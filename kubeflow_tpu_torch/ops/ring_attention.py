"""Ring attention: sequence-parallel attention over a ring of ranks
(counterpart of kubeflow_tpu/ops/ring_attention.py, its `pallas` body:
`_ring_flash`, `_ring_pallas_fwd_loop` and `_ring_flash_bwd`).

Each rank of the sequence group holds one shard of the sequence: q
[B, S_loc, H, D], k/v [B, S_loc, Hkv, D] (kv-head width: GQA expands per
arriving shard, so the ring moves kv-width shards) and its segment ids
[B, S_loc]. At step r a rank holds the K/V shard of group rank
(me - r) mod N; the shard and its segment ids move one step on to the
group's next rank (one `batch_isend_irecv`, posted before the step's
kernel, waited on after it). Per step B1 runs on the expanded shard,
with the local shard's ids for the queries and the arriving shard's for
the keys, and its (o, lse) merge into the running ones by logaddexp.
Causal: the own shard (the diagonal) is causal, a past shard whole, and
a future shard contributes nothing, so nothing is launched for it (the
JAX body runs a zero step there for SPMD uniformity).

The backward is a second ring pass: delta once from the merged o and
dO, then B2 and B3 per arriving shard with the GLOBAL lse and delta (p =
exp(s - lse) is then the true share of the whole row, so the per-shard
gradients sum exactly). dk and dv fold from q-head width to kv width in
f32 and travel with their shard; after N steps each is home.

The per-step compute is `ring_fwd_step`, `ring_merge` and
`ring_bwd_step`, free of any process group, so one process can run
every rank's steps by rotating the shards by hand. On CUDA tensors the
steps launch the kernels or raise; on CPU tensors they run the kernels'
plain versions (ops/flash_attention.py).
"""

from __future__ import annotations

import torch

from kubeflow_tpu_torch.ops.attention import repeat_kv
from kubeflow_tpu_torch.ops.flash_attention import (NEG_INF, flash_bwd_dkv,
                                                    flash_bwd_dq, flash_fwd,
                                                    row_delta)

IMPLS = ("auto", "pallas")


def _expand(x: torch.Tensor, groups: int) -> torch.Tensor:
    return repeat_kv(x, groups).contiguous()


def _fold(dx: torch.Tensor, groups: int) -> torch.Tensor:
    """The adjoint of the GQA expansion, in f32: [B, S, H, D] -> [B, S,
    H / groups, D], each kv head the sum of its query heads' rows."""
    b, s, h, d = dx.shape
    return dx.float().reshape(b, s, h // groups, groups, d).sum(3)


def _seg_kw(seg_q, seg_arr, diag: bool, scale) -> dict:
    return dict(causal=diag, scale=scale, segment_ids=seg_arr,
                q_segment_ids=None if seg_arr is None else seg_q)


def ring_fwd_step(q, k_arr, v_arr, seg_q=None, seg_arr=None, *, diag: bool,
                  scale: float | None = None):
    """One ring step's forward: B1 on the local queries q [B, S_loc, H, D]
    against an arriving shard k_arr/v_arr [B, S_loc, Hkv, D] (expanded to
    H heads), causal on the diagonal (`diag`), with the query ids seg_q
    and the arriving ids seg_arr [B, S_loc] (or neither). Returns (o
    [B, S_loc, H, D] in q.dtype, lse [B, H, S_loc] f32); a row that sees
    no key of this shard has o = 0 and lse about -1e30."""
    groups = q.shape[2] // k_arr.shape[2]
    return flash_fwd(q, _expand(k_arr, groups), _expand(v_arr, groups),
                     **_seg_kw(seg_q, seg_arr, diag, scale))


def ring_merge(o, lse, o_r, lse_r):
    """The running (o f32 [B, S, H, D], lse [B, H, S]) merged with one
    step's (o_r, lse_r) by logaddexp, as the JAX loop does."""
    new = torch.logaddexp(lse, lse_r)
    c_old = torch.exp(lse - new).transpose(1, 2)[..., None]
    c_new = torch.exp(lse_r - new).transpose(1, 2)[..., None]
    return o * c_old + o_r.float() * c_new, new


def ring_bwd_step(q, k_arr, v_arr, do, lse, delta, seg_q=None, seg_arr=None,
                  *, diag: bool, scale: float | None = None):
    """One ring step's backward: B2 and B3 on the local queries against
    an arriving shard with the global lse and delta [B, H, S_loc] f32.
    Returns (dq_part [B, S_loc, H, D] in q.dtype, dk_part and dv_part
    [B, S_loc, Hkv, D] f32, folded to kv width)."""
    groups = q.shape[2] // k_arr.shape[2]
    ke, ve = _expand(k_arr, groups), _expand(v_arr, groups)
    kw = _seg_kw(seg_q, seg_arr, diag, scale)
    dq = flash_bwd_dq(q, ke, ve, do, lse, delta, **kw)
    dk, dv = flash_bwd_dkv(q, ke, ve, do, lse, delta, **kw)
    return dq, _fold(dk, groups), _fold(dv, groups)


def runs_step(causal: bool, src: int, me: int) -> bool:
    """Whether rank `me` computes anything against the shard of rank
    `src`: always when not causal, else only for its own and past
    shards."""
    return not causal or src <= me


def _rotate(tensors, group, peers):
    """Each tensor sent to the ring's next rank and its counterpart
    received from the previous one: (the receive buffers, the works to
    wait on)."""
    import torch.distributed as dist

    nxt, prv = peers
    out = [torch.empty_like(t) for t in tensors]
    ops = []
    for t, r in zip(tensors, out):
        ops += [dist.P2POp(dist.isend, t, nxt, group),
                dist.P2POp(dist.irecv, r, prv, group)]
    return out, dist.batch_isend_irecv(ops)


def _wait(works) -> None:
    for w in works:
        w.wait()


def _ring(group):
    """(N, this rank's index, its ring peers) of the sequence group."""
    import torch.distributed as dist

    from kubeflow_tpu_torch.parallel.sharding import ring_peers

    if group is None:
        return 1, 0, None
    n = dist.get_world_size(group)
    return n, dist.get_rank(group), (ring_peers(group) if n > 1 else None)


def _ring_forward(q, k, v, seg, group, causal, scale):
    n, me, peers = _ring(group)
    b, s, h, _ = q.shape
    o = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    lse = torch.full((b, h, s), NEG_INF, dtype=torch.float32,
                     device=q.device)
    cur = [k, v] + ([] if seg is None else [seg])
    for r in range(n):
        src = (me - r) % n
        nxt, works = (_rotate(cur, group, peers) if r < n - 1
                      else (cur, ()))
        if runs_step(causal, src, me):
            o_r, lse_r = ring_fwd_step(
                q, cur[0], cur[1], seg, cur[2] if seg is not None else None,
                diag=causal and src == me, scale=scale)
            o, lse = ring_merge(o, lse, o_r, lse_r)
        _wait(works)
        cur = nxt
    return o.to(q.dtype), lse


def _ring_backward(q, k, v, seg, o, lse, do, group, causal, scale):
    n, me, peers = _ring(group)
    do = do.contiguous()
    delta = row_delta(o, do)
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.zeros_like(dk)
    cur = [k, v] + ([] if seg is None else [seg])
    for r in range(n):
        src = (me - r) % n
        nxt, works = (_rotate(cur, group, peers) if r < n - 1
                      else (cur, ()))
        if runs_step(causal, src, me):
            dq_p, dk_p, dv_p = ring_bwd_step(
                q, cur[0], cur[1], do, lse, delta, seg,
                cur[2] if seg is not None else None,
                diag=causal and src == me, scale=scale)
            dq += dq_p.float()
            dk += dk_p
            dv += dv_p
        _wait(works)
        cur = nxt
        if n > 1:   # the accumulators travel with their shard
            (dk, dv), works = _rotate([dk, dv], group, peers)
            _wait(works)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _RingFlash(torch.autograd.Function):
    """The `_ring_flash` custom vjp: the forward ring keeps (q, k, v,
    segment ids, o, the merged lse), the backward runs the second ring
    pass."""

    @staticmethod
    def forward(ctx, q, k, v, seg, group, causal, scale):
        o, lse = _ring_forward(q, k, v, seg, group, causal, scale)
        ctx.save_for_backward(q, k, v, seg, o, lse)
        ctx.group, ctx.causal, ctx.scale = group, causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, seg, o, lse = ctx.saved_tensors
        dq, dk, dv = _ring_backward(q, k, v, seg, o, lse, do, ctx.group,
                                    ctx.causal, ctx.scale)
        return dq, dk, dv, None, None, None, None


def ring_attention(q, k, v, *, group=None, causal: bool = True,
                   scale: float | None = None, segment_ids=None,
                   impl: str = "auto") -> torch.Tensor:
    """Per-rank body: q [B, S_loc, H, D], k/v [B, S_loc, Hkv, D] and
    segment_ids [B, S_loc] (or None), this rank's shard of the sequence
    split over `group` (the mesh's `sequence` group; None: one rank) ->
    o [B, S_loc, H, D], differentiable. `impl` "auto" and "pallas" take
    the kernels; the JAX package's "xla" body has no counterpart."""
    if impl == "xla":
        raise ValueError(
            "ring_attention impl='xla': the port has no plain-version path "
            "on the card; CUDA tensors always take the kernels (ROADMAP.md "
            "north star, rule 4)")
    if impl not in IMPLS:
        raise ValueError(f"unknown ring_attention impl {impl!r}")
    h, hkv = q.shape[2], k.shape[2]
    if h % hkv:
        raise ValueError(f"n_heads {h} must be a multiple of kv heads {hkv}")
    scale = 1.0 / (q.shape[-1] ** 0.5) if scale is None else scale
    seg = (None if segment_ids is None
           else segment_ids.to(torch.int32).contiguous())
    return _RingFlash.apply(q.contiguous(), k.contiguous(), v.contiguous(),
                            seg, group, causal, scale)
