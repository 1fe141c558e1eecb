"""B1-B3: flash attention for training, forward and backward
(counterpart of kubeflow_tpu/ops/flash_pallas.py — `_fwd`, `_bwd`,
`flash_fwd_stats`, `flash_bwd_grads`, the `_flash` custom vjp and
`pallas_flash_attention` — and of `flash_attention` in
kubeflow_tpu/ops/flash_attention.py).

Three CUDA kernels replace the three TPU kernels: csrc/flash_attn_fwd.cu
(`_fwd_kernel`), csrc/flash_attn_dq.cu (`_bwd_dq_kernel`) and
csrc/flash_attn_dkv.cu (`_bwd_dkv_kernel`). Layout is BSHD throughout:
q [B, Sq, H, D], k/v [B, Sk, H, D] with the GQA heads already expanded,
lse and delta [B, H, Sq] f32, segment ids [B, Sk] int32. A query-side
array `q_segment_ids` [B, Sq] may stand beside them (a ring step: the
local shard's ids for the queries, the arriving shard's for the keys);
without it the query rows read their ids from the key array. A row that
sees no key (its segment absent from the keys) gets o = 0 and lse about
-1e30 from the forward and adds nothing in the backward.

On a CUDA tensor each wrapper launches its kernel or raises; on a CPU
tensor it runs the plain version below, which does the kernels'
arithmetic in one pass with the same masks and the same casts (p to bf16
before p.v and p^T.dO, ds to bf16 before ds.k and ds^T.q), so the plain
version is what the kernels are held to on the card.
"""

from __future__ import annotations

import ctypes

import torch

from kubeflow_tpu_torch.ops import _build
from kubeflow_tpu_torch.ops.attention import (KERNEL_MIN_HEAD_DIM,
                                              on_padded_heads, repeat_kv)

NEG_INF = -1e30


def _seg_offset(sq: int, sk: int, q_offset: int) -> int:
    """Where query row 0's segment id sits in the [B, Sk] array: at
    q_offset for a continuation (Sq != Sk), else at 0, as the JAX
    `pallas_flash_attention` slices it."""
    return q_offset if sq != sk else 0


def check_segments(segment_ids, q_segment_ids, sq: int, sk: int) -> None:
    """A query-side array needs the key-side one, and Sq == Sk: the
    kernels read both with one row stride."""
    if q_segment_ids is None:
        return
    if segment_ids is None:
        raise ValueError("q_segment_ids needs segment_ids (the keys' ids)")
    if sq != sk:
        raise ValueError(
            f"q_segment_ids with Sq={sq} != Sk={sk}: the kernels read the "
            "query and key ids with one row stride")


def _visible(sq: int, sk: int, *, causal: bool, q_offset: int,
             segment_ids, device, q_segment_ids=None) -> torch.Tensor:
    """[B or 1, 1, Sq, Sk] bool: key t visible to query row i."""
    q_pos = torch.arange(sq, device=device)[:, None] + q_offset
    k_pos = torch.arange(sk, device=device)[None, :]
    mask = (q_pos >= k_pos) if causal else torch.ones(
        sq, sk, dtype=torch.bool, device=device)
    mask = mask[None, None]
    check_segments(segment_ids, q_segment_ids, sq, sk)
    if segment_ids is not None:
        if q_segment_ids is None:
            off = _seg_offset(sq, sk, q_offset)
            q_segment_ids = segment_ids[:, off:off + sq]
        mask = mask & (q_segment_ids[:, None, :, None]
                       == segment_ids[:, None, None, :])
    return mask


def plain_fwd(q, k, v, *, causal=True, scale=None, q_offset=0,
              segment_ids=None, q_segment_ids=None):
    """(o [B, Sq, H, D] in q.dtype, lse [B, H, Sq] f32): the forward
    kernel's arithmetic in one pass — f32 scores times scale, masked to
    -1e30, p = exp(s - m) zeroed where masked, l clamped to 1e-30, p
    rounded to q.dtype before p.v."""
    dt = q.dtype
    d = q.shape[-1]
    scale = 1.0 / (d ** 0.5) if scale is None else scale
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    valid = _visible(q.shape[1], k.shape[1], causal=causal,
                     q_offset=q_offset, segment_ids=segment_ids,
                     device=q.device, q_segment_ids=q_segment_ids)
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(s > NEG_INF / 2, torch.exp(s - m), torch.zeros_like(s))
    del s
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    acc = torch.einsum("bhqk,bkhd->bhqd", p.to(dt).float(), v.float())
    o = (acc / l).to(dt).transpose(1, 2)
    return o, (m + torch.log(l))[..., 0]


def row_delta(o, do):
    """rowsum(dO * O) in f32, [B, H, Sq] — computed outside the backward
    kernels, from the forward's rounded O, as the JAX `_bwd` does."""
    return (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()


def _bwd_probs(q, k, v, do, lse, delta, causal, scale, segment_ids,
               q_segment_ids):
    """(p, ds) [B, H, Sq, Sk] f32 of the backward: p = exp(s - lse) zeroed
    where masked, ds = p * (dO.v^T - delta) * scale."""
    d = q.shape[-1]
    scale = 1.0 / (d ** 0.5) if scale is None else scale
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    valid = _visible(q.shape[1], k.shape[1], causal=causal, q_offset=0,
                     segment_ids=segment_ids, device=q.device,
                     q_segment_ids=q_segment_ids)
    p = torch.where(valid, torch.exp(s - lse[..., None]),
                    torch.zeros_like(s))
    del s
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    return p, p * (dp - delta[..., None]) * scale


def plain_bwd_dq(q, k, v, do, lse, delta, *, causal=True, scale=None,
                 segment_ids=None, q_segment_ids=None):
    """dq = ds.k with ds rounded to k.dtype (the dq kernel's formula)."""
    _, ds = _bwd_probs(q, k, v, do, lse, delta, causal, scale, segment_ids,
                       q_segment_ids)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds.to(k.dtype).float(), k.float())
    return dq.to(q.dtype)


def plain_bwd_dkv(q, k, v, do, lse, delta, *, causal=True, scale=None,
                  segment_ids=None, q_segment_ids=None):
    """(dk, dv): dv = p^T.dO with p rounded to dO's dtype, dk = ds^T.q with
    ds rounded to q.dtype (the dk/dv kernel's formulas)."""
    p, ds = _bwd_probs(q, k, v, do, lse, delta, causal, scale, segment_ids,
                       q_segment_ids)
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(do.dtype).float(), do.float())
    del p
    dk = torch.einsum("bhqk,bqhd->bkhd", ds.to(q.dtype).float(), q.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def plain_bwd(q, k, v, o, lse, do, *, causal=True, scale=None,
              segment_ids=None, q_segment_ids=None):
    """(dq, dk, dv) at q_offset 0 by the backward kernels' explicit
    formulas (not autograd)."""
    delta = row_delta(o, do)
    kw = dict(causal=causal, scale=scale, segment_ids=segment_ids,
              q_segment_ids=q_segment_ids)
    dq = plain_bwd_dq(q, k, v, do, lse, delta, **kw)
    return (dq, *plain_bwd_dkv(q, k, v, do, lse, delta, **kw))


# -- the kernels ---------------------------------------------------------------

_SIGNATURES = {
    # q k v seg_q seg_k o lse | B H Sq Sk D | seg_stride | q_offset causal
    # | scale | stream
    "kft_flash_attn_fwd": [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
    + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_float,
       ctypes.c_void_p],
    # q k v dout lse delta seg_q seg_k dq | B H Sq Sk D | seg_stride
    # | causal | scale | stream
    "kft_flash_attn_dq": [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5
    + [ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_void_p],
    # ... dk dv instead of dq
    "kft_flash_attn_dkv": [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5
    + [ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_void_p],
}


def _fn(source: str, name: str):
    fn = getattr(_build.load(source), name)
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = _SIGNATURES[name]
    return fn


def _check(name, q, k, v, do=None):
    """The kernels take contiguous bf16 q (and dO) [B, Sq, H, D] and k/v
    [B, Sk, H, D] with D in (64, 128), all on one CUDA device. Returns
    (B, Sq, Sk, H, D)."""
    xs = (q, k, v) if do is None else (q, k, v, do)
    for x in xs:
        if x.device != q.device or x.dtype != torch.bfloat16 \
                or not x.is_contiguous() or x.dim() != 4:
            raise TypeError(f"{name}: expects contiguous bfloat16 "
                            "[B, S, H, D] tensors on one CUDA device")
    b, sq, h, d = q.shape
    sk = k.shape[1]
    if k.shape != (b, sk, h, d) or v.shape != k.shape or (
            do is not None and do.shape != q.shape):
        raise ValueError(f"{name}: k/v must be [B, Sk, H, D] (and dO "
                         "[B, Sq, H, D]) with q's B, H and D")
    if d not in (64, 128):
        raise ValueError(f"{name}: head dim {d} not in (64, 128)")
    return b, sq, sk, h, d


def _ids(x, shape, dev, name):
    x = x.to(device=dev, dtype=torch.int32).contiguous()
    if x.shape != shape:
        raise ValueError(f"{name} {tuple(x.shape)} != {shape}")
    return x


def _segments(segment_ids, q_segment_ids, b, sq, sk, q_offset, dev):
    """(seg_q, seg_k, row stride, the tensors behind them): the int32
    addresses the kernels read query row i's and key t's ids of batch b
    at (seg_q and seg_k + 4 (b * stride + i or t)), None without
    segments. Without q_segment_ids the query rows read the key array
    from `_seg_offset`."""
    check_segments(segment_ids, q_segment_ids, sq, sk)
    if segment_ids is None:
        return None, None, 0, ()
    seg = _ids(segment_ids, (b, sk), dev, "segment_ids")
    if q_segment_ids is None:
        return (seg.data_ptr() + 4 * _seg_offset(sq, sk, q_offset),
                seg.data_ptr(), sk, (seg,))
    seg_q = _ids(q_segment_ids, (b, sq), dev, "q_segment_ids")
    return seg_q.data_ptr(), seg.data_ptr(), sk, (seg_q, seg)


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def _on_cpu(x, name) -> bool:
    """True for a CPU tensor (the plain version runs), False for a CUDA
    one (the kernel runs); other devices raise."""
    if x.device.type == "cpu":
        return True
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    return False


def flash_fwd(q, k, v, *, causal=True, scale=None, q_offset=0,
              segment_ids=None, q_segment_ids=None):
    """(o [B, Sq, H, D], lse [B, H, Sq] f32); B1 for CUDA tensors."""
    q_offset = int(q_offset)
    if q_offset < 0:
        raise ValueError(f"q_offset must be >= 0, got {q_offset}")
    if _on_cpu(q, "flash_attn_fwd"):
        return plain_fwd(q, k, v, causal=causal, scale=scale,
                         q_offset=q_offset, segment_ids=segment_ids,
                         q_segment_ids=q_segment_ids)
    b, sq, sk, h, d = _check("flash_attn_fwd", q, k, v)
    scale = 1.0 / (d ** 0.5) if scale is None else scale
    seg_q, seg_k, stride, _keep = _segments(segment_ids, q_segment_ids, b,
                                            sq, sk, q_offset, q.device)
    o = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    err = _fn("flash_attn_fwd", "kft_flash_attn_fwd")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), seg_q, seg_k,
        o.data_ptr(), lse.data_ptr(), b, h, sq, sk, d, stride, q_offset,
        int(causal), float(scale), _stream(q.device))
    _build.check(err, "flash_attn_fwd")
    _build.count_launch("flash_attn_fwd", b=b, sq=sq, sk=sk, h=h, d=d,
                        causal=bool(causal), q_offset=q_offset,
                        segmented=seg_k is not None)
    return o, lse


def _bwd_args(name, q, k, v, do, lse, delta, segment_ids, q_segment_ids,
              scale):
    b, sq, sk, h, d = _check(name, q, k, v, do)
    for x in (lse, delta):
        if x.shape != (b, h, sq) or x.dtype != torch.float32 \
                or not x.is_contiguous() or x.device != q.device:
            raise TypeError(f"{name}: lse and delta must be contiguous f32 "
                            "[B, H, Sq] on q's device")
    seg = _segments(segment_ids, q_segment_ids, b, sq, sk, 0, q.device)
    scale = 1.0 / (d ** 0.5) if scale is None else scale
    return seg, float(scale), dict(
        b=b, sq=sq, sk=sk, h=h, d=d, segmented=seg[1] is not None)


def flash_bwd_dq(q, k, v, do, lse, delta, *, causal=True, scale=None,
                 segment_ids=None, q_segment_ids=None):
    """dq [B, Sq, H, D] from lse and delta [B, H, Sq]; B2 for CUDA
    tensors."""
    kw = dict(causal=causal, scale=scale, segment_ids=segment_ids,
              q_segment_ids=q_segment_ids)
    if _on_cpu(q, "flash_attn_dq"):
        return plain_bwd_dq(q, k, v, do, lse, delta, **kw)
    (seg_q, seg_k, stride, _keep), scale, shape = _bwd_args(
        "flash_attn_dq", q, k, v, do, lse, delta, segment_ids,
        q_segment_ids, scale)
    dq = torch.empty_like(q)
    err = _fn("flash_attn_dq", "kft_flash_attn_dq")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), seg_q, seg_k, dq.data_ptr(),
        shape["b"], shape["h"], shape["sq"], shape["sk"], shape["d"], stride,
        int(causal), scale, _stream(q.device))
    _build.check(err, "flash_attn_dq")
    _build.count_launch("flash_attn_dq", causal=bool(causal), **shape)
    return dq


def flash_bwd_dkv(q, k, v, do, lse, delta, *, causal=True, scale=None,
                  segment_ids=None, q_segment_ids=None):
    """(dk, dv) [B, Sk, H, D]; B3 for CUDA tensors."""
    kw = dict(causal=causal, scale=scale, segment_ids=segment_ids,
              q_segment_ids=q_segment_ids)
    if _on_cpu(q, "flash_attn_dkv"):
        return plain_bwd_dkv(q, k, v, do, lse, delta, **kw)
    (seg_q, seg_k, stride, _keep), scale, shape = _bwd_args(
        "flash_attn_dkv", q, k, v, do, lse, delta, segment_ids,
        q_segment_ids, scale)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    err = _fn("flash_attn_dkv", "kft_flash_attn_dkv")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), seg_q, seg_k, dk.data_ptr(),
        dv.data_ptr(), shape["b"], shape["h"], shape["sq"], shape["sk"],
        shape["d"], stride, int(causal), scale, _stream(q.device))
    _build.check(err, "flash_attn_dkv")
    _build.count_launch("flash_attn_dkv", causal=bool(causal), **shape)
    return dk, dv


def flash_bwd(q, k, v, o, lse, do, *, causal=True, scale=None,
              segment_ids=None, q_segment_ids=None):
    """(dq, dk, dv) at q_offset 0: delta, then B2 and B3 (their plain
    versions for CPU tensors)."""
    do = do.contiguous()
    delta = row_delta(o, do)
    kw = dict(causal=causal, scale=scale, segment_ids=segment_ids,
              q_segment_ids=q_segment_ids)
    dq = flash_bwd_dq(q, k, v, do, lse, delta, **kw)
    return (dq, *flash_bwd_dkv(q, k, v, do, lse, delta, **kw))


class _FlashAttention(torch.autograd.Function):
    """The `_flash` custom vjp: forward keeps (q, k, v, o, lse), backward
    runs B2 and B3 (or the plain backward for CPU tensors)."""

    @staticmethod
    def forward(ctx, q, k, v, segment_ids, causal, scale):
        o, lse = flash_fwd(q, k, v, causal=causal, scale=scale,
                           segment_ids=segment_ids)
        ctx.save_for_backward(q, k, v, o, lse, segment_ids)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, segment_ids = ctx.saved_tensors
        dq, dk, dv = flash_bwd(q, k, v, o, lse, do, causal=ctx.causal,
                               scale=ctx.scale, segment_ids=segment_ids)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, *, causal=True, scale=None, q_offset=0,
                    segment_ids=None):
    """Flash attention, BSHD, GQA-aware: q [B, Sq, H, D], k/v [B, Sk, Hkv,
    D] -> [B, Sq, H, D]. KV heads are expanded with repeat_kv before the
    kernels (their gradients reduce through autograd), as the JAX
    `flash_attention` does. Differentiable at q_offset 0; with a q_offset
    (continuation prefill) the call is forward-only. On the card a head
    dim under 64 runs the kernels on zero-padded heads
    (`on_padded_heads`), the padding differentiable."""
    h, hkv = q.shape[2], k.shape[2]
    if hkv != h:
        k = repeat_kv(k, h // hkv)
        v = repeat_kv(v, h // hkv)
    if q.is_cuda and q.shape[-1] < KERNEL_MIN_HEAD_DIM:
        return on_padded_heads(flash_attention, q, k, v, scale,
                               causal=causal, q_offset=q_offset,
                               segment_ids=segment_ids)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    scale = 1.0 / (q.shape[-1] ** 0.5) if scale is None else scale
    if int(q_offset) == 0:
        return _FlashAttention.apply(q, k, v, segment_ids, causal, scale)
    with torch.no_grad():
        o, _ = flash_fwd(q, k, v, causal=causal, scale=scale,
                         q_offset=q_offset, segment_ids=segment_ids)
    return o
