"""Ulysses sequence parallelism: an all-to-all reshard of sequence and
heads (counterpart of kubeflow_tpu/ops/ulysses.py, `ulysses_attention`).

Each rank of the sequence group holds a shard [B, S/N, H, D]. One
all-to-all over the group scatters the heads and gathers the sequence,
so every rank holds the FULL sequence for H/N heads and attention is
exact there; a second all-to-all brings the output back to the sequence
shard. The exchange is differentiable: its backward is the inverse
all-to-all. Grouped kv heads that do not divide by N are expanded to
the full heads first; segment ids are all-gathered for the full-sequence
view. The body on the full sequence is the port's `flash_attention`
(B1-B3 on the card, their plain versions on the CPU) at any length: the
JAX body takes XLA `mha` under 256 tokens, a plain version the port
never runs on the card.
"""

from __future__ import annotations

import torch

from kubeflow_tpu_torch.ops.attention import repeat_kv
from kubeflow_tpu_torch.ops.flash_attention import flash_attention


def _group_size(group) -> int:
    import torch.distributed as dist

    return 1 if group is None else dist.get_world_size(group)


def seq_to_heads(x: torch.Tensor, group) -> torch.Tensor:
    """[B, S/N, H, D] sequence shards -> [B, S, H/N, D] head blocks: head
    block j goes to rank j, the sequence blocks arrive in rank order."""
    import torch.distributed as dist

    n = _group_size(group)
    b, s, h, d = x.shape
    src = x.reshape(b, s, n, h // n, d).permute(2, 0, 1, 3, 4).contiguous()
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=group)
    return out.permute(1, 0, 2, 3, 4).reshape(b, n * s, h // n, d)


def heads_to_seq(x: torch.Tensor, group) -> torch.Tensor:
    """The inverse of `seq_to_heads`: [B, S, H/N, D] -> [B, S/N, H, D]."""
    import torch.distributed as dist

    n = _group_size(group)
    b, s_full, hn, d = x.shape
    s = s_full // n
    src = x.reshape(b, n, s, hn, d).permute(1, 0, 2, 3, 4).contiguous()
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=group)
    return out.permute(1, 2, 0, 3, 4).reshape(b, s, n * hn, d)


class _Exchange(torch.autograd.Function):
    """seq_to_heads (to_heads) or heads_to_seq forward, the other one
    backward."""

    @staticmethod
    def forward(ctx, x, group, to_heads):
        ctx.group, ctx.to_heads = group, to_heads
        return (seq_to_heads if to_heads else heads_to_seq)(x, group)

    @staticmethod
    def backward(ctx, g):
        back = heads_to_seq if ctx.to_heads else seq_to_heads
        return back(g.contiguous(), ctx.group), None, None


def gather_sequence(segment_ids: torch.Tensor, group) -> torch.Tensor:
    """[B, S/N] ids of every rank -> [B, S] in rank order."""
    import torch.distributed as dist

    n = _group_size(group)
    src = segment_ids.contiguous()
    out = torch.empty((n, *src.shape), dtype=src.dtype, device=src.device)
    dist.all_gather_into_tensor(out, src[None], group=group)
    return out.permute(1, 0, 2).reshape(src.shape[0], -1)


def ulysses_attention(q, k, v, *, group=None, causal: bool = True,
                      scale: float | None = None,
                      segment_ids=None) -> torch.Tensor:
    """Per-rank body: q [B, S/N, H, D], k/v [B, S/N, Hkv, D] and
    segment_ids [B, S/N] (or None), this rank's shard of the sequence
    split over `group` (None: one rank, plain flash attention) -> o
    [B, S/N, H, D], differentiable."""
    n = _group_size(group)
    if n == 1:
        return flash_attention(q, k, v, causal=causal, scale=scale,
                               segment_ids=segment_ids)
    h, hkv = q.shape[2], k.shape[2]
    if h % n:
        raise ValueError(f"ulysses: n_heads={h} not divisible by axis size "
                         f"{n}")
    if hkv % n:
        # grouped kv heads do not scatter evenly: expand to full heads
        k = repeat_kv(k, h // hkv)
        v = repeat_kv(v, h // hkv)
    qg, kg, vg = (_Exchange.apply(x.contiguous(), group, True)
                  for x in (q, k, v))
    seg = (None if segment_ids is None
           else gather_sequence(segment_ids.to(torch.int32), group))
    out = flash_attention(qg, kg, vg, causal=causal, scale=scale,
                          segment_ids=seg)
    return _Exchange.apply(out.contiguous(), group, False)
