"""Reference multi-head attention, BSHD layout, f32 softmax
(counterpart of kubeflow_tpu/ops/attention.py). The plain versions of the
attention kernels are held against this."""

from __future__ import annotations

import torch
import torch.nn.functional as F

F32_MIN = torch.finfo(torch.float32).min
#: the kernels' smallest head dim: their tiles are 64-column regions
KERNEL_MIN_HEAD_DIM = 64


def on_padded_heads(fn, q, k, v, scale, **kw):
    """fn(q, k, v, scale=..., **kw) on q, k and v zero-padded to
    KERNEL_MIN_HEAD_DIM columns, its output cut back to q's head dim D.
    The kernel wrappers run a head dim under the kernels' smallest this
    way: the zero columns add nothing to q.k and give the output zero
    columns, and the scale stays D's. Padding copies k and v whole (a
    decode or prefill call's whole slab span or block pool, each layer
    of each step)."""
    d = q.shape[-1]
    scale = 1.0 / (d ** 0.5) if scale is None else scale
    q, k, v = (F.pad(x, (0, KERNEL_MIN_HEAD_DIM - d)) for x in (q, k, v))
    return fn(q, k, v, scale=scale, **kw)[..., :d]


def repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """[B, S, Hkv, D] -> [B, S, Hkv * n_rep, D] (kv-major head order)."""
    if n_rep == 1:
        return k
    b, s, h, d = k.shape
    return k[:, :, :, None, :].expand(b, s, h, n_rep, d).reshape(
        b, s, h * n_rep, d)


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
        causal: bool = True, scale: float | None = None,
        segment_ids: torch.Tensor | None = None,
        q_offset: int = 0) -> torch.Tensor:
    """q [B, Sq, H, D], k/v [B, Sk, Hkv, D] -> [B, Sq, H, D] in q.dtype.
    Query row i sits at position q_offset + i and, when causal, sees keys
    k_pos <= q_offset + i. segment_ids [B, S] (self-attention only, Sq ==
    Sk): tokens attend only within equal ids."""
    b, sq, h, d = q.shape
    hkv = k.shape[2]
    if hkv != h:
        k = repeat_kv(k, h // hkv)
        v = repeat_kv(v, h // hkv)
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    mask = None
    if causal:
        q_pos = torch.arange(sq, device=q.device)[:, None] + q_offset
        k_pos = torch.arange(k.shape[1], device=q.device)[None, :]
        mask = (q_pos >= k_pos)[None, None]
    if segment_ids is not None:
        if segment_ids.shape[1] != sq or k.shape[1] != sq:
            raise ValueError("segment_ids require Sq == Sk (self-attention)")
        seg = segment_ids[:, None, :, None] == segment_ids[:, None, None, :]
        mask = seg if mask is None else mask & seg
    if mask is not None:
        logits = torch.where(mask, logits, torch.full_like(logits, F32_MIN))
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v.to(q.dtype))
