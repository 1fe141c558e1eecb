"""Normalization: f32 statistics, cast back to the input dtype
(counterpart of kubeflow_tpu/ops/norms.py)."""

from __future__ import annotations

import torch


#: on the card, the row count below which `_row_mean_sq` reduces over a
#: taller buffer
_MIN_ROWS = 16


def _row_mean_sq(xf: torch.Tensor) -> torch.Tensor:
    """mean(xf * xf) over the last dim, keepdim. PyTorch's CUDA reduction
    gives a row more threads when there are fewer than 16 rows, which
    sums it in another order, so on the card fewer rows are squared into
    the first rows of a 16-row buffer and reduced with it: a row gets the
    bits it gets among 16 or more, with no extra kernel (the buffer's
    other rows are never written, and their means are dropped). The
    stage-sharded engine normalizes a microbatch of 5 or 6 slots where
    the single program normalizes all 16."""
    d = xf.shape[-1]
    rows = xf.numel() // d
    if not xf.is_cuda or rows >= _MIN_ROWS:
        return (xf * xf).mean(dim=-1, keepdim=True)
    flat = xf.reshape(rows, d)
    if flat.requires_grad:   # out= does not differentiate: pad with zeros
        buf = torch.cat([flat * flat, flat.new_zeros(_MIN_ROWS - rows, d)])
    else:
        buf = xf.new_empty((_MIN_ROWS, d))
        torch.mul(flat, flat, out=buf[:rows])
    return buf.mean(dim=-1, keepdim=True)[:rows].reshape(
        *xf.shape[:-1], 1)


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = _row_mean_sq(xf)
    normed = xf * torch.rsqrt(var + eps)
    return (normed * weight.float()).to(x.dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    """Mean and population variance in f32, eps inside the rsqrt."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, correction=0)
    normed = (xf - mean) * torch.rsqrt(var + eps)
    return (normed * weight.float() + bias.float()).to(x.dtype)
