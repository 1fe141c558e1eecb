"""Rotary position embeddings, half-split (`x1*cos - x2*sin`, not
interleaved), f32 angles (counterpart of kubeflow_tpu/ops/rope.py)."""

from __future__ import annotations

import torch


def rope_frequencies(head_dim: int, theta: float = 10000.0,
                     device: torch.device | str = "cpu") -> torch.Tensor:
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    return 1.0 / (theta ** exponent)              # [head_dim // 2]


def rope_tables(positions: torch.Tensor, head_dim: int,
                theta: float = 10000.0):
    """(cos, sin) [B, S, 1, D/2] f32 for integer positions [B, S] or [S].
    A forward computes them once and applies them to q and k of every
    layer."""
    freqs = rope_frequencies(head_dim, theta, positions.device)
    if positions.dim() == 1:
        positions = positions[None, :]
    angles = positions[..., None].float() * freqs          # [B, S, D/2]
    return torch.cos(angles)[:, :, None, :], torch.sin(angles)[:, :, None, :]


def apply_rope_tables(x: torch.Tensor, cos: torch.Tensor,
                      sin: torch.Tensor) -> torch.Tensor:
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, *,
               theta: float = 10000.0) -> torch.Tensor:
    """RoPE on [B, S, H, D] at integer positions [B, S] or [S]."""
    return apply_rope_tables(x, *rope_tables(positions, x.shape[-1], theta))
