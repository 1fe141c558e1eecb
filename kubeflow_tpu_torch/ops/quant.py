"""Weight-only int8 quantization for serving (counterpart of
kubeflow_tpu/ops/quant.py).

A quantized weight is a dict leaf {"q": int8 [..., in, out],
"s": f32 [..., out]}, applied as x @ W. Decode-shaped products (few rows,
the `quant_matmul.kernel_applicable` gate the JAX package uses) go to the
K1 kernel wrapper; larger products (prefill rows) multiply the weight
converted to the model dtype, as the JAX package leaves them to XLA.
"""

from __future__ import annotations

from typing import Any

import torch

from kubeflow_tpu_torch.ops import quant_matmul


def quantize_int8(w: torch.Tensor) -> dict[str, torch.Tensor]:
    """Per-output-channel (last axis) symmetric int8: divide in f32 and
    round half to even, so the bytes equal the JAX package's."""
    wf = w.float()
    s = wf.abs().amax(dim=-2, keepdim=True).clamp_min(1e-8) / 127.0
    q = torch.round(wf / s).clamp(-127, 127).to(torch.int8)
    return {"q": q, "s": s.squeeze(-2)}


def is_quantized(wt: Any) -> bool:
    return isinstance(wt, dict) and "q" in wt and "s" in wt


def _kernel_wanted(x: torch.Tensor, q: torch.Tensor) -> bool:
    m = x.numel() // x.shape[-1]
    return q.dim() == 2 and quant_matmul.kernel_applicable(m, *q.shape)


def _mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w; on the CPU with a row's bits independent of the row count
    (`quant_matmul.rows_mm`)."""
    return quant_matmul.rows_mm(x, w) if x.device.type == "cpu" else x @ w


def matmul(x: torch.Tensor, wt: Any, dtype: torch.dtype) -> torch.Tensor:
    """x @ W for a raw or quantized weight leaf (x: [..., in]). The scale
    multiplies the f32 product, which is then cast to dtype."""
    if is_quantized(wt):
        if _kernel_wanted(x, wt["q"]):
            return quant_matmul.dequant_matmul(x, wt["q"], wt["s"], dtype)
        return (_mm(x.to(dtype), wt["q"].to(dtype)).float()
                * wt["s"]).to(dtype)
    return _mm(x.to(dtype), wt.to(dtype))


class _F32OutMatmul(torch.autograd.Function):
    """x [..., d] @ w [d, o], both in the model dtype, with an f32 result:
    one GEMM that accumulates in f32 and writes f32 (JAX's
    preferred_element_type=float32). The backward rounds the f32 cotangent
    to the model dtype for both products, as the TPU's default-precision
    transpose does; dw comes out in w's dtype, as in JAX."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        out = torch.mm(x.reshape(-1, x.shape[-1]), w,
                       out_dtype=torch.float32)
        return out.reshape(*x.shape[:-1], w.shape[-1])

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g2 = g.reshape(-1, g.shape[-1]).to(x.dtype)
        dx = (g2 @ w.t()).reshape(x.shape)
        dw = x.reshape(-1, x.shape[-1]).t() @ g2
        return dx, dw


def matmul_f32_out(x: torch.Tensor, wt: Any,
                   dtype: torch.dtype) -> torch.Tensor:
    """Like matmul but with f32 output (the lm-head contract). A raw
    weight on the card takes one dtype-in, f32-out GEMM; on the CPU the
    operands are rounded to dtype and multiplied in f32."""
    if is_quantized(wt):
        if _kernel_wanted(x, wt["q"]):
            return quant_matmul.dequant_matmul(x, wt["q"], wt["s"],
                                               torch.float32)
        w = wt["q"].to(dtype).float()
        return _mm(x.to(dtype).float(), w) * wt["s"]
    if x.device.type == "cuda" and dtype != torch.float32:
        return _F32OutMatmul.apply(x.to(dtype), wt.to(dtype))
    return _mm(x.to(dtype).float(), wt.to(dtype).float())
