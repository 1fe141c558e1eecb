"""K1: weight-only int8 skinny GEMM (counterpart of
kubeflow_tpu/ops/quant_matmul.py, whose TPU kernel `_dequant_kernel`
this replaces; CUDA source csrc/quant_matmul.cu).

`dequant_matmul(x, q, s, out_dtype)` = (bf16(x) @ q) in f32, times s, cast
to out_dtype. On a CUDA tensor it launches the kernel or raises; on a CPU
tensor it runs `dequant_matmul_plain`, the same arithmetic in PyTorch.
"""

from __future__ import annotations

import ctypes

import torch

from kubeflow_tpu_torch.ops import _build

# decode/verify row counts; beyond this the product is compute-heavy and
# the caller multiplies plainly (the JAX package's gate)
MAX_ROWS = 128


def _pick_block(dim: int, prefs: tuple[int, ...]) -> int | None:
    for b in prefs:
        if dim % b == 0:
            return b
    return None


def kernel_applicable(m: int, d: int, o: int) -> bool:
    """Static shape gate, the same as the JAX package's."""
    return (m <= MAX_ROWS
            and _pick_block(d, (2048, 1024, 512, 256)) is not None
            and _pick_block(o, (512, 384, 256, 128)) is not None)


def dequant_matmul_plain(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
                         out_dtype: torch.dtype) -> torch.Tensor:
    """The kernel's function in plain PyTorch: x rounded to bf16 (as the
    TPU kernel does, even for f32 models), f32 accumulation, scale on the
    f32 sum, cast."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).to(torch.bfloat16).float()
    out = (x2 @ q.float()) * s.float()
    return out.to(out_dtype).reshape(*lead, q.shape[1])


def _lib():
    lib = _build.load("quant_matmul")
    if lib.kft_dequant_matmul.argtypes is None:
        lib.kft_dequant_matmul.restype = ctypes.c_int
        lib.kft_dequant_matmul.argtypes = ([ctypes.c_void_p] * 4
                                           + [ctypes.c_int] * 4
                                           + [ctypes.c_void_p])
    return lib


def dequant_matmul(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
                   out_dtype: torch.dtype) -> torch.Tensor:
    """x [..., d] @ {q int8 [d, o], s f32 [o]} -> [..., o] out_dtype."""
    if x.device.type == "cpu":
        return dequant_matmul_plain(x, q, s, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"dequant_matmul: unsupported device {x.device}")
    d, o = q.shape
    lead = x.shape[:-1]
    x2 = x.reshape(-1, d).to(torch.bfloat16).contiguous()
    if x2.data_ptr() % 16:   # the kernel copies x in 16-byte chunks
        x2 = x2.clone()
    m = x2.shape[0]
    if x.shape[-1] != d or not kernel_applicable(m, d, o):
        raise ValueError(f"dequant_matmul: shape m={m} d={d} o={o} is "
                         "outside the kernel gate")
    if q.dtype != torch.int8 or s.dtype != torch.float32:
        raise TypeError("dequant_matmul: q must be int8 and s float32")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"dequant_matmul: unsupported out dtype {out_dtype}")
    if not (q.is_cuda and s.is_cuda and q.device == x.device
            and s.device == x.device):
        raise ValueError("dequant_matmul: x, q and s must share a device")
    if not (q.is_contiguous() and s.is_contiguous()) or s.shape != (o,):
        raise ValueError("dequant_matmul: q and s must be contiguous, "
                         "s of shape [o]")
    if q.data_ptr() % 16:
        raise ValueError("dequant_matmul: q must be 16-byte aligned")
    out = torch.empty((m, o), dtype=out_dtype, device=x.device)
    err = _lib().kft_dequant_matmul(
        x2.data_ptr(), q.data_ptr(), s.data_ptr(), out.data_ptr(), m, d, o,
        int(out_dtype == torch.float32),
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "dequant_matmul")
    _build.count_launch("quant_matmul", m=m, d=d, o=o, out_dtype=out_dtype)
    return out.reshape(*lead, o)
