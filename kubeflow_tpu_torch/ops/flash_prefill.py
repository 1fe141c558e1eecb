"""K3: causal grouped-query attention for a prefill chunk over the KV
slab (counterpart of kubeflow_tpu/ops/flash_prefill.py, whose TPU kernel
`_prefill_kernel` this replaces in slab mode; CUDA source
csrc/flash_prefill.cu).

q [B, S, H, hd] whose row i sits at absolute position q_offset + i (a
python int); k/v [B, T, kv, hd] covering positions 0..T-1, int8 with
per-token scales [B, T, kv] f32, or the model dtype. Key t is visible to
row i iff t <= q_offset + i. Returns [B, S, H, hd] in q.dtype. On a CUDA
tensor the wrapper launches the kernel or raises; on a CPU tensor it runs
`flash_prefill_plain`.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from kubeflow_tpu_torch.ops import _build
from kubeflow_tpu_torch.ops.attention import mha
from kubeflow_tpu_torch.ops.flash_decode import check_slab


def flash_prefill_plain(q, k, v, *, q_offset=0, k_scale=None, v_scale=None,
                        scale=None):
    """The mha path of the JAX `llama.prefill_attention`: int8 K/V are
    dequantized in the model dtype, then causal mha at q_offset."""
    dtype = q.dtype
    if k_scale is not None:
        k = k.to(dtype) * k_scale[..., None].to(dtype)
        v = v.to(dtype) * v_scale[..., None].to(dtype)
    return mha(q, k.to(dtype), v.to(dtype), causal=True, scale=scale,
               q_offset=q_offset)


def _lib():
    lib = _build.load("flash_prefill")
    if lib.kft_flash_prefill.argtypes is None:
        lib.kft_flash_prefill_max_group.restype = ctypes.c_int
        lib.kft_flash_prefill_max_group.argtypes = []
        lib.kft_flash_prefill.restype = ctypes.c_int
        lib.kft_flash_prefill.argtypes = (
            [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
            + [ctypes.c_longlong] * 2
            + [ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
    return lib


@functools.lru_cache(maxsize=None)
def _max_group() -> int:
    """Query heads per kv head that the kernel's block holds."""
    return _lib().kft_flash_prefill_max_group()


def flash_prefill_attention(q, k, v, *, q_offset=0, k_scale=None,
                            v_scale=None, scale=None):
    q_offset = int(q_offset)
    if q_offset < 0:
        raise ValueError(f"q_offset must be >= 0, got {q_offset}")
    if q.device.type == "cpu":
        return flash_prefill_plain(q, k, v, q_offset=q_offset,
                                   k_scale=k_scale, v_scale=v_scale,
                                   scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_prefill: unsupported device {q.device}")
    quantized = check_slab(q, k, v, k_scale, v_scale, "flash_prefill")
    b, s, nh, hd = q.shape
    t, nkv = k.shape[1], k.shape[2]
    if nh // nkv > _max_group():
        raise ValueError(f"flash_prefill: group {nh // nkv} > "
                         f"{_max_group()}")
    scale = 1.0 / (hd ** 0.5) if scale is None else scale
    out = torch.empty_like(q)
    dev = q.device
    err = _lib().kft_flash_prefill(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        k_scale.data_ptr() if quantized else None,
        v_scale.data_ptr() if quantized else None,
        out.data_ptr(), b, s, nh, nkv, hd, t, k.stride(0),
        k_scale.stride(0) if quantized else 0, int(quantized), q_offset,
        float(scale), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "flash_prefill")
    _build.count_launch("flash_prefill", b=b, s=s, nh=nh, nkv=nkv, hd=hd,
                        t=t, slot_stride=k.stride(0), q_offset=q_offset,
                        int8=quantized)
    return out
