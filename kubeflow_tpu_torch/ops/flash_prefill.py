"""K3: causal grouped-query attention for a prefill chunk over the KV
slab or the paged block pool (counterpart of
kubeflow_tpu/ops/flash_prefill.py, whose TPU kernel `_prefill_kernel`
this replaces in both modes; CUDA source csrc/flash_prefill.cu).

q [B, S, H, hd] whose row i sits at absolute position q_offset + i (a
python int); k/v [B, T, kv, hd] covering positions 0..T-1, int8 with
per-token scales [B, T, kv] f32, or the model dtype. Key t is visible to
row i iff t <= q_offset + i. Returns [B, S, H, hd] in q.dtype.

Paged mode (`tables` [B, nb] int32): k/v are one layer of the block pool,
[N, bt, kv, hd] (scales [N, bt, kv]), and slot b's T = nb * bt keys are
the blocks of its table row concatenated. The mask is the same, with no
lengths (every one of the T keys exists), as in the TPU kernel.

On a CUDA tensor the wrapper launches the kernel or raises; on a CPU
tensor it runs `flash_prefill_plain`.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from kubeflow_tpu_torch.ops import _build
from kubeflow_tpu_torch.ops.attention import mha
from kubeflow_tpu_torch.ops.flash_decode import (check_paged, check_slab,
                                                 gather_pages)

#: keys per K/V tile of the kernel; a paged block of bt keys loads as
#: boxes that land on the tile's swizzle atoms, so bt is a multiple of 8
#: that divides the tile, or a multiple of the tile (the C entry point
#: checks the same)
KV_TILE = 128


def flash_prefill_plain(q, k, v, *, q_offset=0, k_scale=None, v_scale=None,
                        scale=None, tables=None):
    """The mha path of the JAX `llama.prefill_attention`: int8 K/V are
    dequantized in the model dtype, then causal mha at q_offset. With
    `tables`, the pool's blocks are gathered into the slab view first
    (the JAX `jnp.take` twin)."""
    if tables is not None:
        k, v, k_scale, v_scale = gather_pages(tables, k, v, k_scale,
                                              v_scale)
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
        lib.kft_flash_prefill_paged.restype = ctypes.c_int
        lib.kft_flash_prefill_paged.argtypes = (
            [ctypes.c_void_p] * 7 + [ctypes.c_int] * 11
            + [ctypes.c_float, ctypes.c_void_p])
    return lib


@functools.lru_cache(maxsize=None)
def _max_group() -> int:
    """Query heads per kv head that the kernel's block holds."""
    return _lib().kft_flash_prefill_max_group()


def check_pages(q, k, v, k_scale, v_scale, tables):
    """Argument checks of K3's paged mode: `check_paged`'s (the pool, the
    table's dtype, shape, rows and device; no lengths), and a block size
    the kernel's producer loads. Raises on anything else; returns
    (quantized, bt, nb)."""
    quantized, bt, nb = check_paged(q, k, v, k_scale, v_scale, tables,
                                    None, "flash_prefill")
    if not (bt % KV_TILE == 0 or (bt % 8 == 0 and KV_TILE % bt == 0)):
        raise ValueError(f"flash_prefill: block_tokens {bt} unsupported (a "
                         f"multiple of 8 that divides {KV_TILE}, or a "
                         f"multiple of {KV_TILE})")
    return quantized, bt, nb


def flash_prefill_attention(q, k, v, *, q_offset=0, k_scale=None,
                            v_scale=None, scale=None, tables=None):
    q_offset = int(q_offset)
    if q_offset < 0:
        raise ValueError(f"q_offset must be >= 0, got {q_offset}")
    if q.device.type == "cpu":
        return flash_prefill_plain(q, k, v, q_offset=q_offset,
                                   k_scale=k_scale, v_scale=v_scale,
                                   scale=scale, tables=tables)
    if q.device.type != "cuda":
        raise ValueError(f"flash_prefill: unsupported device {q.device}")
    if tables is not None:
        return _flash_prefill_paged(q, k, v, tables, q_offset, k_scale,
                                    v_scale, scale)
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


def _flash_prefill_paged(q, k, v, tables, q_offset, k_scale, v_scale,
                         scale):
    """The paged launch of K3 on the card."""
    quantized, bt, nb = check_pages(q, k, v, k_scale, v_scale, tables)
    b, s, nh, hd = q.shape
    nkv = k.shape[2]
    if nh // nkv > _max_group():
        raise ValueError(f"flash_prefill: group {nh // nkv} > "
                         f"{_max_group()}")
    scale = 1.0 / (hd ** 0.5) if scale is None else scale
    out = torch.empty_like(q)
    err = _lib().kft_flash_prefill_paged(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        k_scale.data_ptr() if quantized else None,
        v_scale.data_ptr() if quantized else None,
        tables.data_ptr(), out.data_ptr(), b, s, nh, nkv, hd, bt, nb,
        k.shape[0], tables.stride(0), int(quantized), q_offset,
        float(scale), torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_prefill")
    _build.count_launch("flash_prefill_paged", b=b, s=s, nh=nh, nkv=nkv,
                        hd=hd, bt=bt, nb=nb, n_pool=k.shape[0],
                        q_offset=q_offset, int8=quantized)
    return out
