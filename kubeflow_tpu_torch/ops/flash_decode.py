"""K2: grouped-query decode/verify attention over the KV slab or the
paged block pool (counterpart of kubeflow_tpu/ops/flash_decode.py, whose
TPU kernel `_decode_kernel` this replaces in both modes; CUDA source
csrc/flash_decode.cu).

q [B, S_v, H, hd]; k/v [B, T, kv, hd] — the span-sliced cache slab, int8
with per-token scales [B, T, kv] f32, or the model dtype; lengths [B]
int32. Query row i of slot b sees keys t <= lengths[b] + i. Returns
[B, S_v, H, hd] in q.dtype. `split_slots`: when the B slots are a window
of a slab's slots (a stage's microbatch of the stage-sharded engine), the
slab's slot count; the kernel then splits each row's keys as a launch
over the whole slab does, so a row gets the same bits in either (None:
B).

Paged mode (`tables` [B, nb] int32): k/v are one layer of the block pool,
[N, bt, kv, hd] (scales [N, bt, kv]), and slot b's T = nb * bt keys are
the blocks of its table row concatenated. The mask is the same.

On a CUDA tensor the wrapper launches the kernel or raises (a head dim
under 64 on zero-padded heads, `attention.on_padded_heads`); on a CPU
tensor it runs `flash_decode_plain`.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from kubeflow_tpu_torch.ops import _build
from kubeflow_tpu_torch.ops.attention import (F32_MIN, KERNEL_MIN_HEAD_DIM,
                                              on_padded_heads)


def gather_pages(tables, *pool):
    """The slab view [B, nb * bt, ...] of pool tensors [N, bt, ...]
    through tables [B, nb] (None passes through): the JAX `jnp.take`
    twin of paged decode."""
    b, nb = tables.shape
    idx = tables.long()
    return [None if x is None else
            x[idx].reshape(b, nb * x.shape[1], *x.shape[2:]) for x in pool]


def flash_decode_plain(q, k, v, lengths, *, k_scale=None, v_scale=None,
                       scale=None, tables=None):
    """The einsum path of the JAX `llama.decode_attention`: GQA without
    repeat_kv, the int8 k scale on the score before 1/sqrt(hd), the v
    scale folded into the probabilities, f32 softmax. With `tables`, the
    pool's blocks are gathered into the slab view first."""
    if tables is not None:
        k, v, k_scale, v_scale = gather_pages(tables, k, v, k_scale,
                                              v_scale)
    b, s_v, nh, hd = q.shape
    t, nkv = k.shape[1], k.shape[2]
    g = nh // nkv
    dtype = q.dtype
    scale = 1.0 / (hd ** 0.5) if scale is None else scale
    positions = lengths.to(torch.int64)[:, None] + torch.arange(
        s_v, device=q.device)[None]
    k_pos = torch.arange(t, device=q.device)
    mask = k_pos[None, None, None, :] <= positions[:, None, :, None]
    qg = q.reshape(b, s_v, nkv, g, hd).permute(0, 2, 3, 1, 4)
    att = torch.einsum("bhgqd,bkhd->bhgqk", qg.float(),
                       k.to(dtype).float())
    if k_scale is not None:
        att = att * k_scale.permute(0, 2, 1)[:, :, None, None, :]
    att = att * scale
    att = torch.where(mask[:, :, None], att, torch.full_like(att, F32_MIN))
    probs = torch.softmax(att, dim=-1).to(dtype)
    if v_scale is not None:
        probs = probs * v_scale.permute(0, 2, 1)[
            :, :, None, None, :].to(dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v.to(dtype))
    return out.reshape(b, s_v, nh, hd)


def _lib():
    lib = _build.load("flash_decode")
    if lib.kft_flash_decode.argtypes is None:
        lib.kft_flash_decode_workspace.restype = ctypes.c_longlong
        lib.kft_flash_decode_workspace.argtypes = [ctypes.c_int] * 6
        lib.kft_flash_decode.restype = ctypes.c_int
        lib.kft_flash_decode.argtypes = (
            [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
            + [ctypes.c_longlong] * 2
            + [ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
        lib.kft_flash_decode_paged.restype = ctypes.c_int
        lib.kft_flash_decode_paged.argtypes = (
            [ctypes.c_void_p] * 8 + [ctypes.c_int] * 9
            + [ctypes.c_float, ctypes.c_void_p])
    return lib


@functools.lru_cache(maxsize=None)
def _workspace(b: int, s_v: int, nh: int, nkv: int, hd: int, t: int) -> int:
    """f32 words of workspace the kernel needs: 0 (it merges its split
    inside the launch), or -1 for a shape it cannot hold."""
    return _lib().kft_flash_decode_workspace(b, s_v, nh, nkv, hd, t)


def _check_shape(b: int, s_v: int, nh: int, nkv: int, hd: int,
                 t: int) -> None:
    """Raise for a shape the kernel does not hold. Any g * S_v is held:
    the kernel runs the rows of a kv head in groups of 32, one block
    cluster each; the grid caps slots x kv heads x row groups."""
    if _workspace(b, s_v, nh, nkv, hd, t) < 0:
        raise ValueError(
            f"flash_decode: B={b} x kv={nkv} x ceil(g * S_v / 32) with "
            f"g * S_v = {nh // nkv * s_v} is more (slot, kv head, row "
            "group) columns than the kernel's grid holds")


def check_slab(q, k, v, k_scale, v_scale, name):
    """Shared argument checks of the two attention kernels: q bf16
    contiguous [B, S, H, hd]; k/v [B, T, kv, hd] int8 or bf16 whose
    [T, kv, hd] part is contiguous (the slot stride may be the cache's);
    int8 comes with f32 scales [B, T, kv] laid out the same way."""
    b, _, nh, hd = q.shape
    if q.dtype != torch.bfloat16 or not q.is_contiguous():
        raise TypeError(f"{name}: q must be contiguous bfloat16")
    if hd not in (64, 128):
        raise ValueError(f"{name}: head dim {hd} unsupported (64 or 128)")
    if k.dim() != 4 or k.shape != v.shape or k.shape[0] != b \
            or k.shape[3] != hd:
        raise ValueError(f"{name}: k/v shape {tuple(k.shape)} does not "
                         f"match q {tuple(q.shape)}")
    nkv = k.shape[2]
    if nh % nkv:
        raise ValueError(f"{name}: heads {nh} must divide by kv {nkv}")
    if k.dtype != v.dtype or k.dtype not in (torch.int8, torch.bfloat16):
        raise TypeError(f"{name}: k/v must both be int8 or bfloat16")
    if k.stride() != v.stride() or k.stride()[1:] != (nkv * hd, hd, 1):
        raise ValueError(f"{name}: k/v need contiguous [T, kv, hd] rows "
                         "and equal strides")
    quantized = k.dtype == torch.int8
    if quantized != (k_scale is not None) or \
            (k_scale is None) != (v_scale is None):
        raise ValueError(f"{name}: int8 k/v need k_scale and v_scale, "
                         "float k/v take neither")
    tensors = [q, k, v]
    if quantized:
        if (k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32
                or k_scale.shape != k.shape[:3]
                or v_scale.shape != k.shape[:3]
                or k_scale.stride() != v_scale.stride()
                or k_scale.stride()[1:] != (nkv, 1)):
            raise ValueError(f"{name}: scales must be float32 [B, T, kv] "
                             "with contiguous [T, kv] rows")
        tensors += [k_scale, v_scale]
    if any(t.device != q.device for t in tensors):
        raise ValueError(f"{name}: all tensors must share q's device")
    if (k.data_ptr() % 16 or v.data_ptr() % 16
            or k.stride(0) * k.element_size() % 16):
        raise ValueError(f"{name}: k/v rows must be 16-byte aligned")
    return quantized


def flash_decode_attention(q, k, v, lengths, *, k_scale=None, v_scale=None,
                           scale=None, tables=None, split_slots=None):
    if q.device.type == "cpu":
        return flash_decode_plain(q, k, v, lengths, k_scale=k_scale,
                                  v_scale=v_scale, scale=scale,
                                  tables=tables)
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode: unsupported device {q.device}")
    if q.shape[-1] < KERNEL_MIN_HEAD_DIM:
        return on_padded_heads(flash_decode_attention, q, k, v, scale,
                               lengths=lengths, k_scale=k_scale,
                               v_scale=v_scale, tables=tables,
                               split_slots=split_slots)
    if tables is not None:
        return _flash_decode_paged(q, k, v, lengths, tables, k_scale,
                                   v_scale, scale)
    quantized = check_slab(q, k, v, k_scale, v_scale, "flash_decode")
    b, s_v, nh, hd = q.shape
    t, nkv = k.shape[1], k.shape[2]
    if (lengths.dtype != torch.int32 or lengths.shape != (b,)
            or not lengths.is_contiguous() or lengths.device != q.device):
        raise ValueError("flash_decode: lengths must be int32 [B] on q's "
                         "device")
    _check_shape(b, s_v, nh, nkv, hd, t)
    split_slots = b if split_slots is None else int(split_slots)
    if split_slots < 1:
        raise ValueError("flash_decode: split_slots must be >= 1")
    scale = 1.0 / (hd ** 0.5) if scale is None else scale
    out = torch.empty_like(q)
    dev = q.device
    err = _lib().kft_flash_decode(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        k_scale.data_ptr() if quantized else None,
        v_scale.data_ptr() if quantized else None,
        lengths.data_ptr(), out.data_ptr(), b, s_v, nh, nkv, hd, t,
        split_slots, k.stride(0), k_scale.stride(0) if quantized else 0,
        int(quantized), float(scale),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "flash_decode")
    _build.count_launch("flash_decode", b=b, s_v=s_v, nh=nh, nkv=nkv, hd=hd,
                        t=t, slot_stride=k.stride(0), int8=quantized,
                        split_slots=split_slots)
    return out


def check_paged(q, k, v, k_scale, v_scale, tables, lengths, name):
    """Argument checks of paged mode: q bf16 contiguous [B, S, H, hd];
    k/v one contiguous pool layer [N, bt, kv, hd], int8 with contiguous
    f32 scales [N, bt, kv], or bf16; tables int32 [B, nb] with contiguous
    rows; lengths int32 [B] (None for K3, which takes none); all on q's
    device. Returns (quantized, bt, nb)."""
    b, _, nh, hd = q.shape
    if q.dtype != torch.bfloat16 or not q.is_contiguous():
        raise TypeError(f"{name}: q must be contiguous bfloat16")
    if hd not in (64, 128):
        raise ValueError(f"{name}: head dim {hd} unsupported (64 or 128)")
    if k.dim() != 4 or k.shape != v.shape or k.shape[3] != hd:
        raise ValueError(f"{name}: pool k/v shape {tuple(k.shape)} is not "
                         f"[N, bt, kv, {hd}]")
    nkv = k.shape[2]
    if nh % nkv:
        raise ValueError(f"{name}: heads {nh} must divide by kv {nkv}")
    if k.dtype != v.dtype or k.dtype not in (torch.int8, torch.bfloat16):
        raise TypeError(f"{name}: k/v must both be int8 or bfloat16")
    if not (k.is_contiguous() and v.is_contiguous()):
        raise ValueError(f"{name}: pool k/v must be contiguous")
    quantized = k.dtype == torch.int8
    if quantized != (k_scale is not None) or \
            (k_scale is None) != (v_scale is None):
        raise ValueError(f"{name}: int8 k/v need k_scale and v_scale, "
                         "float k/v take neither")
    tensors = [q, k, v, tables] + ([] if lengths is None else [lengths])
    if quantized:
        if (k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32
                or k_scale.shape != k.shape[:3]
                or v_scale.shape != k.shape[:3]
                or not (k_scale.is_contiguous()
                        and v_scale.is_contiguous())):
            raise ValueError(f"{name}: scales must be contiguous float32 "
                             "[N, bt, kv]")
        tensors += [k_scale, v_scale]
    if (tables.dtype != torch.int32 or tables.dim() != 2
            or tables.shape[0] != b or tables.shape[1] < 1
            or tables.stride(1) != 1):
        raise ValueError(f"{name}: tables must be int32 [B, nb] with "
                         "contiguous rows")
    if lengths is not None and (lengths.dtype != torch.int32
                                or lengths.shape != (b,)
                                or not lengths.is_contiguous()):
        raise ValueError(f"{name}: lengths must be int32 [B]")
    if any(t.device != q.device for t in tensors):
        raise ValueError(f"{name}: all tensors must share q's device")
    if k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError(f"{name}: k/v must be 16-byte aligned")
    return quantized, k.shape[1], tables.shape[1]


def _flash_decode_paged(q, k, v, lengths, tables, k_scale, v_scale, scale):
    """The paged launch of K2 on the card."""
    quantized, bt, nb = check_paged(q, k, v, k_scale, v_scale, tables,
                                    lengths, "flash_decode")
    b, s_v, nh, hd = q.shape
    nkv = k.shape[2]
    _check_shape(b, s_v, nh, nkv, hd, nb * bt)
    scale = 1.0 / (hd ** 0.5) if scale is None else scale
    out = torch.empty_like(q)
    err = _lib().kft_flash_decode_paged(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        k_scale.data_ptr() if quantized else None,
        v_scale.data_ptr() if quantized else None,
        lengths.data_ptr(), tables.data_ptr(), out.data_ptr(), b, s_v, nh,
        nkv, hd, bt, nb, tables.stride(0), int(quantized), float(scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_decode")
    _build.count_launch("flash_decode_paged", b=b, s_v=s_v, nh=nh, nkv=nkv,
                        hd=hd, bt=bt, nb=nb, n_pool=k.shape[0],
                        int8=quantized)
    return out
