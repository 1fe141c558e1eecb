"""The plain PyTorch version of each ported kernel against the JAX
package's TPU kernel, run by the Pallas interpreter on the CPU as the JAX
package's own tests run it (FORCE_INTERPRET, restored afterwards), and
against the JAX xla branch. On CPU tensors the port's wrappers run the
plain versions, so these are the functions the CUDA kernels are held to
on the card (chip_smoke.py)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import ml_dtypes

from kubeflow_tpu.models import llama as jllama
from kubeflow_tpu.ops import flash_decode as jfd
from kubeflow_tpu.ops import flash_prefill as jfp
from kubeflow_tpu.ops import quant as jquant
from kubeflow_tpu.ops import quant_matmul as jqm
from kubeflow_tpu_torch.models import llama as tllama
from kubeflow_tpu_torch.ops import _build
from kubeflow_tpu_torch.ops import flash_decode as tfd
from kubeflow_tpu_torch.ops import flash_prefill as tfp
from kubeflow_tpu_torch.ops import quant as tquant
from kubeflow_tpu_torch.ops import quant_matmul as tqm

torch.set_num_threads(2)

# f32 attention: online softmax (JAX kernel) vs one-pass softmax (plain
# version) differ by f32 rounding only
ATOL, RTOL = 2e-5, 2e-5


@pytest.fixture
def interpret():
    saved = (jfd.FORCE_INTERPRET, jfp.FORCE_INTERPRET, jqm.FORCE_INTERPRET)
    jfd.FORCE_INTERPRET = jfp.FORCE_INTERPRET = jqm.FORCE_INTERPRET = True
    yield
    jfd.FORCE_INTERPRET, jfp.FORCE_INTERPRET, jqm.FORCE_INTERPRET = saved


def _cfg(nh, nkv, hd):
    return jllama.LlamaConfig(vocab_size=64, d_model=nh * hd, n_layers=1,
                              n_heads=nh, n_kv_heads=nkv, d_ff=32,
                              max_seq_len=512, dtype=jnp.float32)


def _kv(rng, shape, quantized):
    """(numpy k, numpy scale | None) — int8 through the JAX quantizer."""
    x = rng.normal(size=shape).astype(np.float32)
    if not quantized:
        return x, None
    q, s = jllama.quantize_kv(jnp.asarray(x))
    return np.asarray(q), np.asarray(s)


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


# S_v = 8 at g = 4 is the CUDA kernel's 32-row limit; all lengths 0 is
# the first decode step, where each block's share of the live keys is
# one tile or none
@pytest.mark.parametrize("s_v,zero_lengths", [
    pytest.param(1, False, id="1"), pytest.param(4, False, id="4"),
    pytest.param(8, False, id="8"), pytest.param(1, True, id="1-len0"),
    pytest.param(8, True, id="8-len0")])
@pytest.mark.parametrize("quantized", [False, True])
def test_flash_decode_plain_matches_jax(interpret, s_v, zero_lengths,
                                        quantized):
    nh, nkv, hd, t = 8, 2, 16, 40        # GQA 4:1
    rng = np.random.default_rng(10 + s_v)
    lengths = np.array([0, 7, 21, t - s_v], np.int32)   # ragged
    if zero_lengths:
        lengths[:] = 0
    b = len(lengths)
    q = rng.normal(size=(b, s_v, nh, hd)).astype(np.float32)
    k, ks = _kv(rng, (b, t, nkv, hd), quantized)
    v, vs = _kv(rng, (b, t, nkv, hd), quantized)
    got = tfd.flash_decode_attention(_t(q), _t(k), _t(v), _t(lengths),
                                     k_scale=_t(ks), v_scale=_t(vs))
    kern = jfd.flash_decode_attention(_j(q), _j(k), _j(v), _j(lengths),
                                      k_scale=_j(ks), v_scale=_j(vs))
    np.testing.assert_allclose(got.numpy(), np.asarray(kern), atol=ATOL,
                               rtol=RTOL)
    positions = jnp.asarray(lengths)[:, None] + jnp.arange(s_v)[None]
    xla = jllama.decode_attention(_cfg(nh, nkv, hd), _j(q), _j(k), _j(v),
                                  _j(ks), _j(vs), positions, impl="xla")
    np.testing.assert_allclose(got.reshape(b, s_v, -1).numpy(),
                               np.asarray(xla), atol=ATOL, rtol=RTOL)


# (quantized, q_offset, group): every group size the CUDA kernel packs into
# its 128-row tile differently (1, 4, 8 query heads per kv head), and a
# ragged continuation offset in int8; the group-4 cases keep the ids
# "quantized-q_offset"
_PREFILL_CASES = (
    [pytest.param(qz, off, 4, id=f"{qz}-{off}")
     for qz in (False, True) for off in (0, 24)]
    + [pytest.param(qz, off, g, id=f"g{g}-{qz}-{off}")
       for g in (1, 8) for qz in (False, True) for off in (0, 24)]
    + [pytest.param(True, 37, g, id=f"g{g}-True-37") for g in (1, 4, 8)])


@pytest.mark.parametrize("quantized,q_offset,group", _PREFILL_CASES)
def test_flash_prefill_plain_matches_jax(interpret, q_offset, quantized,
                                         group):
    nh, hd, s = 8, 16, 20
    nkv = nh // group
    t = q_offset + s
    rng = np.random.default_rng(20 + q_offset)
    q = rng.normal(size=(2, s, nh, hd)).astype(np.float32)
    k, ks = _kv(rng, (2, t, nkv, hd), quantized)
    v, vs = _kv(rng, (2, t, nkv, hd), quantized)
    got = tfp.flash_prefill_attention(_t(q), _t(k), _t(v),
                                      q_offset=q_offset, k_scale=_t(ks),
                                      v_scale=_t(vs))
    kern = jfp.flash_prefill_attention(_j(q), _j(k), _j(v),
                                       q_offset=q_offset, k_scale=_j(ks),
                                       v_scale=_j(vs))
    np.testing.assert_allclose(got.numpy(), np.asarray(kern), atol=ATOL,
                               rtol=RTOL)
    xla = jllama.prefill_attention(_cfg(nh, nkv, hd), _j(q), _j(k), _j(v),
                                   _j(ks), _j(vs), q_offset=q_offset,
                                   impl="xla")
    np.testing.assert_allclose(got.numpy(), np.asarray(xla), atol=ATOL,
                               rtol=RTOL)


# m = 13 and 128 are the CUDA kernel's tile edges (its activation rows
# round up to 16) and the gate's top; (512, 384) is a width that is not a
# multiple of the JAX kernel's 512-column block
@pytest.mark.parametrize("m,d,o", [
    pytest.param(1, 256, 128, id="1"), pytest.param(8, 256, 128, id="8"),
    pytest.param(13, 256, 128, id="13"),
    pytest.param(128, 256, 128, id="128"),
    pytest.param(8, 512, 384, id="8-512x384"),
    pytest.param(13, 512, 384, id="13-512x384")])
@pytest.mark.parametrize("out", ["float32", "bfloat16"])
def test_dequant_matmul_plain_matches_jax(interpret, m, d, o, out):
    rng = np.random.default_rng(30 + m)
    x = rng.normal(size=(m, d)).astype(np.float32)
    w = rng.normal(size=(d, o)).astype(np.float32)
    jw = jquant.quantize_int8(jnp.asarray(w))
    q, s = np.asarray(jw["q"]), np.asarray(jw["s"])
    assert tqm.kernel_applicable(m, d, o) and jqm.kernel_applicable(m, d, o)
    t_out = getattr(torch, out)
    got = tqm.dequant_matmul(_t(x), _t(q), _t(s), t_out).float().numpy()
    kern = np.asarray(jqm.dequant_matmul(_j(x), _j(q), _j(s),
                                         getattr(jnp, out))
                      ).astype(np.float32)
    # a 256-long f32 sum in two orders; bf16 output may differ by one
    # rounding step of the output where the f32 sums straddle a tie
    tol = 1e-4 if out == "float32" else 2 ** -7
    np.testing.assert_allclose(got, kern, atol=tol * np.abs(kern).max(),
                               rtol=0)
    # xla branch: the f32-output product of the bf16-rounded rows
    xb = x.astype(ml_dtypes.bfloat16).astype(np.float32)
    xla = np.asarray(jquant.matmul_f32_out(jnp.asarray(xb), jw,
                                           jnp.float32))
    np.testing.assert_allclose(got, xla, atol=tol * np.abs(xla).max(),
                               rtol=0)
    # and the port's quant.matmul routes this shape to the same wrapper
    via_quant = tquant.matmul_f32_out(
        _t(x), {"q": _t(q), "s": _t(s)}, torch.float32)
    np.testing.assert_allclose(via_quant.numpy(),
                               tqm.dequant_matmul_plain(
                                   _t(x), _t(q), _t(s),
                                   torch.float32).numpy(), rtol=0, atol=0)


def test_kernel_wrappers_reject_unsupported_devices():
    x = torch.zeros(2, 256, device="meta")
    with pytest.raises(ValueError):
        tqm.dequant_matmul(x, torch.zeros(256, 128, dtype=torch.int8),
                           torch.zeros(128), torch.float32)
    q = torch.zeros(1, 1, 8, 16, device="meta")
    with pytest.raises(ValueError):
        tfd.flash_decode_attention(q, q, q, torch.zeros(1, dtype=torch.int32))
    with pytest.raises(ValueError):
        tfp.flash_prefill_attention(q, q, q)


def test_launch_counts_by_shape_and_plain_runs_count_nothing():
    _build.reset_launches()
    x = torch.ones(3, 256)
    tqm.dequant_matmul(x, torch.ones(256, 128, dtype=torch.int8),
                       torch.ones(128), torch.float32)
    assert _build.LAUNCHES == {name: 0 for name in _build.KERNELS}
    assert all(not by_shape for by_shape in _build.SHAPES.values())
    for _ in range(2):
        _build.count_launch("flash_decode", b=8, t=1024)
    _build.count_launch("flash_decode", b=8, t=2048)
    assert _build.LAUNCHES["flash_decode"] == 3
    assert _build.SHAPES["flash_decode"] == {
        (("b", 8), ("t", 1024)): 2, (("b", 8), ("t", 2048)): 1}
    _build.reset_launches()
    assert _build.LAUNCHES["flash_decode"] == 0
    assert not _build.SHAPES["flash_decode"]

