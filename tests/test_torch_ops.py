"""CPU parity of the port's plain ops (kubeflow_tpu_torch.ops) against the
JAX package's: the same numpy inputs, made from a seed, go through both.
f32 throughout, so the tolerances are f32 rounding; int8 quantization
must give identical bytes."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kubeflow_tpu.models import llama as jllama
from kubeflow_tpu.ops import attention as jattn
from kubeflow_tpu.ops import norms as jnorms
from kubeflow_tpu.ops import quant as jquant
from kubeflow_tpu.ops import rope as jrope
from kubeflow_tpu_torch.models import llama as tllama
from kubeflow_tpu_torch.ops import attention as tattn
from kubeflow_tpu_torch.ops import norms as tnorms
from kubeflow_tpu_torch.ops import quant as tquant
from kubeflow_tpu_torch.ops import rope as trope

torch.set_num_threads(2)

# f32 elementwise/reduction math in two frameworks: a few ulps
ATOL, RTOL = 1e-5, 1e-5


def _rng(seed=0):
    return np.random.default_rng(seed)


def _close(t, j, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                               atol=atol, rtol=rtol)


def test_rms_norm_matches_jax():
    rng = _rng(1)
    x = rng.normal(size=(2, 5, 64)).astype(np.float32)
    w = rng.normal(size=(64,)).astype(np.float32)
    _close(tnorms.rms_norm(torch.from_numpy(x), torch.from_numpy(w)),
           jnorms.rms_norm(jnp.asarray(x), jnp.asarray(w)))


@pytest.mark.parametrize("pos_ndim", [1, 2])
def test_apply_rope_matches_jax(pos_ndim):
    rng = _rng(2)
    x = rng.normal(size=(2, 6, 4, 16)).astype(np.float32)
    pos = (np.arange(6, dtype=np.int32) + 37 if pos_ndim == 1
           else rng.integers(0, 500, size=(2, 6)).astype(np.int32))
    # angles up to ~500 rad: sin/cos of large f32 arguments differ by an
    # ulp or two of the angle between the two libraries
    _close(trope.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                            theta=10000.0),
           jrope.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                            theta=10000.0), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("q_offset", [0, 5])
def test_mha_matches_jax(q_offset):
    rng = _rng(3)
    q = rng.normal(size=(2, 4, 8, 16)).astype(np.float32)
    k = rng.normal(size=(2, 4 + q_offset, 2, 16)).astype(np.float32)
    v = rng.normal(size=(2, 4 + q_offset, 2, 16)).astype(np.float32)
    _close(tattn.mha(torch.from_numpy(q), torch.from_numpy(k),
                     torch.from_numpy(v), causal=True, q_offset=q_offset),
           jattn.mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     causal=True, q_offset=q_offset))


def test_quantize_int8_bytes_identical():
    rng = _rng(4)
    # values on exact .5 steps of their channel scale exercise the
    # round-half-to-even rule
    w = rng.normal(size=(3, 64, 32)).astype(np.float32)
    w[0, :4, 0] = np.array([127.0, 0.5, -1.5, 2.5], np.float32)
    t = tquant.quantize_int8(torch.from_numpy(w))
    j = jquant.quantize_int8(jnp.asarray(w))
    np.testing.assert_array_equal(t["q"].numpy(), np.asarray(j["q"]))
    np.testing.assert_array_equal(t["s"].numpy(), np.asarray(j["s"]))


def test_quantize_kv_bytes_identical():
    rng = _rng(5)
    x = rng.normal(size=(2, 7, 4, 16)).astype(np.float32)
    x[0, 0, 0, :4] = np.array([127.0, 0.5, -1.5, 2.5], np.float32)
    tq, ts = tllama.quantize_kv(torch.from_numpy(x))
    jq, js = jllama.quantize_kv(jnp.asarray(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    _close(tllama.dequantize_kv(tq, ts, torch.float32),
           jllama.dequantize_kv(jq, js, jnp.float32))


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("f32_out", [False, True])
def test_quant_matmul_matches_jax(quantized, f32_out):
    """Shapes under the K1 kernel gate (d % 256 != 0): both frameworks
    take their plain product."""
    rng = _rng(6)
    x = rng.normal(size=(2, 3, 64)).astype(np.float32)
    w = rng.normal(size=(64, 48)).astype(np.float32)
    tw = (tquant.quantize_int8(torch.from_numpy(w)) if quantized
          else torch.from_numpy(w))
    jw = jquant.quantize_int8(jnp.asarray(w)) if quantized \
        else jnp.asarray(w)
    if f32_out:
        t = tquant.matmul_f32_out(torch.from_numpy(x), tw, torch.float32)
        j = jquant.matmul_f32_out(jnp.asarray(x), jw, jnp.float32)
    else:
        t = tquant.matmul(torch.from_numpy(x), tw, torch.float32)
        j = jquant.matmul(jnp.asarray(x), jw, jnp.float32)
    # a 64-long f32 contraction summed in two orders
    _close(t, j, atol=1e-4, rtol=1e-5)
