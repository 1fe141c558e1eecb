"""The port's Llama serving functions against the JAX package's on the
tiny config in f32, from the same params (models/interop.py converts the
JAX tree): prefill, prefill_continue, decode_step and verify_step (S_v=4),
logits and the new KV, with float weights and KV and with int8 weights
and KV."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.models import llama as jllama
from kubeflow_tpu_torch.models import interop
from kubeflow_tpu_torch.models import llama as tllama

torch.set_num_threads(2)

# a 2-layer f32 model evaluated by two frameworks: f32 rounding only
ATOL, RTOL = 1e-4, 1e-4
MAX_LEN = 48


@pytest.fixture(scope="module")
def models():
    jcfg = dataclasses.replace(jllama.LlamaConfig.tiny(), dtype=jnp.float32)
    tcfg = dataclasses.replace(tllama.LlamaConfig.tiny(),
                               dtype=torch.float32)
    jparams = jllama.init(jax.random.key(0), jcfg)
    out = {}
    for quantized in (False, True):
        jp = jllama.quantize_params(jparams) if quantized else jparams
        tp = interop.from_jax_params(jax.tree.map(np.asarray, jp), tcfg,
                                     device="cpu")
        out[quantized] = (jp, tp)
    return jcfg, tcfg, out


def _close(t, j):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=ATOL,
                               rtol=RTOL)


def _tokens(shape, seed):
    return np.random.default_rng(seed).integers(0, 512, size=shape,
                                                dtype=np.int32)


def test_from_jax_params_copies_every_leaf(models):
    _, tcfg, out = models
    jp, tp = out[True]
    np.testing.assert_array_equal(tp["layers"]["wq"]["q"].numpy(),
                                  np.asarray(jp["layers"]["wq"]["q"]))
    np.testing.assert_array_equal(tp["lm_head"]["s"].numpy(),
                                  np.asarray(jp["lm_head"]["s"]))
    assert tp["layers"]["w_down"]["q"].shape == (
        tcfg.n_layers, tcfg.d_ff, tcfg.d_model)
    with pytest.raises(ValueError):
        interop.from_jax_params(
            jax.tree.map(np.asarray, jp),
            dataclasses.replace(tcfg, n_layers=3), device="cpu")


@pytest.mark.parametrize("quantized", [False, True])
def test_prefill_and_continue_match_jax(models, quantized):
    jcfg, tcfg, out = models
    jp, tp = out[quantized]
    toks = _tokens((2, 16), 1)
    jl, jk, jv = jllama.prefill(jp, jnp.asarray(toks), jcfg)
    tl, tk, tv = tllama.prefill(tp, torch.from_numpy(toks).long(), tcfg)
    _close(tl, jl)
    _close(tk, jk)
    _close(tv, jv)
    tail = _tokens((2, 8), 2)
    jl2, jk2, jv2 = jllama.prefill_continue(jp, jnp.asarray(tail), jk, jv,
                                            jcfg)
    tl2, tk2, tv2 = tllama.prefill_continue(
        tp, torch.from_numpy(tail).long(), tk, tv, tcfg)
    _close(tl2, jl2)
    _close(tk2, jk2)
    _close(tv2, jv2)


def _caches(jcfg, tcfg, kvq, seed):
    """Matching JAX and port caches holding the same random prefix KV."""
    jc = jllama.init_cache(jcfg, 2, MAX_LEN, kv_quantize=kvq)
    rng = np.random.default_rng(seed)
    shape = jc["k"].shape
    kf = rng.normal(size=shape).astype(np.float32)
    vf = rng.normal(size=shape).astype(np.float32)
    if kvq:
        kq, ks = jllama.quantize_kv(jnp.asarray(kf))
        vq, vs = jllama.quantize_kv(jnp.asarray(vf))
        jc = {"k": kq, "v": vq, "k_s": ks, "v_s": vs}
    else:
        jc = {"k": jnp.asarray(kf), "v": jnp.asarray(vf)}
    tc = {k: torch.from_numpy(np.array(v)) for k, v in jc.items()}
    return jc, tc


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("s_v", [1, 4])
def test_decode_and_verify_match_jax(models, quantized, s_v):
    jcfg, tcfg, out = models
    jp, tp = out[quantized]
    kvq = "int8" if quantized else None
    jc, tc = _caches(jcfg, tcfg, kvq, 3 + s_v)
    # slot 1 sits at the cache's end: with S_v=4 two of its rows fall past
    # max_len and must be dropped, not clamped onto the last live row
    lengths = np.array([5, MAX_LEN - 2], np.int32)
    toks = _tokens((2, s_v), 4)
    if s_v == 1:
        jl, jnew = jllama.decode_step(jp, jnp.asarray(toks[:, 0]), jc,
                                      jnp.asarray(lengths), jcfg)
        tl = tllama.decode_step(tp, torch.from_numpy(toks[:, 0]).long(),
                                tc, torch.from_numpy(lengths), tcfg)
    else:
        jl, jnew = jllama.verify_step(jp, jnp.asarray(toks), jc,
                                      jnp.asarray(lengths), jcfg)
        tl = tllama.verify_step(tp, torch.from_numpy(toks).long(), tc,
                                torch.from_numpy(lengths), tcfg)
    _close(tl, jl)
    for name in jnew:
        if quantized and name in ("k", "v"):
            # int8 payloads: f32 rounding may move a value across a
            # rounding boundary by one step
            diff = np.abs(tc[name].numpy().astype(np.int32)
                          - np.asarray(jnew[name]).astype(np.int32))
            assert diff.max() <= 1
        else:
            _close(tc[name], jnew[name])


def test_decode_span_matches_full_span(models):
    """A span that covers every live length gives the full-span logits
    (softmax sums of another length: f32 rounding)."""
    _, tcfg, out = models
    _, tp = out[True]
    jcfg = dataclasses.replace(jllama.LlamaConfig.tiny(), dtype=jnp.float32)
    _, tc1 = _caches(jcfg, tcfg, "int8", 9)
    tc2 = {k: v.clone() for k, v in tc1.items()}
    lengths = torch.tensor([3, 20], dtype=torch.int32)
    toks = torch.tensor([7, 9])
    full = tllama.decode_step(tp, toks, tc1, lengths, tcfg)
    short = tllama.decode_step(tp, toks, tc2, lengths, tcfg, span=24)
    torch.testing.assert_close(short, full, atol=1e-5, rtol=1e-5)
