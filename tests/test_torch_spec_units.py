"""The port's speculative decoding pieces on the CPU against the JAX
package: `_ngram_draft` on random and hand-made histories, the adaptive
draft length on the same observation streams, K2's plain version at the
verify shapes past 32 query rows a kv head (slab and paged, against the
JAX kernel in interpret mode), the wrapper's checks at those shapes, the
engine's speculation arguments, and the server's config keys reaching the
engine."""

import dataclasses
import json
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.models import llama as jllama
from kubeflow_tpu.ops import flash_decode as jfd
from kubeflow_tpu.serving import llm as jllm
from kubeflow_tpu_torch.models import interop
from kubeflow_tpu_torch.models import llama as tllama
from kubeflow_tpu_torch.ops import flash_decode as tfd
from kubeflow_tpu_torch.serving import llm as tllm
from kubeflow_tpu_torch.serving.server import CompletionServer

torch.set_num_threads(2)

# f32 attention: online softmax (JAX kernel) against one-pass softmax (the
# plain version) differ by f32 rounding only (tests/test_torch_kernel_refs)
ATOL, RTOL = 2e-5, 2e-5


@pytest.fixture(scope="module")
def tiny():
    jcfg = dataclasses.replace(jllama.LlamaConfig.tiny(), dtype=jnp.float32)
    tcfg = dataclasses.replace(tllama.LlamaConfig.tiny(),
                               dtype=torch.float32)
    jparams = jllama.init(jax.random.key(0), jcfg)
    tparams = interop.from_jax_params(jax.tree.map(np.asarray, jparams),
                                      tcfg, device="cpu")
    return jcfg, tcfg, jparams, tparams


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


# -- the drafter --------------------------------------------------------------


def _draft_cases(rng, n):
    """Histories for gram size n: random ones over a small alphabet (many
    matches) and a large one (few), lengths from 0 (shorter than the
    gram) to the end, a repeated tail (a match clipped by the known
    tokens), and the JAX package's hand-made cases."""
    cases = []
    for vocab in (3, 50):
        hist = rng.integers(0, vocab, size=(6, 24)).astype(np.int32)
        lengths = np.array([0, n - 1, n, 9, 17, 23], np.int32)
        cases.append((hist, lengths))
    rep = np.tile(np.array([4, 5, 6], np.int32), 8)[None].repeat(2, 0)
    cases.append((rep, np.array([5, 12], np.int32)))
    cases.append((np.array([[4, 5, 6, 9, 8, 7, 5, 6, 0, 0]], np.int32),
                  np.array([7], np.int32)))
    cases.append((np.array([[1, 2, 3, 4, 5, 0, 0, 0]], np.int32),
                  np.array([4], np.int32)))
    cases.append((np.array([[5, 6, 9, 5, 6, 0, 0, 0]], np.int32),
                  np.array([4], np.int32)))
    return cases


@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_ngram_draft_matches_jax(n):
    rng = np.random.default_rng(n)
    counts = []
    for hist, lengths in _draft_cases(rng, n):
        for k in range(1, 9):
            jd, jc = jllm._ngram_draft(_j(hist), _j(lengths), k, n)
            td, tc = tllm._ngram_draft(_t(hist), _t(lengths), k, n)
            np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
            np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
            assert td.dtype == tc.dtype == torch.int32
            counts += tc.tolist()
    # every regime came up: no draft, a clipped one and a full k
    assert 0 in counts and len(set(counts)) > 3


def test_adaptive_draft_len_matches_jax():
    rng = np.random.default_rng(7)
    for k_max in (1, 3, 4, 6, 16):
        ja = jllm.AdaptiveDraftLen(k_max, 4)
        ta = tllm.AdaptiveDraftLen(k_max, 4)
        assert ta.menu == ja.menu
        for _ in range(60):
            slots = [s for s in range(4) if rng.random() < 0.7]
            assert ta.pick(slots) == ja.pick(slots)
            kd = ja.pick(slots)
            for s in slots:
                acc = int(rng.integers(0, kd + 1))
                ja.observe(s, acc, kd)
                ta.observe(s, acc, kd)
            if rng.random() < 0.1:
                s = int(rng.integers(0, 4))
                ja.reset_slot(s)
                ta.reset_slot(s)
            np.testing.assert_array_equal(ta.ema, ja.ema)
    assert tllm.AdaptiveDraftLen(6, 1).menu == [1, 2, 4, 6]
    assert tllm.SPEC_EMA_ALPHA == jllm.SPEC_EMA_ALPHA
    with pytest.raises(ValueError, match="k_max"):
        tllm.AdaptiveDraftLen(0, 1)


# -- K2 past 32 query rows a kv head (the verify shapes of speculation) ------


@pytest.fixture
def interpret():
    saved = jfd.FORCE_INTERPRET
    jfd.FORCE_INTERPRET = True
    yield
    jfd.FORCE_INTERPRET = saved


def _kv(rng, shape, quantized, junk_block0=False):
    x = rng.normal(size=shape).astype(np.float32)
    if junk_block0:   # the paged trash block: large, finite
        x[0] = 1e4 * rng.normal(size=x[0].shape)
    if not quantized:
        return x, None
    q, s = (np.array(a) for a in jllama.quantize_kv(jnp.asarray(x)))
    if junk_block0:
        s[0] = 1e4
    return q, s


# g = 4 (8 heads on 2 kv heads): S_v 9 and 17 are 36 and 68 query rows a
# kv head, two and three of the CUDA kernel's 32-row groups
@pytest.mark.parametrize("paged", [False, True], ids=["slab", "paged"])
def test_flash_decode_verify_rows_plain_matches_jax(interpret, paged):
    nh, nkv, hd = 8, 2, 16
    for s_v in (9, 17):
        for quantized in (False, True):
            rng = np.random.default_rng(s_v + 2 * quantized + 5 * paged)
            b, span = 4, 48
            lengths = np.array([0, 7, 21, span - s_v], np.int32)
            q = rng.normal(size=(b, s_v, nh, hd)).astype(np.float32)
            tables = None
            if paged:
                bt = 8
                nb, n_pool = span // bt, b * span // bt + 3
                k, ks = _kv(rng, (n_pool, bt, nkv, hd), quantized, True)
                v, vs = _kv(rng, (n_pool, bt, nkv, hd), quantized, True)
                perm = rng.permutation(np.arange(1, n_pool))
                tables = np.zeros((b, nb), np.int32)
                for i in range(b):
                    live = -(-(int(lengths[i]) + s_v) // bt)
                    tables[i, :live] = perm[i * nb:i * nb + live]
            else:
                k, ks = _kv(rng, (b, span, nkv, hd), quantized)
                v, vs = _kv(rng, (b, span, nkv, hd), quantized)
            got = tfd.flash_decode_attention(
                _t(q), _t(k), _t(v), _t(lengths), k_scale=_t(ks),
                v_scale=_t(vs), tables=_t(tables))
            assert got.shape == (b, s_v, nh, hd)
            assert np.isfinite(got.numpy()).all()
            kern = jfd.flash_decode_attention(
                _j(q), _j(k), _j(v), _j(lengths), k_scale=_j(ks),
                v_scale=_j(vs), tables=_j(tables))
            np.testing.assert_allclose(got.numpy(), np.asarray(kern),
                                       atol=ATOL, rtol=RTOL)


class _FakeLib:
    """The workspace query of the C library, as flash_decode.cu answers
    it: 0 for any g * S_v while slots x kv heads x 32-row groups fit the
    grid's 65535 columns, else -1."""

    def kft_flash_decode_workspace(self, b, s_v, nh, nkv, hd, t):
        groups = -(-(nh // nkv) * s_v // 32)
        return 0 if nh % nkv == 0 and b * nkv * groups <= 65535 else -1


def test_flash_decode_verify_rows_pass_the_wrapper_checks(monkeypatch):
    """The argument checks of both modes accept the Llama-3-8B verify
    shapes (32 heads on 8 kv heads, S_v up to 17 = speculative 16), and
    the shape check no longer refuses g * S_v > 32: it raises only when
    the library's workspace query says the grid cannot hold the shape."""
    b, nh, nkv, hd = 16, 32, 8, 128
    monkeypatch.setattr(tfd, "_lib", lambda: _FakeLib())
    tfd._workspace.cache_clear()
    try:
        for s_v in (7, 9, 17):
            q = torch.zeros(b, s_v, nh, hd, dtype=torch.bfloat16)
            k = torch.zeros(b, 64, nkv, hd, dtype=torch.int8)
            s = torch.zeros(b, 64, nkv)
            assert tfd.check_slab(q, k, k, s, s, "t") is True
            pool = torch.zeros(9, 16, nkv, hd, dtype=torch.int8)
            ps = torch.zeros(9, 16, nkv)
            tables = torch.zeros(b, 4, dtype=torch.int32)
            lengths = torch.zeros(b, dtype=torch.int32)
            assert tfd.check_paged(q, pool, pool, ps, ps, tables, lengths,
                                   "t") == (True, 16, 4)
            tfd._check_shape(b, s_v, nh, nkv, hd, 2048)
        with pytest.raises(ValueError, match="grid"):
            tfd._check_shape(4096, 17, nh, nkv, hd, 2048)
    finally:
        tfd._workspace.cache_clear()


# -- the engine's and the server's speculation keys ---------------------------


def test_spec_engine_arguments_match_jax(tiny):
    jcfg, tcfg, jparams, tparams = tiny
    kw = dict(n_slots=2, max_len=48, buckets=(8, 16))
    for bad in (dict(speculative=0), dict(speculative=17),
                dict(speculative=4, spec_ngram=0),
                dict(speculative=4, spec_ngram=9)):
        with pytest.raises(ValueError) as want:
            jllm.LLMEngine(jparams, jcfg, prefer_native=False, **kw, **bad)
        with pytest.raises(ValueError) as got:
            tllm.LLMEngine(tparams, tcfg, device="cpu", **kw, **bad)
        assert str(got.value) == str(want.value)
    for spec, adaptive, menu in ((6, True, [1, 2, 4, 6]), (1, True, None),
                                 (4, False, None), (None, True, None)):
        eng = tllm.LLMEngine(tparams, tcfg, speculative=spec,
                             spec_adaptive=adaptive, device="cpu", **kw)
        ref = jllm.LLMEngine(jparams, jcfg, prefer_native=False,
                             speculative=spec, spec_adaptive=adaptive, **kw)
        assert eng.spec_adaptive == ref.spec_adaptive
        assert (eng._spec_adapt.menu if eng._spec_adapt else None) == menu
        assert ("hist" in eng.cache) == bool(spec)
        if spec:
            assert tuple(eng.cache["hist"].shape) == (2, 48)
            assert eng.cache["hist"].dtype == torch.int32
        want = {k: v for k, v in ref.metrics().items()
                if k.startswith("spec_")}
        got = {k: v for k, v in eng.metrics().items()
               if k.startswith("spec_")}
        assert got == want
        ref.close()


def test_server_config_speculative_reaches_the_engine(tiny):
    """The ISVC's speculation keys build the port's engine through
    `CompletionServer.from_config`, and a completion runs verify rounds."""
    _, tcfg, _, tparams = tiny
    config = {"n_slots": 2, "max_len": 48, "buckets": [8, 16],
              "decode_chunk": 4, "speculative": 3, "spec_ngram": 2,
              "spec_adaptive": False, "logprobs_topk": 2}
    server = CompletionServer.from_config(tparams, tcfg, config,
                                          device="cpu").start()
    try:
        eng = server.engine
        assert (eng.spec, eng.spec_ngram, eng._spec_adapt) == (3, 2, None)
        req = urllib.request.Request(
            server.url + "/openai/v1/completions",
            data=json.dumps({"model": "llama", "prompt": "abcabcabc",
                             "max_tokens": 6}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            body = json.loads(r.read())
        assert len(body["choices"][0]["token_ids"]) == 6
        m = eng.metrics()
        assert m["spec_verify_rounds"] >= 1
        assert m["spec_tokens_emitted"] == 5   # the first from prefill
    finally:
        server.stop()
    with pytest.raises(ValueError, match="unsupported config keys"):
        CompletionServer.from_config(tparams, tcfg, {"spec_draft": 2},
                                     device="cpu")
