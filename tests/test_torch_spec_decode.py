"""The port's speculative decoding on the CPU against the JAX spec engine,
over the JAX package's tiny model trained to continue a repeating 8-gram
(tests/test_spec_decode.py), so drafts accept: one traffic script through
the slab and the paged engine with the prefix cache and logprobs on (a
burst of greedy, seeded-sampled and penalized rows, a chunked prompt that
waits for a slot, then prefix hits and a chunked prompt over a cached
head) gives the JAX engine's greedy and penalized tokens, logprobs, top-N
alternatives, verify rounds, delivered tokens and prefix hits; the same
script equals the port's engine without speculation; and a prefix hit
leaves the slot's token history equal to the cold prefill's."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from kubeflow_tpu.models import llama as jllama
from kubeflow_tpu.serving.llm import LLMEngine as JaxEngine
from kubeflow_tpu_torch.models import interop
from kubeflow_tpu_torch.models import llama as tllama
from kubeflow_tpu_torch.serving.llm import LLMEngine
from kubeflow_tpu_torch.serving.paged import PagedLLMEngine

torch.set_num_threads(2)

PATTERN = [3, 11, 7, 19, 2, 31, 5, 23]
# small programs keep the JAX engine's compiles few: one span (max_len <
# 128), buckets 16/32, chunks 1/2/4, draft lengths 1/2/4
ENGINE = dict(n_slots=4, max_len=96, buckets=(16, 32), decode_chunk=4,
              speculative=4, spec_ngram=2, prefix_cache=True,
              logprobs_topk=3)
LONG = (PATTERN * 6)[:44]              # chunked: 32 + a 12-token tail
# (prompt, max_new, keywords): the first four share the first wave, the
# fifth waits for a slot; the second list runs after the first is idle
WAVE1 = [(PATTERN * 3, 20, {}),
         ([9, 40, 77, 12, 5, 61, 30, 8, 2, 44], 12, {}),
         (PATTERN * 2, 16, dict(temperature=0.8, seed=11)),
         (PATTERN * 2 + [1, 2], 16, dict(presence_penalty=0.5,
                                         frequency_penalty=0.3)),
         (LONG, 20, {})]
# the last row's latest bigram match continues with a corrupted copy of
# the pattern (99 for 31): a draft is rejected and the ones after it match
# the model again, which must not be accepted
WAVE2 = [(PATTERN * 3, 18, {}), (LONG, 14, {}),
         (PATTERN[4:] + PATTERN * 3, 10, {}),
         (PATTERN * 3 + [3, 11, 7, 19, 2, 99, 5, 23, 3, 11, 7, 19], 12, {})]
SAMPLED = {2}
# f32 logits of a 2-layer model in two frameworks (tests/test_torch_llama)
LP_ATOL = 1e-4
SPEC_KEYS = ("spec_verify_rounds", "spec_tokens_emitted",
             "spec_tokens_per_round", "spec_draft_k_max",
             "spec_est_round_tokens", "spec_draft_k_last", "spec_accept_ema")


@pytest.fixture(scope="module")
def trained():
    """The tiny model trained on the repeating 8-gram (the JAX package's
    spec test recipe, in f32), in both frameworks."""
    jcfg = dataclasses.replace(jllama.LlamaConfig.tiny(), dtype=jnp.float32)
    tcfg = dataclasses.replace(tllama.LlamaConfig.tiny(),
                               dtype=torch.float32)
    tokens = np.tile(np.array(PATTERN, np.int32), 32).reshape(4, 64)
    params = jllama.init(jax.random.key(1), jcfg)
    opt = optax.adam(3e-3)
    opt_state = opt.init(params)
    batch = {"tokens": jnp.asarray(tokens)}

    @jax.jit
    def step(params, opt_state):
        (loss, _), grads = jax.value_and_grad(
            jllama.loss_fn, has_aux=True)(params, batch, jcfg)
        updates, opt_state = opt.update(grads, opt_state)
        return optax.apply_updates(params, updates), opt_state, loss

    for _ in range(120):
        params, opt_state, loss = step(params, opt_state)
    assert float(loss) < 0.5
    tparams = interop.from_jax_params(jax.tree.map(np.asarray, params),
                                      tcfg, device="cpu")
    return jcfg, tcfg, params, tparams


def _serve(eng):
    """The traffic script: each wave submitted at once and run to idle."""
    rows = []
    for wave in (WAVE1, WAVE2):
        rids = [eng.submit(p, n, **kw) for p, n, kw in wave]
        eng.run_until_idle()
        rows += [dict(tokens=eng.result(r), lps=eng.result_logprobs(r),
                      top=eng.result_top_logprobs(r),
                      reason=eng.finish_reason(r),
                      cached=eng.cached_tokens(r)) for r in rids]
    m = eng.metrics()
    return rows, {k: m.get(k) for k in SPEC_KEYS + ("prefix_hits",
                                                     "prefix_misses")}


@pytest.fixture(scope="module")
def jax_run(trained):
    jcfg, _, jparams, _ = trained
    eng = JaxEngine(jparams, jcfg, prefer_native=False, **ENGINE)
    out = _serve(eng)
    eng.close()
    return out


@pytest.mark.parametrize("paged", [False, True], ids=["slab", "paged"])
def test_spec_engine_equals_jax(trained, jax_run, paged):
    _, tcfg, _, tparams = trained
    want_rows, want_m = jax_run
    cls = PagedLLMEngine if paged else LLMEngine
    eng = cls(tparams, tcfg, device="cpu", **ENGINE)
    rows, m = _serve(eng)
    assert m == want_m
    # the copy-heavy rows accept drafts: several tokens a round
    assert m["spec_tokens_per_round"] > 1.5 and m["prefix_hits"] >= 2
    for i, (got, want) in enumerate(zip(rows, want_rows)):
        assert len(got["tokens"]) == len(want["tokens"]), i
        assert got["reason"] == want["reason"] == "length"
        assert got["cached"] == want["cached"], i
        if i in SAMPLED:   # the port's draws are its own
            assert len(got["lps"]) == len(got["top"]) == len(got["tokens"])
            continue
        assert got["tokens"] == want["tokens"], i
        np.testing.assert_allclose(got["lps"], want["lps"], atol=LP_ATOL)
        # a top-N list for every emitted token, the JAX engine's
        assert len(got["top"]) == len(got["tokens"])
        for g, w in zip(got["top"], want["top"]):
            assert sorted(g) == sorted(w)
            np.testing.assert_allclose([g[t] for t in sorted(g)],
                                       [w[t] for t in sorted(w)],
                                       atol=LP_ATOL)
    assert eng._pending is None and not eng._inflight.any()
    if paged:
        pool = eng.metrics()["kv_pool"]
        trie = eng.kvcache.stats()["blocks"]
        assert pool["free_blocks"] == pool["pool_blocks"] - trie


@pytest.mark.parametrize("paged", [False, True], ids=["slab", "paged"])
def test_spec_tokens_equal_plain_engine(trained, paged):
    """Greedy and penalized rows are the engine's own output without
    speculation; the seeded sampled row too, since it drafts nothing and
    draws at the same positions; and sampled rows verify one token a
    round."""
    _, tcfg, _, tparams = trained
    cls = PagedLLMEngine if paged else LLMEngine
    plain_kw = dict(ENGINE, speculative=None)
    plain, _ = _serve(cls(tparams, tcfg, device="cpu", **plain_kw))
    eng = cls(tparams, tcfg, device="cpu", **ENGINE)
    rows, _ = _serve(eng)
    assert [r["tokens"] for r in rows] == [r["tokens"] for r in plain]
    for got, want in zip(rows, plain):
        np.testing.assert_allclose(got["lps"], want["lps"], atol=LP_ATOL)
    # only the sampled row on its own: one token a round
    eng = cls(tparams, tcfg, device="cpu", **ENGINE)
    p, n, kw = WAVE1[2]
    rid = eng.submit(p, n, **kw)
    eng.run_until_idle()
    m = eng.metrics()
    assert eng.result(rid) == plain[2]["tokens"]
    assert m["spec_verify_rounds"] == m["spec_tokens_emitted"] == n - 1


@pytest.mark.parametrize("paged", [False, True], ids=["slab", "paged"])
def test_prefix_hit_history_equals_cold_prefill(trained, paged):
    """After the prefill wave, a slot's token history holds the prompt;
    a prefix hit (continuation wave over a cached block, or a chunked
    chain from a cached head, spliced from shared blocks on the paged
    engine) leaves the same history as the cold prefill, though another
    prompt used the slot in between."""
    _, tcfg, _, tparams = trained
    cls = PagedLLMEngine if paged else LLMEngine
    eng = cls(tparams, tcfg, device="cpu", **ENGINE)
    for prompt in (PATTERN * 3, LONG):
        other = [(t * 5 + 1) % 500 for t in prompt]
        hists = []
        for p in (prompt, other, prompt):    # cold, a miss, a hit
            rid = eng.submit(p, 4)
            hits = eng.metrics()["prefix_hits"]
            eng.step()        # the prefill
            slot = next(s for s in range(eng.n_slots)
                        if eng.scheduler.slot_request(s) == rid)
            hists.append((slot, eng.cache["hist"][slot, :len(p)].tolist()))
            eng.run_until_idle()
        assert eng.metrics()["prefix_hits"] == hits + 1
        assert hists[0] == hists[2] == (hists[1][0], prompt)
        assert hists[1][1] == other
