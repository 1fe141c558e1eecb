"""The port's full sampler on the CPU against the JAX engine: `_choose` on
fixed logits (greedy bits under penalties, the top-k/top-p candidate
sets), `_fold_seed24` and the sampling-row quantization bit for bit,
penalized greedy tokens and greedy logprobs equal to the JAX `LLMEngine`
on the tiny config (f32 and int8), zero penalties bit-exact, penalty
counts reset between a slot's occupants, seeded draws independent of
slot, batchmates, chunking, pipelining and KV layout, the submit-time
errors of the JAX engine, and the HTTP surface of these fields."""

import dataclasses
import json
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.models import llama as jllama
from kubeflow_tpu.serving import llm as jllm
from kubeflow_tpu.serving.llm import LLMEngine as JaxEngine
from kubeflow_tpu_torch.models import interop
from kubeflow_tpu_torch.models import llama as tllama
from kubeflow_tpu_torch.serving import llm as tllm
from kubeflow_tpu_torch.serving.llm import LLMEngine
from kubeflow_tpu_torch.serving.paged import PagedLLMEngine
from kubeflow_tpu_torch.serving.server import CompletionServer

torch.set_num_threads(2)

ENGINE = dict(n_slots=2, max_len=48, buckets=(8, 16))
PROMPT = [3, 17, 42, 9]
PENALTIES = ((0.9, 0.0), (0.0, 1.3), (0.7, 0.4))
NEW = 10
# f32 logprobs of a 2-layer model in two frameworks
LP_ATOL = 1e-5


@pytest.fixture(scope="module")
def tiny():
    jcfg = dataclasses.replace(jllama.LlamaConfig.tiny(), dtype=jnp.float32)
    tcfg = dataclasses.replace(tllama.LlamaConfig.tiny(),
                               dtype=torch.float32)
    jparams = jllama.init(jax.random.key(0), jcfg)
    tparams = interop.from_jax_params(jax.tree.map(np.asarray, jparams),
                                      tcfg, device="cpu")
    return jcfg, tcfg, jparams, tparams


def _penalized_and_logprob_runs(eng):
    """The runs both engines make: each penalty pair on PROMPT, then a
    greedy burst whose logprobs are compared."""
    out = {}
    for pres, freq in PENALTIES:
        rid = eng.submit(PROMPT, NEW, presence_penalty=pres,
                         frequency_penalty=freq)
        eng.run_until_idle()
        out[pres, freq] = eng.result(rid)
    rids = [eng.submit(p, 6) for p in ([4, 40, 4], PROMPT)]
    eng.run_until_idle()
    out["greedy"] = [(eng.result(r), eng.result_logprobs(r),
                      eng.result_top_logprobs(r)) for r in rids]
    return out


@pytest.fixture(scope="module")
def jax_runs(tiny):
    jcfg, _, jparams, _ = tiny
    out = {}
    for quant in (None, "int8"):
        eng = JaxEngine(jparams, jcfg, prefer_native=False, quantize=quant,
                        kv_quantize=quant, logprobs_topk=3, **ENGINE)
        out[quant] = _penalized_and_logprob_runs(eng)
        out[quant, "engine"] = eng
    return out


def test_fold_seed24_and_row_quantization_bit_equal_to_jax(jax_runs):
    rng = np.random.default_rng(0)
    seeds = [0, 1, 1234, 2**24, 2**32 + 7, 2**63 - 1] + [
        int(s) for s in rng.integers(0, 2**62, 50)]
    assert [tllm._fold_seed24(s) for s in seeds] == \
        [jllm._fold_seed24(s) for s in seeds]
    for v in (0.0, 0.0004, -0.0004, 0.5, -1.3, 2.0, 1e-9):
        assert LLMEngine._pack_milli(v) == JaxEngine._pack_milli(v)
    for t in (0.0, 1e-5, 0.7, 1.25, 100.0):
        assert LLMEngine._pack_temp(t) == JaxEngine._pack_temp(t)
    # the f32 sampling row the JAX programs unpack from a packed wave row
    jeng = jax_runs[None, "engine"]
    row = (0.7, 5, 0.9, 0.3, -1.2, tllm._fold_seed24(99))
    packed = jeng._pack_rows(1, 4, [([1, 2], 0, 2) + row])
    want = np.asarray(jeng._unpack_wave(jnp.asarray(packed))[3])[0]
    port = LLMEngine.__new__(LLMEngine)
    got = np.array(port._samp_row(*row), np.float32)
    np.testing.assert_array_equal(got, want)


def _fixed_logits(rows, vocab, seed):
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((rows, vocab)) * 3).astype(np.float32)
    counts = rng.integers(0, 3, (rows, vocab)).astype(np.int32)
    counts[rng.random((rows, vocab)) < 0.9] = 0
    return logits, counts


def test_choose_greedy_bits_match_jax_with_penalties(tiny, jax_runs):
    """temperature-0 rows: the argmax of the penalized logits, the same
    token as the JAX `_choose`, over zero, presence, frequency and mixed
    penalties."""
    _, tcfg, _, tparams = tiny
    jeng = jax_runs[None, "engine"]
    teng = LLMEngine(tparams, tcfg, device="cpu", **ENGINE)
    logits, counts = _fixed_logits(8, tcfg.vocab_size, 1)
    counts[np.arange(8), logits.argmax(-1)] = 2   # penalize the argmax
    samp = np.zeros((8, 6), np.float32)
    samp[:, 5] = -1
    samp[:, 3] = [0, 0.9, 0, 0.7, -1.5, 2, 0, 0.001]
    samp[:, 4] = [0, 0, 1.3, 0.4, 0, -2, 0.5, 0]
    slots = np.arange(8) % 2
    pos = np.full(8, 7, np.int32)
    _, want = jeng._choose(jnp.asarray(logits), jnp.asarray(samp),
                           jax.random.key(0), jnp.asarray(slots),
                           jnp.asarray(counts), jnp.asarray(pos))
    for sampling in (False, True):
        got = teng._choose(torch.from_numpy(logits), torch.from_numpy(samp),
                           torch.from_numpy(slots), torch.from_numpy(counts),
                           torch.from_numpy(pos), sampling)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the penalties moved some argmax, so the edit is really applied
    assert (np.asarray(want) != logits.argmax(-1)).any()


def test_choose_candidate_sets_match_jax(tiny, jax_runs):
    """Sampled rows: the tokens the JAX `_choose` draws over many keys
    are exactly the port's top-k/top-p candidate set, and every port draw
    lies in it."""
    _, tcfg, _, tparams = tiny
    jeng = jax_runs[None, "engine"]
    teng = LLMEngine(tparams, tcfg, device="cpu", **ENGINE)
    logits, counts = _fixed_logits(6, tcfg.vocab_size, 2)
    samp = np.zeros((6, 6), np.float32)
    samp[:, 5] = -1
    samp[:, 0] = 2.0                            # flat enough to visit all
    samp[:, 1] = [1, 3, 5, 0, 0, 4]             # top_k
    samp[:, 2] = [1, 1, 0.9, 0.3, 0.05, 0.5]    # top_p
    samp[:, 3] = [0, 0.5, 0, 0, 1.0, 0]
    slots = np.arange(6) % 2
    pos = np.full(6, 9, np.int32)
    choose = jax.jit(jeng._choose)
    seen = [set() for _ in range(6)]
    for i in range(300):
        _, toks = choose(jnp.asarray(logits), jnp.asarray(samp),
                         jax.random.key(i), jnp.asarray(slots),
                         jnp.asarray(counts), jnp.asarray(pos))
        for r, t in enumerate(np.asarray(toks)):
            seen[r].add(int(t))
    lg = torch.from_numpy(logits)
    lg = (lg - torch.from_numpy(samp[:, 3:4]) * (torch.from_numpy(counts) > 0)
          - torch.from_numpy(samp[:, 4:5]) * torch.from_numpy(counts))
    probs = torch.softmax(lg / torch.from_numpy(samp[:, :1]), dim=-1)
    mask = teng._sample_mask(probs, torch.from_numpy(samp[:, 1]),
                             torch.from_numpy(samp[:, 2])).numpy()
    for r in range(6):
        assert seen[r] == set(np.flatnonzero(mask[r]).tolist()), r
    assert len(seen[0]) == 1 and len(seen[2]) > 1
    drawn = [set() for _ in range(6)]
    for _ in range(50):   # each call advances the draw counter
        got = teng._choose(torch.from_numpy(logits), torch.from_numpy(samp),
                           torch.from_numpy(slots), torch.from_numpy(counts),
                           torch.from_numpy(pos), True)
        for r, t in enumerate(got.tolist()):
            drawn[r].add(t)
    assert all(drawn[r] <= seen[r] for r in range(6))
    assert len(drawn[2]) > 1


@pytest.mark.parametrize("quant", [None, "int8"])
def test_penalized_greedy_and_logprobs_equal_jax_engine(tiny, jax_runs,
                                                        quant):
    _, tcfg, _, tparams = tiny
    teng = LLMEngine(tparams, tcfg, quantize=quant, kv_quantize=quant,
                     logprobs_topk=3, device="cpu", **ENGINE)
    got = _penalized_and_logprob_runs(teng)
    want = jax_runs[quant]
    for key in PENALTIES:
        assert got[key] == want[key], key
    # the penalties changed the greedy output
    plain = teng.generate(PROMPT, NEW)
    assert any(got[key] != plain for key in PENALTIES)
    for (gt, glp, gtop), (wt, wlp, wtop) in zip(got["greedy"],
                                                want["greedy"]):
        assert gt == wt
        np.testing.assert_allclose(glp, wlp, atol=LP_ATOL)
        for g, w in zip(gtop, wtop):
            assert list(g) == list(w)   # the same ids, best first
            np.testing.assert_allclose(list(g.values()), list(w.values()),
                                       atol=LP_ATOL)
        for tok, lp, top in zip(gt, glp, gtop):
            # greedy: the chosen token is the top-1 alternative
            assert max(top, key=top.get) == tok and top[tok] == lp
            assert lp <= 0


def test_penalized_greedy_independent_of_chunking_and_pipelining(
        tiny, jax_runs):
    """The counts advance on the device every step, so a penalized
    request's tokens do not depend on the chunk length or on a chunk in
    flight."""
    _, tcfg, _, tparams = tiny
    key = PENALTIES[2]
    for kw in (dict(decode_chunk=1), dict(decode_chunk=2),
               dict(decode_chunk=8, pipeline_decode=False)):
        eng = LLMEngine(tparams, tcfg, device="cpu", **ENGINE, **kw)
        got = eng.generate(PROMPT, NEW, presence_penalty=key[0],
                           frequency_penalty=key[1])
        assert got == jax_runs[None][key], kw


def test_zero_penalty_is_bit_exact_greedy(tiny):
    _, tcfg, _, tparams = tiny
    eng = LLMEngine(tparams, tcfg, device="cpu", **ENGINE)
    plain = eng.submit(PROMPT, 8)
    eng.run_until_idle()
    zero = eng.submit(PROMPT, 8, presence_penalty=0.0,
                      frequency_penalty=0.0)
    eng.run_until_idle()
    assert eng.result(zero) == eng.result(plain)
    assert eng.result_logprobs(zero) == eng.result_logprobs(plain)
    # the edit itself: a zero-penalty row's logits are unchanged bit for
    # bit whatever its counts
    logits, counts = _fixed_logits(2, tcfg.vocab_size, 3)
    samp = np.zeros((2, 6), np.float32)
    samp[:, 5] = -1
    toks = eng._choose(torch.from_numpy(logits), torch.from_numpy(samp),
                       torch.arange(2), torch.from_numpy(counts),
                       torch.zeros(2, dtype=torch.int32), True)
    np.testing.assert_array_equal(toks.numpy(), logits.argmax(-1))


def test_penalty_counts_reset_between_slot_occupants(tiny):
    _, tcfg, _, tparams = tiny
    eng = LLMEngine(tparams, tcfg, device="cpu", **dict(ENGINE, n_slots=1))
    r1 = eng.submit(PROMPT, NEW, frequency_penalty=1.3)
    eng.run_until_idle()
    r2 = eng.submit(PROMPT, NEW, frequency_penalty=1.3)
    assert eng.step()    # r2's prefill: the slot's counts are its one-hot
    first = eng.partial_result(r2)[0]
    cnt = eng._cnt[0].numpy()
    assert cnt[first] == 1 and cnt.sum() == 1
    eng.run_until_idle()
    assert eng.result(r2) == eng.result(r1)


def test_seeded_draws_independent_of_slot_batchmates_chunking_layout(tiny):
    _, tcfg, _, tparams = tiny
    prompt = [7, 8, 9]
    kw = dict(temperature=0.9, top_p=0.95, seed=42)

    def solo(**ekw):
        eng = (PagedLLMEngine if ekw.pop("paged", False) else LLMEngine)(
            tparams, tcfg, device="cpu", **{**ENGINE, "n_slots": 3, **ekw})
        return eng, eng.generate(prompt, 8, **kw)

    eng, want = solo()
    assert want != eng.generate(prompt, 8)   # it really sampled
    # batchmates take the other slots, and it lands in slot 2
    others = [eng.submit([1, 2], 8, temperature=1.3) for _ in range(2)]
    again = eng.submit(prompt, 8, **kw)
    eng.run_until_idle()
    assert eng.result(again) == want
    assert [eng.result(r) for r in others] != [want, want]
    for ekw in (dict(decode_chunk=1), dict(decode_chunk=2, sample_seed=9),
                dict(pipeline_decode=False), dict(paged=True)):
        assert solo(**ekw)[1] == want, ekw
    assert solo()[0].generate(prompt, 8, **dict(kw, seed=43)) != want
    # a seeded greedy request stays greedy
    eng = LLMEngine(tparams, tcfg, device="cpu", **ENGINE)
    assert eng.generate(prompt, 8, seed=7) == eng.generate(prompt, 8)


def test_submit_errors_as_jax_engine(tiny, jax_runs):
    _, tcfg, _, tparams = tiny
    jeng = jax_runs[None, "engine"]
    teng = LLMEngine(tparams, tcfg, device="cpu", **ENGINE)
    bad = [dict(temperature=float("nan")), dict(temperature=101),
           dict(top_k=-1), dict(top_k=65), dict(top_p=0.0),
           dict(top_p=1.5), dict(presence_penalty=2.5),
           dict(frequency_penalty=-3),
           dict(presence_penalty=float("nan")), dict(seed=-1),
           dict(seed=1.5), dict(seed=True), dict(stop=[[]]),
           dict(stop=[list(range(65))]), dict(stop=[[1]] * 9),
           dict(deadline_s=0)]
    for kw in bad:
        with pytest.raises(ValueError) as want:
            jeng.submit([1, 2], 4, **kw)
        with pytest.raises(ValueError) as got:
            teng.submit([1, 2], 4, **kw)
        assert str(got.value) == str(want.value), kw
    assert teng.scheduler.next() is None   # nothing was queued


def test_logprob_surfaces(tiny):
    _, tcfg, _, tparams = tiny
    eng = LLMEngine(tparams, tcfg, device="cpu", **ENGINE)
    rid = eng.submit([4], 3)
    assert eng.partial_result(rid) == [] and eng.partial_logprobs(rid) == []
    eng.step()
    assert len(eng.partial_result(rid)) == 1
    assert len(eng.partial_logprobs(rid)) == 1
    eng.run_until_idle()
    assert len(eng.result_logprobs(rid)) == 3
    with pytest.raises(ValueError):
        eng.result_top_logprobs(rid)
    with pytest.raises(ValueError):
        LLMEngine(tparams, tcfg, device="cpu", logprobs_topk=17, **ENGINE)


def test_unseeded_sampling_repeats_from_sample_seed(tiny):
    _, tcfg, _, tparams = tiny
    kw = dict(temperature=1.0, top_k=20)
    runs = []
    for seed in (5, 5, 6):
        eng = LLMEngine(tparams, tcfg, sample_seed=seed, device="cpu",
                        **ENGINE)
        runs.append([eng.generate(p, 8, **kw) for p in ([1, 2, 3], [1, 2, 3])])
    assert runs[0] == runs[1]
    assert runs[0] != runs[2]
    # the same prompt twice on one engine: the draw counter moved on
    assert runs[0][0] != runs[0][1]


def _post(url, body):
    req = urllib.request.Request(url + "/openai/v1/completions",
                                 data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


def test_http_penalties_seed_stop_and_logprobs(tiny):
    _, tcfg, _, tparams = tiny
    config = {"n_slots": 2, "max_len": 48, "buckets": [8, 16],
              "decode_chunk": 4, "logprobs_topk": 3, "timeout_s": 60}
    server = CompletionServer.from_config(tparams, tcfg, config,
                                          device="cpu").start()
    try:
        body = {"prompt": [3, 17, 42, 9], "max_tokens": 6}
        plain = _post(server.url, dict(body, logprobs=2))["choices"][0]
        toks = plain["token_ids"]
        lp = plain["logprobs"]
        assert lp["token_logprobs"] and len(lp["tokens"]) == len(toks)
        assert all(len(d) == 2 and str(t) in d
                   for t, d in zip(toks, lp["top_logprobs"]))
        cut = _post(server.url, dict(body, stop=[toks[2:4]]))["choices"][0]
        assert cut["token_ids"] == toks[:2]
        assert cut["finish_reason"] == "stop"
        seeded = [_post(server.url, dict(body, temperature=0.9, seed=11,
                                         presence_penalty=0.5))
                  ["choices"][0]["token_ids"] for _ in range(2)]
        assert seeded[0] == seeded[1]
        for bad in ({"logprobs": 4}, {"seed": -1}, {"stop": 5},
                    {"presence_penalty": 3}):
            with pytest.raises(urllib.error.HTTPError) as e:
                _post(server.url, dict(body, **bad))
            assert e.value.code == 400, bad
    finally:
        server.stop()
