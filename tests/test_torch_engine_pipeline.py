"""The port's pipelined decode, cancellation, deadlines, stop sequences and
decode program menu on the CPU against the JAX engine: greedy tokens of
the pipelined and the unpipelined engine (slab and paged, f32 and int8)
equal to the JAX `LLMEngine` (pipelined, its default); a stop sequence,
one spanning a chunk boundary too, as the JAX engine cuts it; cancel of a
queued request, of a running one with a chunk in flight, of a finished
one; a deadline; the cache's room held with a chunk in flight; paged
blocks returned only once no chunk is in flight; and after warmup() no
decode key outside the warmed menu."""

import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.models import llama as jllama
from kubeflow_tpu.serving.llm import LLMEngine as JaxEngine
from kubeflow_tpu_torch.models import interop
from kubeflow_tpu_torch.models import llama as tllama
from kubeflow_tpu_torch.serving.llm import LLMEngine
from kubeflow_tpu_torch.serving.paged import PagedLLMEngine

torch.set_num_threads(2)

ENGINE = dict(n_slots=2, max_len=48, buckets=(8, 16), decode_chunk=4)
# staggered budgets: slots finish mid-chunk with a chunk in flight, and a
# third request waits for a slot
PROMPTS = [[3, 17, 101, 44, 9], list(range(20, 32)), [7, 7, 7]]
BUDGETS = [9, 5, 7]
STOP_PROMPT = [3, 17, 42, 9, 55]


@pytest.fixture(scope="module")
def tiny():
    jcfg = dataclasses.replace(jllama.LlamaConfig.tiny(), dtype=jnp.float32)
    tcfg = dataclasses.replace(tllama.LlamaConfig.tiny(),
                               dtype=torch.float32)
    jparams = jllama.init(jax.random.key(0), jcfg)
    tparams = interop.from_jax_params(jax.tree.map(np.asarray, jparams),
                                      tcfg, device="cpu")
    return jcfg, tcfg, jparams, tparams


def _burst(eng):
    rids = [eng.submit(p, n) for p, n in zip(PROMPTS, BUDGETS)]
    eng.run_until_idle()
    return [(eng.result(r), eng.finish_reason(r)) for r in rids]


@pytest.fixture(scope="module")
def jax_runs(tiny):
    """The JAX engine's burst (f32 and int8) and, on f32, its greedy
    stop-prompt tokens and the stop sequences it cuts."""
    jcfg, _, jparams, _ = tiny
    out = {}
    for quant in (None, "int8"):
        eng = JaxEngine(jparams, jcfg, prefer_native=False, quantize=quant,
                        kv_quantize=quant, **ENGINE)
        out[quant] = _burst(eng)
        if quant is None:
            greedy = eng.generate(STOP_PROMPT, 10)
            out["greedy"] = greedy
            for stop in (greedy[2:4], greedy[4:7], [greedy[6]]):
                rid = eng.submit(STOP_PROMPT, 10, stop=[[999], stop])
                eng.run_until_idle()
                out[tuple(stop)] = (eng.result(rid), eng.finish_reason(rid),
                                    len(eng.result_logprobs(rid)))
    return out


@pytest.mark.parametrize("paged", [False, True], ids=["slab", "paged"])
@pytest.mark.parametrize("quant", [None, "int8"], ids=["f32", "int8"])
def test_pipelined_and_unpipelined_tokens_equal_jax(tiny, jax_runs, paged,
                                                    quant):
    _, tcfg, _, tparams = tiny
    cls = PagedLLMEngine if paged else LLMEngine
    for pipeline in (True, False):
        eng = cls(tparams, tcfg, quantize=quant, kv_quantize=quant,
                  pipeline_decode=pipeline, device="cpu", **ENGINE)
        assert _burst(eng) == jax_runs[quant], pipeline
        assert eng._pending is None and not eng._inflight.any()


def test_pipelined_equals_unpipelined_with_sampled_rows(tiny):
    """Tokens, logprobs and finish reasons of a greedy and an unseeded
    sampled slot with staggered budgets (one finishes mid-chunk) are the
    same with and without a chunk in flight."""
    _, tcfg, _, tparams = tiny
    outs = []
    for pipeline in (True, False):
        eng = LLMEngine(tparams, tcfg, sample_seed=5, logprobs_topk=2,
                        pipeline_decode=pipeline, device="cpu", **ENGINE)
        rids = [eng.submit(p, n, temperature=t) for p, n, t in
                (([3, 17, 42], 9, 0.0), ([5, 9, 2, 44], 5, 1.1))]
        eng.run_until_idle()
        outs.append([(eng.result(r), eng.result_logprobs(r),
                      eng.result_top_logprobs(r), eng.finish_reason(r))
                     for r in rids])
    assert outs[0] == outs[1]


def test_pipelined_decode_drains_before_refilling_a_slot(tiny, jax_runs):
    """One slot and a queue: each request's chunk in flight lands before
    the next prefill takes the slot, and every request decodes as it does
    alone (the JAX burst's tokens, one at a time)."""
    _, tcfg, _, tparams = tiny
    eng = LLMEngine(tparams, tcfg, device="cpu", **dict(ENGINE, n_slots=1))
    rids = [eng.submit(p, n) for p, n in zip(PROMPTS, BUDGETS)]
    prefill_with_pending = []
    real = eng._run_prefill_actions

    def spy(actions):
        prefill_with_pending.append(eng._pending is not None)
        return real(actions)

    eng._run_prefill_actions = spy
    eng.run_until_idle()
    assert [(eng.result(r), eng.finish_reason(r)) for r in rids] == \
        jax_runs[None]
    assert len(prefill_with_pending) == 3 and not any(prefill_with_pending)


def test_stop_sequences_cut_as_jax(tiny, jax_runs):
    """decode_chunk 4: greedy[2:4] ends inside the first chunk, greedy[4:7]
    spans the first chunk boundary (token 5 is the first of the second
    chunk); the matched tokens leave the result and its logprobs."""
    _, tcfg, _, tparams = tiny
    greedy = jax_runs["greedy"]
    for pipeline in (True, False):
        eng = LLMEngine(tparams, tcfg, pipeline_decode=pipeline,
                        device="cpu", **ENGINE)
        assert eng.generate(STOP_PROMPT, 10) == greedy
        for stop in (greedy[2:4], greedy[4:7], [greedy[6]]):
            rid = eng.submit(STOP_PROMPT, 10, stop=[[999], stop])
            eng.run_until_idle()
            got = (eng.result(rid), eng.finish_reason(rid),
                   len(eng.result_logprobs(rid)))
            assert got == jax_runs[tuple(stop)], stop
            assert got[1] == "stop" and got[0] == greedy[:greedy.index(
                stop[0], 2 if len(stop) > 1 else 6)]


def test_cancel_queued_running_in_flight_and_finished(tiny):
    _, tcfg, _, tparams = tiny
    eng = LLMEngine(tparams, tcfg, device="cpu",
                    **dict(ENGINE, n_slots=1, decode_chunk=2))
    want = eng.generate([5, 9, 2], 4)
    # a queued request never runs
    r1 = eng.submit([3, 17, 42], 4)
    r2 = eng.submit([5, 9, 2], 4)
    assert eng.scheduler.cancel(10**6) is None
    assert eng.cancel(r2)
    eng.run_until_idle()
    assert eng.finish_reason(r2) == "cancelled" and eng.result(r2) == []
    assert eng.finish_reason(r1) == "length" and len(eng.result(r1)) == 4
    # a running request, cancelled while a chunk is in flight: the
    # chunk's tokens for it are dropped and its slot goes to the next one
    r3 = eng.submit([3, 17, 42], 30)
    r4 = eng.submit([5, 9, 2], 4)
    assert eng.step()                      # prefill r3
    assert eng.step()                      # chunk 1 dispatched
    assert eng.step()                      # chunk 2 in flight, 1 replayed
    assert eng._pending is not None
    assert eng.cancel(r3)
    seen = len(eng.partial_result(r3))
    assert eng.step()                      # drops r3, drains, prefills r4
    assert eng.is_done(r3) and eng.finish_reason(r3) == "cancelled"
    assert len(eng.result(r3)) == seen     # the in-flight chunk's are junk
    eng.run_until_idle()
    assert eng.result(r4) == want
    # a finished request: no-op
    assert not eng.cancel(r4) and eng.finish_reason(r4) == "length"
    assert eng.scheduler.cancel(r4) is None


def test_deadline_cancels_at_the_next_step(tiny):
    _, tcfg, _, tparams = tiny
    eng = LLMEngine(tparams, tcfg, device="cpu",
                    **dict(ENGINE, n_slots=1, decode_chunk=2))
    rid = eng.submit([3, 17, 42], 40, deadline_s=0.05)
    other = eng.submit([5, 9], 3, deadline_s=60.0)
    assert eng.step()                      # prefill
    time.sleep(0.1)
    eng.run_until_idle()
    assert eng.finish_reason(rid) == "cancelled"
    assert 1 <= len(eng.result(rid)) < 40
    assert eng.finish_reason(other) == "length"
    assert len(eng.result(other)) == 3


@pytest.mark.parametrize("paged", [False, True], ids=["slab", "paged"])
def test_cache_room_held_with_a_chunk_in_flight(tiny, paged):
    """A request that outruns the cache ends "length" at max_len, and no
    chunk is planned past max_len with its predecessor unfetched."""
    _, tcfg, _, tparams = tiny
    cls = PagedLLMEngine if paged else LLMEngine
    eng = cls(tparams, tcfg, device="cpu", **ENGINE)
    planned = []
    real = eng._decode_chunk

    def spy(steps, span, active, sample=True):
        rows = eng._host_lengths + eng._inflight
        planned.append(int(rows[eng._active_host].max()) + steps)
        return real(steps, span, active, sample)

    eng._decode_chunk = spy
    rid = eng.submit(list(range(16)), 100)
    short = eng.submit([1, 2, 3], 100)
    eng.run_until_idle()
    assert len(eng.result(rid)) == ENGINE["max_len"] - 16 + 1
    assert len(eng.result(short)) == ENGINE["max_len"] - 3 + 1
    assert eng.finish_reason(rid) == eng.finish_reason(short) == "length"
    assert max(planned) <= ENGINE["max_len"]
    if paged:
        m = eng.metrics()["kv_pool"]
        assert m["free_blocks"] == m["pool_blocks"]


def test_paged_blocks_return_only_with_no_chunk_in_flight(tiny):
    _, tcfg, _, tparams = tiny
    eng = PagedLLMEngine(tparams, tcfg, device="cpu",
                         **dict(ENGINE, n_slots=3, decode_chunk=2))
    calls = []
    real = eng._pool.deref

    def spy(ids):
        calls.append(eng._pending is None)
        return real(ids)

    eng._pool.deref = spy
    rids = [eng.submit(p, n) for p, n in zip(PROMPTS, (3, 9, 6))]
    deferred = 0
    while eng.step():
        deferred = max(deferred, len(eng._deferred_derefs))
        eng._pool.check_invariants()
    assert all(eng.is_done(r) for r in rids)
    assert calls and all(calls)
    assert deferred > 0          # a finish under an in-flight chunk waited
    m = eng.metrics()["kv_pool"]
    assert m["free_blocks"] == m["pool_blocks"]
    assert not eng._tbl_host.any() and not eng._deferred_derefs


def test_warmup_menu_covers_live_traffic(tiny):
    """max_len 2048: 4 chunks x 5 spans is over 16, so the menu is the
    JAX engine's: every chunk at full span plus chunk 4 at every span,
    each in both variants; live traffic asks for no other key."""
    _, tcfg, _, tparams = tiny
    eng = LLMEngine(tparams, tcfg, device="cpu",
                    **dict(ENGINE, max_len=2048, decode_chunk=8))
    eng.warmup()
    chunks, spans = (1, 2, 4, 8), (128, 256, 512, 1024, 2048)
    combos = {(c, 2048) for c in chunks} | {(8, s) for s in spans}
    assert set(eng._programs) == {(c, s, v) for c, s in combos
                                  for v in (True, False)}
    assert eng.graph_stats()["warmed"]
    assert not eng.lengths.any() and not eng._cnt.any()
    asked = []
    real = eng._decode_fn

    def spy(steps, span, sample=True):
        asked.append((steps, span, sample))
        return real(steps, span, sample)

    eng._decode_fn = spy
    eng.generate(list(range(1, 12)), 6)    # greedy alone: no sampling
    rids = [eng.submit(p, n, temperature=t, presence_penalty=pp)
            for p, n, t, pp in ((list(range(1, 14)), 7, 0.0, 0.0),
                                ([4, 5], 3, 0.8, 0.0),
                                ([9] * 5, 5, 0.0, 0.5))]
    eng.run_until_idle()
    assert all(eng.is_done(r) for r in rids)
    assert asked and set(asked) <= set(eng._programs)
    assert len(eng._programs) == 2 * len(combos)
    assert {k[2] for k in asked} == {True, False}
    # warmup left the engine as a fresh one: the same greedy tokens
    cold = LLMEngine(tparams, tcfg, device="cpu",
                     **dict(ENGINE, max_len=2048, decode_chunk=8))
    assert eng.generate([1, 2, 3], 6) == cold.generate([1, 2, 3], 6)
    with pytest.raises(RuntimeError):
        eng.submit([1], 2)
        eng.step()
        eng.warmup()
