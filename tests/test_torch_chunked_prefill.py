"""The port's chunked prefill on the CPU against the JAX engine: the chunk
plan (and its PromptTooLong messages) equal to the JAX `_chunk_plan` and
`_chunk_plan_from` over a grid of lengths; greedy tokens of prompts
longer than the largest bucket, alone and beside short ones, equal to
the JAX `LLMEngine` (slab and paged, f32 and int8); the no-decode-room
rejection at submit, as JAX; the paged `_extract_prefix` (gathered
through the table) equal to the slab one; and a chunked request's
seeded, penalized and first-token state as a short request's."""

import dataclasses
import types

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
from kubeflow_tpu_torch.serving.scheduler import PromptTooLong

torch.set_num_threads(2)

ENGINE = dict(n_slots=2, max_len=64, buckets=(8, 16), decode_chunk=4)
# 40 tokens: chunks 16 + 16 + a tail of 8; 21: 16 + a tail of 5 (bucket 8)
LONG = [(7 * i + 3) % 512 for i in range(40)]
MID = [(5 * i + 2) % 512 for i in range(21)]
SHORT = [5, 9, 2]
NEW = 6


@pytest.fixture(scope="module")
def tiny():
    jcfg = dataclasses.replace(jllama.LlamaConfig.tiny(), dtype=jnp.float32)
    tcfg = dataclasses.replace(tllama.LlamaConfig.tiny(),
                               dtype=torch.float32)
    jparams = jllama.init(jax.random.key(0), jcfg)
    tparams = interop.from_jax_params(jax.tree.map(np.asarray, jparams),
                                      tcfg, device="cpu")
    return jcfg, tcfg, jparams, tparams


def _runs(eng):
    """A long prompt alone, then a burst that mixes chunked and short
    prompts."""
    out = [eng.generate(LONG, NEW)]
    rids = [eng.submit(p, NEW) for p in (SHORT, LONG)]
    eng.run_until_idle()
    return out + [eng.result(r) for r in rids]


@pytest.fixture(scope="module")
def jax_tokens(tiny):
    jcfg, _, jparams, _ = tiny
    return {quant: _runs(JaxEngine(jparams, jcfg, prefer_native=False,
                                   quantize=quant, kv_quantize=quant,
                                   **ENGINE))
            for quant in (None, "int8")}


def _jax_planner(max_len, buckets):
    """The JAX engine's plan methods on a bare object with its two
    fields."""
    ns = types.SimpleNamespace(max_len=max_len, buckets=tuple(buckets))
    for name in ("_tail_bucket", "_chunk_plan", "_chunk_plan_from"):
        setattr(ns, name, getattr(JaxEngine, name).__get__(ns))
    return ns


@pytest.mark.parametrize("max_len,buckets", [
    (64, (8, 16)), (36, (8, 16)), (2048, (128, 512, 1024)), (40, (4, 12))])
def test_chunk_plan_equals_jax(tiny, max_len, buckets):
    _, tcfg, _, tparams = tiny
    want = _jax_planner(max_len, buckets)
    got = LLMEngine(tparams, tcfg, n_slots=1, max_len=max_len,
                    buckets=buckets, device="cpu")
    for n in range(max(buckets) + 1, max_len + 3):
        try:
            ref = want._chunk_plan(n)
        except Exception as e:   # the JAX PromptTooLong
            with pytest.raises(PromptTooLong) as mine:
                got._chunk_plan(n)
            assert str(mine.value) == str(e), (max_len, n)
            continue
        assert got._chunk_plan(n) == ref, (max_len, n)
        for start in range(0, n, max(buckets) // 2):
            assert (got._chunk_plan_from(n, start)
                    == want._chunk_plan_from(n, start)), (n, start)


@pytest.mark.parametrize("paged", [False, True], ids=["slab", "paged"])
@pytest.mark.parametrize("quant", [None, "int8"], ids=["f32", "int8"])
def test_long_prompt_greedy_tokens_equal_jax(tiny, jax_tokens, paged, quant):
    _, tcfg, _, tparams = tiny
    cls = PagedLLMEngine if paged else LLMEngine
    eng = cls(tparams, tcfg, quantize=quant, kv_quantize=quant, device="cpu",
              **ENGINE)
    got = _runs(eng)
    assert got == jax_tokens[quant]
    assert all(len(t) == NEW for t in got)
    if paged:
        m = eng.metrics()["kv_pool"]
        assert m["free_blocks"] == m["pool_blocks"]


def test_long_prompt_held_in_a_small_paged_pool(tiny, jax_tokens):
    """Two long prompts whose reservations do not fit the pool together:
    the second prefill is held until the first request's blocks return,
    and each decodes as it does alone."""
    _, tcfg, _, tparams = tiny
    eng = PagedLLMEngine(tparams, tcfg, pool_blocks=8, device="cpu",
                         **ENGINE)
    rids = [eng.submit(LONG, NEW) for _ in range(2)]
    held = 0
    while eng.step():
        held = max(held, eng.metrics()["held_prefills"])
        eng._pool.check_invariants()
    assert held == 1
    assert [eng.result(r) for r in rids] == [jax_tokens[None][0]] * 2
    m = eng.metrics()["kv_pool"]
    assert m["free_blocks"] == m["pool_blocks"] == 8


def test_no_decode_room_rejected_at_submit_as_jax(tiny):
    jcfg, tcfg, jparams, tparams = tiny
    for max_len, n in ((32, 32), (32, 40), (36, 34)):
        jeng = JaxEngine(jparams, jcfg, prefer_native=False, n_slots=2,
                         max_len=max_len, buckets=(8, 16))
        teng = LLMEngine(tparams, tcfg, n_slots=2, max_len=max_len,
                         buckets=(8, 16), device="cpu")
        with pytest.raises(Exception) as want:
            jeng.submit(list(range(n)), 4)
        with pytest.raises(PromptTooLong) as got:
            teng.submit(list(range(n)), 4)
        assert type(want.value).__name__ == "PromptTooLong"
        assert str(got.value) == str(want.value)
        assert teng.scheduler.next() is None
    # 31 tokens: 16 + a tail of 15 in bucket 16, 32 <= 32
    eng = LLMEngine(tparams, tcfg, n_slots=2, max_len=32, buckets=(8, 16),
                    device="cpu")
    rid = eng.submit([1] * 31, 2)
    eng.run_until_idle()
    assert eng.is_done(rid) and len(eng.result(rid)) == 2
    with pytest.raises(PromptTooLong):
        eng.submit([], 2)


@pytest.mark.parametrize("quant", [None, "int8"], ids=["f32", "int8"])
def test_paged_extract_prefix_equals_slab(tiny, quant):
    _, tcfg, _, tparams = tiny
    prefixes = []
    for cls in (LLMEngine, PagedLLMEngine):
        eng = cls(tparams, tcfg, kv_quantize=quant, device="cpu", **ENGINE)
        eng.submit([1, 2, 3], 20)
        rid = eng.submit(LONG, 20)
        assert eng.step()   # both prefills, the long one chained
        assert eng._host_lengths[1] == len(LONG)
        assert eng.scheduler.slot_request(1) == rid
        prefixes.append([eng._extract_prefix(1, p) for p in (16, 32)])
    for (ks, vs), (kp, vp) in zip(*prefixes):
        assert ks.shape == (tcfg.n_layers, 1, ks.shape[2], tcfg.n_kv_heads,
                            tcfg.head_dim)
        assert ks.dtype == tcfg.dtype
        assert torch.equal(ks, kp) and torch.equal(vs, vp)


def test_chunked_request_state_as_a_short_one(tiny):
    """Seeded, penalized and logprob rows through a chain: slab equals
    paged, pipelined equals unpipelined, the counts hold the first token
    only, and the first token is timed."""
    _, tcfg, _, tparams = tiny
    kw = [dict(temperature=0.8, seed=3), dict(frequency_penalty=1.1),
          dict(presence_penalty=-0.5, temperature=0.6, top_k=5, seed=8)]
    outs = []
    for cls, pipeline in ((LLMEngine, True), (LLMEngine, False),
                          (PagedLLMEngine, True)):
        eng = cls(tparams, tcfg, kv_quantize="int8", pipeline_decode=pipeline,
                  logprobs_topk=2, device="cpu", **dict(ENGINE, n_slots=3))
        rids = [eng.submit(p, 8, **k) for p, k in zip((LONG, MID, LONG), kw)]
        assert eng.step()
        for slot in range(3):
            assert eng._cnt[slot].sum() == 1
        eng.run_until_idle()
        assert all(eng.ttft_seconds(r) is not None for r in rids)
        outs.append([(eng.result(r), eng.result_logprobs(r),
                      eng.result_top_logprobs(r)) for r in rids])
    assert outs[0] == outs[1] == outs[2]
