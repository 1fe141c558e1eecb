"""The port's speculative decoding on the CPU, finishing and the paged
engine's block handling, over the JAX package's tiny model trained to
continue a repeating 8-gram (tests/test_spec_decode.py): with int8
weights and KV, an EOS, a stop sequence and a max_new budget in the middle
of an accepted run cut the result where the JAX spec engine cuts it (the
same tokens, verify rounds and delivered tokens) and where the port's
engine without speculation does; a cancel with a chunk of verify rounds in
flight; verify rows past a paged request's reservation land in the trash
block; an oversubscribed paged pool with the prefix cache (held prefills,
the eviction valve, deferred frees) gives the slab engine's tokens; and
warmup() makes the JAX spec menu, after which no new program is made."""

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
# a prompt ending in PATTERN continues 3, 11, 7, 19, 2, 31, ...: the first
# token comes from the prefill, the next five from one round of four
# accepted drafts and the bonus
EOS = 31
ENGINE = dict(n_slots=4, max_len=96, buckets=(16, 32), decode_chunk=4,
              speculative=4, spec_ngram=2)
INT8 = dict(quantize="int8", kv_quantize="int8")
# (prompt, max_new, keywords): EOS at the 6th token; a stop sequence
# [7, 19] inside the first round; a budget of 4 that the first round
# overshoots; a random prompt
FINISH = [(PATTERN * 3, 30, {}),
          (PATTERN * 2, 30, dict(stop=[[7, 19]])),
          (PATTERN[2:] + PATTERN * 2, 4, {}),
          ([9, 40, 77, 12, 5, 61, 30, 8, 2, 44], 12, {})]


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


def _finish_run(eng):
    rids = [eng.submit(p, n, **kw) for p, n, kw in FINISH]
    eng.run_until_idle()
    m = eng.metrics()
    return ([(eng.result(r), eng.finish_reason(r)) for r in rids],
            (m.get("spec_verify_rounds"), m.get("spec_tokens_emitted")))


@pytest.fixture(scope="module")
def jax_finish(trained):
    jcfg, _, jparams, _ = trained
    eng = JaxEngine(jparams, jcfg, prefer_native=False, eos_id=EOS,
                    **ENGINE, **INT8)
    out = _finish_run(eng)
    eng.close()
    return out


@pytest.mark.parametrize("paged", [False, True], ids=["slab", "paged"])
def test_finish_mid_round_int8_equals_jax(trained, jax_finish, paged):
    _, tcfg, _, tparams = trained
    cls = PagedLLMEngine if paged else LLMEngine
    eng = cls(tparams, tcfg, eos_id=EOS, device="cpu", **ENGINE, **INT8)
    rows, counts = _finish_run(eng)
    assert (rows, counts) == jax_finish
    assert rows[0] == (PATTERN[:6], "stop")       # ends at the EOS
    assert rows[1] == (PATTERN[:2], "stop")       # the stop cut out
    assert rows[2] == (PATTERN[:4], "length")     # the budget
    # the same-quantization engine without speculation
    plain = cls(tparams, tcfg, eos_id=EOS, device="cpu",
                **dict(ENGINE, speculative=None), **INT8)
    assert _finish_run(plain)[0] == rows
    assert eng._pending is None and not eng._inflight.any()
    if paged:
        pool = eng.metrics()["kv_pool"]
        assert pool["free_blocks"] == pool["pool_blocks"]


@pytest.mark.parametrize("paged", [False, True], ids=["slab", "paged"])
def test_cancel_with_verify_rounds_in_flight(trained, paged):
    """A request cancelled while a chunk of its verify rounds is in
    flight keeps the tokens delivered so far (a prefix of its run alone)
    with finish reason "cancelled"; its batchmate's tokens are unchanged,
    and the paged engine returns every block."""
    _, tcfg, _, tparams = trained
    cls = PagedLLMEngine if paged else LLMEngine
    prompts = [(PATTERN * 3, 40), ([9, 40, 77, 12, 5, 61, 30, 8], 24)]
    ref = cls(tparams, tcfg, device="cpu", **ENGINE)
    want = [ref.generate(p, n) for p, n in prompts]
    eng = cls(tparams, tcfg, device="cpu", **ENGINE)
    rids = [eng.submit(p, n) for p, n in prompts]
    in_flight = False
    while eng.step():
        if (not in_flight and eng._pending is not None
                and len(eng.partial_result(rids[0])) >= 6):
            in_flight = eng.cancel(rids[0])
    assert in_flight
    got = eng.result(rids[0])
    assert eng.finish_reason(rids[0]) == "cancelled"
    assert 6 <= len(got) < 40 and got == want[0][:len(got)]
    assert eng.result(rids[1]) == want[1]
    assert eng._pending is None and not eng._inflight.any()
    if paged:
        pool = eng.metrics()["kv_pool"]
        assert pool["free_blocks"] == pool["pool_blocks"]


def test_verify_rows_past_the_reservation_land_in_the_trash_block(trained):
    """A 16-token prompt with a budget of 16 reserves 4 blocks of 8
    (positions 0..31); its last chunk of rounds writes up to kd rows past
    position 31, which the table sends to block 0: no other block
    changes, and the tokens are the slab engine's."""
    _, tcfg, _, tparams = trained
    kw = dict(ENGINE, n_slots=2, max_len=64, buckets=(8, 16))
    prompt, n = PATTERN * 2, 16
    eng = PagedLLMEngine(tparams, tcfg, device="cpu", **kw)
    rid = eng.submit(prompt, n)
    eng.step()    # the prefill
    mine = {int(b) for b in eng._tbl_host[0] if b}
    assert len(mine) == 4
    others = [b for b in range(1, eng._pool.n_blocks) if b not in mine]
    before = {name: eng.cache[name][:, others].clone()
              for name in ("k", "v")}
    eng.run_until_idle()
    assert int(eng.lengths[0]) > 32    # rounds wrote past the reservation
    for name, t in before.items():
        assert torch.equal(eng.cache[name][:, others], t)
    slab = LLMEngine(tparams, tcfg, device="cpu", **kw)
    assert eng.result(rid) == slab.generate(prompt, n)


def test_oversubscribed_pool_with_prefix_cache_equals_slab(trained):
    """Eight copy-heavy requests on four slots and a 14-block pool: some
    prefills are held, the valve evicts trie blocks, finished slots'
    blocks come back only with no chunk in flight, and every token equals
    the slab engine's."""
    _, tcfg, _, tparams = trained
    kw = dict(ENGINE, n_slots=4, max_len=48, buckets=(8, 16),
              prefix_cache=True)
    # a random prompt with a long budget keeps the pipeline running while
    # the copy-heavy rows finish
    prompts = [[9, 40, 77, 12, 5, 61, 30, 8]]
    prompts += [PATTERN[i:] + PATTERN * 2 for i in range(0, 8, 2)]
    prompts += [PATTERN * 2 + PATTERN[:i] for i in range(1, 4)]
    budgets = [30, 12, 5, 9, 7, 12, 6, 10]
    slab = LLMEngine(tparams, tcfg, device="cpu", **kw)
    want = [slab.generate(p, n) for p, n in zip(prompts, budgets)]
    eng = PagedLLMEngine(tparams, tcfg, device="cpu", pool_blocks=14, **kw)
    rids = [eng.submit(p, n) for p, n in zip(prompts, budgets)]
    held = deferred = 0
    while eng.step():
        held = max(held, len(eng._held))
        deferred = max(deferred, len(eng._deferred_derefs))
        eng._pool.check_invariants()
    assert [eng.result(r) for r in rids] == want
    assert held > 0 and deferred > 0
    assert eng.kvcache.stats()["evicted_blocks"] > 0
    pool = eng.metrics()["kv_pool"]
    assert pool["free_blocks"] == (pool["pool_blocks"]
                                   - eng.kvcache.stats()["blocks"])


def test_warmup_makes_the_jax_spec_menu(trained):
    """warmup() makes the JAX engine's spec menu in both variants and no
    decode program: every chunk at full span and the largest chunk at
    every span with k_max, each smaller k at full span for the largest
    chunk and chunk 1. Serving after it makes no new program (a cold key
    falls back to full span, then to k_max) and gives the tokens of an
    engine that was not warmed."""
    _, tcfg, _, tparams = trained
    # the flagship's max_len and chunk: 20 (chunk, span) pairs, more than
    # the 16 the JAX engine warms in full
    kw = dict(ENGINE, max_len=2048, buckets=(16, 32), decode_chunk=8,
              speculative=6)
    eng = LLMEngine(tparams, tcfg, device="cpu", **kw)
    eng.warmup()
    spans, chunks = [128, 256, 512, 1024, 2048], [1, 2, 4, 8]
    menu = ({(c, 2048, 6) for c in chunks} | {(8, s, 6) for s in spans}
            | {(c, 2048, kd) for c in (1, 8) for kd in (1, 2, 4)})
    assert set(eng._programs) == {m + (smp,) for m in menu
                                  for smp in (True, False)}
    keys = set(eng._programs)
    prompts = [PATTERN * 3, [9, 40, 77, 12, 5, 61, 30, 8], PATTERN * 4]
    got = [eng.generate(p, 40, temperature=t) for p, t in
           zip(prompts, (0.0, 0.0, 0.9))]
    assert set(eng._programs) == keys
    cold = LLMEngine(tparams, tcfg, device="cpu", **kw)
    assert got[:2] == [cold.generate(p, 40) for p in prompts[:2]]
