"""The paged engine's half of the prefix cache on the CPU. Three scenarios
of tests/test_paged_kv.py run on the port's `PagedLLMEngine` and on the
JAX one, with the same observations from both: a forced eviction of
every banked block and a byte-identical recompute; a cached prefix that
funds itself (only the uncached suffix reserved, the valve never fires);
a held prefill that keeps its prefix pinned through the valve and
re-probes the cache when it funds. Then what only the port has to get
right: trie evictions wait for the chunk in flight like any other
deref, every splice lands in the device table the decode graphs read,
and a shared-prefix burst with second turns through a pool small enough
to evict gives the slab engine's tokens and leaves only the trie's
blocks in use."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.models import llama as jllama
from kubeflow_tpu.serving.paged import PagedLLMEngine as JaxPaged
from kubeflow_tpu_torch.models import interop
from kubeflow_tpu_torch.models import llama as tllama
from kubeflow_tpu_torch.serving.llm import LLMEngine
from kubeflow_tpu_torch.serving.paged import PagedLLMEngine

torch.set_num_threads(2)

SMALL = dict(max_len=32, buckets=(8,), decode_chunk=4)
PROMPT = list(range(1, 14))          # 13 tokens: one block and a tail
PREFIX2 = list(range(1, 18))         # 17 tokens: a two-block prefix
BLOCKER = [50, 51, 52, 53, 54, 55, 56]


@pytest.fixture(scope="module")
def tiny():
    jcfg = dataclasses.replace(jllama.LlamaConfig.tiny(), dtype=jnp.float32)
    tcfg = dataclasses.replace(tllama.LlamaConfig.tiny(),
                               dtype=torch.float32)
    jparams = jllama.init(jax.random.key(0), jcfg)
    tparams = interop.from_jax_params(jax.tree.map(np.asarray, jparams),
                                      tcfg, device="cpu")
    return jcfg, tcfg, jparams, tparams


def _both(tiny, scenario, **kw):
    """(port observations, JAX observations, the port's cold slab
    engine) of `scenario` on a prefix-cache paged engine of each."""
    jcfg, tcfg, jparams, tparams = tiny
    want = scenario(JaxPaged(jparams, jcfg, prefer_native=False,
                             prefix_cache=True, **SMALL, **kw))
    got = scenario(PagedLLMEngine(tparams, tcfg, prefix_cache=True,
                                  device="cpu", **SMALL, **kw))
    cold = LLMEngine(tparams, tcfg, n_slots=kw["n_slots"], device="cpu",
                     **SMALL)
    return got, want, cold


def _forced_eviction(eng):
    obs = {"first": eng.generate(PROMPT, 6),
           "misses": eng.metrics()["prefix_misses"],
           "evicted": eng.kvcache.evict(10**6)}
    eng._flush_derefs()
    obs["all_free"] = eng._pool.free_blocks == eng._pool.capacity_blocks
    obs["recompute"] = eng.generate(PROMPT, 6)
    obs["rebanked_hit"] = eng.generate(PROMPT, 6)
    eng._pool.check_invariants()
    m = eng.metrics()
    obs.update(hits=m["prefix_hits"], kv_pool=m["kv_pool"],
               trie_blocks=m["prefix_cache"]["blocks"], held=len(eng._held))
    return obs


def test_forced_eviction_recompute_is_byte_identical_as_jax(tiny):
    got, want, cold = _both(tiny, _forced_eviction, n_slots=2)
    assert got == want
    ref = cold.generate(PROMPT, 6)
    assert got["first"] == got["recompute"] == got["rebanked_hit"] == ref
    assert got["misses"] == 1 and got["evicted"] > 0 and got["all_free"]
    assert got["hits"] >= 1 and got["held"] == 0
    assert got["kv_pool"]["used_blocks"] == got["trie_blocks"]
    assert got["kv_pool"]["alloc_failures"] == 0


def _suffix_funding(eng):
    obs = {"first": eng.generate(PREFIX2, 6)}
    blocker = eng.submit(BLOCKER, 25)
    eng.step()                       # the blocker takes 4 blocks
    obs["free_before"] = eng._pool.free_blocks
    rid = eng.submit(list(PREFIX2), 6)
    eng.step()                       # funded now, on the suffix alone
    obs.update(held=len(eng._held), free_after=eng._pool.free_blocks)
    for _ in range(200):
        if eng.is_done(rid):
            break
        eng.step()
    obs["hit"] = eng.result(rid)
    m = eng.metrics()
    obs.update(hits=m["prefix_hits"],
               alloc_failures=m["kv_pool"]["alloc_failures"])
    eng._pool.check_invariants()
    eng.cancel(blocker)
    return obs


def test_cached_prefix_funds_only_its_suffix_as_jax(tiny):
    got, want, cold = _both(tiny, _suffix_funding, n_slots=2,
                            pool_blocks=7)
    assert got == want
    assert got["first"] == got["hit"] == cold.generate(PREFIX2, 6)
    assert got["free_before"] == 1 and got["held"] == 0
    assert got["free_after"] == 0
    assert got["hits"] == 1 and got["alloc_failures"] == 0


def _held_retry(eng):
    eng.generate(PREFIX2, 6)         # banks two blocks: five free
    blocker = eng.submit(BLOCKER, 25)
    eng.step()
    obs = {"free_before": eng._pool.free_blocks}
    # needs 4, 2 cached: 2 to allocate, 1 free -> held, and the valve may
    # not evict the pinned prefix while it decides
    rid = eng.submit(list(PREFIX2), 15)
    eng.step()
    obs.update(held=len(eng._held),
               trie_blocks=eng.metrics()["prefix_cache"]["blocks"])
    for _ in range(600):
        if eng.is_done(rid):
            break
        eng.step()
    obs["tokens"] = eng.result(rid)
    obs.update(hits=eng.metrics()["prefix_hits"], held_after=len(eng._held))
    eng._pool.check_invariants()
    eng.cancel(blocker)
    return obs


def test_held_retry_keeps_the_prefix_pinned_and_reprobes_as_jax(tiny):
    got, want, cold = _both(tiny, _held_retry, n_slots=3, pool_blocks=7)
    assert got == want
    assert got["tokens"] == cold.generate(PREFIX2, 15)
    assert got["free_before"] == 1 and got["held"] == 1
    assert got["trie_blocks"] == 2
    assert got["hits"] == 1 and got["held_after"] == 0


def test_trie_evictions_wait_for_the_chunk_in_flight(tiny):
    _, tcfg, _, tparams = tiny
    eng = PagedLLMEngine(tparams, tcfg, n_slots=2, prefix_cache=True,
                         device="cpu", **SMALL)
    eng.generate(PREFIX2, 4)
    banked = eng.metrics()["prefix_cache"]["blocks"]
    rid = eng.submit(BLOCKER, 12)
    eng.step()                       # prefill
    eng.step()                       # a decode chunk, left in flight
    assert eng._pending is not None
    free = eng._pool.free_blocks
    assert eng.kvcache.evict(10**6) == banked == 2
    assert eng._pool.free_blocks == free          # deferred
    eng.run_until_idle()
    assert eng.is_done(rid) and eng._pending is None
    assert eng._pool.free_blocks == eng._pool.capacity_blocks
    eng._pool.check_invariants()


def test_splices_land_in_the_device_table_in_place(tiny):
    _, tcfg, _, tparams = tiny
    eng = PagedLLMEngine(tparams, tcfg, n_slots=2, prefix_cache=True,
                         device="cpu", **SMALL)
    tbl = eng.cache["tbl"]
    ptr = tbl.data_ptr()
    eng.generate(PREFIX2, 4)
    chain = eng.kvcache.match(PREFIX2, max_tokens=16, namespace=0)
    ids = [int(b) for b in chain.payloads]
    eng.kvcache.release(chain)
    long = PREFIX2 + list(range(60, 70))     # 27 tokens: chunked
    for prompt in (PREFIX2 + [9], long):
        rid = eng.submit(prompt, 6)
        eng.step()
        slot = next(s for s in range(2)
                    if eng.scheduler.slot_request(s) == rid)
        assert eng.cache["tbl"] is tbl and tbl.data_ptr() == ptr
        assert np.array_equal(tbl.numpy(), eng._tbl_host)
        assert [int(b) for b in eng._tbl_host[slot, :2]] == ids
        assert eng.cached_tokens(rid) == 16
        eng.run_until_idle()
    for r in range(2):
        assert eng._pool.refcount(ids[r]) == 1     # the trie's alone


def test_small_pool_burst_and_second_turns_equal_the_slab_engine(tiny):
    """A system prompt banked, a burst of 8 sharing it (waves and two
    chunked chains), then second turns, through a pool too small to keep
    every banked block: the valve evicts, the tokens equal the slab
    engine's with the cache and the paged engine's with a large pool,
    and at idle only the trie's blocks are in use."""
    _, tcfg, _, tparams = tiny
    kw = dict(n_slots=8, max_len=64, buckets=(8, 16, 32), decode_chunk=4,
              prefix_cache=True, device="cpu")
    system = [(3 * i + 1) % 500 + 1 for i in range(16)]
    rng = np.random.default_rng(0)
    burst = [system + rng.integers(1, 500, n).tolist()
             for n in (3, 5, 9, 12, 14, 16, 20, 30)]

    def drain(eng):
        # bounded: a pool that can never fund a held prefill would spin
        for _ in range(1000):
            if not eng.step():
                return
        raise AssertionError("the engine never went idle")

    def run(eng):
        rids = [eng.submit(system + [7, 7, 7], 4)]
        drain(eng)
        rids += [eng.submit(p, 6) for p in burst]
        drain(eng)
        outs = [eng.result(r) for r in rids]
        turns = [burst[i] + outs[1 + i] + [11, 12, 13] for i in (2, 5, 7)]
        rids = [eng.submit(p, 6) for p in turns]
        drain(eng)
        outs += [eng.result(r) for r in rids]
        reuse = [eng.cached_tokens(r) for r in rids]
        return outs, reuse

    want, want_reuse = run(LLMEngine(tparams, tcfg, **kw))
    big, big_reuse = run(PagedLLMEngine(tparams, tcfg, **kw))
    eng = PagedLLMEngine(tparams, tcfg, pool_blocks=12, **kw)
    got, _ = run(eng)
    assert got == big == want and big_reuse == want_reuse
    assert all(r > 16 for r in want_reuse)
    m = eng.metrics()
    assert m["prefix_cache"]["evicted_blocks"] > 0
    assert m["kv_pool"]["alloc_failures"] > 0        # the valve fired
    assert m["kv_pool"]["used_blocks"] == m["prefix_cache"]["blocks"]
    assert m["held_prefills"] == 0
    eng._pool.check_invariants()
    eng.kvcache.check_invariants()
