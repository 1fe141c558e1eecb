"""The port's radix prefix index (kubeflow_tpu_torch/kvcache/radix.py)
against the JAX package's `RadixKVCache`, step for step: seeded random
sequences of match (pins kept and released later), insert (with the
payload calls it makes), release, evict (with an evict_hook recording
each payload), cached_prefix_len, record_hit/record_miss, stats (with and
without an attached pool) and clear, over namespaces and tenants; both
`check_invariants` after every step. Then the eight cases of
tests/test_kvcache.py, run on the port's class."""

import random

import pytest

import test_kvcache
from kubeflow_tpu.kvcache.radix import RadixKVCache as JaxRadix
from kubeflow_tpu_torch.kvcache import RadixKVCache


class _Pool:
    """The two gauges stats() reads from an attached block pool."""

    def __init__(self):
        self.free_blocks = 5
        self.capacity_blocks = 9


def _drive(cache, seed, n_steps, bt, capacity):
    """Run the seeded op sequence on `cache`; returns everything each
    step gave back (the payload calls and evictions included)."""
    rng = random.Random(seed)
    calls, evicted, log, live = [], [], [], []
    cache.evict_hook = evicted.append
    pool = _Pool()
    seqs: list[list[int]] = []
    for step in range(n_steps):
        if not seqs or rng.random() < 0.3:
            seq = [rng.randint(1, 3) for _ in range(rng.randint(0, 5 * bt))]
        else:
            seq = list(rng.choice(seqs))
            if rng.random() < 0.5:
                seq += [rng.randint(1, 3)
                        for _ in range(rng.randint(1, 2 * bt))]
        seqs.append(seq)
        ns = rng.choice([0, 0, 1, None])
        tenant = rng.choice([None, "a", "b"])
        cap = rng.choice([None, None, len(seq) - 1, rng.randint(0, 4 * bt)])
        op = rng.random()
        if op < 0.35:
            def payload(i, s, e, step=step):
                calls.append((step, i, s, e))
                return (step, i, s, e)
            out = cache.insert(seq, payload, max_tokens=cap, tenant=tenant,
                               namespace=ns)
        elif op < 0.6:
            m = cache.match(seq, max_tokens=cap, namespace=ns)
            out = (m.tokens, list(m.payloads), m.n_blocks)
            if m.tokens and rng.random() < 0.5 and len(live) < 5:
                live.append(m)
            else:
                cache.release(m)
        elif op < 0.7 and live:
            m = live.pop(rng.randrange(len(live)))
            cache.release(m)
            cache.release(m)                  # idempotent
            out = "released"
        elif op < 0.78:
            out = cache.evict(rng.randint(0, capacity))
        elif op < 0.86:
            out = cache.cached_prefix_len(seq, max_tokens=cap, namespace=ns)
        elif op < 0.92:
            if rng.random() < 0.5:
                cache.record_hit(tenant, rng.randint(0, 64))
            else:
                cache.record_miss(tenant)
            out = "recorded"
        elif op < 0.96:
            if rng.random() < 0.5:
                cache.attach_pool(pool)
            out = cache.stats()
        else:
            try:
                cache.clear()
                out = "cleared"
            except RuntimeError as e:
                out = str(e)
        cache.check_invariants()
        log.append((step, out, cache.n_blocks, list(evicted)))
    for m in live:
        cache.release(m)
    cache.check_invariants()
    log.append(("end", cache.stats(), calls))
    return log


@pytest.mark.parametrize("seed,bt,capacity", [(0, 1, 6), (1, 2, 12),
                                              (2, 4, 40)])
def test_step_for_step_equal_to_jax(seed, bt, capacity):
    want = _drive(JaxRadix(bt, capacity), seed, 1500, bt, capacity)
    got = _drive(RadixKVCache(bt, capacity), seed, 1500, bt, capacity)
    for w, g in zip(want, got):
        assert g == w
    assert len(got) == len(want)


def test_rejects_what_jax_rejects():
    for args in ((0, 4), (4, 0)):
        with pytest.raises(ValueError):
            JaxRadix(*args)
        with pytest.raises(ValueError):
            RadixKVCache(*args)


KVCACHE_CASES = (
    "test_differential_against_brute_force_lcp",
    "test_differential_with_namespaces",
    "test_eviction_under_pressure_property",
    "test_all_pinned_insert_degrades_without_eviction",
    "test_interior_nodes_never_evicted_before_leaves",
    "test_accounting_per_tenant",
    "test_match_respects_max_tokens",
    "test_clear_refuses_with_pins_outstanding",
)


@pytest.mark.parametrize("case", KVCACHE_CASES)
def test_kvcache_cases_on_the_port(case, monkeypatch):
    monkeypatch.setattr(test_kvcache, "RadixKVCache", RadixKVCache)
    getattr(test_kvcache, case)()
