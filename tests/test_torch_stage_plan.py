"""The port's stage split (kubeflow_tpu_torch/parallel/pipeline.py and the
stage-keyed prefix store of kvcache/radix.py) against the JAX package's
functions on the same inputs: `stage_bounds`, `microbatch_ranges` and
`wavefront` over a grid of geometries (with their errors),
`resolve_schedule` over the environment, `StagePerf` snapshots over a
seeded sequence of records, `split_stage_params` on f32 and int8 trees
(views of the stacked leaves, no copy), `InferenceStagePlan.describe`,
and `StagePartitionedKVCache` step for step over seeded op sequences,
then the JAX test's unit case on the port's class."""

import random

import jax
import numpy as np
import pytest
import torch

from kubeflow_tpu.kvcache.radix import RadixKVCache as JaxRadix
from kubeflow_tpu.kvcache.radix import \
    StagePartitionedKVCache as JaxStageCache
from kubeflow_tpu.parallel import pipeline as jpipe
from kubeflow_tpu_torch.kvcache import (RadixKVCache,
                                        StagePartitionedKVCache)
from kubeflow_tpu_torch.models import llama
from kubeflow_tpu_torch.parallel import pipeline as tpipe

GRID = [(a, b) for a in range(0, 11) for b in range(0, 12)]


def _outcome(fn, *args):
    try:
        out = fn(*args)
        return ("ok", list(out) if not isinstance(out, list) else out)
    except ValueError as e:
        return ("ValueError", str(e))


@pytest.mark.parametrize("name", ["stage_bounds", "microbatch_ranges",
                                  "wavefront"])
def test_geometry_equal_jax(name):
    """Every (a, b) of the grid gives the JAX function's result, or its
    error with its message."""
    for a, b in GRID:
        if name == "microbatch_ranges" and a == 0:
            continue   # no slots: the JAX function divides by zero too
        assert _outcome(getattr(tpipe, name), a, b) \
            == _outcome(getattr(jpipe, name), a, b), (name, a, b)


def test_resolve_schedule_equal_jax(monkeypatch):
    for env in (None, "", "1", "on", "overlapped", "OVERLAPPED ", "0",
                "off", "sync", "bogus"):
        if env is None:
            monkeypatch.delenv(tpipe.SCHEDULE_ENV, raising=False)
        else:
            monkeypatch.setenv(tpipe.SCHEDULE_ENV, env)
        for configured in (None, "sync", "overlapped", "bogus"):
            assert _outcome(tpipe.resolve_schedule, configured) \
                == _outcome(jpipe.resolve_schedule, configured), \
                (env, configured)
    assert tpipe.SCHEDULE_ENV == jpipe.SCHEDULE_ENV


def test_stage_perf_snapshot_equal_jax():
    """A seeded sequence of steps, stage times, resets and schedule
    kinds: every snapshot equal to the JAX StagePerf's; the clock's
    bracket adds to one stage and passes the value through."""
    rng = random.Random(3)
    for n_stages in (1, 2, 3, 5):
        a, b = tpipe.StagePerf(n_stages), jpipe.StagePerf(n_stages)
        assert a.snapshot() == b.snapshot()
        for _ in range(60):
            op = rng.random()
            if op < 0.4:
                m, wall = rng.randint(1, 6), rng.uniform(0, 0.01)
                a.record_step(m, wall)
                b.record_step(m, wall)
            elif op < 0.8:
                s, busy = rng.randrange(n_stages), rng.uniform(0, 0.004)
                a.record_stage(s, busy)
                b.record_stage(s, busy)
            elif op < 0.9:
                a.schedule = b.schedule = rng.choice(["sync", "overlapped"])
            else:
                a.reset()
                b.reset()
            assert a.snapshot() == b.snapshot()
    perf = tpipe.StagePerf(2)
    assert tpipe.StageClock(perf, False).run(1, lambda: 7) == 7
    assert perf.stage_busy_s == [0.0, 0.0]
    assert tpipe.StageClock(perf, True).run(1, lambda: 8) == 8
    assert perf.stage_busy_s[0] == 0.0 and perf.stage_busy_s[1] > 0.0


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    return tree.numpy()


def _storage(t: torch.Tensor) -> int:
    return t.untyped_storage().data_ptr()


@pytest.mark.parametrize("quant", [None, "int8"], ids=["f32", "int8"])
def test_split_stage_params_views_equal_jax(quant):
    """Each slab's leaves equal the JAX split of the same tree (an int8
    tree's {"q", "s"} subtrees included) and share the stacked leaves'
    storage: the slabs hold no copy of the weights."""
    cfg = llama.LlamaConfig(vocab_size=64, d_model=32, n_layers=5,
                            n_heads=4, n_kv_heads=2, d_ff=64,
                            dtype=torch.float32)
    params = llama.init(cfg, seed=1, device="cpu", quantize=quant)
    for n_stages in (1, 2, 3, 5):
        bounds = tpipe.stage_bounds(cfg.n_layers, n_stages)
        got = tpipe.split_stage_params(params, bounds)
        want = jpipe.split_stage_params(_np_tree(params), bounds)
        assert len(got) == len(want) == n_stages
        for slab, ref in zip(got, want):
            flat = jax.tree_util.tree_flatten_with_path(ref)[0]
            assert sorted(slab) == sorted(ref)
            for path, leaf in flat:
                t = slab
                for k in path:
                    t = t[k.key]
                np.testing.assert_array_equal(t.numpy(), leaf)
                full = params
                for k in path:
                    full = full[k.key]
                assert _storage(t) == _storage(full), path
        if quant:
            assert got[0]["layers"]["wq"]["q"].dtype == torch.int8
            assert got[-1]["lm_head"]["s"].dtype == torch.float32


def test_inference_stage_plan_describe_equal_jax():
    """Virtual staging on one device: describe() equal to the JAX plan's
    on one CPU device; to_stage the identity; tensor > 1 names A6c-iii;
    more stages than layers raise as in JAX."""
    one = jax.devices()[:1]
    for n_layers, stage, slots in ((4, 1, 2), (4, 2, 2), (3, 2, 3),
                                   (4, 4, 2), (32, 3, 16)):
        plan = tpipe.InferenceStagePlan(n_layers, stage, slots,
                                        device="cpu")
        ref = jpipe.InferenceStagePlan(n_layers, stage, slots, devices=one)
        assert plan.describe() == ref.describe()
        assert plan.virtual and plan.devices == [torch.device("cpu")] * stage
        x = torch.ones(2)
        assert plan.to_stage(x, stage - 1) is x
        assert plan.perf.snapshot() == ref.perf.snapshot()
    with pytest.raises(ValueError, match="A6c-iii"):
        tpipe.InferenceStagePlan(4, 2, 2, tensor=2, device="cpu")
    with pytest.raises(ValueError, match="n_stages"):
        tpipe.InferenceStagePlan(4, 5, 2, device="cpu")


def _drive(cache, seed, n_steps, n_stages, bt):
    """A seeded op sequence on a stage-partitioned store; returns what
    each step gave back, the payload calls included."""
    rng = random.Random(seed)
    calls, log, live, seqs = [], [], [], []
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
                return tuple((step, st, i, s, e) for st in range(n_stages))
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
            cache.release(live.pop(rng.randrange(len(live))))
            out = "released"
        elif op < 0.76:
            out = cache.inner.evict(rng.randint(0, 2 * n_stages))
        elif op < 0.84:
            out = cache.cached_prefix_len(seq, max_tokens=cap, namespace=ns)
        elif op < 0.92:
            if rng.random() < 0.5:
                cache.record_hit(tenant, rng.randint(0, 64))
            else:
                cache.record_miss(tenant)
            out = "recorded"
        else:
            out = cache.stats()
        cache.check_invariants()
        log.append((step, out, cache.n_blocks))
    return log, calls


@pytest.mark.parametrize("n_stages", [2, 3])
def test_stage_partitioned_cache_equal_jax(n_stages):
    """The port's store and the JAX one, each over a small inner cache
    (evictions cut one stage's chain before another's), give the same
    result at every step, make the same payload calls and hold the same
    blocks."""
    bt, cap = 2, 7 * n_stages
    for seed in range(4):
        ours = StagePartitionedKVCache(RadixKVCache(bt, cap), n_stages)
        ref = JaxStageCache(JaxRadix(bt, cap), n_stages)
        assert _drive(ours, seed, 150, n_stages, bt) \
            == _drive(ref, seed, 150, n_stages, bt)
        assert (ours.block_tokens, ours.capacity_blocks) \
            == (ref.block_tokens, ref.capacity_blocks)


def test_stage_partitioned_cache_units():
    """The JAX suite's unit case on the port's class: per-stage
    namespaces, the minimum across stages when one stage holds a longer
    chain, logical accounting, clear."""
    inner = RadixKVCache(2, 64)
    c = StagePartitionedKVCache(inner, 2)
    toks = [1, 2, 3, 4, 5, 6]
    assert c.insert(toks, lambda i, a, b: ((0, i), (1, i)),
                    tenant="t") == 3
    assert inner.n_blocks == 6
    m = c.match(toks)
    assert m.tokens == 6 and m.payloads[1] == ((0, 1), (1, 1))
    c.release(m)
    assert c.cached_prefix_len(toks) == 6
    st = c.stats()
    assert st["stages"] == 2 and st["logical_blocks"] == 3
    assert st["per_tenant"]["t"]["inserted_blocks"] == 3   # stage 0 only
    inner.insert([1, 2, 3, 4, 5, 6, 7, 8], lambda i, a, b: ("only0", i),
                 namespace=(None, 0))
    m = c.match([1, 2, 3, 4, 5, 6, 7, 8])
    assert m.tokens == 6
    c.release(m)
    assert inner.evict(1) == 1 and c.n_blocks == 6
    c.clear()
    assert c.n_blocks == 0
    c.check_invariants()
    with pytest.raises(ValueError):
        StagePartitionedKVCache(inner, 0)
