"""The port's continuous-batching scheduler: its C++ core
(`NativeScheduler` over kubeflow_tpu_torch/native/cb_scheduler.cpp) and
its Python twin against the JAX package's `PyScheduler`, on seeded
random sequences of submit (tenant, `now`), set_fairness, next,
token_done, cancel, stats, tenant_active and slot_request: the same
actions, errors and stats at every step. Then the JAX fairness cases of
tests/test_scheduler_fairness.py on both port twins, the engine on the
C++ core with no silent fallback, the library's build under the port's
git-ignored `_build/`, and both twins under concurrent submitters."""

import dataclasses
import random
import sys
import threading
from pathlib import Path

import pytest

from kubeflow_tpu.serving import scheduler as jsched
from kubeflow_tpu_torch import native
from kubeflow_tpu_torch.serving import scheduler as tsched

TWINS = (tsched.NativeScheduler, tsched.PyScheduler)
BUCKETS = (8, 16, 32)


def _act(a):
    """An action as comparable data (the twins' classes differ)."""
    if a is None:
        return None
    return type(a).__name__, dataclasses.astuple(a)


def _call(fn, *a, **kw):
    """A call's result, or the name of the exception it raised."""
    try:
        out = fn(*a, **kw)
    except (RuntimeError, ValueError) as e:
        return "raised", type(e).__name__
    if dataclasses.is_dataclass(out):
        return _act(out)
    return out


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_twins_act_as_the_jax_scheduler(seed):
    rng = random.Random(seed)
    n_slots, max_queue = 3, 10
    scheds = [jsched.PyScheduler(n_slots, BUCKETS, max_queue)] + [
        cls(n_slots, BUCKETS, max_queue) for cls in TWINS]
    seen = []
    for i in range(600):
        op = rng.random()
        if op < 0.40:
            args = (rng.choice((0, 4, 9, 17, 31, 32, 40)),
                    rng.randint(1, 4))
            kw = dict(now=float(i), tenant=rng.randint(-1, 4))
            outs = [_call(s.submit, *args, **kw) for s in scheds]
            if isinstance(outs[0], int):
                seen.append(outs[0])
        elif op < 0.45:
            caps = (rng.randint(0, 3), rng.randint(0, 5))
            outs = [_call(s.set_fairness, *caps) for s in scheds]
        elif op < 0.55 and seen:
            rid = rng.choice(seen + [10**6])
            outs = [_call(s.cancel, rid) for s in scheds]
        elif op < 0.70:
            slot = rng.randrange(n_slots)
            fin = rng.random() < 0.3
            outs = [_call(s.token_done, slot, fin) for s in scheds]
        else:
            outs = [_call(s.next) for s in scheds]
        assert outs[1] == outs[0] and outs[2] == outs[0], (i, outs)
        for s in scheds[1:]:
            assert dataclasses.astuple(s.stats()) == dataclasses.astuple(
                scheds[0].stats())
            for t in range(5):
                assert s.tenant_active(t) == scheds[0].tenant_active(t)
            for slot in range(n_slots):
                assert s.slot_request(slot) == scheds[0].slot_request(slot)
    st = scheds[0].stats()
    assert st.rejected > 0 and st.completed > 0


# -- the JAX fairness cases, on both port twins -------------------------------

def _single_tenant_stays_fifo(cls):
    s = cls(2, (8,))
    ids = [s.submit(4, 2) for _ in range(4)]
    assert [s.next().req_id for _ in range(2)] == ids[:2]
    assert isinstance(s.next(), tsched.DecodeAction)


def _max_min_fair_pop_interleaves_tenants(cls):
    s = cls(4, (8,))
    a_ids = [s.submit(4, 2, tenant=1) for _ in range(4)]
    b_ids = [s.submit(4, 2, tenant=2) for _ in range(2)]
    order = [s.next().req_id for _ in range(4)]
    assert order == [a_ids[0], b_ids[0], a_ids[1], b_ids[1]]


def _share_cap_skips_over_cap_tenant(cls):
    s = cls(3, (8,))
    s.set_fairness(max_active_per_tenant=1)
    a1 = s.submit(4, 8, tenant=1)
    a2 = s.submit(4, 8, tenant=1)
    b1 = s.submit(4, 8, tenant=2)
    assert s.next().req_id == a1
    assert s.next().req_id == b1
    assert s.next().req_id == a2        # work-conserving
    assert s.tenant_active(1) == 2 and s.tenant_active(2) == 1


def _admission_quota_rejects_per_tenant(cls):
    s = cls(1, (8,))
    s.set_fairness(max_queued_per_tenant=2)
    s.submit(4, 2, tenant=1)
    s.submit(4, 2, tenant=1)
    before = s.stats().rejected
    with pytest.raises(tsched.TenantOverQuota):
        s.submit(4, 2, tenant=1)
    assert s.stats().rejected == before + 1
    s.submit(4, 2, tenant=2)
    assert s.stats().queued == 3
    # the subtypes a server maps to 503
    assert issubclass(tsched.TenantOverQuota, tsched.QueueFull)
    assert issubclass(tsched.TenantShed, tsched.QueueFull)


def _freed_slot_returns_to_starved_tenant(cls):
    s = cls(2, (8,))
    for _ in range(3):
        s.submit(4, 4, tenant=1)
    sl0 = s.next().slot
    s.next()
    assert s.tenant_active(1) == 2
    b = s.submit(4, 4, tenant=2)
    s.token_done(sl0, finished=True)
    assert s.next().req_id == b
    assert s.tenant_active(2) == 1


def _cancel_queued_under_tenant_queues(cls):
    s = cls(1, (8,))
    s.submit(4, 2, tenant=1)
    r2 = s.submit(4, 2, tenant=2)
    assert s.cancel(r2) == "queued"
    assert s.stats().queued == 1
    assert s.cancel(r2) is None


FAIRNESS_CASES = (_single_tenant_stays_fifo,
                  _max_min_fair_pop_interleaves_tenants,
                  _share_cap_skips_over_cap_tenant,
                  _admission_quota_rejects_per_tenant,
                  _freed_slot_returns_to_starved_tenant,
                  _cancel_queued_under_tenant_queues)


@pytest.mark.parametrize("case", FAIRNESS_CASES,
                         ids=lambda f: f.__name__.strip("_"))
def test_fairness_case_on_both_twins(case):
    for cls in TWINS:
        case(cls)


def test_the_engine_runs_the_native_core_without_fallback(monkeypatch,
                                                          tmp_path):
    """The engine's scheduler is the C++ core; with no compiler the
    engine raises instead of falling back to the twin."""
    import torch

    from kubeflow_tpu_torch.models import llama as tllama
    from kubeflow_tpu_torch.serving.llm import LLMEngine

    cfg = dataclasses.replace(tllama.LlamaConfig.tiny(), dtype=torch.float32)
    params = tllama.init(cfg, seed=0, device="cpu")
    eng = LLMEngine(params, cfg, device="cpu", n_slots=2, max_len=32,
                    buckets=(8,))
    assert type(eng.scheduler) is tsched.NativeScheduler
    monkeypatch.setattr(native, "_libs", {})
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path)
    monkeypatch.setattr(native.shutil, "which", lambda _name: None)
    with pytest.raises(native.NativeUnavailable, match="compiler"):
        LLMEngine(params, cfg, device="cpu", n_slots=2, max_len=32,
                  buckets=(8,))
    monkeypatch.undo()
    with pytest.raises(ValueError, match="scheduler config"):
        tsched.NativeScheduler(0, (8,))


def test_library_builds_under_the_port_keyed_by_source(monkeypatch,
                                                       tmp_path):
    """The port's own source, built into kubeflow_tpu_torch/_build/
    (git-ignored), never the tracked native/build library; an edited
    source gets a library of its own."""
    lib = Path(native.library("cb_scheduler")._name)
    root = Path(native.__file__).resolve().parent.parent / "_build"
    assert lib.parent.parent == root and lib.name == "libcb_scheduler.so"
    assert "native/build" not in str(lib)
    src = tmp_path / "src"
    src.mkdir()
    text = (native.SRC_DIR / "cb_scheduler.cpp").read_text()
    (src / "cb_scheduler.cpp").write_text(text + "\n// edited\n")
    monkeypatch.setattr(native, "SRC_DIR", src)
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(native, "_libs", {})
    edited = Path(native.library("cb_scheduler")._name)
    assert edited.parent.name != lib.parent.name
    assert edited.parent.parent == tmp_path / "build"
    assert not list((tmp_path / "build").rglob("*.tmp"))


def test_twins_under_concurrent_submitters():
    """Submitters on many threads and one popping thread: every accepted
    id is unique, every pop a submitted request, and the counts add up
    (a lost update breaks one of them)."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for cls in TWINS:
            s = cls(4, (8,), max_queue=10**6)
            ids: list[list[int]] = [[] for _ in range(8)]
            popped: list[int] = []
            stop = threading.Event()

            def submitter(k):
                for i in range(300):
                    ids[k].append(s.submit(4, 1, now=float(i), tenant=k % 3))

            def popper():
                while not stop.is_set() or s.stats().queued:
                    a = s.next()
                    if isinstance(a, tsched.PrefillAction):
                        popped.append(a.req_id)
                        s.token_done(a.slot, finished=True)

            threads = [threading.Thread(target=submitter, args=(k,))
                       for k in range(8)]
            pop = threading.Thread(target=popper)
            pop.start()
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=60)
            stop.set()
            pop.join(timeout=60)
            assert not pop.is_alive()
            assert not any(th.is_alive() for th in threads)
            flat = [r for k in ids for r in k]
            assert len(set(flat)) == len(flat) == 2400
            assert sorted(popped) == sorted(flat)
            st = s.stats()
            assert (st.queued, st.active, st.completed, st.rejected) == (
                0, 0, 2400, 0)
    finally:
        sys.setswitchinterval(old)
