"""Tenants on the port's engines and supervisor against the JAX
package's, on `LlamaConfig.tiny()` with the same weights: a flood
submitted whole before the first step under tenant caps gives the same
refusals (`TenantOverQuota`), the same admission order (the scheduler's
max-min fair pop), the same greedy tokens and the same completed and
rejected counts, on the slab engine and the paged one, each on its C++
scheduler and with the Python twin put in its place; the supervisors
under the committed `crash_midstream` script with a `ShedPolicy` give
the same `accounting()`, `shed` included, shedding only the low tenant
and only while degraded, with the tenant caps applied again to the
restarted engine, on the slab and the paged engine. Also: `ShedPolicy`
ranks as JAX's, a scheduler's `max_queue` refuses past its bound with
the JAX engine's `QueueFull`, tenant ids are bounded by MAX_TENANTS, and
adapters and bad tenant names are refused."""

import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.chaos import load_fault_script as jax_fault_script
from kubeflow_tpu.models import llama as jllama
from kubeflow_tpu.serving import scheduler as jsched
from kubeflow_tpu.serving.agent import EngineSupervisor as JaxSupervisor
from kubeflow_tpu.serving.llm import LLMEngine as JaxEngine
from kubeflow_tpu_torch.chaos import load_fault_script
from kubeflow_tpu_torch.models import interop
from kubeflow_tpu_torch.models import llama as tllama
from kubeflow_tpu_torch.obs.metrics import render_metrics
from kubeflow_tpu_torch.serving import scheduler as tsched
from kubeflow_tpu_torch.serving.agent import EngineSupervisor
from kubeflow_tpu_torch.serving.llm import LLMEngine
from kubeflow_tpu_torch.serving.paged import PagedLLMEngine

torch.set_num_threads(2)

ENGINE = dict(n_slots=4, max_len=48, buckets=(8, 16), decode_chunk=4)
#: the flood: tenant of each request, all submitted before the first step
FLOOD = ["t0"] * 8 + ["t1"] * 3 + [None] * 2 + ["t0", "t2"]
CAPS = (1, 4)
SUP = dict(backoff_base_s=0.01, backoff_cap_s=0.02, stall_timeout_s=5.0)
PROMPTS = [[3, 17, 101, 44, 9], list(range(20, 32)), [7, 7, 200, 201]]
NEW = 12
#: the supervisor counts compared (outage instants are not)
COUNTS = ("accepted", "completed", "cancelled", "rejected", "shed",
          "retried", "replayed", "replay_verified", "replay_mismatch",
          "restarts", "in_flight", "terminal", "lost", "permanent_failed",
          "journal_depth")


@pytest.fixture(scope="module")
def tiny():
    jcfg = dataclasses.replace(jllama.LlamaConfig.tiny(), dtype=jnp.float32)
    tcfg = dataclasses.replace(tllama.LlamaConfig.tiny(),
                               dtype=torch.float32)
    jparams = jllama.init(jax.random.key(0), jcfg)
    tparams = interop.from_jax_params(jax.tree.map(np.asarray, jparams),
                                      tcfg, device="cpu")
    return jcfg, tcfg, jparams, tparams


def _flood_requests(vocab: int):
    rng = np.random.default_rng(7)
    return [(rng.integers(1, vocab, int(rng.integers(3, 15))).tolist(),
             int(rng.integers(3, 11))) for _ in FLOOD]


def _flood(eng, requests, error):
    """Submit the flood whole, then step to idle. Returns each request's
    tokens (or "refused"), the pop order as flood indices and the
    engine's completed/rejected counts."""
    pops = []
    inner = eng.scheduler.next

    def next_recorded():
        a = inner()
        if type(a).__name__ == "PrefillAction":
            pops.append(a.req_id)
        return a

    eng.scheduler.next = next_recorded
    eng.set_tenant_limits(*CAPS)
    rids = []
    for (prompt, new), tenant in zip(requests, FLOOD):
        try:
            rids.append(eng.submit(prompt, new, tenant=tenant))
        except error:
            rids.append(None)
    eng.run_until_idle()
    index = {rid: i for i, rid in enumerate(rids) if rid is not None}
    out = [eng.result(r) if r is not None else "refused" for r in rids]
    m = eng.metrics()
    return out, [index[r] for r in pops], (m["completed"], m["rejected"])


@pytest.fixture(scope="module")
def jax_flood(tiny):
    jcfg, _, jparams, _ = tiny
    eng = JaxEngine(jparams, jcfg, prefer_native=False, **ENGINE)
    return _flood(eng, _flood_requests(jcfg.vocab_size),
                  jsched.TenantOverQuota)


@pytest.mark.parametrize("layout,native", [("slab", True), ("slab", False),
                                           ("paged", True), ("paged", False)])
def test_flood_under_caps_as_jax(tiny, jax_flood, layout, native):
    _, tcfg, _, tparams = tiny
    cls = PagedLLMEngine if layout == "paged" else LLMEngine
    eng = cls(tparams, tcfg, device="cpu", **ENGINE)
    assert type(eng.scheduler) is tsched.NativeScheduler
    if not native:   # the Python twin, the oracle, in the engine's place
        eng.scheduler = tsched.PyScheduler(eng.n_slots, eng.buckets)
    got = _flood(eng, _flood_requests(tcfg.vocab_size),
                 tsched.TenantOverQuota)
    assert got == jax_flood
    toks, pops, (completed, rejected) = got
    # t0's requests past its 4 queued are refused; nobody else's
    assert [i for i, t in enumerate(toks) if t == "refused"] == [4, 5, 6, 7,
                                                                 13]
    assert (completed, rejected) == (10, 5)
    # the fair pop: t0's head, then t1's and the anonymous tenant's
    # before t0's second request
    assert pops[:4] == [0, 8, 11, 14]


def _shed_run(sup, script, sched):
    """Requests of the high tenant t0 and the low tenant t1, a crash once
    each has a token, submits while the engine is down, then after the
    restart. Returns the tokens, the counts and what was shed when."""
    sup.set_tenant_limits(2, 3)
    rids = [sup.submit(PROMPTS[0], NEW, tenant="t0"),
            sup.submit(PROMPTS[1], NEW, tenant="t1")]
    while not all(sup.partial_result(r) for r in rids):
        sup.step()
    sup.arm_faults(script)
    sup.step()                 # arms the script's clock
    time.sleep(0.1)            # past the crash instant
    sup.step()                 # the crash
    assert sup.engine is None and sup.degraded
    shed = []
    for tenant in ("t1", None, "t0", "t1"):
        try:
            rids.append(sup.submit(PROMPTS[2], NEW, tenant=tenant))
            shed.append(False)
        except sched.TenantShed:
            shed.append(True)
    sup.run_until_idle()
    assert sup.engine is not None and not sup.degraded
    # the caps came back with the engine: t0's third queued request is
    # refused by the restarted engine's scheduler
    over = []
    for _ in range(4):
        try:
            rids.append(sup.submit(PROMPTS[2], NEW, tenant="t0"))
            over.append(False)
        except sched.TenantOverQuota:
            over.append(True)
    rids.append(sup.submit(PROMPTS[0], NEW, tenant="t1"))   # not shed now
    sup.run_until_idle()
    acc = sup.accounting()
    return ([sup.result(r) for r in rids], {k: acc[k] for k in COUNTS},
            shed, over)


@pytest.fixture(scope="module")
def jax_shed(tiny):
    jcfg, _, jparams, _ = tiny
    jsup = JaxSupervisor(
        lambda: JaxEngine(jparams, jcfg, prefer_native=False, **ENGINE),
        shed_policy=jsched.ShedPolicy(priorities=(("t0", 1),)), **SUP)
    return _shed_run(jsup, jax_fault_script("crash_midstream",
                                            duration_s=0.05), jsched)


@pytest.mark.parametrize("layout", ["slab", "paged"])
def test_supervisor_sheds_while_degraded_as_jax(tiny, jax_shed, layout):
    _, tcfg, _, tparams = tiny
    cls = PagedLLMEngine if layout == "paged" else LLMEngine
    tsup = EngineSupervisor(
        lambda: cls(tparams, tcfg, device="cpu", **ENGINE),
        shed_policy=tsched.ShedPolicy(priorities=(("t0", 1),)), **SUP)
    got = _shed_run(tsup, load_fault_script("crash_midstream",
                                            duration_s=0.05), tsched)
    assert got == jax_shed
    toks, counts, shed, over = got
    assert shed == [True, True, False, True]
    assert over == [False, False, False, True]
    assert counts["shed"] == 3 and counts["restarts"] == 1
    assert counts["lost"] == 0 and counts["replay_verified"] == 2
    assert all(len(t) == NEW for t in toks)
    assert 'scheduler_shed_total{engine="supervisor"}' in render_metrics()


@pytest.mark.parametrize("kw", [
    {}, {"priorities": (("gold", 2), ("silver", 1)), "shed_below": 2},
    {"priorities": (("t0", -1),), "default_priority": 5, "shed_below": 3}])
def test_shed_policy_ranks_as_jax(kw):
    got, want = tsched.ShedPolicy(**kw), jsched.ShedPolicy(**kw)
    for tenant in (None, "gold", "silver", "t0", "bronze"):
        assert got.priority_of(tenant) == want.priority_of(tenant)
        assert got.sheds(tenant) == want.sheds(tenant)


@pytest.mark.parametrize("native", [True, False])
def test_queue_full_past_max_queue_as_jax(tiny, native):
    """The scheduler's max_queue bounds the queue over every tenant: past
    it submit raises QueueFull, counted as rejected, on both frameworks
    (the port's engine given a scheduler with a small bound)."""
    jcfg, tcfg, jparams, tparams = tiny
    tenants = ["a", "b", None, "a", "c", "b"]
    out = []
    for eng, sched in (
            (JaxEngine(jparams, jcfg, prefer_native=False, max_queue=4,
                       **ENGINE), jsched),
            (LLMEngine(tparams, tcfg, device="cpu", **ENGINE), tsched)):
        if sched is tsched:
            twin = tsched.NativeScheduler if native else tsched.PyScheduler
            eng.scheduler = twin(eng.n_slots, eng.buckets, max_queue=4)
        rids = []
        for i, t in enumerate(tenants):
            try:
                rids.append(eng.submit(PROMPTS[i % 3], 3, tenant=t))
            except sched.QueueFull as e:
                assert not isinstance(e, sched.TenantOverQuota)
                rids.append(None)
        eng.run_until_idle()
        m = eng.metrics()
        out.append(([r is None for r in rids],
                    [eng.result(r) for r in rids if r is not None],
                    (m["completed"], m["rejected"], m["tenants_seen"])))
    assert out[1] == out[0]
    assert out[0][0] == [False] * 4 + [True] * 2


def test_tenant_ids_unique_and_bounded(tiny):
    """Distinct names mint distinct scheduler ids; past MAX_TENANTS a new
    name shares the anonymous id 0 (the JAX engine's rule)."""
    _, tcfg, _, tparams = tiny
    eng = LLMEngine(tparams, tcfg, device="cpu", **ENGINE)
    with eng._submit_lock:
        ids = [eng._tenant_id(f"u{i}") for i in range(5)]
        assert eng._tenant_id(None) == 0
    assert ids == [1, 2, 3, 4, 5]
    eng.MAX_TENANTS = len(eng._tenant_idx)
    with eng._submit_lock:
        assert eng._tenant_id("overflow") == 0
        assert eng._tenant_id("u0") == ids[0]
    assert "overflow" not in eng._tenant_idx
    assert eng.metrics()["tenants_seen"] == 5


def test_adapters_and_bad_tenants_refused(tiny):
    _, tcfg, _, tparams = tiny
    eng = LLMEngine(tparams, tcfg, device="cpu", **ENGINE)
    # adapters are ported (queue A3); this engine loads none
    with pytest.raises(ValueError, match="unknown adapter 'a0'"):
        eng.submit(PROMPTS[0], 2, adapter="a0")
    with pytest.raises(ValueError, match="tenant"):
        eng.submit(PROMPTS[0], 2, tenant="")
    rid = eng.submit(PROMPTS[0], 2, adapter=None, tenant="t")
    eng.run_until_idle()
    assert len(eng.result(rid)) == 2
    # a prompt no chunk plan fits counts as a scheduler rejection, as JAX
    with pytest.raises(Exception, match="max_len|chunk|bucket"):
        eng.submit(list(range(1, 60)), 2)
    assert eng.metrics()["rejected"] == 1
