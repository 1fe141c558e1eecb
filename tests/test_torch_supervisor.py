"""The port's `EngineSupervisor` against the JAX package's: the same
`kubeflow_tpu.chaos` fault script, through a `FaultInjector`, drives
each supervisor over its own package's tiny engine (the same weights), and
the delivered tokens and the `accounting()` counts agree for a
backend_crash mid-stream, a decode_stall the watchdog catches, and a
restart budget run out (permanent failure: every stream ends with an
error event and one [DONE], and /v2/health/ready answers 503 on the
port's server and on the JAX server over the port's model). `close()`
drops the engine's tensors."""

import dataclasses
import gc
import json
import threading
import time
import urllib.error
import urllib.request
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.chaos import (FaultScriptConfig, FaultSpec,
                                generate_fault_script)
from kubeflow_tpu.chaos.injector import FaultInjector
from kubeflow_tpu.loadgen.http_client import stream_completion
from kubeflow_tpu.models import llama as jllama
from kubeflow_tpu.serving.agent import EngineSupervisor as JaxSupervisor
from kubeflow_tpu.serving.llm import LLMEngine as JaxEngine
from kubeflow_tpu.serving.model import ModelRepository
from kubeflow_tpu.serving.server import ModelServer
from kubeflow_tpu_torch.models import interop
from kubeflow_tpu_torch.models import llama as tllama
from kubeflow_tpu_torch.serving.agent import EngineSupervisor
from kubeflow_tpu_torch.serving.llm import LLMEngine
from kubeflow_tpu_torch.serving.llm_runtime import LLMModel
from kubeflow_tpu_torch.serving.paged import PagedLLMEngine
from kubeflow_tpu_torch.serving.scheduler import ShedPolicy, TenantOverQuota
from kubeflow_tpu_torch.serving.server import CompletionServer

torch.set_num_threads(2)

ENGINE = dict(n_slots=4, max_len=48, buckets=(8, 16), decode_chunk=4)
PROMPTS = [[3, 17, 101, 44, 9], list(range(20, 32)), [7, 7, 200, 201]]
NEW = 12
SUP = dict(backoff_base_s=0.01, backoff_cap_s=0.02, stall_timeout_s=0.2,
           stall_min_steps=3)
#: the accounting() keys that are counts (outage instants are not)
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


def _script(kind: str, count: int = 1, duration: float = 0.0):
    """Fault(s) at t=0: armed mid-run, they are due at the next step."""
    return generate_fault_script(FaultScriptConfig(
        seed=1, duration_s=1.0,
        faults=(FaultSpec(kind, count, (0.0, 0.0),
                          (duration, duration)),)), name=kind)


def _supervisors(tiny, **sup_kw):
    jcfg, tcfg, jparams, tparams = tiny
    kw = dict(SUP, **sup_kw)
    return (JaxSupervisor(lambda: JaxEngine(jparams, jcfg,
                                            prefer_native=False, **ENGINE),
                          **kw),
            EngineSupervisor(lambda: LLMEngine(tparams, tcfg, device="cpu",
                                               **ENGINE), **kw))


def _drive(sup, script):
    """Two greedy requests, a seeded one and an unseeded sampled one;
    the script is armed once every request has a token."""
    rids = [sup.submit(p, NEW) for p in PROMPTS[:2]]
    rids.append(sup.submit(PROMPTS[2], NEW, temperature=0.8, seed=3))
    rids.append(sup.submit(PROMPTS[2], NEW, temperature=0.8))
    armed = False
    while sup.step():
        if not armed and all(sup.partial_result(r) for r in rids):
            sup.arm_faults(FaultInjector(script))
            armed = True
    assert armed
    acc = sup.accounting()
    toks = [sup.result(r) for r in rids]
    return toks, {k: acc[k] for k in COUNTS}, sup


@pytest.mark.parametrize("kind,count", [("backend_crash", 1),
                                        ("decode_stall", 1),
                                        ("backend_crash", 2)])
def test_fault_delivers_what_the_jax_supervisor_does(tiny, kind, count):
    script = _script(kind, count,
                     duration=30.0 if kind == "decode_stall" else 0)
    jsup, tsup = _supervisors(tiny)
    jtoks, jacc, jsup = _drive(jsup, script)
    ttoks, tacc, tsup = _drive(tsup, script)
    # greedy rows replay byte-exact, on both; the sampled rows' draws
    # differ between the frameworks by design (ROADMAP.md parity
    # contract), but not their lengths or accounting
    assert ttoks[:2] == jtoks[:2]
    assert [len(t) for t in ttoks] == [len(t) for t in jtoks] == [NEW] * 4
    assert tacc == jacc
    assert tacc["restarts"] == count and tacc["lost"] == 0
    assert tacc["replay_verified"] == 3 and tacc["retried"] == count
    # the usage chains: byte-exact replays, and the unseeded row resumed
    rids = sorted(tsup._journal)
    assert [tsup.usage_chain(r) for r in rids] == [
        jsup.usage_chain(r) for r in sorted(jsup._journal)]
    assert tsup.usage_chain(rids[0])[0] == "replayed"
    assert tsup.usage_chain(rids[3])[:2] == ["cancelled", "retried"]
    cause = tsup.outages[0]["cause"]
    assert cause.startswith("injected_crash" if kind == "backend_crash"
                            else "stall")


def test_restart_budget_exhausted_as_jax(tiny):
    script = _script("backend_crash", count=3)
    jsup, tsup = _supervisors(tiny, max_restarts=2)
    _, jacc, _ = _drive(jsup, script)
    toks, tacc, sup = _drive(tsup, script)
    assert tacc == jacc
    assert tacc["permanent_failed"] and tacc["cancelled"] == 4
    assert tacc["restarts"] == 2 and tacc["lost"] == 0
    assert sup.engine is None and sup.step() is False
    with pytest.raises(Exception, match="permanently failed"):
        sup.submit([1, 2, 3], 4)


def test_paged_replay_equals_the_slab_run(tiny):
    """A crash under a paged engine replays into the same tokens."""
    _, tcfg, _, tparams = tiny
    script = _script("backend_crash")
    slab = _drive(_supervisors(tiny)[1], script)[0]
    sup = EngineSupervisor(lambda: PagedLLMEngine(tparams, tcfg,
                                                  device="cpu", **ENGINE),
                           **SUP)
    toks, acc, _ = _drive(sup, script)
    assert toks[:3] == slab[:3] and acc["restarts"] == 1
    assert acc["replay_verified"] == 3


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_permanent_failure_over_http(tiny):
    """Streams end with an error event and one [DONE]; readiness goes
    503 on the port's server and on the JAX server over the same
    LLMModel."""
    _, tcfg, _, tparams = tiny
    model = LLMModel("tiny", params=tparams, llama_config=tcfg,
                     device="cpu", sse_keepalive_s=0.05,
                     supervisor=dict(SUP, max_restarts=1), **ENGINE)
    server = CompletionServer(model).start()
    repo = ModelRepository()
    repo.register(model, load=False)
    jserver = ModelServer(repo).start()
    try:
        assert _get(server.url + "/v2/health/ready") == (200,
                                                         {"ready": True})
        res = {}

        def run():
            res["r"] = stream_completion(server.port, {
                "model": "tiny", "prompt": PROMPTS[1], "max_tokens": 30})

        th = threading.Thread(target=run)
        th.start()
        while not model.supervisor.accounting()["accepted"]:
            time.sleep(0.001)
        model.supervisor.arm_faults(FaultInjector(
            _script("backend_crash", count=2)))
        th.join(timeout=60)
        assert not th.is_alive()
        r = res["r"]
        assert r["status"] == 200 and r["done_count"] == 1
        assert len(r["errors"]) == 1
        assert "permanently failed" in r["errors"][0]
        for url in (server.url, jserver.url):
            assert _get(url + "/v2/health/ready") == (503, {"ready": False})
        health = _get(server.url + "/healthz")[1]
        assert health["supervisor"]["tiny"]["permanent_failed"]
        r = stream_completion(server.port, {"model": "tiny",
                                            "prompt": PROMPTS[0]})
        assert r["status"] == 503
    finally:
        jserver.stop()
        server.stop()
    model.unload()


def test_close_drops_the_engine_tensors(tiny):
    jcfg, tcfg, jparams, tparams = tiny
    sup = EngineSupervisor(lambda: LLMEngine(tparams, tcfg, device="cpu",
                                             prefix_cache=True, **ENGINE))
    eng = sup.engine
    rid = sup.submit(PROMPTS[1], 4)
    sup.run_until_idle()
    assert len(sup.result(rid)) == 4
    refs = [weakref.ref(t) for t in (eng.cache["k"], eng.lengths, eng._cnt)]
    sup.close()
    gc.collect()
    assert sup.engine is None and eng.cache is None and eng.params is None
    assert eng.kvcache is None and not eng._programs
    assert all(r() is None for r in refs)
    assert not [k for k, v in vars(eng).items()
                if isinstance(v, torch.Tensor)]
    # the JAX supervisor's close() drops the same state
    jsup = JaxSupervisor(lambda: JaxEngine(jparams, jcfg,
                                           prefer_native=False, **ENGINE))
    jeng = jsup.engine
    jsup.close()
    assert jsup.engine is None and jeng.cache is None and jeng.params is None


def test_port_only_surfaces_raise(tiny):
    _, tcfg, _, tparams = tiny

    def factory():
        return LLMEngine(tparams, tcfg, device="cpu", **ENGINE)

    class NotAnInjector:
        def start(self):
            pass

    with pytest.raises(TypeError, match="due_one_shots"):
        EngineSupervisor(factory).arm_faults(NotAnInjector())
    # adapters are ported (queue A3): one the engine has not loaded is
    # refused through the supervisor, with the JAX engine's message, and
    # nothing is journaled; tenant caps and shedding are ported: past its
    # queue cap a tenant's submit is refused, through the supervisor and
    # on the engine
    sup = EngineSupervisor(factory, shed_policy=ShedPolicy())
    assert sup._adapter_idx == {}
    with pytest.raises(ValueError, match="unknown adapter 'a0'"):
        sup.submit(PROMPTS[0], NEW, adapter="a0")
    sup.set_tenant_limits(1, 1)
    sup.submit(PROMPTS[0], NEW, tenant="a")
    with pytest.raises(TenantOverQuota):
        sup.submit(PROMPTS[1], NEW, tenant="a")
    with pytest.raises(TenantOverQuota):
        sup.engine.submit(PROMPTS[1], NEW, tenant="a")
    sup.run_until_idle()
    sup.set_tenant_limits(0, 0)
    # the decode chunk clamps to the captured menu once warmed up
    sup.engine.warmup()
    assert sup.set_decode_chunk(16) == 4 == sup.decode_chunk_max
    assert sup.set_decode_chunk(2) == 2 and sup.decode_chunk == 2
    assert sup.engine.mesh_info()["layout"] == "single"


def _down(sup):
    """Kill the engine by an injected crash and stop at the first step
    after it, with the engine down for the (long) backoff."""
    sup.backoff_base_s = sup.backoff_cap_s = 0.3
    sup.arm_faults(FaultInjector(_script("backend_crash")))
    sup.step()
    assert sup.engine is None and sup.degraded


def test_requests_while_the_engine_is_down(tiny):
    """Accepted while down (the journal is the queue), a request is
    submitted by the restart's replay pass; one cancelled while down ends
    cancelled. The same tokens and counts as JAX."""
    out = []
    for sup in _supervisors(tiny):
        old = sup.submit(PROMPTS[0], NEW)
        while not sup.partial_result(old):
            sup.step()
        _down(sup)
        new = sup.submit(PROMPTS[1], NEW)
        assert not sup.is_done(new)
        assert sup.cancel(old) and not sup.cancel(old)
        sup.run_until_idle()
        acc = sup.accounting()
        out.append((sup.result(new), sup.finish_reason(old),
                    {k: acc[k] for k in COUNTS}))
    assert out[1] == out[0]
    assert out[1][1] == "cancelled"
    assert out[1][2]["cancelled"] == 1 and out[1][2]["completed"] == 1


def test_a_replay_that_differs_counts_a_mismatch(tiny):
    """The delivered prefix is checked against the replay: a replacement
    engine that decodes otherwise (other weights here) counts a
    replay_mismatch, on both supervisors alike."""
    jcfg, tcfg, jparams, tparams = tiny
    jother = jax.tree.map(lambda x: x * 1.5, jparams)
    tother = interop.from_jax_params(jax.tree.map(np.asarray, jother), tcfg,
                                     device="cpu")
    built = {"jax": 0, "port": 0}

    def jfactory():
        built["jax"] += 1
        return JaxEngine(jparams if built["jax"] == 1 else jother, jcfg,
                         prefer_native=False, **ENGINE)

    def tfactory():
        built["port"] += 1
        return LLMEngine(tparams if built["port"] == 1 else tother, tcfg,
                         device="cpu", **ENGINE)

    out = []
    for sup in (JaxSupervisor(jfactory, **SUP),
                EngineSupervisor(tfactory, **SUP)):
        rids = [sup.submit(p, NEW) for p in PROMPTS[:2]]
        armed = False
        while sup.step():
            if not armed and all(len(sup.partial_result(r)) >= 3
                                 for r in rids):
                sup.arm_faults(FaultInjector(_script("backend_crash")))
                armed = True
        acc = sup.accounting()
        out.append(({k: acc[k] for k in COUNTS},
                    [sup.result(r) for r in rids]))
    assert out[1] == out[0]
    assert out[1][0]["replay_mismatch"] == 2
    assert out[1][0]["replay_verified"] == 0


def test_timing_and_cached_tokens_as_jax(tiny):
    """request_timing()'s keys, and the prefix tokens a finished request
    reused (kept by the journal after the engine released the request),
    as the JAX supervisor reports them."""
    jcfg, tcfg, jparams, tparams = tiny
    sups = (JaxSupervisor(lambda: JaxEngine(jparams, jcfg,
                                            prefer_native=False,
                                            prefix_cache=True, **ENGINE)),
            EngineSupervisor(lambda: LLMEngine(tparams, tcfg, device="cpu",
                                               prefix_cache=True, **ENGINE)))
    out = []
    for sup in sups:
        row = []
        for _ in range(2):
            rid = sup.submit(list(range(30, 50)), 4)
            sup.run_until_idle()
            tm = sup.request_timing(rid)
            row.append((sorted(tm), sup.cached_tokens(rid),
                        tm["prompt_len"], tm["prefill_tokens"],
                        tm["n_tokens"]))
        assert sup.prefix_cache_enabled and sup.kvcache is not None
        out.append(row)
    assert out[1] == out[0]
    assert out[1][1][1] == 16   # the second request hit the cache


def test_logprobs_survive_a_crash_as_jax(tiny):
    jcfg, tcfg, jparams, tparams = tiny
    kw = dict(ENGINE, logprobs_topk=2)
    sups = (JaxSupervisor(lambda: JaxEngine(jparams, jcfg,
                                            prefer_native=False, **kw),
                          **SUP),
            EngineSupervisor(lambda: LLMEngine(tparams, tcfg, device="cpu",
                                               **kw), **SUP))
    out = []
    for sup in sups:
        rid = sup.submit(PROMPTS[1], NEW)
        armed = False
        while sup.step():
            if not armed and len(sup.partial_result(rid)) >= 3:
                sup.arm_faults(FaultInjector(_script("backend_crash")))
                armed = True
        out.append((sup.result(rid), sup.result_logprobs(rid),
                    [sorted(d) for d in sup.result_top_logprobs(rid)]))
    (jt, jl, jtop), (tt, tl, ttop) = out
    assert tt == jt and ttop == jtop and len(tl) == len(tt) == NEW
    np.testing.assert_allclose(tl, jl, atol=1e-4, rtol=1e-4)


def test_passthroughs_while_down(tiny):
    """The engine-facing surface the runtime reads, with the engine
    alive and while it is down."""
    _, tsup = _supervisors(tiny)
    m = tsup.metrics()
    assert m["supervisor"]["permanent_failed"] is False
    assert m["prefill_tokens_computed"] == 0
    assert tsup.decode_chunk == tsup.decode_chunk_max == 4
    _down(tsup)
    assert tsup.metrics() == {"supervisor": tsup.accounting()}
    assert tsup.kvcache is None and not tsup.prefix_cache_enabled
    assert tsup.set_decode_chunk(2) == 2 and tsup.decode_chunk == 2
    tsup.run_until_idle()
    assert tsup.engine.decode_chunk == 2
