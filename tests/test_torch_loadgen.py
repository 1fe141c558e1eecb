"""The port's loadgen package against the JAX package's: every committed
scenario loads to the same config and generates the same trace bytes
(`trace_sha256`), at full scale and as a miniature, and the hashes
chip_smoke (e7) pins are these; the SLO summary and the decode-chunk
controller compute the same numbers; `run_scenario` of a miniature
`steady` and of `multi_tenant_lora` (adapters=[], its caps on) over the
port's tiny engine gives the JAX runner's per-request tokens and
per-tenant completed, rejected and cancelled counts over the JAX engine;
a trace that routes to adapters the engine lacks fails before replay; and
the port's SSE client replays a trace through the port's server, one
[DONE] a stream, with a tenant refusal answered 503."""

import dataclasses
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from kubeflow_tpu import loadgen as jloadgen
from kubeflow_tpu.loadgen import control as jcontrol
from kubeflow_tpu.loadgen import slo as jslo
from kubeflow_tpu.models import llama as jllama
from kubeflow_tpu.serving.llm import LLMEngine as JaxEngine
from kubeflow_tpu_torch import loadgen
from kubeflow_tpu_torch.loadgen import control, slo
from kubeflow_tpu_torch.models import interop
from kubeflow_tpu_torch.models import llama as tllama
from kubeflow_tpu_torch.serving import scheduler as tsched
from kubeflow_tpu_torch.serving.llm import LLMEngine
from kubeflow_tpu_torch.serving.server import CompletionServer

torch.set_num_threads(2)

ENGINE = dict(n_slots=2, max_len=48, buckets=(8, 16), decode_chunk=4)
#: the traces chip_smoke (e7) replays: the committed configs with only
#: the overrides (e7) gives, and their sha256
E7_TRACES = {
    "steady": ("steady", {},
               "2d3f20c1952fddd2e7b19e2591c60d39"
               "bc26234995496f4b841442b0b64cae0d"),
    "steady_two_tenants": ("steady", {"n_tenants": 2},
                           "8ca0673d417454beea39a3c36d152b3f"
                           "a3a5b481382652f6a35940146d518310"),
    "multi_tenant_lora": ("multi_tenant_lora", {},
                          "4d61174032a28b3cbc00ca5cf49c9347"
                          "01da41e608d89723d8aa9cb92ca351cf"),
}


@pytest.fixture(scope="module")
def tiny():
    jcfg = dataclasses.replace(jllama.LlamaConfig.tiny(), dtype=jnp.float32)
    tcfg = dataclasses.replace(tllama.LlamaConfig.tiny(),
                               dtype=torch.float32)
    jparams = jllama.init(jax.random.key(0), jcfg)
    tparams = interop.from_jax_params(jax.tree.map(np.asarray, jparams),
                                      tcfg, device="cpu")
    return jcfg, tcfg, jparams, tparams


@pytest.mark.parametrize("name", jloadgen.SCENARIOS)
def test_scenario_loads_and_hashes_as_jax(name):
    assert loadgen.SCENARIOS == jloadgen.SCENARIOS
    s, js = loadgen.load_scenario(name), jloadgen.load_scenario(name)
    assert s.to_json() == js.to_json()
    assert (loadgen.trace_bytes(loadgen.generate_trace(s.trace))
            == jloadgen.trace_bytes(jloadgen.generate_trace(js.trace)))
    mini = loadgen.miniature(s, vocab=512, max_prompt_len=14)
    jmini = jloadgen.miniature(js, vocab=512, max_prompt_len=14)
    assert mini.to_json() == jmini.to_json()
    trace = loadgen.generate_trace(mini.trace)
    assert trace.requests
    assert (loadgen.trace_sha256(trace)
            == jloadgen.trace_sha256(jloadgen.generate_trace(jmini.trace)))


def test_e7_trace_hashes_are_pinned():
    for key, (name, over, sha) in E7_TRACES.items():
        t = loadgen.generate_trace(loadgen.load_scenario(name, **over).trace)
        jt = jloadgen.generate_trace(
            jloadgen.load_scenario(name, **over).trace)
        assert loadgen.trace_sha256(t) == jloadgen.trace_sha256(jt) == sha
        assert chip_smoke.E7_TRACES[key] == (name, over, sha)
    # the second tenant changes only the tenant labels: the prompts,
    # budgets and arrivals of (e7.c) are (e7.a)'s
    a, c = (loadgen.generate_trace(loadgen.load_scenario(
        "steady", **E7_TRACES[k][1]).trace).requests
            for k in ("steady", "steady_two_tenants"))
    assert [(r.prompt, r.max_new_tokens, r.arrival_s) for r in a] == [
        (r.prompt, r.max_new_tokens, r.arrival_s) for r in c]
    assert {r.tenant for r in c} == {"t0", "t1"}


def test_slo_math_and_controller_as_jax():
    rng = random.Random(5)
    recs = []
    for i in range(60):
        reason = rng.choice(("stop", "length", "cancelled", "rejected",
                             "unsubmitted"))
        kw = {}
        if reason != "rejected":
            first = i * 0.1 + rng.uniform(0.01, 3.0)
            kw = dict(submit_s=i * 0.1, first_token_s=first,
                      finish_s=first + rng.uniform(0.0, 2.0),
                      n_tokens=rng.randint(0, 30))
        recs.append((i, f"t{rng.randint(0, 3)}", i * 0.1, rng.randint(1, 30),
                     dict(kw, finish_reason=reason,
                          client_cancelled=reason == "cancelled")))
    kw = dict(ttft_slo_ms=1500.0, tpot_slo_ms=60.0, duration_s=9.5)
    got = slo.summarize([slo.RequestRecord(*r[:4], **r[4]) for r in recs],
                        **kw)
    want = jslo.summarize([jslo.RequestRecord(*r[:4], **r[4])
                           for r in recs], **kw)
    assert got == want and len(got["per_tenant"]) == 4
    for xs in ([1.0, 1.0], [1.0, 0.0, 0.0], [], [0.0], [0.3, 0.9, 0.5]):
        assert slo.jain_index(xs) == jslo.jain_index(xs)
    for target in (100.0, 250.0, 500.0):
        for cap in (2, 4, 8):
            assert (control.pick_decode_chunk(target, max_chunk=cap)
                    == jcontrol.pick_decode_chunk(target, max_chunk=cap))

    class Chunked:
        def __init__(self):
            self.decode_chunk = self.decode_chunk_max = 8

        def set_decode_chunk(self, c):
            self.decode_chunk = max(1, min(int(c), self.decode_chunk_max))
            return self.decode_chunk

    trajectories = []
    for mod in (control, jcontrol):
        c, eng = mod.SLOController(100.0, interval_s=1.0), Chunked()
        for t, ttft in enumerate((400, 400, 300, 10, 10, 10, 10, 500)):
            c.observe(ttft)
            c.maybe_adjust(eng, float(t) * 1.5)
        trajectories.append(c.trajectory)
    assert trajectories[0] == trajectories[1] and trajectories[0]


class _Tap:
    """An engine as the runner sees it, keeping each request's tokens
    (by prompt) when the runner releases it."""

    def __init__(self, engine):
        self._engine = engine
        self._prompt: dict[int, tuple] = {}
        self.tokens: dict[tuple, list[int]] = {}

    def __getattr__(self, name):
        return getattr(self._engine, name)

    def submit(self, prompt, *a, **kw):
        rid = self._engine.submit(prompt, *a, **kw)
        self._prompt[rid] = tuple(prompt)
        return rid

    def release(self, rid):
        self.tokens[self._prompt.pop(rid)] = self._engine.result(rid)
        self._engine.release(rid)


def _replay(run_scenario, engine, scenario, generate_trace):
    tap = _Tap(engine)
    out = run_scenario(tap, scenario, max_wall_s=600.0)
    assert not out["timed_out"]
    trace = generate_trace(scenario.trace)
    tokens = [tap.tokens.get(tuple(r.prompt)) for r in trace.requests]
    counts = {t: (s["offered"], s["completed"], s["rejected"],
                  s["client_cancelled"])
              for t, s in out["per_tenant"].items()}
    return out["trace_sha256"], tokens, counts


@pytest.mark.parametrize("name,over,n_tenants", [
    ("steady", {}, 1),
    ("multi_tenant_lora", {"adapters": []}, 6)])
def test_run_scenario_as_jax(tiny, name, over, n_tenants):
    jcfg, tcfg, jparams, tparams = tiny
    kw = dict(vocab=512, max_prompt_len=14, duration_s=2.0, rate_rps=6.0)
    s = loadgen.miniature(loadgen.load_scenario(name, **over), **kw)
    js = jloadgen.miniature(jloadgen.load_scenario(name, **over), **kw)
    if name == "multi_tenant_lora":
        assert (s.tenant_max_active, s.tenant_max_queued) == (2, 32)
    want = _replay(jloadgen.run_scenario,
                   JaxEngine(jparams, jcfg, prefer_native=False, **ENGINE),
                   js, jloadgen.generate_trace)
    eng = LLMEngine(tparams, tcfg, device="cpu", **ENGINE)
    got = _replay(loadgen.run_scenario, eng, s, loadgen.generate_trace)
    assert got == want
    sha, tokens, counts = got
    assert all(t is not None and len(t) > 0 for t in tokens)
    assert len(counts) <= n_tenants
    assert sum(c[0] for c in counts.values()) == len(tokens)
    # run_scenario never leaks its caps into the next run
    eng.submit([1, 2, 3], 2, tenant="t0")
    for _ in range(40):
        eng.submit([1, 2, 3], 2, tenant="t0")
    eng.run_until_idle()


def test_trace_with_adapters_fails_before_replay(tiny):
    _, tcfg, _, tparams = tiny
    eng = LLMEngine(tparams, tcfg, device="cpu", **ENGINE)
    s = loadgen.miniature(loadgen.load_scenario("multi_tenant_lora"),
                          vocab=512, max_prompt_len=14)
    with pytest.raises(ValueError, match="adapters"):
        loadgen.run_trace(eng, loadgen.generate_trace(s.trace))
    assert eng.metrics()["queued"] == 0 and not eng._results


class _IdTokenizer:
    def encode(self, text):
        return list(text.encode("utf-8"))

    def decode(self, ids):
        return " ".join(str(i) for i in ids)


def test_sse_client_replays_a_trace_through_the_server(tiny):
    _, tcfg, _, tparams = tiny
    s = loadgen.miniature(loadgen.load_scenario("steady", n_tenants=2),
                          vocab=512, max_prompt_len=14, duration_s=1.0,
                          rate_rps=8.0)
    trace = loadgen.generate_trace(s.trace)
    server = CompletionServer.from_config(
        tparams, tcfg, dict(ENGINE, buckets=list(ENGINE["buckets"])),
        device="cpu", model="llm", tokenizer=_IdTokenizer()).start()
    try:
        out = loadgen.run_trace_http(server.port, trace, model="llm",
                                     timeout_s=120.0)
    finally:
        server.stop()
    assert not out["timed_out"]
    eng = LLMEngine(tparams, tcfg, device="cpu", **ENGINE)
    for r in trace.requests:
        st = out["streams"][r.index]
        assert st["status"] == 200 and st["done_count"] == 1
        assert st["usage_count"] == 1 and not st["errors"]
        assert st["t_first_token_s"] is not None
        assert st["token_ids"] == eng.generate(list(r.prompt),
                                               r.max_new_tokens)
    agg = out["summary"]["aggregate"]
    assert agg["completed"] == agg["n_requests"] == len(trace.requests)
    assert set(out["summary"]["per_tenant"]) == {"t0", "t1"}
    # a tenant refusal is the 503 the JAX server gives for QueueFull
    for err in (tsched.TenantOverQuota("x"), tsched.TenantShed("x"),
                tsched.QueueFull("x")):
        assert CompletionServer._completion_error(err)[0] == 503
