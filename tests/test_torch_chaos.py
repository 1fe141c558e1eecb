"""The port's chaos package against the JAX package's: each committed
fault script loads to the same config and materializes to the same bytes
(`script_sha256`), at its own window and rescaled; the injector answers
with the same due one-shots, active windows and fired log at every probe
instant; the supervisor arming a script or an injector; and a scenario
replayed with a committed script through the port's supervisor (the
runner arms it) recovers with nothing lost, shedding the low tenant only
while the engine is down."""

import dataclasses
import time

import pytest
import torch

from kubeflow_tpu import chaos as jchaos
from kubeflow_tpu_torch import chaos, loadgen
from kubeflow_tpu_torch.models import llama as tllama
from kubeflow_tpu_torch.serving.agent import EngineSupervisor
from kubeflow_tpu_torch.serving.llm import LLMEngine
from kubeflow_tpu_torch.serving.scheduler import ShedPolicy, TenantShed

torch.set_num_threads(2)

#: instants at which both injectors are asked, in order, as fractions of
#: the script's window: before, inside and after each committed fault
PROBES = (0.0, 0.167, 0.35, 0.367, 0.413, 0.433, 0.45, 0.467, 0.533, 0.6,
          0.667, 0.833, 0.997)


def _answers(mod, script):
    """Every query of the injector at every probe, as plain data."""
    inj = mod.FaultInjector(script)
    t0 = time.monotonic()
    out = []
    for frac in PROBES:
        # the injector reads time.monotonic() - t0: move the epoch back
        inj._t0 = t0 - frac * script.duration_s
        for kind in mod.FAULT_KINDS:
            due = [e.to_json() for e in inj.due_one_shots(kind)]
            act = inj.active(kind)
            out.append((frac, kind, due, act and act.to_json()))
            if act is not None and kind == "decode_stall" and frac > 0.46:
                inj.clear(act)
    log = [{k: v for k, v in f.items() if k != "fired_s"} for f in inj.log()]
    return out, log


@pytest.mark.parametrize("duration", [None, 4.0, 45.0],
                         ids=["own", "4s", "45s"])
@pytest.mark.parametrize("name", jchaos.FAULT_SCRIPTS)
def test_script_and_injector_as_jax(name, duration):
    """At the script's own window and rescaled onto another."""
    assert chaos.FAULT_SCRIPTS == jchaos.FAULT_SCRIPTS
    assert (chaos.load_fault_config(name).to_json()
            == jchaos.load_fault_config(name).to_json())
    s = chaos.load_fault_script(name, duration_s=duration)
    js = jchaos.load_fault_script(name, duration_s=duration)
    assert chaos.script_bytes(s) == jchaos.script_bytes(js)
    assert chaos.script_sha256(s) == jchaos.script_sha256(js)
    got, want = _answers(chaos, s), _answers(jchaos, js)
    assert got == want
    assert got[1], "no fault fired at any probe"


#: malformed fault specs, each as (kind, count, window, duration_s)
BAD_SPECS = (("meteor", 1, (0.3, 0.7), (0.0, 0.0)),
             ("backend_crash", 1, (0.7, 0.3), (0.0, 0.0)),
             ("backend_crash", 1, (0.3, 1.5), (0.0, 0.0)),
             ("decode_stall", 1, (0.3, 0.7), (2.0, 1.0)),
             ("backend_crash", 0, (0.3, 0.7), (0.0, 0.0)))


def _error(mod, cfg_kw, duration_s=None):
    """The error generating a script raises, as (type name, message)."""
    cfg = mod.FaultScriptConfig(**cfg_kw)
    try:
        mod.generate_fault_script(cfg, duration_s=duration_s)
    except ValueError as e:
        return type(e).__name__, str(e)
    return None


@pytest.mark.parametrize("level", ["spec", "window"])
def test_malformed_scripts_refused_as_jax(level):
    if level == "spec":
        cases = [(dict(seed=1, faults=(mod_spec,)), None)
                 for mod_spec in BAD_SPECS]
    else:
        cases = [(dict(seed=1, duration_s=0.0), None),
                 (dict(seed=1, duration_s=-3.0), None),
                 (dict(seed=1), 0.0)]
    for cfg_kw, dur in cases:
        got = _error(chaos, {k: (tuple(chaos.FaultSpec(*f) for f in v)
                                 if k == "faults" else v)
                             for k, v in cfg_kw.items()}, dur)
        want = _error(jchaos, {k: (tuple(jchaos.FaultSpec(*f) for f in v)
                                   if k == "faults" else v)
                               for k, v in cfg_kw.items()}, dur)
        assert got == want and got is not None, cfg_kw


def test_supervisor_arms_a_script_or_an_injector():
    """arm_faults wraps a FaultScript in a new FaultInjector and takes an
    injector as it is, as the JAX supervisor does, and refuses an object
    without the injector's methods. The supervisor consumes crashes and
    stalls only: a script of checkpoint faults fires nothing and the
    engine serves on."""
    cfg = dataclasses.replace(tllama.LlamaConfig.tiny(), dtype=torch.float32)
    params = tllama.init(cfg, seed=0, device="cpu")
    sup = EngineSupervisor(lambda: LLMEngine(
        params, cfg, device="cpu", n_slots=2, max_len=32, buckets=(8,)))
    script = chaos.generate_fault_script(chaos.FaultScriptConfig(
        seed=3, duration_s=1.0,
        faults=(chaos.FaultSpec("ckpt_io_fail", 1, (0.0, 0.0)),)))
    sup.arm_faults(script)
    assert type(sup.injector) is chaos.FaultInjector
    assert sup.injector.script is script
    inj = chaos.FaultInjector(script)
    assert sup.arm_faults(inj).injector is inj
    with pytest.raises(TypeError, match="due_one_shots"):
        sup.arm_faults(object())
    assert sup.injector is inj
    rid = sup.submit([3, 17, 101], 4)
    sup.run_until_idle()
    assert len(sup.result(rid)) == 4
    assert inj.log() == [] and sup.accounting()["restarts"] == 0


def test_scenario_with_crash_midstream_through_the_supervisor():
    """The runner arms the committed script on the supervisor, which
    restarts the engine once, loses nothing and sheds t1 (ranked below
    the threshold) only while the engine is down; every greedy request
    it accepted gets its uncrashed tokens."""
    cfg = dataclasses.replace(tllama.LlamaConfig.tiny(), dtype=torch.float32)
    params = tllama.init(cfg, seed=0, device="cpu")
    engine_kw = dict(n_slots=2, max_len=48, buckets=(8, 16), decode_chunk=4)

    def factory():
        eng = LLMEngine(params, cfg, device="cpu", **engine_kw)
        step = eng.step

        def slow_step():   # a tiny CPU engine outruns the window
            time.sleep(0.004)
            return step()

        eng.step = slow_step
        return eng

    sup = EngineSupervisor(factory, backoff_base_s=1.0, backoff_cap_s=1.0,
                           shed_policy=ShedPolicy(priorities=(("t0", 1),)))
    scenario = loadgen.miniature(
        loadgen.load_scenario("steady", n_tenants=2), vocab=512,
        max_prompt_len=14, duration_s=3.0, rate_rps=12.0)
    trace = loadgen.generate_trace(scenario.trace)
    shed_at = []
    submit = sup.submit

    def submit_watched(*a, **kw):
        try:
            return submit(*a, **kw)
        except TenantShed:
            shed_at.append((kw.get("tenant"), sup.degraded))
            raise

    sup.submit = submit_watched
    tokens = {}
    release = sup.release

    def release_kept(rid):
        tokens[tuple(sup._journal[rid].prompt)] = sup.result(rid)
        release(rid)

    sup.release = release_kept
    out = loadgen.run_scenario(sup, scenario,
                               fault_script="crash_midstream",
                               max_wall_s=120.0)
    assert not out["timed_out"]
    acc = out["chaos"]["accounting"]
    assert acc["restarts"] == 1 and acc["lost"] == 0
    assert out["chaos"]["script_sha256"] == chaos.script_sha256(
        chaos.load_fault_script("crash_midstream", duration_s=3.0))
    assert [e["kind"] for e in out["chaos"]["events_fired"]] == [
        "backend_crash"]
    assert shed_at and all(t == "t1" and down for t, down in shed_at)
    assert acc["shed"] == len(shed_at) == out["aggregate"]["rejected"]
    assert out["per_tenant"]["t0"]["rejected"] == 0
    eng = LLMEngine(params, cfg, device="cpu", **engine_kw)
    accepted = [r for r in trace.requests if tuple(r.prompt) in tokens]
    assert len(accepted) == len(trace.requests) - len(shed_at)
    for r in accepted:
        assert tokens[tuple(r.prompt)] == eng.generate(list(r.prompt),
                                                       r.max_new_tokens)
