"""Scenario runner (counterpart of kubeflow_tpu/loadgen/runner.py):
replay a trace against a REAL engine or its supervisor.

Open-loop replay through the ordinary `LLMEngine.submit` path — the same
code live HTTP traffic takes — honoring scheduled arrival instants,
tenant routing, adapter routing and client cancellations. A trace that
routes to an adapter the engine has not loaded fails before replay. The
runner is the only loadgen piece that touches wall clocks; everything it
produces reduces through `loadgen.slo` (pure math) into the summary.

Conventions: arrivals coming due while a blocking engine.step() runs
are submitted late but keep their SCHEDULED arrival as the TTFT epoch —
dropping that wait would bias the percentiles low. Cancellation fires
`cancel_after_s` after the scheduled arrival; a request that finished
first simply keeps its result (the client got the answer before
leaving), so `client_cancelled` marks only requests the cancel actually
cut.
"""

from __future__ import annotations

import time
from typing import Any

from kubeflow_tpu_torch.loadgen.slo import RequestRecord, summarize
from kubeflow_tpu_torch.loadgen.trace import (Trace, generate_trace,
                                              trace_sha256)


def run_trace(engine, trace: Trace, *, controller=None,
              max_wall_s: float | None = None) -> dict[str, Any]:
    """Replay `trace` to completion; returns {"records", "summary",
    "wall_s", "timed_out"}. `controller` (loadgen.control.SLOController)
    gets completed-request TTFTs and a control tick each loop."""
    from kubeflow_tpu_torch.serving.scheduler import (PromptTooLong,
                                                      QueueFull)

    cfg = trace.config
    if max_wall_s is None:
        # generous: the trace window plus time to drain a saturated queue
        max_wall_s = cfg.duration_s * 4.0 + 60.0
    # fail BEFORE replay, not mid-loop: every adapter the trace routes to
    # must be loaded in this engine
    need = {r.adapter for r in trace.requests if r.adapter is not None}
    have = set(getattr(engine, "_adapter_idx", {}) or {})
    if need - have:
        raise ValueError(
            f"trace routes to adapters {sorted(need - have)} the engine "
            f"does not serve (loaded: {sorted(have)})")
    reqs = trace.requests
    records: dict[int, RequestRecord] = {}
    rid_of: dict[int, int] = {}         # trace index -> engine rid
    cancels: list[tuple[float, int]] = []   # (due_rel_s, trace index)
    cancelled_by_client: set[int] = set()
    next_arrival = 0
    t0 = time.monotonic()
    timed_out = False

    def now_rel() -> float:
        return time.monotonic() - t0

    def finalize(idx: int) -> None:
        """Read timing BEFORE release, normalize to run-relative times."""
        r = reqs[idx]
        rid = rid_of.pop(idx)
        tm = engine.request_timing(rid)
        records[idx] = RequestRecord(
            index=idx, tenant=r.tenant, arrival_s=r.arrival_s,
            max_new_tokens=r.max_new_tokens, adapter=r.adapter,
            submit_s=(tm["submit_s"] - t0
                      if tm["submit_s"] is not None else None),
            first_token_s=(tm["first_token_s"] - t0
                           if tm["first_token_s"] is not None else None),
            finish_s=(tm["finish_s"] - t0
                      if tm["finish_s"] is not None else None),
            n_tokens=tm["n_tokens"],
            finish_reason=engine.finish_reason(rid),
            client_cancelled=idx in cancelled_by_client)
        if controller is not None:
            ttft = records[idx].ttft_ms()
            if ttft is not None:
                controller.observe(ttft)
        engine.release(rid)

    while len(records) < len(reqs):
        now = now_rel()
        if now > max_wall_s:
            timed_out = True
            break
        # submit due arrivals (scheduled epoch kept by the record)
        while next_arrival < len(reqs) \
                and reqs[next_arrival].arrival_s <= now:
            r = reqs[next_arrival]
            try:
                rid = engine.submit(list(r.prompt), r.max_new_tokens,
                                    adapter=r.adapter, tenant=r.tenant)
                rid_of[r.index] = rid
                if r.cancel_after_s is not None:
                    cancels.append((r.arrival_s + r.cancel_after_s,
                                    r.index))
            except (QueueFull, PromptTooLong):
                # admission control / overload: an immediate, recorded
                # rejection (finish_reason "rejected")
                records[r.index] = RequestRecord(
                    index=r.index, tenant=r.tenant,
                    arrival_s=r.arrival_s,
                    max_new_tokens=r.max_new_tokens, adapter=r.adapter)
            next_arrival += 1
        # client disconnects that came due
        if cancels:
            due = [i for t, i in cancels if t <= now]
            cancels = [(t, i) for t, i in cancels if t > now]
            for idx in due:
                rid = rid_of.get(idx)
                if rid is not None and not engine.is_done(rid):
                    if engine.cancel(rid):
                        cancelled_by_client.add(idx)
        worked = engine.step()
        # collect everything that finished
        for idx in [i for i, rid in rid_of.items()
                    if engine.is_done(rid)]:
            finalize(idx)
        if controller is not None:
            controller.maybe_adjust(engine, now_rel())
        if not worked:
            # idle: sleep to the next scheduled event instead of spinning
            horizon = [t0 + max_wall_s]
            if next_arrival < len(reqs):
                horizon.append(t0 + reqs[next_arrival].arrival_s)
            if cancels:
                horizon.append(t0 + min(t for t, _ in cancels))
            if rid_of:
                horizon.append(time.monotonic() + 0.001)
            time.sleep(max(0.0, min(horizon) - time.monotonic()))
    if timed_out:
        # cancel everything outstanding, drain once, record honestly
        for idx, rid in list(rid_of.items()):
            engine.cancel(rid)
        engine.run_until_idle()
        for idx in list(rid_of):
            finalize(idx)
        for r in reqs:
            # arrivals the wall ran out before: "unsubmitted", NOT
            # "rejected" — the engine never saw them, and the committed
            # rejected column must mean admission control fired
            records.setdefault(r.index, RequestRecord(
                index=r.index, tenant=r.tenant, arrival_s=r.arrival_s,
                max_new_tokens=r.max_new_tokens, adapter=r.adapter,
                finish_reason="unsubmitted"))
    wall = now_rel()
    recs = [records[i] for i in sorted(records)]
    out = {
        "records": recs,
        "summary": summarize(recs, ttft_slo_ms=cfg.ttft_slo_ms,
                             tpot_slo_ms=cfg.tpot_slo_ms,
                             duration_s=max(wall, 1e-9)),
        "wall_s": round(wall, 3),
        "timed_out": timed_out,
    }
    return out


def run_scenario(engine, scenario, *, max_wall_s: float | None = None,
                 fault_script: str | None = None) -> dict[str, Any]:
    """Generate a scenario's trace, apply its fairness/control knobs, and
    replay it. Returns the record shape the JAX runner returns: config
    echo + trace hash + aggregate + per-tenant SLO table (+ the SLO
    controller's chunk trajectory).

    A fault script (the scenario's `fault_script`, or the override
    argument) turns the replay into a chaos run: the script is
    materialized onto the trace's window, armed on the engine's
    supervisor (the engine must be an `EngineSupervisor` — a bare engine
    has no recovery story to inject faults into), and the supervisor's
    zero-lost accounting + fired-event log ride the committed record
    under `chaos`."""
    from kubeflow_tpu_torch.loadgen.control import SLOController

    trace = generate_trace(scenario.trace)
    script_name = fault_script or scenario.fault_script
    script = None
    if script_name:
        from kubeflow_tpu_torch.chaos import (load_fault_script,
                                              script_sha256)

        if not hasattr(engine, "arm_faults"):
            raise ValueError(
                f"scenario carries fault script {script_name!r} but the "
                "engine is not supervised — wrap it in "
                "serving.agent.EngineSupervisor")
        script = load_fault_script(script_name,
                                   duration_s=scenario.trace.duration_s)
        engine.arm_faults(script)
    engine.set_tenant_limits(scenario.tenant_max_active,
                             scenario.tenant_max_queued)
    controller = None
    if scenario.slo_chase:
        controller = SLOController(scenario.ttft_target_ms,
                                   interval_s=scenario.control_interval_s)
    try:
        res = run_trace(engine, trace, controller=controller,
                        max_wall_s=max_wall_s)
    finally:
        engine.set_tenant_limits(0, 0)   # never leak caps to the next run
    out = {
        "scenario": scenario.name,
        "trace_sha256": trace_sha256(trace),
        "n_requests": len(trace.requests),
        "seed": scenario.trace.seed,
        "wall_s": res["wall_s"],
        "timed_out": res["timed_out"],
        **res["summary"],
    }
    if script is not None:
        out["chaos"] = {
            "fault_script": script_name,
            "script_sha256": script_sha256(script),
            "events_scheduled": [e.to_json() for e in script.events],
            "events_fired": engine.injector.log(),
            "accounting": engine.accounting(),
        }
    if controller is not None:
        out["slo_chase"] = {
            "ttft_target_ms": scenario.ttft_target_ms,
            "final_chunk": engine.decode_chunk,
            "trajectory": controller.trajectory,
        }
    return out
