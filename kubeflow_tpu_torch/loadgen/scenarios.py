"""Named, committed traffic scenarios.

Each scenario is a JSON file in `loadgen/configs/` — config-as-data so a
scenario is reviewable in a diff and a record can echo exactly what
ran; the port's `configs/` are the JAX package's files, byte for byte.
`load_scenario` materializes one; `miniature` rescales it onto
a tiny engine (the CPU tests) while keeping the scenario's SHAPE — burst
modulation, tenant/adapter skew, cancellation fraction — intact.

The committed fleet (full-scale values sized for a small serving engine:
buckets 64/128/256, 8 slots):

- steady            — plain Poisson, heterogeneous lengths, one tenant:
                      the baseline every other scenario is read against.
- diurnal_burst     — modulated Poisson (amplitude 0.9): peak-rate
                      queueing vs trough recovery in one window.
- multi_tenant_lora — 6 tenants (Zipf-skewed) over a 4-adapter S-LoRA
                      fleet, per-tenant share caps + admission quota:
                      the fairness/admission scenario.
- cancellation_storm— half the clients disconnect mid-generation:
                      goodput-under-cancellation and prompt slot reuse.
- slo_chase         — the ttft_target_ms knob live: the SLO controller
                      re-picks decode_chunk under load and commits its
                      trajectory.
- long_tail_mix     — heavy-tailed (bounded-Pareto) prompt/output
                      lengths: the paged-KV A/B scenario — slab HBM is
                      sized for the tail, paged admission turns the
                      stranded difference into concurrency.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any

from kubeflow_tpu_torch.loadgen.trace import TraceConfig

CONFIG_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "configs")


@dataclasses.dataclass(frozen=True)
class Scenario:
    name: str
    description: str
    trace: TraceConfig
    tenant_max_active: int = 0     # engine.set_tenant_limits knobs
    tenant_max_queued: int = 0
    slo_chase: bool = False
    ttft_target_ms: float = 300.0
    control_interval_s: float = 5.0
    #: committed chaos fault script (chaos/configs/) replayed against the
    #: serving plane alongside the trace; requires a supervised engine
    fault_script: str | None = None

    def to_json(self) -> dict[str, Any]:
        d = dataclasses.asdict(self)
        d["trace"] = self.trace.to_json()
        return d

    def replace(self, **kw) -> "Scenario":
        return dataclasses.replace(self, **kw)


def _names() -> list[str]:
    return sorted(f[:-5] for f in os.listdir(CONFIG_DIR)
                  if f.endswith(".json"))


#: the committed scenario fleet (derived from configs/, so the registry
#: can never drift from the files)
SCENARIOS: tuple[str, ...] = tuple(_names())


def load_scenario(name: str, **trace_overrides: Any) -> Scenario:
    """Load a committed scenario; `trace_overrides` replace TraceConfig
    fields (e.g. vocab=..., seed=...) without touching the file."""
    path = os.path.join(CONFIG_DIR, f"{name}.json")
    if not os.path.exists(path):
        raise KeyError(f"unknown scenario {name!r}; "
                       f"committed: {list(SCENARIOS)}")
    with open(path) as f:
        d = json.load(f)
    trace = TraceConfig.from_json(d["trace"])
    if trace_overrides:
        trace = trace.replace(**trace_overrides)
    return Scenario(
        name=d["name"], description=d.get("description", ""),
        trace=trace,
        tenant_max_active=int(d.get("tenant_max_active", 0)),
        tenant_max_queued=int(d.get("tenant_max_queued", 0)),
        slo_chase=bool(d.get("slo_chase", False)),
        ttft_target_ms=float(d.get("ttft_target_ms", 300.0)),
        control_interval_s=float(d.get("control_interval_s", 5.0)),
        fault_script=d.get("fault_script"))


def miniature(scenario: Scenario, *, vocab: int, max_prompt_len: int,
              duration_s: float = 4.0, rate_rps: float | None = None,
              max_output: int = 8) -> Scenario:
    """Shrink a scenario onto a tiny engine while preserving its shape:
    prompt-length mixture rescaled proportionally into
    [1, max_prompt_len], output budgets clamped, window shortened, burst
    period scaled with the window so the trace still sees full cycles.
    Used by the CPU tests."""
    t = scenario.trace
    if t.n_templates:
        # shared_prefix family: the effective longest prompt is the
        # longest template plus every turn's user chunk — that is what
        # must fit max_prompt_len, and template/turn lengths scale
        # together so the share-vs-fresh ratio (what the cache-hit
        # numbers mean) survives the shrink
        orig_max = (t.template_len[1]
                    + t.turns[1] * t.turn_user_len[1])
    elif t.long_tail:
        orig_max = t.tail_prompt_len[1]
    else:
        orig_max = max(hi for _, hi, _ in t.prompt_len_mix)
    scale = max_prompt_len / orig_max
    mix = tuple((max(1, int(lo * scale)),
                 max(1, int(hi * scale)), w)
                for lo, hi, w in t.prompt_len_mix)
    dur_scale = duration_s / t.duration_s
    mini = t.replace(
        duration_s=duration_s,
        base_rate_rps=rate_rps if rate_rps is not None
        else t.base_rate_rps,
        burst_period_s=max(0.5, t.burst_period_s * dur_scale),
        prompt_len_mix=mix,
        output_len=(min(t.output_len[0], max_output),
                    min(t.output_len[1], max_output)),
        vocab=vocab,
        cancel_after_s=(t.cancel_after_s[0] * dur_scale,
                        max(t.cancel_after_s[0] * dur_scale,
                            t.cancel_after_s[1] * dur_scale)),
    )
    if t.n_templates:
        mini = mini.replace(
            template_len=(max(1, int(t.template_len[0] * scale)),
                          max(1, int(t.template_len[1] * scale))),
            turn_user_len=(max(1, int(t.turn_user_len[0] * scale)),
                           max(1, int(t.turn_user_len[1] * scale))),
            turn_gap_s=(t.turn_gap_s[0] * dur_scale,
                        max(t.turn_gap_s[0] * dur_scale,
                            t.turn_gap_s[1] * dur_scale)),
        )
    if t.long_tail:
        # the Pareto SHAPE (alpha) survives untouched — only the
        # bounded support rescales, so the short/long imbalance the
        # scenario exists to exercise is intact on the tiny engine
        mini = mini.replace(
            tail_prompt_len=(max(1, int(t.tail_prompt_len[0] * scale)),
                             max(1, int(t.tail_prompt_len[1] * scale))),
            tail_output_len=(min(t.tail_output_len[0], max_output),
                             min(t.tail_output_len[1], max_output)),
        )
    return scenario.replace(trace=mini,
                            control_interval_s=max(
                                0.5, scenario.control_interval_s
                                * dur_scale))
