"""The serving half of the stage split (counterpart of the inference half
of kubeflow_tpu/parallel/pipeline.py): geometry, placement and accounting
for stage-sharded serving (`serving/multichip.py` `StageShardedEngine`).

A model of L layers is cut into S contiguous layer slabs; stage s holds
its slab of the stacked [L, ...] weights and that slab's KV cache [L_s,
slots, max_len, kv, hd], so neither the weights nor the cache has to
exist whole on one device. A decode step splits the slots into M
microbatches and runs them through the stages on the GPipe wavefront: at
tick t stage s works microbatch t - s, so stage s decodes microbatch m
while stage s - 1 decodes microbatch m + 1. The bubble, the share of
stage-ticks with nothing to do, is (S - 1) / (M + S - 1) per step.

Placement (`InferenceStagePlan`): stage s runs on devices[s] when at
least S distinct devices are given (by default every visible CUDA device,
or the engine's device); otherwise every stage runs on the engine's
device ("virtual" staging, the JAX engine's on one device): the same
stage programs and the same schedule, without the copies between
devices.

Not here: the GPipe training schedule (`gpipe`, `microbatch`,
`pipelined_llama_loss`) is ROADMAP.md A6c-ii; tensor-parallel stages and
`collective_matmul` are A6c-iii. The JAX module's
`shard_map_overlap_supported` probes its own compiler and has no
counterpart.
"""

from __future__ import annotations

import os
import time
from typing import Any, Sequence

import torch

#: the environment override of the serving stage schedule: "overlapped"
#: (or "1", "on") or "sync" (or "0", "off"); an explicit engine argument
#: wins over it, and it wins over the default, "sync"
SCHEDULE_ENV = "KTPU_STAGE_OVERLAP"


def resolve_schedule(configured: str | None = None) -> str:
    """The stage schedule: the explicit config ("sync" or "overlapped"),
    else KTPU_STAGE_OVERLAP, else "sync"."""
    if configured is not None:
        if configured not in ("sync", "overlapped"):
            raise ValueError(
                f"unknown stage schedule {configured!r} "
                "(want 'sync' or 'overlapped')")
        return configured
    env = os.environ.get(SCHEDULE_ENV, "").strip().lower()
    if env in ("overlapped", "1", "on"):
        return "overlapped"
    return "sync"


def stage_bounds(n_layers: int, n_stages: int) -> list[tuple[int, int]]:
    """Contiguous [start, end) layer slabs per stage; an uneven split puts
    the remainder on the earliest stages (the last stage also runs the
    lm_head)."""
    if not 1 <= n_stages <= n_layers:
        raise ValueError(
            f"n_stages must be 1..n_layers ({n_layers}), got {n_stages}")
    base, extra = divmod(n_layers, n_stages)
    bounds, start = [], 0
    for s in range(n_stages):
        size = base + (1 if s < extra else 0)
        bounds.append((start, start + size))
        start += size
    return bounds


def microbatch_ranges(n_slots: int, n_stages: int) -> list[tuple[int, int]]:
    """The decode microbatches as contiguous (start, size) slot ranges:
    one per stage, at least one slot each (fewer microbatches than stages
    when the slots are fewer); the remainder on the earliest."""
    m = min(max(1, n_stages), n_slots)
    base, extra = divmod(n_slots, m)
    out, start = [], 0
    for i in range(m):
        size = base + (1 if i < extra else 0)
        out.append((start, size))
        start += size
    return out


def wavefront(n_microbatches: int, n_stages: int):
    """The GPipe ticks as (tick, stage, microbatch) in dispatch order: at
    tick t, stage s works microbatch t - s."""
    for t in range(n_microbatches + n_stages - 1):
        for s in range(n_stages):
            m = t - s
            if 0 <= m < n_microbatches:
                yield t, s, m


def _slice_layers(tree: Any, lo: int, hi: int) -> Any:
    if isinstance(tree, dict):
        return {k: _slice_layers(v, lo, hi) for k, v in tree.items()}
    return tree[lo:hi]


def split_stage_params(params: dict, bounds: Sequence[tuple[int, int]]
                       ) -> list[dict]:
    """init()-shaped llama params -> per-stage slabs: each stage's
    contiguous layers, stage 0 also `embed`, the last stage `final_norm`
    and `lm_head`. The layer leaves are views on the stacked [L, ...]
    tensors ({"q", "s"} subtrees of int8 weights alike), so the slabs
    hold no copy of the weights."""
    n = len(bounds)
    slabs: list[dict] = []
    for s, (lo, hi) in enumerate(bounds):
        slab: dict = {"layers": _slice_layers(params["layers"], lo, hi)}
        if s == 0:
            slab["embed"] = params["embed"]
        if s == n - 1:
            slab["final_norm"] = params["final_norm"]
            slab["lm_head"] = params["lm_head"]
        slabs.append(slab)
    return slabs


class StagePerf:
    """Per-stage busy/idle accounting of the decode pipeline, two views:

    - schedule ticks (always): each decode step runs M + S - 1 ticks and
      every stage is busy in M of them, so the schedule's bubble is
      (S - 1) / (M + S - 1), a cross-check, not a measurement;
    - measured busy time (with `stage_timing`): the engine brackets every
      stage program (sync) or each stage's stream of programs
      (overlapped), so bubble_frac = 1 - sum(busy) / (stages x window) is
      the measured bubble. The brackets synchronize, so timing is for the
      profiler, never for live traffic."""

    def __init__(self, n_stages: int):
        self.n_stages = n_stages
        #: the schedule whose busy times these are ("sync": one bracket
        #: per stage program; "overlapped": each stage's window from its
        #: first program to its last, which overlap)
        self.schedule = "sync"
        self.reset()

    def reset(self) -> None:
        self.stage_busy_s = [0.0] * self.n_stages
        self.stage_ticks = [0] * self.n_stages
        self.window_s = 0.0
        self.steps = 0
        self.ticks_total = 0

    def record_step(self, n_microbatches: int, wall_s: float) -> None:
        """One decode step: its schedule ticks and its measured window."""
        self.steps += 1
        self.ticks_total += n_microbatches + self.n_stages - 1
        for s in range(self.n_stages):
            self.stage_ticks[s] += n_microbatches
        self.window_s += wall_s

    def record_stage(self, stage: int, busy_s: float) -> None:
        self.stage_busy_s[stage] += busy_s

    def bubble_frac(self) -> float | None:
        """The measured share of stage-seconds idle over the window; None
        until a timed window has accumulated."""
        if self.window_s <= 0 or not any(self.stage_busy_s):
            return None
        busy = sum(self.stage_busy_s)
        return max(0.0, min(1.0, round(
            1.0 - busy / (self.n_stages * self.window_s), 4)))

    def schedule_bubble_frac(self) -> float | None:
        """Idle stage-ticks over all stage-ticks of the recorded steps."""
        if not self.ticks_total:
            return None
        busy = sum(self.stage_ticks)
        return round(1.0 - busy / (self.n_stages * self.ticks_total), 4)

    def snapshot(self) -> dict:
        return {
            "stages": self.n_stages,
            "steps": self.steps,
            "schedule": self.schedule,
            "stage_busy_s": [round(b, 4) for b in self.stage_busy_s],
            "window_s": round(self.window_s, 4),
            "bubble_frac": self.bubble_frac(),
            "schedule_bubble_frac": self.schedule_bubble_frac(),
        }


def synchronize(devices) -> None:
    """Wait for every CUDA device of `devices` (CPU devices: nothing)."""
    for d in dict.fromkeys(devices):
        if d.type == "cuda":
            torch.cuda.synchronize(d)


class InferenceStagePlan:
    """Geometry and placement of stage-sharded serving: the layer bounds,
    each stage's device, the microbatch ranges, the accounting, and the
    move between stages (module docstring)."""

    def __init__(self, n_layers: int, n_stages: int, n_slots: int, *,
                 tensor: int = 1,
                 devices: Sequence[Any] | None = None,
                 device: Any = "cpu"):
        if tensor < 1:
            raise ValueError("tensor must be >= 1")
        if tensor > 1:
            raise ValueError(
                f"tensor={tensor}: tensor-parallel stages are not ported "
                "yet (ROADMAP.md queue A6c-iii, tensor-parallel serving)")
        self.n_stages = int(n_stages)
        self.tensor = int(tensor)
        self.bounds = stage_bounds(n_layers, n_stages)
        self.mb_ranges = microbatch_ranges(n_slots, n_stages)
        home = torch.device(device)
        if devices is None:
            devices = ([torch.device("cuda", i)
                        for i in range(torch.cuda.device_count())]
                       if home.type == "cuda" else [home])
        distinct = list(dict.fromkeys(torch.device(d) for d in devices))
        self.virtual = len(distinct) < self.n_stages or self.n_stages == 1
        #: each stage's device
        self.devices = ([home] * self.n_stages if self.virtual
                        else distinct[:self.n_stages])
        self.perf = StagePerf(self.n_stages)

    @property
    def n_microbatches(self) -> int:
        return len(self.mb_ranges)

    def to_stage(self, x: torch.Tensor | None, stage: int):
        """x on `stage`'s device: the identity under virtual staging."""
        if x is None or self.virtual:
            return x
        return x.to(self.devices[stage], non_blocking=True)

    def describe(self) -> dict:
        """The /healthz `mesh` section's geometry half."""
        return {
            "stages": self.n_stages,
            "tensor": self.tensor,
            "virtual": self.virtual,
            "device_count": (1 if self.virtual
                             else self.n_stages * self.tensor),
            "stage_layers": [hi - lo for lo, hi in self.bounds],
            "microbatches": [list(r) for r in self.mb_ranges],
        }


class StageClock:
    """The timing bracket of one stage program: when armed, synchronizes
    the stage's device before and after it and adds the wall between to
    the stage's busy time; a pass-through otherwise."""

    def __init__(self, perf: StagePerf, enabled: bool,
                 devices: Sequence[torch.device] = ()):
        self.perf = perf
        self.enabled = enabled
        self.devices = devices

    def run(self, stage: int, thunk):
        if not self.enabled:
            return thunk()
        dev = self.devices[stage:stage + 1]
        synchronize(dev)
        t0 = time.perf_counter()
        out = thunk()
        synchronize(dev)
        self.perf.record_stage(stage, time.perf_counter() - t0)
        return out
