"""Concurrency packing: solo-against-co-located interference records (the
port's copy of kubeflow_tpu/rl/packing.py). The JAX gang scheduler's
`PackingPolicy.learn` consumes `InterferenceRecord.to_json()`, so the
record keeps the JAX keys and rounding.

Run workload A alone, workload B alone (solo rates), then both at once
from two host threads against the same card, each counting only the
chunks it completes inside one fixed window (packed rates). The
record's `combined_retention` (packed_a/solo_a + packed_b/solo_b) is the
decision quantity: perfect time-slicing scores 1.0, so packing pays only
when the sum clears 1.0 with margin (`PackingPolicy.decide`). On the
card the two threads launch on whatever CUDA streams their work uses; the
caller picks them and says which.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Callable


@dataclasses.dataclass
class InterferenceRecord:
    """Measured solo/packed rates for one co-location pair. Rates are in
    each workload's own units (env-steps/s, tok/s, ...): retentions are
    unit-free, so heterogeneous pairs compare cleanly."""

    workload_a: str
    workload_b: str
    solo_a: float
    solo_b: float
    packed_a: float
    packed_b: float
    unit_a: str = ""
    unit_b: str = ""

    @property
    def retention_a(self) -> float:
        return self.packed_a / self.solo_a if self.solo_a > 0 else 0.0

    @property
    def retention_b(self) -> float:
        return self.packed_b / self.solo_b if self.solo_b > 0 else 0.0

    @property
    def combined_retention(self) -> float:
        """> 1.0 means packing beats perfect chip-time-slicing."""
        return self.retention_a + self.retention_b

    def to_json(self) -> dict[str, Any]:
        return {
            "workload_a": self.workload_a, "workload_b": self.workload_b,
            "unit_a": self.unit_a, "unit_b": self.unit_b,
            "solo_a": round(self.solo_a, 2),
            "solo_b": round(self.solo_b, 2),
            "packed_a": round(self.packed_a, 2),
            "packed_b": round(self.packed_b, 2),
            "retention_a": round(self.retention_a, 3),
            "retention_b": round(self.retention_b, 3),
            "combined_retention": round(self.combined_retention, 3),
        }


def _measure_rate(work: Callable[[], float], min_seconds: float) -> float:
    """Sustained SOLO rate of `work` (each call returns the units it
    completed); runs whole chunks until `min_seconds` elapse. The final
    chunk may overshoot — harmless solo, because the rate divides by the
    actual elapsed time and nothing else contends."""
    units = 0.0
    t0 = time.perf_counter()
    while True:
        units += work()
        dt = time.perf_counter() - t0
        if dt >= min_seconds:
            return units / dt


def _windowed_rate(work: Callable[[], float], seconds: float) -> float:
    """PACKED-phase rate: count only chunks that COMPLETE inside the
    fixed window. A chunk crossing the deadline ran partly after the
    other workload's window closed — i.e. uncontended — and counting it
    would inflate the slower workload's packed rate (and with it the
    combined_retention the PackingPolicy admits packing on). Dropping
    the tail chunk biases conservatively: packed rates are, if anything,
    UNDERestimated, so the policy errs toward denial."""
    units = 0.0
    t0 = time.perf_counter()
    deadline = t0 + seconds
    while True:
        done = units + work()
        if time.perf_counter() > deadline:
            return units / seconds   # tail chunk dropped
        units = done


def measure_interference(name_a: str, work_a: Callable[[], float],
                         name_b: str, work_b: Callable[[], float], *,
                         seconds: float = 2.0, unit_a: str = "",
                         unit_b: str = "") -> InterferenceRecord:
    """Solo A, solo B, then both concurrently for the same wall window.

    `work_*` runs one chunk of its workload and returns the units it
    produced (a chunk should be well under `seconds` or the packed phase
    degenerates to alternation). The packed phase starts both threads on
    a barrier so neither gets a head start; each counts only chunks
    completed inside its fixed window (`_windowed_rate`), so a slow
    workload's overshooting tail — which runs uncontended after the
    other window closed — cannot inflate its packed rate."""
    solo_a = _measure_rate(work_a, seconds)
    solo_b = _measure_rate(work_b, seconds)

    rates: dict[str, float] = {}
    barrier = threading.Barrier(2)
    errors: list[BaseException] = []

    def runner(name: str, work: Callable[[], float]) -> None:
        try:
            barrier.wait(timeout=30)
            rates[name] = _windowed_rate(work, seconds)
        except BaseException as e:   # surfaced to the caller below
            errors.append(e)

    threads = [threading.Thread(target=runner, args=(n, w), daemon=True)
               for n, w in (("a", work_a), ("b", work_b))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return InterferenceRecord(
        workload_a=name_a, workload_b=name_b,
        solo_a=solo_a, solo_b=solo_b,
        packed_a=rates["a"], packed_b=rates["b"],
        unit_a=unit_a, unit_b=unit_b)
