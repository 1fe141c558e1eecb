"""SLO-aware serving control (counterpart of
kubeflow_tpu/loadgen/control.py): turn a `ttft_target_ms` knob into
engine settings.

decode_chunk is the latency/throughput dial: a prefill wave must drain
the in-flight decode chunk first, so TTFT carries about one chunk of
decode wall time, while throughput mildly prefers longer chunks. Two
surfaces here:

- `pick_decode_chunk`: the STATIC pick — largest chunk whose tabled
  TTFT sits under the target, from a (chunk -> ttft_ms) table. Use at
  engine/scenario setup.
- `SLOController`: the LIVE loop — an observed-TTFT EMA against the
  target re-picks the chunk at a fixed control interval through
  `engine.set_decode_chunk` (clamped to the warmed menu, applied at the
  next chunk boundary — live traffic never waits on a graph capture).
  Multiplicative decrease on misses, cautious increase when comfortably
  under target.

Admission control composes via `engine.set_tenant_limits` (the scheduler
owns per-tenant share caps); the slo-chase scenario drives both.
"""

from __future__ import annotations

from typing import Any, Mapping

#: the default (chunk -> TTFT p50 ms) table, the JAX module's values: not
#: a measurement of the port. Only its ranking matters — the controller
#: treats it as a starting order and the live EMA as truth.
MEASURED_CHUNK_TTFT_MS: dict[int, float] = {4: 217.0, 8: 465.0}


def pick_decode_chunk(ttft_target_ms: float,
                      table: Mapping[int, float] | None = None,
                      max_chunk: int = 8) -> int:
    """Largest chunk (<= max_chunk) whose measured TTFT meets the target;
    the smallest tabled chunk when none does (latency-floor fallback)."""
    table = dict(table or MEASURED_CHUNK_TTFT_MS)
    fits = [c for c, ttft in table.items()
            if c <= max_chunk and ttft <= ttft_target_ms]
    if fits:
        return max(fits)
    return min(c for c in table if c <= max_chunk) if any(
        c <= max_chunk for c in table) else 1


class SLOController:
    """Feedback re-pick of decode_chunk from a live TTFT EMA.

    observe() feeds completed-request TTFTs; maybe_adjust() applies the
    policy at most once per control interval:
      - EMA > target          -> halve the chunk (shed queueing latency)
      - EMA < recover*target  -> double it (recover throughput headroom)
    The engine clamps to its warmed menu, so the controller can never
    push live traffic onto a graph capture. The trajectory list is the
    committed evidence that the knob actually moved under load."""

    def __init__(self, ttft_target_ms: float, *,
                 interval_s: float = 5.0, alpha: float = 0.3,
                 recover_frac: float = 0.4):
        if ttft_target_ms <= 0:
            raise ValueError("ttft_target_ms must be positive")
        self.target_ms = float(ttft_target_ms)
        self.interval_s = float(interval_s)
        self.alpha = float(alpha)
        self.recover_frac = float(recover_frac)
        self.ema_ms: float | None = None
        self._last_adjust_s: float | None = None
        self.trajectory: list[dict[str, Any]] = []

    def observe(self, ttft_ms: float) -> None:
        if self.ema_ms is None:
            self.ema_ms = float(ttft_ms)
        else:
            self.ema_ms += self.alpha * (float(ttft_ms) - self.ema_ms)

    def maybe_adjust(self, engine, now_s: float) -> int | None:
        """One control tick; returns the newly applied chunk (None = no
        change). `now_s` is the runner's clock so replays stay testable."""
        if self._last_adjust_s is None:
            self._last_adjust_s = now_s
            return None
        if now_s - self._last_adjust_s < self.interval_s \
                or self.ema_ms is None:
            return None
        self._last_adjust_s = now_s
        current = engine.decode_chunk
        want = current
        if self.ema_ms > self.target_ms and current > 1:
            want = max(1, current // 2)
        elif (self.ema_ms < self.recover_frac * self.target_ms
              and current < engine.decode_chunk_max):
            want = current * 2
        if want == current:
            return None
        applied = engine.set_decode_chunk(want)
        self.trajectory.append({
            "t_s": round(now_s, 3),
            "ttft_ema_ms": round(self.ema_ms, 1),
            "target_ms": self.target_ms,
            "chunk": applied,
        })
        return applied
