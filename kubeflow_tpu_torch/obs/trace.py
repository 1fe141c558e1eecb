"""Request-scoped tracing (counterpart of kubeflow_tpu/obs/trace.py):
trace ids, spans in a bounded ring buffer, and the decode loop's step
aggregator.

1. Zero hot-loop cost when sampled out: the sampling decision is a
   deterministic hash of the trace id, so every layer of one request
   (server, supervisor, engine) reaches the same keep/drop verdict
   without coordination.
2. The decode loop never creates per-token spans. Engines keep the
   timestamps they already track (submit, prefill start, first token,
   finish) and emit one retrospective span per request per phase via
   `record_span`; `StepAggregator` carries the per-chunk counters (steps,
   tokens) that annotate the decode span.
3. Spans are plain facts in a bounded deque: an unscraped buffer can only
   cost old spans (`dropped` counts them), never memory.

Span kinds: ``http`` (server handler), ``supervise`` (journal lifetime
with its crash-replay chain), ``queue``, ``prefill``, ``decode``,
``restart``, ``replay``.
"""

from __future__ import annotations

import hashlib
import os
import threading
import time
from collections import deque
from typing import Any

#: HTTP header carrying the trace id across the router → server hop.
TRACE_HEADER = "X-Trace-Id"

_SAMPLE_SALT = b"ktpu-trace-v1"


def new_trace_id() -> str:
    """128-bit random hex — mint once at the edge (router or submit)."""
    return os.urandom(16).hex()


def _new_span_id() -> str:
    return os.urandom(8).hex()


class Span:
    """One timed hop of one request. Mutable until ``end()``; appended
    to the sink at end-time so half-open spans never export."""

    __slots__ = ("trace_id", "span_id", "parent_id", "name", "kind",
                 "start_s", "end_s", "attrs", "_sink")

    def __init__(self, trace_id: str, name: str, kind: str,
                 parent_id: str | None = None, start_s: float | None = None,
                 attrs: dict[str, Any] | None = None,
                 sink: "SpanSink | None" = None):
        self.trace_id = trace_id
        self.span_id = _new_span_id()
        self.parent_id = parent_id
        self.name = name
        self.kind = kind
        self.start_s = time.monotonic() if start_s is None else start_s
        self.end_s: float | None = None
        self.attrs: dict[str, Any] = dict(attrs or {})
        self._sink = sink

    def end(self, end_s: float | None = None, **attrs: Any) -> "Span":
        if self.end_s is not None:   # idempotent: double-end exports once
            return self
        self.end_s = time.monotonic() if end_s is None else end_s
        if attrs:
            self.attrs.update(attrs)
        if self._sink is not None:
            self._sink.append(self)
        return self


class SpanSink:
    """Bounded in-process ring buffer of ended spans."""

    def __init__(self, capacity: int = 4096):
        self._lock = threading.Lock()
        self._buf: deque[Span] = deque(maxlen=max(1, int(capacity)))
        self.dropped = 0

    def append(self, span: Span) -> None:
        with self._lock:
            if len(self._buf) == self._buf.maxlen:
                self.dropped += 1
            self._buf.append(span)

    def __len__(self) -> int:
        with self._lock:
            return len(self._buf)

    def spans(self, trace_id: str | None = None) -> list[Span]:
        with self._lock:
            snap = list(self._buf)
        if trace_id is None:
            return snap
        return [s for s in snap if s.trace_id == trace_id]


class Tracer:
    """Sampling + span minting over one sink. ``sample_rate`` in [0,1];
    the decision is a pure function of the trace id so every layer
    agrees without sharing state."""

    def __init__(self, sink: SpanSink | None = None,
                 sample_rate: float = 1.0):
        self.sink = sink if sink is not None else SpanSink()
        self.sample_rate = float(sample_rate)

    def set_sample_rate(self, rate: float) -> float:
        self.sample_rate = min(1.0, max(0.0, float(rate)))
        return self.sample_rate

    def sampled(self, trace_id: str | None) -> bool:
        if not trace_id or self.sample_rate <= 0.0:
            return False
        if self.sample_rate >= 1.0:
            return True
        h = hashlib.blake2b(_SAMPLE_SALT + trace_id.encode(),
                            digest_size=8).digest()
        return int.from_bytes(h, "big") < self.sample_rate * 2.0**64

    def record_span(self, name: str, kind: str, trace_id: str | None,
                    start_s: float, end_s: float,
                    parent_id: str | None = None, **attrs: Any) -> None:
        """Retrospective span from timestamps a layer already kept —
        the ONLY emission style allowed on engine hot paths (zero cost
        until the request finishes, nothing per token)."""
        if start_s is None or end_s is None or not self.sampled(trace_id):
            return
        Span(trace_id, name, kind, parent_id=parent_id, start_s=start_s,
             attrs=attrs, sink=self.sink).end(end_s=end_s)


class StepAggregator:
    """The hot-loop recorder: per-step counter bumps only (no spans, no
    allocation), reduced to attrs for the ONE decode span a request
    gets. Engines snapshot ``steps``/``tokens`` at first-token and at
    finish; the difference annotates the retrospective decode span."""

    __slots__ = ("steps", "tokens")

    def __init__(self):
        self.steps = 0
        self.tokens = 0

    def note_step(self, n_tokens: int, steps: int = 1) -> None:
        """Count one dispatch (or a fused chunk of ``steps``) delivering
        up to ``n_tokens`` across the batch."""
        self.steps += int(steps)
        self.tokens += int(n_tokens)

    def snapshot(self) -> tuple[int, int]:
        return self.steps, self.tokens

    @staticmethod
    def window(at_start: tuple[int, int],
               at_end: tuple[int, int]) -> dict[str, int]:
        return {"decode_steps": at_end[0] - at_start[0],
                "decode_tokens": at_end[1] - at_start[1]}


#: the process tracer every layer shares (tests may swap the sink).
TRACER = Tracer()
