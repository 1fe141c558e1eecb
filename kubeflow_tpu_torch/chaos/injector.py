"""Fault injector — the runtime half of the chaos harness.

A `FaultInjector` is armed with one materialized `FaultScript` and a
start instant; instrumented components poll it on their own hot paths
(the supervisor at each step, the router per forward, the heartbeat
reporter per beat, the checkpoint committer per save) and the injector
answers "is this fault due/active for me right now". It never pushes —
injection points stay ordinary code the component owns, so a component
that isn't armed costs one `None` check.

Everything fired is logged with its fire instant: a chaos record keeps
the fired-event log next to the script sha, so the record shows not
just what was SCHEDULED but what actually LANDED.

The JAX module's I/O fault hook (`set_io_fault_hook` / `io_fault`) comes
with the checkpoint commit path that calls it (ROADMAP.md A2.d).
"""

from __future__ import annotations

import threading
import time
from typing import Any

from kubeflow_tpu_torch.chaos.script import FaultEvent, FaultScript


class FaultInjector:
    """Thread-safe poll-side view of one fault script's timeline."""

    def __init__(self, script: FaultScript):
        self.script = script
        self._lock = threading.Lock()
        self._t0: float | None = None
        self._consumed: set[int] = set()    # one-shots fired + cleared windows
        self.fired: list[dict[str, Any]] = []

    # -- clock ---------------------------------------------------------------

    def start(self, t0: float | None = None) -> None:
        """Arm the timeline. Idempotent: the first caller wins, so the
        runner and the supervisor can both try without double-arming."""
        with self._lock:
            if self._t0 is None:
                self._t0 = time.monotonic() if t0 is None else t0

    @property
    def started(self) -> bool:
        return self._t0 is not None

    def now_rel(self) -> float | None:
        with self._lock:
            if self._t0 is None:
                return None
            return time.monotonic() - self._t0

    # -- queries -------------------------------------------------------------

    def _matches(self, e: FaultEvent, kind: str, target: str | None) -> bool:
        if e.kind != kind:
            return False
        # a scripted target of None means "any"; a caller target of None
        # means "I am the default consumer of this kind"
        return e.target is None or target is None or e.target == target

    def due_one_shots(self, kind: str, target: str | None = None
                      ) -> list[FaultEvent]:
        """One-shot events of `kind` whose instant has passed and which
        have not fired yet. AT MOST ONE fires (is consumed) per call: a
        component absorbs one crash at a time — several crashes sharing
        an instant mean "crash again as soon as you're back", not one
        merged death."""
        with self._lock:
            if self._t0 is None:
                return []
            now = time.monotonic() - self._t0
            due = [e for e in self.script.events
                   if e.one_shot and e.index not in self._consumed
                   and e.at_s <= now and self._matches(e, kind, target)]
            if not due:
                return []
            e = due[0]
            self._consumed.add(e.index)
            self.fired.append({"index": e.index, "kind": e.kind,
                               "scheduled_s": e.at_s,
                               "fired_s": round(now, 6)})
            return [e]

    def active(self, kind: str, target: str | None = None
               ) -> FaultEvent | None:
        """The windowed event of `kind` active right now (None if none).
        First activation is logged once per event."""
        with self._lock:
            if self._t0 is None:
                return None
            now = time.monotonic() - self._t0
            for e in self.script.events:
                if (not e.one_shot and e.index not in self._consumed
                        and e.active_at(now)
                        and self._matches(e, kind, target)):
                    if not any(f["index"] == e.index for f in self.fired):
                        self.fired.append(
                            {"index": e.index, "kind": e.kind,
                             "scheduled_s": e.at_s,
                             "duration_s": e.duration_s,
                             "fired_s": round(now, 6)})
                    return e
            return None

    def clear(self, event: FaultEvent) -> None:
        """Consume a windowed event early — e.g. the supervisor declared
        the stalled backend dead and restarted it, so the replacement no
        longer sees the stall (the sick chip was left behind)."""
        with self._lock:
            self._consumed.add(event.index)

    def log(self) -> list[dict[str, Any]]:
        with self._lock:
            return [dict(f) for f in self.fired]
