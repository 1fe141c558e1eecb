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

The module also owns the process-global I/O fault hook
(`set_io_fault_hook` / `io_fault`) that `training/checkpoint.py` calls
at its commit points: a seam rather than a monkeypatch, so a test can
truncate a file "mid-write" through a supported interface.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any, Callable

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

    def as_io_fault_hook(self) -> Callable[[str, str], None]:
        """Bridge a scripted `ckpt_io_fail` one-shot onto the checkpoint
        commit seam: install the returned hook with `set_io_fault_hook`,
        and the next `checkpoint_commit` after a due event truncates one
        file of the committing step to half its size (a torn write the
        manifest must catch at restore). The event is consumed and
        logged like any other fault."""

        def hook(op: str, path: str) -> None:
            if op != "checkpoint_commit":
                return
            if not self.due_one_shots("ckpt_io_fail"):
                return
            victim = None
            for root, _dirs, files in os.walk(path):
                for fn in sorted(files):
                    p = os.path.join(root, fn)
                    if os.path.getsize(p) > 8:
                        victim = p
                        break
                if victim:
                    break
            if victim is not None:
                with open(victim, "r+b") as f:
                    f.truncate(os.path.getsize(victim) // 2)
        return hook


# -- process-global I/O fault hook (checkpoint commit seam) -------------------

_io_hook: Callable[[str, str], None] | None = None
_io_hook_lock = threading.Lock()


def set_io_fault_hook(fn: Callable[[str, str], None] | None
                      ) -> Callable[[str, str], None] | None:
    """Install (or clear, with None) the process-global I/O fault hook.
    The hook receives (op, path) at instrumented commit points:
    "checkpoint_commit" (after the step's files are hashed, before the
    manifest is written: corrupting here models a torn write the checksum
    must catch) and "manifest_write" (before the manifest lands: raising
    here models a crash mid-commit, leaving a partial step). Returns the
    previous hook so tests can restore it."""
    global _io_hook
    with _io_hook_lock:
        prev, _io_hook = _io_hook, fn
        return prev


def io_fault(op: str, path: str) -> None:
    """Called by instrumented I/O commit points; a no-op unless a hook is
    armed. The hook may change files under `path` and/or raise OSError."""
    hook = _io_hook
    if hook is not None:
        hook(op, path)
