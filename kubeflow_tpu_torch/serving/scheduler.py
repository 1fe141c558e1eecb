"""Continuous-batching scheduler (counterpart of the pure-Python
`PyScheduler` in kubeflow_tpu/serving/scheduler.py, without tenants):
fixed decode slots, prompt-length buckets, one FIFO queue.

`next()` hands out a PrefillAction while a slot is free and a request is
queued, else a DecodeAction while any slot is active, else None.
`cancel()` drops a queued request or frees a running one's slot.
"""

from __future__ import annotations

import dataclasses
import threading
from collections import deque
from typing import Sequence


@dataclasses.dataclass(frozen=True)
class PrefillAction:
    req_id: int
    slot: int
    bucket_len: int
    prompt_len: int
    max_new_tokens: int


@dataclasses.dataclass(frozen=True)
class DecodeAction:
    active: int


class QueueFull(RuntimeError):
    pass


class PromptTooLong(ValueError):
    pass


@dataclasses.dataclass
class _Slot:
    req_id: int = -1
    generated: int = 0
    max_new: int = 0
    active: bool = False


class PyScheduler:
    """Slots, buckets and a FIFO queue; thread-safe."""

    #: queued requests past this are refused with QueueFull
    MAX_QUEUE = 1024

    def __init__(self, max_slots: int, buckets: Sequence[int]):
        self._buckets = sorted(buckets)
        self._queue: deque = deque()
        self._slots = [_Slot() for _ in range(max_slots)]
        self._next_id = 1
        self._mu = threading.Lock()

    def submit(self, prompt_len: int, max_new_tokens: int) -> int:
        with self._mu:
            if prompt_len <= 0 or prompt_len > self._buckets[-1]:
                raise PromptTooLong(
                    f"prompt_len {prompt_len} exceeds buckets")
            if len(self._queue) >= self.MAX_QUEUE:
                raise QueueFull("scheduler queue full")
            rid = self._next_id
            self._next_id += 1
            self._queue.append((rid, prompt_len, max_new_tokens))
            return rid

    def next(self) -> PrefillAction | DecodeAction | None:
        with self._mu:
            free = next((i for i, s in enumerate(self._slots)
                         if not s.active), -1)
            if free >= 0 and self._queue:
                rid, plen, max_new = self._queue.popleft()
                sl = self._slots[free]
                sl.req_id, sl.generated, sl.max_new = rid, 0, max_new
                sl.active = True
                bucket = next(b for b in self._buckets if b >= plen)
                return PrefillAction(rid, free, bucket, plen, max_new)
            active = sum(s.active for s in self._slots)
            if active:
                return DecodeAction(active)
            return None

    def token_done(self, slot: int, finished: bool = False) -> bool:
        """Count one generated token; True when the slot's request ended
        (finished, or its max_new_tokens reached) and the slot is free."""
        with self._mu:
            sl = self._slots[slot]
            if not sl.active:
                raise ValueError(f"token_done on inactive slot {slot}")
            sl.generated += 1
            if finished or sl.generated >= sl.max_new:
                sl.active = False
                sl.req_id = -1
                return True
            return False

    def slot_request(self, slot: int) -> int:
        with self._mu:
            sl = self._slots[slot]
            return sl.req_id if sl.active else -1

    def cancel(self, req_id: int) -> str | None:
        """"queued" (removed from the queue), "active" (its slot freed)
        or None (unknown or finished): the JAX scheduler's contract."""
        with self._mu:
            for i, (rid, _plen, _mx) in enumerate(self._queue):
                if rid == req_id:
                    del self._queue[i]
                    return "queued"
            for sl in self._slots:
                if sl.active and sl.req_id == req_id:
                    sl.active = False
                    sl.req_id = -1
                    return "active"
            return None
