"""Continuous-batching scheduler (counterpart of
kubeflow_tpu/serving/scheduler.py): fixed decode slots, prompt-length
buckets and per-tenant queues.

`NativeScheduler` binds the port's C++ core (native/cb_scheduler.cpp,
built by `kubeflow_tpu_torch.native`) through ctypes; `PyScheduler` is
its pure-Python twin with the same policy and API, and the oracle the
tests hold the C++ core to. Both expose what the engine loop consumes:
submit / next / token_done / slot_request / cancel / stats.

`next()` hands out a PrefillAction while a slot is free and a request is
queued, else a DecodeAction while any slot is active, else None.

Multi-tenant fairness: `submit` takes an integer tenant id; the queue is
per-tenant FIFO and the pop is max-min fair over decode slots — among
tenants with queued work, the one holding the fewest active slots wins
(tie: the older head request). `set_fairness(max_active_per_tenant,
max_queued_per_tenant)` adds a soft share cap (over-cap tenants wait
while an under-cap tenant is queued; the policy stays work-conserving)
and hard admission control (submits past the per-tenant queue cap raise
`TenantOverQuota`). All-tenant-0 traffic is one global FIFO.

The engines always run the C++ core, and `NativeScheduler` raises
`NativeUnavailable` when it cannot be built: unlike the JAX module's
`make_scheduler`, nothing falls back to the twin silently, so which code
ran is never in doubt.
"""

from __future__ import annotations

import ctypes
import dataclasses
import threading
from collections import deque
from typing import Sequence

from kubeflow_tpu_torch import native

IDLE, PREFILL, DECODE = 0, 1, 2

#: the bound on queued requests over every tenant; past it submit raises
#: QueueFull
MAX_QUEUE = 1024


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


@dataclasses.dataclass(frozen=True)
class Stats:
    queued: int
    active: int
    completed: int
    rejected: int


class QueueFull(RuntimeError):
    pass


class TenantOverQuota(QueueFull):
    """Per-tenant admission cap exceeded (max_queued_per_tenant); a subtype
    of QueueFull so existing 503 mappings catch it."""


class TenantShed(QueueFull):
    """Degraded-mode load shedding: the serving plane is running at
    reduced capacity (backend dead/restarting) and this tenant's priority
    class is below the shed threshold. A subtype of QueueFull so the
    existing 503 mappings and the loadgen runner's admission-control
    accounting catch it — a shed request is a recorded rejection, never a
    silent drop."""


@dataclasses.dataclass(frozen=True)
class ShedPolicy:
    """Priority-ordered degraded-mode shedding (the anti-collapse policy):
    while the plane is degraded, requests from tenants whose priority is
    below `shed_below` are rejected at admission so the remaining capacity
    serves the tenants the operator ranked highest. Priorities are higher
    = more important; unlisted tenants get `default_priority`. The SLO
    consequences land in the ordinary loadgen accounting (shed requests
    show up in the per-tenant `rejected` column)."""
    priorities: tuple[tuple[str, int], ...] = ()
    default_priority: int = 0
    shed_below: int = 1

    def priority_of(self, tenant: str | None) -> int:
        for name, p in self.priorities:
            if name == tenant:
                return p
        return self.default_priority

    def sheds(self, tenant: str | None) -> bool:
        return self.priority_of(tenant) < self.shed_below


class PromptTooLong(ValueError):
    pass


class NativeScheduler:
    """ctypes binding over the C++ continuous-batching scheduler."""

    def __init__(self, max_slots: int, buckets: Sequence[int],
                 max_queue: int = MAX_QUEUE):
        self._lib = native.library("cb_scheduler")
        self._lib.cbs_create.restype = ctypes.c_void_p
        self._lib.cbs_create.argtypes = [
            ctypes.c_int32, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int32]
        self._lib.cbs_destroy.argtypes = [ctypes.c_void_p]
        self._lib.cbs_submit_t.restype = ctypes.c_int64
        self._lib.cbs_submit_t.argtypes = [
            ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_double, ctypes.c_int32]
        self._lib.cbs_set_fairness.argtypes = [
            ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32]
        self._lib.cbs_next.restype = ctypes.c_int32
        self._lib.cbs_next.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64)]
        self._lib.cbs_token_done.restype = ctypes.c_int32
        self._lib.cbs_token_done.argtypes = [
            ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32]
        self._lib.cbs_slot_request.restype = ctypes.c_int64
        self._lib.cbs_slot_request.argtypes = [ctypes.c_void_p, ctypes.c_int32]
        self._lib.cbs_tenant_active.restype = ctypes.c_int32
        self._lib.cbs_tenant_active.argtypes = [ctypes.c_void_p,
                                                ctypes.c_int32]
        self._lib.cbs_cancel.restype = ctypes.c_int32
        self._lib.cbs_cancel.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        self._lib.cbs_stats.argtypes = [ctypes.c_void_p] + \
            [ctypes.POINTER(ctypes.c_int64)] * 4

        arr = (ctypes.c_int32 * len(buckets))(*sorted(buckets))
        self._h = self._lib.cbs_create(max_slots, max_queue, arr, len(buckets))
        if not self._h:
            raise ValueError("bad scheduler config (slots/buckets)")

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.cbs_destroy(h)
            self._h = None

    def submit(self, prompt_len: int, max_new_tokens: int,
               now: float = 0.0, tenant: int = 0) -> int:
        rid = self._lib.cbs_submit_t(self._h, prompt_len, max_new_tokens,
                                     now, tenant)
        if rid == -1:
            raise QueueFull("scheduler queue full")
        if rid == -2:
            raise PromptTooLong(f"prompt_len {prompt_len} exceeds buckets")
        if rid == -3:
            raise TenantOverQuota(
                f"tenant {tenant} over its admission quota")
        return rid

    def set_fairness(self, max_active_per_tenant: int = 0,
                     max_queued_per_tenant: int = 0) -> None:
        """Per-tenant share cap (soft, work-conserving) and admission cap
        (hard); 0 disables either."""
        self._lib.cbs_set_fairness(self._h, int(max_active_per_tenant),
                                   int(max_queued_per_tenant))

    def tenant_active(self, tenant: int) -> int:
        """Active decode slots currently held by `tenant`."""
        return int(self._lib.cbs_tenant_active(self._h, tenant))

    def next(self) -> PrefillAction | DecodeAction | None:
        out = (ctypes.c_int64 * 5)()
        code = self._lib.cbs_next(self._h, out)
        if code == PREFILL:
            return PrefillAction(out[0], int(out[1]), int(out[2]),
                                 int(out[3]), int(out[4]))
        if code == DECODE:
            return DecodeAction(int(out[1]))
        return None

    def token_done(self, slot: int, finished: bool = False) -> bool:
        r = self._lib.cbs_token_done(self._h, slot, 1 if finished else 0)
        if r < 0:
            raise ValueError(f"token_done on inactive slot {slot}")
        return bool(r)

    def slot_request(self, slot: int) -> int:
        return int(self._lib.cbs_slot_request(self._h, slot))

    def cancel(self, req_id: int) -> str | None:
        """Remove a request wherever it lives: "queued" (pulled from the
        queue before prefill), "active" (slot freed), None (unknown /
        already finished)."""
        r = self._lib.cbs_cancel(self._h, req_id)
        return {1: "queued", 2: "active"}.get(int(r))

    def stats(self) -> Stats:
        vals = [ctypes.c_int64() for _ in range(4)]
        self._lib.cbs_stats(self._h, *[ctypes.byref(v) for v in vals])
        return Stats(*[int(v.value) for v in vals])


@dataclasses.dataclass
class _PySlot:
    req_id: int = -1
    generated: int = 0
    max_new: int = 0
    tenant: int = 0
    active: bool = False


class PyScheduler:
    """Pure-Python twin of the C++ scheduler (same policy, same API)."""

    def __init__(self, max_slots: int, buckets: Sequence[int],
                 max_queue: int = MAX_QUEUE):
        self._buckets = sorted(buckets)
        # per-tenant FIFO, iterated in sorted tenant order (the C++ twin's
        # std::map order) so both twins break ties identically
        self._queues: dict[int, deque] = {}
        self._total_queued = 0
        self._slots = [_PySlot() for _ in range(max_slots)]
        self._max_queue = max_queue
        self._max_active_per_tenant = 0
        self._max_queued_per_tenant = 0
        self._next_id = 1
        self._completed = 0
        self._rejected = 0
        self._mu = threading.Lock()

    def submit(self, prompt_len: int, max_new_tokens: int,
               now: float = 0.0, tenant: int = 0) -> int:
        with self._mu:
            tenant = max(0, int(tenant))
            if prompt_len <= 0 or prompt_len > self._buckets[-1]:
                self._rejected += 1
                raise PromptTooLong(
                    f"prompt_len {prompt_len} exceeds buckets")
            if self._total_queued >= self._max_queue:
                self._rejected += 1
                raise QueueFull("scheduler queue full")
            q = self._queues.setdefault(tenant, deque())
            if (self._max_queued_per_tenant > 0
                    and len(q) >= self._max_queued_per_tenant):
                self._rejected += 1
                raise TenantOverQuota(
                    f"tenant {tenant} over its admission quota")
            rid = self._next_id
            self._next_id += 1
            q.append((rid, prompt_len, max_new_tokens))
            self._total_queued += 1
            return rid

    def set_fairness(self, max_active_per_tenant: int = 0,
                     max_queued_per_tenant: int = 0) -> None:
        with self._mu:
            self._max_active_per_tenant = max(0, int(max_active_per_tenant))
            self._max_queued_per_tenant = max(0, int(max_queued_per_tenant))

    def _tenant_active(self, tenant: int) -> int:
        return sum(1 for s in self._slots
                   if s.active and s.tenant == tenant)

    def tenant_active(self, tenant: int) -> int:
        with self._mu:
            return self._tenant_active(tenant)

    def next(self) -> PrefillAction | DecodeAction | None:
        with self._mu:
            free = next((i for i, s in enumerate(self._slots)
                         if not s.active), -1)
            if free >= 0 and self._total_queued:
                # max-min fair tenant choice: prefer under-cap tenants,
                # then fewest active slots, then oldest head request —
                # byte-identical to cbs_next's loop over std::map order
                best = None  # (tenant, active, head_id, under)
                for tenant in sorted(self._queues):
                    q = self._queues[tenant]
                    if not q:
                        continue
                    a = self._tenant_active(tenant)
                    under = (self._max_active_per_tenant <= 0
                             or a < self._max_active_per_tenant)
                    if (best is None or (under and not best[3])
                            or (under == best[3]
                                and (a, q[0][0]) < (best[1], best[2]))):
                        best = (tenant, a, q[0][0], under)
                tenant = best[0]
                rid, plen, max_new = self._queues[tenant].popleft()
                if not self._queues[tenant]:
                    # drop drained queues: pop cost and memory stay
                    # bounded by LIVE tenants, not tenants ever seen
                    del self._queues[tenant]
                self._total_queued -= 1
                sl = self._slots[free]
                sl.req_id, sl.generated, sl.max_new = rid, 0, max_new
                sl.tenant, sl.active = tenant, True
                bucket = next((b for b in self._buckets if b >= plen),
                              self._buckets[-1])
                return PrefillAction(rid, free, bucket, plen, max_new)
            active = sum(s.active for s in self._slots)
            if active:
                return DecodeAction(active)
            return None

    def token_done(self, slot: int, finished: bool = False) -> bool:
        with self._mu:
            sl = self._slots[slot]
            if not sl.active:
                raise ValueError(f"token_done on inactive slot {slot}")
            sl.generated += 1
            if finished or sl.generated >= sl.max_new:
                sl.active = False
                sl.req_id = -1
                self._completed += 1
                return True
            return False

    def slot_request(self, slot: int) -> int:
        with self._mu:
            sl = self._slots[slot]
            return sl.req_id if sl.active else -1

    def cancel(self, req_id: int) -> str | None:
        """Same contract as NativeScheduler.cancel (the differential-test
        oracle): "queued" | "active" | None. Cancelled requests count
        neither as completed nor rejected — the engine keeps the metric."""
        with self._mu:
            for tenant, q in list(self._queues.items()):
                for i, (rid, _plen, _mx) in enumerate(q):
                    if rid == req_id:
                        del q[i]
                        if not q:
                            del self._queues[tenant]
                        self._total_queued -= 1
                        return "queued"
            for sl in self._slots:
                if sl.active and sl.req_id == req_id:
                    sl.active = False
                    sl.req_id = -1
                    return "active"
            return None

    def stats(self) -> Stats:
        with self._mu:
            return Stats(self._total_queued,
                         sum(s.active for s in self._slots),
                         self._completed, self._rejected)

