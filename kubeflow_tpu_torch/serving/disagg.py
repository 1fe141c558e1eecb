"""Disaggregated prefill/decode serving (counterpart of kubeflow_tpu/
serving/disagg.py).

A chunked prefill chain holds an engine's step loop for a whole chunk
plan while decode wants short uniform steps, so a long prompt arriving
beside running streams stretches every stream's inter-token gap. This
module splits the two onto dedicated engine roles (`serving/llm.py`
`PrefillEngine`, `DecodeEngine`) and coordinates them:

  - **KVHandoff** moves a finished prefill's KV between the roles as
    radix prefix-cache block payloads (block-granular, int8-aware: the
    int8 rows and f32 scales of an int8 cache). `KVHandoff` is the
    in-process zero-copy insert: the payload tensors move by reference
    (each is a clone with storage of its own, `LLMEngine._payload_slice`,
    so the prefill role's slot can be overwritten at once).
    `SerializedKVHandoff` sends every block through host bytes behind
    the same interface (int8 stays int8, f32 scales f32; `bytes_sent`
    counts them), the shape a transport between hosts would take. Either
    way the decode role's ordinary prefix-cache admission consumes the
    blocks: a handed-off prompt is a prefix hit and a tail continuation.

  - **PrefillQueue**: prefill admission by shortest remaining prefill
    first (the prompt less what the prefill role's cache holds) inside
    max-min tenant fairness (among tenants with queued jobs, the one with
    the fewest prefills in flight). Jobs wait here, not in the prefill
    engine's queue, so the policy binds and backpressure has a place to
    act.

  - **DisaggregatedEngine**: the engine surface (submit, step, result,
    cancel, request_timing, metrics, ...) over two `EngineSupervisor`s,
    one per role, with its own request ids. A thread of its own drives
    the prefill role (queue -> prefill -> handoff -> decode submit), so
    prefill work overlaps decode; `step()` drives the decode role.
    Backpressure: a prefill is not dispatched while the decode role's
    store (free and evictable blocks, less those promised to prefills in
    flight) cannot take its output, unless nothing else is in flight
    (then the handoff may be partial, never a deadlock). A prompt shorter
    than one block, or a permanently failed prefill role, bypasses to the
    decode role, which then prefills as a colocated engine does.

On the card the prefill role's thread issues its work on a CUDA stream of
its own, so its kernels run beside the decode role's, which use the
device's default stream. A handed-off payload is ordered after the
prefill stream's writes (`wait_stream`) and recorded as used by the
default stream (`record_stream`), so the allocator cannot reuse its
memory while the decode role may still read it; the serialized handoff
copies the bytes back to the card on the default stream itself. The
roles count their kernel launches apart (`ops/_build.py` TAGGED,
"prefill" and "decode"). Both roles' engines capture graphs with
`capture_error_mode="thread_local"`, so a restarted role's warmup
captures while the other role's thread allocates and synchronizes.

Slab roles only, as in the JAX package: a paged engine's payloads are
block ids into its own pool, meaningless to another engine.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Callable

import torch

from kubeflow_tpu_torch.obs.trace import TRACER
from kubeflow_tpu_torch.ops import _build
from kubeflow_tpu_torch.serving.scheduler import QueueFull


def _to_default_stream(payload: tuple) -> tuple:
    """Order the device's default stream after the current stream's work
    and mark each tensor of `payload` as used by it (a no-op on the CPU
    and where the current stream is the default one)."""
    for t in payload:
        if not t.is_cuda:
            continue
        target = torch.cuda.default_stream(t.device)
        current = torch.cuda.current_stream(t.device)
        if current != target:
            target.wait_stream(current)
            t.record_stream(target)
    return payload


class KVHandoff:
    """Prefill -> decode transfer of radix block payloads, zero-copy: the
    payload tensors move by reference into the target cache. `target` is
    a callable returning the current target `RadixKVCache`, None while
    the decode engine is down (the send is skipped and the decode role
    prefills in full: degraded, never wrong)."""

    name = "zero_copy"

    def __init__(self, target: Callable[[], Any]):
        self._target = target
        self._lock = threading.Lock()
        self.handoffs = 0
        self.blocks_sent = 0
        self.tokens_sent = 0
        self.bytes_sent = 0       # the serialized handoff only

    def transfer(self, payload: tuple) -> tuple:
        return _to_default_stream(payload)

    def send(self, tokens, payloads: list, *, namespace: Any = None,
             tenant: str | None = None) -> int:
        """Insert the matched block chain for the aligned prefix of
        `tokens` into the target cache; `transfer` runs only for blocks
        the target does not hold yet. Returns the number of new blocks
        stored (the insert may stop early when the store is full: a
        prefix of the chain is still a valid chain)."""
        cache = self._target()
        if cache is None or not payloads:
            return 0
        bt = cache.block_tokens
        aligned = min(len(payloads), len(tokens) // bt) * bt
        if aligned <= 0:
            return 0
        inserted = cache.insert(
            tokens, lambda i, s, e: self.transfer(payloads[i]),
            max_tokens=aligned, tenant=tenant, namespace=namespace)
        with self._lock:
            self.handoffs += 1
            self.blocks_sent += inserted
            self.tokens_sent += inserted * bt
        return inserted

    def stats(self) -> dict[str, Any]:
        with self._lock:
            return {"transport": self.name, "handoffs": self.handoffs,
                    "blocks_sent": self.blocks_sent,
                    "tokens_sent": self.tokens_sent,
                    "bytes_sent": self.bytes_sent}


class SerializedKVHandoff(KVHandoff):
    """The handoff through host bytes, behind the same interface: every
    tensor of a block payload is copied to the host, taken to bytes (the
    wire format: int8 blocks stay int8, their scales f32), and rebuilt
    as a new tensor on its device, on the default stream the decode role
    reads it on. In-process the dtype and shape ride as Python objects."""

    name = "serialized"

    def transfer(self, payload: tuple) -> tuple:
        out = []
        total = 0
        for t in payload:
            # .cpu() waits for the stream that wrote the block
            blob = t.detach().cpu().contiguous().flatten().view(
                torch.uint8).numpy().tobytes()
            total += len(blob)
            rebuilt = torch.frombuffer(bytearray(blob), dtype=t.dtype
                                       ).reshape(t.shape)
            if t.is_cuda:
                with torch.cuda.stream(torch.cuda.default_stream(t.device)):
                    rebuilt = rebuilt.to(t.device)
            out.append(rebuilt)
        with self._lock:
            self.bytes_sent += total
        return tuple(out)


HANDOFFS = {"zero_copy": KVHandoff, "serialized": SerializedKVHandoff}


@dataclasses.dataclass
class _DisaggReq:
    """One coordinated request's lifecycle record."""
    rid: int
    prompt: list[int]
    max_new: int
    kw: dict[str, Any]            # decode-side submit kwargs
    tenant: str | None
    adapter: str | None
    submit_s: float
    deadline_at: float | None
    blocks_needed: int = 0
    stage: str = "queued"         # queued | prefill | decode | done
    prefill_rid: int | None = None
    decode_rid: int | None = None
    dispatch_s: float | None = None   # left the queue (phase epoch)
    prefill_done_s: float | None = None   # prefill harvest (handoff epoch)
    handoff_s: float | None = None
    trace: str | None = None          # obs trace id riding the pipeline
    blocks: int = 0               # blocks actually handed off
    bypass: bool = False
    reason: str | None = None     # local terminal reason (no decode rid)


class PrefillQueue:
    """Host-side prefill admission queue: pop() returns the next job by
    shortest-remaining-prefill first WITHIN max-min tenant fairness —
    among tenants with queued jobs, the one holding the fewest in-flight
    prefills wins (tie: shorter best job, then FIFO); within the chosen
    tenant, the job with the least remaining prefill compute. SRPT is
    the TTFT-tail policy: a 64-token prompt never waits behind three
    4k-token chains. `done(tenant)` returns a finished job's fairness
    share."""

    def __init__(self):
        self._lock = threading.Lock()
        self._q: dict[Any, list[_DisaggReq]] = {}
        self._active: dict[Any, int] = {}
        self._seq: dict[int, int] = {}     # rid -> FIFO tiebreak
        self._n = 0
        self.enqueued = 0
        self.popped = 0

    def push(self, job: _DisaggReq) -> None:
        with self._lock:
            self._q.setdefault(job.tenant, []).append(job)
            if job.rid not in self._seq:
                self._n += 1
                self._seq[job.rid] = self._n
                self.enqueued += 1

    def pop(self, remaining: Callable[[_DisaggReq], int]) -> \
            "_DisaggReq | None":
        """`remaining(job)` = prefill tokens the worker would still have
        to compute (prompt minus its cached prefix) — evaluated at pop
        time so a prefix cached since enqueue re-ranks the job."""
        with self._lock:
            best = None   # (active, rem, seq, tenant, idx)
            for tenant, jobs in self._q.items():
                if not jobs:
                    continue
                act = self._active.get(tenant, 0)
                for i, j in enumerate(jobs):
                    key = (act, remaining(j), self._seq[j.rid])
                    if best is None or key < best[0]:
                        best = (key, tenant, i)
            if best is None:
                return None
            _, tenant, i = best
            job = self._q[tenant].pop(i)
            if not self._q[tenant]:
                del self._q[tenant]
            self._active[tenant] = self._active.get(tenant, 0) + 1
            self._seq.pop(job.rid, None)
            self.popped += 1
            return job

    def done(self, tenant: Any) -> None:
        with self._lock:
            n = self._active.get(tenant, 0) - 1
            if n > 0:
                self._active[tenant] = n
            else:
                self._active.pop(tenant, None)

    def remove(self, job: _DisaggReq) -> bool:
        with self._lock:
            jobs = self._q.get(job.tenant)
            if jobs and job in jobs:
                jobs.remove(job)
                if not jobs:
                    del self._q[job.tenant]
                self._seq.pop(job.rid, None)
                return True
            return False

    def depth(self) -> int:
        with self._lock:
            return sum(len(v) for v in self._q.values())

    def inflight(self) -> int:
        with self._lock:
            return sum(self._active.values())


class DisaggregatedEngine:
    """The coordinator over a prefill-role and a decode-role
    `EngineSupervisor`, with the engine surface and its own request ids
    (a role's restart invalidates none). The decode supervisor is the
    replica's identity: its permanent failure is the replica's; a
    permanently failed prefill role degrades to bypass."""

    #: how long an accepted request may wait for decode admission (queue
    #: full or tenant cap at handoff time) before it ends as a recorded
    #: rejection, when it carries no deadline of its own
    decode_wait_s = 60.0

    def __init__(self, prefill, decode, *,
                 handoff: str | KVHandoff = "zero_copy",
                 max_inflight_prefills: int | None = None):
        self.prefill = prefill
        self.decode = decode
        peng, deng = prefill.engine, decode.engine
        if peng is None or deng is None:
            raise ValueError("both role supervisors must start alive")
        if not getattr(deng, "prefix_cache_enabled", False) \
                or not getattr(peng, "prefix_cache_enabled", False):
            raise ValueError("disaggregated roles require prefix_cache "
                             "(the handoff currency)")
        if peng.prefix_block_tokens != deng.prefix_block_tokens:
            raise ValueError(
                f"role block sizes differ (prefill "
                f"{peng.prefix_block_tokens} vs decode "
                f"{deng.prefix_block_tokens}): handed-off chains would "
                "never match")
        if "paged" in (peng.kv_layout, deng.kv_layout):
            raise ValueError(
                "disaggregated serving requires kv_layout=slab roles: "
                "paged payloads are pool-local block ids, not portable "
                "KV (serving/paged.py)")
        self._bt = deng.prefix_block_tokens
        if isinstance(handoff, str):
            try:
                handoff = HANDOFFS[handoff](lambda: self.decode.kvcache)
            except KeyError:
                raise ValueError(
                    f"unknown handoff transport {handoff!r}; "
                    f"known: {sorted(HANDOFFS)}") from None
        self.handoff = handoff
        self._max_inflight = (max_inflight_prefills
                              or max(1, peng.n_slots))
        self.queue = PrefillQueue()
        self._lock = threading.RLock()
        self._reqs: dict[int, _DisaggReq] = {}
        self._next_rid = 1
        self._accepted = 0
        self._terminal = {"completed": 0, "cancelled": 0, "rejected": 0}
        self._bypass = 0
        self._blocks_inflight = 0
        self._qwait_sum_ms = 0.0
        self._qwait_n = 0
        self._pump_errors = 0
        self._last_pump_error: str | None = None
        # the prefill role's own stream on the card (module docstring)
        self._pstream = (torch.cuda.Stream(peng.device)
                         if peng.device.type == "cuda" else None)
        self._stop = threading.Event()
        self._prefill_thread = threading.Thread(
            target=self._prefill_loop, daemon=True,
            name="disagg-prefill-worker")
        self._prefill_thread.start()

    # -- submit side ----------------------------------------------------------

    def submit(self, prompt, max_new_tokens: int = 32,
               temperature: float = 0.0, adapter: str | None = None,
               top_k: int = 0, top_p: float = 1.0,
               presence_penalty: float = 0.0,
               frequency_penalty: float = 0.0,
               seed: int | None = None, stop=None,
               deadline_s: float | None = None,
               tenant: str | None = None,
               trace: str | None = None) -> int:
        if self.failed:
            raise QueueFull("decode backend permanently failed "
                            "(restart budget exhausted)")
        deng = self.decode.engine
        if deng is not None:
            # bad arguments raise on the caller's thread: the pumps run on
            # the engine threads, where an exception would stop serving
            # for everyone (with the engine down, the journal accepts and
            # a replay records the rejection)
            deng._validate_submit(prompt, temperature, adapter, top_k,
                                  top_p, presence_penalty,
                                  frequency_penalty, seed, stop,
                                  deadline_s, max_new_tokens, tenant)
        kw = dict(temperature=temperature, adapter=adapter, top_k=top_k,
                  top_p=top_p, presence_penalty=presence_penalty,
                  frequency_penalty=frequency_penalty, seed=seed,
                  stop=stop, tenant=tenant, trace=trace)
        now = time.monotonic()
        with self._lock:
            r = _DisaggReq(
                rid=self._next_rid, prompt=list(prompt),
                max_new=max_new_tokens, kw=kw, tenant=tenant,
                adapter=adapter, submit_s=now, trace=trace,
                deadline_at=(now + deadline_s if deadline_s is not None
                             else None))
            self._next_rid += 1
            self._reqs[r.rid] = r
            self._accepted += 1
            aligned = (len(r.prompt) // self._bt) * self._bt
            r.blocks_needed = aligned // self._bt
            if aligned < self._bt or self.prefill.failed:
                # nothing to hand off, or no prefill role left: straight
                # to the decode role, its admission errors to the caller
                try:
                    self._to_decode(r, bypass=True, raise_errors=True)
                except BaseException:
                    del self._reqs[r.rid]
                    self._accepted -= 1
                    raise
            else:
                self.queue.push(r)
        return r.rid

    def _to_decode(self, r: _DisaggReq, *, bypass: bool = False,
                   raise_errors: bool = False) -> None:
        """Submit one request to the decode supervisor (lock held)."""
        kw = dict(r.kw)
        if r.deadline_at is not None:
            rem = r.deadline_at - time.monotonic()
            if rem <= 0:
                self._finalize(r, "cancelled")
                return
            kw["deadline_s"] = rem
        if bypass and not r.bypass:
            r.bypass = True
            self._bypass += 1
        try:
            r.decode_rid = self.decode.submit(list(r.prompt), r.max_new,
                                              **kw)
        except Exception:
            if raise_errors:
                raise
            # refused mid-pipeline (queue full, tenant cap) after the
            # coordinator accepted it: held and retried until its
            # deadline (_pump_decode), where a colocated engine would
            # have answered 503 at submit
            r.stage = "decode_wait"
            return
        r.stage = "decode"
        if r.dispatch_s is None:
            r.dispatch_s = time.monotonic()

    def _finalize(self, r: _DisaggReq, reason: str) -> None:
        if r.stage == "done":
            return
        r.stage = "done"
        if r.reason is None and r.decode_rid is None:
            r.reason = reason
        key = ("completed" if reason in ("stop", "length")
               else "rejected" if reason == "rejected" else "cancelled")
        self._terminal[key] += 1

    # -- the drive loops ------------------------------------------------------

    def step(self) -> bool:
        """One iteration of the decode role (the prefill role runs on its
        own thread). False only when decode is idle and nothing is queued
        or in a prefill."""
        _build.set_thread_tag("decode")
        worked = self.decode.step()
        self._pump_decode()
        with self._lock:
            busy = any(r.stage in ("queued", "prefill", "handoff",
                                   "decode_wait")
                       for r in self._reqs.values())
        if not worked and busy:
            # waiting on the prefill role: yield the core to its thread
            time.sleep(0.0005)
        return worked or busy

    def run_until_idle(self) -> None:
        while self.step():
            pass

    def _prefill_loop(self) -> None:
        """The prefill role's drive loop: dispatch queued jobs, step the
        prefill supervisor, hand finished KV to the decode role. An
        exception never ends the loop and never vanishes: it is counted
        in metrics()["disagg"] (pump_errors, last_pump_error)."""
        _build.set_thread_tag("prefill")
        if self._pstream is not None:
            torch.cuda.set_stream(self._pstream)
        while not self._stop.is_set():
            try:
                worked = self._pump_prefill()
                worked = self.prefill.step() or worked
            except Exception as e:
                with self._lock:
                    self._pump_errors += 1
                    self._last_pump_error = f"{type(e).__name__}: {e}"
                worked = False
            if not worked:
                self._stop.wait(0.002)

    def _remaining_prefill(self, r: _DisaggReq) -> int:
        """The prefill tokens the worker would still compute for a job,
        the SRPT key (an unpinned probe of its cache)."""
        cache = self.prefill.kvcache
        if cache is None:
            return len(r.prompt)
        cached = cache.cached_prefix_len(
            r.prompt, max_tokens=len(r.prompt) - 1,
            namespace=self._namespace(r.adapter))
        return len(r.prompt) - cached

    def _namespace(self, adapter: str | None) -> int:
        if adapter is None:
            return 0
        return self.decode._adapter_idx.get(adapter) \
            or self.prefill._adapter_idx.get(adapter, 0)

    def _decode_kv_available(self) -> int | None:
        """Blocks the decode role's store can still take: free and
        evictable, less the blocks promised to prefills in flight. None
        while the decode engine is down (unknown: no gate)."""
        cache = self.decode.kvcache
        if cache is None:
            return None
        st = cache.stats()
        free = st["capacity_blocks"] - st["blocks"]
        return (free + st.get("evictable_blocks", 0)
                - self._blocks_inflight)

    def _pump_prefill(self) -> bool:
        """The prefill thread's half of the state machine; True when
        anything moved."""
        now = time.monotonic()
        moved = False
        with self._lock:
            # 1) deadlines of jobs the decode engine cannot see yet
            for r in list(self._reqs.values()):
                if r.deadline_at is None or now < r.deadline_at:
                    continue
                if r.stage == "queued":
                    self.queue.remove(r)
                    self._finalize(r, "cancelled")
                    moved = True
                elif r.stage == "prefill":
                    self._abort_prefill(r)
                    self._finalize(r, "cancelled")
                    moved = True
            # 2) harvest finished prefills (the handoff runs outside the
            #    lock below: a serialized one crosses the host per block)
            finished: list[tuple[_DisaggReq, str]] = []
            for r in list(self._reqs.values()):
                if r.stage != "prefill" \
                        or not self.prefill.is_done(r.prefill_rid):
                    continue
                reason = self.prefill.finish_reason(r.prefill_rid)
                self.prefill.release(r.prefill_rid)
                r.prefill_rid = None
                self.queue.done(r.tenant)
                self._blocks_inflight = max(
                    0, self._blocks_inflight - r.blocks_needed)
                r.stage = "handoff"
                r.prefill_done_s = time.monotonic()
                finished.append((r, reason))
                moved = True
            # 3) dispatch under the in-flight cap and the decode store's
            #    backpressure
            while self.queue.inflight() < self._max_inflight:
                job = self.queue.pop(self._remaining_prefill)
                if job is None:
                    break
                if job.stage != "queued":
                    self.queue.done(job.tenant)
                    continue
                avail = self._decode_kv_available()
                if (avail is not None and job.blocks_needed > avail
                        and self.queue.inflight() > 1):
                    # the decode store cannot take this output yet: hold
                    # it and everything behind it (alone in flight it goes
                    # anyway: a partial handoff, never a deadlock)
                    self.queue.done(job.tenant)
                    self.queue.push(job)
                    break
                try:
                    job.prefill_rid = self.prefill.submit(
                        list(job.prompt), 1, adapter=job.adapter,
                        tenant=job.tenant, trace=job.trace)
                except Exception:
                    # refused by the prefill role (queue full, shed,
                    # failed): bypass
                    self.queue.done(job.tenant)
                    self._to_decode(job, bypass=True)
                    continue
                job.stage = "prefill"
                job.dispatch_s = time.monotonic()
                self._qwait_sum_ms += (job.dispatch_s - job.submit_s) * 1e3
                self._qwait_n += 1
                self._blocks_inflight += job.blocks_needed
                moved = True
        # the handoff, then a short re-lock to advance the state machine
        # (a cancel that landed meanwhile wins: the moved blocks stay in
        # the decode store as reusable prefix KV)
        for r, reason in finished:
            blocks = (self._handoff(r) if reason in ("stop", "length")
                      else 0)
            with self._lock:
                if r.stage != "handoff":
                    continue
                r.blocks = blocks
                r.handoff_s = time.monotonic()
                self._record_role_spans(r)
                # a prefill refused or cancelled on the prefill role still
                # serves, prefilled by the decode role
                self._to_decode(r, bypass=reason not in ("stop",
                                                         "length"))
        return moved

    def _record_role_spans(self, r: _DisaggReq) -> None:
        """The queue, prefill and handoff spans of a sampled trace, from
        the phase instants, once at the handoff."""
        if r.trace is None or not TRACER.sampled(r.trace):
            return
        TRACER.record_span("disagg.queue", "queue", r.trace,
                           r.submit_s, r.dispatch_s, tenant=r.tenant)
        TRACER.record_span("disagg.prefill", "prefill", r.trace,
                           r.dispatch_s, r.prefill_done_s,
                           role="prefill", prompt_len=len(r.prompt),
                           blocks_needed=r.blocks_needed)
        TRACER.record_span("disagg.handoff", "handoff", r.trace,
                           r.prefill_done_s, r.handoff_s,
                           blocks=r.blocks,
                           handoff=type(self.handoff).__name__)

    def _pump_decode(self) -> None:
        """The decode side's bookkeeping, on the caller's step loop:
        decode completions for the accounting, and decode_wait requests
        retried until their deadline."""
        now = time.monotonic()
        with self._lock:
            for r in list(self._reqs.values()):
                if r.stage == "decode_wait":
                    limit = (r.deadline_at
                             if r.deadline_at is not None
                             else r.submit_s + self.decode_wait_s)
                    if now >= limit:
                        self._finalize(r, "rejected")
                    else:
                        self._to_decode(r, bypass=r.bypass)
                elif r.stage == "decode" and self.decode.is_done(
                        r.decode_rid):
                    self._finalize(r,
                                   self.decode.finish_reason(r.decode_rid))

    def _handoff(self, r: _DisaggReq) -> int:
        """Match the finished prefill's banked chain and send it to the
        decode role's store. Best effort: a crashed prefill engine (a cold
        cache), an evicted chain or a decode engine that is down send
        less or nothing, and the decode role computes the rest."""
        cache = self.prefill.kvcache
        if cache is None:
            return 0
        ns = self._namespace(r.adapter)
        aligned = (len(r.prompt) // self._bt) * self._bt
        m = cache.match(r.prompt, max_tokens=aligned, namespace=ns)
        try:
            return self.handoff.send(r.prompt, list(m.payloads),
                                     namespace=ns, tenant=r.tenant)
        finally:
            cache.release(m)

    def _abort_prefill(self, r: _DisaggReq) -> None:
        """Drop a prefill-stage job's state on the prefill role (lock
        held)."""
        if r.prefill_rid is not None:
            self.prefill.cancel(r.prefill_rid)
            self.prefill.release(r.prefill_rid)
            r.prefill_rid = None
        self.queue.done(r.tenant)
        self._blocks_inflight = max(
            0, self._blocks_inflight - r.blocks_needed)

    # -- request side ---------------------------------------------------------

    def cancel(self, rid: int) -> bool:
        with self._lock:
            r = self._reqs.get(rid)
            if r is None or r.stage == "done":
                return False
            if r.stage == "queued":
                self.queue.remove(r)
                self._finalize(r, "cancelled")
                return True
            if r.stage == "prefill":
                self._abort_prefill(r)
                self._finalize(r, "cancelled")
                return True
            if r.stage in ("handoff", "decode_wait"):
                # the prefill side is clean; a handoff in flight checks
                # the stage before it goes on
                self._finalize(r, "cancelled")
                return True
            return self.decode.cancel(r.decode_rid)

    def is_done(self, rid: int) -> bool:
        with self._lock:
            r = self._reqs.get(rid)
            if r is None or r.stage == "done":
                return True
            if r.stage == "decode":
                return self.decode.is_done(r.decode_rid)
            return False

    def _from_decode(self, rid: int, fn: str, finished: bool = True):
        """The decode role's answer for a request that reached it; for one
        that ended before, [] (KeyError while it runs)."""
        with self._lock:
            r = self._reqs[rid]
            if r.decode_rid is not None:
                return getattr(self.decode, fn)(r.decode_rid)
            if finished and r.stage != "done":
                raise KeyError(f"request {rid} not finished")
            return []

    def result(self, rid: int) -> list[int]:
        return self._from_decode(rid, "result")

    def result_logprobs(self, rid: int) -> list[float]:
        return self._from_decode(rid, "result_logprobs")

    def result_top_logprobs(self, rid: int) -> list[dict[int, float]]:
        return self._from_decode(rid, "result_top_logprobs", finished=False)

    def partial_result(self, rid: int) -> list[int]:
        with self._lock:
            if rid not in self._reqs:
                return []
            return self._from_decode(rid, "partial_result", finished=False)

    def partial_logprobs(self, rid: int) -> list[float]:
        with self._lock:
            if rid not in self._reqs:
                return []
            return self._from_decode(rid, "partial_logprobs",
                                     finished=False)

    def finish_reason(self, rid: int) -> str:
        with self._lock:
            r = self._reqs.get(rid)
            if r is None:
                return "length"
            if r.decode_rid is not None:
                return self.decode.finish_reason(r.decode_rid)
            return r.reason or "length"

    def usage_chain(self, rid: int) -> list[str]:
        with self._lock:
            if rid not in self._reqs:
                return []
            return self._from_decode(rid, "usage_chain", finished=False)

    def cached_tokens(self, rid: int) -> int:
        with self._lock:
            r = self._reqs.get(rid)
            if r is None or r.decode_rid is None:
                return 0
            return self.decode.cached_tokens(r.decode_rid)

    def request_timing(self, rid: int) -> dict[str, Any]:
        """The engine's timing record over the pipeline: queue_wait_ms is
        submit to the job leaving the prefill queue; prefill_ms from there
        to the prefill role's KV harvest; handoff_ms from the harvest to
        the first token (the transfer, decode admission and the tail
        continuation); decode_ms to the finish. The four partition submit
        to finish. A bypass request never harvests: its prefill_ms runs
        from the queue exit to the first token and handoff_ms is None."""
        with self._lock:
            r = self._reqs[rid]
            first = fin = None
            n_tokens = 0
            cached = 0
            if r.decode_rid is not None:
                tm = self.decode.request_timing(r.decode_rid)
                first, fin = tm["first_token_s"], tm["finish_s"]
                n_tokens = tm["n_tokens"]
                cached = tm.get("cached_prefix_len", 0)
            elif r.stage == "done":
                fin = r.handoff_s or r.dispatch_s

        def ms(a, b):
            return (round((b - a) * 1e3, 3)
                    if a is not None and b is not None else None)

        pdone = r.prefill_done_s
        return {
            "submit_s": r.submit_s,
            "first_token_s": first,
            "finish_s": fin,
            "tenant": r.tenant,
            "n_tokens": n_tokens,
            "prompt_len": len(r.prompt),
            "cached_prefix_len": cached,
            "prefill_tokens": len(r.prompt) - cached,
            "queue_wait_ms": ms(r.submit_s, r.dispatch_s),
            "prefill_ms": (ms(r.dispatch_s, pdone) if pdone is not None
                           else ms(r.dispatch_s, first)),
            "handoff_ms": (ms(pdone, first) if pdone is not None
                           else None),
            "decode_ms": ms(first, fin),
        }

    def release(self, rid: int) -> None:
        with self._lock:
            r = self._reqs.get(rid)
            if r is None:
                return
            if r.stage != "done":
                # a client may release the moment is_done() turns, before
                # the step loop's _pump_decode saw it: finalize here, or
                # accounting() would count a loss
                if r.decode_rid is not None:
                    if self.decode.is_done(r.decode_rid):
                        self._finalize(r, self.decode.finish_reason(
                            r.decode_rid))
                    else:
                        self.decode.cancel(r.decode_rid)
                        self._finalize(r, "cancelled")
                else:
                    if r.stage == "queued":
                        self.queue.remove(r)
                    elif r.stage == "prefill":
                        self._abort_prefill(r)
                    self._finalize(r, "cancelled")
            del self._reqs[rid]
            if r.decode_rid is not None:
                self.decode.release(r.decode_rid)

    def generate(self, prompt, max_new_tokens: int = 32,
                 temperature: float = 0.0, adapter: str | None = None,
                 **kw) -> list[int]:
        rid = self.submit(prompt, max_new_tokens, temperature,
                          adapter=adapter, **kw)
        while not self.is_done(rid):
            if not self.step():
                raise RuntimeError("engine idle with request outstanding")
        return self.result(rid)

    # -- knobs and passthroughs -----------------------------------------------

    @property
    def failed(self) -> bool:
        """The replica's permanent failure is the decode role's."""
        return bool(self.decode.failed)

    @property
    def degraded(self) -> bool:
        return bool(self.decode.degraded or self.prefill.degraded
                    or self.prefill.failed)

    @property
    def kvcache(self):
        return self.decode.kvcache

    @property
    def prefix_cache_enabled(self) -> bool:
        return self.decode.prefix_cache_enabled

    @property
    def _adapter_idx(self):
        return self.decode._adapter_idx

    @property
    def injector(self):
        return self.decode.injector

    @property
    def decode_chunk(self) -> int:
        return self.decode.decode_chunk

    @property
    def decode_chunk_max(self) -> int:
        return self.decode.decode_chunk_max

    def set_decode_chunk(self, chunk: int) -> int:
        return self.decode.set_decode_chunk(chunk)

    def set_tenant_limits(self, max_active_per_tenant: int = 0,
                          max_queued_per_tenant: int = 0) -> None:
        self.decode.set_tenant_limits(max_active_per_tenant,
                                      max_queued_per_tenant)
        self.prefill.set_tenant_limits(max_active_per_tenant,
                                       max_queued_per_tenant)

    def arm_faults(self, script) -> "DisaggregatedEngine":
        """Arms the decode role (the replica's identity); arm the prefill
        role through `self.prefill.arm_faults(...)`."""
        self.decode.arm_faults(script)
        return self

    # -- accounting and metrics -----------------------------------------------

    def accounting(self) -> dict[str, Any]:
        """The zero-lost contract over the coordinator: every accepted
        request is queued, in a role's journal, or terminal, so `lost`
        must be 0. The roles' own records ride under prefill/decode."""
        dacc = self.decode.accounting()
        pacc = self.prefill.accounting()
        with self._lock:
            inflight = sum(
                1 for r in self._reqs.values()
                if r.stage in ("queued", "prefill", "handoff",
                               "decode_wait")
                or (r.stage == "decode"
                    and not self.decode.is_done(r.decode_rid)))
            term = dict(self._terminal)
            accepted = self._accepted
        terminal = sum(term.values())
        role_keys = ("accepted", "completed", "cancelled", "rejected",
                     "restarts", "mttr_s", "journal_depth")
        return {
            "accepted": accepted,
            "completed": term["completed"],
            "cancelled": term["cancelled"],
            "rejected": term["rejected"],
            "in_flight": inflight,
            "terminal": terminal,
            "lost": accepted - terminal - inflight,
            **{k: dacc[k] + pacc[k] for k in
               ("restarts", "replayed", "retried", "replay_verified",
                "replay_mismatch", "shed", "outages")},
            "mttr_s": dacc["mttr_s"],
            "permanent_failed": self.failed,
            "last_mttr_s": dacc["last_mttr_s"],
            "journal_depth": dacc["journal_depth"],
            "prefill": {k: pacc[k] for k in role_keys},
            "decode": {k: dacc[k] for k in role_keys},
        }

    def metrics(self) -> dict[str, Any]:
        out = self.decode.metrics()
        out["supervisor"] = self.accounting()
        with self._lock:
            qn = self._qwait_n
            disagg = {
                "queue_depth": self.queue.depth(),
                "inflight_prefills": self.queue.inflight(),
                "blocks_in_flight": self._blocks_inflight,
                "bypass": self._bypass,
                "queue_wait_ms_mean": (round(self._qwait_sum_ms / qn, 3)
                                       if qn else None),
                "handoff": self.handoff.stats(),
                "prefill_permanent_failed": bool(self.prefill.failed),
                "prefill_restarts":
                    self.prefill.accounting()["restarts"],
                "pump_errors": self._pump_errors,
                "last_pump_error": self._last_pump_error,
            }
        peng = self.prefill.engine
        if peng is not None:
            disagg["prefill_cache"] = peng.metrics().get("prefix_cache")
        deng = self.decode.engine
        if deng is not None:
            disagg["decode_full_prefills"] = getattr(
                deng, "full_prefills", None)
        out["disagg"] = disagg
        return out

    def close(self) -> None:
        self._stop.set()
        if self._prefill_thread.is_alive():
            self._prefill_thread.join(timeout=10)
        self.prefill.close()
        self.decode.close()
