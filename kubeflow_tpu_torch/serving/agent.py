"""Engine supervision (counterpart of the `EngineSupervisor` of
kubeflow_tpu/serving/agent.py): the crash-recovery layer every serving
engine sits behind.

The supervisor journals every accepted request, watches the engine for
death (a step() that raises, an injected `backend_crash`) and for stalls
(while work is in flight some request must deliver a token every
`stall_timeout_s`, over at least `stall_min_steps` driven steps),
restarts the engine through a caller-supplied factory under capped
exponential backoff, and replays the journaled in-flight requests:
greedy and seeded requests replay from the prompt (the engine's seeded
draws depend on (seed, position) alone), and their delivered prefix is
checked against the replay at completion (`replay_verified` or
`replay_mismatch`); unseeded sampled requests resume as new generations
over their journaled prefix, chained `cancelled` -> `retried`. After
`max_restarts` consecutive failures the backend is permanently failed
and everything in flight ends `cancelled`. Every accepted request reaches
a terminal state (completed, cancelled or rejected), and `accounting()`
shows that none was lost.

While the backend is down, admission runs in degraded mode: a
`ShedPolicy` sheds the tenants it ranks below its threshold (each a
`TenantShed` refusal, counted as `shed`) so the capacity that comes back
serves the tenants ranked highest. Tenant limits (`set_tenant_limits`)
are kept and applied again to every restarted engine.

The fault injector is duck-typed (`start`, `due_one_shots`, `active`,
`clear`), so the port's `chaos.FaultInjector` (and the JAX package's)
drives this supervisor.

`PayloadLogger` (the JAX package's, the kserve logger sidecar's job):
per-request JSON-lines records of what the server received and answered,
configured per InferenceService by `spec.predictor.logger` ({mode: all |
request | response, path: a file | url: a collector}). The file sink
appends under a lock; the url sink posts from a thread of its own off a
bounded queue (a full queue drops the record); a sink's error is
swallowed, so logging never fails or slows a request.

`MultiModelAgent` (the JAX package's, kserve's puller and ModelMesh
pattern): pull-on-demand models in a `ModelRepository` with LRU eviction.
A pull resolves the URI (`storage.download`), builds the model through
the serving-runtime registry (`model.load_model`) and registers it,
which loads it; past `max_loaded` pulled models the least recently used
is unloaded (on the card its weights go back to the allocator). Models
the agent did not pull (the host service's own) are never evicted, and a
pull of such a name is refused.
"""

from __future__ import annotations

import dataclasses
import json
import queue
import threading
import time
import urllib.request
from typing import Any, Callable

from kubeflow_tpu_torch.chaos import FaultInjector, FaultScript
from kubeflow_tpu_torch.obs import metrics as obs_metrics
from kubeflow_tpu_torch.obs.trace import TRACER
from kubeflow_tpu_torch.serving.model import (ModelError, ModelRepository,
                                              load_model)
from kubeflow_tpu_torch.serving.scheduler import QueueFull, TenantShed
from kubeflow_tpu_torch.serving.storage import download


class PayloadLogger:
    """Thread-safe JSON-lines payload log; `mode` picks which halves of
    each exchange are recorded."""

    def __init__(self, path: str | None = None, url: str | None = None,
                 mode: str = "all"):
        if mode not in ("all", "request", "response"):
            raise ValueError(f"logger mode {mode!r} invalid")
        if not path and not url:
            raise ValueError("logger needs path or url")
        self.path = path
        self.url = url
        self.mode = mode
        self._lock = threading.Lock()
        self._seq = 0
        self._queue: queue.Queue | None = None
        if url:
            # the url sink stays off the request path: a worker thread
            # drains a bounded queue
            self._queue = queue.Queue(maxsize=1024)
            threading.Thread(target=self._url_worker, daemon=True,
                             name="payload-logger").start()

    def _emit(self, record: dict[str, Any]) -> None:
        try:
            line = json.dumps(record, default=str)
        except Exception:
            return
        if self.path:
            try:
                with self._lock:
                    with open(self.path, "a") as f:
                        f.write(line + "\n")
            except Exception:
                pass
        if self._queue is not None:
            try:
                self._queue.put_nowait(line)
            except queue.Full:
                pass   # log records are shed before requests are

    def _url_worker(self) -> None:
        while True:
            line = self._queue.get()
            try:
                req = urllib.request.Request(
                    self.url, data=line.encode(),
                    headers={"Content-Type": "application/json"})
                with urllib.request.urlopen(req, timeout=2.0):
                    pass
            except Exception:
                pass
            finally:
                self._queue.task_done()

    def flush(self, timeout: float = 5.0) -> None:
        """Wait up to `timeout` for the url sink's queued records."""
        if self._queue is None:
            return
        deadline = time.monotonic() + timeout
        while not self._queue.empty() and time.monotonic() < deadline:
            time.sleep(0.01)

    def next_id(self) -> str:
        with self._lock:
            self._seq += 1
            return f"req-{self._seq}"

    def log_request(self, model: str, request_id: str,
                    payload: Any) -> None:
        if self.mode in ("all", "request"):
            self._emit({"ts": time.time(), "id": request_id, "model": model,
                        "type": "request", "payload": payload})

    def log_response(self, model: str, request_id: str, payload: Any,
                     latency_ms: float, status: int = 200) -> None:
        if self.mode in ("all", "response"):
            self._emit({"ts": time.time(), "id": request_id, "model": model,
                        "type": "response", "status": status,
                        "latency_ms": round(latency_ms, 3),
                        "payload": payload})


class MultiModelAgent:
    """Pull/evict manager over a ModelRepository.

    pull() is idempotent per name; predict-path callers `touch()` names so
    eviction tracks recency. A model loading is never evicted (the lock
    covers the bookkeeping, not the load itself, so a slow load does not
    block serving the others)."""

    def __init__(self, repository: ModelRepository | None = None,
                 max_loaded: int = 4, storage_root: str | None = None,
                 namespace: str | None = None):
        if max_loaded < 1:
            raise ValueError("max_loaded must be >= 1")
        self.repository = repository or ModelRepository()
        self.max_loaded = max_loaded
        self.storage_root = storage_root
        self.namespace = namespace
        self._lock = threading.Lock()
        self._last_used: dict[str, float] = {}
        self._loading: set[str] = set()
        # the models THIS agent pulled: capacity and eviction apply only
        # to them (a shared repository may hold the host's own model)
        self._owned: set[str] = set()
        self.pulls = 0
        self.evictions = 0

    def pull(self, name: str, model_format: str, uri: str | None = None,
             **config: Any):
        """Download, load and register; evicts the LRU past max_loaded."""
        with self._lock:
            try:
                existing = self.repository.get(name)
            except ModelError:
                existing = None
            if existing is not None and name not in self._owned:
                # a foreign model claims the name: returning it would
                # report success while serving the wrong model
                raise ModelError(
                    f"model name {name!r} is already in use by the host "
                    f"repository")
            if existing is not None or name in self._loading:
                self._last_used[name] = time.monotonic()
                if existing is not None:
                    return existing
                raise ModelError(f"model {name!r} is still loading")
            self._loading.add(name)
        try:
            local = uri
            if uri and "://" in uri:
                local = download(uri, artifact_root=self.storage_root,
                                 namespace=self.namespace)
            model = load_model(model_format, name, local, **config)
            self.repository.register(model)  # loads the model
            with self._lock:
                self.pulls += 1
                self._loading.discard(name)
                self._owned.add(name)
                self._last_used[name] = time.monotonic()
            self._evict_over_capacity()
            return model
        except BaseException:
            with self._lock:
                self._loading.discard(name)
            raise

    def touch(self, name: str) -> None:
        with self._lock:
            if name in self._last_used:
                self._last_used[name] = time.monotonic()

    def unload(self, name: str) -> None:
        with self._lock:
            self._last_used.pop(name, None)
            self._owned.discard(name)
        self.repository.unload(name)

    def loaded(self) -> list[str]:
        """Models this agent pulled (still loaded)."""
        names = set(self.repository.names())
        with self._lock:
            return sorted(self._owned & names)

    def _evict_over_capacity(self) -> None:
        while True:
            with self._lock:
                names = self._owned & set(self.repository.names())
                if len(names) <= self.max_loaded:
                    return
                # oldest by last use; names never touched sort first
                victim = min(
                    (n for n in names if n not in self._loading),
                    key=lambda n: self._last_used.get(n, 0.0),
                    default=None)
                if victim is None:
                    return
                self._last_used.pop(victim, None)
                self._owned.discard(victim)
                self.evictions += 1
                # unload inside the lock: choosing and removing the victim
                # is atomic against a pull() returning (and touching) it
                self.repository.unload(victim)


@dataclasses.dataclass
class _Journaled:
    """One accepted request's journal entry — everything needed to replay
    it on a replacement engine, plus supervisor-level timing (engine
    timestamps die with the engine; these survive restarts)."""
    rid: int
    prompt: list[int]
    max_new: int
    kw: dict[str, Any]
    tenant: str | None
    deterministic: bool          # seeded or greedy: replay is byte-exact
    submit_s: float
    first_token_s: float | None = None
    finish_s: float | None = None
    tokens: list[int] = dataclasses.field(default_factory=list)
    #: per-token logprobs paired 1:1 with `tokens` (the streaming HTTP
    #: path emits (token, logprob) pairs; they must survive a restart
    #: together or the resumed stream fabricates values)
    lps: list[float] = dataclasses.field(default_factory=list)
    #: tokens delivered by PREVIOUS engine generations (the journaled
    #: prefix an unseeded continuation resumes over)
    base_tokens: list[int] = dataclasses.field(default_factory=list)
    base_lps: list[float] = dataclasses.field(default_factory=list)
    #: top-N alternatives captured at completion (None until then; the
    #: resumed-tail positions of an unseeded retry pad with {})
    top_lps: list[dict] | None = None
    engine_rid: int | None = None
    #: tokens seen from the CURRENT engine generation (watchdog signal:
    #: a replay regenerating its old prefix is progress even though the
    #: client-visible count hasn't moved yet)
    engine_seen: int = 0
    terminal: bool = False
    finish_reason: str | None = None
    chain: list[str] = dataclasses.field(default_factory=list)
    verify_prefix: list[int] | None = None
    #: phase split (queue_wait_ms / prefill_ms / decode_ms) captured from
    #: the engine at completion — durations survive the engine's death,
    #: so request_timing() keeps reporting them after release/restart
    #: (for a replayed request they describe the LAST engine generation)
    phases: dict[str, Any] | None = None
    #: prefix-KV tokens the engine reused, captured at completion: the
    #: live engine rid is released right there, so without this the
    #: usage/cached_tokens surface read 0 the moment a request finished
    cached: int = 0


class EngineSupervisor:
    """Crash/stall supervision + journaled replay over an LLMEngine.

    The supervisor exposes the engine's loadgen-facing API (submit /
    step / is_done / cancel / request_timing / finish_reason / release /
    run_until_idle / set_tenant_limits / decode_chunk), with its OWN
    stable request ids: an engine restart invalidates engine rids but
    never supervisor rids, so callers (the scenario runner, streaming
    servers) ride through a crash without renegotiating handles.

    Failure detection is two-pronged, both applied at step granularity
    (the supervisor is driven by the same loop that drives the engine):
      - liveness: engine.step() raising, or an injected `backend_crash`
        event, kills the engine immediately;
      - progress: while work is in flight, some request must deliver a
        token (or finish) every `stall_timeout_s` — a silent card
        ("decode_stall") is detected by absence of progress, exactly the
        signal an operator has when a device wedges.

    Recovery: capped exponential backoff (base doubling up to
    `backoff_cap_s`) before each restart; `max_restarts` consecutive
    failures declare the backend permanently failed, finalizing
    everything in flight as `cancelled` (terminal — never lost). A
    restart that stays up `stability_s` resets the backoff exponent.
    """

    def __init__(self, engine_factory: Callable[[], Any], *,
                 injector=None, shed_policy=None,
                 stall_timeout_s: float = 2.0,
                 stall_min_steps: int = 10,
                 backoff_base_s: float = 0.05,
                 backoff_cap_s: float = 2.0,
                 max_restarts: int = 8,
                 stability_s: float = 10.0,
                 warm: bool = False):
        self._factory = engine_factory
        self.shed_policy = shed_policy
        self.injector = None
        if injector is not None:
            self.arm_faults(injector)
        self.stall_timeout_s = stall_timeout_s
        # a stall must ALSO span this many driven steps without progress:
        # a genuine stall spins many cheap steps, while one long step that
        # ends in a token is a graph capture or a first-use kernel build —
        # elapsed time alone would misread it as a wedged card
        self.stall_min_steps = stall_min_steps
        self.backoff_base_s = backoff_base_s
        self.backoff_cap_s = backoff_cap_s
        self.max_restarts = max_restarts
        self.stability_s = stability_s
        self._warm = warm
        self._lock = threading.RLock()
        self._journal: dict[int, _Journaled] = {}
        self._next_rid = 1
        self._reap: list[int] = []     # engine rids cancelled, not yet done
        self.engine = engine_factory()
        if warm:
            self.engine.warmup()
        self.degraded = False
        self.failed = False            # max_restarts exhausted
        self._consec_failures = 0
        self._restart_at = 0.0
        self._last_progress = time.monotonic()
        self._no_progress_steps = 0
        self._last_crash = 0.0
        self._chunk: int | None = None
        self._tenant_limits = (0, 0)
        # accounting tallies (survive release())
        self.outages: list[dict[str, Any]] = []
        self._counts = {"accepted": 0, "completed": 0, "cancelled": 0,
                        "rejected": 0, "shed": 0, "retried": 0,
                        "replayed": 0, "replay_verified": 0,
                        "replay_mismatch": 0, "restarts": 0}

    # -- faults ---------------------------------------------------------------

    def arm_faults(self, injector) -> "EngineSupervisor":
        """Attach a `chaos.FaultScript` (armed through a new
        `chaos.FaultInjector`) or a fault injector: any object with
        `start()`, `due_one_shots(kind)`, `active(kind)` and
        `clear(event)`. Its clock arms on the first step() after this
        call."""
        if isinstance(injector, FaultScript):
            injector = FaultInjector(injector)
        missing = [m for m in ("start", "due_one_shots", "active", "clear")
                   if not callable(getattr(injector, m, None))]
        if missing:
            raise TypeError(f"a fault injector needs {missing}")
        self.injector = injector
        return self

    # -- submit-side API ------------------------------------------------------

    def submit(self, prompt, max_new_tokens: int = 32,
               temperature: float = 0.0, adapter: str | None = None,
               tenant: str | None = None, seed: int | None = None,
               **kw) -> int:
        with self._lock:
            if self.failed:
                raise QueueFull("backend permanently failed "
                                f"(restart budget {self.max_restarts} "
                                "exhausted)")
            if self.degraded and self.shed_policy is not None \
                    and self.shed_policy.sheds(tenant):
                self._counts["shed"] += 1
                obs_metrics.SCHED_SHED.inc(engine="supervisor")
                obs_metrics.REQUESTS.inc(component="supervisor",
                                         event="shed")
                raise TenantShed(
                    f"degraded mode: tenant {tenant!r} priority "
                    f"{self.shed_policy.priority_of(tenant)} is below the "
                    f"shed threshold {self.shed_policy.shed_below}")
            submit_kw = dict(kw, temperature=temperature, adapter=adapter,
                             tenant=tenant, seed=seed)
            entry = _Journaled(
                rid=self._next_rid, prompt=list(prompt),
                max_new=max_new_tokens, kw=submit_kw, tenant=tenant,
                deterministic=(seed is not None or temperature == 0.0),
                submit_s=time.monotonic())
            if self.engine is not None:
                # propagate admission errors BEFORE journaling: a rejected
                # request was never accepted, so it owes no terminal state
                entry.engine_rid = self.engine.submit(
                    list(prompt), max_new_tokens, **submit_kw)
            # engine down: the journal IS the queue — accepted now,
            # submitted by the restart's replay pass
            self._next_rid += 1
            self._journal[entry.rid] = entry
            self._counts["accepted"] += 1
            obs_metrics.REQUESTS.inc(component="supervisor",
                                     event="accepted")
            return entry.rid

    # -- the drive loop -------------------------------------------------------

    def step(self) -> bool:
        """One supervised engine iteration. Returns False only when the
        engine is alive and idle and nothing is journaled in flight."""
        now = time.monotonic()
        inj = self.injector
        if inj is not None:
            inj.start()   # idempotent: first step after arming is t0
            if self.engine is not None and inj.due_one_shots(
                    "backend_crash"):
                self._kill("injected_crash", now)
        if self.engine is None:
            return self._step_down(now)
        stall = inj.active("decode_stall") if inj is not None else None
        if stall is not None:
            # the card is wedged: no dispatch completes. The watchdog —
            # not the injector — must notice, from absence of progress.
            time.sleep(0.005)
            self._no_progress_steps += 1
            self._watchdog(time.monotonic(), stall)
            return True
        try:
            worked = self.engine.step()
        except Exception as e:   # engine death IS the condition supervised
            self._kill(f"crash: {type(e).__name__}: {e}", now)
            return True
        now = time.monotonic()   # step() may have captured a graph
        before = self._last_progress
        self._poll_outcomes(now)
        self._no_progress_steps = (0 if self._last_progress > before
                                   else self._no_progress_steps + 1)
        if self._watchdog(now, None):
            return True
        if self._consec_failures and self.engine is not None \
                and now - self._last_crash > self.stability_s:
            self._consec_failures = 0   # stable again: backoff resets
        with self._lock:
            inflight = any(not e.terminal for e in self._journal.values())
        return worked or inflight

    def run_until_idle(self) -> None:
        while self.step():
            pass

    # -- death / restart ------------------------------------------------------

    def _kill(self, cause: str, now: float) -> None:
        with self._lock:
            eng, self.engine = self.engine, None
            self._reap.clear()
            for e in self._journal.values():
                if not e.terminal:
                    e.engine_rid = None
            delay = min(self.backoff_cap_s,
                        self.backoff_base_s * (2 ** self._consec_failures))
            self._consec_failures += 1
            self._last_crash = now
            self._restart_at = now + delay
            self.degraded = True
            self.outages.append({"cause": cause, "detected_s": now,
                                 "backoff_s": round(delay, 4),
                                 "recovered_s": None})
            # `cause` is free-form past the first colon ("crash: ..."),
            # so the counter label keeps only the bounded prefix
            obs_metrics.SUPERVISOR_RESTARTS.inc(
                cause=cause.split(":", 1)[0].strip())
            # the engine died before emitting these requests' spans —
            # the journal is the only witness of the original attempt,
            # so the crash-replay chain (attempt → restart → resume)
            # shows up under ONE trace id even though the engine's own
            # retrospective spans never fired
            for e in self._journal.values():
                if not e.terminal:
                    TRACER.record_span(
                        "supervisor.attempt", "supervise",
                        e.kw.get("trace"), e.submit_s, now,
                        outcome="killed", cause=cause, tenant=e.tenant,
                        tokens_delivered=(len(e.base_tokens)
                                          + len(e.tokens)))
            if self._consec_failures > self.max_restarts:
                self.failed = True
                for e in self._journal.values():
                    if not e.terminal:
                        self._finalize(e, "cancelled", now)
        if eng is not None:
            try:
                eng.close()
            except Exception:
                pass   # it is already dead; close() is best-effort

    def _step_down(self, now: float) -> bool:
        """Engine is dead: wait out the backoff, then restart + replay."""
        if self.failed:
            return False
        if now < self._restart_at:
            time.sleep(min(0.005, self._restart_at - now))
            return True
        self._restart()
        return True

    def _restart(self) -> None:
        self._counts["restarts"] += 1
        engine = self._factory()
        if self._warm:
            engine.warmup()
        if self._tenant_limits != (0, 0):
            engine.set_tenant_limits(*self._tenant_limits)
        if self._chunk is not None:
            engine.set_decode_chunk(self._chunk)
        with self._lock:
            self.engine = engine
            for e in sorted((e for e in self._journal.values()
                             if not e.terminal), key=lambda e: e.rid):
                self._replay(e)
            self.degraded = False
            now = time.monotonic()
            self._last_progress = now
            self._no_progress_steps = 0
            if self.outages and self.outages[-1]["recovered_s"] is None:
                o = self.outages[-1]
                o["recovered_s"] = now
                o["mttr_s"] = round(now - o["detected_s"], 4)

    def _replay(self, e: _Journaled) -> None:
        """Resubmit one journaled request on the fresh engine. Deterministic
        requests (seeded or greedy) replay byte-identically from the full
        prompt — the delivered prefix is kept as evidence and verified at
        completion. Unseeded sampled requests cannot replay exactly: the
        original generation is chained `cancelled` → `retried` and a NEW
        generation resumes over prompt + journaled prefix with the
        remaining budget."""
        tr = e.kw.get("trace")
        t0 = time.monotonic()
        TRACER.record_span(
            "supervisor.restart", "restart", tr, self._last_crash, t0,
            cause=(self.outages[-1]["cause"] if self.outages else None),
            restarts=self._counts["restarts"])
        try:
            # a request with ANY delivered tokens (this generation's OR a
            # previous generation's base prefix — a second crash mid-retry
            # must not rewind the client's stream) resumes; only a truly
            # token-less one replays from scratch
            if e.deterministic or not (e.tokens or e.base_tokens):
                mode = "replayed" if e.tokens else "resubmitted"
                if e.tokens:
                    e.verify_prefix = list(e.base_tokens) + list(e.tokens)
                    e.chain.append("replayed")
                    self._counts["replayed"] += 1
                e.base_tokens = []
                e.tokens = list(e.verify_prefix or ())
                e.lps = list(e.base_lps) + list(e.lps)
                e.base_lps = []
                e.engine_seen = 0
                e.engine_rid = self.engine.submit(
                    list(e.prompt), e.max_new, **e.kw)
                TRACER.record_span(
                    "supervisor.resume", "replay", tr, t0,
                    time.monotonic(), mode=mode,
                    replay_tokens=len(e.tokens))
            else:
                done = e.base_tokens + e.tokens
                remaining = e.max_new - len(done)
                if remaining <= 0:
                    e.tokens = done
                    e.base_tokens = []
                    e.lps = list(e.base_lps) + list(e.lps)
                    e.base_lps = []
                    self._finalize(e, "length", time.monotonic())
                    return
                e.chain += ["cancelled", "retried"]
                self._counts["retried"] += 1
                e.base_tokens = done
                e.tokens = []
                e.base_lps = list(e.base_lps) + list(e.lps)
                e.lps = []
                e.engine_seen = 0
                e.engine_rid = self.engine.submit(
                    list(e.prompt) + done, remaining, **e.kw)
                TRACER.record_span(
                    "supervisor.resume", "replay", tr, t0,
                    time.monotonic(), mode="retried",
                    resumed_over=len(done))
        except (QueueFull, ValueError):
            # the replacement engine cannot take it (queue full, or the
            # prompt+prefix resume outgrew the engine's buckets —
            # PromptTooLong is a ValueError): a recorded rejection, never
            # a silent loss, and never an exception that aborts the
            # whole recovery pass mid-replay
            self._finalize(e, "rejected", time.monotonic())

    # -- outcome polling / watchdog -------------------------------------------

    def _poll_outcomes(self, now: float) -> None:
        with self._lock:
            for rid in list(self._reap):
                if self.engine.is_done(rid):
                    self.engine.release(rid)
                    self._reap.remove(rid)
            for e in self._journal.values():
                if e.terminal or e.engine_rid is None:
                    continue
                part = self.engine.partial_result(e.engine_rid)
                if len(part) > e.engine_seen:
                    e.engine_seen = len(part)
                    self._last_progress = now
                # tokens and logprobs advance TOGETHER, to the length
                # both have reached: if the engine's append of token B's
                # logprob is ever observed mid-flight, token B is held
                # back one poll rather than journaled with a fabricated
                # pair — a crash at that instant must not freeze a
                # misaligned (base_tokens, base_lps) prefix into the
                # unseeded-retry path
                part_lp = self.engine.partial_logprobs(e.engine_rid)
                n = min(len(part), len(part_lp))
                if n > len(e.tokens):
                    e.tokens = list(part[:n])
                    e.lps = list(part_lp[:n])
                    if e.first_token_s is None:
                        e.first_token_s = now
                if self.engine.is_done(e.engine_rid):
                    reason = self.engine.finish_reason(e.engine_rid)
                    try:
                        tm = self.engine.request_timing(e.engine_rid)
                        e.phases = {k: tm.get(k) for k in
                                    ("queue_wait_ms", "prefill_ms",
                                     "decode_ms")}
                        e.cached = int(tm.get("cached_prefix_len") or 0)
                    except Exception:
                        pass   # phase detail is best-effort accounting
                    result = (self.engine.result(e.engine_rid)
                              if reason != "cancelled"
                              else self.engine.partial_result(e.engine_rid))
                    if e.verify_prefix is not None:
                        ok = result[:len(e.verify_prefix)] == e.verify_prefix
                        self._counts["replay_verified" if ok
                                     else "replay_mismatch"] += 1
                        e.verify_prefix = None
                    e.tokens = list(result)
                    e.lps = list(self.engine.partial_logprobs(
                        e.engine_rid))[:len(result)]
                    try:
                        e.top_lps = list(
                            self.engine.result_top_logprobs(e.engine_rid))
                    except (ValueError, KeyError):
                        # engine built with logprobs_topk=0, or cancelled
                        # before completion: no alternatives to keep
                        e.top_lps = None
                    self.engine.release(e.engine_rid)
                    e.engine_rid = None
                    self._finalize(e, reason, now)
                    self._last_progress = now

    def _watchdog(self, now: float, stall_event) -> bool:
        """Progress watchdog: work in flight + no token for
        stall_timeout_s = the backend is wedged. Returns True if it
        killed the engine. A stall-triggered restart consumes the
        injected stall window — the replacement engine is 'placed on a
        healthy card'."""
        with self._lock:
            inflight = any(not e.terminal for e in self._journal.values())
        if not inflight:
            self._last_progress = now
            self._no_progress_steps = 0
            return False
        if now - self._last_progress <= self.stall_timeout_s \
                or self._no_progress_steps < self.stall_min_steps:
            return False
        if stall_event is not None and self.injector is not None:
            self.injector.clear(stall_event)
        self._kill("stall: no request progress for "
                   f"{self.stall_timeout_s}s", now)
        return True

    def _finalize(self, e: _Journaled, reason: str, now: float) -> None:
        e.terminal = True
        e.finish_reason = reason
        e.finish_s = now
        if reason in ("stop", "length"):
            self._counts["completed"] += 1
            event = "completed"
        elif reason == "rejected":
            self._counts["rejected"] += 1
            event = "rejected"
        else:
            self._counts["cancelled"] += 1
            event = "cancelled"
        obs_metrics.REQUESTS.inc(component="supervisor", event=event)
        # the supervise span covers the whole journal lifetime — across
        # restarts — with the usage chain as its crash-replay evidence
        TRACER.record_span(
            "supervisor.supervise", "supervise", e.kw.get("trace"),
            e.submit_s, now, tenant=e.tenant, finish_reason=reason,
            chain=list(e.chain),
            n_tokens=len(e.base_tokens) + len(e.tokens))

    # -- request-side API (the engine surface the runner consumes) ------------

    def is_done(self, rid: int) -> bool:
        with self._lock:
            e = self._journal.get(rid)
            return e is None or e.terminal

    def cancel(self, rid: int) -> bool:
        with self._lock:
            e = self._journal.get(rid)
            if e is None or e.terminal:
                return False
            if e.engine_rid is not None and self.engine is not None:
                self.engine.cancel(e.engine_rid)
                self._reap.append(e.engine_rid)
                e.engine_rid = None
            self._finalize(e, "cancelled", time.monotonic())
            return True

    def result(self, rid: int) -> list[int]:
        with self._lock:
            e = self._journal[rid]
            if not e.terminal:
                raise KeyError(f"request {rid} not finished")
            return list(e.base_tokens) + list(e.tokens)

    def partial_result(self, rid: int) -> list[int]:
        with self._lock:
            e = self._journal.get(rid)
            if e is None:
                return []
            return list(e.base_tokens) + list(e.tokens)

    def partial_logprobs(self, rid: int) -> list[float]:
        """Logprobs of partial_result(rid), journaled alongside the
        tokens — never longer than the token list, so the SSE pairing
        guard in llm_runtime keeps working through a restart."""
        with self._lock:
            e = self._journal.get(rid)
            if e is None:
                return []
            return list(e.base_lps) + list(e.lps)

    def result_logprobs(self, rid: int) -> list[float]:
        with self._lock:
            e = self._journal[rid]
            if not e.terminal:
                raise KeyError(f"request {rid} not finished")
            return list(e.base_lps) + list(e.lps)

    def result_top_logprobs(self, rid: int) -> list[dict[int, float]]:
        """Top-N alternatives. An unseeded resume pads the pre-crash
        prefix positions with {} — the original generation's
        alternatives died with the engine that sampled them."""
        with self._lock:
            e = self._journal[rid]
            if not e.terminal:
                raise KeyError(f"request {rid} not finished")
            return ([{} for _ in e.base_tokens]
                    + [dict(d) for d in (e.top_lps or ())])

    def finish_reason(self, rid: int) -> str:
        with self._lock:
            e = self._journal.get(rid)
            return (e.finish_reason or "length") if e else "length"

    def usage_chain(self, rid: int) -> list[str]:
        """The request's usage-state chain across restarts: [] for an
        undisturbed request; ["replayed"] for a byte-exact replay;
        ["cancelled", "retried"] for an unseeded resume."""
        with self._lock:
            e = self._journal.get(rid)
            return list(e.chain) if e else []

    def request_timing(self, rid: int) -> dict[str, Any]:
        cached = self.cached_tokens(rid)
        with self._lock:
            e = self._journal[rid]
            phases = dict(e.phases or {})
            return {"submit_s": e.submit_s,
                    "first_token_s": e.first_token_s,
                    "finish_s": e.finish_s, "tenant": e.tenant,
                    "n_tokens": len(e.base_tokens) + len(e.tokens),
                    "prompt_len": len(e.prompt),
                    "cached_prefix_len": cached,
                    "prefill_tokens": len(e.prompt) - cached,
                    "queue_wait_ms": phases.get("queue_wait_ms"),
                    "prefill_ms": phases.get("prefill_ms"),
                    "decode_ms": phases.get("decode_ms")}

    def cached_tokens(self, rid: int) -> int:
        """Prefix-KV tokens the CURRENT engine reused for this request.
        Conservative across restarts: a replayed request re-prefills on
        the fresh engine (whose cache starts cold), so the journal never
        fabricates reuse the replacement engine didn't do."""
        with self._lock:
            e = self._journal.get(rid)
            erid = e.engine_rid if e is not None else None
            eng = self.engine
        if eng is None or erid is None:
            # finished (the engine rid was released at completion) or
            # mid-restart: answer from the journal's completion capture
            # — 0 until then, never fabricated
            return e.cached if e is not None else 0
        fn = getattr(eng, "cached_tokens", None)
        try:
            return int(fn(erid)) if fn is not None else 0
        except Exception:   # engine swapped/released under us: 0, not 500
            return 0

    def release(self, rid: int) -> None:
        with self._lock:
            self._journal.pop(rid, None)

    # -- engine passthroughs --------------------------------------------------

    @property
    def _adapter_idx(self) -> dict[str, int]:
        """The engine's loaded adapters (name -> index); the loadgen
        runner checks a trace's adapters against it before replay."""
        return self.engine._adapter_idx if self.engine is not None else {}

    @property
    def decode_chunk(self) -> int:
        if self.engine is not None:
            return self.engine.decode_chunk
        return self._chunk or 0

    @property
    def decode_chunk_max(self) -> int:
        if self.engine is not None:
            return self.engine.decode_chunk_max
        return self._chunk or 1

    # cache-introspection passthroughs: llm_runtime sniffs these to decide
    # whether the usage object carries cached_tokens at all (engine down
    # reads as cache-off — conservative, never fabricated)
    @property
    def kvcache(self):
        return (getattr(self.engine, "kvcache", None)
                if self.engine is not None else None)

    @property
    def prefix_cache_enabled(self) -> bool:
        return bool(getattr(self.engine, "prefix_cache_enabled", False)
                    if self.engine is not None else False)

    def set_decode_chunk(self, chunk: int) -> int:
        self._chunk = chunk
        if self.engine is not None:
            return self.engine.set_decode_chunk(chunk)
        return chunk

    def set_tenant_limits(self, max_active_per_tenant: int = 0,
                          max_queued_per_tenant: int = 0) -> None:
        """The engine's tenant limits, kept here and applied again to
        every restarted engine."""
        self._tenant_limits = (max_active_per_tenant, max_queued_per_tenant)
        if self.engine is not None:
            self.engine.set_tenant_limits(*self._tenant_limits)

    def metrics(self) -> dict[str, Any]:
        out = dict(self.engine.metrics()) if self.engine is not None else {}
        out["supervisor"] = self.accounting()
        return out

    def close(self) -> None:
        if self.engine is not None:
            self.engine.close()
            self.engine = None

    # -- the zero-lost contract -----------------------------------------------

    def accounting(self) -> dict[str, Any]:
        """The committed chaos record: every accepted request must be
        accounted terminal — `lost` MUST be 0 once the run drains."""
        with self._lock:
            c = dict(self._counts)
            inflight = sum(1 for e in self._journal.values()
                           if not e.terminal)
            journal_depth = len(self._journal)
        terminal = c["completed"] + c["cancelled"] + c["rejected"]
        mttrs = [o["mttr_s"] for o in self.outages
                 if o.get("mttr_s") is not None]
        return {
            **c,
            "in_flight": inflight,
            "terminal": terminal,
            "lost": c["accepted"] - terminal - inflight,
            "outages": [dict(o) for o in self.outages],
            "mttr_s": (round(sum(mttrs) / len(mttrs), 4)
                       if mttrs else None),
            # the /healthz supervisor section: the
            # controller's dead-replica pruning and fleet tooling read
            # these without a model round-trip
            "permanent_failed": self.failed,
            "last_mttr_s": mttrs[-1] if mttrs else None,
            "journal_depth": journal_depth,
        }
