"""Dynamic batching (the port's copy of kubeflow_tpu/serving/batching.py,
the kserve agent batcher / Triton dynamic-batching analog).

`DynamicBatcher` coalesces concurrent predict calls into one model call:
callers block until `max_batch_size` requests queue up or
`max_latency_ms` passes, then one worker concatenates the payloads along
axis 0 (`_stack`: a dict of arrays key by key, or arrays), runs the
model once, and splits the result back by each request's row count
(`_unstack`). A batch whose payloads cannot be stacked runs request by
request, so one malformed payload fails only its own caller. The
server wraps a model's predict in one when its config asks for it
(`batching: {maxBatchSize, maxLatencyMs}`).
"""

from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np


@dataclass
class _Pending:
    payload: Any
    done: threading.Event = field(default_factory=threading.Event)
    result: Any = None
    error: Exception | None = None


class DynamicBatcher:
    def __init__(self, fn: Callable[[Any], Any], max_batch_size: int = 16,
                 max_latency_ms: float = 5.0):
        if max_batch_size < 1:
            raise ValueError("max_batch_size must be >= 1")
        self.fn = fn
        self.max_batch_size = max_batch_size
        self.max_latency = max_latency_ms / 1000.0
        self._q: queue.Queue[_Pending | None] = queue.Queue()
        self._stopped = False
        self._stop_lock = threading.Lock()
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name="dynamic-batcher")
        self._worker.start()

    @classmethod
    def from_config(cls, fn: Callable[[Any], Any],
                    cfg: dict[str, Any]) -> "DynamicBatcher":
        """A batcher from a model's serving config entry {maxBatchSize
        (16), maxLatencyMs (5.0)}, the keys the servers take."""
        return cls(fn, max_batch_size=int(cfg.get("maxBatchSize", 16)),
                   max_latency_ms=float(cfg.get("maxLatencyMs", 5.0)))

    def __call__(self, payload: Any) -> Any:
        p = _Pending(payload)
        # enqueue under the stop lock so no request can slip in after the
        # stop sentinel (it would block its caller forever)
        with self._stop_lock:
            if self._stopped:
                raise RuntimeError("batcher stopped")
            self._q.put(p)
        p.done.wait()
        if p.error is not None:
            raise p.error
        return p.result

    def stop(self) -> None:
        with self._stop_lock:
            if self._stopped:
                return
            self._stopped = True
            self._q.put(None)
        self._worker.join(timeout=5)
        # fail anything enqueued before the sentinel but never processed
        saw_sentinel = False
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                break
            if item is None:
                saw_sentinel = True
                continue
            item.error = RuntimeError("batcher stopped")
            item.done.set()
        if saw_sentinel and self._worker.is_alive():
            # join timed out mid-batch and the drain ate the sentinel — put it
            # back so the worker exits instead of blocking on get() forever
            self._q.put(None)

    # -- worker ---------------------------------------------------------------

    def _collect(self) -> list[_Pending] | None:
        first = self._q.get()
        if first is None:
            return None
        batch = [first]
        until = time.monotonic() + self.max_latency
        while len(batch) < self.max_batch_size:
            remaining = until - time.monotonic()
            if remaining <= 0:
                break
            try:
                item = self._q.get(timeout=remaining)
            except queue.Empty:
                break
            if item is None:
                self._q.put(None)   # re-signal stop for the outer loop
                break
            batch.append(item)
        return batch

    def _run(self) -> None:
        while True:
            batch = self._collect()
            if batch is None:
                return
            try:
                stacked, sizes = _stack([p.payload for p in batch])
            except Exception:
                # one malformed payload must not poison co-batched requests:
                # fall back to per-request execution
                for p in batch:
                    try:
                        p.result = self.fn(p.payload)
                    except Exception as e:
                        p.error = e
                    p.done.set()
                continue
            try:
                results = self.fn(stacked)
                parts = _unstack(results, sizes)
                for p, r in zip(batch, parts):
                    p.result = r
            except Exception as e:
                for p in batch:
                    p.error = e
            finally:
                for p in batch:
                    p.done.set()


def _stack(payloads: list[Any]) -> tuple[Any, list[int]]:
    """Concatenate request payloads along axis 0; returns the stacked batch
    plus each request's row count so results scatter back exactly."""
    if isinstance(payloads[0], dict):
        keys = list(payloads[0].keys())
        arrays = [{k: np.asarray(p[k]) for k in keys} for p in payloads]
        sizes = [next(iter(a.values())).shape[0] for a in arrays]
        return ({k: np.concatenate([a[k] for a in arrays]) for k in keys},
                sizes)
    arrays = [np.asarray(p) for p in payloads]
    return np.concatenate(arrays), [a.shape[0] for a in arrays]


def _unstack(result: Any, sizes: list[int]) -> list[Any]:
    offsets = np.cumsum(sizes)[:-1]
    if isinstance(result, dict):
        parts = {k: np.split(np.asarray(v), offsets)
                 for k, v in result.items()}
        return [{k: parts[k][i] for k in parts} for i in range(len(sizes))]
    return list(np.split(np.asarray(result), offsets))
