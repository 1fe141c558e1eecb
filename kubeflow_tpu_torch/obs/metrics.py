"""The serving plane's instruments (counterpart of kubeflow_tpu/obs/
metrics.py over kubeflow_tpu/utils/metrics.py): one process-wide
registry, every serving metric declared here under the JAX package's
name and label set, so a scrape of either server shows the same series.

Text exposition only (the Prometheus scrape format), no client library:
counters, gauges and cumulative-bucket histograms, thread-safe.
`render_metrics()` is the one scrape path `GET /metrics` serves. Pull-model
gauges (queue depth, KV free blocks, SLO burn) come from scrape hooks:
live objects register a callback that refreshes their gauges just before
each render, held through a weakref, so a dropped engine cannot keep
itself alive or poison a later scrape.
"""

from __future__ import annotations

import threading
import weakref
from typing import Any, Callable, Iterable


def _escape(value: str) -> str:
    """Label-value escaping per the text exposition format."""
    return (str(value).replace("\\", r"\\").replace('"', r'\"')
            .replace("\n", r"\n"))


def _fmt_labels(labels: dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_escape(v)}"' for k, v in sorted(labels.items()))
    return "{" + inner + "}"


def _fmt_value(value: float) -> str:
    """Full-precision exposition (the %g shortcut corrupts counters past
    1e6): integers render bare, floats via repr."""
    if value == int(value) and abs(value) < 2**53:
        return str(int(value))
    return repr(float(value))


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, help_: str, label_names: Iterable[str]):
        self.name = name
        self.help = help_
        self.label_names = tuple(label_names)
        self._lock = threading.Lock()
        self._values: dict[tuple[str, ...], float] = {}

    def _key(self, labels: dict[str, str]) -> tuple[str, ...]:
        if set(labels) != set(self.label_names):
            raise ValueError(
                f"{self.name}: labels {sorted(labels)} != declared "
                f"{sorted(self.label_names)}")
        return tuple(str(labels[k]) for k in self.label_names)

    def _labeled(self, key: tuple[str, ...]) -> dict[str, str]:
        return dict(zip(self.label_names, key))

    def samples(self) -> list[tuple[str, dict[str, str], float]]:
        with self._lock:
            return [(self.name, self._labeled(k), v)
                    for k, v in sorted(self._values.items())]

    def render(self) -> str:
        lines = [f"# HELP {self.name} {self.help}",
                 f"# TYPE {self.name} {self.kind}"]
        for name, labels, value in self.samples():
            lines.append(f"{name}{_fmt_labels(labels)} {_fmt_value(value)}")
        return "\n".join(lines)


class Counter(_Metric):
    kind = "counter"

    def inc(self, amount: float = 1.0, **labels: str) -> None:
        key = self._key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

class Gauge(_Metric):
    kind = "gauge"

    def set(self, value: float, **labels: str) -> None:
        key = self._key(labels)
        with self._lock:
            self._values[key] = float(value)


class Histogram(_Metric):
    """Cumulative-bucket histogram (the prometheus shape: _bucket{le=},
    _sum, _count)."""

    kind = "histogram"
    DEFAULT_BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 10.0,
                       30.0, 60.0)

    def __init__(self, name, help_, label_names, buckets=None):
        super().__init__(name, help_, label_names)
        self.buckets = tuple(sorted(buckets or self.DEFAULT_BUCKETS))
        self._counts: dict[tuple[str, ...], list[int]] = {}
        self._sums: dict[tuple[str, ...], float] = {}
        self._totals: dict[tuple[str, ...], int] = {}

    def observe(self, value: float, **labels: str) -> None:
        key = self._key(labels)
        with self._lock:
            counts = self._counts.setdefault(key, [0] * len(self.buckets))
            for i, b in enumerate(self.buckets):
                if value <= b:
                    counts[i] += 1
            self._sums[key] = self._sums.get(key, 0.0) + value
            self._totals[key] = self._totals.get(key, 0) + 1

    def render(self) -> str:
        lines = [f"# HELP {self.name} {self.help}",
                 f"# TYPE {self.name} {self.kind}"]
        with self._lock:
            for key in sorted(self._totals):
                base = self._labeled(key)
                for i, b in enumerate(self.buckets):
                    lines.append(
                        f"{self.name}_bucket"
                        f"{_fmt_labels({**base, 'le': f'{b:g}'})} "
                        f"{self._counts[key][i]}")
                lines.append(
                    f"{self.name}_bucket{_fmt_labels({**base, 'le': '+Inf'})}"
                    f" {self._totals[key]}")
                lines.append(f"{self.name}_sum{_fmt_labels(base)} "
                             f"{_fmt_value(self._sums[key])}")
                lines.append(f"{self.name}_count{_fmt_labels(base)} "
                             f"{self._totals[key]}")
        return "\n".join(lines)


class Registry:
    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict[str, _Metric] = {}

    def _get_or_make(self, cls, name: str, help_: str, label_names,
                     **kwargs) -> Any:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, help_, label_names or (), **kwargs)
                self._metrics[name] = m
                return m
            if not isinstance(m, cls):
                raise ValueError(f"{name} already registered as {m.kind}")
            if m.label_names != tuple(label_names or ()):
                raise ValueError(
                    f"{name} already registered with labels "
                    f"{list(m.label_names)}, not {list(label_names or ())}")
            buckets = kwargs.get("buckets")
            if buckets is not None and tuple(sorted(buckets)) != m.buckets:
                raise ValueError(
                    f"{name} already registered with buckets {m.buckets}")
            return m

    def counter(self, name, help_="", label_names=()) -> Counter:
        return self._get_or_make(Counter, name, help_, label_names)

    def gauge(self, name, help_="", label_names=()) -> Gauge:
        return self._get_or_make(Gauge, name, help_, label_names)

    def histogram(self, name, help_="", label_names=(),
                  buckets=None) -> Histogram:
        return self._get_or_make(Histogram, name, help_, label_names,
                                 buckets=buckets)

    def render(self) -> str:
        with self._lock:
            metrics = list(self._metrics.values())
        return "\n".join(m.render() for m in metrics) + "\n"


REGISTRY = Registry()

# -- explicit latency buckets (seconds) ---------------------------------------
# TTFT spans queue+prefill: sub-10ms cache hits through multi-second
# cold chunked prefills. TPOT is per-token: sub-ms kernel steps through
# ~1s interpret-mode smoke steps. Queue-wait shares TTFT's shape but
# needs the sub-ms floor for idle-engine admissions.
TTFT_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5,
                5.0, 10.0, 30.0)
TPOT_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                0.5, 1.0, 2.5)
QUEUE_WAIT_BUCKETS = (0.0005, 0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0,
                      5.0, 30.0)

# -- request lifecycle (every layer, one name) --------------------------------
REQUESTS = REGISTRY.counter(
    "serving_requests_total",
    "Request lifecycle events across serving layers",
    ["component", "event"])
TTFT_SECONDS = REGISTRY.histogram(
    "serving_ttft_seconds", "Submit to first token", ["component"],
    buckets=TTFT_BUCKETS)
TPOT_SECONDS = REGISTRY.histogram(
    "serving_tpot_seconds", "Per-token decode latency (per request)",
    ["component"], buckets=TPOT_BUCKETS)
QUEUE_WAIT_SECONDS = REGISTRY.histogram(
    "serving_queue_wait_seconds", "Submit to prefill dispatch",
    ["component"], buckets=QUEUE_WAIT_BUCKETS)
INFLIGHT = REGISTRY.gauge(
    "serving_inflight", "Live requests per component", ["component"])

# -- HTTP frontends -----------------------------------------------------------
HTTP_REQUESTS = REGISTRY.counter(
    "serving_http_requests_total", "Frontend requests by model and verb",
    ["model", "verb"])
HTTP_LATENCY = REGISTRY.histogram(
    "serving_http_request_seconds", "Frontend request wall",
    ["model", "verb"])
MODEL_READY = REGISTRY.gauge(
    "serving_model_ready", "1 = model loaded and ready", ["model"])
MODEL_LOAD_SECONDS = REGISTRY.histogram(
    "serving_model_load_seconds", "Model load() wall", ["model"])

# -- supervisor ---------------------------------------------------------------
SUPERVISOR_RESTARTS = REGISTRY.counter(
    "supervisor_restarts_total", "Engine restarts by detected cause",
    ["cause"])

# -- kv/prefix cache ----------------------------------------------------------
PREFIX_EVENTS = REGISTRY.counter(
    "kvcache_prefix_events_total",
    "Radix prefix-cache events (hit/miss/insert/evict)", ["event"])
KV_FREE_BLOCKS = REGISTRY.gauge(
    "kvcache_free_blocks",
    "Allocatable KV blocks currently free (paged: pool free list; "
    "slab: radix store headroom)", ["engine"])
KV_WATERMARK_FRAC = REGISTRY.gauge(
    "kvcache_watermark_frac",
    "Free fraction of allocatable KV capacity (the paged admission "
    "signal: 1.0 = empty, 0.0 = fully committed)", ["engine"])

# -- attention impls (scrape-hook fed) ----------------------------------------
ATTENTION_IMPL = REGISTRY.gauge(
    "serving_attention_impl_info",
    "Resolved attention impl per engine phase (info-style: one series "
    "per (engine, phase=prefill|decode, impl=xla|flash), value 1)",
    ["engine", "phase", "impl"])

# -- scheduler (scrape-hook fed) ----------------------------------------------
SCHED_QUEUED = REGISTRY.gauge(
    "scheduler_queued", "Requests waiting for admission", ["engine"])
SCHED_ACTIVE = REGISTRY.gauge(
    "scheduler_active", "Requests holding decode slots", ["engine"])
SCHED_SHED = REGISTRY.counter(
    "scheduler_shed_total", "Requests shed by degraded-mode policy",
    ["engine"])
# -- SLO burn (scrape-hook fed from SloBurnTracker) ---------------------------
SLO_ATTAINMENT = REGISTRY.gauge(
    "slo_attainment", "Windowed SLO attainment per tenant", ["tenant"])
SLO_BURN_RATE = REGISTRY.gauge(
    "slo_burn_rate",
    "Windowed error-budget burn multiplier per tenant (1.0 = burning "
    "exactly the budget)", ["tenant"])

# -- tracing self-observation -------------------------------------------------
TRACE_BUFFER_SPANS = REGISTRY.gauge(
    "trace_buffer_spans", "Spans currently held in the ring buffer", [])
TRACE_SPANS_DROPPED = REGISTRY.gauge(
    "trace_spans_dropped_total", "Spans evicted from the full ring "
    "buffer since last clear", [])

# -- scrape hooks -------------------------------------------------------------

_hooks_lock = threading.Lock()
_hooks: list[tuple[weakref.ref, Callable[[Any], None]]] = []


def add_scrape_hook(owner: Any, fn: Callable[[Any], None]) -> None:
    """Refresh-before-render callback: ``fn(owner)`` runs on every
    ``render_metrics()``. Held via weakref to ``owner`` — when the owner
    is collected the hook silently unregisters, so short-lived engines
    in tests cannot accumulate."""
    with _hooks_lock:
        _hooks.append((weakref.ref(owner), fn))


def remove_scrape_hooks(owner: Any) -> None:
    with _hooks_lock:
        _hooks[:] = [(r, f) for r, f in _hooks if r() is not owner]


def run_scrape_hooks() -> None:
    with _hooks_lock:
        live = [(r, f) for r, f in _hooks if r() is not None]
        _hooks[:] = live
        snapshot = list(live)
    for ref, fn in snapshot:
        owner = ref()
        if owner is None:
            continue
        try:
            fn(owner)
        except Exception:
            # a dying component must not take the scrape down with it
            pass


def render_metrics() -> str:
    """THE scrape path: refresh pull-model gauges, then render the one
    process registry as Prometheus text."""
    from kubeflow_tpu_torch.obs.trace import TRACER

    run_scrape_hooks()
    TRACE_BUFFER_SPANS.set(len(TRACER.sink))
    TRACE_SPANS_DROPPED.set(TRACER.sink.dropped)
    return REGISTRY.render()
