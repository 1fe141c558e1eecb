"""Online SLO burn accounting (counterpart of kubeflow_tpu/obs/slo.py):
sliding-window per-tenant TTFT/TPOT attainment and error-budget burn
rate, scored request by request with the replay accounting's predicate
(`loadgen.slo.request_meets`), so the online and offline surfaces can
never drift.

Burn rate is the SRE definition: with an error budget ``budget`` (the
tolerated miss fraction, default 1%), ``burn = miss_rate / budget``; 1.0
means the tenant consumes its budget exactly at the wall-clock rate.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict, deque
from typing import Any

from kubeflow_tpu_torch.loadgen.slo import request_meets

#: aggregate pseudo-tenant key in summaries and gauge labels
AGGREGATE = "_aggregate"


class SloBurnTracker:
    """Bounded sliding-window attainment/burn per tenant.

    Tenant cardinality is LRU-capped (``max_tenants``, the engine's
    MAX_TENANTS precedent) and each window holds at most
    ``max_samples`` — an adversarial tenant flood degrades precision,
    never memory."""

    def __init__(self, ttft_slo_ms: float = 2000.0,
                 tpot_slo_ms: float = 200.0, window_s: float = 300.0,
                 budget: float = 0.01, max_tenants: int = 256,
                 max_samples: int = 4096):
        self.ttft_slo_ms = float(ttft_slo_ms)
        self.tpot_slo_ms = float(tpot_slo_ms)
        self.window_s = float(window_s)
        self.budget = max(1e-6, float(budget))
        self.max_tenants = max(1, int(max_tenants))
        self.max_samples = max(16, int(max_samples))
        self._lock = threading.Lock()
        #: tenant -> deque[(t_mono, met: bool, ttft_ms, tpot_ms)]
        self._win: OrderedDict[str, deque] = OrderedDict()

    def record(self, tenant: str | None, ttft_ms: float | None,
               tpot_ms: float | None, completed: bool = True,
               now: float | None = None) -> bool:
        """Score one finished request; returns whether it met SLO."""
        met = request_meets(ttft_ms, tpot_ms,
                            ttft_slo_ms=self.ttft_slo_ms,
                            tpot_slo_ms=self.tpot_slo_ms,
                            completed=completed)
        t = time.monotonic() if now is None else now
        key = tenant or "default"
        with self._lock:
            win = self._win.get(key)
            if win is None:
                win = deque(maxlen=self.max_samples)
                self._win[key] = win
                while len(self._win) > self.max_tenants:
                    self._win.popitem(last=False)   # LRU: oldest tenant
            else:
                self._win.move_to_end(key)
            win.append((t, met, ttft_ms, tpot_ms))
        return met

    def _prune(self, win: deque, now: float) -> None:
        cutoff = now - self.window_s
        while win and win[0][0] < cutoff:
            win.popleft()

    @staticmethod
    def _reduce(samples: list, budget: float) -> dict[str, Any]:
        n = len(samples)
        met = sum(1 for s in samples if s[1])
        attainment = round(met / n, 4) if n else None
        burn = (round((1.0 - met / n) / budget, 3) if n else None)
        ttfts = sorted(s[2] for s in samples if s[2] is not None)
        worst = round(ttfts[-1], 3) if ttfts else None
        return {"n": n, "met": met, "attainment": attainment,
                "burn_rate": burn, "worst_ttft_ms": worst}

    def summary(self, now: float | None = None) -> dict[str, Any]:
        """The /healthz ``slo`` section: per-tenant window stats plus
        the aggregate, under the window/SLO config that produced them."""
        t = time.monotonic() if now is None else now
        with self._lock:
            per: dict[str, list] = {}
            for tenant, win in self._win.items():
                self._prune(win, t)
                if win:
                    per[tenant] = list(win)
        all_samples = [s for ss in per.values() for s in ss]
        return {
            "window_s": self.window_s,
            "slo": {"ttft_ms": self.ttft_slo_ms,
                    "tpot_ms": self.tpot_slo_ms,
                    "error_budget": self.budget},
            "aggregate": self._reduce(all_samples, self.budget),
            "tenants": {tenant: self._reduce(ss, self.budget)
                        for tenant, ss in sorted(per.items())},
        }

    def publish(self, _owner: Any = None) -> None:
        """Scrape hook body: refresh the slo_* gauges from the live
        window (obs.metrics.add_scrape_hook(tracker, SloBurnTracker.
        publish) wires it)."""
        from kubeflow_tpu_torch.obs import metrics as m

        s = self.summary()
        agg = s["aggregate"]
        if agg["attainment"] is not None:
            m.SLO_ATTAINMENT.set(agg["attainment"], tenant=AGGREGATE)
            m.SLO_BURN_RATE.set(agg["burn_rate"], tenant=AGGREGATE)
        for tenant, row in s["tenants"].items():
            if row["attainment"] is not None:
                m.SLO_ATTAINMENT.set(row["attainment"], tenant=tenant)
                m.SLO_BURN_RATE.set(row["burn_rate"], tenant=tenant)
