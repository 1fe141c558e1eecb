"""Per-tenant SLO accounting — pure math over replay records.

Deliberately engine-free: the runner produces `RequestRecord`s and this
module reduces them, so the arithmetic is verifiable against a
hand-computed miniature trace. Definitions, chosen to be computable by hand:

- TTFT = first_token_s - arrival_s: measured from the SCHEDULED arrival
  (an arrival submitted late because the engine was busy still waited —
  same convention as the runner's).
- TPOT = (finish_s - first_token_s) / (n_tokens - 1) for n_tokens >= 2.
- A request MEETS SLO iff it completed normally ("stop"/"length"),
  TTFT <= ttft_slo_ms, and (n_tokens < 2 or TPOT <= tpot_slo_ms).
- slo_attainment = met / (offered - client_cancelled): rejected requests
  count against the tenant's attainment (admission failures are SLO
  misses from the client's view); requests the CLIENT abandoned are
  excluded from the denominator (their outcome was the client's choice).
- throughput counts every delivered token (including partial output of
  cancelled requests); goodput counts only tokens of SLO-met requests —
  the gap between the two is the cancellation-storm / SLO-miss waste.
- saturation = delivered_tokens / offered_tokens (demand coverage).
- fairness (aggregate): Jain's index and the max-min ratio over
  per-tenant service ratios (delivered/offered), tenants with demand
  only. 1.0 = perfectly even service relative to demand.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Iterable, Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class RequestRecord:
    """Outcome of one replayed trace request (times relative to run
    start, seconds)."""
    index: int
    tenant: str
    arrival_s: float
    max_new_tokens: int
    adapter: str | None = None
    submit_s: float | None = None       # None = never reached the engine
    first_token_s: float | None = None
    finish_s: float | None = None
    n_tokens: int = 0
    #: stop|length|cancelled|rejected|unsubmitted — "rejected" means
    #: admission control fired; "unsubmitted" means the replay's wall
    #: budget ran out first (only on timed_out runs). Both count against
    #: SLO attainment; only "rejected" counts in the rejected column.
    finish_reason: str = "rejected"
    client_cancelled: bool = False      # the trace said the client left

    @property
    def rejected(self) -> bool:
        return self.finish_reason == "rejected"

    @property
    def completed(self) -> bool:
        return self.finish_reason in ("stop", "length")

    def ttft_ms(self) -> float | None:
        if self.first_token_s is None:
            return None
        return (self.first_token_s - self.arrival_s) * 1e3

    def tpot_ms(self) -> float | None:
        if (self.first_token_s is None or self.finish_s is None
                or self.n_tokens < 2):
            return None
        return ((self.finish_s - self.first_token_s)
                / (self.n_tokens - 1)) * 1e3

    def meets_slo(self, ttft_slo_ms: float, tpot_slo_ms: float) -> bool:
        return request_meets(self.ttft_ms(), self.tpot_ms(),
                             ttft_slo_ms=ttft_slo_ms,
                             tpot_slo_ms=tpot_slo_ms,
                             completed=self.completed)


def request_meets(ttft_ms: float | None, tpot_ms: float | None, *,
                  ttft_slo_ms: float, tpot_slo_ms: float,
                  completed: bool = True) -> bool:
    """THE SLO predicate (module docstring bullet 3), shared by the
    offline record reduction above and the online burn tracker
    (obs/slo.py) so the two surfaces can never drift: completed
    normally, TTFT within bound, and TPOT within bound when defined
    (single-token requests have no TPOT)."""
    if not completed:
        return False
    if ttft_ms is None or ttft_ms > ttft_slo_ms:
        return False
    return tpot_ms is None or tpot_ms <= tpot_slo_ms


def _pct(vals: Sequence[float], q: float) -> float | None:
    if not vals:
        return None
    return round(float(np.percentile(np.asarray(vals, np.float64), q)), 3)


def _tenant_summary(recs: list[RequestRecord], ttft_slo_ms: float,
                    tpot_slo_ms: float, duration_s: float
                    ) -> dict[str, Any]:
    offered = len(recs)
    client_cancelled = sum(r.client_cancelled for r in recs)
    rejected = sum(r.rejected for r in recs)
    completed = sum(r.completed for r in recs)
    met = sum(r.meets_slo(ttft_slo_ms, tpot_slo_ms) for r in recs)
    delivered = sum(r.n_tokens for r in recs)
    offered_tok = sum(r.max_new_tokens for r in recs)
    good_tok = sum(r.n_tokens for r in recs
                   if r.meets_slo(ttft_slo_ms, tpot_slo_ms))
    ttfts = [t for r in recs if (t := r.ttft_ms()) is not None]
    tpots = [t for r in recs if (t := r.tpot_ms()) is not None]
    denom = offered - client_cancelled
    return {
        "offered": offered,
        "completed": completed,
        "rejected": rejected,
        "client_cancelled": client_cancelled,
        "slo_met": met,
        "slo_attainment": round(met / denom, 4) if denom else None,
        "ttft_p50_ms": _pct(ttfts, 50),
        "ttft_p95_ms": _pct(ttfts, 95),
        "tpot_p50_ms": _pct(tpots, 50),
        "tokens_delivered": delivered,
        "tokens_offered": offered_tok,
        "service_ratio": (round(delivered / offered_tok, 4)
                          if offered_tok else None),
        "goodput_tok_per_s": round(good_tok / duration_s, 2),
        "throughput_tok_per_s": round(delivered / duration_s, 2),
    }


def jain_index(xs: Sequence[float]) -> float | None:
    """Jain's fairness index: (Σx)² / (n·Σx²); 1.0 = perfectly even,
    1/n = one party gets everything."""
    xs = [float(x) for x in xs]
    if not xs:
        return None
    sq = sum(x * x for x in xs)
    if sq == 0:
        return 1.0   # nobody got anything: even, in the degenerate sense
    return round(sum(xs) ** 2 / (len(xs) * sq), 4)


def summarize(records: Iterable[RequestRecord], *, ttft_slo_ms: float,
              tpot_slo_ms: float, duration_s: float) -> dict[str, Any]:
    """Reduce replay records into the committed scenario summary:
    per-tenant SLO table + aggregate fairness/saturation/goodput."""
    recs = list(records)
    by_tenant: dict[str, list[RequestRecord]] = {}
    for r in recs:
        by_tenant.setdefault(r.tenant, []).append(r)
    per_tenant = {t: _tenant_summary(rs, ttft_slo_ms, tpot_slo_ms,
                                     duration_s)
                  for t, rs in sorted(by_tenant.items())}
    ratios = [s["service_ratio"] for s in per_tenant.values()
              if s["service_ratio"] is not None]
    # ONE code path for the shared arithmetic: the aggregate is the
    # all-records tenant summary under its committed key names, plus the
    # cross-tenant fairness that only exists at this level — so the
    # attainment/goodput definitions can never diverge between tables
    whole = _tenant_summary(recs, ttft_slo_ms, tpot_slo_ms, duration_s)
    aggregate = {
        "n_requests": whole["offered"],
        "completed": whole["completed"],
        "rejected": whole["rejected"],
        "client_cancelled": whole["client_cancelled"],
        "slo_attainment": whole["slo_attainment"],
        "ttft_p50_ms": whole["ttft_p50_ms"],
        "ttft_p95_ms": whole["ttft_p95_ms"],
        "throughput_tok_per_s": whole["throughput_tok_per_s"],
        "goodput_tok_per_s": whole["goodput_tok_per_s"],
        "saturation": whole["service_ratio"],
        "fairness_jain": jain_index(ratios),
        "fairness_min_over_max": (
            round(min(ratios) / max(ratios), 4)
            if ratios and max(ratios) > 0 else None),
        "slo": {"ttft_ms": ttft_slo_ms, "tpot_ms": tpot_slo_ms},
    }
    return {"aggregate": aggregate, "per_tenant": per_tenant}
