"""Seeded, deterministic production-traffic trace generator.

A trace is the full client-side story of a workload window: WHO arrives
(tenant, adapter), WHEN (modulated-Poisson arrivals — steady or bursty
diurnal), WITH WHAT (prompt token ids drawn across a heterogeneous length
mixture, per-request output budgets), and WHETHER THE CLIENT STAYS (a
cancellation/disconnect delay for the abandoning fraction). The runner
replays it against a real engine; the SLO math consumes the outcome.

Determinism is a hard contract: the same `TraceConfig` (same seed)
produces a BYTE-IDENTICAL trace in any process on any platform and with
any library versions — every draw derives from a self-contained
splitmix64 stream (`_SplitMix`, the same finalizer the serving seed fold
uses; numpy Generator distribution streams are explicitly NOT versioned
across numpy releases, so they cannot back a committed-artifact
contract), every libm-dependent comparison (thinning acceptance, Zipf
cumulative weights) is quantized before use so last-ulp sin/log/pow
differences between platforms cannot flip a decision, floats are rounded
at generation time, and `trace_bytes` serializes canonically (sorted
keys, no whitespace). Tests pin the cross-process sha256.

Arrival model: inhomogeneous Poisson via Lewis-Shedler thinning at
rate(t) = base_rate_rps * (1 + burst_amplitude * sin(2π t / burst_period_s
+ burst_phase)); burst_amplitude 0 is plain Poisson. Tenant and adapter
popularity are Zipf-skewed (weight ∝ 1/rank^skew) — the many-user fleets
this suite exists to exercise are never uniform.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import math
from typing import Any, Sequence

_MASK64 = (1 << 64) - 1


class _SplitMix:
    """Self-contained 64-bit PRNG (splitmix64) with the handful of
    inverse-CDF draws the generator needs. Exists so the byte-identity
    contract depends on NOTHING but this file: numpy's Generator
    distribution methods are exempt from stream-stability guarantees
    across numpy releases, which would silently invalidate committed
    trace_sha256 evidence on an environment bump."""

    def __init__(self, seed: int):
        self._s = int(seed) & _MASK64

    def _next(self) -> int:
        self._s = (self._s + 0x9E3779B97F4A7C15) & _MASK64
        z = self._s
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
        return (z ^ (z >> 31)) & _MASK64

    def random(self) -> float:
        """Uniform in [0, 1) with 53 bits — exact in a double, so the
        value is bit-identical everywhere (pure integer ops + one exact
        scale)."""
        return (self._next() >> 11) * (1.0 / (1 << 53))

    def exponential(self, scale: float) -> float:
        return -math.log(1.0 - self.random()) * scale

    def uniform(self, lo: float, hi: float) -> float:
        return lo + (hi - lo) * self.random()

    def integers(self, lo: int, hi: int) -> int:
        """Uniform integer in [lo, hi) via rejection-free modulo of a
        64-bit draw (bias < 2^-40 for any range here; exact integer
        ops, so platform-stable)."""
        return lo + self._next() % (hi - lo)

    def choice(self, cum_weights: Sequence[float]) -> int:
        """Index into a quantized cumulative-weight table (see
        _cum_weights — quantization happens THERE, once)."""
        u = self.random()
        for i, c in enumerate(cum_weights):
            if u < c:
                return i
        return len(cum_weights) - 1


@dataclasses.dataclass(frozen=True)
class TraceRequest:
    """One replayable client request. `session` is the stable affinity
    key of the multi-turn conversation this request belongs to (the
    shared_prefix family sets it; None elsewhere). The in-process
    scenario runner drives a single engine, where reuse is purely
    content-based — session rides the trace for HTTP-fleet replays
    (set it as the request's `session` body field / X-Session-Key so
    the router's rendezvous affinity sees the grouping; the affinity
    path belongs to a router, which the port does not have yet)."""
    index: int
    arrival_s: float            # offset from trace start
    tenant: str
    adapter: str | None
    prompt: tuple[int, ...]
    max_new_tokens: int
    cancel_after_s: float | None  # client disconnect delay; None = stays
    session: str | None = None

    def to_json(self) -> dict[str, Any]:
        d = {"i": self.index, "t": self.arrival_s, "tenant": self.tenant,
             "adapter": self.adapter, "prompt": list(self.prompt),
             "max_new": self.max_new_tokens,
             "cancel_after": self.cancel_after_s}
        if self.session is not None:
            # emitted only when set: traces predating the shared_prefix
            # family keep their committed byte-identity (sha256 pins)
            d["session"] = self.session
        return d

    @staticmethod
    def from_json(d: dict[str, Any]) -> "TraceRequest":
        return TraceRequest(d["i"], d["t"], d["tenant"], d["adapter"],
                            tuple(d["prompt"]), d["max_new"],
                            d["cancel_after"], d.get("session"))


@dataclasses.dataclass(frozen=True)
class TraceConfig:
    """Everything the generator needs; every field feeds the byte-identity
    hash, so two configs that differ anywhere produce different traces."""
    seed: int = 0
    duration_s: float = 30.0
    base_rate_rps: float = 2.0
    burst_amplitude: float = 0.0     # 0..1; 0 = plain Poisson
    burst_period_s: float = 20.0
    burst_phase: float = 0.0         # radians
    n_tenants: int = 1
    tenant_skew: float = 1.2         # Zipf exponent over tenant ranks
    adapters: tuple[str, ...] = ()   # () = base model only
    adapter_skew: float = 1.2
    adapter_none_frac: float = 0.25  # fraction of requests on the base
    # prompt-length mixture: (lo, hi, weight) inclusive integer ranges —
    # heterogeneous lengths are what exercise multi-bucket/chunked prefill
    prompt_len_mix: tuple[tuple[int, int, float], ...] = (
        (4, 48, 0.5), (48, 120, 0.3), (120, 240, 0.2))
    output_len: tuple[int, int] = (16, 64)   # inclusive uniform range
    vocab: int = 32000               # prompt ids drawn from [1, vocab)
    cancel_frac: float = 0.0         # fraction of clients that abandon
    cancel_after_s: tuple[float, float] = (0.2, 2.0)
    ttft_slo_ms: float = 2000.0      # SLO targets the accounting applies
    tpot_slo_ms: float = 500.0
    # -- shared_prefix / multi-turn chat family (the kvcache tentpole's
    # honest workload): n_templates > 0 switches arrivals to SESSIONS —
    # each arrival picks a conversation template (Zipf-skewed over
    # n_templates pre-drawn token sequences of template_len tokens: the
    # system-prompt / few-shot preamble every turn shares), then runs
    # `turns` chat turns. Turn k's prompt is template ++ the
    # accumulated per-turn context (turn_user_len tokens each — the
    # client resending its conversation history), so every later turn
    # extends an earlier prompt exactly the way a radix prefix cache
    # can reuse; turns within a session are spaced by turn_gap_s.
    # Requests carry session="s<arrival_index>" for affinity routing.
    n_templates: int = 0
    template_len: tuple[int, int] = (32, 96)
    template_skew: float = 1.1
    turns: tuple[int, int] = (1, 1)
    turn_user_len: tuple[int, int] = (8, 32)
    turn_gap_s: tuple[float, float] = (0.5, 2.0)
    # -- long_tail family (the paged-KV tentpole's honest workload):
    # long_tail=True replaces BOTH uniform length draws with bounded
    # Pareto (power-law) ones — most requests are short, a heavy tail
    # is 10-50x longer. Exactly the shape that strands slab HBM (every
    # slot is sized for the tail) and that paged block ownership turns
    # into oversubscribed concurrency. tail_alpha is the prompt shape,
    # tail_output_alpha the output-budget shape (lower = heavier);
    # supports are the inclusive [lo, hi] bounds.
    long_tail: bool = False
    tail_alpha: float = 1.1
    tail_prompt_len: tuple[int, int] = (4, 480)
    tail_output_alpha: float = 1.3
    tail_output_len: tuple[int, int] = (1, 256)

    #: shared_prefix-family fields, emitted in to_json only when the
    #: family is enabled: configs (and thus traces) predating it keep
    #: their committed byte-identity / sha256 pins
    _FAMILY_FIELDS = ("n_templates", "template_len", "template_skew",
                      "turns", "turn_user_len", "turn_gap_s")
    #: long_tail-family fields, same emission rule (and so the same
    #: byte-identity story) as the shared_prefix family
    _LT_FIELDS = ("long_tail", "tail_alpha", "tail_prompt_len",
                  "tail_output_alpha", "tail_output_len")

    def to_json(self) -> dict[str, Any]:
        d = dataclasses.asdict(self)
        d["adapters"] = list(self.adapters)
        d["prompt_len_mix"] = [list(m) for m in self.prompt_len_mix]
        d["output_len"] = list(self.output_len)
        d["cancel_after_s"] = list(self.cancel_after_s)
        if self.n_templates > 0:
            d["template_len"] = list(self.template_len)
            d["turns"] = list(self.turns)
            d["turn_user_len"] = list(self.turn_user_len)
            d["turn_gap_s"] = list(self.turn_gap_s)
        else:
            for k in self._FAMILY_FIELDS:
                d.pop(k, None)
        if self.long_tail:
            d["tail_prompt_len"] = list(self.tail_prompt_len)
            d["tail_output_len"] = list(self.tail_output_len)
        else:
            for k in self._LT_FIELDS:
                d.pop(k, None)
        return d

    @staticmethod
    def from_json(d: dict[str, Any]) -> "TraceConfig":
        kw = dict(d)
        kw["adapters"] = tuple(kw.get("adapters", ()))
        kw["prompt_len_mix"] = tuple(
            tuple(m) for m in kw["prompt_len_mix"])
        kw["output_len"] = tuple(kw["output_len"])
        kw["cancel_after_s"] = tuple(kw["cancel_after_s"])
        for k in ("template_len", "turns", "turn_user_len", "turn_gap_s",
                  "tail_prompt_len", "tail_output_len"):
            if k in kw:
                kw[k] = tuple(kw[k])
        return TraceConfig(**kw)

    def replace(self, **kw) -> "TraceConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class Trace:
    config: TraceConfig
    requests: tuple[TraceRequest, ...]

    @property
    def duration_s(self) -> float:
        return self.config.duration_s

    def to_json(self) -> dict[str, Any]:
        return {"version": 1, "config": self.config.to_json(),
                "requests": [r.to_json() for r in self.requests]}

    @staticmethod
    def from_json(d: dict[str, Any]) -> "Trace":
        return Trace(TraceConfig.from_json(d["config"]),
                     tuple(TraceRequest.from_json(r)
                           for r in d["requests"]))


def _cum_weights(weights: Sequence[float]) -> list[float]:
    """Normalized cumulative thresholds, quantized to 9 decimals: the
    weights come from libm pow()/division whose last ulp varies across
    platforms, and an unquantized threshold compared against a uniform
    draw could flip a choice between machines."""
    total = sum(weights)
    cum, acc = [], 0.0
    for w in weights:
        acc += w / total
        cum.append(round(acc, 9))
    cum[-1] = 1.0
    return cum


def _zipf_cum(n: int, skew: float) -> list[float]:
    return _cum_weights([1.0 / (r ** skew) for r in range(1, n + 1)])


def _round6(x: float) -> float:
    """All trace floats are quantized at GENERATION time, so canonical
    JSON round-trips exactly and byte-identity never hinges on repr of a
    full-precision double."""
    return round(float(x), 6)


def _pareto_int(rng: _SplitMix, lo: int, hi: int, alpha: float) -> int:
    """Bounded-Pareto integer draw (inverse CDF) in [lo, hi]. The pow()
    result is quantized before the floor, the same argument as the
    thinning acceptance: a last-ulp libm difference flips the integer
    only when the true value sits within ~1e-16 of a rounding boundary."""
    u = rng.random()
    frac = 1.0 - u * (1.0 - (lo / hi) ** alpha)
    x = round(lo * frac ** (-1.0 / alpha), 6)
    return min(hi, int(x))


def generate_trace(cfg: TraceConfig) -> Trace:
    """Deterministic trace from one seeded PCG64 stream. Draw order is
    part of the format: arrivals first (thinning), then per-request
    fields in a fixed sequence — never reorder without bumping the trace
    version."""
    if cfg.base_rate_rps <= 0 or cfg.duration_s <= 0:
        raise ValueError("base_rate_rps and duration_s must be positive")
    if not 0 <= cfg.burst_amplitude <= 1:
        raise ValueError("burst_amplitude must be in [0, 1]")
    if not 0 <= cfg.cancel_frac <= 1:
        raise ValueError("cancel_frac must be in [0, 1]")
    if cfg.n_tenants < 1:
        raise ValueError("n_tenants must be >= 1")
    if cfg.vocab < 2:
        raise ValueError("vocab must be >= 2")
    for lo, hi, w in cfg.prompt_len_mix:
        if not (1 <= lo <= hi) or w < 0:
            raise ValueError(f"bad prompt_len_mix entry {(lo, hi, w)}")
    if cfg.n_templates < 0:
        raise ValueError("n_templates must be >= 0")
    if cfg.n_templates:
        for name in ("template_len", "turns", "turn_user_len"):
            lo, hi = getattr(cfg, name)
            if not 1 <= lo <= hi:
                raise ValueError(f"bad {name} range {(lo, hi)}")
        if not 0 <= cfg.turn_gap_s[0] <= cfg.turn_gap_s[1]:
            raise ValueError(f"bad turn_gap_s range {cfg.turn_gap_s}")
    if cfg.long_tail:
        if cfg.n_templates:
            raise ValueError(
                "long_tail and shared_prefix families do not compose "
                "(each owns the per-request length draws)")
        if cfg.tail_alpha <= 0 or cfg.tail_output_alpha <= 0:
            raise ValueError("tail alphas must be positive")
        for name in ("tail_prompt_len", "tail_output_len"):
            lo, hi = getattr(cfg, name)
            if not 1 <= lo <= hi:
                raise ValueError(f"bad {name} range {(lo, hi)}")
    rng = _SplitMix(cfg.seed)

    # -- arrivals: Lewis-Shedler thinning against the peak rate
    rate_max = cfg.base_rate_rps * (1.0 + cfg.burst_amplitude)
    arrivals: list[float] = []
    t = 0.0
    while True:
        t += rng.exponential(1.0 / rate_max)
        if t >= cfg.duration_s:
            break
        rate_t = cfg.base_rate_rps * (
            1.0 + cfg.burst_amplitude * math.sin(
                2.0 * math.pi * t / cfg.burst_period_s + cfg.burst_phase))
        # the acceptance ratio is quantized before the compare: sin()
        # (and the log() inside exponential()) differ in the last ulp
        # across libm implementations, and an unquantized near-boundary
        # accept flipping would change the arrival set (and every later
        # draw) between platforms. At 6 decimals a last-ulp (~1e-16
        # relative) difference only matters if the true ratio sits
        # within ~1e-16 of a rounding boundary — ~1e-10 odds per draw,
        # vs certainty without the quantization.
        if rng.random() < round(rate_t / rate_max, 6):
            arrivals.append(t)

    tenant_cum = _zipf_cum(cfg.n_tenants, cfg.tenant_skew)
    adapter_cum = (_zipf_cum(len(cfg.adapters), cfg.adapter_skew)
                   if cfg.adapters else None)
    mix_cum = _cum_weights([w for _, _, w in cfg.prompt_len_mix])

    if cfg.n_templates:
        return Trace(cfg, _shared_prefix_requests(
            cfg, rng, arrivals, tenant_cum, adapter_cum))

    requests = []
    for i, at in enumerate(arrivals):
        tenant = f"t{rng.choice(tenant_cum)}"
        adapter = None
        if cfg.adapters:
            # the draw for "base or adapter" happens EVEN when the result
            # is base-only, keeping the stream alignment independent of
            # the outcome
            use_adapter = rng.random() >= cfg.adapter_none_frac
            a_idx = rng.choice(adapter_cum)
            if use_adapter:
                adapter = cfg.adapters[a_idx]
        if cfg.long_tail:
            # family draw order (part of the format): prompt length,
            # prompt tokens, output budget — one Pareto draw replaces
            # the (bucket, uniform) pair of the base mixture
            plen = _pareto_int(rng, *cfg.tail_prompt_len, cfg.tail_alpha)
            prompt = tuple(rng.integers(1, cfg.vocab)
                           for _ in range(plen))
            max_new = _pareto_int(rng, *cfg.tail_output_len,
                                  cfg.tail_output_alpha)
        else:
            b = rng.choice(mix_cum)
            lo, hi, _ = cfg.prompt_len_mix[b]
            plen = rng.integers(lo, hi + 1)
            prompt = tuple(rng.integers(1, cfg.vocab)
                           for _ in range(plen))
            max_new = rng.integers(cfg.output_len[0],
                                   cfg.output_len[1] + 1)
        cancel = None
        # same alignment rule: both draws always happen
        will_cancel = rng.random() < cfg.cancel_frac
        c_delay = rng.uniform(*cfg.cancel_after_s)
        if will_cancel:
            cancel = _round6(c_delay)
        requests.append(TraceRequest(i, _round6(at), tenant, adapter,
                                     prompt, max_new, cancel))
    return Trace(cfg, tuple(requests))


def _shared_prefix_requests(cfg: TraceConfig, rng: _SplitMix,
                            arrivals: list[float], tenant_cum,
                            adapter_cum) -> tuple[TraceRequest, ...]:
    """The shared_prefix / multi-turn chat family. Draw order (part of
    the byte-identity format — never reorder without bumping the trace
    version): first the n_templates template token sequences, then per
    SESSION (one per Poisson arrival) tenant → adapter pair → template →
    n_turns → per turn (user tokens, max_new, cancel pair, gap). Turn
    k's prompt is the template plus all k user chunks so far, so within
    a session every later prompt is a strict extension of the previous
    one — the property a radix prefix cache reuses and the
    session-affinity router preserves across replicas. Requests are
    globally re-sorted by arrival (sessions interleave) and re-indexed;
    ties keep session order, so arrivals stay sorted and deterministic."""
    templates: list[tuple[int, ...]] = []
    for _ in range(cfg.n_templates):
        tlen = rng.integers(cfg.template_len[0], cfg.template_len[1] + 1)
        templates.append(tuple(rng.integers(1, cfg.vocab)
                               for _ in range(tlen)))
    template_cum = _zipf_cum(cfg.n_templates, cfg.template_skew)
    rows: list[tuple] = []   # (arrival, order, ...request fields)
    order = 0
    for s_idx, at in enumerate(arrivals):
        tenant = f"t{rng.choice(tenant_cum)}"
        adapter = None
        if cfg.adapters:
            # same stream-alignment rule as the base family: both draws
            # always happen, whatever the outcome
            use_adapter = rng.random() >= cfg.adapter_none_frac
            a_idx = rng.choice(adapter_cum)
            if use_adapter:
                adapter = cfg.adapters[a_idx]
        ctx = list(templates[rng.choice(template_cum)])
        n_turns = rng.integers(cfg.turns[0], cfg.turns[1] + 1)
        t_turn = at
        for _ in range(n_turns):
            ulen = rng.integers(cfg.turn_user_len[0],
                                cfg.turn_user_len[1] + 1)
            ctx.extend(rng.integers(1, cfg.vocab) for _ in range(ulen))
            prompt = tuple(ctx)
            max_new = rng.integers(cfg.output_len[0],
                                   cfg.output_len[1] + 1)
            will_cancel = rng.random() < cfg.cancel_frac
            c_delay = rng.uniform(*cfg.cancel_after_s)
            cancel = _round6(c_delay) if will_cancel else None
            rows.append((_round6(t_turn), order, tenant, adapter, prompt,
                         max_new, cancel, f"s{s_idx}"))
            order += 1
            t_turn += rng.uniform(*cfg.turn_gap_s)
    rows.sort(key=lambda r: (r[0], r[1]))
    return tuple(
        TraceRequest(i, at, tenant, adapter, prompt, max_new, cancel,
                     session)
        for i, (at, _o, tenant, adapter, prompt, max_new, cancel,
                session) in enumerate(rows))


def trace_bytes(trace: Trace) -> bytes:
    """Canonical serialization — THE byte-identity artifact (sorted keys,
    no whitespace, generation-time-rounded floats)."""
    return json.dumps(trace.to_json(), sort_keys=True,
                      separators=(",", ":")).encode()


def trace_sha256(trace: Trace) -> str:
    return hashlib.sha256(trace_bytes(trace)).hexdigest()


def tenant_names(trace: Trace) -> list[str]:
    """Distinct tenants in arrival order (stable across runs)."""
    seen: dict[str, None] = {}
    for r in trace.requests:
        seen.setdefault(r.tenant, None)
    return list(seen)


def offered_tokens(trace: Trace, tenants: Sequence[str] | None = None
                   ) -> int:
    """Total output-token demand (the denominator of saturation)."""
    sel = set(tenants) if tenants is not None else None
    return sum(r.max_new_tokens for r in trace.requests
               if sel is None or r.tenant in sel)
