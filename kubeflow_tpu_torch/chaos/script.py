"""Seeded, deterministic fault scripts — chaos as a committed artifact.

A fault script is the failure-side twin of a loadgen trace: WHAT breaks
(`backend_crash`, `decode_stall`, `heartbeat_drop`, `ckpt_io_fail`,
`partition`), WHEN (an instant inside the workload window), and FOR HOW
LONG (windowed faults carry a duration; one-shot faults don't). The
loadgen runner replays a trace against the engine while the injector
replays the fault script against the serving plane — so a chaos run is
two committed seeds, both byte-pinned.

Determinism is the same hard contract as `loadgen/trace.py`: every draw
derives from the self-contained splitmix64 stream (`_SplitMix` — numpy
Generator streams are explicitly not versioned across releases), floats
are rounded at generation time, and `script_bytes` serializes
canonically (sorted keys, no whitespace). Tests pin the cross-process
sha256, as they pin the loadgen trace's.

Placement is FRACTIONAL: each `FaultSpec` draws its instants uniformly
inside a (lo, hi) fraction of the window, so the same committed script
config rescales onto a miniature scenario (the CPU tests) without
changing its shape — a crash "mid-stream" stays mid-stream at any
duration. `generate_fault_script(cfg, duration_s=...)` materializes the
absolute timeline for a concrete window.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from typing import Any

from kubeflow_tpu_torch.loadgen.trace import _SplitMix, _round6

CONFIG_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "configs")

#: the injectable fault vocabulary. One-shot kinds fire once at their
#: instant; windowed kinds are ACTIVE for [at_s, at_s + duration_s).
#: `zone_outage` (fleet chaos) is a windowed fault whose target
#: names a ZONE: every backend the router maps into that zone becomes
#: unreachable for the window — many circuits open at once (target None
#: = every zone, the full-fleet drill).
ONE_SHOT_KINDS = ("backend_crash", "ckpt_io_fail")
WINDOWED_KINDS = ("decode_stall", "heartbeat_drop", "partition",
                  "zone_outage")
FAULT_KINDS = ONE_SHOT_KINDS + WINDOWED_KINDS


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault on the timeline."""
    index: int
    at_s: float                 # offset from run start
    kind: str
    duration_s: float           # 0.0 for one-shot kinds
    target: str | None          # component hint (e.g. backend index); None
                                # = whatever the consuming layer defaults to

    @property
    def one_shot(self) -> bool:
        return self.kind in ONE_SHOT_KINDS

    def active_at(self, now_s: float) -> bool:
        return self.at_s <= now_s < self.at_s + self.duration_s

    def to_json(self) -> dict[str, Any]:
        return {"i": self.index, "t": self.at_s, "kind": self.kind,
                "dur": self.duration_s, "target": self.target}

    @staticmethod
    def from_json(d: dict[str, Any]) -> "FaultEvent":
        return FaultEvent(d["i"], d["t"], d["kind"], d["dur"], d["target"])


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One line of a script config: draw `count` events of `kind` with
    instants uniform in [window[0], window[1]] (fractions of the run
    window) and durations uniform in `duration_s` (absolute seconds;
    ignored for one-shot kinds)."""
    kind: str
    count: int = 1
    window: tuple[float, float] = (0.3, 0.7)
    duration_s: tuple[float, float] = (0.0, 0.0)
    target: str | None = None

    def to_json(self) -> dict[str, Any]:
        return {"kind": self.kind, "count": self.count,
                "window": list(self.window),
                "duration_s": list(self.duration_s),
                "target": self.target}

    @staticmethod
    def from_json(d: dict[str, Any]) -> "FaultSpec":
        return FaultSpec(d["kind"], int(d.get("count", 1)),
                         tuple(d.get("window", (0.3, 0.7))),
                         tuple(d.get("duration_s", (0.0, 0.0))),
                         d.get("target"))


@dataclasses.dataclass(frozen=True)
class FaultScriptConfig:
    """Everything the generator needs; every field feeds the byte-identity
    hash. `duration_s` is the canonical window the committed sha pins —
    callers replaying a rescaled scenario override it at generation time
    (the fractional windows keep the shape)."""
    seed: int = 0
    duration_s: float = 30.0
    faults: tuple[FaultSpec, ...] = ()

    def to_json(self) -> dict[str, Any]:
        return {"seed": self.seed, "duration_s": self.duration_s,
                "faults": [f.to_json() for f in self.faults]}

    @staticmethod
    def from_json(d: dict[str, Any]) -> "FaultScriptConfig":
        return FaultScriptConfig(
            int(d.get("seed", 0)), float(d.get("duration_s", 30.0)),
            tuple(FaultSpec.from_json(f) for f in d.get("faults", ())))

    def replace(self, **kw) -> "FaultScriptConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class FaultScript:
    name: str
    config: FaultScriptConfig
    duration_s: float               # the window actually materialized
    events: tuple[FaultEvent, ...]

    def by_kind(self, kind: str) -> list[FaultEvent]:
        return [e for e in self.events if e.kind == kind]

    def to_json(self) -> dict[str, Any]:
        return {"version": 1, "name": self.name,
                "config": self.config.to_json(),
                "duration_s": self.duration_s,
                "events": [e.to_json() for e in self.events]}

    @staticmethod
    def from_json(d: dict[str, Any]) -> "FaultScript":
        return FaultScript(d["name"],
                           FaultScriptConfig.from_json(d["config"]),
                           d["duration_s"],
                           tuple(FaultEvent.from_json(e)
                                 for e in d["events"]))


def generate_fault_script(cfg: FaultScriptConfig, *, name: str = "",
                          duration_s: float | None = None) -> FaultScript:
    """Deterministic timeline from one seeded splitmix64 stream. Draw
    order is part of the format: specs in config order, each spec's
    (instant, duration) pairs in sequence — never reorder without bumping
    the script version. The final sort by instant is stable on the draw
    index, so ties cannot reshuffle between platforms."""
    if cfg.duration_s <= 0:
        raise ValueError("duration_s must be positive")
    dur = cfg.duration_s if duration_s is None else float(duration_s)
    if dur <= 0:
        raise ValueError("materialized duration_s must be positive")
    for spec in cfg.faults:
        if spec.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {spec.kind!r}; "
                             f"known: {FAULT_KINDS}")
        lo, hi = spec.window
        if not (0.0 <= lo <= hi <= 1.0):
            raise ValueError(f"window must satisfy 0 <= lo <= hi <= 1, "
                             f"got {spec.window}")
        dlo, dhi = spec.duration_s
        if not (0.0 <= dlo <= dhi):
            raise ValueError(f"bad duration_s range {spec.duration_s}")
        if spec.count < 1:
            raise ValueError("count must be >= 1")
    rng = _SplitMix(cfg.seed)
    # rescaling the window rescales windowed-fault durations with it (the
    # miniature() convention: a 4 s stall in a 30 s window becomes a
    # 0.53 s stall in a 4 s window — same fractional footprint)
    dscale = dur / cfg.duration_s
    drawn: list[tuple[float, str, float, str | None]] = []
    for spec in cfg.faults:
        lo, hi = spec.window
        dlo, dhi = spec.duration_s
        for _ in range(spec.count):
            # both draws ALWAYS happen (stream alignment independent of
            # kind — the loadgen trace's alignment rule)
            at = _round6(rng.uniform(lo * dur, hi * dur))
            d = _round6(rng.uniform(dlo, dhi) * dscale)
            if spec.kind in ONE_SHOT_KINDS:
                d = 0.0
            drawn.append((at, spec.kind, d, spec.target))
    drawn.sort(key=lambda e: e[0])   # stable: draw order breaks ties
    events = tuple(FaultEvent(i, at, kind, d, target)
                   for i, (at, kind, d, target) in enumerate(drawn))
    return FaultScript(name, cfg, _round6(dur), events)


def script_bytes(script: FaultScript) -> bytes:
    """Canonical serialization — THE byte-identity artifact (sorted keys,
    no whitespace, generation-time-rounded floats)."""
    return json.dumps(script.to_json(), sort_keys=True,
                      separators=(",", ":")).encode()


def script_sha256(script: FaultScript) -> str:
    return hashlib.sha256(script_bytes(script)).hexdigest()


def _names() -> list[str]:
    return sorted(f[:-5] for f in os.listdir(CONFIG_DIR)
                  if f.endswith(".json"))


#: the committed chaos fleet (derived from configs/, so the registry can
#: never drift from the files)
FAULT_SCRIPTS: tuple[str, ...] = tuple(_names())


def load_fault_config(name: str) -> FaultScriptConfig:
    """Load a committed fault-script config by name."""
    path = os.path.join(CONFIG_DIR, f"{name}.json")
    if not os.path.exists(path):
        raise KeyError(f"unknown fault script {name!r}; "
                       f"committed: {list(FAULT_SCRIPTS)}")
    with open(path) as f:
        d = json.load(f)
    return FaultScriptConfig.from_json(d)


def load_fault_script(name: str, *, duration_s: float | None = None
                      ) -> FaultScript:
    """Materialize a committed fault script, optionally rescaled onto a
    different workload window (fractional placement keeps the shape)."""
    return generate_fault_script(load_fault_config(name), name=name,
                                 duration_s=duration_s)
