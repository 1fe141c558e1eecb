"""Structured training-metric stream (counterpart of
kubeflow_tpu/training/metrics_writer.py): one JSON line per logged step,
`{"step": N, "metrics": {...}, "ts": ...}`, with a stdout echo."""

from __future__ import annotations

import json
import os
import sys
import time
from typing import IO, Any


class MetricsWriter:
    def __init__(self, path: str | None = None, echo: bool = True):
        self.path = path
        self.echo = echo
        self._fh: IO[str] | None = None
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            self._fh = open(path, "a", buffering=1)

    def write(self, step: int, metrics: dict[str, Any]) -> None:
        line = json.dumps({"step": step, "metrics": metrics,
                           "ts": time.time()})
        if self._fh:
            self._fh.write(line + "\n")
        if self.echo:
            pretty = " ".join(f"{k}={v:.5g}" if isinstance(v, float)
                              else f"{k}={v}" for k, v in metrics.items())
            print(f"[step {step}] {pretty}", file=sys.stdout, flush=True)

    def close(self) -> None:
        if self._fh:
            self._fh.close()
            self._fh = None


def read_metrics(path: str) -> list[dict[str, Any]]:
    out = []
    if not os.path.exists(path):
        return out
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if line:
                try:
                    out.append(json.loads(line))
                except json.JSONDecodeError:
                    continue
    return out
