"""Build and runtime stamp (counterpart of kubeflow_tpu/obs/build.py):
the package version plus the torch/CUDA pair, the driver and the live
device view, so a record or a health check says what it ran on."""

from __future__ import annotations

import subprocess
from typing import Any

import torch

from kubeflow_tpu_torch import __version__

_STAMP: dict[str, Any] | None = None


def _driver_version() -> str | None:
    """The NVIDIA driver's version as nvidia-smi reports it, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=driver_version",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return None
    return out[0].strip() if out else None


def runtime_stamp() -> dict[str, Any]:
    """platform/device_kind/device_count/torch/cuda/driver of THIS
    process. Queries the CUDA runtime and nvidia-smi, so callers on
    latency paths should prefer the cached ``build_stamp()``."""
    gpu = torch.cuda.is_available()
    return {
        "platform": "gpu" if gpu else "cpu",
        "device_kind": torch.cuda.get_device_name(0) if gpu else "cpu",
        "device_count": torch.cuda.device_count() if gpu else 0,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "driver": _driver_version() if gpu else None,
    }


def build_stamp() -> dict[str, Any]:
    """The version-skew surface: computed once per process and never
    raises — a frontend must stay healthy even if the CUDA runtime is
    broken enough to fail a device query."""
    global _STAMP
    if _STAMP is None:
        stamp: dict[str, Any] = {"kubeflow_tpu_torch": __version__}
        try:
            stamp.update(runtime_stamp())
        except Exception as e:   # runtime broken: version info only
            stamp["runtime_error"] = f"{type(e).__name__}: {e}"
        _STAMP = stamp
    return dict(_STAMP)
