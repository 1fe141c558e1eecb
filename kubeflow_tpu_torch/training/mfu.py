"""MFU accounting (counterpart of kubeflow_tpu/training/mfu.py): the
analytic FLOPs of a step (models.llama.flops_per_token) over the card's
dense bf16 peak."""

from __future__ import annotations

import torch

# dense bf16 tensor-core peak FLOP/s per card, by device name (NVIDIA's
# data sheets); "cpu" is nominal, so CPU runs give a finite MFU
PEAK_FLOPS = {
    "H100 80GB HBM3": 989e12,   # H100 SXM
    "H100 PCIe": 756e12,
    "cpu": 1e11,
}


def device_peak_flops(device: str | torch.device | None = None) -> float:
    """Peak of `device` (default: the current CUDA device if there is one,
    else the CPU entry)."""
    dev = torch.device(device) if device is not None else (
        torch.device("cuda") if torch.cuda.is_available()
        else torch.device("cpu"))
    if dev.type != "cuda":
        return PEAK_FLOPS["cpu"]
    name = torch.cuda.get_device_name(dev).lower()
    for kind, peak in PEAK_FLOPS.items():
        if kind.lower() in name:
            return peak
    raise ValueError(f"no peak FLOP/s known for {name!r}; add it to "
                     "PEAK_FLOPS")


def mfu(flops_per_step: float, step_time_s: float, n_devices: int,
        peak_per_device: float | None = None) -> float:
    peak = peak_per_device if peak_per_device else device_peak_flops()
    if step_time_s <= 0:
        return 0.0
    return flops_per_step / (step_time_s * peak * n_devices)
