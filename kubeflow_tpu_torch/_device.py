"""Device resolution for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """`device` as a torch.device. CUDA is the default; asking for it on
    a machine without a usable GPU raises instead of running on the CPU —
    the CPU is used only when the caller asks for it."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' to run the "
                "plain PyTorch versions on the CPU")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}: use cuda or cpu")
    return dev


#: the JAX package's mesh axes (parallel/mesh.py MeshConfig)
MESH_AXES = ("data", "fsdp", "stage", "expert", "sequence", "tensor")


def check_one_card_mesh(mesh: dict, item: str = "A6") -> None:
    """A mesh spec that a one-card path runs: known axes, each 1 or -1
    (all the devices, which is one card here). Raises ValueError
    otherwise, naming the ROADMAP.md queue item that takes the path past
    one card."""
    for axis, n in mesh.items():
        if axis not in MESH_AXES:
            raise ValueError(f"unknown mesh axis {axis!r}")
        if n not in (1, -1):
            raise ValueError(
                f"mesh axis {axis}={n}: this path runs on one card "
                f"(past one card is ROADMAP.md queue {item}, parallelism)")
