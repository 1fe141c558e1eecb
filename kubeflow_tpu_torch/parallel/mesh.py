"""The device mesh on a torch.distributed process group (counterpart of
kubeflow_tpu/parallel/mesh.py).

The axes, outermost first, are the JAX package's: `data` (gradients
all-reduced), `fsdp` (params and optimizer state sharded, gradients
reduce-scattered), `stage`, `expert`, `sequence`, `tensor`. A mesh is a
`torch.distributed.device_mesh.DeviceMesh` with those six named dims.

One process drives one card, so the mesh's devices are the group's ranks:
a -1 axis resolves against the world size (on one card, -1 is one card,
as it is for a one-device JAX process), and ranks are laid out row-major
over AXIS_ORDER, as the JAX mesh lays out its device list
(`np.asarray(claimed).reshape(shape)`). A mesh smaller than the world
claims its first ranks. When the claimed ranks span several nodes (a
rank's node is its host, learned once per process group), `arrange_ranks`
lays `data` across the nodes and every other axis inside one node, so
that only the gradient all-reduce crosses nodes: the counterpart of the
JAX `_hybrid_device_array` over DCN-connected slices, with the same
fallback to the flat order (and a warning) where the data axis cannot
stride the nodes evenly. `stage_submeshes` cuts a mesh into one mesh per
`stage` coordinate over the other axes (the stage × tensor serving
layout's building block).
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import math
import threading
from typing import Iterator, Sequence

import torch

log = logging.getLogger(__name__)

# Canonical axis order: `data` outermost, `tensor`/`sequence` innermost.
AXIS_ORDER = ("data", "fsdp", "stage", "expert", "sequence", "tensor")


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Declarative mesh shape. -1 on at most one axis = infer from the
    world size."""

    data: int = 1
    fsdp: int = 1
    stage: int = 1
    expert: int = 1
    sequence: int = 1
    tensor: int = 1

    def axis_sizes(self) -> dict[str, int]:
        return {
            "data": self.data,
            "fsdp": self.fsdp,
            "stage": self.stage,
            "expert": self.expert,
            "sequence": self.sequence,
            "tensor": self.tensor,
        }

    def resolved(self, n_devices: int) -> "MeshConfig":
        """Resolve a single -1 axis against the available device count."""
        sizes = self.axis_sizes()
        unknown = [k for k, v in sizes.items() if v == -1]
        if len(unknown) > 1:
            raise ValueError(f"at most one axis may be -1, got {unknown}")
        if unknown:
            known = math.prod(v for v in sizes.values() if v != -1)
            if n_devices % known:
                raise ValueError(
                    f"{n_devices} devices not divisible by fixed axes product {known}"
                )
            sizes[unknown[0]] = n_devices // known
        total = math.prod(sizes.values())
        if total > n_devices:
            raise ValueError(
                f"mesh {sizes} wants {total} devices but only {n_devices} available"
            )
        return dataclasses.replace(self, **sizes)


def mesh_config(mesh: "MeshConfig | dict | None") -> MeshConfig:
    """A MeshConfig from a job's `mesh` dict (unknown axes raise)."""
    if isinstance(mesh, MeshConfig):
        return mesh
    mesh = dict(mesh or {})
    unknown = set(mesh) - set(AXIS_ORDER)
    if unknown:
        raise ValueError(f"unknown mesh axis {sorted(unknown)[0]!r}")
    return MeshConfig(**{k: int(v) for k, v in mesh.items()})


def make_mesh(config: MeshConfig | dict | None = None, *,
              device_type: str | None = None, **axis_sizes: int):
    """A DeviceMesh over the process group's ranks from a MeshConfig (or
    a job's mesh dict, or axis sizes as kwargs). Every rank calls it. The
    device type is cuda on an NCCL group, cpu on gloo. Raises when no
    process group is running (runtime.initialize_distributed starts
    one)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    if config is None:
        config = MeshConfig(**axis_sizes)
    elif axis_sizes:
        raise ValueError("pass either a MeshConfig or axis sizes, not both")
    config = mesh_config(config)
    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs a process group: call "
            "kubeflow_tpu_torch.runtime.initialize_distributed (or "
            "torch.distributed.init_process_group) first")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    config = config.resolved(dist.get_world_size())
    sizes = config.axis_sizes()
    n = math.prod(sizes.values())
    ranks = arrange_ranks(node_ids()[:n], sizes)
    return DeviceMesh(device_type, ranks, mesh_dim_names=AXIS_ORDER)


def arrange_ranks(nodes: Sequence, sizes: dict[str, int]) -> torch.Tensor:
    """The mesh's ranks [data, fsdp, stage, expert, sequence, tensor] from
    each claimed rank's node (nodes[r] is rank r's) and the axis sizes.
    On one node, and wherever the data axis cannot stride the nodes
    evenly (nodes of unequal rank counts, or a data size the node count
    does not divide), the flat row-major order; otherwise `data` across
    the nodes and every other axis inside one node: the ranks grouped by
    node (nodes in order of their first rank), each node's laid out
    row-major over the inner shape (data / nodes, the rest), the node
    index the major part of the data coordinate."""
    shape = tuple(sizes[a] for a in AXIS_ORDER)
    flat = torch.arange(math.prod(shape)).reshape(shape)
    groups: dict = {}
    for r, node in enumerate(nodes):
        groups.setdefault(node, []).append(r)
    if len(groups) <= 1:
        return flat
    n_nodes = len(groups)
    per_node = list(groups.values())
    if len({len(g) for g in per_node}) != 1 or sizes["data"] % n_nodes:
        log.warning(
            "the process group spans %d nodes but the mesh %s cannot "
            "stride them with the data axis; falling back to the flat rank "
            "order: collectives of the other axes may cross nodes",
            n_nodes, {k: v for k, v in sizes.items() if v > 1})
        return flat
    inner = dict(sizes, data=sizes["data"] // n_nodes)
    inner_shape = tuple(inner[a] for a in AXIS_ORDER)
    stacked = torch.stack([torch.tensor(g).reshape(inner_shape)
                           for g in per_node])
    return stacked.reshape(shape)


_NODES: list = [None, None]   # [the process group, its ranks' nodes]


def node_ids() -> list[str]:
    """Each rank's node, rank by rank: its host name, all-gathered once
    per process group."""
    import socket

    import torch.distributed as dist

    group = dist.distributed_c10d._get_default_group()
    if _NODES[0] is not group:
        out: list = [None] * dist.get_world_size()
        dist.all_gather_object(out, socket.gethostname())
        _NODES[:] = [group, out]
    return _NODES[1]


def stage_submeshes(mesh) -> list:
    """One DeviceMesh per `stage` coordinate of `mesh`: stage s gets the
    ranks at coordinate s, laid over the remaining axes in the mesh's
    order (the JAX `stage_submeshes`' `np.take(mesh.devices, s,
    axis=stage)`), so that each stage's collectives stay inside its own
    group. Every rank of `mesh` calls it (each sub-mesh makes its
    groups); a rank's own stage is the entry at its coordinate. Raises
    ValueError on a mesh without a `stage` axis."""
    from torch.distributed.device_mesh import DeviceMesh

    names = list(mesh.mesh_dim_names or ())
    if "stage" not in names:
        raise ValueError(f"mesh has no stage axis: {names}")
    ax = names.index("stage")
    sub_names = tuple(n for n in names if n != "stage")
    return [DeviceMesh(mesh.device_type, mesh.mesh.select(ax, s),
                       mesh_dim_names=sub_names)
            for s in range(mesh.mesh.shape[ax])]


def single_device_mesh(device_type: str | None = None):
    """A mesh with all axes of size 1 on rank 0 of the process group."""
    return make_mesh(MeshConfig(), device_type=device_type)


def mesh_shape(mesh) -> dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


# Ambient mesh: for code that needs the mesh without having it passed
# (the JAX package's `active_mesh` / `get_active_mesh`; the sharded
# trainer sets it around a family's loss, `sharding.regions` reads it).
_ACTIVE = threading.local()


@contextlib.contextmanager
def active_mesh(mesh) -> Iterator:
    stack = getattr(_ACTIVE, "stack", None)
    if stack is None:
        stack = _ACTIVE.stack = []
    stack.append(mesh)
    try:
        yield mesh
    finally:
        stack.pop()


def get_active_mesh():
    stack = getattr(_ACTIVE, "stack", None)
    return stack[-1] if stack else None


def num_data_shards(mesh) -> int:
    s = mesh_shape(mesh)
    return s.get("data", 1) * s.get("fsdp", 1)


def data_shard_index(mesh) -> int:
    """This rank's block of a batch sharded over ("data", "fsdp"): the
    row-major index of its (data, fsdp) coordinate, as JAX's
    PartitionSpec(("data", "fsdp")) numbers the blocks."""
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    return coord["data"] * mesh_shape(mesh)["fsdp"] + coord["fsdp"]


def validate_divisibility(mesh, *, batch: int | None = None,
                          seq: int | None = None, heads: int | None = None,
                          embed: int | None = None) -> None:
    """Early, readable errors instead of a failing collective."""
    s = mesh_shape(mesh)
    checks = [
        ("batch", batch, s.get("data", 1) * s.get("fsdp", 1)),
        ("seq", seq, s.get("sequence", 1)),
        ("heads", heads, s.get("tensor", 1)),
        ("embed", embed, s.get("tensor", 1)),
    ]
    for name, value, div in checks:
        if value is not None and div > 1 and value % div:
            raise ValueError(f"{name}={value} not divisible by mesh factor {div}")
