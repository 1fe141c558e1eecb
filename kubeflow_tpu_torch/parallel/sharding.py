"""Logical-axis sharding rules on DTensor placements (counterpart of
kubeflow_tpu/parallel/sharding.py).

A model annotates every parameter with logical axis names ("embed",
"mlp", "heads", ...; each family's `logical_axes`); a rules dict maps
them to mesh axes. `logical_to_spec` gives the tuple a JAX PartitionSpec
holds for the same rules (a mesh axis used once per spec, a tuple for a
dim over several axes, trailing Nones dropped); `spec_placements` turns
it into one DTensor placement per mesh dim (Shard(d) where the spec puts
that mesh axis on tensor dim d, Replicate elsewhere). A size-1 mesh axis
keeps its Shard placement: its shard is the whole dim, as a JAX sharding
over a size-1 axis is.

The collectives a sharded trainer needs are here too, written per leaf
on the groups of the mesh dims of more than one rank: `local_chunk` (the
rank's block of a whole tensor), `gather` (the whole tensor from the
blocks) and `reduce_grad` (a gradient summed over every rank,
reduce-scattered where its param is sharded and all-reduced where it is
replicated).
"""

from __future__ import annotations

from typing import Any, Mapping, Sequence

import torch

# Logical axes used across kubeflow_tpu_torch.models:
#   batch, seq (activations), embed, mlp, heads, kv (never sharded), qkv,
#   vocab, layers (the stacked-layer axis), expert, conv_in / conv_out

LogicalSpec = tuple[str | None, ...]
Rules = Mapping[str, str | tuple[str, ...] | None]

# Default layout: FSDP over params' embed-ish axes, tensor parallelism over
# heads/mlp/vocab, sequence parallelism over activation `seq`.
DEFAULT_RULES: dict[str, Any] = {
    "batch": ("data", "fsdp"),
    "seq": "sequence",
    "embed": "fsdp",
    "embed_no_fsdp": None,
    "mlp": "tensor",
    "heads": "tensor",
    "qkv": "tensor",
    "kv": None,
    "vocab": "tensor",
    "layers": "stage",
    "expert": "expert",
    "conv_in": None,
    "conv_out": "fsdp",
}


def logical_to_spec(logical: Sequence[str | None],
                    rules: Rules | None = None) -> tuple:
    """The entries of the PartitionSpec JAX builds for a leaf's logical
    axes under rules (DEFAULT_RULES updated by `rules`)."""
    rules = dict(DEFAULT_RULES) | dict(rules or {})
    parts: list[Any] = []
    used: set[str] = set()
    for name in logical:
        axis = rules.get(name) if name is not None else None
        # one mesh axis may appear at most once per spec; later dims replicate
        if axis is None:
            parts.append(None)
        elif isinstance(axis, tuple):
            fresh = tuple(a for a in axis if a not in used)
            used.update(fresh)
            # a PartitionSpec holds a one-axis tuple as the axis itself
            parts.append(fresh if len(fresh) > 1 else
                         fresh[0] if fresh else None)
        elif axis in used:
            parts.append(None)
        else:
            used.add(axis)
            parts.append(axis)
    while parts and parts[-1] is None:
        parts.pop()
    return tuple(parts)


def spec_placements(spec: tuple, mesh) -> tuple:
    """One placement per mesh dim for a spec: Shard(d) on each mesh axis
    the spec puts on tensor dim d, Replicate on the others. A dim over
    several axes must name them in the mesh's order (major first), the
    order DTensor shards in."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names)
    out: list = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        axes = () if entry is None else (
            entry if isinstance(entry, tuple) else (entry,))
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: dim {d} names {axes} out of the "
                             f"mesh's axis order {tuple(names)}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


def is_axes_leaf(x) -> bool:
    """A logical-axes tree's leaf: a tuple of names (or Nones)."""
    return isinstance(x, tuple) and all(
        a is None or isinstance(a, str) for a in x)


def tree_map_axes(fn, tree: Any) -> Any:
    """fn at each logical-axes leaf of nested dicts and lists."""
    if is_axes_leaf(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map_axes(fn, v) for k, v in tree.items()}
    return [tree_map_axes(fn, v) for v in tree]


def axes_by_path(tree: Any, path: str = "") -> dict[str, LogicalSpec]:
    """{"/"-joined key path: logical axes} of a logical-axes tree (the
    paths the trainer's `named_leaves` gives the params)."""
    if is_axes_leaf(tree):
        return {path: tree}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out: dict[str, LogicalSpec] = {}
    for k, v in items:
        out.update(axes_by_path(v, f"{path}/{k}" if path else str(k)))
    return out


def tree_logical_to_placements(logical_tree: Any, mesh,
                               rules: Rules | None = None) -> Any:
    """Map a tree of logical-axis tuples to placement tuples on mesh
    (tree_logical_to_sharding's counterpart)."""
    return tree_map_axes(
        lambda ax: spec_placements(logical_to_spec(ax, rules), mesh),
        logical_tree)


# -- per-leaf blocks and collectives -----------------------------------------


def _sharded_dims(mesh, placements) -> list[tuple[int, int]]:
    """(mesh dim, tensor dim) of each Shard placement on a mesh dim of
    more than one rank, in mesh order (a block over one rank is the whole
    dim, and moving it is the identity)."""
    return [(i, p.dim) for i, p in enumerate(placements)
            if p.is_shard() and mesh.size(i) > 1]


def check_divisible(shape, mesh, placements, what: str = "leaf") -> None:
    """A sharded dim must divide by its mesh axes' sizes (JAX refuses an
    uneven NamedSharding the same way)."""
    per_dim: dict[int, int] = {}
    for i, d in _sharded_dims(mesh, placements):
        per_dim[d] = per_dim.get(d, 1) * mesh.size(i)
    for d, k in per_dim.items():
        if shape[d] % k:
            raise ValueError(
                f"{what} of shape {tuple(shape)}: dim {d} ({shape[d]}) does "
                f"not divide by its mesh factor {k}")


def local_chunk(full: torch.Tensor, mesh, placements,
                offset: int = 0) -> torch.Tensor:
    """This rank's block of a whole tensor (a view). `offset` counts
    leading dims of the leaf that `full` has already been indexed by (a
    stacked leaf's one layer)."""
    coord = mesh.get_coordinate()
    out = full
    for i, d in _sharded_dims(mesh, placements):
        if d < offset:
            raise ValueError("a leaf sharded over its stacked layer axis "
                             "cannot be built layer by layer (ROADMAP.md "
                             "queue A6c)")
        out = out.chunk(mesh.size(i), dim=d - offset)[coord[i]]
    return out


def distribute(full: torch.Tensor, mesh, placements,
               device=None) -> torch.Tensor:
    """The DTensor of a whole tensor: this rank's block copied to
    `device` (the whole tensor's device by default). Every rank calls it
    with the same tensor; no collective runs."""
    from torch.distributed.tensor import DTensor

    check_divisible(full.shape, mesh, placements)
    block = local_chunk(full, mesh, placements)
    block = block.to(device if device is not None else full.device,
                     copy=True).contiguous()
    return DTensor.from_local(block, mesh, placements, run_check=False,
                              shape=full.shape,
                              stride=torch.empty(full.shape,
                                                 device="meta").stride())


def holders(mesh, placements) -> torch.Tensor:
    """The ranks that hold one copy of every block of a leaf, in block
    order: those at coordinate 0 on each mesh dim it is replicated over."""
    ranks = mesh.mesh
    for i in reversed(range(mesh.ndim)):
        if not placements[i].is_shard():
            ranks = ranks.select(i, 0)
    return ranks.flatten()


def _dim_group(mesh, i: int):
    return mesh.get_group(mesh.mesh_dim_names[i])


def gather(local: torch.Tensor, mesh, placements) -> torch.Tensor:
    """The whole tensor from each rank's block: one all-gather per
    sharded mesh dim, innermost first (a plain tensor, not a DTensor)."""
    import torch.distributed as dist

    out = local
    for i, d in reversed(_sharded_dims(mesh, placements)):
        k = mesh.size(i)
        src = out.movedim(d, 0).contiguous()
        buf = torch.empty((k * src.shape[0], *src.shape[1:]),
                          dtype=src.dtype, device=src.device)
        dist.all_gather_into_tensor(buf, src, group=_dim_group(mesh, i))
        out = buf.movedim(0, d)
    return out.contiguous() if out is not local else out


def reduce_grad(grad: torch.Tensor, mesh, placements) -> torch.Tensor:
    """A whole gradient summed over every rank of the mesh, as this
    rank's block of its param: reduce-scatter over each mesh dim the
    param is sharded on (outermost first), all-reduce over the others
    (skipped on a dim of one rank, where it is the identity)."""
    import torch.distributed as dist

    out = grad
    shard = dict((i, d) for i, d in _sharded_dims(mesh, placements))
    for i in range(mesh.ndim):
        group = _dim_group(mesh, i)
        if i in shard:
            d = shard[i]
            k = mesh.size(i)
            src = out.movedim(d, 0).contiguous()
            buf = torch.empty((src.shape[0] // k, *src.shape[1:]),
                              dtype=src.dtype, device=src.device)
            dist.reduce_scatter_tensor(buf, src, group=group)
            out = buf.movedim(0, d)
        elif mesh.size(i) > 1:
            out = out.contiguous()
            dist.all_reduce(out, group=group)
    return out.contiguous()
