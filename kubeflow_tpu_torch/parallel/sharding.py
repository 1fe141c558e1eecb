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
blocks, over the mesh dims asked for) and `reduce_grad` (a gradient
summed over the axes that split the batch's tokens, `data` and `fsdp`
over its rows and `sequence` over its columns: reduce-scattered where
its param is sharded and all-reduced where it is replicated; never
summed over `tensor` or `expert`, whose ranks see the same tokens; over
`stage` under the GPipe schedule only where each stage holds a part of
a whole leaf's gradient).
`ring_peers` names the sequence group's ring neighbours.

The Megatron region operators are here as well, for a family that
computes on `tensor`- and `expert`-local blocks (the registry's
`local_blocks`): `copy_in` (identity forward, all-reduce backward) where
a replicated activation enters a rank-local product, `reduce_out`
(all-reduce forward, identity backward) where rank-local partial sums
leave it, and `vocab_parallel_ce`, the cross-entropy of logits split
over the vocabulary (its per-rank statistics and gradient group-free in
`vocab_shard_stats` and `vocab_shard_grad`). `regions()` gives a family
the groups of the mesh its trainer runs it on (`mesh.active_mesh`), and
NO_REGIONS, whose operators are the identity, off a mesh.
"""

from __future__ import annotations

import dataclasses
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
                layer: int | None = None, n_layers: int = 0):
    """This rank's block of a whole tensor (a view). With `layer`, `full`
    is that layer of a stacked leaf of `n_layers` layers (its dim d is
    the leaf's d + 1): the block of it this rank holds, or None where the
    leaf's stacked axis is split (over `stage`: a stage's slab of
    contiguous layers) and the rank's slab does not hold the layer."""
    coord = mesh.get_coordinate()
    out = full
    lo, n = 0, n_layers
    for i, d in _sharded_dims(mesh, placements):
        if layer is not None and d == 0:
            n //= mesh.size(i)
            lo += coord[i] * n
            continue
        out = out.chunk(mesh.size(i), dim=d - (layer is not None))[coord[i]]
    if layer is not None and not lo <= layer < lo + n:
        return None
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


#: the mesh axes that split a batch's tokens (`data` and `fsdp` its
#: rows, `sequence` its columns): a gradient sums over them
BATCH_AXES = ("data", "fsdp", "sequence")


def ring_peers(group) -> tuple[int, int]:
    """(the next rank, the previous rank) of `group`'s ring, as global
    ranks: rank r of the group sends to r + 1 and receives from r - 1
    (mod its size), the direction of the JAX ring's ppermute."""
    import torch.distributed as dist

    n, r = dist.get_world_size(group), dist.get_rank(group)
    return (dist.get_global_rank(group, (r + 1) % n),
            dist.get_global_rank(group, (r - 1) % n))


def gather(local: torch.Tensor, mesh, placements,
           dims: Sequence[str] | None = None) -> torch.Tensor:
    """The tensor gathered from each rank's block over the mesh dims named
    in `dims` (every dim by default): one all-gather per sharded mesh
    dim, innermost first (a plain tensor, not a DTensor). A family that
    computes on `tensor`- and `expert`-local blocks gathers over the
    others only."""
    import torch.distributed as dist

    names = mesh.mesh_dim_names
    out = local
    for i, d in reversed(_sharded_dims(mesh, placements)):
        if dims is not None and names[i] not in dims:
            continue
        k = mesh.size(i)
        src = out.movedim(d, 0).contiguous()
        buf = torch.empty((k * src.shape[0], *src.shape[1:]),
                          dtype=src.dtype, device=src.device)
        dist.all_gather_into_tensor(buf, src, group=_dim_group(mesh, i))
        out = buf.movedim(0, d)
    return out.contiguous() if out is not local else out


def reduce_grad(grad: torch.Tensor, mesh, placements,
                whole: Sequence[str] | None = None,
                partial: Sequence[str] = ()) -> torch.Tensor:
    """This rank's block of a param's gradient summed over the axes that
    split the batch (BATCH_AXES), mesh dims taken outermost first: a
    reduce-scatter where the param is sharded, an all-reduce where it is
    replicated (skipped on a dim of one rank). Over `tensor` and `expert`
    nothing is summed: their ranks see the same tokens, and a rank either
    computed its own block's gradient or the same whole gradient as its
    peers. `whole` names the mesh dims over which `grad` is whole (the
    dims `gather` gathered; every dim by default): on such a dim outside
    BATCH_AXES the rank keeps its chunk. `partial` names the mesh dims
    whose ranks each hold a part of the gradient of a leaf replicated
    over them (the GPipe schedule's `stage`: the embedding's on the first
    stage, the loss tail's on the last), all-reduced there; a leaf split
    over such a dim keeps its block."""
    import torch.distributed as dist

    names = mesh.mesh_dim_names
    out = grad
    shard = dict((i, d) for i, d in _sharded_dims(mesh, placements))
    for i in range(mesh.ndim):
        k = mesh.size(i)
        if names[i] in partial and i not in shard:
            if k > 1:
                out = out.contiguous()
                dist.all_reduce(out, group=_dim_group(mesh, i))
            continue
        if names[i] not in BATCH_AXES:
            if i in shard and (whole is None or names[i] in whole):
                out = out.chunk(k, dim=shard[i])[mesh.get_coordinate()[i]]
            continue
        group = _dim_group(mesh, i)
        if i in shard:
            d = shard[i]
            src = out.movedim(d, 0).contiguous()
            buf = torch.empty((src.shape[0] // k, *src.shape[1:]),
                              dtype=src.dtype, device=src.device)
            dist.reduce_scatter_tensor(buf, src, group=group)
            out = buf.movedim(0, d)
        elif k > 1:
            out = out.contiguous()
            dist.all_reduce(out, group=group)
    return out.contiguous()


# -- Megatron regions ---------------------------------------------------------


def _all_reduce_groups(t: torch.Tensor, groups) -> torch.Tensor:
    import torch.distributed as dist

    for g in groups:
        dist.all_reduce(t, group=g)
    return t


class _CopyIn(torch.autograd.Function):
    """Identity forward; the gradient all-reduced over `groups` backward
    (a replicated activation entering rank-local products)."""

    @staticmethod
    def forward(ctx, x, groups):
        ctx.groups = groups
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce_groups(g.contiguous().clone(), ctx.groups), None


class _ReduceOut(torch.autograd.Function):
    """All-reduce over `groups` forward (rank-local partial sums leaving a
    region); identity backward."""

    @staticmethod
    def forward(ctx, x, groups):
        return _all_reduce_groups(x.contiguous().clone(), groups)

    @staticmethod
    def backward(ctx, g):
        return g, None


def vocab_shard_stats(logits: torch.Tensor, targets: torch.Tensor,
                      start: int) -> tuple[torch.Tensor, ...]:
    """One rank's statistics of the cross-entropy of f32 logits [..., V_r]
    holding vocabulary columns [start, start + V_r), targets [...] global
    ids: (the row max m, the sum of exp(logits - m), the target's logit
    where it lies in these columns, else 0). The ranks' statistics make
    the whole vocabulary's: M = max m_r, S = sum s_r exp(m_r - M), T =
    sum t_r, and the loss is log S + M - T."""
    v = logits.shape[-1]
    m = logits.detach().amax(dim=-1)
    s = torch.exp(logits - m[..., None]).sum(dim=-1)
    local = targets - start
    inside = (local >= 0) & (local < v)
    t = logits.gather(-1, local.clamp(0, v - 1)[..., None])[..., 0] * inside
    return m, s, t


def vocab_shard_grad(logits: torch.Tensor, targets: torch.Tensor,
                     start: int, m: torch.Tensor, s: torch.Tensor,
                     g: torch.Tensor) -> torch.Tensor:
    """The gradient of the loss log S + M - T, times g [...], with
    respect to one rank's logits [..., V_r] (`vocab_shard_stats`): the
    whole vocabulary's softmax from the combined M and S, less the
    target's one-hot, on these columns alone."""
    v = logits.shape[-1]
    grad = torch.exp(logits - m[..., None])
    grad.mul_((g / s)[..., None])
    local = targets - start
    inside = (local >= 0) & (local < v)
    grad.scatter_add_(-1, local.clamp(0, v - 1)[..., None],
                      -(inside.to(g.dtype) * g)[..., None])
    return grad


class _VocabParallelCE(torch.autograd.Function):
    """-log softmax(logits)[target] per row of logits split over the
    vocabulary: each rank's `vocab_shard_stats` combined over `group`
    (the row max, then the rescaled sums of exponentials and the target
    logits in one all-reduce). Backward: `vocab_shard_grad`, on this
    rank's columns alone."""

    @staticmethod
    def forward(ctx, logits, targets, start, group):
        import torch.distributed as dist

        m, s, t = vocab_shard_stats(logits, targets, start)
        if group is not None:
            top = m.clone()
            dist.all_reduce(top, op=dist.ReduceOp.MAX, group=group)
            st = torch.stack([s * torch.exp(m - top), t])
            dist.all_reduce(st, group=group)
            m, (s, t) = top, st.unbind()
        ctx.start = start
        ctx.save_for_backward(logits, targets, m, s)
        return torch.log(s) + m - t

    @staticmethod
    def backward(ctx, g):
        logits, targets, m, s = ctx.saved_tensors
        return (vocab_shard_grad(logits, targets, ctx.start, m, s, g),
                None, None, None)


def vocab_parallel_ce(logits: torch.Tensor, targets: torch.Tensor,
                      start: int, group) -> torch.Tensor:
    """Per-row cross-entropy of f32 logits [..., V_r] holding vocabulary
    columns [start, start + V_r) of this rank of `group` (None: the whole
    vocabulary), targets [...] global ids. The logits are never
    gathered."""
    return _VocabParallelCE.apply(logits, targets.long(), start, group)


@dataclasses.dataclass(frozen=True)
class Regions:
    """The `tensor`, `expert` and `sequence` split a family computes
    under, and the data shards of the batch's rows, on one mesh: each
    axis' size, this rank's index on it and its group (None on an axis of
    one rank)."""

    sizes: dict
    ranks: dict
    groups: dict
    n_shards: int
    shard: int

    def size(self, axis: str) -> int:
        return self.sizes.get(axis, 1)

    def rank(self, axis: str) -> int:
        return self.ranks.get(axis, 0)

    def _groups(self, axes) -> tuple:
        return tuple(self.groups[a] for a in axes
                     if self.groups.get(a) is not None)

    def copy_in(self, x: torch.Tensor, *axes: str) -> torch.Tensor:
        """x unchanged forward; its gradient summed over `axes` backward."""
        groups = self._groups(axes)
        return _CopyIn.apply(x, groups) if groups else x

    def reduce_out(self, x: torch.Tensor, *axes: str) -> torch.Tensor:
        """x summed over `axes` forward; the gradient passed through."""
        groups = self._groups(axes)
        return _ReduceOut.apply(x, groups) if groups else x

    def sum_batch(self, x: torch.Tensor) -> torch.Tensor:
        """x summed over the batch's shards (the BATCH_AXES groups),
        forward only in value: the gradient passes through to this
        shard's part."""
        return self.reduce_out(x, *BATCH_AXES)

    def gather_shards(self, x: torch.Tensor) -> torch.Tensor:
        """[n_shards * N_seq, ...] of every batch shard's x (no
        gradient), in rank order over (data, fsdp, sequence): the data
        shards as PartitionSpec(("data", "fsdp")) numbers them, each
        one's sequence blocks within it."""
        import torch.distributed as dist

        out = x.detach()[None]
        for axis in reversed(BATCH_AXES):
            g = self.groups.get(axis)
            if g is None:
                continue
            k = self.sizes[axis]
            buf = torch.empty((k * out.shape[0], *out.shape[1:]),
                              dtype=out.dtype, device=out.device)
            dist.all_gather_into_tensor(buf, out.contiguous(), group=g)
            out = buf
        return out

    def tokens_before(self, counts: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
        """counts [B_loc, ...]: a count over this rank's tokens of each of
        its rows (its columns of the row). Returns ([B_loc, ...] the sum
        over every token before each of this rank's row blocks in the
        global batch's flattened [B, S] order, the sum over the global
        batch): the order the JAX package's GSPMD sees, rows outer and
        columns inner, so a row's sequence blocks come in rank order
        after every block of the rows before it (no gradient)."""
        b, n_seq = counts.shape[0], self.size("sequence")
        every = self.gather_shards(counts)
        rest = counts.shape[1:]
        every = every.reshape(self.n_shards, n_seq, b, *rest).transpose(
            1, 2).reshape(self.n_shards * b * n_seq, *rest)
        before = every.cumsum(dim=0) - every
        idx = ((self.shard * b + torch.arange(b, device=counts.device))
               * n_seq + self.rank("sequence"))
        return before[idx], every.sum(dim=0)


#: the Regions off a mesh: one rank on every axis, every region operator
#: the identity
NO_REGIONS = Regions(sizes={}, ranks={}, groups={}, n_shards=1, shard=0)


def regions(mesh=None) -> Regions:
    """The Regions of `mesh` (the active mesh by default), NO_REGIONS
    without one. A family reads it at the top of its forward."""
    from kubeflow_tpu_torch.parallel.mesh import (data_shard_index,
                                                  get_active_mesh,
                                                  num_data_shards)

    mesh = get_active_mesh() if mesh is None else mesh
    if mesh is None:
        return NO_REGIONS
    names = mesh.mesh_dim_names
    coord = mesh.get_coordinate()
    return Regions(
        sizes={n: mesh.size(i) for i, n in enumerate(names)},
        ranks={n: coord[i] for i, n in enumerate(names)},
        groups={n: (_dim_group(mesh, i) if mesh.size(i) > 1 else None)
                for i, n in enumerate(names)},
        n_shards=num_data_shards(mesh), shard=data_shard_index(mesh))
