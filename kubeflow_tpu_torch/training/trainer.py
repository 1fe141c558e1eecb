"""The training loop on one GPU (counterpart of
kubeflow_tpu/training/trainer.py: OptimizerConfig, make_optimizer,
TrainerConfig, Trainer).

The optimizer is the port's own, step for step the optax chain the JAX
trainer builds: clip_by_global_norm, then adamw / adam / sgd(momentum 0.9)
scaled by the schedule. The places a port drifts from optax unnoticed are
kept exactly: the schedule is read at the count before the update (the
first warmup step has lr 0); clipping multiplies by max_norm / norm when
norm >= max_norm, with no epsilon; adamw decays every leaf; eps is added
after the square root, with bias correction; mu_dtype stores the first
moment (the second stays f32), and b1 * mu is then taken in that dtype,
b1 included, as JAX's weak-typed scalar is. Params are updated in place.

Params stay in cfg.param_dtype (f32); the model casts to cfg.dtype at each
matmul. `profile_dir` captures a window of steps with torch.profiler
(training/profiling.py `StepProfiler`). `checkpoint_dir` saves the state
through `training/checkpoint.py` exactly where the JAX trainer does:
after each step's log and step callback (so a cancel raised in the
callback loses that step's save), on the manager's interval
(`checkpoint_every`, keeping `keep_checkpoints`), and once more, forced,
after the last step unless the interval saved it. Saves are synchronous
(a host copy before the next in-place update); each one's seconds are
echoed with the metrics. `trainable_prefix` (LoRA: "lora") freezes every
leaf whose "/"-joined path does not start with it, as the JAX trainer's
optax.multi_transform with set_to_zero does: a frozen leaf has no
optimizer state, is never updated or decayed, and needs no gradient;
clipping still takes the global norm of every gradient it is given.

On a mesh (`mesh=`, a DeviceMesh of `parallel/mesh.py`) the trainer
shards the state over the `data`, `fsdp`, `stage`, `expert` and `tensor`
axes, as
the JAX trainer's `param_sharding` and `_state_sharding` place it: each
param by its family's `logical_axes` through the rules
(`parallel/sharding.py`), each moment as its param, the step counter and
the optimizer's count replicated. A leaf is a DTensor whose local tensor
is this rank's block, and `init_state` keeps each block as its leaf is
made, so one whole leaf exists at a time. A step gathers the params into
plain tensors (the family code and the kernels never see a DTensor) and
runs the family's forward and backward on this rank's rows of the global
batch (the block of PartitionSpec(("data", "fsdp")) at its coordinate:
the ranks of one (data, fsdp) coordinate, across `tensor` and `expert`,
see the same rows) under `active_mesh`; on a `sequence` axis past one
rank also on its columns of those rows (the block of ("batch", "seq"),
the JAX `batch_seq_spec`), given the next-token targets by global
position (`sequence_columns`). Only the Llama family (the registry's
`splits_sequence`) runs a `sequence` axis; the others raise naming
ROADMAP.md queue A6b-ii. A family with the registry's
`local_blocks` (the Llama decoder, its LoRA and Mixtral) gets its params
gathered over the batch axes only and computes on its `tensor` and
`expert` blocks (Megatron splits, `sharding.regions`); every other family
gets whole params and repeats its compute on each rank of those axes,
keeping its block of each gradient. Each gradient is then reduce-scattered
over `fsdp` and all-reduced over `data` (never summed over `tensor` or
`expert`), and summed over `sequence` as well, whose ranks see other
tokens of the same rows; the optimizer runs on the blocks. The loss is
the global batch's: a next-token family's masked-token mean over every
shard's tokens (each rank scales its mean by its shard's share of the
tokens before the backward, the shares summed over the batch axes
alone, data, fsdp and sequence, so a shard counts once), a classifier's
mean over every row, and as it comes
for a family whose loss is already the global batch's (the registry's
`needs_global_batch`: Mixtral's routing and aux loss); `tokens` is the
global count, and `grad_norm` and the clip take the norm over every
block once (a replicated leaf from one holder). On a `stage` axis past
one rank a family with the registry's `pipelines` (the Llama decoder
and its LoRA) runs the GPipe schedule (`parallel/pipeline.py`): its
stacked layer leaves stay split over `stage` while it computes, each
rank running its stage's slab over microbatches of its rows, and the
leaves outside the slabs (embed, final_norm, lm_head) get their
gradients in parts, the embedding's on the first stage and the tail's
on the last, summed over `stage`; the stage ranks see the same rows, so
`stage` is not a batch axis for the loss's weight. Every other family
gathers its slabs over `stage` as over the batch axes and repeats its
compute on each stage rank, keeping its block of each gradient. A step
holds every whole param and then every whole gradient at once before
reducing them, so a rank's peak is the whole f32 params and grads (whole over the batch
axes) plus its blocks and the activations: at Llama-3-8B widths about 64
GB before the blocks without a tensor split, which is why full 8B
training does not fit a rank yet (ROADMAP.md A6a, the per-layer gather).
"""

from __future__ import annotations

import dataclasses
import json
import math
import time
from typing import Any, Callable, Iterator

import numpy as np
import torch

from kubeflow_tpu_torch._device import check_one_card_mesh, resolve_device
from kubeflow_tpu_torch.models import registry
from kubeflow_tpu_torch.parallel import mesh as mesh_lib
from kubeflow_tpu_torch.parallel import sharding
from kubeflow_tpu_torch.training.data import DatasetConfig
from kubeflow_tpu_torch.training.metrics_writer import MetricsWriter

@dataclasses.dataclass
class OptimizerConfig:
    name: str = "adamw"
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.01
    grad_clip: float = 1.0
    b1: float = 0.9
    b2: float = 0.95
    schedule: str = "cosine"   # cosine | linear | constant
    mu_dtype: str | None = None   # e.g. "bfloat16": first moment storage
    # only leaves whose "/"-joined path starts with this train (e.g.
    # "lora" for llama_lora); the others are frozen, with no state
    trainable_prefix: str | None = None


def make_schedule(cfg: OptimizerConfig) -> Callable[[int], float]:
    """lr at an update count, as optax's schedules compute it."""
    lr = cfg.learning_rate
    if cfg.schedule == "cosine":
        warmup = cfg.warmup_steps
        decay = max(cfg.total_steps, warmup + 1) - warmup

        def sched(count: int) -> float:
            if count < warmup:   # linear 0 -> lr over warmup steps
                return lr * min(count, warmup) / warmup
            c = min(count - warmup, decay)
            return lr * 0.5 * (1 + math.cos(math.pi * c / decay))
        return sched
    if cfg.schedule == "linear":   # lr -> 0 over total_steps
        total = cfg.total_steps

        def sched(count: int) -> float:
            if total <= 0:
                return lr
            return lr * (1 - min(max(count, 0), total) / total)
        return sched
    if cfg.schedule == "constant":
        return lambda count: lr
    raise ValueError(f"unknown schedule {cfg.schedule!r}")


def named_leaves(tree, path: str = "") -> list[tuple[str, torch.Tensor]]:
    """(the "/"-joined key path, tensor) of the leaves of nested dicts
    and lists, dict keys in sorted order and lists in theirs (jax's)."""
    if isinstance(tree, dict):
        items = [(k, tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        items = list(enumerate(tree))
    else:
        return [(path, tree)]
    return [item for k, v in items
            for item in named_leaves(v, f"{path}/{k}" if path else str(k))]


def leaves(tree) -> list[torch.Tensor]:
    """The tensors of nested dicts and lists, in jax's order."""
    return [t for _, t in named_leaves(tree)]


def global_norm(tensors: list[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in f32 (one fused
    norm per tensor, then the norm of those)."""
    norms = torch._foreach_norm([t.float() for t in tensors])
    return torch.linalg.vector_norm(torch.stack(norms))


def _times(decay: float, moment: torch.Tensor) -> torch.Tensor:
    """decay * moment in the moment's dtype, the scalar rounded to it
    first (a python float is weak-typed in JAX)."""
    if moment.dtype == torch.float32:
        return moment * decay
    return torch.tensor(decay, dtype=moment.dtype) * moment


def _f32(x: float) -> float:
    """x rounded to f32, as optax evaluates its scalars."""
    return float(np.float32(x))


class Optimizer:
    """The optax chain of make_optimizer over a list of param tensors.
    State is {"count": int, "mu": [...], "nu": [...]} for adam/adamw and
    {"count": int, "trace": [...]} for sgd, one entry per trainable
    param: with `trainable_prefix` set and the params' paths given
    (`named_leaves`), the frozen ones have none."""

    def __init__(self, cfg: OptimizerConfig):
        if cfg.name not in ("adamw", "adam", "sgd"):
            raise ValueError(f"unknown optimizer {cfg.name!r}")
        self.cfg = cfg
        self.schedule = make_schedule(cfg)
        self.mu_dtype = getattr(torch, cfg.mu_dtype) if cfg.mu_dtype else None

    def trainable(self, path: str) -> bool:
        """True when the leaf at "/"-joined `path` trains: its keys start
        with the prefix's (every leaf without a prefix)."""
        if not self.cfg.trainable_prefix:
            return True
        want = self.cfg.trainable_prefix.split("/")
        return path.split("/")[:len(want)] == want

    def trainable_indices(self, n: int,
                          paths: list[str] | None) -> list[int]:
        """The positions of the trainable params among n (all of them
        without paths)."""
        if paths is None:
            return list(range(n))
        return [i for i, p in enumerate(paths) if self.trainable(p)]

    def init(self, params: list[torch.Tensor],
             paths: list[str] | None = None) -> dict[str, Any]:
        params = [params[i] for i in self.trainable_indices(len(params),
                                                            paths)]

        def zeros(p, dtype=None):
            return torch.zeros_like(p, dtype=dtype or p.dtype,
                                    requires_grad=False)
        if self.cfg.name == "sgd":
            return {"count": 0,
                    "trace": [zeros(p, self.mu_dtype) for p in params]}
        return {"count": 0, "mu": [zeros(p, self.mu_dtype) for p in params],
                "nu": [zeros(p) for p in params]}

    @torch.no_grad()
    def update(self, grads: list[torch.Tensor | None], state: dict[str, Any],
               params: list[torch.Tensor],
               paths: list[str] | None = None,
               norm: torch.Tensor | None = None) -> None:
        """One update of the trainable `params` in place; `state` and
        `grads` (which the caller hands over) are updated in place too, to
        keep the passes over the f32 state few. A frozen param's grad may
        be None (counted as zeros by the clip); a given one still counts
        in the global norm, as optax clips before multi_transform. `norm`
        is the gradients' global norm when the caller has it (a sharded
        trainer's norm over every rank's blocks)."""
        cfg = self.cfg
        grads = [None if g is None else g.float() for g in grads]
        if cfg.grad_clip:
            # optax: keep when norm < max_norm, else scale by max_norm /
            # norm (1 where kept, so no host sync is needed)
            present = [g for g in grads if g is not None]
            if norm is None:
                norm = global_norm(present)
            factor = torch.where(norm < cfg.grad_clip, torch.ones_like(norm),
                                 cfg.grad_clip / norm)
            torch._foreach_mul_(present, factor)
        count = state["count"]
        lr = self.schedule(count)
        if cfg.name != "sgd":
            bc1 = 1 - cfg.b1 ** float(count + 1)
            bc2 = 1 - cfg.b2 ** float(count + 1)
        idx = self.trainable_indices(len(params), paths)
        for i, (g, p) in enumerate(zip([grads[j] for j in idx],
                                       [params[j] for j in idx])):
            if cfg.name == "sgd":
                u = _times(0.9, state["trace"][i]).float().add_(g)
                state["trace"][i].copy_(u)
            else:
                mu = _times(cfg.b1, state["mu"][i]).float()
                mu.add_(g, alpha=1 - cfg.b1)
                nu = state["nu"][i].mul_(cfg.b2)
                nu.addcmul_(g, g, value=1 - cfg.b2)
                state["mu"][i].copy_(mu)
                u = mu.div_(_f32(bc1)).div_(
                    (nu / _f32(bc2)).sqrt_().add_(1e-8))
                if cfg.name == "adamw":
                    u.add_(p, alpha=cfg.weight_decay)
            p.add_(u, alpha=-_f32(lr))
        state["count"] = count + 1


def make_optimizer(cfg: OptimizerConfig) -> Optimizer:
    return Optimizer(cfg)


@dataclasses.dataclass
class TrainerConfig:
    model: str = "llama"
    model_overrides: dict[str, Any] = dataclasses.field(default_factory=dict)
    batch_size: int = 8
    optimizer: OptimizerConfig = dataclasses.field(
        default_factory=OptimizerConfig)
    dataset: DatasetConfig = dataclasses.field(default_factory=DatasetConfig)
    seed: int = 0
    log_every: int = 10
    checkpoint_dir: str | None = None
    checkpoint_every: int = 200
    keep_checkpoints: int = 3
    # step-windowed torch.profiler capture; None disables
    profile_dir: str | None = None
    profile_start_step: int = 2
    profile_num_steps: int = 3
    # the job's mesh (a MeshConfig or its dict) and logical-axis rules
    # over DEFAULT_RULES
    mesh: mesh_lib.MeshConfig = dataclasses.field(
        default_factory=mesh_lib.MeshConfig)
    sharding_rules: dict[str, Any] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        self.mesh = mesh_lib.mesh_config(self.mesh)

    @staticmethod
    def from_dict(raw: dict[str, Any]) -> "TrainerConfig":
        """A trainer config from the keys of a job's KTPU_TRAINER_CONFIG
        (examples/llama-jaxjob.yaml). `num_steps` sets the schedule's
        total_steps unless the optimizer pins it, as the JAX job does.
        `mesh` takes data and fsdp at any size; an axis past one card
        needs a process group (`runtime.initialize_distributed`), and the
        axes not ported yet raise naming their ROADMAP.md item."""
        raw = dict(raw)
        num_steps = raw.pop("num_steps", None)
        opt = dict(raw.pop("optimizer", {}))
        dataset = raw.pop("dataset", {})
        mesh = mesh_lib.mesh_config(raw.pop("mesh", {}))
        check_mesh(mesh, raw.get("model", "llama"))
        known = {f.name for f in dataclasses.fields(TrainerConfig)}
        unknown = set(raw) - known
        if unknown:
            raise ValueError(f"unknown or not yet ported trainer config "
                             f"keys: {sorted(unknown)}")
        if num_steps is not None and "total_steps" not in opt:
            opt["total_steps"] = int(num_steps)
        return TrainerConfig(**raw, optimizer=OptimizerConfig(**opt),
                             dataset=DatasetConfig(**dataset), mesh=mesh)


def _group_running() -> bool:
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def _world_size() -> int:
    """The process group's size, 1 when none is running."""
    import torch.distributed as dist

    return dist.get_world_size() if _group_running() else 1


def check_sequence(model: str, sizes: dict[str, int]) -> None:
    """A `sequence` axis past one rank needs a family that splits its
    sequence (the registry's `splits_sequence`, the Llama family); any
    other raises naming ROADMAP.md queue A6b-ii."""
    n = sizes.get("sequence", 1)
    if n in (1, -1) or registry.get(model).splits_sequence:
        return
    families = sorted(name for name in registry.names()
                      if registry.get(name).splits_sequence)
    raise ValueError(
        f"mesh axis sequence={n}: {model!r} does not split its sequence yet "
        f"(ROADMAP.md queue A6b-ii); the families that do: {families}")


def check_mesh(mesh: mesh_lib.MeshConfig, model: str = "llama") -> None:
    """The axes not ported yet raise naming their ROADMAP.md item, and so
    does a `sequence` axis for a family that does not split its sequence
    (`check_sequence`); a mesh that wants more ranks than the process
    group has raises too (one card when no group is running)."""
    sizes = mesh.axis_sizes()
    check_sequence(model, sizes)
    want = math.prod(n for n in sizes.values() if n != -1)
    world = _world_size()
    if want > world:
        raise ValueError(
            f"mesh {sizes} wants {want} ranks but the process group has "
            f"{world}" + ("" if world > 1 else
                          ": without a process group the port runs on one "
                          "card (start one with "
                          "runtime.initialize_distributed)"))


#: metrics a sharded step sums over the ranks; every other metric is a
#: mean over the global batch
SUMMED_METRICS = ("tokens",)


class Trainer:
    """One registered model's train step: forward, loss, backward
    (autograd, through the attention kernels' backward) and the optimizer
    update, eagerly, on one device, or on this rank's card of `mesh`
    (sharded only when given one)."""

    def __init__(self, config: TrainerConfig, *, device="cuda", mesh=None,
                 metrics: MetricsWriter | None = None):
        self.config = config
        self.device = resolve_device(device)
        self.model = registry.get(config.model)
        self.model_cfg = self.model.config_cls(**config.model_overrides)
        self.optimizer = make_optimizer(config.optimizer)
        self.metrics = metrics or MetricsWriter()
        self.mesh = mesh
        self.layout = None
        if mesh is None:
            check_one_card_mesh(config.mesh.axis_sizes())
        else:
            self.layout = self._layout()

    # -- the sharded state ---------------------------------------------------

    def _layout(self) -> "StateLayout":
        import torch.distributed as dist

        mesh = self.mesh
        check_sequence(self.config.model, mesh_lib.mesh_shape(mesh))
        if mesh.mesh.numel() != dist.get_world_size():
            raise ValueError(
                f"the trainer's mesh holds {mesh.mesh.numel()} of the "
                f"{dist.get_world_size()} ranks; give it every rank")
        mesh_lib.validate_divisibility(mesh, batch=self.config.batch_size)
        abstract = self.model.abstract(self.model_cfg)
        named = named_leaves(abstract)
        paths = [p for p, _ in named]
        axes = sharding.axes_by_path(self.model.logical_axes(self.model_cfg))
        if set(axes) != set(paths):
            raise ValueError(
                f"{self.config.model}'s logical_axes do not match its "
                f"params: {sorted(set(axes) ^ set(paths))}")
        # a family on local blocks gathers over the batch axes alone; a
        # pipelined one on a stage axis keeps its stage's slab too, and
        # the whole leaves' gradients come in parts over `stage`
        staged = (("stage",) if self.model.pipelines and mesh_lib.mesh_shape(
            mesh).get("stage", 1) > 1 else ())
        kept = (("tensor", "expert") if self.model.local_blocks else ()) \
            + staged
        gathered = tuple(a for a in mesh.mesh_dim_names if a not in kept)
        return StateLayout(mesh, {
            p: sharding.spec_placements(sharding.logical_to_spec(
                axes[p], self.config.sharding_rules), mesh)
            for p in paths}, {p: t.shape for p, t in named},
            [paths[i] for i in self.optimizer.trainable_indices(
                len(paths), paths)], self.device, gathered,
            partial=staged)

    def abstract_state(self) -> dict[str, Any]:
        """The train state's shapes and dtypes as meta tensors, params
        requiring grad as init_state's do (the checkpoint restore's
        target; no memory is touched)."""
        return self._state(self.model.abstract(self.model_cfg))

    def init_state(self, params=None) -> dict[str, Any]:
        """{"params", "opt_state", "step"}: params from the model's init at
        config.seed unless given (e.g. converted from the JAX package).
        Only trainable params require grad; the frozen ones get no
        optimizer state. On a mesh every leaf is this rank's block of it
        (a DTensor), kept as the leaf is made."""
        if self.layout is not None:
            lay = self.layout
            if params is None:
                blocks = self.model.init(self.model_cfg,
                                         seed=self.config.seed,
                                         device=self.device, keep=lay.keep)
                params = _map_leaves(blocks, lay.wrap_param)
            else:
                params = _map_leaves(params, lambda path, t: lay.distribute(
                    "params/" + path, t))
            return self._sharded_state(params)
        if params is None:
            params = self.model.init(self.model_cfg, seed=self.config.seed,
                                     device=self.device)
        return self._state(params)

    def _sharded_state(self, params) -> dict[str, Any]:
        """The state around sharded params: each trainable param's moments
        as DTensors of its placements."""
        named = named_leaves(params)
        paths = [path for path, _ in named]
        opt = self.optimizer.init([p.to_local() for _, p in named], paths)
        for key, moments in opt.items():
            if isinstance(moments, list):
                opt[key] = [self.layout.wrap(f"opt_state/{key}/{j}", m)
                            for j, m in enumerate(moments)]
        return {"params": params, "opt_state": opt, "step": 0}

    def restore_leaf(self, path: str, full: torch.Tensor):
        """A checkpoint restore's `keep`: this rank's block of the state
        leaf at `path`, as a DTensor on the device (None off a mesh)."""
        if self.layout is None:
            return None
        return self.layout.distribute(path, full)

    def _state(self, params) -> dict[str, Any]:
        named = named_leaves(params)
        paths = [path for path, _ in named]
        for path, p in named:
            p.requires_grad_(self.optimizer.trainable(path))
        return {"params": params,
                "opt_state": self.optimizer.init([p for _, p in named],
                                                 paths),
                "step": 0}

    def to_device(self, batch: dict[str, Any]) -> dict[str, torch.Tensor]:
        """A host batch on the device; on a mesh, this rank's rows of the
        global batch (the block of PartitionSpec(("data", "fsdp")) at its
        coordinate) and, on a `sequence` axis past one rank, its columns
        of them with the targets by global position
        (`sequence_columns`)."""
        batch = {k: np.asarray(v) for k, v in batch.items()}
        if self.layout is not None:
            n = mesh_lib.num_data_shards(self.mesh)
            i = mesh_lib.data_shard_index(self.mesh)
            for v in batch.values():
                mesh_lib.validate_divisibility(self.mesh, batch=v.shape[0])
            batch = {k: v[i * (v.shape[0] // n):(i + 1) * (v.shape[0] // n)]
                     for k, v in batch.items()}
            n_seq = mesh_lib.mesh_shape(self.mesh)["sequence"]
            if n_seq > 1:
                j = self.mesh.get_coordinate()[
                    self.mesh.mesh_dim_names.index("sequence")]
                batch = sequence_columns(batch, n_seq, j)
        return {k: torch.as_tensor(v).to(self.device)
                for k, v in batch.items()}

    def train_step(self, state: dict[str, Any],
                   batch: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        """One step in place on `state`; returns the step's metrics as
        0-d tensors (loss, tokens, grad_norm before clipping)."""
        if self.layout is not None:
            return self._sharded_step(state, batch)
        named = named_leaves(state["params"])
        paths = [path for path, _ in named]
        params = [p for _, p in named]
        idx = self.optimizer.trainable_indices(len(params), paths)
        loss, metrics = self.model.loss_fn(state["params"], batch,
                                           self.model_cfg)
        # frozen params take no gradient: None stands for their zeros
        grads: list[torch.Tensor | None] = [None] * len(params)
        for i, g in zip(idx, torch.autograd.grad(
                loss, [params[i] for i in idx])):
            grads[i] = g
        out = {k: v.detach() for k, v in metrics.items()}
        out["grad_norm"] = global_norm([g for g in grads if g is not None])
        self.optimizer.update(grads, state["opt_state"], params, paths)
        state["step"] += 1
        return out

    def _sharded_step(self, state: dict[str, Any],
                      batch: dict[str, torch.Tensor]
                      ) -> dict[str, torch.Tensor]:
        out, grads = self.sharded_grads(state, batch)
        named = named_leaves(state["params"])
        paths = [path for path, _ in named]
        opt = state["opt_state"]
        local = {k: ([m.to_local() for m in v] if isinstance(v, list) else v)
                 for k, v in opt.items()}
        self.optimizer.update(grads, local, [p.to_local() for _, p in named],
                              paths, norm=out["grad_norm"])
        opt["count"] = local["count"]
        state["step"] += 1
        return out

    def sharded_grads(self, state: dict[str, Any],
                      batch: dict[str, torch.Tensor]
                      ) -> tuple[dict[str, torch.Tensor], list]:
        """A sharded step's metrics (global, with `grad_norm`) and each
        param's gradient as this rank's block (None for a frozen one),
        before the optimizer runs."""
        lay = self.layout
        mesh = lay.mesh
        named = named_leaves(state["params"])
        paths = [path for path, _ in named]
        blocks = [p for _, p in named]
        idx = self.optimizer.trainable_indices(len(blocks), paths)
        trains = set(idx)
        # params as plain tensors (whole over the gathered axes): the
        # family code and the kernels never see a DTensor
        full = [sharding.gather(p.to_local(), mesh, p.placements,
                                lay.gathered)
                .detach().requires_grad_(i in trains)
                for i, p in enumerate(blocks)]
        with mesh_lib.active_mesh(mesh):
            loss, metrics = self.model.loss_fn(
                _rebuild(state["params"], iter(full)), batch,
                self.model_cfg)
        global_loss = self.model.needs_global_batch
        batch_sum = sharding.regions(mesh).sum_batch
        if global_loss:   # the family's loss is the global batch's already
            scale = None
        else:
            # the global batch's mean: this rank's mean times its shard's
            # share of the global weight (tokens counted by the loss, else
            # rows), summed over the batch axes alone (the ranks of one
            # shard see the same tokens); exactly 1 on one shard
            first = next(iter(batch.values()))
            weight = (metrics["tokens"].detach().float()
                      if "tokens" in metrics
                      else torch.tensor(float(first.shape[0]),
                                        device=first.device))
            total = batch_sum(weight)
            scale = weight / total.clamp_min(1.0)
            loss = loss * scale
        # a stage's loss reaches only its own leaves (the embedding on
        # the first, the tail on the last): the others' part is zero;
        # off a stage axis every trainable leaf must be reached
        full_grads = list(torch.autograd.grad(
            loss, [full[i] for i in idx], allow_unused=bool(lay.partial),
            materialize_grads=bool(lay.partial)))
        del full, loss
        grads: list[torch.Tensor | None] = [None] * len(blocks)
        for j, i in enumerate(idx):
            grads[i] = sharding.reduce_grad(full_grads[j], mesh,
                                            blocks[i].placements,
                                            lay.gathered, lay.partial)
            full_grads[j] = None
        norm = lay.global_norm([(grads[i], blocks[i].placements)
                                for i in idx])
        keys = list(metrics)
        summed = [k in SUMMED_METRICS for k in keys]
        vec = torch.stack([
            metrics[k].detach().float() if s or global_loss
            else metrics[k].detach().float() * scale
            for k, s in zip(keys, summed)])
        if global_loss:   # only the counts are this shard's
            mask = torch.tensor(summed, device=vec.device)
            vec = torch.where(mask, batch_sum(vec * mask), vec)
        else:
            vec = batch_sum(vec)
        out = dict(zip(keys, vec.unbind()))
        out["grad_norm"] = norm
        return out, grads

    def train(self, data: Iterator[dict[str, Any]], num_steps: int,
              state: dict[str, Any] | None = None,
              step_callback: Callable[[int, dict], None] | None = None):
        """Run num_steps steps; log loss, tokens, grad_norm and step_time_s
        every log_every steps and on the last. The first interval carries
        includes_compile (the kernels build on first use). With
        profile_dir, steps [profile_start_step, + profile_num_steps) of
        this run (counted from its first step, as in the JAX trainer) are
        captured there. With checkpoint_dir, saves as the module doc
        says."""
        state = state if state is not None else self.init_state()
        ckpt = None
        if self.config.checkpoint_dir:
            from kubeflow_tpu_torch.training.checkpoint import (
                CheckpointManager)

            ckpt = CheckpointManager(
                self.config.checkpoint_dir,
                max_to_keep=self.config.keep_checkpoints,
                save_interval_steps=self.config.checkpoint_every)
        start = state["step"]
        t_last = time.perf_counter()
        since = 0
        first = True
        prof = None
        if self.config.profile_dir:
            from kubeflow_tpu_torch.training.profiling import StepProfiler

            # the window is relative to this run's first step: on resume
            # the first-use costs come again, and profile_start_step
            # exists to skip them
            prof = StepProfiler(self.config.profile_dir,
                                start + self.config.profile_start_step,
                                self.config.profile_num_steps)
        for i in range(num_steps):
            step = start + i + 1
            if prof is not None:
                prof.maybe_start(step)
            metrics = self.train_step(state, self.to_device(next(data)))
            since += 1
            if prof is not None:
                prof.maybe_stop(step, sync=self._sync)
            if step % self.config.log_every == 0 or i == num_steps - 1:
                scalars = {k: float(v) for k, v in metrics.items()}
                now = time.perf_counter()
                scalars["step_time_s"] = (now - t_last) / since
                t_last, since = now, 0
                if first:
                    scalars["includes_compile"] = 1.0
                    first = False
                self.metrics.write(step, scalars)
                if step_callback:
                    step_callback(step, scalars)
            if ckpt is not None:
                # the manager applies the interval; the last step is
                # forced below
                self._save(ckpt, step, state)
        if prof is not None:
            prof.close()
        if ckpt is not None:
            final = start + num_steps
            # the interval may have saved it already (on a mesh, rank
            # 0's directory decides for every rank)
            self._save(ckpt, final, state,
                       force=ckpt.latest_step() != final)
            ckpt.close()
        return state

    def _save(self, ckpt, step: int, state: dict[str, Any],
              force: bool = False) -> None:
        if ckpt.save(step, state, force=force) and self.metrics.echo \
                and ckpt.last_save is not None:
            print(f"[checkpoint {step}] {json.dumps(ckpt.last_save)}",
                  flush=True)

    def _sync(self) -> None:
        """Wait for the card's queued work (nothing to wait for on the
        CPU)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


def sequence_columns(batch: dict[str, np.ndarray], n: int,
                     j: int) -> dict[str, np.ndarray]:
    """The columns [j S/n, (j + 1) S/n) of every [B, S] entry of a host
    batch, with `targets` and `target_mask` added by global position
    first: position i's target is token i + 1, weighted by the loss_mask
    there (or 1), and the global last position has none, as the JAX loss
    shifts the whole sequence. A shard's last column so takes the next
    shard's first token."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    if s % n:
        raise ValueError(f"seq={s} not divisible by mesh factor {n}")
    weights = np.ones((b, s), np.float32)
    weights[:, -1] = 0.0
    if "loss_mask" in batch:
        weights[:, :-1] *= batch["loss_mask"][:, 1:]
    full = dict(batch, target_mask=weights, targets=np.concatenate(
        [tokens[:, 1:], tokens[:, :1]], axis=1))
    c = s // n
    return {k: v[:, j * c:(j + 1) * c] for k, v in full.items()}


def _map_leaves(tree, fn, path: str = ""):
    """Nested dicts and lists with fn(path, leaf) at each tensor, path the
    "/"-joined keys (`named_leaves`' paths)."""
    if isinstance(tree, dict):
        return {k: _map_leaves(v, fn, f"{path}/{k}" if path else str(k))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_leaves(v, fn, f"{path}/{i}" if path
                                      else str(i))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def _rebuild(tree, values: Iterator):
    """`tree`'s structure with its leaves replaced, in `named_leaves`'
    order, by the next items of `values`."""
    if isinstance(tree, dict):
        out = {k: _rebuild(tree[k], values) for k in sorted(tree)}
        return {k: out[k] for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, values) for v in tree)
    return next(values)


class StateLayout:
    """Where each leaf of a sharded train state lives: its placements on
    the mesh (moments as their param), its whole shape, the mesh dims a
    step gathers it over, and the per-leaf moves between whole tensors
    and this rank's blocks."""

    def __init__(self, mesh, placements: dict[str, tuple],
                 shapes: dict[str, torch.Size], trainable: list[str],
                 device: torch.device, gathered: tuple[str, ...],
                 partial: tuple[str, ...] = ()):
        self.mesh = mesh
        self.device = device
        # the mesh dims a step gathers the params over (and so over which
        # a gradient comes whole)
        self.gathered = gathered
        # the mesh dims over which a replicated leaf's gradient comes in
        # parts (`sharding.reduce_grad`)
        self.partial = partial
        self.placements = {"params/" + p: pl for p, pl in placements.items()}
        self.shapes = {"params/" + p: s for p, s in shapes.items()}
        for j, p in enumerate(trainable):
            for key in ("mu", "nu", "trace"):
                self.placements[f"opt_state/{key}/{j}"] = placements[p]
                self.shapes[f"opt_state/{key}/{j}"] = shapes[p]
        for path, pl in self.placements.items():
            sharding.check_divisible(self.shapes[path], mesh, pl, path)
        self._holders: dict[tuple, torch.Tensor] = {}

    def keep(self, path: str, t: torch.Tensor, layer: int | None = None
             ) -> torch.Tensor | None:
        """An init's `keep`: a copy of this rank's block of the param leaf
        at `path` (of its layer `layer` for a stacked leaf made layer by
        layer; None for a layer outside this rank's `stage` slab), so the
        whole leaf can be freed."""
        path = "params/" + path
        block = sharding.local_chunk(t, self.mesh, self.placements[path],
                                     layer, self.shapes[path][0])
        if block is None:
            return None
        return block.clone(memory_format=torch.contiguous_format)

    def wrap(self, path: str, block: torch.Tensor):
        """The DTensor of a state leaf from this rank's block."""
        from torch.distributed.tensor import DTensor

        shape = self.shapes[path]
        return DTensor.from_local(
            block, self.mesh, self.placements[path], run_check=False,
            shape=shape, stride=torch.empty(shape, device="meta").stride())

    def wrap_param(self, path: str, block: torch.Tensor):
        return self.wrap("params/" + path, block)

    def distribute(self, path: str, full: torch.Tensor):
        """The DTensor of a state leaf from its whole tensor (this rank's
        block copied to the device); None for a path with no placement."""
        pl = self.placements.get(path)
        if pl is None:
            return None
        return sharding.distribute(full, self.mesh, pl, self.device)

    def global_norm(self, grads: list[tuple[torch.Tensor, tuple]]
                    ) -> torch.Tensor:
        """The norm of the whole gradients from the blocks: each block's
        norm, gathered from every rank, each leaf's taken once from the
        ranks that hold one copy of it, in leaf order (on one rank the
        unsharded trainer's vector of norms)."""
        import torch.distributed as dist

        local = torch.stack(torch._foreach_norm([g.float()
                                                 for g, _ in grads]))
        every = torch.empty((dist.get_world_size(), local.numel()),
                            dtype=local.dtype, device=local.device)
        dist.all_gather_into_tensor(every, local[None])
        parts = []
        for j, (_, pl) in enumerate(grads):
            if pl not in self._holders:
                self._holders[pl] = sharding.holders(self.mesh, pl).to(
                    every.device)
            parts.append(every[self._holders[pl], j])
        return torch.linalg.vector_norm(torch.cat(parts))
