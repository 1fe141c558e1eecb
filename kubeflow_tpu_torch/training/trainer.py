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
(training/profiling.py `StepProfiler`). Checkpointing, LoRA
(trainable_prefix) and meshes are not ported yet (ROADMAP.md).
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Callable, Iterator

import numpy as np
import torch

from kubeflow_tpu_torch._device import resolve_device
from kubeflow_tpu_torch.models import registry
from kubeflow_tpu_torch.training.data import DatasetConfig
from kubeflow_tpu_torch.training.metrics_writer import MetricsWriter

MESH_AXES = ("data", "fsdp", "stage", "expert", "sequence", "tensor")


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


def leaves(tree) -> list[torch.Tensor]:
    """The tensors of a nested dict, in sorted key order (jax's)."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in leaves(tree[k])]
    return [tree]


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
    {"count": int, "trace": [...]} for sgd."""

    def __init__(self, cfg: OptimizerConfig):
        if cfg.name not in ("adamw", "adam", "sgd"):
            raise ValueError(f"unknown optimizer {cfg.name!r}")
        self.cfg = cfg
        self.schedule = make_schedule(cfg)
        self.mu_dtype = getattr(torch, cfg.mu_dtype) if cfg.mu_dtype else None

    def init(self, params: list[torch.Tensor]) -> dict[str, Any]:
        def zeros(p, dtype=None):
            return torch.zeros_like(p, dtype=dtype or p.dtype,
                                    requires_grad=False)
        if self.cfg.name == "sgd":
            return {"count": 0,
                    "trace": [zeros(p, self.mu_dtype) for p in params]}
        return {"count": 0, "mu": [zeros(p, self.mu_dtype) for p in params],
                "nu": [zeros(p) for p in params]}

    @torch.no_grad()
    def update(self, grads: list[torch.Tensor], state: dict[str, Any],
               params: list[torch.Tensor]) -> None:
        """One update of `params` in place; `state` and `grads` (which
        the caller hands over) are updated in place too, to keep the
        passes over the f32 state few."""
        cfg = self.cfg
        grads = [g.float() for g in grads]
        if cfg.grad_clip:
            # optax: keep when norm < max_norm, else scale by max_norm /
            # norm (1 where kept, so no host sync is needed)
            norm = global_norm(grads)
            factor = torch.where(norm < cfg.grad_clip, torch.ones_like(norm),
                                 cfg.grad_clip / norm)
            torch._foreach_mul_(grads, factor)
        count = state["count"]
        lr = self.schedule(count)
        if cfg.name != "sgd":
            bc1 = 1 - cfg.b1 ** float(count + 1)
            bc2 = 1 - cfg.b2 ** float(count + 1)
        for i, (g, p) in enumerate(zip(grads, params)):
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
    # step-windowed torch.profiler capture; None disables
    profile_dir: str | None = None
    profile_start_step: int = 2
    profile_num_steps: int = 3

    @staticmethod
    def from_dict(raw: dict[str, Any]) -> "TrainerConfig":
        """A trainer config from the keys of a job's KTPU_TRAINER_CONFIG
        (examples/llama-jaxjob.yaml). `num_steps` sets the schedule's
        total_steps unless the optimizer pins it, as the JAX job does;
        `mesh` is accepted only when every axis is 1 or -1 (one card)."""
        raw = dict(raw)
        num_steps = raw.pop("num_steps", None)
        opt = dict(raw.pop("optimizer", {}))
        dataset = raw.pop("dataset", {})
        for axis, n in raw.pop("mesh", {}).items():
            if axis not in MESH_AXES:
                raise ValueError(f"unknown mesh axis {axis!r}")
            if n not in (1, -1):
                raise ValueError(
                    f"mesh axis {axis}={n}: the trainer runs on one card "
                    "(multi-card meshes are queued in ROADMAP.md)")
        known = {f.name for f in dataclasses.fields(TrainerConfig)}
        unknown = set(raw) - known
        if unknown:
            raise ValueError(f"unknown or not yet ported trainer config "
                             f"keys: {sorted(unknown)}")
        if num_steps is not None and "total_steps" not in opt:
            opt["total_steps"] = int(num_steps)
        return TrainerConfig(**raw, optimizer=OptimizerConfig(**opt),
                             dataset=DatasetConfig(**dataset))


class Trainer:
    """One registered model's train step on one device: forward, loss,
    backward (autograd, through the attention kernels' backward) and the
    optimizer update, eagerly."""

    def __init__(self, config: TrainerConfig, *, device="cuda",
                 metrics: MetricsWriter | None = None):
        self.config = config
        self.device = resolve_device(device)
        self.model = registry.get(config.model)
        self.model_cfg = self.model.config_cls(**config.model_overrides)
        self.optimizer = make_optimizer(config.optimizer)
        self.metrics = metrics or MetricsWriter()

    def init_state(self, params=None) -> dict[str, Any]:
        """{"params", "opt_state", "step"}: params from the model's init at
        config.seed unless given (e.g. converted from the JAX package)."""
        if params is None:
            params = self.model.init(self.model_cfg, seed=self.config.seed,
                                     device=self.device)
        for p in leaves(params):
            p.requires_grad_(True)
        return {"params": params,
                "opt_state": self.optimizer.init(leaves(params)),
                "step": 0}

    def to_device(self, batch: dict[str, Any]) -> dict[str, torch.Tensor]:
        return {k: torch.as_tensor(np.asarray(v)).to(self.device)
                for k, v in batch.items()}

    def train_step(self, state: dict[str, Any],
                   batch: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        """One step in place on `state`; returns the step's metrics as
        0-d tensors (loss, tokens, grad_norm before clipping)."""
        params = leaves(state["params"])
        loss, metrics = self.model.loss_fn(state["params"], batch,
                                           self.model_cfg)
        grads = torch.autograd.grad(loss, params)
        out = {k: v.detach() for k, v in metrics.items()}
        out["grad_norm"] = global_norm(list(grads))
        self.optimizer.update(list(grads), state["opt_state"], params)
        state["step"] += 1
        return out

    def train(self, data: Iterator[dict[str, Any]], num_steps: int,
              state: dict[str, Any] | None = None,
              step_callback: Callable[[int, dict], None] | None = None):
        """Run num_steps steps; log loss, tokens, grad_norm and step_time_s
        every log_every steps and on the last. The first interval carries
        includes_compile (the kernels build on first use). With
        profile_dir, steps [profile_start_step, + profile_num_steps) of
        this run (counted from its first step, as in the JAX trainer) are
        captured there."""
        state = state if state is not None else self.init_state()
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
        if prof is not None:
            prof.close()
        return state

    def _sync(self) -> None:
        """Wait for the card's queued work (nothing to wait for on the
        CPU)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
