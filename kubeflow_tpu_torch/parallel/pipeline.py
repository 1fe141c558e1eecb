"""The stage split (counterpart of kubeflow_tpu/parallel/pipeline.py):
the GPipe training schedule over the mesh's `stage` axis, and the
geometry, placement and accounting of stage-sharded serving
(`serving/multichip.py` `StageShardedEngine`).

Training (`gpipe`, `microbatch`, `pipelined_llama_loss`): the stacked
[L, ...] layer leaves are split over `stage`, so each rank of the stage
group holds a contiguous L/S slab. A step cuts the rank's rows into M
microbatches; stage 0 embeds them, each stage applies its slab to each
microbatch in turn and sends the result to the next stage, and the last
stage runs the loss tail and sends the loss to the group. Stage s works
microbatch m while stage s - 1 works m + 1 (the GPipe wavefront): the
point-to-point messages alone order the stages, and the warmup and
drain ticks, which JAX runs on garbage and masks, do not run at all.
The backward is one autograd Function around the whole schedule: its
forward keeps each microbatch's graph, and its backward takes the
microbatches in reverse order on every rank, receiving each one's
output gradient from the next stage (the last stage: from the loss),
running that microbatch's backward and sending its input gradient to
the previous stage. Every message is tagged with its microbatch, and
every rank sends and receives in the same order, so blocking sends
cannot deadlock. Within a stage the `data`, `fsdp`, `tensor` and
`sequence` splits run as they do without one.

Serving: a model of L layers is cut into S contiguous layer slabs; stage
s holds its slab of the stacked [L, ...] weights and that slab's KV cache
[L_s, slots, max_len, kv, hd], so neither the weights nor the cache has
to exist whole on one device. A decode step splits the slots into M
microbatches and runs them through the stages on the GPipe wavefront: at
tick t stage s works microbatch t - s, so stage s decodes microbatch m
while stage s - 1 decodes microbatch m + 1. The bubble, the share of
stage-ticks with nothing to do, is (S - 1) / (M + S - 1) per step.

Placement (`InferenceStagePlan`): stage s runs on devices[s] when at
least S distinct devices are given (by default every visible CUDA device,
or the engine's device); otherwise every stage runs on the engine's
device ("virtual" staging, the JAX engine's on one device): the same
stage programs and the same schedule, without the copies between
devices.

Not here: tensor-parallel stages and `collective_matmul` are ROADMAP.md
A6c-iii. The JAX module's `shard_map_overlap_supported` probes its own
compiler and has no counterpart.
"""

from __future__ import annotations

import os
import time
from typing import Any, Sequence

import torch

#: the environment override of the serving stage schedule: "overlapped"
#: (or "1", "on") or "sync" (or "0", "off"); an explicit engine argument
#: wins over it, and it wins over the default, "sync"
SCHEDULE_ENV = "KTPU_STAGE_OVERLAP"


def resolve_schedule(configured: str | None = None) -> str:
    """The stage schedule: the explicit config ("sync" or "overlapped"),
    else KTPU_STAGE_OVERLAP, else "sync"."""
    if configured is not None:
        if configured not in ("sync", "overlapped"):
            raise ValueError(
                f"unknown stage schedule {configured!r} "
                "(want 'sync' or 'overlapped')")
        return configured
    env = os.environ.get(SCHEDULE_ENV, "").strip().lower()
    if env in ("overlapped", "1", "on"):
        return "overlapped"
    return "sync"


#: the mesh axis the GPipe schedule runs over
AXIS = "stage"


def microbatch(x: torch.Tensor, n: int) -> torch.Tensor:
    """[B, ...] -> [n, B/n, ...]."""
    if x.shape[0] % n:
        raise ValueError(f"batch {x.shape[0]} not divisible by "
                         f"{n} microbatches")
    return x.reshape(n, x.shape[0] // n, *x.shape[1:])


def _leaves(tree: Any) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _map(fn, tree: Any) -> Any:
    """fn at each leaf of nested dicts, lists and tuples, in `_leaves`'
    order."""
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


class _Schedule:
    """One `gpipe` call: the stage function, its params' tree, the side
    inputs and the stage group with this rank's place in it (the
    previous and the next stage's global ranks, None at the ends)."""

    def __init__(self, stage_fn, tree, extras, group):
        import torch.distributed as dist

        self.stage_fn, self.tree, self.extras = stage_fn, tree, extras
        self.group = group
        n, s = ((dist.get_world_size(group), dist.get_rank(group))
                if group is not None else (1, 0))
        self.prev = dist.get_global_rank(group, s - 1) if s > 0 else None
        self.next = (dist.get_global_rank(group, s + 1) if s < n - 1
                     else None)

    def apply(self, params, x: torch.Tensor, i: int) -> torch.Tensor:
        if self.extras is None:
            return self.stage_fn(params, x)
        return self.stage_fn(params, x, _map(lambda e: e[i], self.extras))

    def send(self, t: torch.Tensor, dst: int, i: int) -> None:
        import torch.distributed as dist

        dist.send(t.detach().contiguous(), dst, group=self.group, tag=i)

    def recv(self, like: torch.Tensor, src: int, i: int) -> torch.Tensor:
        import torch.distributed as dist

        t = torch.empty(like.shape, dtype=like.dtype, device=like.device)
        dist.recv(t, src, group=self.group, tag=i)
        return t


class _GPipe(torch.autograd.Function):
    """The schedule as one autograd node (module doc): forward and
    backward of every microbatch of this rank's stage, in a fixed order,
    with the stage's neighbours."""

    @staticmethod
    def forward(ctx, run: _Schedule, x_mb: torch.Tensor, *leaves):
        params = [p.detach().requires_grad_(p.requires_grad)
                  for p in leaves]
        it = iter(params)
        tree = _map(lambda _: next(it), run.tree)
        ins, outs = [], []
        for i in range(x_mb.shape[0]):
            if run.prev is None:
                x = x_mb[i].detach().requires_grad_(x_mb.requires_grad)
            else:
                x = run.recv(x_mb[i], run.prev, i).requires_grad_()
            with torch.enable_grad():
                y = run.apply(tree, x, i)
            if run.next is not None:
                run.send(y, run.next, i)
            ins.append(x)
            outs.append(y)
        ctx.run, ctx.params, ctx.ins, ctx.outs = run, params, ins, outs
        if run.next is None:
            return torch.stack([y.detach() for y in outs])
        return outs[0].new_zeros((len(outs), *outs[0].shape))

    @staticmethod
    def backward(ctx, g):
        run, params = ctx.run, ctx.params
        wants = [p for p in params if p.requires_grad]
        dx = []
        for i in reversed(range(len(ctx.outs))):
            x, y = ctx.ins[i], ctx.outs[i]
            dy = g[i] if run.next is None else run.recv(y, run.next, i)
            inputs = wants + ([x] if x.requires_grad else [])
            if inputs and y.requires_grad:
                torch.autograd.backward(y, dy, inputs=inputs)
            ctx.ins[i] = ctx.outs[i] = None
            if x.requires_grad:
                gx = x.grad if x.grad is not None else torch.zeros_like(x)
                if run.prev is not None:
                    run.send(gx, run.prev, i)
                else:
                    dx.append(gx)
        dx_mb = torch.stack(dx[::-1]) if dx else None
        return (None, dx_mb, *(p.grad for p in params))


def gpipe(stage_fn, stage_params: Any, x_mb: torch.Tensor, *,
          extras: Any = None, group=None) -> torch.Tensor:
    """The GPipe schedule over this rank's stage group (`group`; by
    default the active mesh's `stage` group, one stage off a mesh).

    stage_fn(stage_params, x, extras_m) -> y applies this rank's stage
    (its slab) to one microbatch; y has x's shape and dtype. x_mb: [M,
    ...] microbatches, read on stage 0 alone (the other stages read only
    its shape and dtype). extras: optional tree of [M, ...] side inputs
    (segment ids): each microbatch's entry is indexed locally and never
    sent. Returns [M, ...] outputs, valid on the last stage (zeros
    elsewhere). Differentiable: the backward takes the output's
    cotangent on the last stage (the others' is ignored) and returns the
    gradients of x_mb (on stage 0) and of this stage's params."""
    if group is None:
        from kubeflow_tpu_torch.parallel.sharding import regions

        group = regions().groups.get(AXIS)
    leaves = _leaves(stage_params)
    return _GPipe.apply(_Schedule(stage_fn, stage_params, extras, group),
                        x_mb, *leaves)


class _FromLastStage(torch.autograd.Function):
    """The last stage's `value` on every rank of the stage group (a
    broadcast). Backward: the gradient to the last stage's value; on
    the other stages zeros to `anchor` (their schedule's output), so that
    every stage's backward runs its part of the schedule's."""

    @staticmethod
    def forward(ctx, value, anchor, group, src: int, is_src: bool):
        import torch.distributed as dist

        ctx.is_src = is_src
        ctx.anchor = (anchor.shape, anchor.dtype)
        out = value.clone()
        if group is not None:
            dist.broadcast(out, src, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        if ctx.is_src:
            return g, None, None, None, None
        shape, dtype = ctx.anchor
        return None, g.new_zeros(shape, dtype=dtype), None, None, None


def llama_stage_fn(cfg, positions: torch.Tensor, tp=None):
    """The Llama family's stage body: stage_fn(layers, h, segment_ids=None)
    runs h [Bm, S, D] through a slab of stacked layers, each layer
    `llama._layer_body` under the config's remat (`llama._remat`), RoPE at
    `positions`, on the rank's tensor blocks under `tp`."""
    from kubeflow_tpu_torch.models import llama
    from kubeflow_tpu_torch.models.common import unstack_layers

    rope = llama._rope(cfg, positions)
    body = llama._remat(cfg, lambda h, layer, seg: llama._layer_body(
        cfg, h, layer, rope, seg, tp))

    def stage_fn(layers, h, segment_ids=None):
        for layer in unstack_layers(layers):
            h = body(h, layer, segment_ids)
        return h
    return stage_fn


def llama_loss_tail(params, h: torch.Tensor, batch: dict, cfg, tp=None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """The last stage's tail on the layers' output h [B, S, D]: the final
    norm, the lm_head (f32 logits; the rank's vocabulary columns under
    `tp`) and the masked next-token cross-entropy (vocab-parallel under
    `tp`; the targets by global position on a sequence shard) ->
    (the summed token loss, the token count), `llama.loss_fn`'s
    numerator and denominator."""
    from kubeflow_tpu_torch.models import llama
    from kubeflow_tpu_torch.ops import quant
    from kubeflow_tpu_torch.ops.norms import rms_norm

    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    if tp is not None:
        h = tp.copy_in(h, "tensor")
    logits = quant.matmul_f32_out(h, params["lm_head"], cfg.dtype)
    logits, targets, mask = llama.next_token_terms(
        logits, batch, batch["tokens"].long())
    return (llama._token_loss(logits, targets, tp) * mask).sum(), mask.sum()


def pipelined_llama_loss(params, batch: dict, cfg, mesh=None,
                         n_microbatches: int | None = None):
    """`llama.loss_fn` as the GPipe schedule over `mesh`'s `stage` axis
    (the active mesh by default): the same loss, pipelined. M =
    n_microbatches or the stage count microbatches of the rank's rows
    (which must divide by M); stage 0 embeds, the stages run their slabs
    of params["layers"] (`llama_stage_fn`), the last stage runs
    `llama_loss_tail`, and every rank returns the global (loss,
    {"loss", "tokens"}). Segment ids ride with each microbatch; the loss
    mask applies in the tail; ce_chunk is not read (JAX's dispatch comes
    before it). Gradients: the slab's on each stage, the embedding's on
    the first stage alone and the tail's on the last (the trainer sums
    those over `stage`)."""
    import torch.distributed as dist

    from kubeflow_tpu_torch.models import llama
    from kubeflow_tpu_torch.parallel.mesh import active_mesh, get_active_mesh
    from kubeflow_tpu_torch.parallel.sharding import regions

    mesh = get_active_mesh() if mesh is None else mesh
    with active_mesh(mesh):
        split = regions(mesh)
        n_stages, stage = split.size(AXIS), split.rank(AXIS)
        group = split.groups.get(AXIS)
        m = n_microbatches or n_stages
        tokens = batch["tokens"].long()
        tp = llama.tensor_split(cfg)
        if stage == 0:
            x = llama._embed(params, tokens, cfg, tp)
        else:   # the schedule reads only its shape and dtype here
            x = torch.zeros((), dtype=cfg.dtype, device=tokens.device
                            ).expand(*tokens.shape, cfg.d_model)
        seg = batch.get("segment_ids")
        out = gpipe(llama_stage_fn(cfg, llama.global_positions(tokens), tp),
                    params["layers"], microbatch(x, m),
                    extras=None if seg is None else microbatch(seg, m),
                    group=group)
        last = stage == n_stages - 1
        if last:
            local = torch.stack(llama_loss_tail(
                params, out.reshape(*tokens.shape, -1), batch, cfg, tp))
        else:
            local = torch.zeros(2, device=tokens.device)
        src = (dist.get_global_rank(group, n_stages - 1)
               if group is not None else 0)
        vec = _FromLastStage.apply(local, out, group, src, last)
    loss = vec[0] / vec[1].clamp_min(1.0)
    return loss, {"loss": loss, "tokens": vec[1].detach()}


def stage_bounds(n_layers: int, n_stages: int) -> list[tuple[int, int]]:
    """Contiguous [start, end) layer slabs per stage; an uneven split puts
    the remainder on the earliest stages (the last stage also runs the
    lm_head)."""
    if not 1 <= n_stages <= n_layers:
        raise ValueError(
            f"n_stages must be 1..n_layers ({n_layers}), got {n_stages}")
    base, extra = divmod(n_layers, n_stages)
    bounds, start = [], 0
    for s in range(n_stages):
        size = base + (1 if s < extra else 0)
        bounds.append((start, start + size))
        start += size
    return bounds


def microbatch_ranges(n_slots: int, n_stages: int) -> list[tuple[int, int]]:
    """The decode microbatches as contiguous (start, size) slot ranges:
    one per stage, at least one slot each (fewer microbatches than stages
    when the slots are fewer); the remainder on the earliest."""
    m = min(max(1, n_stages), n_slots)
    base, extra = divmod(n_slots, m)
    out, start = [], 0
    for i in range(m):
        size = base + (1 if i < extra else 0)
        out.append((start, size))
        start += size
    return out


def wavefront(n_microbatches: int, n_stages: int):
    """The GPipe ticks as (tick, stage, microbatch) in dispatch order: at
    tick t, stage s works microbatch t - s."""
    for t in range(n_microbatches + n_stages - 1):
        for s in range(n_stages):
            m = t - s
            if 0 <= m < n_microbatches:
                yield t, s, m


def _slice_layers(tree: Any, lo: int, hi: int) -> Any:
    if isinstance(tree, dict):
        return {k: _slice_layers(v, lo, hi) for k, v in tree.items()}
    return tree[lo:hi]


def split_stage_params(params: dict, bounds: Sequence[tuple[int, int]]
                       ) -> list[dict]:
    """init()-shaped llama params -> per-stage slabs: each stage's
    contiguous layers, stage 0 also `embed`, the last stage `final_norm`
    and `lm_head`. The layer leaves are views on the stacked [L, ...]
    tensors ({"q", "s"} subtrees of int8 weights alike), so the slabs
    hold no copy of the weights."""
    n = len(bounds)
    slabs: list[dict] = []
    for s, (lo, hi) in enumerate(bounds):
        slab: dict = {"layers": _slice_layers(params["layers"], lo, hi)}
        if s == 0:
            slab["embed"] = params["embed"]
        if s == n - 1:
            slab["final_norm"] = params["final_norm"]
            slab["lm_head"] = params["lm_head"]
        slabs.append(slab)
    return slabs


class StagePerf:
    """Per-stage busy/idle accounting of the decode pipeline, two views:

    - schedule ticks (always): each decode step runs M + S - 1 ticks and
      every stage is busy in M of them, so the schedule's bubble is
      (S - 1) / (M + S - 1), a cross-check, not a measurement;
    - measured busy time (with `stage_timing`): the engine brackets every
      stage program (sync) or each stage's stream of programs
      (overlapped), so bubble_frac = 1 - sum(busy) / (stages x window) is
      the measured bubble. The brackets synchronize, so timing is for the
      profiler, never for live traffic."""

    def __init__(self, n_stages: int):
        self.n_stages = n_stages
        #: the schedule whose busy times these are ("sync": one bracket
        #: per stage program; "overlapped": each stage's window from its
        #: first program to its last, which overlap)
        self.schedule = "sync"
        self.reset()

    def reset(self) -> None:
        self.stage_busy_s = [0.0] * self.n_stages
        self.stage_ticks = [0] * self.n_stages
        self.window_s = 0.0
        self.steps = 0
        self.ticks_total = 0

    def record_step(self, n_microbatches: int, wall_s: float) -> None:
        """One decode step: its schedule ticks and its measured window."""
        self.steps += 1
        self.ticks_total += n_microbatches + self.n_stages - 1
        for s in range(self.n_stages):
            self.stage_ticks[s] += n_microbatches
        self.window_s += wall_s

    def record_stage(self, stage: int, busy_s: float) -> None:
        self.stage_busy_s[stage] += busy_s

    def bubble_frac(self) -> float | None:
        """The measured share of stage-seconds idle over the window; None
        until a timed window has accumulated."""
        if self.window_s <= 0 or not any(self.stage_busy_s):
            return None
        busy = sum(self.stage_busy_s)
        return max(0.0, min(1.0, round(
            1.0 - busy / (self.n_stages * self.window_s), 4)))

    def schedule_bubble_frac(self) -> float | None:
        """Idle stage-ticks over all stage-ticks of the recorded steps."""
        if not self.ticks_total:
            return None
        busy = sum(self.stage_ticks)
        return round(1.0 - busy / (self.n_stages * self.ticks_total), 4)

    def snapshot(self) -> dict:
        return {
            "stages": self.n_stages,
            "steps": self.steps,
            "schedule": self.schedule,
            "stage_busy_s": [round(b, 4) for b in self.stage_busy_s],
            "window_s": round(self.window_s, 4),
            "bubble_frac": self.bubble_frac(),
            "schedule_bubble_frac": self.schedule_bubble_frac(),
        }


def synchronize(devices) -> None:
    """Wait for every CUDA device of `devices` (CPU devices: nothing)."""
    for d in dict.fromkeys(devices):
        if d.type == "cuda":
            torch.cuda.synchronize(d)


class InferenceStagePlan:
    """Geometry and placement of stage-sharded serving: the layer bounds,
    each stage's device, the microbatch ranges, the accounting, and the
    move between stages (module docstring)."""

    def __init__(self, n_layers: int, n_stages: int, n_slots: int, *,
                 tensor: int = 1,
                 devices: Sequence[Any] | None = None,
                 device: Any = "cpu"):
        if tensor < 1:
            raise ValueError("tensor must be >= 1")
        if tensor > 1:
            raise ValueError(
                f"tensor={tensor}: tensor-parallel stages are not ported "
                "yet (ROADMAP.md queue A6c-iii, tensor-parallel serving)")
        self.n_stages = int(n_stages)
        self.tensor = int(tensor)
        self.bounds = stage_bounds(n_layers, n_stages)
        self.mb_ranges = microbatch_ranges(n_slots, n_stages)
        home = torch.device(device)
        if devices is None:
            devices = ([torch.device("cuda", i)
                        for i in range(torch.cuda.device_count())]
                       if home.type == "cuda" else [home])
        distinct = list(dict.fromkeys(torch.device(d) for d in devices))
        self.virtual = len(distinct) < self.n_stages or self.n_stages == 1
        #: each stage's device
        self.devices = ([home] * self.n_stages if self.virtual
                        else distinct[:self.n_stages])
        self.perf = StagePerf(self.n_stages)

    @property
    def n_microbatches(self) -> int:
        return len(self.mb_ranges)

    def to_stage(self, x: torch.Tensor | None, stage: int):
        """x on `stage`'s device: the identity under virtual staging."""
        if x is None or self.virtual:
            return x
        return x.to(self.devices[stage], non_blocking=True)

    def describe(self) -> dict:
        """The /healthz `mesh` section's geometry half."""
        return {
            "stages": self.n_stages,
            "tensor": self.tensor,
            "virtual": self.virtual,
            "device_count": (1 if self.virtual
                             else self.n_stages * self.tensor),
            "stage_layers": [hi - lo for lo, hi in self.bounds],
            "microbatches": [list(r) for r in self.mb_ranges],
        }


class StageClock:
    """The timing bracket of one stage program: when armed, synchronizes
    the stage's device before and after it and adds the wall between to
    the stage's busy time; a pass-through otherwise."""

    def __init__(self, perf: StagePerf, enabled: bool,
                 devices: Sequence[torch.device] = ()):
        self.perf = perf
        self.enabled = enabled
        self.devices = devices

    def run(self, stage: int, thunk):
        if not self.enabled:
            return thunk()
        dev = self.devices[stage:stage + 1]
        synchronize(dev)
        t0 = time.perf_counter()
        out = thunk()
        synchronize(dev)
        self.perf.record_stage(stage, time.perf_counter() - t0)
        return out
