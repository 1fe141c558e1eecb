"""Multi-rank cases of the port's sharded trainer, run as gloo processes
on the CPU (one torch thread each) by tests/test_torch_sharded_*.py.

    python tests/torch_ranks.py CASE RANK WORLD DIR

Each rank joins a process group on the `file://` store DIR/pg (no port is
bound), reads its inputs from DIR/inputs.pt (written by the test), runs
CASE and writes DIR/out-CASE-RANK.pt. This module imports no JAX.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def start(case: str, world: int, directory: str,
          argv: list[str] | None = None, env=None) -> list:
    """Start CASE on `world` ranks (each its own process); `finish` waits
    for them. With `argv`, each rank runs that command instead, its env
    extended by env(rank)."""
    procs = []
    for rank in range(world):
        full = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1",
                    JAX_PLATFORMS="cpu")
        if env is not None:
            full.update(env(rank))
        log = open(os.path.join(directory, f"log-{case}-{rank}.txt"), "w")
        cmd = argv or [sys.executable, os.path.abspath(__file__), case,
                       str(rank), str(world), directory]
        procs.append((subprocess.Popen(cmd, env=full, cwd=ROOT,
                                       stdout=log, stderr=subprocess.STDOUT),
                      log))
    return [case, directory, procs, argv is None]


def finish(handle: list, timeout: float = 120.0) -> list[dict]:
    """Wait for the ranks of `start` and return each rank's output
    (raises with the ranks' logs when one fails)."""
    case, directory, procs, outputs = handle
    deadline = time.monotonic() + timeout
    codes = []
    for p, log in procs:
        try:
            codes.append(p.wait(max(1.0, deadline - time.monotonic())))
        except subprocess.TimeoutExpired:
            p.kill()
            codes.append(p.wait())
        log.close()
    if any(codes):
        logs = "".join(
            f"--- rank {r} (exit {c})\n" + open(os.path.join(
                directory, f"log-{case}-{r}.txt")).read()[-3000:]
            for r, c in enumerate(codes))
        raise RuntimeError(f"{case} failed on {len(codes)} ranks:\n{logs}")
    if not outputs:
        return []
    return [torch.load(os.path.join(directory, f"out-{case}-{r}.pt"),
                       weights_only=False) for r in range(len(codes))]


def write_inputs(case: str, directory: str, inputs: dict) -> None:
    torch.save(inputs, os.path.join(directory, f"inputs-{case}.pt"))


# -- the rank side -------------------------------------------------------------


def _trainer(inp: dict, mesh: dict, **over):
    from kubeflow_tpu_torch.parallel import make_mesh
    from kubeflow_tpu_torch.training import trainer as ttrainer
    from kubeflow_tpu_torch.training.metrics_writer import MetricsWriter

    cfg = ttrainer.TrainerConfig(**dict(inp["config"], mesh=mesh, **over))
    return ttrainer.Trainer(cfg, device="cpu", mesh=make_mesh(cfg.mesh),
                            metrics=MetricsWriter(echo=False))


def _params(trainer, flat: list[np.ndarray]):
    """The model's tree with the given whole leaves (in leaf order)."""
    from kubeflow_tpu_torch.training.trainer import _rebuild

    return _rebuild(trainer.model.abstract(trainer.model_cfg),
                    iter(torch.from_numpy(np.array(a)) for a in flat))


def _run(trainer, state, batches) -> list[dict]:
    out = []
    for b in batches:
        m = trainer.train_step(state, trainer.to_device(b))
        out.append({k: float(v) for k, v in m.items()})
    return out


def _blocks(tree) -> list[np.ndarray]:
    from kubeflow_tpu_torch.training.trainer import leaves

    return [t.to_local().detach().numpy().copy() for t in leaves(tree)]


def _whole(tree) -> list[np.ndarray]:
    from kubeflow_tpu_torch.training.checkpoint import _whole as whole
    from kubeflow_tpu_torch.training.trainer import leaves

    return [whole(t).detach().numpy().copy() for t in leaves(tree)]


def _raises(fn) -> str:
    try:
        fn()
    except ValueError as e:
        return str(e)
    return ""


def case_llama(inp: dict) -> dict:
    """{data: 2, fsdp: 2}: three steps from the given params and global
    batches; the blocks, the resident bytes, an init's blocks, and the
    refusal of a family outside the Llama family on a sequence axis;
    the same steps on {data: 2, stage: 2} (the GPipe schedule)."""
    from kubeflow_tpu_torch.training.trainer import leaves

    t = _trainer(inp, {"data": 2, "fsdp": 2})
    state = t.init_state(_params(t, inp["params"]))
    log = _run(t, state, inp["batches"])
    fresh = t.init_state()   # blocks kept as the leaves are made
    return {
        "log": log, "coord": tuple(t.mesh.get_coordinate()),
        "params": _blocks(state["params"]),
        "mu": _blocks(state["opt_state"]["mu"]),
        "nu": _blocks(state["opt_state"]["nu"]),
        "count": state["opt_state"]["count"],
        "resident": sum(x.to_local().nbytes for x in
                        leaves(state["params"]) + leaves(
                            [state["opt_state"]["mu"],
                             state["opt_state"]["nu"]])),
        "fresh_blocks": _blocks(fresh["params"]),
        "fresh_whole": _whole(fresh["params"]),
        "sequence": _raises(lambda: _trainer(
            dict(inp, config=dict(inp["config"], model="bert",
                                  model_overrides={})),
            {"fsdp": 2, "sequence": 2})),
        "stage": _steps(inp, {"data": 2, "stage": 2}),
    }


def case_lora_mnist(inp: dict) -> dict:
    """llama_lora on {fsdp: 2} from its seed, and mnist_cnn on {data: 2}
    from the given params, three steps each."""
    from kubeflow_tpu_torch.training.trainer import leaves

    lo = _trainer(inp["lora"], {"fsdp": 2})
    state = lo.init_state()
    base = _whole(state["params"]["base"])
    lora_log = _run(lo, state, inp["lora"]["batches"])
    mn = _trainer(inp["mnist"], {"data": 2})
    mstate = mn.init_state(_params(mn, inp["mnist"]["params"]))
    return {
        "lora_log": lora_log,
        "lora_whole": _whole(state["params"]),
        "lora_base_moved": any(not np.array_equal(a, b) for a, b in zip(
            base, _whole(state["params"]["base"]))),
        "lora_moments": [tuple(m.shape) for m in state["opt_state"]["mu"]],
        "lora_adapters": [tuple(t.shape)
                          for t in leaves(state["params"]["lora"])],
        "mnist_log": _run(mn, mstate, inp["mnist"]["batches"]),
        "mnist_whole": _whole(mstate["params"]),
    }


def case_ckpt(inp: dict) -> dict:
    """{data: 2, fsdp: 2}, six steps saving at 1, 3 and 6 (orbax's rule
    at interval 3); step 6 removed, then a resumed run of steps 4-6."""
    import shutil

    import torch.distributed as dist
    from kubeflow_tpu_torch.training.checkpoint import restore_or_init

    d = inp["dir"]
    over = dict(checkpoint_dir=d, checkpoint_every=3, keep_checkpoints=5,
                log_every=1)
    t = _trainer(inp, {"data": 2, "fsdp": 2}, **over)
    state = t.init_state(_params(t, inp["params"]))
    log, whole3 = [], []

    def on_step(step, scalars):
        log.append(scalars)
        if step == 3:
            whole3.extend(_whole([state["params"], state["opt_state"]["mu"],
                                  state["opt_state"]["nu"]]))
    t.train(iter(inp["batches"]), 6, state, step_callback=on_step)
    dist.barrier()
    if dist.get_rank() == 0:
        shutil.rmtree(os.path.join(d, "6"))
    dist.barrier()
    t2 = _trainer(inp, {"data": 2, "fsdp": 2}, **over)
    state2, resumed = restore_or_init(t2, d)
    start_step = state2["step"]
    log2 = []
    t2.train(iter(inp["batches"][3:]), 3, state2,
             step_callback=lambda s, m: log2.append(m))
    return {"log": log, "log2": log2, "resumed": resumed,
            "start": start_step, "whole3": whole3,
            "final": _whole(state["params"]),
            "final2": _whole(state2["params"])}


def case_views(inp: dict) -> dict:
    """{fsdp: 2} with a checkpoint directory per rank (as node-local
    paths), rank 1's already holding steps 2 and 3, so that its own view
    would skip every save: three steps saving on interval 2; then a save
    of a step rank 0 holds, and one whose write fails on rank 0."""
    import torch.distributed as dist
    from kubeflow_tpu_torch.training import checkpoint as ckpt

    rank = dist.get_rank()
    d = f"{inp['dir']}-{rank}"
    if rank == 1:
        for step in (2, 3):
            os.makedirs(os.path.join(d, str(step)))
    t = _trainer(inp, {"fsdp": 2}, checkpoint_dir=d, checkpoint_every=2,
                 keep_checkpoints=5, log_every=1)
    state = t.init_state(_params(t, inp["params"]))
    t.train(iter(inp["batches"]), 3, state)
    mngr = ckpt.CheckpointManager(d)
    steps = mngr.all_steps()
    exists = _raises(lambda: mngr.save(3, state, force=True))
    real = ckpt.safetensors.save_file

    def disk_full(*args, **kwargs):
        raise OSError(28, "No space left on device")
    if rank == 0:
        ckpt.safetensors.save_file = disk_full
    failed = ""
    try:
        mngr.save(9, state, force=True)
    except Exception as e:
        failed = f"{type(e).__name__}: {e}"
    finally:
        ckpt.safetensors.save_file = real
    return {"dir": mngr.directory, "steps": steps, "exists": exists,
            "failed": failed, "steps_after": mngr.all_steps()}


def _steps(inp: dict, mesh: dict, **model_over) -> dict:
    """Three steps of inp's config on `mesh` from its params and batches
    (model_overrides updated by model_over): the log, this rank's
    coordinate and blocks."""
    cfg = dict(inp["config"])
    cfg["model_overrides"] = dict(cfg["model_overrides"], **model_over)
    t = _trainer(dict(inp, config=cfg), mesh)
    state = t.init_state(_params(t, inp["params"]))
    return {"log": _run(t, state, inp["batches"]),
            "coord": tuple(t.mesh.get_coordinate()),
            "params": _blocks(state["params"])}


def _recorded(fn):
    """fn() with the heads B1-B3's wrapper sees and the vocabulary width
    the cross-entropy sees recorded: (fn's result, {"heads": {(q heads,
    kv heads)}, "ce_width": {width}})."""
    from kubeflow_tpu_torch.models import llama
    from kubeflow_tpu_torch.parallel import sharding

    seen = {"heads": set(), "ce_width": set()}
    attn, ce = llama.flash_attention, sharding.vocab_parallel_ce

    def flash(q, k, v, **kw):
        seen["heads"].add((q.shape[2], k.shape[2]))
        return attn(q, k, v, **kw)

    def vocab_ce(logits, *a):
        seen["ce_width"].add(logits.shape[-1])
        return ce(logits, *a)
    llama.flash_attention, sharding.vocab_parallel_ce = flash, vocab_ce
    try:
        return fn(), seen
    finally:
        llama.flash_attention, sharding.vocab_parallel_ce = attn, ce


def case_tensor(inp: dict) -> dict:
    """Llama on {fsdp: 2, tensor: 2} (the heads and vocabulary widths the
    kernels and the loss see recorded), on {data: 2, tensor: 2}, the same
    with ce_chunk, and the refusal of a kv head count the tensor axis
    does not divide."""
    fsdp, seen = _recorded(lambda: _steps(inp, {"fsdp": 2, "tensor": 2}))
    gqa = dict(inp, config=dict(inp["config"], model_overrides=dict(
        inp["config"]["model_overrides"], n_kv_heads=2)))
    t = _trainer(gqa, {"tensor": 4})
    state = t.init_state()
    return {"fsdp": fsdp, "seen": seen,
            "data": _steps(inp, {"data": 2, "tensor": 2}),
            "chunk": _steps(inp, {"data": 2, "tensor": 2}, ce_chunk=4),
            "gqa": _raises(lambda: t.train_step(
                state, t.to_device(inp["batches"][0])))}


def case_tensor2(inp: dict) -> dict:
    """llama_lora on {tensor: 2} and BERT on {tensor: 2} (compute
    repeated on both ranks), each from the given params; whether the
    LoRA base's blocks moved."""
    lo = _trainer(inp["lora"], {"tensor": 2})
    state = lo.init_state(_params(lo, inp["lora"]["params"]))
    base = _blocks(state["params"]["base"])
    lora = {"log": _run(lo, state, inp["lora"]["batches"]),
            "coord": tuple(lo.mesh.get_coordinate()),
            "params": _blocks(state["params"])}
    lora["base_moved"] = any(not np.array_equal(a, b) for a, b in zip(
        base, _blocks(state["params"]["base"])))
    return {"lora": lora, "bert": _steps(inp["bert"], {"tensor": 2})}


def _router_grads(inp: dict, mesh: dict) -> list[np.ndarray]:
    """Each layer's router gradient of the global batch's loss (this
    rank's block, whole here: the router is split over no axis of
    `mesh`) from the given params and the first batch."""
    from kubeflow_tpu_torch.training.trainer import named_leaves

    t = _trainer(inp, mesh)
    state = t.init_state(_params(t, inp["params"]))
    _, grads = t.sharded_grads(state, t.to_device(inp["batches"][0]))
    i = [p for p, _ in named_leaves(state["params"])].index("layers/router")
    return grads[i].detach().numpy().copy()


def case_expert(inp: dict) -> dict:
    """Mixtral on {data: 2, fsdp: 2}, {data: 2, expert: 2} and {expert:
    2, tensor: 2}, three steps each, and the router's gradient on
    {data: 2, expert: 2}."""
    return {"data_fsdp": _steps(inp, {"data": 2, "fsdp": 2}),
            "data_expert": _steps(inp, {"data": 2, "expert": 2}),
            "expert_tensor": _steps(inp, {"expert": 2, "tensor": 2}),
            "router": _router_grads(inp, {"data": 2, "expert": 2})}


def case_expert2(inp: dict) -> dict:
    """The router's gradient on {expert: 2}."""
    return {"router": _router_grads(inp, {"expert": 2})}


def case_rl(inp: dict) -> dict:
    """The Anakin learner on {data: 2}: its own draws for three updates
    from its seed, then the JAX learner's draws injected (`draws`, the
    global batch's rows) from the JAX init."""
    import torch.distributed as dist
    from kubeflow_tpu_torch.models import interop
    from kubeflow_tpu_torch.parallel import make_mesh
    from kubeflow_tpu_torch.rl import anakin, envs
    from kubeflow_tpu_torch.rl.config import AnakinConfig

    mesh = make_mesh({"data": 2})
    own = anakin.AnakinLearner(AnakinConfig(**inp["own"]), device="cpu",
                               mesh=mesh)
    state = own.init(0)
    first_obs = state["obs"].clone()
    log = []
    for _ in range(3):
        state, m = own.step(state)
        log.append({k: float(v) for k, v in m.items()})
    out = {"rank": dist.get_rank(), "first_obs": first_obs.numpy(),
           "own_log": log, "own_params": [
               p.detach().numpy().copy()
               for p in anakin.net_leaves(state["params"])]}
    draws = inp["draws"]
    jl = anakin.AnakinLearner(
        AnakinConfig(**inp["jax"]), device="cpu", mesh=mesh,
        draws=lambda up, t, seed: draws[int(up)][t])
    js = jl.init(0)
    rows = slice(jl.first, jl.first + jl.n_local)
    js["params"] = interop.from_jax_tree(
        inp["jax_params"], anakin.abstract_net(4, (16, 16), 2),
        device="cpu")
    js["env_state"] = envs.CartPoleState(
        *(torch.from_numpy(x[rows].copy()) for x in inp["jax_env_state"]))
    js["obs"] = torch.from_numpy(inp["jax_obs"][rows].copy())
    jlog = []
    for _ in range(3):
        js, m = jl.step(js)
        jlog.append({k: float(v) for k, v in m.items()})
    out.update(jax_log=jlog, jax_obs=js["obs"].numpy().copy(),
               jax_params=[p.detach().numpy().copy()
                           for p in anakin.net_leaves(js["params"])])
    return out


def _sequence_group(mesh: dict):
    """(the `sequence` group of a mesh over every rank, this rank's index
    on it, the axis size)."""
    from kubeflow_tpu_torch.parallel import make_mesh

    m = make_mesh(mesh)
    i = m.mesh_dim_names.index("sequence")
    return m.get_group("sequence"), m.get_coordinate()[i], m.size(i)


def _seq_block(x, j: int, n: int) -> torch.Tensor:
    """Rank j's block of n along dim 1 of a whole numpy array."""
    return torch.from_numpy(np.array(x)).chunk(n, dim=1)[j].contiguous()


def _attention_runs(inp: dict, attend) -> dict:
    """Each of inp's cases through attend(q, k, v, group=, causal=,
    segment_ids=) on this rank's sequence shard of {sequence: 4}, its
    gradients from the case's cotangent: the blocks of o, dq, dk, dv."""
    group, j, n = _sequence_group({"sequence": 4})
    out = []
    for c in inp["cases"]:
        q, k, v = (_seq_block(c[x], j, n).requires_grad_()
                   for x in ("q", "k", "v"))
        seg = None if c["seg"] is None else _seq_block(c["seg"], j, n)
        o = attend(q, k, v, group=group, causal=c["causal"],
                   segment_ids=seg)
        grads = torch.autograd.grad((o * _seq_block(c["cot"], j, n)).sum(),
                                    (q, k, v))
        out.append({"o": o.detach().numpy(), **{
            name: g.numpy() for name, g in zip(("dq", "dk", "dv"), grads)}})
    return {"rank": j, "cases": out}


def case_ring(inp: dict) -> dict:
    """The port's ring on {sequence: 4} for each case; the B1-B3 calls
    each rank made (a causal rank computes its own and past shards
    alone)."""
    from kubeflow_tpu_torch.ops import ring_attention as ra

    calls = []
    real = {n: getattr(ra, n) for n in ("flash_fwd", "flash_bwd_dq",
                                        "flash_bwd_dkv")}

    def counted(name):
        def fn(*a, **kw):
            calls[-1][name] += 1
            return real[name](*a, **kw)
        return fn

    def attend(*a, **kw):
        calls.append(dict.fromkeys(real, 0))
        return ra.ring_attention(*a, **kw)
    for name in real:
        setattr(ra, name, counted(name))
    try:
        out = _attention_runs(inp, attend)
    finally:
        for name, fn in real.items():
            setattr(ra, name, fn)
    out["calls"] = calls
    return out


def case_ulysses(inp: dict) -> dict:
    """The port's Ulysses on {sequence: 4} for each case; the first
    case's q resharded to heads and back; the refusal of a head count the
    axis does not divide."""
    from kubeflow_tpu_torch.ops import ulysses as ul

    out = _attention_runs(inp, ul.ulysses_attention)
    group, j, n = _sequence_group({"sequence": 4})
    x = _seq_block(inp["cases"][0]["q"], j, n)
    heads = ul.seq_to_heads(x, group)
    odd = torch.zeros(1, 4, 6, 8)
    out.update(heads=heads.numpy(), back=ul.heads_to_seq(heads,
                                                         group).numpy(),
               odd_heads=_raises(lambda: ul.ulysses_attention(
                   odd, odd, odd, group=group)))
    return out


def _bodies(fn):
    """fn() with the attention bodies the Llama dispatch called counted:
    (fn's result, {"flash": n, "ring": n, "ulysses": n})."""
    from kubeflow_tpu_torch.models import llama

    names = {"flash": "flash_attention", "ring": "ring_attention",
             "ulysses": "ulysses_attention"}
    real = {k: getattr(llama, v) for k, v in names.items()}
    seen = dict.fromkeys(names, 0)

    def counted(key):
        def body(*a, **kw):
            seen[key] += 1
            return real[key](*a, **kw)
        return body
    for k, v in names.items():
        setattr(llama, v, counted(k))
    try:
        return fn(), seen
    finally:
        for k, v in names.items():
            setattr(llama, v, real[k])


def case_seq(inp: dict) -> dict:
    """Llama's sequence splits through the trainer: ring, Ulysses and
    flash on {data: 2, sequence: 2}, Ulysses on {sequence: 2, tensor:
    2}, ring and Ulysses on {data: 4} (no sequence axis), ce_chunk with
    the ring, each with the attention bodies counted; Mixtral and LoRA on
    {data: 2, sequence: 2}; BERT on {data: 2, sequence: 2} refused."""
    ds = {"data": 2, "sequence": 2}
    runs = {"ring": (ds, dict(attention_impl="ring")),
            "ulysses": (ds, dict(attention_impl="ulysses")),
            "flash": (ds, dict(attention_impl="flash")),
            "tensor": ({"sequence": 2, "tensor": 2},
                       dict(attention_impl="ulysses")),
            "ring_data": ({"data": 4}, dict(attention_impl="ring")),
            "ulysses_data": ({"data": 4}, dict(attention_impl="ulysses")),
            "chunk": (ds, dict(attention_impl="ring", ce_chunk=4))}
    out = {}
    for key, (mesh, over) in runs.items():
        out[key], out[key]["bodies"] = _bodies(
            lambda: _steps(inp, mesh, **over))
    out["mixtral"] = _steps(inp["mixtral"], ds)
    out["lora"] = _steps(inp["lora"], ds)
    out["bert"] = _raises(lambda: _trainer(
        dict(inp, config=dict(inp["config"], model="bert",
                              model_overrides={})), ds))
    return out


def _gpipe_chain(inp: dict) -> dict:
    """`pipeline.gpipe` on {stage: 4} (the active mesh's stage group) of
    tanh(h @ w) with this rank's w, over inp's microbatches; the
    gradients of w and x from the cotangent on the last stage (zeros on
    the others, which the schedule ignores)."""
    from kubeflow_tpu_torch.parallel import make_mesh, pipeline
    from kubeflow_tpu_torch.parallel.mesh import active_mesh

    mesh = make_mesh({"stage": 4})
    s = mesh.get_coordinate()[mesh.mesh_dim_names.index("stage")]
    w = torch.from_numpy(inp["ws"][s:s + 1].copy()).requires_grad_()
    x = torch.from_numpy(inp["x"].copy()).requires_grad_()
    with active_mesh(mesh):
        out = pipeline.gpipe(lambda w, h: torch.tanh(h @ w[0]), w, x)
    cot = torch.from_numpy(inp["cot"])
    dw, dx = torch.autograd.grad(out, [w, x], cot if s == 3 else
                                 torch.zeros_like(cot), allow_unused=True)
    return {"stage": s, "out": out.detach().numpy(), "dw": dw.numpy(),
            "dx": None if dx is None else dx.numpy()}


def case_pipe4(inp: dict) -> dict:
    """The GPipe schedule on 4 ranks: the raw runner (`_gpipe_chain`);
    the Llama Trainer on {stage: 4} at pipeline_microbatches 0 and 4;
    on {data: 2, stage: 2} a microbatch count that the rank's rows do
    not divide; LoRA and BERT (its blocks at rest over `stage`) on
    {data: 2, stage: 2}; the trainer configs of a {stage: 4} mesh."""
    from kubeflow_tpu_torch.training.trainer import TrainerConfig

    return {"gpipe": _gpipe_chain(inp["gpipe"]),
            "configs": {model: TrainerConfig.from_dict(
                {"model": model, "mesh": {"stage": 4}}).mesh.stage
                for model in ("llama", "bert")},
            "m0": _steps(inp, {"stage": 4}),
            "m4": _steps(inp, {"stage": 4}, pipeline_microbatches=4),
            "uneven": _raises(lambda: _steps(
                inp, {"data": 2, "stage": 2}, pipeline_microbatches=8)),
            "lora": _steps(inp["lora"], {"data": 2, "stage": 2}),
            "bert": _steps(inp["bert"], {"data": 2, "stage": 2})}


def case_stage8(inp: dict) -> dict:
    """The GPipe schedule composed with the other axes on 8 ranks, two
    steps each: {data, fsdp} x stage x tensor, data x stage x fsdp,
    data x stage x sequence (ring, Ulysses), packed segments with a loss
    mask on data x stage x tensor; `stage_submeshes`' rank layouts of
    {stage: 2, tensor: 2, data: 2} and {stage: 4, tensor: 2}, and its
    refusal of a mesh without a stage axis."""
    from torch.distributed.device_mesh import DeviceMesh

    from kubeflow_tpu_torch.parallel import make_mesh, stage_submeshes

    dst = {"data": 2, "stage": 2, "tensor": 2}
    dss = {"data": 2, "stage": 2, "sequence": 2}
    runs = {"dp_pp_tp": (dst, {}),
            "fsdp_pp_tp": ({"fsdp": 2, "stage": 2, "tensor": 2}, {}),
            "dp_pp_fsdp": ({"data": 2, "stage": 2, "fsdp": 2}, {}),
            "ring": (dss, dict(attention_impl="ring")),
            "ulysses": (dss, dict(attention_impl="ulysses"))}
    out = {k: _steps(inp, mesh, **over) for k, (mesh, over) in runs.items()}
    out["packed"] = _steps(dict(inp, batches=inp["packed"]), dst)
    out["submeshes"] = {
        key: [(m.mesh.tolist(), m.mesh_dim_names)
              for m in stage_submeshes(make_mesh(shape))]
        for key, shape in (("stage2", {"stage": 2, "tensor": 2,
                                       "data": 2}),
                           ("stage4", {"stage": 4, "tensor": 2}))}
    out["no_stage"] = _raises(lambda: stage_submeshes(DeviceMesh(
        "cpu", torch.arange(8), mesh_dim_names=("data",))))
    return out


def case_stage2(inp: dict) -> dict:
    """{stage: 2}: two steps saving a checkpoint (the last, forced),
    the whole state after them, and the blocks restore_or_init gives a
    new trainer from the save against the trained blocks."""
    from kubeflow_tpu_torch.training.checkpoint import restore_or_init

    t = _trainer(inp, {"stage": 2}, checkpoint_dir=inp["dir"],
                 checkpoint_every=5)
    state = t.init_state(_params(t, inp["params"]))
    t.train(iter(inp["batches"]), len(inp["batches"]), state)
    state2, resumed = restore_or_init(_trainer(inp, {"stage": 2}),
                                      inp["dir"])
    trees = [state["params"], state["opt_state"]["mu"],
             state["opt_state"]["nu"]]
    return {"whole": _whole(trees), "resumed": resumed,
            "coord": tuple(t.mesh.get_coordinate()),
            "blocks": _blocks(trees),
            "restored": _blocks([state2["params"],
                                 state2["opt_state"]["mu"],
                                 state2["opt_state"]["nu"]])}


def main() -> None:
    import torch.distributed as dist

    case, rank, world, directory = (sys.argv[1], int(sys.argv[2]),
                                    int(sys.argv[3]), sys.argv[4])
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method="file://" + os.path.join(directory, f"pg-{case}"),
        world_size=world, rank=rank)
    try:
        inp = torch.load(os.path.join(directory, f"inputs-{case}.pt"),
                         weights_only=False)
        out = globals()[f"case_{case}"](inp)
        torch.save(out, os.path.join(directory, f"out-{case}-{rank}.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
