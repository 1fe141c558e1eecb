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


def _moe_trainer(inp: dict, name: str):
    return _trainer(dict(inp, config=dict(inp["config"], model=name,
                                          model_overrides={})),
                    {"data": 2, "fsdp": 2})


def _moe_under(name: str, inp: dict) -> str:
    """The refusal of Mixtral's family registered under another name."""
    from kubeflow_tpu_torch.models import registry

    registry._REGISTRY[name] = registry.get("mixtral")
    try:
        return _raises(lambda: _moe_trainer(inp, name))
    finally:
        del registry._REGISTRY[name]


def case_llama(inp: dict) -> dict:
    """{data: 2, fsdp: 2}: three steps from the given params and global
    batches; the blocks, the resident bytes, an init's blocks, and the
    refusals of the axes and the model not ported yet."""
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
        "mixtral": _raises(lambda: _moe_trainer(inp, "mixtral")),
        "moe_alias": _moe_under("moe_alias", inp),
        "tensor": _raises(lambda: _trainer(inp, {"data": 2, "tensor": 2})),
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
