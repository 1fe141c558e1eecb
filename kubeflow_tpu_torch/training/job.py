"""The port's trainer as a pod target (counterpart of
kubeflow_tpu/training/job.py).

The JAX control plane runs a thread-backend pod's target by name, and a
dotted "module:function" target is imported as it stands
(`kubeflow_tpu/control/executor.py` `get_target`), so a JAXJob runs the
port's trainer with

    template:
      backend: thread
      target: kubeflow_tpu_torch.training.job:train_target
      env:
        KTPU_TORCH_DEVICE: cuda       # the default; "cpu" for tests
        KTPU_TRAINER_CONFIG: >
          {"model": "llama", "batch_size": 8, "num_steps": 50,
           "dataset": {"type": "token_file", "path": "/tmp/corpus.bin",
                       "seq_len": 256},
           "checkpoint_dir": "/tmp/ckpt/llama-corpus"}

`train_target` builds the Trainer on the device KTPU_TORCH_DEVICE names
(cuda unless it says cpu; without a GPU, cuda raises), resumes from the
newest intact checkpoint under `checkpoint_dir` if there is one (printing
"resumed from checkpoint at step N"), and trains the remaining steps over
`make_dataset` with the JAX job's seeds. As in the JAX job, the data
stream starts from its first batch on a resume: it is not fast-forwarded
past the batches the earlier run consumed. Metrics go to
KTPU_METRICS_FILE, the file the HPO collector tails; the JAX job's second
path, a direct report into its in-process observation DB under
KTPU_TRIAL_NAME, is a global of the JAX package and is not taken here.

Cancellation (pod deletion, elastic scale-down) is honored at each logged
step: the cancel event maps to SystemExit(143), SIGTERM's code, which the
ExitCode restart policy retries.

Past one process (KTPU_NUM_PROCESSES > 1) the target starts the process
group itself (`runtime.initialize_distributed`: NCCL on the card
KTPU_DEVICE_IDS names, gloo for cpu) and the trainer shards over the
config's `mesh`; the JAX target leaves the group to the program. Rank 0
writes the metrics and the checkpoints. One process runs one rank, so a
multi-rank job runs its pods on the subprocess backend:

    template:
      backend: subprocess
      argv: [python, -m, kubeflow_tpu_torch.training.job]
      env:
        KTPU_TRAINER_CONFIG: '{"model": "llama", "mesh": {"fsdp": -1}, ...}'
"""

from __future__ import annotations

import json
import os
import threading
from typing import Any

from kubeflow_tpu_torch.runtime import (initialize_distributed, rank_device,
                                        worker_context)
from kubeflow_tpu_torch.training.checkpoint import restore_or_init
from kubeflow_tpu_torch.training.metrics_writer import MetricsWriter
from kubeflow_tpu_torch.training.trainer import Trainer, TrainerConfig

#: the pod env key that names the trainer's device
DEVICE_ENV = "KTPU_TORCH_DEVICE"


def config_from_env(env: dict[str, str]) -> tuple[TrainerConfig, int]:
    """Parse KTPU_TRAINER_CONFIG into (TrainerConfig, num_steps); the
    schedule spans num_steps unless the optimizer pins total_steps."""
    raw = json.loads(env.get("KTPU_TRAINER_CONFIG", "{}"))
    num_steps = int(raw.get("num_steps", 100))
    cfg = TrainerConfig.from_dict(dict(raw, num_steps=num_steps))
    return cfg, num_steps


def train_target(env: dict[str, str], cancel: threading.Event) -> None:
    """Train a registered model from the pod's env (see the module doc)."""
    ctx = worker_context(env)
    device = env.get(DEVICE_ENV, "cuda")
    group = ctx.num_processes > 1
    if group:
        initialize_distributed(ctx, device=device)
        device = rank_device(ctx, device)
    try:
        _train(env, cancel, device, ctx.is_primary, sharded=group)
    finally:
        if group:
            import torch.distributed as dist

            dist.destroy_process_group()


def _train(env: dict[str, str], cancel: threading.Event, device,
           primary: bool, sharded: bool) -> None:
    """The job on `device`; `sharded`: on a mesh of the config's `mesh`
    over the running process group."""
    from kubeflow_tpu_torch.parallel import make_mesh
    from kubeflow_tpu_torch.training import data as data_lib

    cfg, num_steps = config_from_env(env)
    metrics = MetricsWriter(env.get("KTPU_METRICS_FILE") if primary
                            else None, echo=primary)
    trainer = Trainer(cfg, device=device, metrics=metrics,
                      mesh=make_mesh(cfg.mesh) if sharded else None)
    state, resumed = restore_or_init(trainer, cfg.checkpoint_dir)
    start = int(state["step"])
    if resumed and primary:
        print(f"resumed from checkpoint at step {start}", flush=True)
    remaining = max(0, num_steps - start)

    def on_step(step: int, scalars: dict[str, Any]) -> None:
        if cancel.is_set():
            raise SystemExit(143)

    data = data_lib.make_dataset(cfg.dataset, cfg.model, trainer.model_cfg,
                                 cfg.batch_size, fallback_seed=cfg.seed)
    try:
        trainer.train(data, remaining, state=state, step_callback=on_step)
    finally:
        if hasattr(data, "close"):
            data.close()
        metrics.close()
    if primary:
        print(f"training done: {num_steps} steps", flush=True)


if __name__ == "__main__":   # a subprocess-backend pod: the env is the pod's
    train_target(dict(os.environ), threading.Event())
