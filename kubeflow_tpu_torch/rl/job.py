"""The port's RL learner as a pod target (counterpart of the `rl_learner`
target of kubeflow_tpu/rl/job.py).

The JAX control plane runs a thread-backend pod's target by name, and a
dotted "module:function" target is imported as it stands
(`kubeflow_tpu/control/executor.py` `get_target`), so an RLJob runs the
port's learner with

    replicaSpecs:
      learner:
        template:
          backend: thread
          target: kubeflow_tpu_torch.rl.job:rl_learner_target
          env:
            KTPU_TORCH_DEVICE: cuda       # the default; "cpu" for tests
            KTPU_RL_CONFIG: >
              {"env": "cartpole", "n_envs": 2048, "rollout_len": 64,
               "num_updates": 200, "log_every": 10, "mesh": {"data": -1}}

The JAX `RLJobController` admits the spec (`parse_rl_config` there) and
schedules the gang; it needs no port. `rl_learner_target` parses
KTPU_RL_CONFIG with the port's `parse_rl_config`, builds an
`AnakinLearner` on the device KTPU_TORCH_DEVICE names (cuda unless it
says cpu; without a GPU, cuda raises), and writes the learner's metrics
at the log cadence to KTPU_METRICS_FILE, the file the Katib collector
tails. The JAX target's second path, a direct report into its
in-process observation DB under KTPU_TRIAL_NAME, is a global of the JAX
package and is not taken here. Cancellation is checked before every
update and maps to SystemExit(143), SIGTERM's code.

Past one process (KTPU_NUM_PROCESSES > 1) the target starts the process
group itself (`runtime.initialize_distributed`: NCCL on the card
KTPU_DEVICE_IDS names, gloo for cpu), as `training/job.py` does, and the
learner runs its env batch over the config's mesh (`{"data": -1}`: every
rank); rank 0 writes the metrics. One process runs one rank, so such a
learner runs its pods on the subprocess backend with `argv: [python, -m,
kubeflow_tpu_torch.rl.job]`.
"""

from __future__ import annotations

import os
import threading

from kubeflow_tpu_torch.rl.config import parse_rl_config
from kubeflow_tpu_torch.runtime import (initialize_distributed, rank_device,
                                        worker_context)
from kubeflow_tpu_torch.training.metrics_writer import MetricsWriter

#: the pod env key that names the learner's device
DEVICE_ENV = "KTPU_TORCH_DEVICE"


def rl_learner_target(env: dict[str, str],
                      cancel: threading.Event) -> None:
    """Run an Anakin learner from the pod's env (see the module doc)."""
    cfg, num_updates, log_every = parse_rl_config(
        env.get("KTPU_RL_CONFIG", "{}"))
    ctx = worker_context(env)
    device = env.get(DEVICE_ENV, "cuda")
    group = ctx.num_processes > 1
    if group:
        initialize_distributed(ctx, device=device)
        device = rank_device(ctx, device)
    try:
        _learn(env, cancel, cfg, num_updates, log_every, device,
               ctx.is_primary, group)
    finally:
        if group:
            import torch.distributed as dist

            dist.destroy_process_group()


def _learn(env: dict[str, str], cancel: threading.Event, cfg,
           num_updates: int, log_every: int, device, primary: bool,
           sharded: bool) -> None:
    """The learner on `device`; `sharded`: its env batch over the mesh of
    the config's `mesh` on the running process group."""
    from kubeflow_tpu_torch.parallel import make_mesh
    from kubeflow_tpu_torch.rl.anakin import AnakinLearner

    metrics = MetricsWriter(env.get("KTPU_METRICS_FILE") if primary
                            else None, echo=primary)
    learner = AnakinLearner(cfg, device=device,
                            mesh=make_mesh(cfg.mesh) if sharded else None)
    state = learner.init(cfg.seed)

    def on_log(update: int, scalars: dict[str, float]) -> None:
        metrics.write(update, {k: v for k, v in scalars.items()
                               if k != "update"})

    def cancelled() -> bool:
        # every update, not only at the log cadence
        if cancel.is_set():
            raise SystemExit(143)
        return False

    try:
        learner.train(state, num_updates, log_every=log_every,
                      callback=on_log, should_stop=cancelled)
    finally:
        metrics.close()
    if primary:
        print(f"rl training done: {num_updates} updates on {cfg.env} "
              f"({learner.env_steps_per_update()} env-steps/update)",
              flush=True)


if __name__ == "__main__":   # a subprocess-backend pod: the env is the pod's
    rl_learner_target(dict(os.environ), threading.Event())
