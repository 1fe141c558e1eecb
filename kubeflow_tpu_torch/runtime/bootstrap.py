"""Worker-process bootstrap: the consumer side of the env the JAXJob
controller injects (counterpart of kubeflow_tpu/runtime/bootstrap.py).

The JAX workers read the KTPU_* env and call `jax.distributed.initialize`;
the port's workers read the same keys, with the same defaults, and call
`torch.distributed.init_process_group`: NCCL for a CUDA device, gloo only
when the caller asks for the CPU (there is no fallback from one to the
other). One process drives one card. The world size is
KTPU_NUM_PROCESSES, the rank KTPU_PROCESS_ID, the store the TCP address
KTPU_COORDINATOR_ADDRESS (a host:port, or a URL such as a `file://`
path, which binds no port), and the rank's card the one id in
KTPU_DEVICE_IDS, which the executor fills from the pod's devices
(`kubeflow_tpu/control/executor.py` `_run_pod`). A single process skips
the group, as the JAX bootstrap does.
"""

from __future__ import annotations

import dataclasses
import os

import torch


@dataclasses.dataclass(frozen=True)
class WorkerContext:
    job_name: str
    namespace: str
    replica_type: str
    replica_index: int
    process_id: int
    num_processes: int
    coordinator_address: str
    device_ids: tuple[int, ...]

    @property
    def is_primary(self) -> bool:
        return self.process_id == 0


def worker_context(env: dict[str, str] | None = None) -> WorkerContext:
    e = os.environ if env is None else env
    raw_devices = e.get("KTPU_DEVICE_IDS", "")
    return WorkerContext(
        job_name=e.get("KTPU_JOB_NAME", "local"),
        namespace=e.get("KTPU_NAMESPACE", "default"),
        replica_type=e.get("KTPU_REPLICA_TYPE", "worker"),
        replica_index=int(e.get("KTPU_REPLICA_INDEX", "0")),
        process_id=int(e.get("KTPU_PROCESS_ID", "0")),
        num_processes=int(e.get("KTPU_NUM_PROCESSES", "1")),
        coordinator_address=e.get("KTPU_COORDINATOR_ADDRESS",
                                  "127.0.0.1:47000"),
        device_ids=tuple(int(d) for d in raw_devices.split(",") if d),
    )


def rank_device(ctx: WorkerContext, device: str | torch.device = "cuda"
                ) -> torch.device:
    """The device this worker runs on: the CPU when asked for; a single
    process keeps `device` as given; a rank of a multi-process job runs on
    the one card KTPU_DEVICE_IDS names, so two ranks never share a card
    by default."""
    dev = torch.device(device)
    if dev.type == "cpu" or ctx.num_processes <= 1:
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {device!r}: use cuda or cpu")
    if len(ctx.device_ids) != 1:
        raise ValueError(
            f"process {ctx.process_id} of {ctx.num_processes}: "
            f"KTPU_DEVICE_IDS={','.join(map(str, ctx.device_ids))!r} must "
            "name this rank's one card (one process per card)")
    return torch.device("cuda", ctx.device_ids[0])


def initialize_distributed(ctx: WorkerContext | None = None, *,
                           device: str | torch.device = "cuda",
                           init_method: str | None = None) -> WorkerContext:
    """Start the process group of a multi-process job: NCCL on the rank's
    card (`rank_device`, made the current card first) or gloo for
    device="cpu", world size and rank from the context, the store at
    `init_method`, or KTPU_COORDINATOR_ADDRESS: tcp://host:port for an
    address, as it stands for a URL (file:///shared/path binds no port).
    A single process skips the group. Returns the context."""
    import torch.distributed as dist

    ctx = ctx or worker_context()
    if ctx.num_processes <= 1:
        return ctx
    dev = rank_device(ctx, device)
    kw = {}
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' to run the "
                "process group on gloo")
        torch.cuda.set_device(dev)
        backend = "nccl"
        kw["device_id"] = dev
    else:
        backend = "gloo"
    addr = ctx.coordinator_address
    dist.init_process_group(
        backend,
        init_method=init_method or (addr if "://" in addr
                                    else f"tcp://{addr}"),
        world_size=ctx.num_processes, rank=ctx.process_id, **kw)
    return ctx
