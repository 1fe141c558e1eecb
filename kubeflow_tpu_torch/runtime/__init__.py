"""Worker bootstrap: the KTPU_* env contract and the process group
(counterpart of kubeflow_tpu/runtime/bootstrap.py; the JAX package's
heartbeat and rendezvous modules import no JAX and are not copied)."""

from kubeflow_tpu_torch.runtime.bootstrap import (  # noqa: F401
    WorkerContext,
    initialize_distributed,
    rank_device,
    worker_context,
)
