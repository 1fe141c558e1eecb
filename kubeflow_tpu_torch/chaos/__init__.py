"""Chaos harness (counterpart of kubeflow_tpu/chaos): deterministic
fault injection for the serving plane, as committed, replayable
artifacts.

- `chaos.script`   — seeded byte-deterministic fault scripts (the same
  splitmix64 + sha256 contract as `loadgen/trace.py`); the committed
  configs in `chaos/configs/` (`crash_midstream`, `stall_and_partition`,
  `zone_outage`) are the JAX package's files.
- `chaos.injector` — the runtime poll side: components ask "is this
  fault due for me now"; fired events are logged for the record. It
  also holds the I/O fault seam the checkpoint commit calls
  (`set_io_fault_hook`, `io_fault`; `ckpt_io_fail` events reach it
  through `FaultInjector.as_io_fault_hook`).

The engine supervisor (`serving/agent.py`) consumes crashes and stalls,
the checkpoint commit (`training/checkpoint.py`) I/O failures;
partitions, zone outages and heartbeat drops belong to a router and a
heartbeat reporter the port does not have yet.
"""

from kubeflow_tpu_torch.chaos.injector import (FaultInjector, io_fault,
                                               set_io_fault_hook)
from kubeflow_tpu_torch.chaos.script import (FAULT_KINDS, FAULT_SCRIPTS,
                                       FaultEvent, FaultScript,
                                       FaultScriptConfig, FaultSpec,
                                       generate_fault_script,
                                       load_fault_config,
                                       load_fault_script, script_bytes,
                                       script_sha256)

__all__ = [
    "FAULT_KINDS", "FAULT_SCRIPTS", "FaultEvent", "FaultInjector",
    "FaultScript", "FaultScriptConfig", "FaultSpec",
    "generate_fault_script", "io_fault", "load_fault_config",
    "load_fault_script", "script_bytes", "script_sha256",
    "set_io_fault_hook",
]
