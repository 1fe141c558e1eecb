"""Chaos harness (counterpart of kubeflow_tpu/chaos): deterministic
fault injection for the serving plane, as committed, replayable
artifacts.

- `chaos.script`   — seeded byte-deterministic fault scripts (the same
  splitmix64 + sha256 contract as `loadgen/trace.py`); the committed
  configs in `chaos/configs/` (`crash_midstream`, `stall_and_partition`,
  `zone_outage`) are the JAX package's files.
- `chaos.injector` — the runtime poll side: components ask "is this
  fault due for me now"; fired events are logged for the record.

The engine supervisor (`serving/agent.py`) consumes crashes and stalls;
partitions, zone outages and heartbeat drops belong to a router and a
heartbeat reporter the port does not have yet.
"""

from kubeflow_tpu_torch.chaos.injector import FaultInjector
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
    "generate_fault_script", "load_fault_config", "load_fault_script",
    "script_bytes", "script_sha256",
]
