"""Trace-driven traffic scenarios (counterpart of kubeflow_tpu/loadgen):
a seeded, byte-deterministic trace generator (`trace`), per-tenant SLO
accounting over replay records (`slo`), named committed scenarios
(`scenarios` and `configs/*.json`, the JAX package's files), the
SLO-aware decode-chunk controller (`control`), the runner that replays a
trace through an engine's or a supervisor's ordinary submit path
(`runner`), and the SSE client that replays one through a server's socket
(`http_client`).

The workload dimensions a serving platform must show, not assert:
heterogeneous prompt and output lengths (bucketed and chunked prefill),
many tenants with skewed popularity, bursty arrivals (modulated Poisson),
client cancellations, and SLO attainment under all of it. The same
config gives the same trace bytes in either package (`trace_sha256`).
"""

from kubeflow_tpu_torch.loadgen.control import (SLOController,
                                                pick_decode_chunk)
from kubeflow_tpu_torch.loadgen.http_client import (run_trace_http,
                                                    stream_completion)
from kubeflow_tpu_torch.loadgen.runner import run_scenario, run_trace
from kubeflow_tpu_torch.loadgen.scenarios import (SCENARIOS, Scenario,
                                                  load_scenario, miniature)
from kubeflow_tpu_torch.loadgen.slo import RequestRecord, summarize
from kubeflow_tpu_torch.loadgen.trace import (Trace, TraceConfig,
                                              TraceRequest, generate_trace,
                                              trace_bytes, trace_sha256)

__all__ = [
    "Trace", "TraceConfig", "TraceRequest", "generate_trace",
    "trace_bytes", "trace_sha256", "RequestRecord", "summarize",
    "run_scenario", "run_trace", "run_trace_http", "stream_completion",
    "SLOController", "pick_decode_chunk",
    "SCENARIOS", "Scenario", "load_scenario", "miniature",
]
