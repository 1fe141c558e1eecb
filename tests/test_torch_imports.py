"""The port stands alone: no module of kubeflow_tpu_torch, and not
chip_smoke.py, imports jax or anything of the kubeflow_tpu package
(an AST scan of every import statement)."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FILES = sorted((ROOT / "kubeflow_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
BANNED = ("jax", "jaxlib", "kubeflow_tpu")


def _imports(path: Path) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
    return names


def test_port_files_exist():
    assert (ROOT / "chip_smoke.py").exists()
    assert len(FILES) > 10


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.name)
def test_no_jax_or_reference_imports(path):
    bad = [n for n in _imports(path)
           if n.split(".")[0] in BANNED]
    assert not bad, f"{path} imports {bad}"


def test_the_dataplane_modules_are_scanned():
    """The serving dataplane's modules are among the scanned files: the
    port's own copies of the obs layer, its safetensors reader, the
    supervisor and the predictor, the OIP codec, protos and gRPC server,
    the batcher and the disaggregated coordinator."""
    port = ROOT / "kubeflow_tpu_torch"
    for rel in ("obs/metrics.py", "obs/trace.py", "obs/slo.py",
                "models/safetensors.py", "serving/agent.py",
                "serving/llm_runtime.py", "serving/server.py",
                "serving/tokenizer.py", "serving/protocol.py",
                "serving/protos/inference_pb2.py", "serving/grpc_server.py",
                "serving/batching.py", "serving/disagg.py"):
        assert port / rel in FILES, rel


def test_the_scheduler_loadgen_and_chaos_modules_are_scanned():
    """The port's own copies of the native scheduler binding, the loadgen
    scenario suite and the chaos harness are among the scanned files."""
    port = ROOT / "kubeflow_tpu_torch"
    for rel in ("native/__init__.py", "serving/scheduler.py",
                "loadgen/__init__.py", "loadgen/trace.py", "loadgen/slo.py",
                "loadgen/scenarios.py", "loadgen/control.py",
                "loadgen/runner.py", "loadgen/http_client.py",
                "chaos/__init__.py", "chaos/script.py", "chaos/injector.py"):
        assert port / rel in FILES, rel
    assert (port / "native" / "cb_scheduler.cpp").exists()


def test_the_model_family_modules_are_scanned():
    """The port's copies of the other model families, their ops, the
    shared pieces and the trainer-checkpoint runtime are among the
    scanned files."""
    port = ROOT / "kubeflow_tpu_torch"
    for rel in ("ops/moe.py", "ops/norms.py", "models/moe_llama.py",
                "models/bert.py", "models/mnist_cnn.py", "models/resnet.py",
                "models/vit.py", "models/nas_cnn.py", "models/common.py",
                "models/registry.py", "serving/trainer_runtime.py"):
        assert port / rel in FILES, rel


def test_the_rl_and_multi_model_modules_are_scanned():
    """The port's RL package (envs, learner, config, pod target, packing)
    and the multi-model serving modules (the model abstraction and
    runtimes, storage) are among the scanned files."""
    port = ROOT / "kubeflow_tpu_torch"
    for rel in ("rl/__init__.py", "rl/config.py", "rl/envs.py",
                "rl/anakin.py", "rl/packing.py", "rl/job.py",
                "serving/model.py", "serving/storage.py"):
        assert port / rel in FILES, rel


def test_the_parallel_and_runtime_modules_are_scanned():
    """The port's process-group bootstrap, mesh and sharding rules are
    among the scanned files, as is the multi-rank test helper."""
    port = ROOT / "kubeflow_tpu_torch"
    for rel in ("runtime/__init__.py", "runtime/bootstrap.py",
                "parallel/__init__.py", "parallel/mesh.py",
                "parallel/sharding.py"):
        assert port / rel in FILES, rel
    helper = ROOT / "tests" / "torch_ranks.py"
    assert not [n for n in _imports(helper) if n.split(".")[0] in BANNED]


def test_the_stage_serving_modules_are_scanned():
    """The stage-sharded engine, the stage plan and the module of the
    stage-keyed prefix store are among the scanned files."""
    port = ROOT / "kubeflow_tpu_torch"
    for rel in ("serving/multichip.py", "parallel/pipeline.py",
                "kvcache/radix.py"):
        assert port / rel in FILES, rel
