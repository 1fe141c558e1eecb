"""The port's trainer as a job (training/job.py) against the JAX job: the
same TrainerConfig from examples/llama-corpus-jaxjob.yaml; a run
cancelled at a step and run again resumes at the JAX job's step with
its losses (the same initial params, converted by from_jax_params, and
the same token corpus); the JAX control plane runs the port's dotted
target as a JAXJob, restarts it after a kill and it resumes from its
checkpoint; and the trained checkpoint served by `LLMModel` gives the
tokens of the trainer's in-memory params."""

from __future__ import annotations

import dataclasses
import json
import os
import threading

import jax
import numpy as np
import pytest
import torch

from kubeflow_tpu.control import Cluster, JAXJobController, new_resource
from kubeflow_tpu.control.conditions import has_condition, is_finished
from kubeflow_tpu.training import job as jjob
from kubeflow_tpu.training import trainer as jtrainer
from kubeflow_tpu_torch.models import interop
from kubeflow_tpu_torch.serving.llm_runtime import LLMModel
from kubeflow_tpu_torch.training import job as tjob
from kubeflow_tpu_torch.training import trainer as ttrainer
from kubeflow_tpu_torch.training.checkpoint import CheckpointManager
from kubeflow_tpu_torch.training.loader import write_corpus
from kubeflow_tpu_torch.training.metrics_writer import read_metrics

yaml = pytest.importorskip("yaml")

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = {"vocab_size": 256, "d_model": 64, "n_layers": 2, "n_heads": 4,
        "n_kv_heads": 2, "d_ff": 128, "max_seq_len": 64, "dtype": "float32"}


def _example_config() -> dict:
    with open(os.path.join(ROOT, "examples", "llama-corpus-jaxjob.yaml")) as f:
        job = yaml.safe_load(f)
    env = job["spec"]["replicaSpecs"]["worker"]["template"]["env"]
    return json.loads(env["KTPU_TRAINER_CONFIG"])


def test_config_from_env_matches_the_jax_job():
    env = {"KTPU_TRAINER_CONFIG": json.dumps(_example_config())}
    jcfg, jn = jjob.config_from_env(env)
    tcfg, tn = tjob.config_from_env(env)
    assert tn == jn == 50
    for f in dataclasses.fields(tcfg):
        got, want = getattr(tcfg, f.name), getattr(jcfg, f.name)
        if dataclasses.is_dataclass(got):
            # a JAX key the port lacks would have to be unset here
            got, want = dataclasses.asdict(got), dataclasses.asdict(want)
            assert all(want[k] is None for k in set(want) - set(got))
            want = {k: want[k] for k in got}
        assert got == want, f.name
    assert tcfg.checkpoint_dir == "/tmp/ckpt/llama-corpus"
    assert tcfg.dataset.type == "token_file"
    assert tcfg.optimizer.total_steps == 50
    defaults = tjob.config_from_env({})
    assert defaults[1] == 100 and defaults[0].optimizer.total_steps == 100


def _corpus(path: str) -> str:
    write_corpus(path, np.random.default_rng(0).integers(0, 256, 20_000))
    return path


def _job_env(tmp_path, tag: str, corpus: str, **extra) -> dict:
    cfg = {"model": "llama", "batch_size": 2, "num_steps": 6, "log_every": 1,
           "model_overrides": TINY,
           "dataset": {"type": "token_file", "path": corpus, "seq_len": 32},
           "mesh": {"data": 1},
           "checkpoint_dir": str(tmp_path / f"ckpt-{tag}"),
           "checkpoint_every": 2, "keep_checkpoints": 2,
           "optimizer": {"learning_rate": 0.01, "warmup_steps": 1}}
    cfg.update(extra)
    return {"KTPU_TRAINER_CONFIG": json.dumps(cfg),
            "KTPU_METRICS_FILE": str(tmp_path / f"metrics-{tag}.jsonl"),
            tjob.DEVICE_ENV: "cpu"}


class CancelAt(threading.Event):
    """A cancel event that reads as set from its n-th check on: both jobs
    check it once a logged step, so n=5 cancels at step 5."""

    def __init__(self, n: int):
        super().__init__()
        self.n, self.checks = n, 0

    def is_set(self) -> bool:
        self.checks += 1
        return self.checks >= self.n or super().is_set()


def _steps(d: str) -> list[int]:
    return sorted(int(n) for n in os.listdir(d) if n.isdigit())


def _losses(path: str) -> list[tuple[int, float]]:
    return [(r["step"], r["metrics"]["loss"]) for r in read_metrics(path)]


def test_a_cancelled_run_resumes_like_the_jax_job(tmp_path, monkeypatch,
                                                  capfd):
    corpus = _corpus(str(tmp_path / "corpus.bin"))
    jenv = _job_env(tmp_path, "jax", corpus)
    tenv = _job_env(tmp_path, "port", corpus)
    jcfg, _ = jjob.config_from_env(jenv)
    init = jax.tree.map(np.asarray, jtrainer.Trainer(
        jcfg, devices=jax.devices()[:1]).init_state()["params"])
    orig = ttrainer.Trainer.init_state
    monkeypatch.setattr(
        ttrainer.Trainer, "init_state", lambda self, params=None: orig(
            self, interop.from_jax_params(init, self.model_cfg,
                                          device="cpu")))
    for run in (1, 2):
        codes = {}
        for name, target, env in (("jax", jjob.train_target, jenv),
                                  ("port", tjob.train_target, tenv)):
            try:
                target(env, CancelAt(5) if run == 1 else threading.Event())
                codes[name] = 0
            except SystemExit as e:
                codes[name] = e.code
        out = capfd.readouterr().out
        jdir = json.loads(jenv["KTPU_TRAINER_CONFIG"])["checkpoint_dir"]
        tdir = json.loads(tenv["KTPU_TRAINER_CONFIG"])["checkpoint_dir"]
        if run == 1:
            assert codes == {"jax": 143, "port": 143}
            # the JAX manager's async save of step 4 may still be
            # committing after the cancel; wait for it
            for _ in range(600):
                if 4 in _steps(jdir):
                    break
                threading.Event().wait(0.05)
            assert _steps(tdir) == _steps(jdir) == [2, 4]
        else:
            assert codes == {"jax": 0, "port": 0}
            assert out.count("resumed from checkpoint at step 4") == 2
            assert _steps(tdir) == _steps(jdir) == [4, 6]
    jl, tl = _losses(jenv["KTPU_METRICS_FILE"]), _losses(
        tenv["KTPU_METRICS_FILE"])
    assert [s for s, _ in tl] == [s for s, _ in jl] == [1, 2, 3, 4, 5, 5, 6]
    np.testing.assert_allclose([v for _, v in tl], [v for _, v in jl],
                               rtol=1e-5)


def killed_once_target(env: dict, cancel: threading.Event) -> None:
    """The port's train_target, whose first attempt is cancelled at step
    5 (SystemExit(143), retryable under the ExitCode policy)."""
    marker = env["KILL_MARKER"]
    if not os.path.exists(marker):
        open(marker, "w").close()
        cancel = CancelAt(5)
    tjob.train_target(env, cancel)


def test_jaxjob_runs_the_port_trainer_and_resumes_after_a_kill(tmp_path):
    """examples/llama-corpus-jaxjob.yaml's trainer config, shrunk to the
    tiny model and a local corpus, with the port's dotted target and the
    CPU device key, through the JAX control plane: the first attempt is
    killed at step 5, the pod is restarted, resumes from step 4 and the
    job succeeds with its checkpoint at num_steps and loss in the
    metrics file."""
    raw = _example_config()
    corpus = _corpus(str(tmp_path / "corpus.bin"))
    raw.update(batch_size=2, num_steps=6, log_every=1, model_overrides=TINY,
               checkpoint_dir=str(tmp_path / "ckpt"), checkpoint_every=2)
    raw["dataset"].update(path=corpus, seq_len=32)
    metrics = str(tmp_path / "metrics.jsonl")
    spec = {"runPolicy": {"backoffLimit": 1},
            "replicaSpecs": {"worker": {
                "replicas": 1, "restartPolicy": "ExitCode",
                "template": {"backend": "thread",
                             "target": f"{__name__}:killed_once_target",
                             "resources": {"tpu": 1},
                             "env": {"KTPU_TRAINER_CONFIG": json.dumps(raw),
                                     "KTPU_METRICS_FILE": metrics,
                                     tjob.DEVICE_ENV: "cpu",
                                     "KILL_MARKER": str(tmp_path / "k")}}}}}
    c = Cluster(n_devices=1)
    c.add(JAXJobController)
    with c:
        c.store.create(new_resource("JAXJob", "port-corpus", spec=spec))
        done = c.wait_for("JAXJob", "port-corpus",
                          lambda o: is_finished(o["status"]), timeout=120)
    assert has_condition(done["status"], "Succeeded"), done["status"]
    assert done["status"]["restartCount"] == 1
    assert [s for s, _ in _losses(metrics)] == [1, 2, 3, 4, 5, 5, 6]
    assert all(np.isfinite(v) for _, v in _losses(metrics))
    mngr = CheckpointManager(raw["checkpoint_dir"])
    assert mngr.latest_step() == 6 and mngr.latest_intact_step() == 6


def test_train_then_serve_the_checkpoint(tmp_path):
    """LLMModel(checkpoint=...) serves the trained params: the same
    greedy tokens as LLMModel(params=...) over the trainer's final
    in-memory params, f32 and int8 (weights and KV)."""
    corpus = _corpus(str(tmp_path / "corpus.bin"))
    env = _job_env(tmp_path, "serve", corpus, num_steps=3)
    cfg, n = tjob.config_from_env(env)
    trainer = ttrainer.Trainer(cfg, device="cpu")
    trainer.metrics.echo = False
    from kubeflow_tpu_torch.training import data as tdata

    data = tdata.make_dataset(cfg.dataset, cfg.model, trainer.model_cfg,
                              cfg.batch_size, fallback_seed=cfg.seed)
    state = trainer.train(data, n)
    data.close()
    params = {k: (v.detach() if isinstance(v, torch.Tensor) else
                  {kk: vv.detach() for kk, vv in v.items()})
              for k, v in state["params"].items()}
    body = [{"prompt_tokens": [5, 6, 7, 8], "max_new_tokens": 6},
            {"prompt_tokens": [40, 41], "max_new_tokens": 4}]
    serving = dict(n_slots=2, max_len=64, buckets=(8, 16), supervised=False,
                   device="cpu")
    for quant in (None, "int8"):
        outs = []
        for kw in (dict(checkpoint=cfg.checkpoint_dir, model=TINY),
                   dict(params=params, llama_config=trainer.model_cfg)):
            m = LLMModel("m", quantize=quant, kv_quantize=quant, **serving,
                         **kw)
            m.load()
            try:
                outs.append(m.predict(body))
            finally:
                m.unload()
        assert outs[0] == outs[1], quant
        assert [len(o["output_tokens"]) for o in outs[0]] == [6, 4]


def test_chip_smoke_j3_runs_the_longctx_example_job():
    """chip_smoke (j3) trains examples/llama-longctx-jaxjob.yaml's
    trainer config, key for key, before its cuts."""
    import chip_smoke

    with open(os.path.join(ROOT, "examples",
                           "llama-longctx-jaxjob.yaml")) as f:
        job = yaml.safe_load(f)
    env = job["spec"]["replicaSpecs"]["worker"]["template"]["env"]
    assert chip_smoke.J3_JOB == json.loads(env["KTPU_TRAINER_CONFIG"])
    tjob.config_from_env({"KTPU_TRAINER_CONFIG": json.dumps(
        chip_smoke.J3_JOB)})
