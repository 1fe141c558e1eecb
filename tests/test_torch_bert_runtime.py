"""The port's BERT (models/bert.py with ops/norms.py `layer_norm`) against
the JAX package at f32 on the tiny config, with a padded attention mask
and token types; its synthetic data byte for byte and
examples/bert-jaxjob.yaml through the port's `train_target`; the port's
`TrainerCheckpointModel` over a port checkpoint of JAX-initialised params
against the JAX trainer runtime over the same params, directly and behind
the JAX `ModelServer` (its `python` runtime loading the class by
`className`); and a Katib Experiment over `mnist_cnn`, as
examples/katib-experiment.yaml has it, whose trials run the port's
`train_target` on the CPU."""

import json
import threading
import urllib.request
import uuid

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kubeflow_tpu import hpo
from kubeflow_tpu.control import Cluster, JAXJobController, new_resource
from kubeflow_tpu.control.conditions import (JobConditionType, has_condition,
                                             is_finished)
from kubeflow_tpu.models import bert as jbert
from kubeflow_tpu.models import registry as jregistry
from kubeflow_tpu.ops import norms as jnorms
from kubeflow_tpu.serving.model import ModelError as JModelError
from kubeflow_tpu.serving.model import ModelRepository, load_model
from kubeflow_tpu.serving.server import ModelServer
from kubeflow_tpu.training import data as jdata
from kubeflow_tpu_torch.models import bert as tbert
from kubeflow_tpu_torch.models import interop, registry
from kubeflow_tpu_torch.ops import norms as tnorms
from kubeflow_tpu_torch.serving.llm_runtime import ModelError
from kubeflow_tpu_torch.serving.trainer_runtime import TrainerCheckpointModel
from kubeflow_tpu_torch.training import data as tdata
from kubeflow_tpu_torch.training import job as tjob
from kubeflow_tpu_torch.training.checkpoint import CheckpointManager
from kubeflow_tpu_torch.training.metrics_writer import read_metrics
from kubeflow_tpu_torch.training.trainer import named_leaves

from test_torch_vision_models import example_trainer_config

torch.set_num_threads(2)

ATOL = 1e-4        # logits and losses, absolute
GRAD_TOL = 1e-4    # each gradient leaf, relative to its norm
CLASS = "kubeflow_tpu_torch.serving.trainer_runtime:TrainerCheckpointModel"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_matches_jax(dtype):
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(3, 5, 48)) * 3 + 1).astype(np.float32)
    w, b = (rng.normal(size=(48,)).astype(np.float32) for _ in range(2))
    jx = jnp.asarray(x, dtype)
    want = np.asarray(jnorms.layer_norm(jx, w, b, 1e-6).astype(jnp.float32))
    got = tnorms.layer_norm(torch.from_numpy(x).to(getattr(torch, dtype)),
                            torch.from_numpy(w), torch.from_numpy(b), 1e-6)
    assert got.dtype == getattr(torch, dtype)
    # bf16: the same f32 value rounded once on both sides
    np.testing.assert_allclose(got.float().numpy(), want,
                               atol=1e-5 if dtype == "float32" else 2e-2)


def test_bert_matches_jax_with_a_padded_mask():
    jcfg = jbert.BertConfig.tiny()
    jcfg = jbert.BertConfig(**{**jcfg.__dict__, "dtype": jnp.float32,
                               "n_classes": 3})
    tcfg = tbert.BertConfig(**{**tbert.BertConfig.tiny().__dict__,
                               "dtype": "float32", "n_classes": 3})
    jparams = jbert.init(jax.random.key(0), jcfg)
    params = interop.from_jax_tree(jax.tree.map(np.asarray, jparams),
                                   tbert.abstract_params(tcfg), device="cpu")
    named = named_leaves(params)
    for _, p in named:
        p.requires_grad_(True)
    rng = np.random.default_rng(1)
    b, s = 3, 24
    tokens = rng.integers(0, 512, (b, s)).astype(np.int32)
    mask = np.ones((b, s), np.int32)
    mask[0, 17:] = 0
    mask[2, 9:] = 0
    types = (np.arange(s) >= 12).astype(np.int32)[None].repeat(b, 0)
    labels = np.array([0, 2, 1], np.int32)
    jlog = jbert.apply(jparams, jnp.asarray(tokens), jcfg,
                       attention_mask=jnp.asarray(mask),
                       token_type_ids=jnp.asarray(types))
    tlog = tbert.apply(params, torch.from_numpy(tokens), tcfg,
                       attention_mask=torch.from_numpy(mask),
                       token_type_ids=torch.from_numpy(types))
    np.testing.assert_allclose(tlog.detach().numpy(), np.asarray(jlog),
                               atol=ATOL)
    batch = {"tokens": tokens, "attention_mask": mask, "label": labels}
    (jl, jm), jg = jax.value_and_grad(jbert.loss_fn, has_aux=True)(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg)
    tl, tm = tbert.loss_fn(params, {k: torch.from_numpy(v) for k, v in
                                    batch.items()}, tcfg)
    np.testing.assert_allclose(float(tl), float(jl), atol=ATOL)
    assert float(tm["accuracy"]) == float(jm["accuracy"])
    grads = torch.autograd.grad(tl, [p for _, p in named])
    jflat = dict(named_leaves(jax.tree.map(np.asarray, jg)))
    for (leaf, _), g in zip(named, grads):
        want = jflat[leaf]
        err = np.abs(g.numpy() - want).max()
        assert err <= GRAD_TOL * max(np.linalg.norm(want), 1e-12), leaf
    assert tbert.BertConfig.base().d_model == 768


def test_synthetic_classification_text_matches_jax_bytes():
    j = jdata.synthetic_classification_text(4, 20, 300, 3, seed=6)
    t = tdata.synthetic_classification_text(4, 20, 300, 3, seed=6)
    for _ in range(3):
        a, b = next(j), next(t)
        for k in ("tokens", "label"):
            assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes()


def test_bert_example_job_runs_through_train_target(tmp_path):
    """examples/bert-jaxjob.yaml's trainer config as written (its mesh
    {"data": -1} is one card here), cut to 4 steps with a checkpoint."""
    raw = json.loads(example_trainer_config("examples/bert-jaxjob.yaml"))
    assert raw["mesh"] == {"data": -1}
    raw.update(num_steps=4, log_every=2, checkpoint_dir=str(tmp_path / "c"))
    metrics = str(tmp_path / "metrics.jsonl")
    tjob.train_target({"KTPU_TRAINER_CONFIG": json.dumps(raw),
                       "KTPU_METRICS_FILE": metrics,
                       tjob.DEVICE_ENV: "cpu"}, threading.Event())
    rows = read_metrics(metrics)
    assert [r["step"] for r in rows] == [2, 4]
    assert all(np.isfinite(r["metrics"]["loss"]) and
               "accuracy" in r["metrics"] for r in rows)


RESNET = dict(stage_sizes=[1, 1], width=8, n_classes=5, groups=4,
              image_size=12)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """A port checkpoint of the JAX init of a tiny f32 ResNet (seed 0);
    the JAX ModelServer hosting the JAX trainer runtime (no checkpoint:
    the same init) and the port class by className over the checkpoint,
    logits and argmax."""
    ckpt = str(tmp_path_factory.mktemp("ckpt"))
    jov = dict(RESNET, stage_sizes=(1, 1), dtype=jnp.float32)
    jcfg = jregistry.get("resnet").config_cls(**jov)
    jparams = jregistry.get("resnet").init(jax.random.key(0), jcfg)
    tov = dict(RESNET, dtype="float32")
    tdef = registry.get("resnet")
    params = interop.from_jax_tree(jax.tree.map(np.asarray, jparams),
                                   tdef.abstract(tdef.config_cls(**tov)),
                                   device="cpu")
    mngr = CheckpointManager(ckpt)
    mngr.save(3, {"params": params, "opt_state": {"count": 3}, "step": 3},
              force=True)
    mngr.close()
    repo = ModelRepository()
    repo.register(load_model("trainer", "jax", model="resnet",
                             model_overrides=jov))
    for out in ("logits", "argmax"):
        repo.register(load_model("python", f"port-{out}", ckpt,
                                 className=CLASS, model="resnet",
                                 model_overrides=tov, output=out,
                                 device="cpu"))
    server = ModelServer(repo).start()
    yield server, repo, ckpt, tov
    server.stop()


def _post(server, path, body):
    req = urllib.request.Request(server.url + path,
                                 data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


def test_trainer_checkpoint_model_answers_as_jax(served):
    """V1 instances and one V2 tensor through the JAX server: the port's
    logits equal the JAX runtime's at f32, argmax theirs."""
    server, _, _, _ = served
    images = np.random.default_rng(2).normal(size=(4, 12, 12, 3))
    v1 = {"instances": images.tolist()}
    want = np.asarray(_post(server, "/v1/models/jax:predict",
                            v1)["predictions"])
    got = np.asarray(_post(server, "/v1/models/port-logits:predict",
                           v1)["predictions"])
    assert got.shape == want.shape == (4, 5)
    np.testing.assert_allclose(got, want, atol=ATOL)
    top = _post(server, "/v1/models/port-argmax:predict", v1)["predictions"]
    assert top == np.argmax(got, axis=-1).tolist()
    v2 = {"inputs": [{"name": "image", "shape": list(images.shape),
                      "datatype": "FP32",
                      "data": images.astype(np.float32).ravel().tolist()}]}
    outs = {m: _post(server, f"/v2/models/{m}/infer", v2)["outputs"][0]
            for m in ("jax", "port-logits")}
    assert outs["port-logits"]["shape"] == outs["jax"]["shape"] == [4, 5]
    np.testing.assert_allclose(outs["port-logits"]["data"],
                               outs["jax"]["data"], atol=ATOL)


def test_trainer_checkpoint_model_errors_are_jaxs(served, tmp_path):
    """The port raises its ModelError where the JAX runtime raises its
    own, with the same message: a bad output, a V2 payload of two
    tensors, an empty checkpoint directory; no checkpoint serves the
    init; cuda without a GPU raises."""
    _, repo, ckpt, tov = served
    jov = dict(RESNET, stage_sizes=(1, 1), dtype=jnp.float32)
    for cls, err, kw in ((TrainerCheckpointModel, ModelError, tov),
                         (None, JModelError, jov)):
        def make(**extra):
            if cls is None:
                return load_model("trainer", "m", model="resnet",
                                  model_overrides=kw, **extra)
            return cls("m", model="resnet", model_overrides=kw,
                       device="cpu", **extra)
        with pytest.raises(err, match="output 'probs' invalid"):
            make(output="probs")
        empty = tmp_path / ("e" + err.__module__.split(".")[0])
        empty.mkdir()
        with pytest.raises(err, match="no checkpoint"):
            make(checkpoint=str(empty)).load()
        m = make()
        m.load()
        x = np.zeros((1, 12, 12, 3), np.float32)
        with pytest.raises(err, match="one input tensor"):
            m.predict({"a": x, "b": x})
        assert m.predict(x).shape == (1, 5)
    port = repo.get("port-logits")
    assert port.ready and port.load_time is not None
    with pytest.raises(ModelError, match="explain"):
        port.explain([])
    import unittest.mock as mock

    with mock.patch.object(torch.cuda, "is_available", lambda: False):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TrainerCheckpointModel("m", ckpt, model="resnet")


def test_katib_experiment_runs_port_trials(tmp_path):
    """examples/katib-experiment.yaml's trial config over mnist_cnn, run
    by the port's train_target (target and device key set), 2 trials of
    6 steps: the experiment succeeds and its optimum's objective is the
    least loss its trials wrote to their metrics files (or echoed)."""
    import yaml

    with open("examples/katib-experiment.yaml") as f:
        exp = yaml.safe_load(f)
    spec = exp["spec"]
    raw = example_trainer_config("examples/katib-experiment.yaml")
    raw = raw.replace('"num_steps": 40', '"num_steps": 6').replace(
        '"log_every": 10', '"log_every": 3')
    template = spec["trialTemplate"]["spec"]["replicaSpecs"]["worker"][
        "template"]
    template["target"] = "kubeflow_tpu_torch.training.job:train_target"
    template["env"] = {"KTPU_TRAINER_CONFIG": raw, tjob.DEVICE_ENV: "cpu"}
    spec.update(maxTrialCount=2, parallelTrialCount=2)
    # pods keep their logs in one directory across runs, and the
    # collector scrapes every log of a pod's name: a fresh name per run
    name = f"port-sweep-{uuid.uuid4().hex[:8]}"
    c = Cluster(n_devices=2)
    c.add(JAXJobController)
    hpo.add_hpo_controllers(c, metrics_dir=str(tmp_path))
    try:
        with c:
            c.store.create(new_resource("Experiment", name, spec=spec))
            done = c.wait_for("Experiment", name,
                              lambda o: is_finished(o["status"]),
                              timeout=120)
    finally:
        hpo.set_default_db(None)
    assert has_condition(done["status"], JobConditionType.SUCCEEDED), \
        done["status"]
    assert done["status"]["trials"]["succeeded"] == 2
    opt = done["status"]["currentOptimalTrial"]
    assert np.isfinite(opt["objectiveValue"])
    files = sorted(tmp_path.rglob("*.jsonl"))
    assert len(files) == 2
    losses = [r["metrics"]["loss"] for f in files
              for r in read_metrics(str(f))]
    # a minimized objective is the least loss a trial logged; the
    # collector also scrapes the echoed "loss=" lines, printed to 4
    # decimals, so it may be the rounded value
    assert opt["objectiveValue"] == pytest.approx(min(losses), abs=1e-4)
