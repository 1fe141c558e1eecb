"""The port's vision families (models/mnist_cnn.py, resnet.py, vit.py,
nas_cnn.py with the DARTS supernet) against the JAX package at f32 on
tiny configs: logits, loss, accuracy and every gradient leaf from the
same params (the JAX init carried across by from_jax_tree) and the same
numpy images; the synthetic data byte for byte; and the MNIST and NAS
example jobs through the port's `train_target`."""

import json
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kubeflow_tpu.models import nas_cnn as jnas
from kubeflow_tpu.models import registry as jregistry
from kubeflow_tpu.training import data as jdata
from kubeflow_tpu_torch.models import interop, registry
from kubeflow_tpu_torch.models import common
from kubeflow_tpu_torch.models import nas_cnn as tnas
from kubeflow_tpu_torch.training import data as tdata
from kubeflow_tpu_torch.training import job as tjob
from kubeflow_tpu_torch.training.metrics_writer import read_metrics
from kubeflow_tpu_torch.training import trainer as ttrainer
from kubeflow_tpu_torch.training.trainer import named_leaves

torch.set_num_threads(2)

ATOL = 1e-4        # logits and losses, absolute
GRAD_TOL = 1e-4    # each gradient leaf, relative to its norm


def _parity(name, jov, tov, images, labels, seed=0, jparams=None):
    """Family `name`'s apply, loss_fn and grads, JAX against the port at
    f32; returns the port's params."""
    jdef, tdef = jregistry.get(name), registry.get(name)
    jcfg, tcfg = jdef.config_cls(**jov), tdef.config_cls(**tov)
    if jparams is None:
        jparams = jdef.init(jax.random.key(seed), jcfg)
    params = interop.from_jax_tree(jax.tree.map(np.asarray, jparams),
                                   tdef.abstract(tcfg), device="cpu")
    named = named_leaves(params)
    for _, p in named:
        p.requires_grad_(True)
    batch = {"image": images, "label": labels}
    jlogits = jax.jit(jdef.apply, static_argnums=2)(
        jparams, jnp.asarray(images), jcfg)
    (jl, jm), jg = jax.jit(jax.value_and_grad(jdef.loss_fn, has_aux=True),
                           static_argnums=2)(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tlogits = tdef.apply(params, tb["image"], tcfg)
    assert tlogits.dtype == torch.float32
    np.testing.assert_allclose(tlogits.detach().numpy(), np.asarray(jlogits),
                               atol=ATOL)
    tl, tm = tdef.loss_fn(params, tb, tcfg)
    np.testing.assert_allclose(float(tl), float(jl), atol=ATOL)
    assert float(tm["accuracy"]) == float(jm["accuracy"])
    grads = torch.autograd.grad(tl, [p for _, p in named])
    jflat = dict(named_leaves(jax.tree.map(np.asarray, jg)))
    assert set(jflat) == {n for n, _ in named}
    for (leaf, _), g in zip(named, grads):
        want = jflat[leaf]
        err = np.abs(g.numpy() - want).max()
        assert err <= GRAD_TOL * max(np.linalg.norm(want), 1e-12), leaf
    return params


def _images(b, size, c, n_classes, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, size, size, c)).astype(np.float32),
            rng.integers(0, n_classes, size=(b,)).astype(np.int32))


def test_mnist_cnn_matches_jax():
    _parity("mnist_cnn", {}, {}, *_images(4, 28, 1, 10))


@pytest.mark.parametrize("size", [16, 13])
def test_resnet_matches_jax(size):
    """ResNet tiny at an even size (the stem's 7x7 stride 2 and the max
    pool pad one more on the high side) and an odd one (the stage-2
    stride-2 conv does): XLA's SAME is asymmetric there."""
    ov = dict(stage_sizes=(1, 1), width=16, n_classes=10, groups=4)
    _parity("resnet", dict(ov, dtype=jnp.float32),
            dict(ov, dtype="float32"), *_images(3, size, 3, 10))


def test_same_pads_are_xlas():
    assert common.same_pads(224, 7, 2) == (2, 3)
    assert common.same_pads(56, 3, 2) == (0, 1)
    assert common.same_pads(112, 3, 2) == (0, 1)
    assert common.same_pads(7, 3, 2) == (1, 1)
    assert common.same_pads(28, 3, 1) == (1, 1)


def test_vit_matches_jax():
    """ViT tiny (as tests/test_vit.py runs it: the JAX model's XLA
    attention at f32) against the port's flash attention, whose plain
    forward and backward run on the CPU."""
    ov = dict(image_size=8, patch_size=4, in_channels=3, n_classes=4,
              d_model=32, n_layers=2, n_heads=2, d_ff=64)
    jdef = jregistry.get("vit")
    jcfg = jdef.config_cls(**ov, dtype=jnp.float32)
    jparams = jdef.init(jax.random.key(0), jcfg)
    # the JAX init zeroes the head: give it weights so its grads reach
    # every layer
    jparams["head"]["w"] = 0.1 * jax.random.normal(
        jax.random.key(1), jparams["head"]["w"].shape)
    _parity("vit", dict(ov, dtype=jnp.float32, attention_impl="xla"),
            dict(ov, dtype="float32"), *_images(3, 8, 3, 4),
            jparams=jparams)
    with pytest.raises(ValueError, match="xla"):
        registry.get("vit").config_cls(attention_impl="xla")


def test_nas_cnn_every_op_matches_jax():
    """Every op of OP_NAMES in one architecture, on a 9-pixel image: the
    VALID 2x2 reduction floors 9 to 4, and avgpool divides by 9 at the
    borders too."""
    ov = dict(ops=tnas.OP_NAMES, channels=8, image_size=9,
              n_classes=4, reduce_every=2)
    _parity("nas_cnn", ov, ov, *_images(3, 9, 3, 4))
    with pytest.raises(ValueError, match="unknown op"):
        tnas.NasCnnConfig(ops=("conv7",))


def test_darts_supernet_and_derive_match_jax():
    ov = dict(ops=("conv3", "sep3", "avgpool"), channels=8, image_size=8,
              n_classes=4, reduce_every=2)
    jcfg = jnas.NasCnnConfig(**ov)
    jparams = jnas.darts_init(jax.random.key(0), jcfg)
    alpha = np.random.default_rng(2).normal(size=(3, len(jnas.OP_NAMES)))
    jparams["alpha"] = jnp.asarray(alpha, jnp.float32)
    params = _parity("darts_supernet", ov, ov, *_images(3, 8, 3, 4),
                     jparams=jparams)
    assert tnas.derive(params["alpha"].detach()) == jnas.derive(alpha)
    tied = np.zeros((2, len(jnas.OP_NAMES)))
    tied[1, [3, 5]] = 1.0
    assert tnas.derive(tied) == jnas.derive(tied) == ("conv3", "maxpool")


FAMILIES = {
    "llama": {}, "mixtral": {}, "mnist_cnn": {},
    "bert": dict(vocab_size=500, max_seq_len=40, n_classes=3),
    "resnet": dict(image_size=12, n_classes=7),
    "vit": dict(image_size=8, patch_size=4, n_classes=5),
    "nas_cnn": dict(image_size=10, n_classes=3, in_channels=2),
    "darts_supernet": dict(image_size=6, n_classes=3)}


def test_synthetic_data_matches_jax_bytes():
    """synthetic_images and for_model (and make_dataset's synthetic
    branch through it) give the JAX batches byte for byte."""
    j = jdata.synthetic_images(3, 6, 2, 4, seed=5)
    t = tdata.synthetic_images(3, 6, 2, 4, seed=5)
    for _ in range(3):
        a, b = next(j), next(t)
        for k in ("image", "label"):
            assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes()
    for name, ov in FAMILIES.items():
        jcfg = jregistry.get(name).config_cls(**ov)
        tcfg = registry.get(name).config_cls(**ov)
        for j, t in ((jdata.for_model(name, jcfg, 4, 32, seed=7),
                      tdata.for_model(name, tcfg, 4, 32, seed=7)),
                     (jdata.make_dataset(jdata.DatasetConfig(seq_len=32),
                                         name, jcfg, 4, fallback_seed=2),
                      tdata.make_dataset(tdata.DatasetConfig(seq_len=32),
                                         name, tcfg, 4, fallback_seed=2))):
            for _ in range(2):
                a, b = next(j), next(t)
                assert sorted(a) == sorted(b), name
                for k in a:
                    assert a[k].dtype == b[k].dtype, (name, k)
                    assert a[k].tobytes() == b[k].tobytes(), (name, k)
    with pytest.raises(KeyError, match="no synthetic data recipe"):
        tdata.for_model("gpt", None, 2)


def example_trainer_config(path: str) -> str:
    """The KTPU_TRAINER_CONFIG text of an example (a job's worker or an
    experiment's trial template), ${...} placeholders left in place."""
    import yaml

    def find(node):
        if isinstance(node, dict):
            if "KTPU_TRAINER_CONFIG" in node:
                return node["KTPU_TRAINER_CONFIG"]
            node = list(node.values())
        if isinstance(node, list):
            for v in node:
                found = find(v)
                if found is not None:
                    return found
        return None

    with open(path) as f:
        return find(yaml.safe_load(f))


@pytest.mark.parametrize("example, subs", [
    ("examples/mnist-jaxjob.yaml", {}),
    ("examples/nas-experiment.yaml", {"${trialParameters.op_0}": "sep3",
                                      "${trialParameters.op_1}": "maxpool"})])
def test_example_jobs_run_through_train_target(tmp_path, example, subs):
    """An example's trainer config as written (a NAS trial's parameters
    filled in, the checkpoint under tmp_path and the steps cut to 6) runs
    through `train_target` on the CPU: finite losses, accuracy in the
    metrics file, a checkpoint of the final step."""
    raw = example_trainer_config(example)
    for k, v in subs.items():
        raw = raw.replace(k, v)
    raw = json.loads(raw)
    raw.update(num_steps=6, log_every=2,
               checkpoint_dir=str(tmp_path / "ckpt"))
    metrics = str(tmp_path / "metrics.jsonl")
    env = {"KTPU_TRAINER_CONFIG": json.dumps(raw),
           "KTPU_METRICS_FILE": metrics, tjob.DEVICE_ENV: "cpu"}
    tjob.train_target(env, threading.Event())
    rows = read_metrics(metrics)
    assert [r["step"] for r in rows] == [2, 4, 6]
    assert all(np.isfinite(r["metrics"]["loss"])
               and 0 <= r["metrics"]["accuracy"] <= 1 for r in rows)
    from kubeflow_tpu_torch.training.checkpoint import CheckpointManager

    assert CheckpointManager(raw["checkpoint_dir"]).latest_step() == 6


def test_chip_smoke_m_runs_the_examples_as_written():
    """chip_smoke (m) trains examples/mnist-jaxjob.yaml's config and
    examples/nas-experiment.yaml's trial config key for key (M1_JOB,
    M5_TRIAL), and its width configs build: BERT-base, ResNet-50 at 224,
    ViT-B/16 (S = 197, head dim 64) and Mixtral's 8x7B widths at 2
    layers."""
    import chip_smoke

    assert chip_smoke.M1_JOB == json.loads(
        example_trainer_config("examples/mnist-jaxjob.yaml"))
    assert chip_smoke.M5_TRIAL == json.loads(
        example_trainer_config("examples/nas-experiment.yaml"))
    cfgs = {}
    for label, job in chip_smoke.m_jobs().items():
        tc = ttrainer.TrainerConfig.from_dict(job)
        cfgs[label] = registry.make_config(tc.model, tc.model_overrides)
    assert cfgs["m2 bert"] == registry.get("bert").config_cls.base()
    assert cfgs["m3 resnet"].stage_sizes == (3, 4, 6, 3)
    vit = cfgs["m4 vit"]
    assert (vit.n_patches + 1, vit.d_model // vit.n_heads) == (197, 64)
    assert chip_smoke.M4_ATTN == (64, vit.n_patches + 1, vit.n_heads, 64)
    mix = cfgs["m6 mixtral"]
    assert (mix.d_model, mix.d_ff, mix.n_experts, mix.n_layers) == (
        4096, 14336, 8, 2)
    assert cfgs["m5 nas_cnn"].ops == chip_smoke.M5_OPS
