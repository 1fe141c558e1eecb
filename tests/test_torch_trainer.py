"""The port's trainer (training/trainer.py, data.py, mfu.py) against the
JAX package: the synthetic batches byte for byte, and the whole Trainer
against the JAX Trainer on the tiny f32 config — same initial params
(converted by from_jax_params), same batches, 3 steps — plus the config
parsing, MFU and device checks. The optimizer alone is held to optax in
test_torch_optimizer.py."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kubeflow_tpu.models import llama as jllama
from kubeflow_tpu.training import data as jdata
from kubeflow_tpu.training import trainer as jtrainer
from kubeflow_tpu_torch.models import interop
from kubeflow_tpu_torch.models import llama as tllama
from kubeflow_tpu_torch.training import data as tdata
from kubeflow_tpu_torch.training import mfu as tmfu
from kubeflow_tpu_torch.training import trainer as ttrainer
from kubeflow_tpu_torch.training.metrics_writer import (MetricsWriter,
                                                        read_metrics)

torch.set_num_threads(2)


def test_synthetic_tokens_match_jax_bytes():
    j = jdata.synthetic_tokens(3, 40, 1000, seed=4)
    t = tdata.synthetic_tokens(3, 40, 1000, seed=4)
    for _ in range(3):
        a, b = next(j)["tokens"], next(t)["tokens"]
        assert a.dtype == b.dtype == np.int32
        assert a.tobytes() == b.tobytes()


def test_make_dataset():
    cfg = tllama.LlamaConfig.tiny()
    ds = tdata.DatasetConfig(seq_len=32, seed=None)
    batch = next(tdata.make_dataset(ds, "llama", cfg, 2, fallback_seed=3))
    ref = next(jdata.make_dataset(jdata.DatasetConfig(seq_len=32), "llama",
                                  cfg, 2, fallback_seed=3))
    assert batch["tokens"].tobytes() == ref["tokens"].tobytes()
    for kind in ("token_file", "array_file"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tdata.make_dataset(tdata.DatasetConfig(type=kind, path="x"),
                               "llama", cfg, 2)
    with pytest.raises(ValueError, match="unknown dataset type"):
        tdata.make_dataset(tdata.DatasetConfig(type="nope"), "llama", cfg, 2)


TINY = dict(vocab_size=512, d_model=64, n_layers=2, n_heads=8, n_kv_heads=4,
            d_ff=128, max_seq_len=128, rope_theta=10000.0)


def test_trainer_matches_jax_trainer(tmp_path):
    steps, seq, batch = 3, 64, 2
    opt = dict(learning_rate=1e-2, warmup_steps=1, total_steps=10)
    jcfg = jtrainer.TrainerConfig(
        model="llama", model_overrides=dict(TINY, dtype=jnp.float32),
        batch_size=batch, optimizer=jtrainer.OptimizerConfig(**opt),
        log_every=1, seed=0)
    jt = jtrainer.Trainer(jcfg, devices=jax.devices()[:1],
                          metrics=MetricsWriter(echo=False))
    jstate = jt.init_state()
    init = jax.tree.map(np.array, jstate["params"])   # before donation
    j_log = []
    jstate = jt.train(jdata.synthetic_tokens(batch, seq, 512, 0), steps,
                      jstate, step_callback=lambda s, m: j_log.append(m))
    j_final = jax.tree.map(np.asarray, jstate["params"])

    path = tmp_path / "metrics.jsonl"
    tcfg = ttrainer.TrainerConfig(
        model="llama", model_overrides=dict(TINY, dtype="float32"),
        batch_size=batch, optimizer=ttrainer.OptimizerConfig(**opt),
        log_every=1, seed=0)
    tt = ttrainer.Trainer(tcfg, device="cpu",
                          metrics=MetricsWriter(str(path), echo=False))
    tstate = tt.init_state(interop.from_jax_params(init, tt.model_cfg,
                                                   device="cpu"))
    t_log = []
    tstate = tt.train(tdata.synthetic_tokens(batch, seq, 512, 0), steps,
                      tstate, step_callback=lambda s, m: t_log.append(m))
    tt.metrics.close()

    assert tstate["step"] == steps and len(t_log) == len(j_log) == steps
    for t, j in zip(t_log, j_log):
        np.testing.assert_allclose(t["loss"], j["loss"], rtol=1e-5)
        np.testing.assert_allclose(t["grad_norm"], j["grad_norm"],
                                   rtol=1e-5)
        assert t["tokens"] == j["tokens"] == batch * (seq - 1)
    assert t_log[0]["includes_compile"] == 1.0
    assert "includes_compile" not in t_log[1]
    assert t_log[-1]["loss"] < t_log[0]["loss"]
    for t, j in zip(ttrainer.leaves(tstate["params"]),
                    jax.tree.leaves(j_final)):
        np.testing.assert_allclose(t.detach().numpy(), j, atol=1e-4,
                                   rtol=0)
    rows = read_metrics(str(path))
    assert [r["step"] for r in rows] == [1, 2, 3]
    assert rows[0]["metrics"]["loss"] == pytest.approx(t_log[0]["loss"])


def test_from_dict_accepts_the_example_job_config():
    raw = json.loads("""
        {"model": "llama", "batch_size": 4, "num_steps": 20,
         "log_every": 5,
         "model_overrides": {"vocab_size": 2048, "d_model": 256,
                             "n_layers": 4, "n_heads": 8, "n_kv_heads": 4,
                             "d_ff": 1024, "max_seq_len": 512,
                             "remat": true},
         "mesh": {"data": -1},
         "optimizer": {"learning_rate": 0.0003, "warmup_steps": 5}}""")
    cfg = ttrainer.TrainerConfig.from_dict(raw)
    assert cfg.batch_size == 4 and cfg.log_every == 5
    assert cfg.optimizer.total_steps == 20      # from num_steps
    assert cfg.optimizer.warmup_steps == 5
    model_cfg = tllama.LlamaConfig(**cfg.model_overrides)
    assert model_cfg.max_seq_len == 512 and model_cfg.remat
    pinned = ttrainer.TrainerConfig.from_dict(
        {"num_steps": 20, "optimizer": {"total_steps": 100}})
    assert pinned.optimizer.total_steps == 100


@pytest.mark.parametrize("raw,match", [
    ({"mesh": {"fsdp": 4}}, "one card"),
    ({"mesh": {"pipe": 1}}, "unknown mesh axis"),
    ({"checkpoint_dir": "/x"}, "not yet ported"),
])
def test_from_dict_rejects(raw, match):
    with pytest.raises(ValueError, match=match):
        ttrainer.TrainerConfig.from_dict(raw)


def test_longctx_job_model_overrides_build_a_trainer():
    """The model_overrides of examples/llama-longctx-jaxjob.yaml (the JAX
    config's attention_impl and scan_layers keys included), shrunk for
    the CPU, build the port's Trainer and one training step runs."""
    job = open(os.path.join(os.path.dirname(__file__), "..", "examples",
                            "llama-longctx-jaxjob.yaml")).read()
    raw = json.loads(job.split("KTPU_TRAINER_CONFIG: >", 1)[1]
                     .split("\n\n", 1)[0])
    overrides = raw["model_overrides"]
    assert overrides["attention_impl"] == "flash"
    assert overrides["scan_layers"] is False
    overrides.update(vocab_size=256, d_model=64, n_layers=2, n_heads=4,
                     n_kv_heads=2, d_ff=128, max_seq_len=64)
    raw.pop("dataset")   # token_file loader: ROADMAP A2.c
    cfg = ttrainer.TrainerConfig.from_dict(
        dict(raw, dataset={"seq_len": 64}))
    trainer = ttrainer.Trainer(cfg, device="cpu",
                               metrics=MetricsWriter(echo=False))
    assert trainer.model_cfg.attention_impl == "flash"
    assert trainer.model_cfg.scan_layers is False
    state = trainer.init_state()
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, 256, (1, 64)).astype(np.int32),
             "segment_ids": np.zeros((1, 64), np.int32),
             "loss_mask": np.ones((1, 64), np.float32)}
    metrics = trainer.train_step(state, trainer.to_device(batch))
    assert np.isfinite(float(metrics["loss"]))
    # the JAX config takes the same keys
    jllama.LlamaConfig(**overrides)


@pytest.mark.parametrize("key,value,match", [
    ("attention_impl", "xla", "plain-version"),
    ("attention_impl", "ring", "A6"),
    ("attention_impl", "ulysses", "A6"),
    ("decode_attention_impl", "xla", "plain-version"),
    ("prefill_attention_impl", "xla", "plain-version"),
    ("pipeline_microbatches", 2, "A6"),
    ("attention_impl", "bogus", "unknown"),
])
def test_llama_config_rejects_unported_impls(key, value, match):
    with pytest.raises(ValueError, match=match):
        tllama.LlamaConfig(**{key: value})
    with pytest.raises(ValueError, match=match):
        ttrainer.Trainer(ttrainer.TrainerConfig(
            model_overrides={key: value}), device="cpu")


def test_mfu():
    assert tmfu.mfu(989e12, 1.0, 1, peak_per_device=989e12) == 1.0
    assert tmfu.mfu(1e12, 0.0, 1) == 0.0
    assert tmfu.device_peak_flops("cpu") == 1e11
    assert tmfu.PEAK_FLOPS["H100 80GB HBM3"] == 989e12
    assert tmfu.PEAK_FLOPS["H100 PCIe"] == 756e12


def test_cuda_without_a_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = ttrainer.TrainerConfig(model_overrides=TINY)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrainer.Trainer(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrainer.Trainer(cfg, device="cuda")
    trainer = ttrainer.Trainer(cfg, device="cpu")
    trainer.device = torch.device("cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trainer.init_state()


def test_registry_and_unknown_model():
    from kubeflow_tpu_torch.models import registry
    assert registry.names() == ["llama"]
    assert registry.make_config("llama", TINY).d_model == 64
    with pytest.raises(KeyError, match="unknown model"):
        ttrainer.Trainer(ttrainer.TrainerConfig(model="bert"), device="cpu")
    assert dataclasses.asdict(ttrainer.OptimizerConfig())["b2"] == 0.95
