"""LoRA fine-tuning in the port (models/lora.py, the `llama_lora`
registry entry, the trainer's `trainable_prefix`) against the JAX
package: merge/apply/loss_fn on the same params, the merged model equal
to the base at init, the config checks, the freezing optimizer step for
step against optax's multi_transform, optimizer state for the adapters
alone, and examples/llama-lora-jaxjob.yaml through `train_target`
against the JAX job, cancelled and resumed."""

from __future__ import annotations

import dataclasses
import json
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from kubeflow_tpu.models import lora as jlora
from kubeflow_tpu.training import job as jjob
from kubeflow_tpu.training import trainer as jtrainer
from kubeflow_tpu_torch.models import interop, registry
from kubeflow_tpu_torch.models import llama as tllama
from kubeflow_tpu_torch.models import lora as tlora
from kubeflow_tpu_torch.training import job as tjob
from kubeflow_tpu_torch.training import trainer as ttrainer
from kubeflow_tpu_torch.training.checkpoint import (CheckpointManager,
                                                    restore_params)
from kubeflow_tpu_torch.training.loader import write_corpus
from kubeflow_tpu_torch.training.metrics_writer import read_metrics

yaml = pytest.importorskip("yaml")

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = {"vocab_size": 256, "d_model": 64, "n_layers": 2, "n_heads": 8,
        "n_kv_heads": 4, "d_ff": 128, "max_seq_len": 128,
        "rope_theta": 10000.0, "dtype": "float32"}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_params(rank=4, alpha=8.0, seed=0, b_scale=0.05):
    """A JAX llama_lora tree with random nonzero b (LoRA's b = 0 would
    make every adapter check pass on code that ignores the adapters)."""
    cfg = jlora.LoraLlamaConfig(rank=rank, alpha=alpha, llama=TINY)
    params = jlora.init(jax.random.key(seed), cfg)
    rng = np.random.default_rng(seed + 7)
    params["lora"] = {t: {"a": ab["a"], "b": jnp.asarray(
        rng.normal(size=ab["b"].shape).astype(np.float32) * b_scale)}
        for t, ab in params["lora"].items()}
    return cfg, params


def _tree_close(got, want, **tol):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _tree_close(got[k], want[k], **tol)
        return
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)


def test_merge_apply_and_loss_match_jax():
    jcfg, jparams = _jax_params()
    tcfg = tlora.LoraLlamaConfig(rank=4, alpha=8.0, llama=TINY)
    tparams = interop.from_jax_lora_params(_np(jparams), tcfg, device="cpu")
    _tree_close(tlora.merge(tparams, tcfg),
                _np(jlora.merge(jparams, jcfg)), rtol=1e-5, atol=1e-7)
    _tree_close(tlora.adapter_only(tparams),
                _np(jlora.adapter_only(jparams)), rtol=0, atol=0)
    tokens = np.random.default_rng(3).integers(0, 256, (2, 16))
    np.testing.assert_allclose(
        tlora.apply(tparams, torch.from_numpy(tokens), tcfg).numpy(),
        np.asarray(jlora.apply(jparams, jnp.asarray(tokens), jcfg)),
        rtol=1e-5, atol=1e-5)
    batch = {"tokens": tokens.astype(np.int32)}
    tloss, _ = tlora.loss_fn(tparams, {"tokens": torch.from_numpy(
        batch["tokens"])}, tcfg)
    jloss, _ = jlora.loss_fn(jparams, jax.tree.map(jnp.asarray, batch), jcfg)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    # the base enters detached: no gradient reaches it through merge
    for p in ttrainer.leaves(tparams):
        p.requires_grad_(True)
    tloss, _ = tlora.loss_fn(tparams, {"tokens": torch.from_numpy(
        batch["tokens"])}, tcfg)
    tloss.backward()
    assert all(p.grad is None for p in ttrainer.leaves(tparams["base"]))
    assert all(p.grad is not None for p in ttrainer.leaves(tparams["lora"]))
    jgrads = jax.grad(lambda p: jlora.loss_fn(
        p, jax.tree.map(jnp.asarray, batch), jcfg)[0])(jparams)
    assert float(jnp.abs(jgrads["base"]["layers"]["wq"]).max()) == 0.0


def test_merged_model_equals_the_base_at_init():
    cfg = tlora.LoraLlamaConfig(rank=4, llama=TINY)
    params = tlora.init(cfg, seed=0, device="cpu")
    merged = tlora.merge(params, cfg)
    for t in cfg.targets:
        assert torch.equal(merged["layers"][t], params["base"]["layers"][t])
        assert not params["lora"][t]["b"].any()
        a = params["lora"][t]["a"]
        assert a.shape == (2, tllama.matmul_shapes(cfg.base_cfg)[t][0], 4)
        # a ~ N(0, 1 / d_in)
        assert abs(float(a.std()) * a.shape[1] ** 0.5 - 1.0) < 0.2
    toks = torch.arange(1, 17)[None]
    assert torch.equal(tllama.apply(params["base"], toks, cfg.base_cfg),
                       tlora.apply(params, toks, cfg))


def test_config_validation():
    for bad in (dict(rank=0), dict(targets=("nonsense",)),
                dict(llama={"d_modle": 64})):
        with pytest.raises(ValueError):
            tlora.LoraLlamaConfig(**bad)
        with pytest.raises(ValueError):
            jlora.LoraLlamaConfig(**bad)
    cfg = tlora.LoraLlamaConfig(rank=4, llama=TINY)
    assert cfg.vocab_size == 256 and cfg.n_layers == 2   # delegation
    assert cfg.base_cfg.dtype == torch.float32
    assert tlora.LoraLlamaConfig(targets=["wq", "w_down"]).targets == (
        "wq", "w_down")


@pytest.mark.parametrize("mu_dtype", [None, "bfloat16"])
def test_trainable_prefix_matches_optax_multi_transform(mu_dtype):
    """5 updates of a llama_lora tree under trainable_prefix "lora", the
    clip hit and every leaf given a gradient (the frozen ones count in
    the global norm, as optax clips before multi_transform): params and
    the adapters' mu/nu against optax at f32; mu stored in bf16 with
    bf16(b1) when asked (the pin of ROADMAP.md §C)."""
    kw = dict(name="adamw", learning_rate=0.05, warmup_steps=2,
              total_steps=6, weight_decay=0.1, grad_clip=1.0,
              schedule="cosine", mu_dtype=mu_dtype, trainable_prefix="lora")
    _, jparams = _jax_params(rank=2)
    params = _np(jparams)
    rng = np.random.default_rng(5)
    grads = [jax.tree.map(lambda x: (rng.normal(size=x.shape) * 0.3).astype(
        np.float32), params) for _ in range(5)]
    opt = jtrainer.make_optimizer(jtrainer.OptimizerConfig(**kw))
    jp = jax.tree.map(jnp.asarray, params)
    jstate = opt.init(jp)
    topt = ttrainer.make_optimizer(ttrainer.OptimizerConfig(**kw))
    named = ttrainer.named_leaves(jax.tree.map(
        lambda x: torch.from_numpy(x.copy()), params))
    paths = [p for p, _ in named]
    tp = [t for _, t in named]
    tstate = topt.init(tp, paths)
    lora_idx = [i for i, p in enumerate(paths) if p.startswith("lora/")]
    assert topt.trainable_indices(len(tp), paths) == lora_idx
    assert len(tstate["mu"]) == len(tstate["nu"]) == len(lora_idx) == 8
    for g in grads:
        upd, jstate = opt.update(jax.tree.map(jnp.asarray, g), jstate, jp)
        jp = optax.apply_updates(jp, upd)
        topt.update([torch.from_numpy(x) for x in jax.tree.leaves(g)],
                    tstate, tp, paths)
        for t, j in zip(tp, jax.tree.leaves(jp)):
            np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5,
                                       atol=1e-7)
    # the adapters' moments, in leaf order, against the train branch's
    inner = jstate[1].inner_states["train"].inner_state[0]
    jmu = [x for x in jax.tree.leaves(inner.mu) if x.ndim]
    jnu = [x for x in jax.tree.leaves(inner.nu) if x.ndim]
    for t, j in zip(tstate["mu"], jmu):
        assert t.dtype == (torch.bfloat16 if mu_dtype else torch.float32)
        np.testing.assert_allclose(t.float().numpy(),
                                   np.asarray(j, np.float32), rtol=1e-5,
                                   atol=1e-7)
    for t, j in zip(tstate["nu"], jnu):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5,
                                   atol=1e-9)
    # frozen leaves: bit for bit unchanged
    for i, (path, t) in enumerate(named):
        if i not in lora_idx:
            assert np.array_equal(t.numpy(), jax.tree.leaves(params)[i])


def test_only_the_adapters_have_optimizer_state():
    cfg = ttrainer.TrainerConfig(
        model="llama_lora", model_overrides=dict(rank=2, llama=TINY),
        optimizer=ttrainer.OptimizerConfig(trainable_prefix="lora"))
    trainer = ttrainer.Trainer(cfg, device="cpu")
    for state in (trainer.init_state(), trainer.abstract_state()):
        named = ttrainer.named_leaves(state["params"])
        lora_leaves = [t for p, t in named if p.startswith("lora/")]
        assert all(t.requires_grad == p.startswith("lora/")
                   for p, t in named)
        mu, nu = state["opt_state"]["mu"], state["opt_state"]["nu"]
        assert [m.shape for m in mu] == [t.shape for t in lora_leaves]
        assert [n.shape for n in nu] == [t.shape for t in lora_leaves]
        n_opt = sum(m.numel() for m in mu + nu)
        n_all = sum(t.numel() for _, t in named)
        assert n_opt == 2 * sum(t.numel() for t in lora_leaves) < n_all / 10
    # a frozen base needs no gradient: the step takes the adapters' only
    state = trainer.init_state()
    base = [t.clone() for t in ttrainer.leaves(state["params"]["base"])]
    batch = {"tokens": torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (2, 16)).astype(np.int32))}
    for _ in range(3):
        m = trainer.train_step(state, batch)
    assert np.isfinite(float(m["grad_norm"])) and float(m["grad_norm"]) > 0
    assert all(torch.equal(a, b) for a, b in zip(
        base, ttrainer.leaves(state["params"]["base"])))
    assert all(state["params"]["lora"][t]["b"].abs().max() > 0
               for t in ("wq", "wk", "wv", "wo"))


def test_registry_entry():
    assert "llama_lora" in registry.names()
    model = registry.get("llama_lora")
    cfg = registry.make_config("llama_lora", dict(rank=3, llama=TINY))
    assert isinstance(cfg, tlora.LoraLlamaConfig)
    real = model.init(cfg, seed=1, device="cpu")
    abstract = model.abstract(cfg)
    assert [(p, t.shape, t.dtype) for p, t in ttrainer.named_leaves(real)] \
        == [(p, t.shape, t.dtype)
            for p, t in ttrainer.named_leaves(abstract)]
    assert all(t.device.type == "meta" for t in ttrainer.leaves(abstract))


def _example_config() -> dict:
    with open(os.path.join(ROOT, "examples", "llama-lora-jaxjob.yaml")) as f:
        job = yaml.safe_load(f)
    env = job["spec"]["replicaSpecs"]["worker"]["template"]["env"]
    return json.loads(env["KTPU_TRAINER_CONFIG"])


def test_chip_smoke_l2_runs_the_lora_example_job():
    """chip_smoke (l2) trains examples/llama-lora-jaxjob.yaml's trainer
    config, key for key; both jobs parse it to the same config."""
    import chip_smoke

    raw = _example_config()
    assert chip_smoke.L2_JOB == raw
    env = {"KTPU_TRAINER_CONFIG": json.dumps(raw)}
    tcfg, tn = tjob.config_from_env(env)
    jcfg, jn = jjob.config_from_env(env)
    assert tn == jn == 50
    assert tcfg.model == jcfg.model == "llama_lora"
    assert tcfg.optimizer.trainable_prefix == "lora"
    assert dataclasses.asdict(tcfg.optimizer) == dataclasses.asdict(
        jcfg.optimizer)
    assert tcfg.model_overrides == jcfg.model_overrides


class CancelAt(threading.Event):
    """Reads as set from its n-th check on (once a logged step)."""

    def __init__(self, n: int):
        super().__init__()
        self.n, self.checks = n, 0

    def is_set(self) -> bool:
        self.checks += 1
        return self.checks >= self.n or super().is_set()


def _job_env(tmp_path, tag: str, corpus: str) -> dict:
    """The example's config shrunk to the tiny f32 model, a local corpus
    and 6 steps, with checkpoints every 2."""
    raw = _example_config()
    raw.update(batch_size=2, num_steps=6, log_every=1,
               checkpoint_dir=str(tmp_path / f"ckpt-{tag}"),
               checkpoint_every=2, keep_checkpoints=3, mesh={"data": 1})
    raw["model_overrides"] = dict(raw["model_overrides"], llama=TINY)
    raw["dataset"].update(path=corpus, seq_len=32)
    return {"KTPU_TRAINER_CONFIG": json.dumps(raw),
            "KTPU_METRICS_FILE": str(tmp_path / f"metrics-{tag}.jsonl"),
            tjob.DEVICE_ENV: "cpu"}


def test_lora_job_matches_the_jax_job_and_resumes(tmp_path, monkeypatch):
    """Both jobs cancelled at step 5 and run again: the same steps and
    losses (rtol 1e-5); the port's step-4 checkpoint holds the state of
    an uninterrupted in-process run bit for bit (its frozen base without
    moments), and its adapters restore alone (params/lora)."""
    corpus = str(tmp_path / "corpus.bin")
    write_corpus(corpus, np.random.default_rng(0).integers(0, 256, 20_000))
    jenv = _job_env(tmp_path, "jax", corpus)
    tenv = _job_env(tmp_path, "port", corpus)
    jcfg, _ = jjob.config_from_env(jenv)
    init = _np(jtrainer.Trainer(jcfg, devices=jax.devices()[:1])
               .init_state()["params"])
    orig = ttrainer.Trainer.init_state
    monkeypatch.setattr(
        ttrainer.Trainer, "init_state", lambda self, params=None: orig(
            self, interop.from_jax_lora_params(init, self.model_cfg,
                                               device="cpu")))
    for run in (1, 2):
        for target, env in ((jjob.train_target, jenv),
                            (tjob.train_target, tenv)):
            try:
                target(env, CancelAt(5) if run == 1 else threading.Event())
            except SystemExit as e:
                assert run == 1 and e.code == 143
    losses = [[(r["step"], r["metrics"]["loss"]) for r in read_metrics(
        env["KTPU_METRICS_FILE"])] for env in (jenv, tenv)]
    assert [s for s, _ in losses[1]] == [s for s, _ in losses[0]] == [
        1, 2, 3, 4, 5, 5, 6]
    np.testing.assert_allclose([v for _, v in losses[1]],
                               [v for _, v in losses[0]], rtol=1e-5)
    # the uninterrupted run's step 4, in-process, against the checkpoint
    tcfg, _ = tjob.config_from_env(tenv)
    trainer = ttrainer.Trainer(dataclasses.replace(tcfg, checkpoint_dir=None),
                               device="cpu")
    trainer.metrics.echo = False
    from kubeflow_tpu_torch.training import data as tdata

    data = tdata.make_dataset(tcfg.dataset, tcfg.model, trainer.model_cfg,
                              tcfg.batch_size, fallback_seed=tcfg.seed)
    live = trainer.train(data, 4)
    data.close()
    saved = CheckpointManager(tcfg.checkpoint_dir).restore(
        trainer.abstract_state(), step=4, device="cpu")
    assert saved["step"] == live["step"] == 4
    assert len(saved["opt_state"]["mu"]) == 8       # 4 targets x (a, b)
    for a, b in zip(ttrainer.leaves(live["params"]) + live["opt_state"]["mu"]
                    + live["opt_state"]["nu"],
                    ttrainer.leaves(saved["params"])
                    + saved["opt_state"]["mu"] + saved["opt_state"]["nu"]):
        assert torch.equal(a.detach(), b.detach())
    lcfg = trainer.model_cfg
    alone = restore_params(tcfg.checkpoint_dir,
                           tlora.abstract_params(lcfg)["lora"], step=4,
                           subtree="params/lora")
    for t in lcfg.targets:
        for k in ("a", "b"):
            assert torch.equal(alone[t][k], saved["params"]["lora"][t][k])


def test_head_dim_32_runs_the_kernels_on_padded_heads():
    """examples/llama-lora-jaxjob.yaml's model has head dim 32 and the
    kernels take 64 or 128: on the card the wrappers zero-pad the heads
    to 64 (`on_padded_heads`) and drop the extra columns. The same helper
    around the plain versions gives the unpadded results: training
    forward and backward, decode (slab int8 and paged) and prefill."""
    from kubeflow_tpu_torch.ops import attention, flash_decode, flash_prefill
    from kubeflow_tpu_torch.ops import flash_attention as fa

    padded = attention.on_padded_heads
    g = torch.Generator().manual_seed(0)

    def rnd(*shape):
        return torch.randn(shape, generator=g)

    q, k, v = rnd(2, 16, 4, 32), rnd(2, 16, 2, 32), rnd(2, 16, 2, 32)
    for x in (q, k, v):
        x.requires_grad_(True)
    want = fa.flash_attention(q, k, v)
    want.square().sum().backward()
    grads = [x.grad.clone() for x in (q, k, v)]
    for x in (q, k, v):
        x.grad = None
    got = padded(fa.flash_attention, q, k, v, None)
    got.square().sum().backward()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    for a, b in zip((q.grad, k.grad, v.grad), grads):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    q = rnd(3, 2, 4, 32)
    k8, ks = tllama.quantize_kv(rnd(3, 24, 2, 32))
    v8, vs = tllama.quantize_kv(rnd(3, 24, 2, 32))
    lengths = torch.tensor([5, 0, 20], dtype=torch.int32)
    want = flash_decode.flash_decode_attention(q, k8, v8, lengths,
                                               k_scale=ks, v_scale=vs)
    got = padded(flash_decode.flash_decode_attention, q, k8, v8, None,
                 lengths=lengths, k_scale=ks, v_scale=vs)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    pool_k, pool_v = rnd(7, 8, 2, 32), rnd(7, 8, 2, 32)
    tables = torch.tensor([[3, 1, 5], [2, 6, 4], [1, 1, 1]],
                          dtype=torch.int32)
    want = flash_decode.flash_decode_attention(q, pool_k, pool_v, lengths,
                                               tables=tables)
    got = padded(flash_decode.flash_decode_attention, q, pool_k, pool_v,
                 None, lengths=lengths, tables=tables)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    q, k, v = rnd(2, 8, 4, 32), rnd(2, 24, 2, 32), rnd(2, 24, 2, 32)
    want = flash_prefill.flash_prefill_attention(q, k, v, q_offset=16)
    got = padded(flash_prefill.flash_prefill_attention, q, k, v, None,
                 q_offset=16)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
