"""The port's MoE (ops/moe.py, models/moe_llama.py: the `mixtral` family)
against the JAX package at f32 on tiny configs: routing on fixed logits
(ties, a capacity overflow) with the masks exactly equal, the expert MLP,
Mixtral's logits, loss and gradients (params carried across by
from_jax_tree), flops_per_token, and three Trainer steps against the JAX
Trainer's."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kubeflow_tpu.models import moe_llama as jmoe
from kubeflow_tpu.ops import moe as jops
from kubeflow_tpu.training import data as jdata
from kubeflow_tpu.training import trainer as jtrainer
from kubeflow_tpu_torch.models import interop, registry
from kubeflow_tpu_torch.models import moe_llama as tmoe
from kubeflow_tpu_torch.ops import moe as tops
from kubeflow_tpu_torch.training import data as tdata
from kubeflow_tpu_torch.training import trainer as ttrainer
from kubeflow_tpu_torch.training.metrics_writer import MetricsWriter

torch.set_num_threads(2)

ATOL = 1e-4        # logits and losses, absolute
GRAD_TOL = 1e-4    # each gradient leaf, relative to its norm
TINY = dict(vocab_size=512, d_model=64, n_layers=2, n_heads=8, n_kv_heads=4,
            d_ff=96, max_seq_len=128, rope_theta=10000.0, n_experts=4,
            top_k=2)


def _logits(case: str) -> np.ndarray:
    rng = np.random.default_rng(3)
    if case == "ample":
        return rng.normal(size=(16, 4)).astype(np.float32)
    if case == "ties":
        # equal top scores in every row, and whole rows equal
        x = np.round(rng.normal(size=(24, 6)), 1).astype(np.float32)
        x[:, 2] = x[:, 4] = x.max(axis=1) + 1.0
        x[10:14] = x[3]
        return x
    # overflow: most tokens prefer expert 0
    x = rng.normal(size=(40, 4)).astype(np.float32)
    x[:, 0] += 3.0
    return x


ROUTE_ARGS = {"ample": dict(n_experts=4, top_k=2, capacity_factor=4.0),
              "ties": dict(n_experts=6, top_k=2, capacity_factor=1.25),
              "overflow": dict(n_experts=4, top_k=2, capacity_factor=0.5)}


@pytest.mark.parametrize("case", sorted(ROUTE_ARGS))
def test_route_matches_jax(case):
    """Dispatch exactly JAX's (the argmax's first index on ties, slots
    from the cumsum with the carried fill, overflow dropped), combine and
    the aux loss within f32 rounding."""
    x = _logits(case)
    kw = ROUTE_ARGS[case]
    jd, jc, ja = jax.jit(lambda x: jops.route(x, jops.MoEArgs(**kw)))(
        jnp.asarray(x))
    td, tc, ta = tops.route(torch.from_numpy(x), tops.MoEArgs(**kw))
    assert td.shape == jd.shape
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-6)
    np.testing.assert_allclose(float(ta), float(ja), rtol=1e-6)
    cap = tops.expert_capacity(x.shape[0], kw["n_experts"], kw["top_k"],
                               kw["capacity_factor"])
    assert cap == jops.expert_capacity(x.shape[0], kw["n_experts"],
                                       kw["top_k"], kw["capacity_factor"])
    if case == "overflow":
        assert td.sum() < x.shape[0] * kw["top_k"]   # some were dropped


def _grad_close(name, got, want):
    want = np.asarray(want)
    err = np.abs(got.detach().numpy() - want).max()
    assert err <= GRAD_TOL * max(np.linalg.norm(want), 1e-12), name


def test_moe_mlp_and_grads_match_jax():
    rng = np.random.default_rng(0)
    d, f, e = 16, 24, 4
    x = rng.normal(size=(2, 10, d)).astype(np.float32)
    ws = [rng.normal(size=s).astype(np.float32) / s[-2] ** 0.5 for s in
          ((d, e), (e, d, f), (e, d, f), (e, f, d))]
    args = dict(n_experts=e, top_k=2, capacity_factor=1.0)

    def jf(x, *ws):
        out, aux = jops.moe_mlp(x, *ws, jops.MoEArgs(**args),
                                dtype=jnp.float32)
        return jnp.sum(out * out) + aux, (out, aux)

    (_, (jout, jaux)), jgrads = jax.jit(jax.value_and_grad(
        jf, argnums=(0, 1, 2, 3, 4), has_aux=True))(x, *ws)
    tx = [torch.from_numpy(a).requires_grad_() for a in (x, *ws)]
    tout, taux = tops.moe_mlp(*tx, tops.MoEArgs(**args), dtype=torch.float32)
    tgrads = torch.autograd.grad((tout * tout).sum() + taux, tx)
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout),
                               atol=ATOL)
    np.testing.assert_allclose(float(taux), float(jaux), atol=1e-6)
    for name, g, jg in zip(("x", "router", "w_gate", "w_up", "w_down"),
                           tgrads, jgrads):
        _grad_close(name, g, jg)


@pytest.fixture(scope="module")
def mixtral():
    jcfg = jmoe.MoELlamaConfig(**TINY, dtype=jnp.float32)
    jparams = jmoe.init(jax.random.key(0), jcfg)
    tcfg = tmoe.MoELlamaConfig(**TINY, dtype="float32")
    np_params = jax.tree.map(np.asarray, jparams)
    return jcfg, jparams, tcfg, np_params


def test_mixtral_apply_loss_and_grads_match_jax(mixtral):
    jcfg, jparams, tcfg, np_params = mixtral
    rng = np.random.default_rng(1)
    batch = {"tokens": rng.integers(0, 512, (2, 48)).astype(np.int32),
             "loss_mask": (rng.random((2, 48)) < 0.8).astype(np.float32)}
    jlogits, jaux = jax.jit(
        lambda p, t: jmoe.apply(p, t, jcfg, return_aux=True))(
        jparams, jnp.asarray(batch["tokens"]))
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p, b: jmoe.loss_fn(p, b, jcfg), has_aux=True))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})

    params = interop.from_jax_tree(np_params, tmoe.abstract_params(tcfg),
                                   device="cpu")
    named = ttrainer.named_leaves(params)
    for _, p in named:
        p.requires_grad_(True)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tlogits, taux = tmoe.apply(params, tb["tokens"], tcfg, return_aux=True)
    np.testing.assert_allclose(tlogits.detach().numpy(), np.asarray(jlogits),
                               atol=ATOL)
    np.testing.assert_allclose(float(taux), float(jaux), atol=1e-6)
    tl, tm = tmoe.loss_fn(params, tb, tcfg)
    np.testing.assert_allclose(float(tl), float(jl), atol=ATOL)
    for k in ("loss", "aux_loss", "tokens"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), atol=ATOL)
    grads = torch.autograd.grad(tl, [p for _, p in named])
    jflat = dict(ttrainer.named_leaves(jax.tree.map(np.asarray, jg)))
    assert set(jflat) == {n for n, _ in named}
    for (name, _), g in zip(named, grads):
        _grad_close(name, g, jflat[name])


def test_mixtral_tree_and_flops_match_jax(mixtral):
    """init's tree equals JAX's leaf for leaf in shape and dtype (its
    abstract too), from_jax_tree refuses a changed tree, and
    flops_per_token counts the active experts as JAX does."""
    jcfg, _, tcfg, np_params = mixtral
    want = {n: (a.shape, a.dtype.name)
            for n, a in ttrainer.named_leaves(np_params)}
    for tree in (tmoe.init(tcfg, seed=1, device="cpu"),
                 tmoe.abstract_params(tcfg)):
        got = {n: (tuple(t.shape), str(t.dtype).removeprefix("torch."))
               for n, t in ttrainer.named_leaves(tree)}
        assert got == want
    bad = dict(np_params, layers=dict(np_params["layers"]))
    bad["layers"]["router"] = bad["layers"]["router"][:, :, :2]
    with pytest.raises(ValueError, match="layers/router"):
        interop.from_jax_tree(bad, tmoe.abstract_params(tcfg), device="cpu")
    del bad["layers"]["router"]
    with pytest.raises(ValueError, match="keys"):
        interop.from_jax_tree(bad, tmoe.abstract_params(tcfg), device="cpu")
    for jc, tc in ((jcfg, tcfg), (jmoe.MoELlamaConfig.mixtral_8x7b(),
                                  tmoe.MoELlamaConfig.mixtral_8x7b())):
        for s in (128, 4096):
            assert tmoe.flops_per_token(tc, s) == jmoe.flops_per_token(jc, s)
    assert registry.get("mixtral").config_cls is tmoe.MoELlamaConfig


def test_mixtral_trainer_matches_jax_trainer():
    """Three Trainer steps of `mixtral` (router aux loss, AdamW) from the
    same params and batches: losses, aux, grad norms and the final
    params."""
    steps, seq, batch = 3, 32, 2
    opt = dict(learning_rate=1e-2, warmup_steps=1, total_steps=10)
    jcfg = jtrainer.TrainerConfig(
        model="mixtral", model_overrides=dict(TINY, dtype=jnp.float32),
        batch_size=batch, optimizer=jtrainer.OptimizerConfig(**opt),
        log_every=1, seed=0)
    jt = jtrainer.Trainer(jcfg, devices=jax.devices()[:1],
                          metrics=MetricsWriter(echo=False))
    jstate = jt.init_state()
    init = jax.tree.map(np.array, jstate["params"])
    j_log = []
    jstate = jt.train(jdata.for_model("mixtral", jt.model_cfg, batch, seq, 0),
                      steps, jstate, step_callback=lambda s, m: j_log.append(m))
    j_final = dict(ttrainer.named_leaves(
        jax.tree.map(np.asarray, jstate["params"])))

    tcfg = ttrainer.TrainerConfig(
        model="mixtral", model_overrides=dict(TINY, dtype="float32"),
        batch_size=batch, optimizer=ttrainer.OptimizerConfig(**opt),
        log_every=1, seed=0)
    tt = ttrainer.Trainer(tcfg, device="cpu",
                          metrics=MetricsWriter(echo=False))
    tstate = tt.init_state(interop.from_jax_tree(
        init, tt.model.abstract(tt.model_cfg), device="cpu"))
    t_log = []
    tstate = tt.train(tdata.for_model("mixtral", tt.model_cfg, batch, seq, 0),
                      steps, tstate, step_callback=lambda s, m: t_log.append(m))
    assert len(t_log) == len(j_log) == steps
    for t, j in zip(t_log, j_log):
        for k in ("loss", "aux_loss", "grad_norm"):
            np.testing.assert_allclose(t[k], j[k], rtol=1e-4, atol=1e-6)
        assert t["tokens"] == j["tokens"] == batch * (seq - 1)
    for name, p in ttrainer.named_leaves(tstate["params"]):
        w = j_final[name]
        err = np.abs(p.detach().numpy() - w).max()
        assert err <= GRAD_TOL * max(np.linalg.norm(w), 1e-12), name


def test_config_fields_and_dtype_names():
    jcfg = jmoe.MoELlamaConfig.tiny()
    tcfg = tmoe.MoELlamaConfig.tiny()
    for f in dataclasses.fields(jcfg):
        if f.name not in ("dtype", "param_dtype"):
            assert getattr(tcfg, f.name) == getattr(jcfg, f.name), f.name
    cfg = tmoe.MoELlamaConfig(**TINY, dtype="bfloat16")
    assert cfg.dtype is torch.bfloat16 and cfg.moe_args.n_experts == 4
