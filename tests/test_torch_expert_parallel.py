"""Mixtral past one rank (ops/moe.py and models/moe_llama.py on a mesh)
against the JAX Trainer on the same mesh of virtual CPU devices. The
port's ranks are gloo processes (tests/torch_ranks.py); the JAX trainers
run here meanwhile.

The tiny config at f32 from the JAX init, capacity_factor 0.5 so that
tokens overflow their experts and the global token order decides which
are dropped (a per-shard routing drops others), loss masks whose token
counts differ between the data shards: three steps on {data: 2, fsdp:
2}, {data: 2, expert: 2} and {expert: 2, tensor: 2}, whose losses,
aux losses, tokens, grad norms and blocks are JAX's. The router's
gradient of the global loss (the combine's share summed over `expert`,
the aux and z terms counted once, the global aux not scaled again) on
{expert: 2} and {data: 2, expert: 2} equals the port's one-rank gradient
and `jax.grad` of the JAX loss."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kubeflow_tpu.models import moe_llama as jmoe
from kubeflow_tpu.parallel import MeshConfig
from kubeflow_tpu.training import trainer as jtrainer
from kubeflow_tpu_torch.models import moe_llama as tmoe
from kubeflow_tpu_torch.training import trainer as ttrainer
from kubeflow_tpu_torch.training.metrics_writer import MetricsWriter

import torch_ranks

torch.set_num_threads(2)

TINY = dict(vocab_size=512, d_model=64, n_layers=2, n_heads=8, n_kv_heads=4,
            d_ff=96, max_seq_len=128, rope_theta=10000.0, n_experts=4,
            top_k=2, capacity_factor=0.5)
OPT = dict(learning_rate=1e-2, warmup_steps=1, total_steps=10)
B, S, STEPS = 8, 16, 3
RTOL = 2e-5        # f32 against XLA on the same mesh
BLOCK_TOL = 1e-4   # a block after three AdamW steps, of its leaf's norm
GRAD_TOL = 1e-5    # the router's gradient, of its norm
MESHES = {"data_fsdp": MeshConfig(data=2, fsdp=2),
          "data_expert": MeshConfig(data=2, expert=2),
          "expert_tensor": MeshConfig(expert=2, tensor=2)}


def _batches():
    rng = np.random.default_rng(5)
    out = []
    for _ in range(STEPS):
        mask = np.ones((B, S), np.float32)
        mask[1:3, 6:] = 0.0
        mask[5, 2:] = 0.0
        out.append({"tokens": rng.integers(0, 512, (B, S)).astype(np.int32),
                    "loss_mask": mask})
    return out


def _jax(mesh):
    cfg = jtrainer.TrainerConfig(
        model="mixtral", model_overrides=dict(TINY, dtype=jnp.float32),
        batch_size=B, optimizer=jtrainer.OptimizerConfig(**OPT), mesh=mesh,
        seed=0)
    jt = jtrainer.Trainer(cfg, devices=jax.devices()[:4],
                          metrics=MetricsWriter(echo=False))
    return jt, jt.init_state()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("expert"))
    batches = _batches()
    jts = {"data_fsdp": _jax(MESHES["data_fsdp"])}
    init = [np.array(x) for x in jax.tree.leaves(
        jts["data_fsdp"][1]["params"])]
    inputs = {"config": dict(
        model="mixtral", model_overrides=dict(TINY, dtype="float32"),
        batch_size=B, optimizer=ttrainer.OptimizerConfig(**OPT), seed=0),
        "params": init, "batches": batches}
    torch_ranks.write_inputs("expert", d, inputs)
    torch_ranks.write_inputs("expert2", d, inputs)
    h1 = torch_ranks.start("expert", 4, d)
    h2 = torch_ranks.start("expert2", 2, d)
    # the other JAX trainers build and step while the ranks run
    jts.update((k, _jax(m)) for k, m in MESHES.items() if k not in jts)
    logs, states = {}, {}
    for key, (jt, state) in jts.items():
        step = None
        log = []
        for b in batches:
            b = jt.shard_batch(b)
            step = step or jt.compiled_step(state, b)
            state, m = step(state, b)
            log.append({k: float(v) for k, v in jax.device_get(m).items()})
        logs[key], states[key] = log, state
    ranks, two = torch_ranks.finish(h1), torch_ranks.finish(h2)
    return dict(jts=jts, logs=logs, states=states, ranks=ranks, two=two,
                init=init, batches=batches)


@pytest.mark.parametrize("key", sorted(MESHES))
def test_mixtral_matches_jax_on_the_mesh(runs, key):
    """Losses, aux losses, tokens (each data shard counted once) and grad
    norms on every rank, and each rank's blocks, against the JAX
    trainer on the same mesh."""
    jt, _ = runs["jts"][key]
    for r in runs["ranks"]:
        got = r[key]["log"]
        assert len(got) == STEPS
        for x, y in zip(got, runs["logs"][key]):
            for k in ("loss", "aux_loss", "grad_norm", "tokens"):
                np.testing.assert_allclose(x[k], y[k], rtol=RTOL, err_msg=k)
    mesh = jt.mesh
    coords = {mesh.devices[i]: i for i in np.ndindex(mesh.devices.shape)}
    place = jax.tree.leaves(jt.param_sharding,
                            is_leaf=lambda x: hasattr(x, "spec"))
    by_coord = {r[key]["coord"]: r[key] for r in runs["ranks"]}
    for i, leaf in enumerate(jax.tree.leaves(runs["states"][key]["params"])):
        tol = BLOCK_TOL * max(float(np.linalg.norm(np.asarray(leaf))), 1e-6)
        for shard in jax.device_put(leaf, place[i]).addressable_shards:
            mine = by_coord[coords[shard.device]]["params"][i]
            assert mine.shape == shard.data.shape, i
            assert np.abs(mine - np.asarray(shard.data)).max() <= tol, i


def test_capacity_drops_tokens_in_the_global_order(runs):
    """At capacity_factor 0.5 the first layer's routing of the first
    batch drops tokens, and routing each data shard alone (capacity and
    slot order of its half) drops others: the parity above rests on the
    global order."""
    cfg = tmoe.MoELlamaConfig(**dict(TINY, dtype="float32"))
    args = cfg.moe_args
    rng = np.random.default_rng(0)
    logits = torch.from_numpy(rng.normal(size=(B * S, 4)).astype(np.float32))
    from kubeflow_tpu_torch.ops import moe as tops

    whole, _, _ = tops.route(logits, args)
    halves = [tops.route(h, args)[0] for h in logits.chunk(2)]
    kept = whole.sum(dim=(1, 2))
    assert (kept < args.top_k).any()
    assert not torch.equal(kept, torch.cat([h.sum(dim=(1, 2))
                                            for h in halves]))


def _router_grads(runs):
    """(the port's one-rank router gradient, JAX's) of the first batch's
    loss from the initial params."""
    from kubeflow_tpu_torch.models import interop

    batch = runs["batches"][0]
    jcfg = runs["jts"]["data_fsdp"][0].model_cfg
    jparams = jax.tree.unflatten(jax.tree.structure(
        runs["states"]["data_fsdp"]["params"]),
        [jnp.asarray(x) for x in runs["init"]])
    jg = jax.grad(lambda p: jmoe.loss_fn(
        p, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg)[0])(jparams)
    tcfg = tmoe.MoELlamaConfig(**dict(TINY, dtype="float32"))
    params = interop.from_jax_tree(jax.tree.map(np.asarray, jparams),
                                   tmoe.abstract_params(tcfg), device="cpu")
    router = params["layers"]["router"].requires_grad_(True)
    loss, _ = tmoe.loss_fn(params, {k: torch.from_numpy(v) for k, v in
                                    batch.items()}, tcfg)
    (tg,) = torch.autograd.grad(loss, [router])
    return tg.numpy(), np.asarray(jg["layers"]["router"])


def test_router_gradient_equals_one_rank_and_jax(runs):
    """Trap (b): on {expert: 2} and {data: 2, expert: 2} the router's
    gradient equals the one-rank gradient and JAX's (a per-rank combine
    not summed over `expert`, or the aux counted per rank, or scaled
    again by a rank's share, gives another)."""
    one, want = _router_grads(runs)
    tol = GRAD_TOL * np.linalg.norm(want)
    assert np.abs(one - want).max() <= tol
    for r in runs["ranks"] + runs["two"]:
        assert r["router"].shape == want.shape
        assert np.abs(r["router"] - want).max() <= tol
