"""The port's Anakin learner (kubeflow_tpu_torch/rl/anakin.py) against the
JAX learner at f32: the network on JAX params (`interop.from_jax_tree`),
GAE, `ppo_loss` and its gradient against `jax.value_and_grad` (clipped
and A2C), one update's clip and Adam against `optax.chain(
clip_by_global_norm, adam)`, and the whole learner for 3 updates with the
JAX learner's own draws injected through `draws` (the Gumbel noise of
`jax.random.categorical` and the uniforms of the env resets, rebuilt from
the JAX key schedule). Action ties: the Gumbel noise is continuous, so an
exact tie has probability zero (both argmaxes take the first index); a
near tie that f32 rounding flips would change the trajectory and fail the
params check outright, not within a tolerance. Then the port's own
draws: bit-for-bit determinism, `should_stop` on every update, the
one-card mesh, and the JAX package's committed GridWorld point."""

import unittest.mock as mock

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from kubeflow_tpu.rl import anakin as janakin
from kubeflow_tpu.rl.config import AnakinConfig as JConfig
from kubeflow_tpu_torch.models import interop
from kubeflow_tpu_torch.rl import anakin as tanakin
from kubeflow_tpu_torch.rl import envs as tenvs
from kubeflow_tpu_torch.rl.config import REWARD_METRIC, AnakinConfig

torch.set_num_threads(2)

ATOL = 1e-5      # f32 losses, grads and params after a few updates
HIDDEN = (16, 16)


def _to_torch(tree, obs_dim=4, hidden=HIDDEN, actions=2):
    return interop.from_jax_tree(
        jax.tree.map(np.asarray, tree),
        tanakin.abstract_net(obs_dim, hidden, actions), device="cpu")


def _flat(tree, pre=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], f"{pre}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _flat(v, f"{pre}/{i}")
    else:
        yield pre, np.asarray(tree.detach() if hasattr(tree, "detach")
                              else tree)


def _assert_trees_close(jtree, ttree, atol=ATOL):
    a, b = list(_flat(jtree)), list(_flat(ttree))
    assert [n for n, _ in a] == [n for n, _ in b]
    for (name, x), (_, y) in zip(a, b):
        np.testing.assert_allclose(y, x, atol=atol, rtol=0, err_msg=name)


@pytest.fixture(scope="module")
def jparams():
    return janakin.init_net(jax.random.key(0), 4, HIDDEN, 2)


def _batch(n=64, seed=0):
    rng = np.random.default_rng(seed)
    return {"obs": rng.normal(size=(n, 4)).astype(np.float32),
            "action": rng.integers(0, 2, n).astype(np.int32),
            "logp": np.log(rng.uniform(0.3, 0.7, n)).astype(np.float32),
            "advantage": rng.normal(size=n).astype(np.float32),
            "return": rng.normal(size=n).astype(np.float32)}


def _tbatch(b):
    return {k: torch.from_numpy(v.copy()).long() if k == "action"
            else torch.from_numpy(v.copy()) for k, v in b.items()}


def test_net_apply_on_jax_params(jparams):
    obs = np.random.default_rng(1).normal(size=(5, 7, 4)).astype(np.float32)
    jl, jv = janakin.net_apply(jparams, jnp.asarray(obs))
    tl, tv = tanakin.net_apply(_to_torch(jparams), torch.from_numpy(obs))
    assert tl.shape == (5, 7, 2) and tv.shape == (5, 7)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=ATOL)
    assert [tuple(p.shape) for _, p in _flat(_to_torch(jparams))] == [
        tuple(np.shape(p)) for _, p in _flat(jparams)]


def test_gae_with_dones_and_bootstrap_matches_jax():
    rng = np.random.default_rng(2)
    t, n = 9, 6
    r = rng.normal(size=(t, n)).astype(np.float32)
    d = rng.uniform(size=(t, n)) < 0.25
    v = rng.normal(size=(t, n)).astype(np.float32)
    last = rng.normal(size=n).astype(np.float32)
    ja, jr = janakin.gae_advantages(jnp.asarray(r), jnp.asarray(d),
                                    jnp.asarray(v), jnp.asarray(last),
                                    0.97, 0.9)
    ta, tr = tanakin.gae_advantages(*(torch.from_numpy(x) for x in
                                      (r, d, v, last)), 0.97, 0.9)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=ATOL)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=ATOL)
    # an unterminated single step bootstraps from last_value
    one, _ = tanakin.gae_advantages(torch.ones(1, 1), torch.zeros(1, 1),
                                    torch.zeros(1, 1), torch.full((1,), 2.0),
                                    0.5, 1.0)
    assert one.item() == 2.0


@pytest.mark.parametrize("clip_eps", [0.2, None], ids=["ppo", "a2c"])
def test_ppo_loss_and_grad_match_jax(jparams, clip_eps):
    b = _batch()
    kw = dict(clip_eps=clip_eps, entropy_coef=0.01, value_coef=0.5)
    (jloss, jaux), jgrad = jax.value_and_grad(janakin.ppo_loss,
                                              has_aux=True)(
        jparams, {k: jnp.asarray(v) for k, v in b.items()}, **kw)
    tp = _to_torch(jparams)
    leaves = tanakin.net_leaves(tp)
    for p in leaves:
        p.requires_grad_(True)
    tloss, taux = tanakin.ppo_loss(tp, _tbatch(b), **kw)
    tgrad = torch.autograd.grad(tloss, leaves)
    assert abs(tloss.item() - float(jloss)) <= ATOL
    for k in ("pg_loss", "value_loss", "entropy"):
        assert abs(taux[k].item() - float(jaux[k])) <= ATOL, k
    gtree = {"torso": [{"w": tgrad[2 * i], "b": tgrad[2 * i + 1]}
                       for i in range(len(HIDDEN))],
             "policy": {"w": tgrad[-4], "b": tgrad[-3]},
             "value": {"w": tgrad[-2], "b": tgrad[-1]}}
    _assert_trees_close(jgrad, gtree)


def test_one_update_matches_optax(jparams):
    """Two epochs on one fixed trajectory: the port's clip and Adam (the
    count a device tensor) against optax.chain(clip_by_global_norm, adam)
    at f32, with the clip binding (max_grad_norm under the grad norm)."""
    b = _batch(seed=4)
    cfg = AnakinConfig(env="cartpole", hidden=HIDDEN, max_grad_norm=0.05,
                       learning_rate=3e-3)
    tx = optax.chain(optax.clip_by_global_norm(0.05), optax.adam(3e-3))
    kw = dict(clip_eps=0.2, entropy_coef=0.01, value_coef=0.5)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    p, opt = jparams, tx.init(jparams)
    learner = tanakin.AnakinLearner(cfg, device="cpu")
    tstate = learner.init(0)
    tp = _to_torch(jparams)
    leaves = tanakin.net_leaves(tp)
    for x in leaves:
        x.requires_grad_(True)
    topt = tstate["opt_state"]
    for _ in range(2):
        grads = jax.grad(lambda q: janakin.ppo_loss(q, jb, **kw)[0])(p)
        assert float(optax.global_norm(grads)) > 0.05
        upd, opt = tx.update(grads, opt, p)
        p = optax.apply_updates(p, upd)
        tloss, _ = tanakin.ppo_loss(tp, _tbatch(b), **kw)
        learner._apply_updates(leaves, list(torch.autograd.grad(
            tloss, leaves)), topt)
    _assert_trees_close(p, tp)
    assert topt["count"].dtype == torch.int32 and int(topt["count"]) == 2
    jmu = opt[1][0].mu
    _assert_trees_close(jmu, {"torso": [
        {"w": topt["mu"][2 * i], "b": topt["mu"][2 * i + 1]}
        for i in range(len(HIDDEN))],
        "policy": {"w": topt["mu"][-4], "b": topt["mu"][-3]},
        "value": {"w": topt["mu"][-2], "b": topt["mu"][-1]}})


def _jax_draws(key, updates, t, n, actions=2):
    """The JAX learner's draws, update by update and step by step: its
    key split, each step's categorical Gumbel noise and each env's reset
    uniforms."""
    out = []
    for _ in range(updates):
        key, k_roll = jax.random.split(key)
        per = []
        for k in jax.random.split(k_roll, t):
            k_act, k_env = jax.random.split(k)
            g = np.array(jax.random.gumbel(k_act, (n, actions)))
            u = np.array(jax.vmap(lambda kk: jax.random.uniform(kk, (4,)))(
                jax.random.split(k_env, n)))
            per.append((torch.from_numpy(g), torch.from_numpy(u)))
        out.append(per)
    return out


def test_learner_with_jax_draws_matches_jax():
    """Three updates of CartPole (max_steps 10, so episodes end and reset
    from injected uniforms) from the JAX init: metrics and params within
    ATOL of the JAX learner's, episode counts exact."""
    kw = dict(env="cartpole", env_kwargs={"max_steps": 10}, n_envs=16,
              rollout_len=8, hidden=HIDDEN, learning_rate=5e-3, seed=0)
    jl = janakin.AnakinLearner(JConfig(**kw))
    js = jl.init(0)
    draws = _jax_draws(js["key"], 3, 8, 16)
    tl = tanakin.AnakinLearner(AnakinConfig(**kw), device="cpu",
                               draws=lambda up, t, seed: draws[int(up)][t])
    ts = tl.init(0)
    ts["params"] = _to_torch(js["params"])
    ts["env_state"] = tenvs.CartPoleState(
        *(torch.from_numpy(np.array(x)) for x in js["env_state"]))
    ts["obs"] = torch.from_numpy(np.array(js["obs"]))
    episodes = []
    for _ in range(3):
        js, jm = jl.step(js)
        ts, tm = tl.step(ts)
        assert set(tm) == set(jm)
        for k in jm:
            assert abs(float(tm[k]) - float(jm[k])) <= ATOL * max(
                1.0, abs(float(jm[k]))), k
        assert int(tm["episodes"]) == int(jm["episodes"])
        episodes.append(int(tm["episodes"]))
    assert episodes[1] > 0
    _assert_trees_close(js["params"], ts["params"])
    np.testing.assert_allclose(ts["obs"].numpy(), np.asarray(js["obs"]),
                               atol=ATOL)
    assert int(ts["update"]) == 3


def _tiny(**kw):
    base = dict(env="gridworld", env_kwargs={"size": 4, "max_steps": 24},
                n_envs=16, rollout_len=8, hidden=HIDDEN, learning_rate=5e-3,
                seed=0)
    base.update(kw)
    return AnakinConfig(**base)


def test_seeded_determinism_bitwise():
    """The same seed gives the same params bit for bit (two learners);
    another seed changes the trajectory."""
    runs = []
    for seed in (0, 0, 1):
        learner = tanakin.AnakinLearner(_tiny(env="cartpole",
                                              env_kwargs={}), device="cpu")
        state, hist = learner.train(learner.init(seed), 5, log_every=5)
        runs.append([p.detach().clone() for p in
                     tanakin.net_leaves(state["params"])])
    assert all(torch.equal(a, b) for a, b in zip(runs[0], runs[1]))
    assert not all(torch.equal(a, b) for a, b in zip(runs[0], runs[2]))


def test_should_stop_consulted_every_update():
    learner = tanakin.AnakinLearner(_tiny(), device="cpu")
    calls = []

    def stop():
        calls.append(1)
        return len(calls) >= 3

    state, _ = learner.train(learner.init(0), 100, log_every=50,
                             should_stop=stop)
    assert len(calls) == 3 and int(state["update"]) == 2


def test_metrics_accounting_and_a2c():
    learner = tanakin.AnakinLearner(_tiny(), device="cpu")
    state, metrics = learner.step(learner.init(0))
    assert set(metrics) >= {REWARD_METRIC, "rollout_reward", "loss",
                            "entropy", "episodes"}
    assert int(state["update"]) == 1
    _, hist = learner.train(state, 4, log_every=4)
    assert hist[-1]["episodes"] > 0 and np.isfinite(hist[-1][REWARD_METRIC])
    assert hist[-1]["update"] == 4
    assert learner.env_steps_per_update() == 16 * 8
    a2c = tanakin.AnakinLearner(_tiny(clip_eps=None, ppo_epochs=4),
                                device="cpu")
    assert a2c.cfg.ppo_epochs == 1
    _, m = a2c.step(a2c.init(0))
    assert np.isfinite(float(m["loss"]))


def test_one_card_mesh_and_the_device_default():
    """{"data": -1} (the RLJob example's mesh) is one card without a
    process group; data 2 needs one (the learner's `mesh=`); another
    axis of 2 is refused naming A6, as the JAX divisibility check refuses
    what it cannot lay out; cuda, the default, raises without a GPU."""
    learner = tanakin.AnakinLearner(_tiny(n_envs=32, mesh={"data": -1}),
                                    device="cpu")
    _, m = learner.step(learner.init(0))
    assert np.isfinite(float(m["loss"]))
    with pytest.raises(ValueError, match="process group"):
        tanakin.AnakinLearner(_tiny(mesh={"data": 2}), device="cpu")
    with pytest.raises(ValueError, match="A6"):
        _tiny(mesh={"fsdp": 2})
    with pytest.raises(ValueError, match="unknown mesh axis"):
        _tiny(mesh={"rows": 1})
    with mock.patch.object(torch.cuda, "is_available", lambda: False):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tanakin.AnakinLearner(_tiny())


def test_committed_gridworld_threshold():
    """The JAX package's committed CPU point, as written: 4x4 GridWorld,
    32 envs x 16 steps, hidden (32, 32), lr 5e-3, seed 0: mean episode
    return >= 0.93 within 60 updates (optimal 0.95)."""
    cfg = AnakinConfig(env="gridworld",
                       env_kwargs={"size": 4, "max_steps": 24},
                       n_envs=32, rollout_len=16, hidden=(32, 32),
                       learning_rate=5e-3, seed=0)
    learner = tanakin.AnakinLearner(cfg, device="cpu")
    _, hist = learner.train(learner.init(0), 60, log_every=60)
    assert hist[-1][REWARD_METRIC] >= 0.93, hist
