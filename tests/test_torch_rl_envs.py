"""The port's batched RL envs (kubeflow_tpu_torch/rl/envs.py) and its RL
config (rl/config.py) against the JAX package: CartPole and GridWorld
steps at f32 over seeded random states and actions (the JAX envs vmapped,
the reset noise fed to the port as the same uniforms the JAX keys draw),
auto-reset, the time limit, the walls, the env kwargs map, and the
config's refusals with the JAX messages."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.rl import config as jconfig
from kubeflow_tpu.rl import envs as jenvs
from kubeflow_tpu_torch.rl import config as tconfig
from kubeflow_tpu_torch.rl import envs as tenvs

ATOL = 1e-6   # f32 physics: the two packages' sin/cos/rounding


def _uniforms(key, n, k=4):
    """The [0, 1) floats each env's key draws in the JAX reset, and the
    keys themselves (the JAX step takes the keys)."""
    keys = jax.random.split(key, n)
    u = jax.vmap(lambda kk: jax.random.uniform(kk, (k,)))(keys)
    return keys, torch.from_numpy(np.array(u))


def _cartpole_batch(seed, n, env):
    """Seeded states around and past the fall limits, t near max_steps."""
    rng = np.random.default_rng(seed)
    lim = np.array([3.0, 2.0, 0.3, 2.0], np.float32)
    st = (rng.uniform(-1, 1, (n, 4)) * lim).astype(np.float32)
    t = rng.integers(0, env.max_steps + 1, n).astype(np.int32)
    act = rng.integers(0, 2, n).astype(np.int32)
    return st, t, act


def _compare(jout, tout):
    (js, jobs, jrew, jdone), (ts, tobs, trew, tdone) = jout, tout
    np.testing.assert_array_equal(np.asarray(jdone), tdone.numpy())
    for a, b in zip(jax.tree.leaves(js), list(ts)):
        np.testing.assert_allclose(np.asarray(a), b.numpy(), atol=ATOL,
                                   rtol=0)
        assert np.asarray(a).dtype == b.numpy().dtype
    np.testing.assert_allclose(np.asarray(jobs), tobs.numpy(), atol=ATOL,
                               rtol=0)
    np.testing.assert_array_equal(np.asarray(jrew), trew.numpy())
    assert tobs.dtype == trew.dtype == torch.float32


@pytest.mark.parametrize("seed", [0, 1])
def test_cartpole_step_matches_jax(seed):
    kw = {"max_steps": 30, "force_mag": 12.0} if seed else {}
    je, te = jenvs.CartPole(**kw), tenvs.CartPole(**kw)
    n = 512
    st, t, act = _cartpole_batch(seed, n, je)
    keys, u = _uniforms(jax.random.key(seed + 10), n)
    js = jenvs.CartPoleState(*(jnp.asarray(st[:, i]) for i in range(4)),
                             jnp.asarray(t))
    jout = jax.vmap(je.step)(js, jnp.asarray(act), keys)
    ts = tenvs.CartPoleState(*(torch.from_numpy(st[:, i].copy())
                               for i in range(4)), torch.from_numpy(t))
    tout = te.step(ts, torch.from_numpy(act).long(), u)
    _compare(jout, tout)
    done = tout[3].numpy()
    assert 0 < done.sum() < n   # both branches of the auto-reset ran


def test_gridworld_step_matches_jax():
    je, te = jenvs.GridWorld(size=4, max_steps=9), tenvs.GridWorld(
        size=4, max_steps=9)
    rng = np.random.default_rng(3)
    n = 256
    xy = rng.integers(0, 4, (n, 2)).astype(np.int32)
    t = rng.integers(0, 9, n).astype(np.int32)
    act = rng.integers(0, 4, n).astype(np.int32)
    keys = jax.random.split(jax.random.key(0), n)
    jout = jax.vmap(je.step)(jenvs.GridWorldState(jnp.asarray(xy),
                                                  jnp.asarray(t)),
                             jnp.asarray(act), keys)
    tout = te.step(tenvs.GridWorldState(torch.from_numpy(xy),
                                        torch.from_numpy(t)),
                   torch.from_numpy(act).long(), torch.zeros(n, 0))
    _compare(jout, tout)


def test_cartpole_auto_reset_uses_the_same_uniforms():
    """A pole past the limit: the returned state and obs are the next
    episode's reset from this step's draws (the JAX reset of the same
    key), the terminal reward is kept and done marks the boundary."""
    je, te = jenvs.CartPole(), tenvs.CartPole()
    keys, u = _uniforms(jax.random.key(7), 3)
    st = np.array([[0.0, 0.0, 0.5, 3.0], [2.5, 1.0, 0.0, 0.0],
                   [0.0, 0.0, 0.0, 0.0]], np.float32)
    js = jenvs.CartPoleState(*(jnp.asarray(st[:, i]) for i in range(4)),
                             jnp.zeros(3, jnp.int32))
    ts = tenvs.CartPoleState(*(torch.from_numpy(st[:, i].copy())
                               for i in range(4)),
                             torch.zeros(3, dtype=torch.int32))
    act = np.array([1, 1, 0], np.int32)
    jout = jax.vmap(je.step)(js, jnp.asarray(act), keys)
    tout = te.step(ts, torch.from_numpy(act).long(), u)
    _compare(jout, tout)
    assert tout[3].tolist() == [True, True, False]
    reset_obs = jax.vmap(je.reset)(keys)[1]
    np.testing.assert_allclose(tout[1][:2].numpy(),
                               np.asarray(reset_obs)[:2], atol=ATOL, rtol=0)
    assert tout[0].t.tolist() == [0, 0, 1]
    assert tout[2].tolist() == [1.0, 1.0, 1.0]
    s0, obs0 = te.reset(u)
    np.testing.assert_allclose(obs0.numpy(), np.asarray(reset_obs),
                               atol=ATOL, rtol=0)
    assert obs0.abs().max() <= te.reset_scale


@pytest.mark.parametrize("name", ["cartpole", "gridworld"])
def test_time_limit_ends_the_episode(name):
    """At max_steps the episode ends (done, auto-reset to t=0) in both
    packages, from a state nothing else would end."""
    kw = {"max_steps": 3}
    je, te = jenvs.make_env(name, **kw), tenvs.make_env(name, **kw)
    n = 4
    keys, u = _uniforms(jax.random.key(1), n, te.reset_draws)
    js, _ = jax.vmap(je.reset)(keys)
    ts, _ = te.reset(u)
    act = jnp.zeros(n, jnp.int32) if name == "gridworld" else \
        jnp.asarray([0, 1, 0, 1], jnp.int32)
    dones = []
    for _ in range(3):
        jout = jax.vmap(je.step)(js, act, keys)
        tout = te.step(ts, torch.from_numpy(np.array(act)).long(), u)
        _compare(jout, tout)
        js, ts = jout[0], tout[0]
        dones.append(tout[3].tolist())
    assert dones[:2] == [[False] * n] * 2 and dones[2] == [True] * n
    assert tout[0].t.tolist() == [0] * n


def test_gridworld_walls_and_goal():
    """Walls clip moves; the goal pays goal_reward and resets; a step
    costs step_cost (the JAX env's record)."""
    je, te = jenvs.GridWorld(size=3, max_steps=10), tenvs.GridWorld(
        size=3, max_steps=10)
    xy = np.array([[0, 0], [0, 0], [2, 1], [1, 2], [2, 2]], np.int32)
    act = np.array([2, 3, 1, 0, 0], np.int32)   # left, up: walls; goal x2
    t = np.zeros(5, np.int32)
    keys = jax.random.split(jax.random.key(0), 5)
    jout = jax.vmap(je.step)(jenvs.GridWorldState(jnp.asarray(xy),
                                                  jnp.asarray(t)),
                             jnp.asarray(act), keys)
    tout = te.step(tenvs.GridWorldState(torch.from_numpy(xy),
                                        torch.from_numpy(t)),
                   torch.from_numpy(act).long(), torch.zeros(5, 0))
    _compare(jout, tout)
    assert tout[0].xy[:2].tolist() == [[0, 0], [0, 0]]
    assert tout[3].tolist() == [False, False, True, True, True]
    np.testing.assert_allclose(tout[2].numpy(),
                               np.float32([-0.01, -0.01, 1, 1, 1]))
    assert tout[0].xy[2:].tolist() == [[0, 0]] * 3


def test_env_kwargs_match_jax_and_the_dataclasses():
    assert tconfig.ENV_KWARGS == jconfig.ENV_KWARGS
    assert tconfig.ENV_KWARG_MIN == jconfig.ENV_KWARG_MIN
    assert set(tenvs.ENVS) == set(tconfig.ENV_KWARGS)
    for name, cls in tenvs.ENVS.items():
        assert tconfig.ENV_KWARGS[name] == {
            f.name for f in dataclasses.fields(cls)}, name
        jcls = jenvs.ENVS[name]
        assert dataclasses.asdict(cls()) == dataclasses.asdict(jcls())
        assert (cls.num_actions, cls.obs_dim) == (jcls.num_actions,
                                                  jcls.obs_dim)
    assert tconfig.REWARD_METRIC == jconfig.REWARD_METRIC
    assert tconfig.LEARNER_METRICS == jconfig.LEARNER_METRICS
    with pytest.raises(ValueError, match="unknown env 'pong'"):
        tenvs.make_env("pong")


BAD = [
    {"env": "cartpol"}, {"env": "gridworld", "env_kwargs": {"max_step": 12}},
    {"env": "gridworld", "env_kwargs": {"size": 1}},
    {"env": "cartpole", "env_kwargs": {"max_steps": 0}},
    {"env": "cartpole", "env_kwargs": {"tau": 0.0}},
    {"n_envs": 0}, {"rollout_len": 0}, {"ppo_epochs": 0},
    {"learning_rate": -1.0}, {"gamma": 0.0}, {"gae_lambda": 1.5},
    {"learning_rat": 0.1}, {"log_every": 0}, {"num_updates": 0},
]


def test_config_refusals_carry_the_jax_messages():
    """Every typo and bad value the JAX admission refuses, the port
    refuses with the same message; what JAX accepts (A2C's forced single
    pass, the example's config) the port accepts the same."""
    for bad in BAD:
        msgs = []
        for parse in (jconfig.parse_rl_config, tconfig.parse_rl_config):
            with pytest.raises(ValueError) as e:
                parse(dict(bad))
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1], bad
    good = {"env": "gridworld", "env_kwargs": {"size": 3}, "clip_eps": None,
            "ppo_epochs": 4, "hidden": [8, 8], "num_updates": 7,
            "log_every": 2, "mesh": {"data": -1}}
    (jc, jn, jl), (tc, tn, tl) = (jconfig.parse_rl_config(dict(good)),
                                  tconfig.parse_rl_config(dict(good)))
    assert (jn, jl) == (tn, tl) == (7, 2)
    assert jc.to_json() == tc.to_json()
    assert tc.ppo_epochs == 1 and tc.hidden == (8, 8)
