"""The port's Anakin learner with its env batch over `data`
(rl/anakin.py `AnakinLearner(mesh=)`) on two gloo processes
(tests/torch_ranks.py): against the one-rank learner on its own draws
(keyed by the global env index: the same trajectories, the advantages
normalised over the global batch, the PPO terms global means), against
the JAX learner on {data: 2} with the JAX draws injected, and
`rl_learner_target` as two `python -m kubeflow_tpu_torch.rl.job`
processes from the KTPU_* env. Trap (e): draws keyed by a rank's local
env index, or advantages normalised per rank, give another update."""

import json
import os
import sys
import threading

import jax
import numpy as np
import pytest
import torch

from kubeflow_tpu.rl import anakin as janakin
from kubeflow_tpu.rl.config import AnakinConfig as JConfig
from kubeflow_tpu_torch.rl import anakin as tanakin
from kubeflow_tpu_torch.rl import job as tjob
from kubeflow_tpu_torch.rl.config import AnakinConfig
from kubeflow_tpu_torch.training.metrics_writer import read_metrics

import torch_ranks

torch.set_num_threads(2)

ATOL = 1e-5     # f32 params and metrics after three updates
HIDDEN = (16, 16)
OWN = dict(env="cartpole", env_kwargs={"max_steps": 10}, n_envs=16,
           rollout_len=8, hidden=HIDDEN, learning_rate=5e-3, seed=0)
JAX = dict(OWN, mesh={"data": 2})
JOB = {"env": "gridworld", "env_kwargs": {"size": 3, "max_steps": 12},
       "n_envs": 8, "rollout_len": 4, "hidden": [8, 8],
       "learning_rate": 5e-3, "num_updates": 4, "log_every": 2,
       "mesh": {"data": -1}}


def _jax_draws(key, updates, t, n, actions=2):
    """The JAX learner's draws, update by update and step by step (as
    tests/test_torch_rl_anakin.py rebuilds them)."""
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


def _job_env(d, **over):
    return {"KTPU_RL_CONFIG": json.dumps(JOB), "KTPU_TORCH_DEVICE": "cpu",
            "KTPU_METRICS_FILE": os.path.join(d, "rl.jsonl"), **over}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("rl_sharded"))
    jl = janakin.AnakinLearner(JConfig(**JAX))
    js = jl.init(0)
    torch_ranks.write_inputs("rl", d, {
        "own": OWN, "jax": JAX,
        "draws": _jax_draws(js["key"], 3, 8, 16),
        "jax_params": jax.tree.map(np.asarray, js["params"]),
        "jax_env_state": [np.array(x) for x in js["env_state"]],
        "jax_obs": np.array(js["obs"])})
    h1 = torch_ranks.start("rl", 2, d)
    h2 = torch_ranks.start(
        "rljob", 2, d,
        argv=[sys.executable, "-m", "kubeflow_tpu_torch.rl.job"],
        env=lambda r: _job_env(d, KTPU_NUM_PROCESSES="2",
                               KTPU_PROCESS_ID=str(r),
                               KTPU_COORDINATOR_ADDRESS="file://" +
                               os.path.join(d, "pg-rljob")))
    jlog = []
    for _ in range(3):
        js, m = jl.step(js)
        jlog.append({k: float(v) for k, v in m.items()})
    ranks = torch_ranks.finish(h1)
    torch_ranks.finish(h2)
    return dict(d=d, ranks=ranks, js=js, jlog=jlog)


def _jax_leaves(jparams):
    """The JAX param tree's leaves in the port's `net_leaves` order."""
    out = [t for layer in jparams["torso"] for t in (layer["w"], layer["b"])]
    return out + [jparams[h][k] for h in ("policy", "value")
                  for k in ("w", "b")]


def _one_rank(cfg, updates=3):
    learner = tanakin.AnakinLearner(AnakinConfig(**cfg), device="cpu")
    state = learner.init(0)
    first = state["obs"].clone()
    log = []
    for _ in range(updates):
        state, m = learner.step(state)
        log.append({k: float(v) for k, v in m.items()})
    return learner, state, first, log


def test_data2_learner_equals_the_one_rank_learner(runs):
    """Each rank starts from the one-rank learner's envs at its global
    indices, and after three updates both ranks hold the one-rank
    learner's params, with its metrics (the global batch's)."""
    _, state, first, log = _one_rank(OWN)
    want = [p.detach().numpy() for p in tanakin.net_leaves(state["params"])]
    for r in runs["ranks"]:
        rows = slice(8 * r["rank"], 8 * r["rank"] + 8)
        assert np.array_equal(r["first_obs"], first[rows].numpy())
        for a, b in zip(r["own_params"], want):
            np.testing.assert_allclose(a, b, atol=ATOL, rtol=0)
        for got, exp in zip(r["own_log"], log):
            assert got["episodes"] == exp["episodes"]
            for k in exp:
                assert abs(got[k] - exp[k]) <= ATOL * max(1.0, abs(exp[k])), k
    a, b = (r["own_params"] for r in runs["ranks"])
    assert all(np.array_equal(x, y) for x, y in zip(a, b))


def test_data2_learner_with_jax_draws_equals_jax(runs):
    """The JAX learner on {data: 2} with its draws injected: every
    metric, the params and each rank's half of the observations."""
    js = runs["js"]
    want = [np.asarray(x) for x in _jax_leaves(js["params"])]
    for r in runs["ranks"]:
        for got, exp in zip(r["jax_log"], runs["jlog"]):
            assert got["episodes"] == exp["episodes"]
            for k in exp:
                assert abs(got[k] - exp[k]) <= ATOL * max(1.0, abs(exp[k])), k
        for a, b in zip(r["jax_params"], want):
            np.testing.assert_allclose(a, b, atol=ATOL, rtol=0)
        rows = slice(8 * r["rank"], 8 * r["rank"] + 8)
        np.testing.assert_allclose(r["jax_obs"], np.asarray(js["obs"])[rows],
                                   atol=ATOL)
    assert runs["jlog"][1]["episodes"] > 0


def test_local_keys_or_local_normalisation_change_the_update():
    """Trap (e) on one process: a rank's envs drawn by their local
    indices repeat the other rank's trajectories, and normalising the
    advantages of half the envs gives another update than the global
    normalisation."""
    learner = tanakin.AnakinLearner(AnakinConfig(**OWN), device="cpu")
    seed, up = torch.tensor(0), torch.tensor(0)
    whole = tanakin.hash_uniform(seed, up, 0, 16, 6)
    assert torch.equal(tanakin.hash_uniform(seed, up, 0, 8, 6, 8),
                       whole[8:])
    assert not torch.equal(tanakin.hash_uniform(seed, up, 0, 8, 6),
                           whole[8:])
    adv = torch.randn(8, 16, generator=torch.Generator().manual_seed(1))
    adv[:, 8:] += 3.0
    every = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
    half = adv[:, 8:]
    local = (half - half.mean()) / (half.std(correction=0) + 1e-8)
    assert not torch.allclose(local, every[:, 8:], atol=1e-2)
    assert learner.n_local == 16 and learner.first == 0


def test_two_process_rl_learner_target_from_the_env(runs, tmp_path):
    """Two `python -m kubeflow_tpu_torch.rl.job` processes with
    KTPU_NUM_PROCESSES=2 and {"data": -1}: rank 0 writes the metrics at
    the log cadence, equal to the same job in one process."""
    rows = read_metrics(os.path.join(runs["d"], "rl.jsonl"))
    assert [r["step"] for r in rows] == [2, 4]
    one = str(tmp_path)
    tjob.rl_learner_target(_job_env(one), threading.Event())
    want = read_metrics(os.path.join(one, "rl.jsonl"))
    for got, exp in zip(rows, want):
        for k, v in exp["metrics"].items():
            assert abs(got["metrics"][k] - v) <= ATOL * max(1.0, abs(v)), k
