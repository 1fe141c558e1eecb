"""The port's RL learner as a pod target and its packing record, on the
unchanged JAX control plane: an RLJob whose learner runs the dotted
target `kubeflow_tpu_torch.rl.job:rl_learner_target` on the CPU
(KTPU_TORCH_DEVICE=cpu) reaches Succeeded with LEARNER_METRICS at every
logged update; a bad config fails at admission; a cancel exits 143; a
two-trial cut of examples/rl-katib-experiment.yaml runs the port's
target, its observations from the metrics file; and the port's
`InterferenceRecord.to_json` teaches the JAX `PackingPolicy` what the JAX
record with the same numbers does."""

import json
import threading
import uuid

import pytest
import yaml

from kubeflow_tpu import hpo
from kubeflow_tpu.control import Cluster, add_training_controllers, new_resource
from kubeflow_tpu.control.conditions import (JobConditionType, has_condition,
                                             is_finished)
from kubeflow_tpu.control.scheduler import PackingPolicy
from kubeflow_tpu.rl import RL_JOB_KIND, RLJobController
from kubeflow_tpu.rl import packing as jpacking
from kubeflow_tpu_torch.rl import config as tconfig
from kubeflow_tpu_torch.rl import job as tjob
from kubeflow_tpu_torch.rl import packing as tpacking
from kubeflow_tpu_torch.training.metrics_writer import read_metrics

TARGET = "kubeflow_tpu_torch.rl.job:rl_learner_target"
TINY = {"env": "gridworld", "env_kwargs": {"size": 3, "max_steps": 12},
        "n_envs": 8, "rollout_len": 4, "hidden": [8, 8],
        "learning_rate": 5e-3, "num_updates": 6, "log_every": 3}


def rl_job(name, config=None, **env):
    return new_resource(RL_JOB_KIND, name, spec={
        "replicaSpecs": {"learner": {
            "replicas": 1, "restartPolicy": "Never",
            "template": {
                "backend": "thread", "target": TARGET,
                "env": {"KTPU_RL_CONFIG": json.dumps(config or TINY),
                        tjob.DEVICE_ENV: "cpu", **env},
                "resources": {"cpu": 1}},
        }},
    })


def test_rl_job_runs_the_port_target_to_succeeded(tmp_path):
    mfile = str(tmp_path / "rl.jsonl")
    c = Cluster(n_devices=2)
    add_training_controllers(c)
    with c:
        c.store.create(rl_job("anakin-port", KTPU_METRICS_FILE=mfile))
        done = c.wait_for(RL_JOB_KIND, "anakin-port",
                          lambda o: is_finished(o["status"]), timeout=120)
    assert has_condition(done["status"], JobConditionType.SUCCEEDED), \
        done["status"]
    recs = read_metrics(mfile)
    assert [r["step"] for r in recs] == [3, 6]
    for r in recs:
        assert set(tconfig.LEARNER_METRICS) <= set(r["metrics"])


def test_invalid_config_fails_at_admission():
    """The JAX controller's admission refuses the spec before the port's
    target runs (the port's parse refuses it the same way)."""
    bad = rl_job("bad", config=dict(TINY, nope=1))
    assert any("unknown rl config keys" in e
               for e in RLJobController.validate(bad))
    with pytest.raises(ValueError, match="unknown rl config keys"):
        tconfig.parse_rl_config(dict(TINY, nope=1))
    c = Cluster(n_devices=2)
    c.add(RLJobController)
    with c:
        c.store.create(bad)
        done = c.wait_for(RL_JOB_KIND, "bad",
                          lambda o: is_finished(o["status"]), timeout=30)
    assert has_condition(done["status"], JobConditionType.FAILED)
    assert "unknown rl config keys" in \
        done["status"]["conditions"][-1]["message"]


def test_cancel_exits_143_and_cuda_default_raises(tmp_path):
    """A set cancel event stops the target before its first update with
    SystemExit(143); without KTPU_TORCH_DEVICE the target asks for cuda,
    which raises without a GPU."""
    env = {"KTPU_RL_CONFIG": json.dumps(TINY), tjob.DEVICE_ENV: "cpu",
           "KTPU_METRICS_FILE": str(tmp_path / "m.jsonl")}
    cancel = threading.Event()
    cancel.set()
    with pytest.raises(SystemExit) as e:
        tjob.rl_learner_target(env, cancel)
    assert e.value.code == 143
    assert read_metrics(env["KTPU_METRICS_FILE"]) == []
    import unittest.mock as mock

    import torch

    with mock.patch.object(torch.cuda, "is_available", lambda: False):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tjob.rl_learner_target({"KTPU_RL_CONFIG": json.dumps(TINY)},
                                   threading.Event())


def test_example_config_parses_as_jax_parses_it():
    """examples/rl-anakin-jaxjob.yaml's config: the same AnakinConfig in
    both packages, and chip_smoke (r)'s R_JOB key for key."""
    with open("examples/rl-anakin-jaxjob.yaml") as f:
        job = yaml.safe_load(f)
    raw = job["spec"]["replicaSpecs"]["learner"]["template"]["env"][
        "KTPU_RL_CONFIG"]
    from kubeflow_tpu.rl.config import parse_rl_config

    (jc, jn, jl), (tc, tn, tl) = parse_rl_config(raw), \
        tconfig.parse_rl_config(raw)
    assert (jn, jl) == (tn, tl) and jc.to_json() == tc.to_json()
    assert (tc.n_envs, tc.rollout_len, tc.mesh) == (2048, 64, {"data": -1})
    import chip_smoke   # (r) runs this config as written

    assert chip_smoke.R_JOB == json.loads(raw)


def test_katib_experiment_runs_port_trials(tmp_path):
    """examples/rl-katib-experiment.yaml (its lr, ent and clip sweep) cut
    to two trials of 6 updates on a tiny GridWorld, each trial the port's
    target: the experiment
    succeeds and its optimum's objective is a mean_episode_return a trial
    wrote to its metrics file."""
    with open("examples/rl-katib-experiment.yaml") as f:
        spec = yaml.safe_load(f)["spec"]
    template = spec["trialTemplate"]["spec"]["replicaSpecs"]["learner"][
        "template"]
    raw = template["env"]["KTPU_RL_CONFIG"]
    cut = raw
    for old, new in (
            ('"env": "cartpole", "n_envs": 1024, "rollout_len": 32',
             '"env": "gridworld", "env_kwargs": {"size": 3, '
             '"max_steps": 12}, "n_envs": 8, "rollout_len": 4'),
            ('"hidden": [64, 64]', '"hidden": [8, 8]'),
            ('"num_updates": 200, "log_every": 20',
             '"num_updates": 6, "log_every": 3')):
        assert old in cut, old
        cut = cut.replace(old, new)
    template["target"] = TARGET
    template["env"] = {"KTPU_RL_CONFIG": cut, tjob.DEVICE_ENV: "cpu"}
    spec.update(maxTrialCount=2, parallelTrialCount=2)
    name = f"rl-port-{uuid.uuid4().hex[:8]}"
    c = Cluster(n_devices=2)
    add_training_controllers(c)
    hpo.add_hpo_controllers(c, metrics_dir=str(tmp_path))
    try:
        with c:
            c.store.create(new_resource("Experiment", name, spec=spec))
            done = c.wait_for("Experiment", name,
                              lambda o: is_finished(o["status"]),
                              timeout=180)
    finally:
        hpo.set_default_db(None)
    assert has_condition(done["status"], JobConditionType.SUCCEEDED), \
        done["status"]
    assert done["status"]["trials"]["succeeded"] == 2
    files = sorted(tmp_path.rglob("*.jsonl"))
    assert len(files) == 2
    rets = [r["metrics"][tconfig.REWARD_METRIC] for f in files
            for r in read_metrics(str(f))]
    opt = done["status"]["currentOptimalTrial"]
    assert opt["objectiveValue"] == pytest.approx(max(rets), abs=1e-4)


RECORDS = [(100.0, 100.0, 80.0, 60.0), (100.0, 100.0, 50.0, 50.0),
           (100.0, 100.0, 100.0, 10.0), (0.0, 100.0, 1.0, 1.0),
           (123456.789, 987.654, 98765.4321, 543.21)]


@pytest.mark.parametrize("nums", RECORDS)
def test_packing_record_teaches_the_jax_policy(nums):
    rec = ("rl-learner", "llm-serving", *nums)
    kw = dict(unit_a="env_steps/s", unit_b="tok/s")
    tj = tpacking.InterferenceRecord(*rec, **kw).to_json()
    jj = jpacking.InterferenceRecord(*rec, **kw).to_json()
    assert tj == jj
    pt, pj = PackingPolicy(), PackingPolicy()
    assert pt.learn("rl-learner", "llm-serving", tj).to_json() == \
        pj.learn("rl-learner", "llm-serving", jj).to_json()
    assert pt.allows("rl-learner", ["llm-serving"]) == \
        pj.allows("rl-learner", ["llm-serving"])


def test_measure_interference_counts_chunks(monkeypatch):
    """Two workloads on a fake clock: solo rates near their chunk rates,
    packed rates positive, the record's keys the JAX record's. The
    module's `time` is a clock that only a chunk advances (by 0.01 and
    0.02 s), one per thread, so the rates are exact whatever the load:
    the barrier and the rest of the process keep real time."""
    import types

    clock = threading.local()

    def now():
        return getattr(clock, "t", 0.0)

    monkeypatch.setattr(tpacking, "time",
                        types.SimpleNamespace(perf_counter=now))

    def work(dt, units):
        def chunk():
            clock.t = now() + dt
            return units
        return chunk

    rec = tpacking.measure_interference("a", work(0.01, 2.0), "b",
                                        work(0.02, 3.0), seconds=0.3)
    assert 100 <= rec.solo_a <= 210 and 75 <= rec.solo_b <= 155
    assert rec.packed_a > 0 and rec.packed_b > 0
    assert set(rec.to_json()) == set(jpacking.InterferenceRecord(
        "a", "b", 1, 1, 1, 1).to_json())
