"""Checkpoints of the port's sharded trainer (training/checkpoint.py) and
`train_target` past one process (training/job.py), on gloo processes
(tests/torch_ranks.py): a {data: 2, fsdp: 2} run saves whole leaves, so
its step-3 checkpoint restores onto one process bit for bit and holds
the files and hashes an unsharded save of the same state writes; a
resumed four-rank run gives the uninterrupted run's losses; ranks
whose directories differ take rank 0's save decisions and its write's
outcome; two processes run a JAXJob's env through `python -m
kubeflow_tpu_torch.training.job` on a file:// store."""

import json
import os
import sys
import threading

import numpy as np
import pytest
import torch

from kubeflow_tpu_torch.training import checkpoint as tckpt
from kubeflow_tpu_torch.training import job as tjob
from kubeflow_tpu_torch.training import trainer as ttrainer
from kubeflow_tpu_torch.training.metrics_writer import (MetricsWriter,
                                                        read_metrics)

import torch_ranks

torch.set_num_threads(2)

TINY = dict(vocab_size=512, d_model=64, n_layers=2, n_heads=8, n_kv_heads=4,
            d_ff=128, max_seq_len=128, rope_theta=10000.0, dtype="float32")
OPT = dict(learning_rate=1e-2, warmup_steps=1, total_steps=10)
B, S = 8, 16


def _config(**over):
    return dict(dict(model="llama", model_overrides=TINY, batch_size=B,
                     optimizer=ttrainer.OptimizerConfig(**OPT), seed=0),
                **over)


def _job_env(d, ckpt, **over):
    cfg = {"model": "llama", "model_overrides": TINY, "batch_size": 4,
           "num_steps": 4, "log_every": 1, "seed": 3,
           "optimizer": dict(OPT), "mesh": {"fsdp": -1},
           "dataset": {"seq_len": S}, "checkpoint_dir": ckpt}
    return {"KTPU_TRAINER_CONFIG": json.dumps(cfg),
            "KTPU_TORCH_DEVICE": "cpu",
            "KTPU_METRICS_FILE": os.path.join(d, "metrics.jsonl"), **over}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("sharded_ckpt"))
    rng = np.random.default_rng(11)
    batches = []
    for _ in range(6):
        mask = np.ones((B, S), np.float32)
        mask[2:4, 9:] = 0.0
        batches.append({"tokens": rng.integers(0, 512, (B, S)).astype(
            np.int32), "loss_mask": mask})
    one = ttrainer.Trainer(ttrainer.TrainerConfig(**_config()),
                           device="cpu")
    params = [t.detach().numpy().copy()
              for t in ttrainer.leaves(one.init_state()["params"])]
    ckpt = os.path.join(d, "ckpt")
    torch_ranks.write_inputs("ckpt", d, {
        "config": _config(), "params": params, "batches": batches,
        "dir": ckpt})
    h1 = torch_ranks.start("ckpt", 4, d)
    job_ckpt = os.path.join(d, "job-ckpt")
    h2 = torch_ranks.start(
        "job", 2, d, argv=[sys.executable, "-m",
                           "kubeflow_tpu_torch.training.job"],
        env=lambda r: _job_env(d, job_ckpt, KTPU_NUM_PROCESSES="2",
                               KTPU_PROCESS_ID=str(r),
                               KTPU_COORDINATOR_ADDRESS="file://" +
                               os.path.join(d, "pg-job")))
    torch_ranks.write_inputs("views", d, {
        "config": _config(), "params": params, "batches": batches[:3],
        "dir": os.path.join(d, "views")})
    h3 = torch_ranks.start("views", 2, d)
    ranks = torch_ranks.finish(h1)
    torch_ranks.finish(h2)
    views = torch_ranks.finish(h3)
    return dict(d=d, ranks=ranks, ckpt=ckpt, job_ckpt=job_ckpt,
                batches=batches, views=views)


def test_sharded_save_restores_onto_one_rank_bit_for_bit(runs, tmp_path):
    """The {data: 2, fsdp: 2} save at step 3 restores into the one-rank
    trainer's state: params and moments equal the ranks' gathered step-3
    state bit for bit; re-saved unsharded, its manifest's files and
    hashes are the sharded save's."""
    t = ttrainer.Trainer(ttrainer.TrainerConfig(**_config()), device="cpu")
    mngr = tckpt.CheckpointManager(runs["ckpt"])
    assert mngr.all_steps() == [1, 3, 6]   # 6 written again by the resume
    state = mngr.restore(t.abstract_state(), step=3, device="cpu")
    got = [x.detach().numpy() for x in ttrainer.leaves(
        [state["params"], state["opt_state"]["mu"],
         state["opt_state"]["nu"]])]
    for r in runs["ranks"]:
        assert len(r["whole3"]) == len(got)
        for a, b in zip(r["whole3"], got):
            assert np.array_equal(a, b)
    assert state["step"] == 3 and state["opt_state"]["count"] == 3
    again = tckpt.CheckpointManager(str(tmp_path / "one"))
    assert again.save(3, state, force=True)

    def manifest(root):
        with open(os.path.join(root, "3", tckpt.MANIFEST_NAME)) as f:
            return json.load(f)["files"]
    assert manifest(str(tmp_path / "one")) == manifest(runs["ckpt"])
    assert tckpt.verify_step(runs["ckpt"], 3) == "intact"


def test_resumed_run_reproduces_the_uninterrupted_losses(runs):
    """restore_or_init on four ranks takes step 3 (rank 0's pick) and the
    resumed steps 4-6 give the uninterrupted run's losses, grad norms and
    params bit for bit."""
    for r in runs["ranks"]:
        assert r["resumed"] and r["start"] == 3
        assert [m["loss"] for m in r["log2"]] == \
            [m["loss"] for m in r["log"][3:]]
        assert [m["grad_norm"] for m in r["log2"]] == \
            [m["grad_norm"] for m in r["log"][3:]]
        for a, b in zip(r["final"], r["final2"]):
            assert np.array_equal(a, b)
    # the losses are the one-rank trainer's on the same batches
    t = ttrainer.Trainer(ttrainer.TrainerConfig(**_config()), device="cpu",
                         metrics=MetricsWriter(echo=False))
    state = t.init_state()
    one = [float(t.train_step(state, t.to_device(b))["loss"])
           for b in runs["batches"]]
    np.testing.assert_allclose([m["loss"] for m in runs["ranks"][0]["log"]],
                               one, rtol=2e-5)


def test_two_process_train_target_from_the_env(runs, tmp_path):
    """Two processes of `python -m kubeflow_tpu_torch.training.job` with
    KTPU_NUM_PROCESSES=2 and the mesh {"fsdp": -1}: rank 0 writes one
    metrics line a step and the checkpoints; the losses are those of the
    same job in one process."""
    rows = read_metrics(os.path.join(runs["d"], "metrics.jsonl"))
    assert [r["step"] for r in rows] == [1, 2, 3, 4]
    assert tckpt.CheckpointManager(runs["job_ckpt"]).all_steps() == [1, 4]
    one = str(tmp_path / "one")
    os.makedirs(one)
    tjob.train_target(_job_env(one, os.path.join(one, "ckpt")),
                      threading.Event())
    want = read_metrics(os.path.join(one, "metrics.jsonl"))
    np.testing.assert_allclose([r["metrics"]["loss"] for r in rows],
                               [r["metrics"]["loss"] for r in want],
                               rtol=2e-5)
    assert [r["metrics"]["tokens"] for r in rows] == \
        [r["metrics"]["tokens"] for r in want]


def test_ranks_take_rank_0s_save_decision_and_outcome(runs):
    """Two ranks, each with its own checkpoint directory, rank 1's
    already holding steps 2 and 3: every save is rank 0's decision, so
    no rank waits in a collective the other skipped. Rank 0 saved 1, 2
    and the final 3; rank 1's directory is as it was. A step rank 0
    holds raises on both ranks; a write that fails on rank 0 (disk
    full) raises there and raises on rank 1 with rank 0's error."""
    r0, r1 = runs["views"]
    assert r0["steps"] == [1, 2, 3] and r1["steps"] == [2, 3]
    for r in (r0, r1):
        assert "already exists" in r["exists"] and r0["dir"] in r["exists"]
    assert r0["failed"].startswith("OSError") and \
        "No space left on device" in r0["failed"]
    assert r1["failed"].startswith("RuntimeError") and \
        "rank 0's write failed: OSError" in r1["failed"]
    assert r0["steps_after"] == [1, 2, 3] and r1["steps_after"] == [2, 3]
