"""The port's Trainer with the GPipe schedule composed with the other
mesh axes, on 8 gloo ranks (tests/torch_ranks.py, case `stage8`)
against the JAX Trainer on one virtual CPU device, as
tests/test_pipeline_parallel.py holds JAX's own compositions: {data: 2,
stage: 2, tensor: 2}, {fsdp: 2, stage: 2, tensor: 2}, {data: 2, stage:
2, fsdp: 2}, {data: 2, stage: 2, sequence: 2} with the ring and with
Ulysses, and packed segment ids with a loss mask on {data: 2, stage: 2,
tensor: 2}: both steps' loss and grad norm at that file's config (vocab
256, d_model 64, 4 layers, f32, no remat, B=8 x S=32). On the same
ranks, `stage_submeshes`' rank layouts against the JAX function's
device ids. On 2 ranks (case `stage2`), a {stage: 2} checkpoint
restored onto one process, whole leaf for whole leaf, and onto the
ranks, block for block."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kubeflow_tpu.parallel import MeshConfig
from kubeflow_tpu.parallel import make_mesh as jmake_mesh
from kubeflow_tpu.parallel.mesh import stage_submeshes as jstage_submeshes
from kubeflow_tpu.training import trainer as jtrainer
from kubeflow_tpu_torch.training import checkpoint as tckpt
from kubeflow_tpu_torch.training import trainer as ttrainer
from kubeflow_tpu_torch.training.metrics_writer import MetricsWriter

import torch_ranks

torch.set_num_threads(2)

# tests/test_pipeline_parallel.py's model
TINY = dict(vocab_size=256, d_model=64, n_layers=4, n_heads=8, n_kv_heads=4,
            d_ff=128, max_seq_len=64, remat=False)
OPT = dict(learning_rate=1e-2, warmup_steps=1, total_steps=10)
B, S = 8, 32
# tests/test_pipeline_parallel.py's tolerance
TOL = 2e-4
COMPOSITIONS = ["dp_pp_tp", "fsdp_pp_tp", "dp_pp_fsdp", "ring", "ulysses"]
SUBMESHES = {"stage2": MeshConfig(stage=2, tensor=2, data=2),
             "stage4": MeshConfig(stage=4, tensor=2)}


def _batches(packed: bool = False):
    """tests/test_pipeline_parallel.py's tokens (two draws), and with
    `packed` its two documents a row and its loss mask."""
    out = []
    for i in range(2):
        b = {"tokens": np.asarray(jax.random.randint(
            jax.random.key(11 + i), (B, S), 0, 256, jnp.int32))}
        if packed:
            b["segment_ids"] = np.concatenate(
                [np.zeros((B, 12), np.int32), np.ones((B, 20), np.int32)],
                axis=1)
            b["loss_mask"] = np.asarray(
                jax.random.uniform(jax.random.key(3), (B, S)) > 0.25
            ).astype(np.float32)
        out.append(b)
    return out


def _jax_log(jt, state, batches):
    step, log = None, []
    for b in batches:
        b = jt.shard_batch(b)
        step = step or jt.compiled_step(state, b)
        state, m = step(state, b)
        log.append({k: float(v) for k, v in jax.device_get(m).items()})
    return log


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("stage8"))

    def one_device():
        jt = jtrainer.Trainer(jtrainer.TrainerConfig(
            model="llama", model_overrides=dict(TINY, dtype=jnp.float32,
                                                attention_impl="xla"),
            batch_size=B, optimizer=jtrainer.OptimizerConfig(**OPT),
            mesh=MeshConfig(data=1), seed=0), devices=jax.devices()[:1],
            metrics=MetricsWriter(echo=False))
        return jt, jt.init_state()
    jt, state = one_device()
    init = [np.array(x) for x in jax.tree.leaves(state["params"])]
    config = dict(model="llama", model_overrides=dict(TINY, dtype="float32"),
                  batch_size=B, optimizer=ttrainer.OptimizerConfig(**OPT),
                  seed=0)
    plain, packed = _batches(), _batches(packed=True)
    torch_ranks.write_inputs("stage8", d, {
        "config": config, "params": init, "batches": plain,
        "packed": packed})
    ckpt = str(tmp_path_factory.mktemp("stage2-ckpt"))
    torch_ranks.write_inputs("stage2", d, {
        "config": config, "params": init, "batches": packed, "dir": ckpt})
    h8 = torch_ranks.start("stage8", 8, d)
    h2 = torch_ranks.start("stage2", 2, d)
    # the JAX steps run while the ranks do
    out = {"plain": _jax_log(jt, state, plain),
           "packed": _jax_log(*one_device(), packed),
           "config": config, "ckpt": ckpt}
    out["ranks"] = torch_ranks.finish(h8, 240.0)
    out["two"] = torch_ranks.finish(h2, 120.0)
    return out


def _close(got, want):
    assert len(got) == len(want) == 2
    for x, y in zip(got, want):
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(x[k], y[k], rtol=TOL, atol=TOL,
                                       err_msg=k)


@pytest.mark.parametrize("key", COMPOSITIONS)
def test_composition_matches_one_device(runs, key):
    """Each composition's two steps on every rank against the JAX
    Trainer on one device; every rank's coordinate is its own."""
    for r in runs["ranks"]:
        _close(r[key]["log"], runs["plain"])
    assert len({r[key]["coord"] for r in runs["ranks"]}) == 8


def test_packed_segments_and_loss_mask(runs):
    """Segment ids ride with each microbatch and the loss mask applies
    in the last stage's tail, on {data: 2, stage: 2, tensor: 2}."""
    for r in runs["ranks"]:
        _close(r["packed"]["log"], runs["packed"])
        assert r["packed"]["log"][0]["tokens"] == float(
            _batches(packed=True)[0]["loss_mask"][:, 1:].sum())


@pytest.mark.parametrize("key", sorted(SUBMESHES))
def test_stage_submeshes_layout_matches_jax(runs, key):
    """Stage s's sub-mesh holds the ranks at stage coordinate s over the
    other axes in their order, as the JAX function's devices (the
    virtual devices' ids are their ranks)."""
    jmesh = jmake_mesh(SUBMESHES[key], devices=jax.devices()[:8])
    want = [(np.vectorize(lambda dv: dv.id)(m.devices).tolist(),
             tuple(m.axis_names)) for m in jstage_submeshes(jmesh)]
    for r in runs["ranks"]:
        assert r["submeshes"][key] == want


def test_stage_submeshes_refuses_a_mesh_without_stage(runs):
    for r in runs["ranks"]:
        assert "no stage axis" in r["no_stage"]
    with pytest.raises(ValueError, match="no stage axis"):
        jstage_submeshes(jax.sharding.Mesh(np.asarray(jax.devices()[:2]),
                                           ("data",)))


def test_stage2_checkpoint_restores_onto_one_process(runs):
    """A {stage: 2} save (each stage's slab gathered into whole leaves
    on rank 0) restores into the one-process trainer's state: params
    and moments equal the ranks' gathered state bit for bit."""
    t = ttrainer.Trainer(ttrainer.TrainerConfig(**runs["config"]),
                         device="cpu")
    mngr = tckpt.CheckpointManager(runs["ckpt"])
    assert mngr.all_steps() == [1, 2]   # orbax's rule: the first, forced
    state = mngr.restore(t.abstract_state(), step=2, device="cpu")
    got = [x.detach().numpy() for x in ttrainer.leaves(
        [state["params"], state["opt_state"]["mu"],
         state["opt_state"]["nu"]])]
    for r in runs["two"]:
        assert len(r["whole"]) == len(got)
        for a, b in zip(r["whole"], got):
            assert np.array_equal(a, b)
    assert state["step"] == 2


def test_stage2_restore_gives_each_rank_its_blocks(runs):
    """restore_or_init on the two stage ranks takes the save, and each
    rank's blocks equal the trained blocks bit for bit: its stage's half
    of every stacked leaf's layers, every other leaf whole."""
    assert sorted(r["coord"][2] for r in runs["two"]) == [0, 1]
    for r in runs["two"]:
        assert r["resumed"]
        for a, b, whole in zip(r["restored"], r["blocks"], r["whole"]):
            assert np.array_equal(a, b)
            if b.shape != whole.shape:
                assert np.array_equal(b, np.split(whole, 2)[r["coord"][2]])
