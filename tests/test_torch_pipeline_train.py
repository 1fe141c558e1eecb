"""The port's GPipe training schedule (parallel/pipeline.py `gpipe`,
`microbatch`, `pipelined_llama_loss`) and the Trainer on a `stage` axis,
on 4 gloo ranks (tests/torch_ranks.py, case `pipe4`) against the JAX
package on its virtual CPU devices: the raw runner of
tests/test_pipeline_parallel.py (4 stages, 6 microbatches of tanh(h @ w))
and its gradients against the chained product's autograd; the Llama
Trainer at that file's config (vocab 256, d_model 64, 4 layers, f32, no
remat, B=8 x S=32) on {stage: 4} at pipeline_microbatches 0 and 4
against the JAX Trainer on the same mesh: both steps' loss and grad
norm and each stage's blocks after step 2; LoRA and BERT (its layer
blocks at rest over `stage`, gathered for compute) on {data: 2, stage:
2} against the JAX Trainer on one device; the rank's rows that a
microbatch count does not divide. In this process: `microbatch` against
JAX's, the schedule on one stage against `llama.loss_fn` under each
remat policy, and the refusals the axis once met."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kubeflow_tpu.models import registry as jregistry
from kubeflow_tpu.parallel import MeshConfig
from kubeflow_tpu.parallel import pipeline as jpipeline
from kubeflow_tpu.training import data as jdata
from kubeflow_tpu.training import trainer as jtrainer
from kubeflow_tpu_torch.models import llama as tllama
from kubeflow_tpu_torch.parallel import pipeline as tpipeline
from kubeflow_tpu_torch.parallel import sharding as tsharding
from kubeflow_tpu_torch.training import trainer as ttrainer
from kubeflow_tpu_torch.training.metrics_writer import MetricsWriter

import torch_ranks

torch.set_num_threads(2)

# tests/test_pipeline_parallel.py's model
TINY = dict(vocab_size=256, d_model=64, n_layers=4, n_heads=8, n_kv_heads=4,
            d_ff=128, max_seq_len=64, remat=False)
BERT = dict(vocab_size=512, d_model=64, n_layers=2, n_heads=8, d_ff=128,
            max_seq_len=64)
# lr 1e-2 so that step 2's update (step 1 has lr 0 in warmup) moves the
# blocks well past the tolerance
OPT = dict(learning_rate=1e-2, warmup_steps=1, total_steps=10)
B, S = 8, 32
# tests/test_pipeline_parallel.py's tolerance
TOL = 2e-4


def _batches():
    return [{"tokens": np.asarray(jax.random.randint(
        jax.random.key(11 + i), (B, S), 0, 256, jnp.int32))}
        for i in range(2)]


def _jax_init(model, overrides, batch, mesh, n_dev, **opt):
    """The JAX Trainer and its initial state (LoRA's b drawn nonzero)."""
    cfg = jtrainer.TrainerConfig(
        model=model, model_overrides=overrides, batch_size=batch,
        optimizer=jtrainer.OptimizerConfig(**OPT, **opt), mesh=mesh, seed=0)
    jt = jtrainer.Trainer(cfg, devices=jax.devices()[:n_dev],
                          metrics=MetricsWriter(echo=False))
    state = jt.init_state()
    if model == "llama_lora":
        # LoRA's b = 0 would leave each a without a gradient at step 1
        rng = np.random.default_rng(5)
        params = dict(state["params"], lora={
            t: {"a": ab["a"], "b": jnp.asarray(rng.normal(
                size=ab["b"].shape).astype(np.float32) * 0.05)}
            for t, ab in state["params"]["lora"].items()})
        state = dict(state, params=jax.device_put(params,
                                                  jt.param_sharding))
    return jt, state


def _leaves(tree):
    return [np.array(x) for x in jax.tree.leaves(tree)]


def _jax_steps(jt, state, batches):
    """The two-step log and the final params."""
    step, log = None, []
    for b in batches:
        b = jt.shard_batch(b)
        step = step or jt.compiled_step(state, b)
        state, m = step(state, b)
        log.append({k: float(v) for k, v in jax.device_get(m).items()})
    return {"log": log, "final": _leaves(state["params"])}


def _config(model, overrides, batch, **opt):
    return dict(model=model, model_overrides=overrides, batch_size=batch,
                optimizer=ttrainer.OptimizerConfig(**OPT, **opt), seed=0)


def _jax_gpipe(ws, x):
    """tests/test_pipeline_parallel.py's raw runner on 4 devices."""
    from jax.sharding import PartitionSpec as P

    from kubeflow_tpu.parallel import make_mesh

    mesh = make_mesh(MeshConfig(stage=4), devices=jax.devices()[:4])

    def body(ws, x):
        out = jpipeline.gpipe(lambda w, h: jnp.tanh(h @ w[0]), ws, x)
        return jax.lax.psum(out * (jax.lax.axis_index("stage") == 3),
                            "stage")
    return np.asarray(jax.shard_map(body, mesh=mesh,
                                    in_specs=(P("stage"), P()),
                                    out_specs=P())(ws, x))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("pipe4"))
    batches = _batches()
    over = dict(TINY, dtype=jnp.float32, attention_impl="xla")
    ws = np.asarray(jax.random.normal(jax.random.key(0), (4, 8, 8)) * 0.3)
    x = np.asarray(jax.random.normal(jax.random.key(1), (6, 2, 8)))
    cot = np.random.default_rng(2).normal(size=x.shape).astype(np.float32)
    bb = [dict(b) for b, _ in zip(jdata.for_model(
        "bert", jregistry.make_config("bert", BERT), 4, 32, 3), range(2))]
    # JAX reads pipeline_microbatches 0 as one microbatch per stage: on
    # {stage: 4} its runs at 0 and at 4 are one program
    jax_runs = {"stage4": _jax_init("llama", over, B, MeshConfig(stage=4),
                                    4)}
    jax_runs["lora"] = _jax_init("llama_lora", dict(rank=2, llama=over), B,
                                 MeshConfig(data=1), 1,
                                 trainable_prefix="lora")
    jax_runs["bert"] = _jax_init("bert", dict(BERT, dtype=jnp.float32), 4,
                                 MeshConfig(data=1), 1)
    tover = dict(TINY, dtype="float32")
    torch_ranks.write_inputs("pipe4", d, {
        "config": _config("llama", tover, B),
        "params": _leaves(jax_runs["stage4"][1]["params"]), "batches": batches,
        "gpipe": {"ws": ws, "x": x, "cot": cot},
        "lora": {"config": _config("llama_lora", dict(rank=2, llama=tover),
                                   B, trainable_prefix="lora"),
                 "params": _leaves(jax_runs["lora"][1]["params"]),
                 "batches": batches},
        "bert": {"config": _config("bert", dict(BERT, dtype="float32"), 4),
                 "params": _leaves(jax_runs["bert"][1]["params"]),
                 "batches": bb}})
    handle = torch_ranks.start("pipe4", 4, d)
    # the JAX steps run while the ranks do
    out = {k: _jax_steps(jt, state, bb if k == "bert" else batches)
           for k, (jt, state) in jax_runs.items()}
    out.update(gpipe=_jax_gpipe(ws, x), ws=ws, x=x, cot=cot,
               ranks=torch_ranks.finish(handle, 180.0))
    return out


def _close(got, want):
    assert len(got) == len(want) == 2
    for x, y in zip(got, want):
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(x[k], y[k], rtol=TOL, atol=TOL,
                                       err_msg=k)


def _stacked(model, overrides) -> list[tuple[str, bool]]:
    """(path, whether its first axis is the stacked layer axis) of each
    leaf, in leaf order."""
    from kubeflow_tpu_torch.models import registry

    m = registry.get(model)
    cfg = m.config_cls(**overrides)
    axes = tsharding.axes_by_path(m.logical_axes(cfg))
    return [(p, axes[p][:1] == ("layers",))
            for p, _ in ttrainer.named_leaves(m.abstract(cfg))]


def _stage_blocks_match(paths, final, port_runs, n_stages):
    """Each rank's block of each leaf equals the JAX leaf at its stage
    coordinate: a stacked leaf's slab of L / n_stages layers, any other
    leaf whole."""
    for r in port_runs:
        s = r["coord"][2]
        for (path, stacked), want, got in zip(paths, final, r["params"]):
            if stacked:
                k = want.shape[0] // n_stages
                want = want[s * k:(s + 1) * k]
            assert got.shape == want.shape, path
            np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL,
                                       err_msg=path)


def test_gpipe_matches_the_jax_runner(runs):
    """The last stage's outputs of 6 microbatches through 4 stages of
    tanh(h @ w) equal the JAX raw runner's within 1e-5."""
    last = [r["gpipe"] for r in runs["ranks"] if r["gpipe"]["stage"] == 3]
    assert len(last) == 1
    np.testing.assert_allclose(last[0]["out"], runs["gpipe"], rtol=1e-5,
                               atol=1e-5)


def test_gpipe_gradients_match_the_chain(runs):
    """The schedule's backward (each microbatch's cotangent received from
    the next stage, its input's gradient sent to the previous one) gives
    each stage's w gradient and stage 0's x gradient of the chained
    product's autograd on one process."""
    ws = torch.from_numpy(runs["ws"]).requires_grad_()
    x = torch.from_numpy(runs["x"]).requires_grad_()
    h = x
    for i in range(4):
        h = torch.tanh(h @ ws[i])
    dws, dx = torch.autograd.grad(h, [ws, x], torch.from_numpy(runs["cot"]))
    for r in runs["ranks"]:
        g = r["gpipe"]
        s = g["stage"]
        np.testing.assert_allclose(g["dw"], dws[s:s + 1].numpy(),
                                   rtol=1e-5, atol=1e-6)
        if s == 0:
            np.testing.assert_allclose(g["dx"], dx.numpy(), rtol=1e-5,
                                       atol=1e-6)
        else:   # x is read on stage 0 alone
            assert g["dx"] is None
        if s != 3:
            assert not g["out"].any()   # zeros off the last stage


def test_microbatch_matches_jax():
    """[B, ...] -> [n, B/n, ...] as JAX's, and the same ValueError."""
    x = np.arange(48, dtype=np.float32).reshape(6, 2, 4)
    for n in (1, 2, 3, 6):
        assert np.array_equal(
            tpipeline.microbatch(torch.from_numpy(x), n).numpy(),
            np.asarray(jpipeline.microbatch(jnp.asarray(x), n)))
    for impl in (lambda: tpipeline.microbatch(torch.from_numpy(x), 4),
                 lambda: jpipeline.microbatch(jnp.asarray(x), 4)):
        with pytest.raises(ValueError, match="not divisible by 4"):
            impl()


@pytest.mark.parametrize("policy", ["none", "minimal", "full"])
def test_one_stage_schedule_matches_loss_fn(policy):
    """Off a mesh the schedule runs one stage: its loss and every
    gradient over two microbatches (packed segments, a loss mask) equal
    `llama.loss_fn`'s under each remat policy (each layer checkpointed
    inside the schedule's graph)."""
    cfg = tllama.LlamaConfig(**dict(TINY, dtype="float32", remat=True,
                                    remat_policy=policy))
    params = tllama.init(cfg, seed=0, device="cpu")
    leaves = ttrainer.leaves(params)
    for t in leaves:
        t.requires_grad_()
    rng = np.random.default_rng(4)
    seg = np.zeros((4, S), np.int32)
    seg[:, 12:] = 1
    batch = {"tokens": torch.from_numpy(rng.integers(0, 256, (4, S))),
             "segment_ids": torch.from_numpy(seg),
             "loss_mask": torch.from_numpy(
                 (rng.random((4, S)) > 0.3).astype(np.float32))}
    want, wm = tllama.loss_fn(params, batch, cfg)
    want_g = torch.autograd.grad(want, leaves)
    got, gm = tpipeline.pipelined_llama_loss(params, batch, cfg, None, 2)
    got_g = torch.autograd.grad(got, leaves)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    assert float(gm["tokens"]) == float(wm["tokens"])
    for a, b in zip(got_g, want_g):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-6)


def test_the_stage_refusals_are_gone():
    """A stage mesh builds a trainer config (here -1, one card; {stage:
    4} on the 4 ranks), a config takes pipeline_microbatches, and a
    stacked leaf split over `stage` is built layer by layer: each
    layer's block on the rank whose slab holds it, none elsewhere."""
    from torch.distributed.tensor import Replicate, Shard

    cfg = ttrainer.TrainerConfig.from_dict({"model": "llama",
                                            "mesh": {"stage": -1}})
    assert cfg.mesh.stage == -1
    assert tllama.LlamaConfig(pipeline_microbatches=4) \
        .pipeline_microbatches == 4

    class Mesh:   # {stage: 4, tensor: 2} at stage 2, tensor 1
        mesh_dim_names = ("stage", "tensor")

        def get_coordinate(self):
            return [2, 1]

        def size(self, i):
            return (4, 2)[i]
    w = torch.arange(48.0).reshape(6, 8)
    place = (Shard(0), Shard(2))   # ("layers", None, "tensor")
    held = [tsharding.local_chunk(w, Mesh(), place, layer, 8)
            for layer in range(8)]
    assert [h is not None for h in held] == [False] * 4 + [True] * 2 + \
        [False] * 2
    assert torch.equal(held[4], w[:, 4:])
    assert torch.equal(tsharding.local_chunk(
        torch.arange(16.0).reshape(8, 2), Mesh(), (Shard(0), Replicate())),
        torch.tensor([[8.0, 9.0], [10.0, 11.0]]))


@pytest.mark.parametrize("m", [0, 4])
def test_stage4_trainer_matches_jax(runs, m):
    """{stage: 4} at pipeline_microbatches m (0: one microbatch per
    stage, as JAX reads it): both steps' loss and grad norm on every
    rank, and each stage's layer slab and whole leaves after step 2,
    against the JAX Trainer on the same mesh (4 microbatches)."""
    jax_run = runs["stage4"]
    port = [r[f"m{m}"] for r in runs["ranks"]]
    for r in port:
        _close(r["log"], jax_run["log"])
    assert sorted(r["coord"][2] for r in port) == [0, 1, 2, 3]
    _stage_blocks_match(_stacked("llama", TINY), jax_run["final"], port, 4)


def test_stage_mesh_configs_build_on_the_ranks(runs):
    """TrainerConfig.from_dict takes {stage: 4} on the 4 ranks, for the
    Llama family and for a family that does not pipeline."""
    for r in runs["ranks"]:
        assert r["configs"] == {"llama": 4, "bert": 4}


def test_rows_that_do_not_divide_raise(runs):
    """The port microbatches the rank's rows: on {data: 2, stage: 2} a
    rank holds 4 of the 8 rows, which 8 microbatches do not divide, so
    the step raises where JAX, which microbatches the global 8 rows,
    runs."""
    for r in runs["ranks"]:
        assert "batch 4 not divisible by 8 microbatches" in r["uneven"]
    jpipeline.microbatch(jnp.zeros((B, S)), 8)


def test_lora_on_data_stage_matches_jax(runs):
    """llama_lora on {data: 2, stage: 2}: the adapters split over
    `stage` with their layers, merged into each stage's slab; both
    steps and every block against the JAX Trainer on one device."""
    port = [r["lora"] for r in runs["ranks"]]
    for r in port:
        _close(r["log"], runs["lora"]["log"])
    _stage_blocks_match(_stacked("llama_lora", dict(rank=2, llama=TINY)),
                        runs["lora"]["final"], port, 2)


def test_bert_blocks_at_rest_over_stage_match_jax(runs):
    """BERT does not pipeline: on {data: 2, stage: 2} its layer blocks
    rest split over `stage` (one of its 2 layers a rank), are gathered
    for compute and keep their blocks of the gradients; both steps and
    every block against the JAX Trainer on one device."""
    port = [r["bert"] for r in runs["ranks"]]
    for r in port:
        _close(r["log"], runs["bert"]["log"])
    _stage_blocks_match(_stacked("bert", BERT), runs["bert"]["final"], port, 2)
