"""The port's `sequence` axis through its Trainer (each rank its columns
of the batch, ring or Ulysses attention across them, the targets by
global position) on 4 gloo ranks (tests/torch_ranks.py, case `seq`)
against the JAX Trainer on the same mesh of virtual CPU devices, with
the config of the JAX package's tests/test_seq_parallel.py (tiny Llama,
f32, no remat) and batches whose loss_mask and segment_ids change inside
a shard and at a shard edge: three steps' losses, tokens and grad norms
and each rank's blocks on {data: 2, sequence: 2} with "ring" and with
"ulysses"; "ring" and "ulysses" on {data: 4} (no sequence axis: the
port's flash attention against JAX's mha); "flash" on {data: 2,
sequence: 2} (the port's ring against JAX's blockwise attention under
GSPMD); Ulysses composed with a tensor split on {sequence: 2, tensor:
2}; ce_chunk with the ring; Mixtral tiny at capacity factor 0.5 (its
routing over every rank's tokens in the global order) and LoRA (b drawn
nonzero) on {data: 2, sequence: 2}; the attention bodies the dispatch
ran; and the refusal of a family outside the Llama family on a sequence
axis (A6b-ii)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kubeflow_tpu.parallel import MeshConfig
from kubeflow_tpu.training import trainer as jtrainer
from kubeflow_tpu_torch.training import trainer as ttrainer
from kubeflow_tpu_torch.training.metrics_writer import MetricsWriter

import torch_ranks

torch.set_num_threads(2)

# tests/test_seq_parallel.py's model
TINY = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=8, n_kv_heads=4,
            d_ff=128, max_seq_len=64, remat=False)
MOE = dict(TINY, d_ff=96, n_experts=4, top_k=2, capacity_factor=0.5)
OPT = dict(learning_rate=1e-2, warmup_steps=1, total_steps=10)
B, S, STEPS = 4, 32, 3
# f32 against XLA on the same mesh: sums in another order
RTOL = 2e-5
# a block after three AdamW steps, relative to its leaf's norm (as in
# tests/test_torch_tensor_parallel.py)
BLOCK_TOL = 1e-4
DS = MeshConfig(data=2, sequence=2)
# each JAX run: (model, attention_impl, mesh)
JAX_RUNS = {"ring": ("llama", "ring", DS),
            "ulysses": ("llama", "ulysses", DS),
            "flash": ("llama", "flash", DS),
            "tensor": ("llama", "ulysses", MeshConfig(sequence=2, tensor=2)),
            "data": ("llama", "ring", MeshConfig(data=4)),
            "mixtral": ("mixtral", "flash", DS),
            "lora": ("llama_lora", "ring", DS)}


def _batches():
    """Tokens, a loss_mask and segment_ids per step: shards of 16 columns;
    row 0's mask is 0 at column 16 (the target of shard 0's last
    position) and its documents change at 20, row 1's mask is 0 over
    10..20 and its documents change at 9 and 16 (on the edge), row 3
    has three documents."""
    rng = np.random.default_rng(3)
    mask = np.ones((B, S), np.float32)
    mask[0, 16] = 0.0
    mask[1, 10:21] = 0.0
    mask[3, ::3] = 0.0
    seg = np.zeros((B, S), np.int32)
    seg[0, 20:] = 1
    seg[1, 9:] = 1
    seg[1, 16:] = 2
    seg[3, 5:] = 1
    seg[3, 27:] = 2
    return [{"tokens": rng.integers(0, 256, (B, S)).astype(np.int32),
             "loss_mask": mask, "segment_ids": seg} for _ in range(STEPS)]


def _overrides(model, dtype, impl="ring"):
    if model == "llama_lora":
        return dict(rank=2, llama=_overrides("llama", dtype, impl))
    return dict(MOE if model == "mixtral" else TINY, dtype=dtype,
                attention_impl=impl)


def _opt(model):
    return dict(OPT, trainable_prefix="lora") if model == "llama_lora" \
        else OPT


def _jax_trainer(model, impl, mesh):
    cfg = jtrainer.TrainerConfig(
        model=model, model_overrides=_overrides(model, jnp.float32, impl),
        batch_size=B, optimizer=jtrainer.OptimizerConfig(**_opt(model)),
        mesh=mesh, seed=0)
    jt = jtrainer.Trainer(cfg, devices=jax.devices()[:4],
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


def _jax_steps(jt, state, batches):
    step, log = None, []
    for b in batches:
        b = jt.shard_batch(b)
        step = step or jt.compiled_step(state, b)
        state, m = step(state, b)
        log.append({k: float(v) for k, v in jax.device_get(m).items()})
    return state, log


def _config(model):
    return dict(model=model, model_overrides=_overrides(model, "float32"),
                batch_size=B, optimizer=ttrainer.OptimizerConfig(
                    **_opt(model)), seed=0)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("seq"))
    batches = _batches()
    jax_runs = {k: _jax_trainer(*JAX_RUNS[k])
                for k in ("ring", "mixtral", "lora")}

    def leaves(key):
        return [np.array(x) for x in jax.tree.leaves(
            jax_runs[key][1]["params"])]
    torch_ranks.write_inputs("seq", d, {
        "config": _config("llama"), "params": leaves("ring"),
        "batches": batches,
        "mixtral": {"config": _config("mixtral"), "params": leaves("mixtral"),
                    "batches": batches},
        "lora": {"config": _config("llama_lora"), "params": leaves("lora"),
                 "batches": batches}})
    handle = torch_ranks.start("seq", 4, d)
    # the JAX trainers build and step while the ranks run
    jax_runs.update((k, _jax_trainer(*v)) for k, v in JAX_RUNS.items()
                    if k not in jax_runs)
    jax_out = {}
    for key, (jt, state) in jax_runs.items():
        state, log = _jax_steps(jt, state, batches)
        jax_out[key] = {"jt": jt, "state": state, "log": log}
    return {"jax": jax_out, "ranks": torch_ranks.finish(handle, 180.0),
            "batches": batches}


def _close(got, want, keys=("loss", "grad_norm", "tokens")):
    assert len(got) == len(want) == STEPS
    for x, y in zip(got, want):
        for k in keys:
            np.testing.assert_allclose(x[k], y[k], rtol=RTOL, err_msg=k)


def _blocks_match(jax_run, port_runs):
    """Each rank's block of each param equals the JAX array's addressable
    shard at the rank's mesh coordinate, within BLOCK_TOL of the leaf's
    norm."""
    jt = jax_run["jt"]
    mesh = jt.mesh
    coords = {mesh.devices[i]: i for i in np.ndindex(mesh.devices.shape)}
    place = jax.tree.leaves(jt.param_sharding,
                            is_leaf=lambda x: hasattr(x, "spec"))
    by_coord = {r["coord"]: r for r in port_runs}
    for i, leaf in enumerate(jax.tree.leaves(jax_run["state"]["params"])):
        tol = BLOCK_TOL * max(float(np.linalg.norm(np.asarray(leaf))), 1e-6)
        for shard in jax.device_put(leaf, place[i]).addressable_shards:
            mine = by_coord[coords[shard.device]]["params"][i]
            assert mine.shape == shard.data.shape, i
            assert np.abs(mine - np.asarray(shard.data)).max() <= tol, i


def _check(runs, key, jax_key=None, bodies=None):
    jax_run = runs["jax"][jax_key or key]
    for r in runs["ranks"]:
        _close(r[key]["log"], jax_run["log"])
        if bodies is not None:   # each layer's forward, every step
            want = dict.fromkeys(("flash", "ring", "ulysses"), 0)
            want[bodies] = STEPS * TINY["n_layers"]
            assert r[key]["bodies"] == want, key
    _blocks_match(jax_run, [r[key] for r in runs["ranks"]])


@pytest.mark.parametrize("impl", ["ring", "ulysses"])
def test_data_sequence_matches_jax(runs, impl):
    """{data: 2, sequence: 2}: losses, global token counts (the masked
    targets by global position, a shard's last column taking the next
    shard's first token) and grad norms on every rank, and each rank's
    blocks, against the JAX trainer on the same mesh."""
    counts = [float(b["loss_mask"][:, 1:].sum()) for b in runs["batches"]]
    for r in runs["ranks"]:
        assert [x["tokens"] for x in r[impl]["log"]] == counts
    _check(runs, impl, bodies=impl)


@pytest.mark.parametrize("impl", ["ring", "ulysses"])
def test_no_sequence_axis_runs_flash(runs, impl):
    """ring/ulysses on {data: 4}: the port's flash attention against the
    JAX trainer's mha on the same mesh."""
    _check(runs, f"{impl}_data", "data", bodies="flash")


def test_flash_on_a_sequence_mesh_runs_the_ring(runs):
    """"flash" on {data: 2, sequence: 2}: the port runs the ring; JAX its
    blockwise attention under GSPMD."""
    _check(runs, "flash", bodies="ring")


def test_ulysses_composes_with_tensor(runs):
    """{sequence: 2, tensor: 2}: Ulysses on each tensor rank's 4 heads."""
    _check(runs, "tensor", bodies="ulysses")


def test_ce_chunk_on_sequence_shards(runs):
    """ce_chunk 4 divides a shard's 16 columns; the chunked loss over the
    shards' targets gives the unchunked JAX run's numbers."""
    _check(runs, "chunk", "ring", bodies="ring")


def test_mixtral_on_data_sequence_matches_jax(runs):
    """Mixtral at capacity factor 0.5 on {data: 2, sequence: 2}: the
    routing's capacity and slots over every rank's tokens in the global
    [B, S] order, the aux loss over all of them."""
    jax_run = runs["jax"]["mixtral"]
    for r in runs["ranks"]:
        _close(r["mixtral"]["log"], jax_run["log"],
               keys=("loss", "aux_loss", "grad_norm", "tokens"))
    _blocks_match(jax_run, [r["mixtral"] for r in runs["ranks"]])


def test_lora_on_data_sequence_matches_jax(runs):
    """llama_lora with the ring on {data: 2, sequence: 2}: the adapters'
    gradients summed over the sequence ranks as well, the base frozen."""
    _check(runs, "lora")


def test_other_families_on_sequence_raise_a6b_ii(runs):
    """BERT on the ranks' {data: 2, sequence: 2}, and the configs of the
    families outside the Llama family with a sequence axis, raise naming
    ROADMAP.md A6b-ii; the Llama family's configs are taken."""
    for r in runs["ranks"]:
        assert "sequence=2" in r["bert"] and "A6b-ii" in r["bert"]
    for model in ("bert", "vit", "resnet", "mnist_cnn", "nas_cnn",
                  "darts_supernet"):
        with pytest.raises(ValueError, match="A6b-ii"):
            ttrainer.TrainerConfig.from_dict(
                {"model": model, "mesh": {"sequence": 2}})
    with pytest.raises(ValueError, match="A6b-ii"):
        from kubeflow_tpu_torch.rl.config import AnakinConfig

        AnakinConfig(mesh={"sequence": 2})
    for model in ("llama", "llama_lora", "mixtral"):
        cfg = ttrainer.TrainerConfig.from_dict(
            {"model": model, "mesh": {"sequence": -1}})
        assert cfg.mesh.sequence == -1
