"""The port's tensor axis (Megatron splits of models/llama.py under
parallel/sharding.py's regions; the repeated compute of the families
without the registry's `local_blocks`) against the JAX Trainer on the
same mesh of virtual CPU devices, and against the port's one-rank
trainer. The port's ranks are gloo processes (tests/torch_ranks.py); the
JAX trainers run here meanwhile.

Llama's tiny config (8 query heads, 4 kv heads) at f32 from the JAX
init, three steps on {fsdp: 2, tensor: 2} and {data: 2, tensor: 2} with
loss masks whose token counts differ between the data shards: losses,
tokens, grad norms and each rank's blocks against the JAX arrays'
addressable shards at its mesh coordinate; B1-B3's plain versions on 4
and 2 heads a rank, the cross-entropy on 256 of the 512 vocabulary
columns. The same with ce_chunk; LoRA on {tensor: 2} (nonzero b, so
every factor has a gradient from the first step) and BERT on {tensor:
2}, its compute repeated on both ranks, against JAX on the same mesh;
n_kv_heads that the tensor size does not divide raises."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kubeflow_tpu.parallel import MeshConfig
from kubeflow_tpu.training import data as jdata
from kubeflow_tpu.training import trainer as jtrainer
from kubeflow_tpu_torch.training import trainer as ttrainer
from kubeflow_tpu_torch.training.metrics_writer import MetricsWriter

import torch_ranks

torch.set_num_threads(2)

TINY = dict(vocab_size=512, d_model=64, n_layers=2, n_heads=8, n_kv_heads=4,
            d_ff=128, max_seq_len=128, rope_theta=10000.0)
OPT = dict(learning_rate=1e-2, warmup_steps=1, total_steps=10)
B, S, STEPS = 8, 16, 3
# f32 against XLA on the same mesh: sums in another order (the row- and
# vocab-parallel partial sums among them)
RTOL = 2e-5
# a block after three AdamW steps, relative to its leaf's norm: a
# gradient entry near 0 can take an update of either sign (as in
# tests/test_torch_moe.py)
BLOCK_TOL = 1e-4
BERT = dict(vocab_size=512, d_model=64, n_layers=2, n_heads=8, d_ff=128,
            max_seq_len=64)


def _llama_batches():
    rng = np.random.default_rng(11)
    out = []
    for _ in range(STEPS):
        mask = np.ones((B, S), np.float32)
        mask[2:4, 5:] = 0.0          # data shard 0's second half: fewer
        mask[4:6, 1:] = 0.0          # shard 1's first rows: one token
        mask[6, ::2] = 0.0
        out.append({"tokens": rng.integers(0, 512, (B, S)).astype(np.int32),
                    "loss_mask": mask})
    return out


def _jax_trainer(model, overrides, batch, mesh, n_dev, **opt):
    cfg = jtrainer.TrainerConfig(
        model=model, model_overrides=overrides, batch_size=batch,
        optimizer=jtrainer.OptimizerConfig(**OPT, **opt), mesh=mesh, seed=0)
    jt = jtrainer.Trainer(cfg, devices=jax.devices()[:n_dev],
                          metrics=MetricsWriter(echo=False))
    state = jt.init_state()
    return jt, state, [np.array(x) for x in jax.tree.leaves(state["params"])]


def _jax_steps(jt, state, batches):
    step, log = None, []
    for b in batches:
        b = jt.shard_batch(b)
        step = step or jt.compiled_step(state, b)
        state, m = step(state, b)
        log.append({k: float(v) for k, v in jax.device_get(m).items()})
    return state, log


def _config(model, overrides, batch, **opt):
    return dict(model=model, model_overrides=overrides, batch_size=batch,
                optimizer=ttrainer.OptimizerConfig(**OPT, **opt), seed=0)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("tensor"))
    lb = _llama_batches()
    over = dict(TINY, dtype="float32")
    jt, jstate, jinit = _jax_trainer("llama", dict(TINY, dtype=jnp.float32),
                                     B, MeshConfig(fsdp=2, tensor=2), 4)
    torch_ranks.write_inputs("tensor", d, {
        "config": _config("llama", over, B), "params": jinit,
        "batches": lb})
    bjt, bstate, binit = _jax_trainer(
        "bert", dict(BERT, dtype=jnp.float32), 4, MeshConfig(tensor=2), 2)
    bb = [dict(b) for b, _ in zip(jdata.for_model(
        "bert", bjt.model_cfg, 4, 32, 3), range(STEPS))]
    ljt, lstate = _jax_lora()
    lora_batches = [{"tokens": b["tokens"][:4]} for b in lb]
    torch_ranks.write_inputs("tensor2", d, {
        "lora": {"config": _config("llama_lora", dict(rank=2, llama=over), 4,
                                   trainable_prefix="lora"),
                 "params": [np.array(x) for x in
                            jax.tree.leaves(lstate["params"])],
                 "batches": lora_batches},
        "bert": {"config": _config("bert", dict(BERT, dtype="float32"), 4),
                 "params": binit, "batches": bb}})
    h1 = torch_ranks.start("tensor", 4, d)
    h2 = torch_ranks.start("tensor2", 2, d)
    # the JAX steps run while the ranks do
    djt, dstate, _ = _jax_trainer("llama", dict(TINY, dtype=jnp.float32), B,
                                  MeshConfig(data=2, tensor=2), 4)
    jstate, jlog = _jax_steps(jt, jstate, lb)
    dstate, dlog = _jax_steps(djt, dstate, lb)
    bstate, blog = _jax_steps(bjt, bstate, bb)
    lstate, llog = _jax_steps(ljt, lstate, lora_batches)
    ranks, two = torch_ranks.finish(h1), torch_ranks.finish(h2)
    return dict(jt=jt, jstate=jstate, jlog=jlog, djt=djt, dstate=dstate,
                dlog=dlog, bjt=bjt, bstate=bstate, blog=blog, ljt=ljt,
                lstate=lstate, llog=llog, ranks=ranks, two=two, lb=lb)


def _jax_lora():
    """The JAX llama_lora trainer on {tensor: 2} and its initial state
    with every adapter's b drawn nonzero (LoRA's b = 0 would leave each
    a without a gradient at the first step), placed by the trainer's
    param_sharding."""
    jt, state, _ = _jax_trainer(
        "llama_lora", dict(rank=2, llama=dict(TINY, dtype=jnp.float32)), 4,
        MeshConfig(tensor=2), 2, trainable_prefix="lora")
    rng = np.random.default_rng(5)
    params = jax.tree.map(lambda x: x, state["params"])
    params["lora"] = {t: {"a": ab["a"], "b": jnp.asarray(rng.normal(
        size=ab["b"].shape).astype(np.float32) * 0.05)}
        for t, ab in params["lora"].items()}
    return jt, dict(state, params=jax.device_put(params, jt.param_sharding))


def _close(a, b, keys=("loss", "grad_norm", "tokens"), **kw):
    assert len(a) == len(b) == STEPS
    for x, y in zip(a, b):
        for k in keys:
            np.testing.assert_allclose(x[k], y[k], **kw, err_msg=k)


def _blocks_match(jt, jstate, runs_of_ranks):
    """Each rank's block of each param equals the JAX array's addressable
    shard at the rank's mesh coordinate (the arrays placed by the JAX
    trainer's param_sharding), within BLOCK_TOL of the leaf's norm."""
    mesh = jt.mesh
    coords = {mesh.devices[i]: i for i in np.ndindex(mesh.devices.shape)}
    place = jax.tree.leaves(jt.param_sharding,
                            is_leaf=lambda x: hasattr(x, "spec"))
    by_coord = {r["coord"]: r for r in runs_of_ranks}
    for i, leaf in enumerate(jax.tree.leaves(jstate["params"])):
        tol = BLOCK_TOL * max(float(np.linalg.norm(np.asarray(leaf))), 1e-6)
        leaf = jax.device_put(leaf, place[i])
        for shard in leaf.addressable_shards:
            mine = by_coord[coords[shard.device]]["params"][i]
            want = np.asarray(shard.data)
            assert mine.shape == want.shape, i
            assert np.abs(mine - want).max() <= tol, i


def test_llama_fsdp_tensor_matches_jax(runs):
    """{fsdp: 2, tensor: 2}: every rank's losses, tokens and grad norms
    are the JAX trainer's, the tensor pair of each shard counted once
    (the global token counts), and each block is JAX's shard."""
    counts = [float(b["loss_mask"][:, 1:].sum()) for b in runs["lb"]]
    for r in runs["ranks"]:
        assert [x["tokens"] for x in r["fsdp"]["log"]] == counts
        _close(r["fsdp"]["log"], runs["jlog"], rtol=RTOL)
        assert r["fsdp"]["log"] == runs["ranks"][0]["fsdp"]["log"]
    _blocks_match(runs["jt"], runs["jstate"],
                  [r["fsdp"] for r in runs["ranks"]])


def test_llama_data_tensor_matches_jax(runs):
    """{data: 2, tensor: 2}, the data shards' token counts unequal: the
    JAX trainer's losses, grad norms and blocks."""
    halves = [b["loss_mask"][:, 1:].reshape(2, -1).sum(1) for b in runs["lb"]]
    assert all(h[0] != h[1] for h in halves)
    for r in runs["ranks"]:
        _close(r["data"]["log"], runs["dlog"], rtol=RTOL)
    _blocks_match(runs["djt"], runs["dstate"],
                  [r["data"] for r in runs["ranks"]])


def test_llama_ce_chunk_matches_jax(runs):
    """ce_chunk 4 on {data: 2, tensor: 2}: the vocab-parallel loss per
    chunk under checkpoint gives the unchunked JAX run's numbers."""
    for r in runs["ranks"]:
        _close(r["chunk"]["log"], runs["dlog"], rtol=RTOL)
    _blocks_match(runs["djt"], runs["dstate"],
                  [r["chunk"] for r in runs["ranks"]])


def test_kernels_see_local_heads_and_the_logits_stay_split(runs):
    """B1-B3's wrapper sees a rank's 4 query and 2 kv heads, and the
    cross-entropy a rank's 256 vocabulary columns, never all 512."""
    for r in runs["ranks"]:
        assert r["seen"]["heads"] == {(4, 2)}
        assert r["seen"]["ce_width"] == {256}


def test_kv_heads_not_divisible_by_tensor_raise(runs):
    """n_kv_heads 2 on {tensor: 4}: a rank's query heads would need
    another rank's kv heads; the step raises naming A6a-iii."""
    for r in runs["ranks"]:
        assert "n_kv_heads=2" in r["gqa"] and "A6a-iii" in r["gqa"]


def test_lora_on_tensor2_matches_jax(runs):
    """llama_lora on {tensor: 2} from the JAX trainer's params (a column
    target's b and wo's a split, the whole factor through copy_in): the
    JAX trainer's losses, grad norms and blocks, adapters and the frozen
    base alike; the base does not move."""
    for r in runs["two"]:
        assert not r["lora"]["base_moved"]
        _close(r["lora"]["log"], runs["llog"], keys=("loss", "grad_norm"),
               rtol=RTOL)
    _blocks_match(runs["ljt"], runs["lstate"],
                  [r["lora"] for r in runs["two"]])


def test_bert_on_tensor2_repeats_compute_and_matches_jax(runs):
    """BERT (no `local_blocks`) on {tensor: 2}: each rank computes the
    whole step and keeps its blocks; JAX's losses, grad norms and
    blocks."""
    for r in runs["two"]:
        _close(r["bert"]["log"], runs["blog"], keys=("loss", "grad_norm"),
               rtol=RTOL)
    _blocks_match(runs["bjt"], runs["bstate"],
                  [r["bert"] for r in runs["two"]])


@pytest.mark.parametrize("nodes,sizes", [
    ([0] * 4 + [1] * 4, {"data": 2, "fsdp": 2, "tensor": 2}),
    ([0, 0, 1, 1, 2, 2, 3, 3], {"data": 4, "expert": 2}),
    (["b"] * 2 + ["a"] * 2, {"data": 2, "tensor": 2}),
    ([0, 0, 0, 1], {"data": 2, "tensor": 2}),
    ([0, 0, 1, 1], {"fsdp": 2, "tensor": 2}),
    ([0] * 4, {"data": 2, "tensor": 2})],
    ids=["even", "four-nodes", "named", "uneven", "no-data", "one-node"])
def test_multi_node_arrangement_equals_jax_hybrid(nodes, sizes, caplog):
    """`arrange_ranks` from made-up node lists against the JAX
    `_hybrid_device_array` over stand-in devices whose slice is the node:
    data across the nodes and the other axes inside one where the data
    axis strides them evenly, else the flat order with a warning (JAX
    returns None and lays the claimed devices out flat)."""
    import logging
    import types

    from kubeflow_tpu.parallel import mesh as jmesh
    from kubeflow_tpu_torch.parallel import mesh as tmesh

    full = {a: sizes.get(a, 1) for a in tmesh.AXIS_ORDER}
    index = {n: i for i, n in enumerate(dict.fromkeys(nodes))}
    devices = [types.SimpleNamespace(id=r, slice_index=index[n],
                                     platform="cpu")
               for r, n in enumerate(nodes)]
    with caplog.at_level(logging.WARNING):
        got = tmesh.arrange_ranks(nodes, full)
    want = jmesh._hybrid_device_array(devices, full)
    shape = tuple(full[a] for a in tmesh.AXIS_ORDER)
    if want is None:
        want = np.arange(len(nodes)).reshape(shape)
    else:
        want = np.vectorize(lambda d: d.id)(want)
    assert got.tolist() == want.tolist()
    spread = len(set(nodes)) > 1 and got.flatten().tolist() != list(
        range(len(nodes)))
    warned = "cannot stride" in caplog.text
    assert not (spread and warned)
    if len(set(nodes)) > 1 and (sizes.get("data", 1) % len(set(nodes))
                                or len(set(nodes.count(n)
                                           for n in nodes)) > 1):
        assert warned
    if spread:   # every non-data axis stays inside one node
        ids = np.asarray(got).reshape(shape)
        for idx in np.ndindex(shape[0]):
            assert len({nodes[r] for r in ids[idx].flatten()}) == 1
