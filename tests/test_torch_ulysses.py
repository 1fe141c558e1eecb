"""The port's Ulysses sequence parallelism (ops/ulysses.py) on 4 gloo
ranks (tests/torch_ranks.py, case `ulysses`) against the JAX
`ulysses_attention_sharded` on {sequence: 4} of virtual CPU devices and
the JAX `mha`, forward and the gradients of q, k and v: causal and not,
kv heads the axis divides (GQA kept through the reshard) and kv heads it
does not (expanded to full heads first), packed segment ids across the
shards, and a sequence of 256 (where the JAX body turns to its flash
attention; the port's is flash attention at any length). The exchange
itself: a rank's heads after `seq_to_heads` are its block of every
shard's, and `heads_to_seq` brings them back; a head count the axis
does not divide raises. f32 throughout."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kubeflow_tpu.ops.attention import mha
from kubeflow_tpu.ops.ulysses import ulysses_attention_sharded
from kubeflow_tpu.parallel import MeshConfig, make_mesh

import torch_ranks

torch.set_num_threads(1)

N = 4
# f32 against XLA, the same sums in another order (the JAX package's
# ulysses tests hold 2e-5 forward and 1e-4 for the gradients)
TOL = 2e-5
GRAD_TOL = 1e-4


def _case(seed, b, s, h, hkv, d, causal, seg=None):
    rng = np.random.default_rng(seed)

    def x(heads):
        return rng.normal(size=(b, s, heads, d)).astype(np.float32)
    return {"q": x(h), "k": x(hkv), "v": x(hkv), "cot": x(h), "seg": seg,
            "causal": causal}


def _documents(b, s, at):
    seg = np.zeros((b, s), np.int32)
    for i, a in enumerate(at):
        seg[i, a:] = 1
    return seg


CASES = {
    "causal": _case(11, 2, 64, 4, 4, 16, True),
    "noncausal": _case(12, 2, 64, 4, 4, 16, False),
    "uneven_kv": _case(13, 1, 32, 4, 2, 8, True),
    "gqa": _case(14, 1, 64, 8, 4, 16, True),
    "segments": _case(15, 2, 64, 4, 4, 16, True, _documents(2, 64, (24, 41))),
    "long": _case(16, 1, 256, 4, 4, 16, True, _documents(1, 256, (100,))),
}


def _jax(c):
    mesh = make_mesh(MeshConfig(sequence=N), devices=jax.devices()[:N])
    seg = None if c["seg"] is None else jnp.asarray(c["seg"])
    cot = jnp.asarray(c["cot"])

    def uly(q, k, v):
        return ulysses_attention_sharded(q, k, v, mesh, causal=c["causal"],
                                         segment_ids=seg)

    def ref(q, k, v):
        return mha(q, k, v, causal=c["causal"], segment_ids=seg)

    def with_grads(fn):
        def run(q, k, v):
            o, vjp = jax.vjp(fn, q, k, v)
            return (o, *vjp(cot))
        return jax.jit(run)

    args = tuple(jnp.asarray(c[x]) for x in "qkv")
    return {name: [np.asarray(x) for x in with_grads(fn)(*args)]
            for name, fn in (("ulysses", uly), ("mha", ref))}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("ulysses"))
    names = list(CASES)
    torch_ranks.write_inputs("ulysses", d,
                             {"cases": [CASES[n] for n in names]})
    handle = torch_ranks.start("ulysses", N, d)
    jax_out = {n: _jax(CASES[n]) for n in names}
    ranks = sorted(torch_ranks.finish(handle), key=lambda r: r["rank"])
    port = {n: [np.concatenate([r["cases"][i][key] for r in ranks], axis=1)
                for key in ("o", "dq", "dk", "dv")]
            for i, n in enumerate(names)}
    return {"jax": jax_out, "port": port, "ranks": ranks}


def _close(runs, name, refs=("ulysses", "mha")):
    for ref in refs:
        for key, g, w in zip(("o", "dq", "dk", "dv"), runs["port"][name],
                             runs["jax"][name][ref]):
            tol = TOL if key == "o" else GRAD_TOL
            np.testing.assert_allclose(g, w, rtol=tol, atol=tol,
                                       err_msg=f"{name} {key} vs JAX {ref}")


@pytest.mark.parametrize("name", ["causal", "noncausal"])
def test_ulysses_matches_jax_and_mha(runs, name):
    _close(runs, name)


def test_uneven_kv_expands_to_full_heads(runs):
    """2 kv heads over 4 ranks: expanded to the 4 query heads, the
    gradients summed back to the 2 kv heads."""
    assert runs["port"]["uneven_kv"][2].shape[2] == 2
    _close(runs, "uneven_kv")


def test_gqa_survives_the_reshard(runs):
    """4 kv heads over 4 ranks: one kv head and two query heads a rank."""
    _close(runs, "gqa")


def test_segment_ids_gathered_across_shards(runs):
    _close(runs, "segments")


def test_long_sequence_flash_body(runs):
    """S = 256: the JAX body's flash attention, the port's flash
    attention, both against mha."""
    _close(runs, "long")


def test_exchange_layout_and_inverse(runs):
    """After seq_to_heads rank j holds head block j of the whole
    sequence; heads_to_seq gives back its shard."""
    q = CASES["causal"]["q"]
    hn = q.shape[2] // N
    for r in runs["ranks"]:
        j = r["rank"]
        np.testing.assert_array_equal(r["heads"],
                                      q[:, :, j * hn:(j + 1) * hn])
        np.testing.assert_array_equal(r["back"],
                                      np.split(q, N, axis=1)[j])


def test_heads_not_divisible_raise(runs):
    for r in runs["ranks"]:
        assert "n_heads=6 not divisible by axis size 4" in r["odd_heads"]
