"""The port's ring attention (ops/ring_attention.py) against the JAX
package: on 4 gloo ranks (tests/torch_ranks.py, case `ring`) against the
JAX `ring_attention_sharded` on {sequence: 4} of virtual CPU devices
(its XLA body, and its Pallas body in interpret mode for one case) and
the JAX `mha`, forward and the gradients of q, k and v: causal and not,
GQA (kv-width shards around the ring), packed segment ids whose
document boundary lies inside a shard; the B1-B3 calls of each rank (a
causal rank launches nothing for a future shard); the group-free step
functions run for every rank in one process, the shards rotated by
hand; and the flash wrappers' `q_segment_ids` against the JAX kernels
`flash_fwd_stats` / `flash_bwd_grads` in interpret mode, with query
and key ids that differ and rows that see no key. f32 throughout."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kubeflow_tpu.ops import flash_pallas as jfp
from kubeflow_tpu.ops.attention import mha
from kubeflow_tpu.ops.ring_attention import ring_attention_sharded
from kubeflow_tpu.parallel import MeshConfig, make_mesh
from kubeflow_tpu_torch.ops import flash_attention as tfa
from kubeflow_tpu_torch.ops import ring_attention as tra

import torch_ranks

torch.set_num_threads(1)

N = 4
# f32 against XLA: the same sums in another order (the JAX package's own
# ring tests hold 2e-5); gradients through autodiff of the XLA ring
# against the port's explicit backward, as the JAX package's ring
# gradient test holds them
TOL = 2e-5
GRAD_TOL = 1e-4
# the Pallas body in interpret mode against the port (the JAX package's
# test_ring_pallas_* tolerance)
PALLAS_TOL = 2e-4


def _case(seed, b, s, h, hkv, d, causal, seg=None):
    rng = np.random.default_rng(seed)

    def x(heads):
        return rng.normal(size=(b, s, heads, d)).astype(np.float32)
    return {"q": x(h), "k": x(hkv), "v": x(hkv), "cot": x(h), "seg": seg,
            "causal": causal}


def _documents(b, s, at):
    """Two documents per row, row i's boundary at at[i]."""
    seg = np.zeros((b, s), np.int32)
    for i, a in enumerate(at):
        seg[i, a:] = 1
    return seg


# shards of 16: boundaries at 24 and 41 lie inside shards 1 and 2
CASES = {
    "causal": _case(1, 2, 64, 4, 4, 16, True),
    "noncausal": _case(2, 2, 64, 4, 4, 16, False),
    "gqa": _case(3, 1, 64, 4, 2, 16, True),
    "segments": _case(4, 2, 64, 4, 4, 16, True, _documents(2, 64, (24, 41))),
    "segments_noncausal_gqa": _case(5, 2, 64, 4, 2, 16, False,
                                    _documents(2, 64, (41, 24))),
}


def _jax_ring(c, impl="xla"):
    """(o, dq, dk, dv) of the JAX ring on {sequence: 4} and of mha."""
    mesh = make_mesh(MeshConfig(sequence=N), devices=jax.devices()[:N])
    seg = None if c["seg"] is None else jnp.asarray(c["seg"])
    cot = jnp.asarray(c["cot"])

    def ring(q, k, v):
        return ring_attention_sharded(q, k, v, mesh, causal=c["causal"],
                                      segment_ids=seg, impl=impl)

    def ref(q, k, v):
        return mha(q, k, v, causal=c["causal"], segment_ids=seg)

    def with_grads(fn):
        def run(q, k, v):
            o, vjp = jax.vjp(fn, q, k, v)
            return (o, *vjp(cot))
        return jax.jit(run)

    args = tuple(jnp.asarray(c[x]) for x in "qkv")
    return {name: [np.asarray(x) for x in with_grads(fn)(*args)]
            for name, fn in (("ring", ring), ("mha", ref))}


def _whole(rank_outs, i, key):
    """The whole tensor of case i's `key` from the ranks' blocks."""
    blocks = sorted(((r["rank"], r["cases"][i][key]) for r in rank_outs))
    return np.concatenate([blk for _, blk in blocks], axis=1)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("ring"))
    names = list(CASES)
    torch_ranks.write_inputs("ring", d, {"cases": [CASES[n] for n in names]})
    handle = torch_ranks.start("ring", N, d)
    jax_out = {n: _jax_ring(CASES[n]) for n in names}
    ranks = torch_ranks.finish(handle)
    port = {n: [_whole(ranks, i, key) for key in ("o", "dq", "dk", "dv")]
            for i, n in enumerate(names)}
    return {"jax": jax_out, "port": port, "ranks": ranks, "names": names}


def _close(got, want, tol, what):
    for name, g, w in zip(("o", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g, w, rtol=tol if name == "o"
                                   else GRAD_TOL, atol=tol if name == "o"
                                   else GRAD_TOL, err_msg=f"{what} {name}")


@pytest.mark.parametrize("name", ["causal", "noncausal"])
def test_ring_matches_jax_ring_and_mha(runs, name):
    for ref in ("ring", "mha"):
        _close(runs["port"][name], runs["jax"][name][ref], TOL,
               f"{name} vs JAX {ref}")


def test_ring_gqa_matches_jax(runs):
    """k/v at kv-head width around the ring, the gradients folded back to
    it."""
    assert runs["port"]["gqa"][2].shape[2] == 2
    for ref in ("ring", "mha"):
        _close(runs["port"]["gqa"], runs["jax"]["gqa"][ref], TOL, ref)


@pytest.mark.parametrize("name", ["segments", "segments_noncausal_gqa"])
def test_ring_segments_across_shards_match_jax(runs, name):
    for ref in ("ring", "mha"):
        _close(runs["port"][name], runs["jax"][name][ref], TOL,
               f"{name} vs JAX {ref}")


def test_ring_launches_nothing_for_future_shards(runs):
    """Causal: rank r calls B1, B2 and B3 once for each of its own and
    past shards, r + 1 times (N(N+1)/2 over the ring); not causal, N
    times each."""
    for r in runs["ranks"]:
        for i, name in enumerate(runs["names"]):
            want = r["rank"] + 1 if CASES[name]["causal"] else N
            assert r["calls"][i] == dict.fromkeys(
                ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"), want), name


def test_ring_pallas_body_matches_port(pallas_interpret):
    """The JAX ring's Pallas body (the TPU kernels per arriving shard, in
    interpret mode) on the GQA segmented case at S_loc 128 against the
    port's step functions over the same shards."""
    c = _case(6, 1, 512, 4, 2, 32, True, _documents(1, 512, (200,)))
    want = _jax_ring(c, impl="pallas")["ring"]
    got = _one_process(c)
    for name, g, w in zip(("o", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g, w, rtol=PALLAS_TOL, atol=PALLAS_TOL,
                                   err_msg=name)


def _one_process(c):
    """Every rank's forward and backward ring steps in this process, the
    K/V shards rotated by hand: (o, dq, dk, dv) whole, numpy."""
    t = {x: torch.from_numpy(c[x]) for x in ("q", "k", "v", "cot")}
    chunk = {x: t[x].chunk(N, dim=1) for x in t}
    seg = (None if c["seg"] is None
           else torch.from_numpy(c["seg"]).chunk(N, dim=1))
    causal = c["causal"]
    o, lse = [], []
    for me in range(N):
        b, s, h, _ = chunk["q"][me].shape
        acc = torch.zeros(chunk["q"][me].shape)
        run = torch.full((b, h, s), tfa.NEG_INF)
        for src in range(N):
            if not tra.runs_step(causal, src, me):
                continue
            o_r, lse_r = tra.ring_fwd_step(
                chunk["q"][me], chunk["k"][src], chunk["v"][src],
                None if seg is None else seg[me],
                None if seg is None else seg[src],
                diag=causal and src == me)
            acc, run = tra.ring_merge(acc, run, o_r, lse_r)
        o.append(acc)
        lse.append(run)
    dq = [torch.zeros_like(x) for x in chunk["q"]]
    dk = [torch.zeros(x.shape) for x in chunk["k"]]
    dv = [torch.zeros(x.shape) for x in chunk["v"]]
    for me in range(N):
        delta = tfa.row_delta(o[me], chunk["cot"][me])
        for src in range(N):
            if not tra.runs_step(causal, src, me):
                continue
            dq_p, dk_p, dv_p = tra.ring_bwd_step(
                chunk["q"][me], chunk["k"][src], chunk["v"][src],
                chunk["cot"][me], lse[me], delta,
                None if seg is None else seg[me],
                None if seg is None else seg[src],
                diag=causal and src == me)
            dq[me] += dq_p
            dk[src] += dk_p
            dv[src] += dv_p
    return [torch.cat(x, dim=1).numpy() for x in (o, dq, dk, dv)]


@pytest.mark.parametrize("name", ["gqa", "segments_noncausal_gqa"])
def test_step_functions_in_one_process_match_ranks(runs, name):
    """The group-free steps, every rank's in one process, give the gloo
    ranks' results."""
    got = _one_process(CASES[name])
    for g, w in zip(got, runs["port"][name]):
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6)


@pytest.fixture
def pallas_interpret():
    saved = jfp.FORCE_INTERPRET
    jfp.FORCE_INTERPRET = True
    yield
    jfp.FORCE_INTERPRET = saved


def _bh(x):
    b, s, h, d = x.shape
    return jnp.asarray(x.transpose(0, 2, 1, 3).reshape(b * h, s, d))


def _bshd(x, b, h):
    x = np.asarray(x)
    return x.reshape(b, h, *x.shape[1:]).transpose(0, 2, 1, 3)


def test_q_segment_ids_match_pallas_kernels(pallas_interpret):
    """A ring step's forward and backward with query ids (the local
    shard's) other than the key ids (an arriving shard's): the wrappers'
    plain versions against the TPU kernels in interpret mode. Query rows
    of document 2 see no key of shard 1: o = 0 there, lse <= -1e29,
    nothing NaN, and they add nothing to the gradients; the backward runs
    with the global lse and o of both shards, as the ring's does."""
    b, s, h, d = 1, 128, 2, 32
    rng = np.random.default_rng(7)
    q, k1, v1, k2, v2, do = (rng.normal(size=(b, s, h, d)).astype(
        np.float32) for _ in range(6))
    seg_q = np.repeat(np.array([[1, 2, 0]], np.int32), [40, 50, 38], axis=1)
    seg_1 = np.repeat(np.array([[0, 1]], np.int32), [60, 68], axis=1)
    seg_2 = np.repeat(np.array([[1, 2]], np.int32), [30, 98], axis=1)
    scale = d ** -0.5
    kw = dict(causal=False, scale=scale, interpret=True, block_q=128,
              block_kv=128)
    t = lambda x: torch.from_numpy(np.array(x))  # noqa: E731
    stats = []
    for k, v, seg_k in ((k1, v1, seg_1), (k2, v2, seg_2)):
        jo, jlse = jfp.flash_fwd_stats(_bh(q), _bh(k), _bh(v),
                                       jnp.asarray(seg_q), jnp.asarray(seg_k),
                                       **kw)
        o, lse = tfa.flash_fwd(t(q), t(k), t(v), causal=False,
                               segment_ids=t(seg_k), q_segment_ids=t(seg_q))
        np.testing.assert_allclose(o.numpy(), _bshd(jo, b, h), rtol=TOL,
                                   atol=TOL)
        np.testing.assert_allclose(lse.numpy(),
                                   np.asarray(jlse).reshape(b, h, s),
                                   rtol=TOL, atol=TOL)
        stats.append((o, lse))
    blind = seg_q[0] == 2          # document 2 is absent from shard 1
    o1, lse1 = stats[0]
    assert torch.isfinite(o1).all() and not torch.isnan(lse1).any()
    assert (o1[0, blind] == 0).all() and (lse1[0, :, blind] <= -1e29).all()
    o_g, lse_g = tra.ring_merge(torch.zeros(b, s, h, d),
                                torch.full((b, h, s), tfa.NEG_INF),
                                *stats[0])
    o_g, lse_g = tra.ring_merge(o_g, lse_g, *stats[1])
    assert (lse_g > -1e29).all()
    delta = tfa.row_delta(o_g, t(do))
    refs = jfp.flash_bwd_grads(
        _bh(q), _bh(k1), _bh(v1), jnp.asarray(seg_q), jnp.asarray(seg_1),
        _bh(o_g.numpy()), jnp.asarray(lse_g.numpy().reshape(b * h, s)),
        _bh(do), **kw)
    args = (t(q), t(k1), t(v1), t(do), lse_g, delta)
    seg_kw = dict(causal=False, segment_ids=t(seg_1), q_segment_ids=t(seg_q))
    dq = tfa.flash_bwd_dq(*args, **seg_kw)
    dk, dv = tfa.flash_bwd_dkv(*args, **seg_kw)
    for name, g, r in (("dq", dq, refs[0]), ("dk", dk, refs[1]),
                       ("dv", dv, refs[2])):
        np.testing.assert_allclose(g.numpy(), _bshd(r, b, h), rtol=TOL,
                                   atol=TOL, err_msg=name)
    assert (dq[0, blind] == 0).all()


def test_segment_checks_and_xla_impl_raise():
    """q_segment_ids need the key ids and Sq == Sk (one row stride for
    both); the JAX ring's "xla" body has no counterpart in the port."""
    q = torch.zeros(1, 8, 2, 16)
    k = torch.zeros(1, 12, 2, 16)
    ids = torch.zeros(1, 8, dtype=torch.int32)
    with pytest.raises(ValueError, match="needs segment_ids"):
        tfa.flash_fwd(q, q, q, q_segment_ids=ids)
    with pytest.raises(ValueError, match="one row stride"):
        tfa.flash_fwd(q, k, k, causal=False,
                      segment_ids=torch.zeros(1, 12, dtype=torch.int32),
                      q_segment_ids=ids)
    with pytest.raises(ValueError, match="plain-version"):
        tra.ring_attention(q, q, q, impl="xla")
    with pytest.raises(ValueError, match="multiple of kv heads"):
        tra.ring_attention(torch.zeros(1, 8, 3, 16), q, q)
