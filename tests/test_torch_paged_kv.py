"""The port's paged KV serving on the CPU against the JAX package: the
block pool's ids, refcounts and stats step for step; K2's paged plain
version against the JAX TPU kernel in interpret mode and against the JAX
XLA gather twin; decode_step through block tables against the JAX
decode_step on the same pool; and PagedLLMEngine's greedy tokens against
the JAX PagedLLMEngine (prefix cache off) and the port's slab engine,
including an oversubscribed burst that holds prefills."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.kvcache.pool import BlockPool as JaxPool
from kubeflow_tpu.models import llama as jllama
from kubeflow_tpu.ops import flash_decode as jfd
from kubeflow_tpu.serving.paged import PagedLLMEngine as JaxPaged
from kubeflow_tpu_torch.kvcache import BlockPool
from kubeflow_tpu_torch.models import interop
from kubeflow_tpu_torch.models import llama as tllama
from kubeflow_tpu_torch.ops import flash_decode as tfd
from kubeflow_tpu_torch.serving.llm import LLMEngine
from kubeflow_tpu_torch.serving.paged import PagedLLMEngine

torch.set_num_threads(2)

# the engine settings and prompts of tests/test_torch_engine.py
ENGINE = dict(n_slots=2, max_len=48, buckets=(8, 16))
PROMPTS = [[3, 17, 101, 44, 9], list(range(20, 32)),
           [7] * 3 + list(range(200, 213))]
NEW = 8
# an oversubscribed pool: 4 slots would need up to 16 blocks, 6 exist
BURST = dict(n_slots=4, max_len=32, buckets=(8,), decode_chunk=4,
             pool_blocks=6)
BURST_PROMPTS = [[10 + i, 20 + i, 30 + i, 40 + i] for i in range(8)]
BURST_NEW = 6
# f32 attention: online softmax (JAX kernel) vs one-pass softmax (plain
# version) differ by f32 rounding only (tests/test_torch_kernel_refs.py)
ATOL, RTOL = 2e-5, 2e-5
# a 2-layer f32 model in two frameworks (tests/test_torch_llama.py)
LOGIT_ATOL, LOGIT_RTOL = 1e-4, 1e-4


@pytest.fixture(scope="module")
def tiny():
    jcfg = dataclasses.replace(jllama.LlamaConfig.tiny(), dtype=jnp.float32)
    tcfg = dataclasses.replace(tllama.LlamaConfig.tiny(),
                               dtype=torch.float32)
    jparams = jllama.init(jax.random.key(0), jcfg)
    tparams = interop.from_jax_params(jax.tree.map(np.asarray, jparams),
                                      tcfg, device="cpu")
    return jcfg, tcfg, jparams, tparams


def _run(engine, prompts, new, **kw):
    rids = [engine.submit(p, new, **kw) for p in prompts]
    engine.run_until_idle()
    return [engine.result(r) for r in rids]


@pytest.fixture(scope="module")
def jax_tokens(tiny):
    """Greedy tokens of the JAX PagedLLMEngine, each engine built once:
    ENGINE plain and int8/int8, and the oversubscribed BURST."""
    jcfg, _, jparams, _ = tiny
    out = {}
    for quant in (None, "int8"):
        eng = JaxPaged(jparams, jcfg, prefix_cache=False,
                       prefer_native=False, quantize=quant,
                       kv_quantize=quant, **ENGINE)
        out[quant] = _run(eng, PROMPTS, NEW)
        eng.close()
    eng = JaxPaged(jparams, jcfg, prefix_cache=False, prefer_native=False,
                   **BURST)
    out["burst"] = _run(eng, BURST_PROMPTS, BURST_NEW)
    eng.close()
    return out


# -- BlockPool ----------------------------------------------------------------


def make_pool(cls=BlockPool, n_blocks=8):
    return cls(n_layers=2, n_blocks=n_blocks, block_tokens=4, n_kv_heads=2,
               head_dim=4, dtype=torch.float32)


def test_pool_cases_of_the_jax_pool_tests():
    """The three cases of tests/test_paged_kv.py: all-or-nothing alloc,
    refcounts and the free list, the watermark."""
    pool = make_pool(n_blocks=8)
    assert pool.capacity_blocks == 7
    ids = pool.alloc(5)
    assert ids is not None and len(ids) == 5 and 0 not in ids
    assert pool.free_blocks == 2
    assert pool.alloc(3) is None             # no partial grant
    assert pool.free_blocks == 2
    assert pool.stats()["alloc_failures"] == 1
    pool.check_invariants()

    pool = make_pool(n_blocks=6)
    ids = pool.alloc(3)
    pool.ref(ids[:2])
    assert pool.refcount(ids[0]) == 2
    assert pool.deref(ids) == 1
    assert pool.free_blocks == 3
    assert pool.deref(ids[:2]) == 2
    assert pool.free_blocks == 5
    with pytest.raises(ValueError):
        pool.ref([0])                        # the trash block
    with pytest.raises(ValueError):
        pool.deref(ids[:1])                  # a double free
    pool.check_invariants()

    pool = make_pool(n_blocks=9)
    assert pool.watermark_frac == 1.0
    ids = pool.alloc(6)
    assert pool.watermark_frac == pytest.approx(0.25)
    s = pool.stats()
    assert s["free_blocks"] == 2 and s["used_blocks"] == 6
    assert s["pool_blocks"] == 8
    pool.deref(ids)
    assert pool.watermark_frac == 1.0


def test_pool_matches_jax_pool_step_for_step():
    """A seeded random sequence of alloc/ref/deref on both pools: the same
    ids, refcounts and stats after every step."""
    rng = np.random.default_rng(0)
    ours, ref = make_pool(n_blocks=12), make_pool(JaxPool, n_blocks=12)
    held: list[int] = []                     # one entry per reference
    for _ in range(300):
        op = rng.integers(3) if held else 0
        if op == 0:
            n = int(rng.integers(0, 6))
            got, want = ours.alloc(n), ref.alloc(n)
            assert got == want
            held += got or []
        elif op == 1:
            ids = sorted(set(rng.choice(held, size=min(3, len(held)),
                                        replace=False).tolist()))
            ours.ref(ids)
            ref.ref(ids)
            held += ids
        else:
            ids = sorted(set(rng.choice(held, size=min(3, len(held)),
                                        replace=False).tolist()))
            assert ours.deref(ids) == ref.deref(ids)
            for b in ids:
                held.remove(b)
        assert ours.stats() == ref.stats()
        assert [ours.refcount(b) for b in range(12)] == \
            [ref.refcount(b) for b in range(12)]
        ours.check_invariants()


# -- K2 paged: the plain version against the JAX kernel and gather twin -----


def _paged_inputs(rng, s_v, bt, quantized, b=4, nkv=2, hd=16):
    """A pool larger than the batch needs, with large finite junk in block
    0 (the trash block), and shuffled tables whose entries past each
    slot's live keys are 0."""
    nb = 48 // bt
    span = nb * bt
    n_pool = b * nb + 3
    lengths = np.array([0, 7, 21, span - s_v], np.int32)

    def payload():
        x = rng.normal(size=(n_pool, bt, nkv, hd)).astype(np.float32)
        x[0] = 1e4 * rng.normal(size=x[0].shape)
        if not quantized:
            return x, None
        q, s = (np.array(a) for a in jllama.quantize_kv(jnp.asarray(x)))
        s[0] = 1e4
        return q, s

    k, ks = payload()
    v, vs = payload()
    perm = rng.permutation(np.arange(1, n_pool))
    tables = np.zeros((b, nb), np.int32)
    for i in range(b):
        live = -(-(int(lengths[i]) + s_v) // bt)
        tables[i, :live] = perm[i * nb:i * nb + live]
    return lengths, k, v, ks, vs, tables


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


# one test item per KV type, each over S_v 1 and 4 and bt 8 and 16. The
# file keeps fewer items than tests/test_obs_tracing.py (14): xdist's
# --dist loadfile queue orders files by descending test count, so this
# file is queued after that order-dependent test and leaves the files
# queued before it as they were (ROADMAP.md §C)
@pytest.mark.parametrize("quantized", [False, True])
def test_flash_decode_paged_plain_matches_jax(quantized):
    for s_v in (1, 4):
        for bt in (8, 16):
            _check_paged_plain(quantized, s_v, bt)


def _check_paged_plain(quantized, s_v, bt):
    nh, nkv, hd = 8, 2, 16
    rng = np.random.default_rng(100 + 10 * s_v + bt)
    lengths, k, v, ks, vs, tables = _paged_inputs(rng, s_v, bt, quantized)
    b = len(lengths)
    q = rng.normal(size=(b, s_v, nh, hd)).astype(np.float32)
    got = tfd.flash_decode_attention(_t(q), _t(k), _t(v), _t(lengths),
                                     k_scale=_t(ks), v_scale=_t(vs),
                                     tables=_t(tables))
    assert np.isfinite(got.numpy()).all()
    kern = jfd.flash_decode_attention(_j(q), _j(k), _j(v), _j(lengths),
                                      k_scale=_j(ks), v_scale=_j(vs),
                                      tables=_j(tables), interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(kern), atol=ATOL,
                               rtol=RTOL)
    cfg = jllama.LlamaConfig(vocab_size=64, d_model=nh * hd, n_layers=1,
                             n_heads=nh, n_kv_heads=nkv, d_ff=32,
                             max_seq_len=512, dtype=jnp.float32)
    positions = jnp.asarray(lengths)[:, None] + jnp.arange(s_v)[None]
    xla = jllama.decode_attention(cfg, _j(q), _j(k), _j(v), _j(ks), _j(vs),
                                  positions, impl="xla", tables=_j(tables))
    np.testing.assert_allclose(got.reshape(b, s_v, -1).numpy(),
                               np.asarray(xla), atol=ATOL, rtol=RTOL)


def test_paged_argument_checks(tiny):
    """The card path's argument checks, run on CPU tensors, and a paged
    span that does not divide by block_tokens."""
    q = torch.zeros(2, 1, 8, 64, dtype=torch.bfloat16)
    k = torch.zeros(5, 16, 2, 64, dtype=torch.int8)
    s = torch.zeros(5, 16, 2)
    tables = torch.zeros(2, 3, dtype=torch.int32)
    lengths = torch.zeros(2, dtype=torch.int32)
    assert tfd.check_paged(q, k, k, s, s, tables, lengths, "t") == \
        (True, 16, 3)
    for bad in (tables.long(), tables[:1], tables.t().contiguous().t()):
        with pytest.raises(ValueError, match="tables"):
            tfd.check_paged(q, k, k, s, s, bad, lengths, "t")
    with pytest.raises(ValueError, match="scales"):
        tfd.check_paged(q, k, k, s[:, :8], s, tables, lengths, "t")
    with pytest.raises(ValueError, match="k_scale"):
        tfd.check_paged(q, k, k, None, None, tables, lengths, "t")
    meta = q.to("meta")
    with pytest.raises(ValueError, match="device"):
        tfd.flash_decode_attention(meta, k, k, lengths, k_scale=s,
                                   v_scale=s, tables=tables)
    _, tcfg, _, tparams = tiny
    cache = {"k": torch.zeros(2, 4, 8, 4, 8), "v": torch.zeros(2, 4, 8, 4, 8),
             "tbl": torch.zeros(2, 6, dtype=torch.int32)}
    with pytest.raises(ValueError, match="block_tokens"):
        tllama.decode_step(tparams, torch.zeros(2, dtype=torch.long), cache,
                           torch.zeros(2, dtype=torch.int32), tcfg, span=20)


# -- decode_step through block tables -----------------------------------------


@pytest.mark.parametrize("quantized", [False, True])
def test_paged_decode_step_matches_jax(tiny, quantized):
    """Four slots over a shuffled pool: two live, one released (its table
    row zero) and one past max_len; both junk writes land in block 0, at
    different offsets. The logits, and the whole pool after the step."""
    jcfg, tcfg, jparams, tparams = tiny
    jp = jllama.quantize_params(jparams) if quantized else jparams
    tp = interop.from_jax_params(jax.tree.map(np.asarray, jp), tcfg,
                                 device="cpu") if quantized else tparams
    bt, n_tbl, n_pool = 8, 6, 20            # max_len 48
    rng = np.random.default_rng(7)
    shape = (jcfg.n_layers, n_pool, bt, jcfg.n_kv_heads, jcfg.head_dim)
    kf = rng.normal(size=shape).astype(np.float32)
    vf = rng.normal(size=shape).astype(np.float32)
    if quantized:
        kq, ksc = jllama.quantize_kv(jnp.asarray(kf))
        vq, vsc = jllama.quantize_kv(jnp.asarray(vf))
        pool = {"k": kq, "v": vq, "k_s": ksc, "v_s": vsc}
    else:
        pool = {"k": jnp.asarray(kf), "v": jnp.asarray(vf)}
    perm = rng.permutation(np.arange(1, n_pool))
    tbl = np.zeros((4, n_tbl), np.int32)
    tbl[0, :2] = perm[:2]                  # live at 9: blocks 0, 1
    tbl[1, :6] = perm[2:8]                 # live at 40
    tbl[3, :6] = perm[8:14]                # past max_len: writes to block 0
    lengths = np.array([9, 40, 5, 48], np.int32)   # slot 2: zero row
    toks = rng.integers(0, tcfg.vocab_size, size=4).astype(np.int32)
    jcache = dict(pool, tbl=jnp.asarray(tbl))
    tcache = {n: torch.from_numpy(np.array(a)) for n, a in jcache.items()}
    jl, jnew = jllama.decode_step(jp, jnp.asarray(toks), jcache,
                                  jnp.asarray(lengths), jcfg, span=48)
    tl = tllama.decode_step(tp, torch.from_numpy(toks).long(), tcache,
                            torch.from_numpy(lengths), tcfg, span=48)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_ATOL,
                               rtol=LOGIT_RTOL)
    np.testing.assert_array_equal(tcache["tbl"].numpy(), tbl)
    for name in pool:
        got, want = tcache[name].numpy(), np.asarray(jnew[name])
        if quantized and name in ("k", "v"):
            # the int8 payloads, every row: the same bytes
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, atol=LOGIT_ATOL,
                                       rtol=LOGIT_RTOL)
    # the step wrote slot 2's and slot 3's rows into block 0 only: every
    # block no live slot writes is unchanged
    before = np.array(pool["k"])
    written = {int(tbl[0, 1]), int(tbl[1, 5]), 0}
    for blk in set(range(n_pool)) - written:
        np.testing.assert_array_equal(tcache["k"].numpy()[:, blk],
                                      before[:, blk])
    assert not np.array_equal(tcache["k"].numpy()[:, 0], before[:, 0])


# -- PagedLLMEngine -----------------------------------------------------------


@pytest.mark.parametrize("quant", [None, "int8"])
def test_greedy_tokens_equal_jax_paged_and_port_slab(tiny, jax_tokens,
                                                     quant):
    _, tcfg, _, tparams = tiny
    eng = PagedLLMEngine(tparams, tcfg, quantize=quant, kv_quantize=quant,
                         device="cpu", **ENGINE)
    got = _run(eng, PROMPTS, NEW)
    assert got == jax_tokens[quant]
    slab = LLMEngine(tparams, tcfg, quantize=quant, kv_quantize=quant,
                     device="cpu", **ENGINE)
    assert got == _run(slab, PROMPTS, NEW)
    assert all(len(t) == NEW for t in got)
    m = eng.metrics()
    assert m["held_prefills"] == 0
    assert m["kv_pool"]["free_blocks"] == m["kv_pool"]["pool_blocks"] == 12
    eng._pool.check_invariants()


def test_oversubscribed_burst_holds_prefills_and_loses_no_token(
        tiny, jax_tokens):
    _, tcfg, _, tparams = tiny
    eng = PagedLLMEngine(tparams, tcfg, device="cpu", **BURST)
    rids = [eng.submit(p, BURST_NEW) for p in BURST_PROMPTS]
    held = []
    for _ in range(600):
        if all(eng.is_done(r) for r in rids):
            break
        eng.step()
        held.append(eng.metrics()["held_prefills"])
        eng._pool.check_invariants()
    outs = [eng.result(r) for r in rids]
    assert all(len(o) == BURST_NEW for o in outs)
    assert max(held) > 0
    assert outs == jax_tokens["burst"]
    m = eng.metrics()
    assert m["held_prefills"] == 0 and eng._held == []
    assert m["kv_pool"]["free_blocks"] == m["kv_pool"]["pool_blocks"] == 6
    assert m["kv_pool"]["alloc_failures"] > 0
    assert not eng._tbl_host.any()


def test_paged_ctor_validation(tiny, monkeypatch):
    _, tcfg, _, tparams = tiny
    with pytest.raises(ValueError, match="slab"):
        PagedLLMEngine(tparams, tcfg, mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="divide"):
        # bt = gcd(buckets) = 8 does not divide max_len
        PagedLLMEngine(tparams, tcfg, n_slots=2, max_len=36, buckets=(8, 16),
                       device="cpu")
    with pytest.raises(ValueError, match="pool_blocks"):
        # fewer blocks than one max-length request needs
        PagedLLMEngine(tparams, tcfg, n_slots=2, max_len=32, buckets=(8,),
                       pool_blocks=3, device="cpu")
    with pytest.raises(ValueError, match="attention span"):
        # bt 48 divides max_len 144 but not the span 128
        PagedLLMEngine(tparams, tcfg, n_slots=2, max_len=144, buckets=(48,),
                       device="cpu")
    with pytest.raises(TypeError):
        PagedLLMEngine(tparams, tcfg, prefix_cache=True, device="cpu",
                       **ENGINE)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PagedLLMEngine(tparams, tcfg, **ENGINE)


def test_seeded_sampling_slab_equals_paged(tiny):
    _, tcfg, _, tparams = tiny
    kw = dict(temperature=0.9, top_k=20, top_p=0.9)
    slab = _run(LLMEngine(tparams, tcfg, sample_seed=7, device="cpu",
                          **ENGINE), PROMPTS, NEW, **kw)
    paged = _run(PagedLLMEngine(tparams, tcfg, sample_seed=7, device="cpu",
                                **ENGINE), PROMPTS, NEW, **kw)
    assert paged == slab
    greedy = _run(LLMEngine(tparams, tcfg, device="cpu", **ENGINE), PROMPTS,
                  NEW)
    assert slab != greedy                    # the sampler really sampled
