"""K3's paged mode in the port on the CPU against the JAX package: the plain
version (the port's `flash_prefill_attention(..., tables=)` on CPU
tensors) against the JAX TPU kernel in interpret mode and against the JAX
XLA gather twin (`llama.prefill_attention(impl="xla", tables=)`), over a
shuffled table into a pool larger than the batch needs whose unreferenced
blocks hold large finite junk; the port's `llama.prefill_attention(
tables=)` against its slab call on the gathered keys; the paged
validator; and the paged launch counter."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.models import llama as jllama
from kubeflow_tpu.ops import flash_prefill as jfp
from kubeflow_tpu_torch.models import llama as tllama
from kubeflow_tpu_torch.ops import _build
from kubeflow_tpu_torch.ops import flash_decode as tfd
from kubeflow_tpu_torch.ops import flash_prefill as tfp

torch.set_num_threads(2)

# f32 attention: online softmax (JAX kernel) vs one-pass softmax (plain
# version) differ by f32 rounding only (tests/test_torch_kernel_refs.py)
ATOL, RTOL = 2e-5, 2e-5
NH, NKV, HD, S = 8, 2, 16, 20     # GQA 4:1, a 20-row chunk
B = 2


def _cfg():
    return jllama.LlamaConfig(vocab_size=64, d_model=NH * HD, n_layers=1,
                              n_heads=NH, n_kv_heads=NKV, d_ff=32,
                              max_seq_len=512, dtype=jnp.float32)


def _pool(rng, bt, nb, quantized):
    """A pool of 3 * B * nb + 1 blocks, block 0 and every block no table
    names filled with large finite junk, and tables [B, nb] naming a
    shuffled set of the others. Returns numpy (k, v, ks, vs, tables);
    scales None for f32."""
    n_pool = 3 * B * nb + 1
    x = [rng.normal(size=(n_pool, bt, NKV, HD)).astype(np.float32)
         for _ in range(2)]
    perm = rng.permutation(np.arange(1, n_pool))
    tables = perm[:B * nb].reshape(B, nb).astype(np.int32)
    unused = np.setdiff1d(np.arange(n_pool), tables)
    assert 0 in unused and len(unused) > B * nb
    out = []
    for a in x:
        a[unused] *= 1e4
        if quantized:
            q, s = jllama.quantize_kv(jnp.asarray(a))
            q, s = np.array(q), np.array(s)
            s[unused] = 1e4
            out += [q, s]
        else:
            out += [a, None]
    k, ks, v, vs = out
    return k, v, ks, vs, tables


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


# every pair of (KV type, block size, q_offset) values once: each JAX
# program compiles anew, so the full product would double the file's time
@pytest.mark.parametrize("quantized,bt,q_offset", [
    (False, 8, 0), (False, 16, 24), (True, 8, 24), (True, 16, 0)])
def test_paged_plain_matches_jax_kernel_and_gather_twin(quantized, bt,
                                                        q_offset):
    """The chunk's rows see keys up to q_offset + i of T = nb * bt, T past
    the deepest row, so the last blocks are partly masked."""
    rng = np.random.default_rng(100 + 10 * bt + q_offset)
    nb = -(-(q_offset + S + 5) // bt)
    k, v, ks, vs, tables = _pool(rng, bt, nb, quantized)
    q = rng.normal(size=(B, S, NH, HD)).astype(np.float32)
    got = tfp.flash_prefill_attention(
        _t(q), _t(k), _t(v), q_offset=q_offset, k_scale=_t(ks),
        v_scale=_t(vs), tables=_t(tables))
    assert got.shape == (B, S, NH, HD)
    assert torch.isfinite(got).all()
    kern = jfp.flash_prefill_attention(
        _j(q), _j(k), _j(v), q_offset=q_offset, k_scale=_j(ks),
        v_scale=_j(vs), tables=_j(tables), interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(kern), atol=ATOL,
                               rtol=RTOL)
    xla = jllama.prefill_attention(
        _cfg(), _j(q), _j(k), _j(v), _j(ks), _j(vs), q_offset=q_offset,
        impl="xla", tables=_j(tables))
    np.testing.assert_allclose(got.numpy(), np.asarray(xla), atol=ATOL,
                               rtol=RTOL)


@pytest.mark.parametrize("quantized", [False, True])
def test_llama_prefill_attention_paged_equals_slab_on_gathered_keys(
        quantized):
    rng = np.random.default_rng(7)
    bt, nb, q_offset = 8, 6, 16
    k, v, ks, vs, tables = _pool(rng, bt, nb, quantized)
    q = _t(rng.normal(size=(B, S, NH, HD)).astype(np.float32))
    cfg = tllama.LlamaConfig(vocab_size=64, d_model=NH * HD, n_layers=1,
                             n_heads=NH, n_kv_heads=NKV, d_ff=32,
                             dtype=torch.float32)
    kv = [_t(x) for x in (k, v, ks, vs)]
    paged = tllama.prefill_attention(cfg, q, *kv, q_offset=q_offset,
                                     tables=_t(tables))
    slab = tllama.prefill_attention(
        cfg, q, *tfd.gather_pages(_t(tables), *kv), q_offset=q_offset)
    assert torch.equal(paged, slab)


def _args(bt=16, nb=4, quantized=True, n_pool=9):
    q = torch.zeros(B, S, NH, 64, dtype=torch.bfloat16)
    dt = torch.int8 if quantized else torch.bfloat16
    k = torch.zeros(n_pool, bt, NKV, 64, dtype=dt)
    sc = torch.zeros(n_pool, bt, NKV) if quantized else None
    tables = torch.zeros(B, nb, dtype=torch.int32)
    return q, k, k.clone(), sc, None if sc is None else sc.clone(), tables


def test_validator_takes_the_producers_block_sizes():
    for bt in (8, 16, 32, 64, 128, 256):
        for quantized in (False, True):
            assert tfp.check_pages(*_args(bt=bt, quantized=quantized)) == (
                quantized, bt, 4)
    for bt in (4, 12, 24, 48, 96, 192):
        with pytest.raises(ValueError, match="block_tokens"):
            tfp.check_pages(*_args(bt=bt))


def _bad_tables(args):
    q, k, v, ks, vs, tables = args
    return [(q, k, v, ks, vs, bad) for bad in (
        tables.long(), tables.float(), tables[:1], tables[0],
        torch.zeros(B, 0, dtype=torch.int32),
        torch.zeros(B, 8, dtype=torch.int32)[:, ::2])]


def _bad_pool(args):
    q, k, v, ks, vs, tables = args
    return [(q, k[:, :, :, :32], v, ks, vs, tables),
            (q, k, v[:4], ks, vs, tables)]


def _bad_layout(args):
    q, k, v, ks, vs, tables = args
    return [(q, k[::2], v[::2], ks[::2], vs[::2], tables)]


def _bad_scales(args):
    q, k, v, ks, vs, tables = args
    return [(q, k, v, ks[:, :8], vs[:, :8], tables),
            (q, k, v, None, None, tables), (q, k, v, ks, None, tables)]


@pytest.mark.parametrize("make,match", [
    (_bad_tables, "tables"), (_bad_pool, "pool"),
    (_bad_layout, "contiguous"), (_bad_scales, "scales|k_scale")],
    ids=["tables", "pool", "layout", "scales"])
def test_validator_raises_on_bad_tables_and_pools(make, match):
    for args in make(_args()):
        with pytest.raises(ValueError, match=match):
            tfp.check_pages(*args)


def test_validator_raises_on_bad_types():
    q, k, v, ks, vs, tables = _args()
    for args in ((q.float(), k, v, ks, vs, tables),
                 (q, k.to(torch.bfloat16), v, ks, vs, tables)):
        with pytest.raises(TypeError):
            tfp.check_pages(*args)


def test_paged_launches_have_their_own_counter_and_plain_runs_count_none():
    assert "flash_prefill_paged" in _build.KERNELS
    _build.reset_launches()
    q, k, v, ks, vs, tables = _args()
    out = tfp.flash_prefill_attention(q, k, v, k_scale=ks, v_scale=vs,
                                      tables=tables, q_offset=40)
    assert out.shape == q.shape and out.dtype == torch.bfloat16
    assert _build.LAUNCHES == {name: 0 for name in _build.KERNELS}
    assert all(not by_shape for by_shape in _build.SHAPES.values())
    with pytest.raises(ValueError):
        tfp.flash_prefill_attention(q.to("meta"), k, v, tables=tables)
