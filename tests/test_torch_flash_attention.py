"""The training attention of the port (ops/flash_attention.py) against the
JAX package: the plain forward and backward — the versions the CUDA
kernels B1-B3 are held to on the card — against the TPU kernels run by
the Pallas interpreter (flash_fwd_stats, flash_bwd_grads); flash_attention's
gradients against jax.grad through the JAX flash_attention; mha with
segment_ids against the JAX mha. Inputs come from a numpy seed, in f32."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kubeflow_tpu.ops import attention as jattn
from kubeflow_tpu.ops import flash_attention as jfa
from kubeflow_tpu.ops import flash_pallas as jfp
from kubeflow_tpu_torch.ops import attention as tattn
from kubeflow_tpu_torch.ops import flash_attention as tfa

torch.set_num_threads(2)

# f32 throughout: the one-pass plain version and the TPU kernel's online
# softmax over 128-key blocks differ by f32 rounding only
TOL = 2e-5
# gradients through the JAX blockwise path vs the port's explicit
# backward: the tolerance of the JAX package's own test_pallas_flash_grad
GRAD_TOL = 5e-4


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Each test runs torch on one intra-op thread: in a process that also
    runs XLA, the second thread sometimes computed its share of a batched
    product in another floating-point state (7.7e-5 off on every row of
    batch 1, from one process to the next), which made these f32
    comparisons flaky."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def interpret():
    saved = jfp.FORCE_INTERPRET
    jfp.FORCE_INTERPRET = True
    yield
    jfp.FORCE_INTERPRET = saved


def _qkvo(seed, b, s, h, d):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, s, h, d)).astype(np.float32)
            for _ in range(4)]


def _segments(b, s):
    """Two documents per row, the boundary inside a 128-row block."""
    seg = np.zeros((b, s), np.int32)
    for i in range(b):
        seg[i, s // 2 + 9 * (i + 1):] = 1
    return seg


def _bh(x):
    """[B, S, H, D] numpy -> the JAX kernels' [B*H, S, D]."""
    b, s, h, d = x.shape
    return jnp.asarray(x.transpose(0, 2, 1, 3).reshape(b * h, s, d))


def _bshd(x, b, h):
    """[B*H, S, D] -> numpy [B, S, H, D]."""
    x = np.asarray(x)
    return x.reshape(b, h, *x.shape[1:]).transpose(0, 2, 1, 3)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("s", [128, 200])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("segmented", [False, True])
def test_plain_fwd_matches_pallas_kernel(interpret, s, causal, segmented):
    b, h, d = 2, 2, 32
    q, k, v, _ = _qkvo(s + causal + 2 * segmented, b, s, h, d)
    seg = _segments(b, s) if segmented else None
    scale = 1.0 / d ** 0.5
    jseg = None if seg is None else jnp.asarray(seg)
    o_ref, lse_ref = jfp.flash_fwd_stats(
        _bh(q), _bh(k), _bh(v), jseg, jseg, causal=causal, scale=scale,
        interpret=True, block_q=128, block_kv=128)
    o, lse = tfa.plain_fwd(_t(q), _t(k), _t(v), causal=causal,
                           segment_ids=None if seg is None else _t(seg))
    np.testing.assert_allclose(o.numpy(), _bshd(o_ref, b, h), atol=TOL,
                               rtol=TOL)
    np.testing.assert_allclose(
        lse.numpy(), np.asarray(lse_ref)[:, :s].reshape(b, h, s), atol=TOL,
        rtol=TOL)


# (s, head dim): the B2/B3 tile edges too — 320 rows hold a partial
# 128-key block and 64-row tiles past it, and 64 is the kernels' other
# head dim; the head-dim-32 cases keep their old ids
BWD_SHAPES = [(128, 32), (200, 32), (320, 32), (128, 64), (200, 64),
              (320, 64)]


@pytest.mark.parametrize(
    "s,d", BWD_SHAPES,
    ids=[str(s) if d == 32 else f"{s}-d{d}" for s, d in BWD_SHAPES])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("segmented", [False, True])
def test_plain_bwd_matches_pallas_kernels(interpret, s, d, causal,
                                          segmented):
    b, h = 1, 2
    q, k, v, do = _qkvo(10 + s + causal + 2 * segmented, b, s, h, d)
    seg = _segments(b, s) if segmented else None
    jseg = None if seg is None else jnp.asarray(seg)
    scale = 1.0 / d ** 0.5
    kw = dict(causal=causal, scale=scale, interpret=True, block_q=128,
              block_kv=128)
    o, lse = jfp.flash_fwd_stats(_bh(q), _bh(k), _bh(v), jseg, jseg, **kw)
    refs = jfp.flash_bwd_grads(_bh(q), _bh(k), _bh(v), jseg, jseg, o, lse,
                               _bh(do), **kw)
    o_t = _t(_bshd(o, b, h))
    lse_t = _t(np.asarray(lse)[:, :s].reshape(b, h, s))
    got = tfa.plain_bwd(_t(q), _t(k), _t(v), o_t, lse_t, _t(do),
                        causal=causal,
                        segment_ids=None if seg is None else _t(seg))
    for name, g, r in zip(("dq", "dk", "dv"), got, refs):
        np.testing.assert_allclose(g.numpy(), _bshd(r, b, h), atol=TOL,
                                   rtol=TOL, err_msg=name)


def test_bwd_wrappers_split_like_the_kernels():
    """flash_bwd on CPU tensors is row_delta + the dq and dk/dv plain
    versions, the same decomposition as B2 and B3."""
    b, s, h, d = 1, 96, 2, 16
    q, k, v, do = (_t(x) for x in _qkvo(3, b, s, h, d))
    o, lse = tfa.flash_fwd(q, k, v)
    dq, dk, dv = tfa.flash_bwd(q, k, v, o, lse, do)
    delta = tfa.row_delta(o, do)
    assert delta.shape == (b, h, s)
    torch.testing.assert_close(dq, tfa.flash_bwd_dq(q, k, v, do, lse, delta),
                               rtol=0, atol=0)
    dk2, dv2 = tfa.flash_bwd_dkv(q, k, v, do, lse, delta)
    torch.testing.assert_close(dk, dk2, rtol=0, atol=0)
    torch.testing.assert_close(dv, dv2, rtol=0, atol=0)


@pytest.mark.parametrize("segmented", [False, True])
def test_flash_attention_grads_match_jax_gqa(segmented):
    b, s, h, hkv, d = 2, 96, 4, 2, 16
    rng = np.random.default_rng(21 + segmented)
    q = rng.normal(size=(b, s, h, d)).astype(np.float32)
    k = rng.normal(size=(b, s, hkv, d)).astype(np.float32)
    v = rng.normal(size=(b, s, hkv, d)).astype(np.float32)
    seg = _segments(b, s) if segmented else None

    def jloss(q, k, v):
        out = jfa.flash_attention(q, k, v, causal=True,
                                  segment_ids=None if seg is None
                                  else jnp.asarray(seg))
        return jnp.sum(out ** 2)

    j_out = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=True,
                                segment_ids=None if seg is None
                                else jnp.asarray(seg))
    j_grads = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (_t(x).requires_grad_() for x in (q, k, v))
    out = tfa.flash_attention(tq, tk, tv, causal=True,
                              segment_ids=None if seg is None else _t(seg))
    (out ** 2).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(j_out),
                               atol=GRAD_TOL, rtol=GRAD_TOL)
    for name, g, r in zip(("dq", "dk", "dv"), (tq.grad, tk.grad, tv.grad),
                          j_grads):
        assert g.shape == r.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=GRAD_TOL,
                                   rtol=GRAD_TOL, err_msg=name)


def test_flash_attention_q_offset_is_forward_only():
    """A continuation chunk (q_offset > 0) runs the forward alone and
    matches the JAX blockwise path at that offset."""
    b, sk, sq, h, d, off = 1, 160, 48, 2, 16, 112
    rng = np.random.default_rng(5)
    q = rng.normal(size=(b, sq, h, d)).astype(np.float32)
    k, v = (rng.normal(size=(b, sk, h, d)).astype(np.float32)
            for _ in range(2))
    seg = _segments(b, sk)
    ref = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              causal=True, q_offset=off,
                              segment_ids=jnp.asarray(seg))
    tq = _t(q).requires_grad_()
    out = tfa.flash_attention(tq, _t(k), _t(v), causal=True, q_offset=off,
                              segment_ids=_t(seg))
    assert not out.requires_grad
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=TOL,
                               rtol=TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_mha_segment_ids_match_jax(causal):
    b, s, h, hkv, d = 2, 40, 4, 2, 8
    rng = np.random.default_rng(7)
    q = rng.normal(size=(b, s, h, d)).astype(np.float32)
    k = rng.normal(size=(b, s, hkv, d)).astype(np.float32)
    v = rng.normal(size=(b, s, hkv, d)).astype(np.float32)
    seg = _segments(b, s)
    ref = jattn.mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    causal=causal, segment_ids=jnp.asarray(seg))
    got = tattn.mha(_t(q), _t(k), _t(v), causal=causal,
                    segment_ids=_t(seg))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=TOL,
                               rtol=TOL)


def test_mha_segment_ids_require_self_attention():
    q = torch.zeros(1, 4, 2, 8)
    k = torch.zeros(1, 6, 2, 8)
    with pytest.raises(ValueError, match="Sq == Sk"):
        tattn.mha(q, k, k, segment_ids=torch.zeros(1, 6, dtype=torch.int32))


def test_kernel_wrappers_reject_other_devices():
    x = torch.zeros(1, 4, 2, 64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tfa.flash_fwd(x, x, x)
