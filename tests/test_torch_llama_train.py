"""The port's training forward (models/llama.py: apply, loss_fn with its
chunked cross-entropy, the remat policies, flops_per_token) against the
JAX package on the tiny config in f32, with the same parameters (the JAX
init converted by from_jax_params) and the same numpy tokens. Attention
runs the port's plain flash forward/backward on the CPU and the JAX
blockwise path."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kubeflow_tpu.models import llama as jllama
from kubeflow_tpu_torch.models import interop
from kubeflow_tpu_torch.models import llama as tllama
from kubeflow_tpu_torch.training.trainer import leaves

torch.set_num_threads(2)

# f32 on both sides; sums in another order (blockwise vs one-pass
# softmax, XLA vs ATen reductions)
LOSS_RTOL = 1e-5
# per grad leaf, relative to the leaf's largest value
GRAD_TOL = 1e-4
S = 64


def _jcfg(**kw):
    return dataclasses.replace(jllama.LlamaConfig.tiny(), dtype=jnp.float32,
                               **kw)


def _tcfg(jcfg, **kw):
    fields = ("vocab_size", "d_model", "n_layers", "n_heads", "n_kv_heads",
              "d_ff", "max_seq_len", "rope_theta", "norm_eps", "remat",
              "remat_policy", "ce_chunk")
    base = {f: getattr(jcfg, f) for f in fields}
    base.update(dtype=torch.float32, param_dtype=torch.float32)
    base.update(kw)
    return tllama.LlamaConfig(**base)


@pytest.fixture(scope="module")
def model():
    jcfg = _jcfg()
    jparams = jllama.init(jax.random.key(0), jcfg)
    np_params = jax.tree.map(np.asarray, jparams)
    return jcfg, jparams, np_params


def _params(np_params, tcfg):
    params = interop.from_jax_params(np_params, tcfg, device="cpu")
    for p in leaves(params):
        p.requires_grad_(True)
    return params


def _batch(seed, segmented, masked, vocab=512, b=2):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, vocab, (b, S)).astype(np.int32)}
    if segmented:
        seg = np.zeros((b, S), np.int32)
        seg[0, 23:] = 1
        seg[1, 40:] = 1
        batch["segment_ids"] = seg
    if masked:
        batch["loss_mask"] = (rng.random((b, S)) < 0.7).astype(np.float32)
    return batch


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def test_from_jax_params_training_tree(model):
    jcfg, _, np_params = model
    params = interop.from_jax_params(np_params, _tcfg(jcfg), device="cpu")
    flat_j = jax.tree_util.tree_flatten_with_path(np_params)[0]
    assert len(flat_j) == len(leaves(params)) == 12
    for path, leaf in flat_j:
        got = params
        for p in path:
            got = got[p.key]
        assert isinstance(got, torch.Tensor), path   # no {"q", "s"}
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), leaf)


@pytest.mark.parametrize("segmented", [False, True])
def test_apply_logits_match_jax(model, segmented):
    jcfg, jparams, np_params = model
    tcfg = _tcfg(jcfg)
    batch = _batch(1, segmented, False)
    seg = batch.get("segment_ids")
    ref = jllama.apply(jparams, jnp.asarray(batch["tokens"]), jcfg,
                       segment_ids=None if seg is None else jnp.asarray(seg))
    with torch.no_grad():
        got = tllama.apply(_params(np_params, tcfg),
                           torch.from_numpy(batch["tokens"]), tcfg,
                           segment_ids=None if seg is None
                           else torch.from_numpy(seg))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4,
                               rtol=1e-4)


def _jax_loss_and_grads(jparams, jcfg, batch):
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (loss, aux), grads = jax.value_and_grad(
        lambda p: jllama.loss_fn(p, jb, jcfg), has_aux=True)(jparams)
    return float(loss), float(aux["tokens"]), grads


def _torch_loss_and_grads(params, tcfg, batch):
    loss, aux = tllama.loss_fn(params, _torch_batch(batch), tcfg)
    grads = torch.autograd.grad(loss, leaves(params))
    return loss.item(), aux["tokens"].item(), grads


def _assert_grads_close(got, ref):
    flat = [np.asarray(x) for x in jax.tree.leaves(ref)]   # sorted keys
    assert len(got) == len(flat)
    for g, r in zip(got, flat):
        scale = max(float(np.abs(r).max()), 1e-12)
        np.testing.assert_allclose(g.numpy() / scale, r / scale,
                                   atol=GRAD_TOL, rtol=0)


@pytest.mark.parametrize("segmented,masked",
                         [(False, False), (True, False), (False, True),
                          (True, True)])
def test_loss_and_grads_match_jax(model, segmented, masked):
    jcfg, jparams, np_params = model
    tcfg = _tcfg(jcfg)
    batch = _batch(2 + 2 * segmented + masked, segmented, masked)
    j_loss, j_tok, j_grads = _jax_loss_and_grads(jparams, jcfg, batch)
    t_loss, t_tok, t_grads = _torch_loss_and_grads(
        _params(np_params, tcfg), tcfg, batch)
    assert t_tok == j_tok
    np.testing.assert_allclose(t_loss, j_loss, rtol=LOSS_RTOL)
    _assert_grads_close(t_grads, j_grads)


@pytest.mark.parametrize("masked", [False, True])
def test_chunked_ce_equals_plain_loss(model, masked):
    jcfg, jparams, np_params = model
    batch = _batch(7, True, masked)
    plain = _torch_loss_and_grads(_params(np_params, _tcfg(jcfg)),
                                  _tcfg(jcfg), batch)
    chunked = _torch_loss_and_grads(
        _params(np_params, _tcfg(jcfg, ce_chunk=16)),
        _tcfg(jcfg, ce_chunk=16), batch)
    np.testing.assert_allclose(chunked[0], plain[0], rtol=LOSS_RTOL)
    assert chunked[1] == plain[1]
    for a, b in zip(chunked[2], plain[2]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    # and against the JAX chunked path at the same chunk
    j_loss, _, j_grads = _jax_loss_and_grads(
        jparams, dataclasses.replace(jcfg, ce_chunk=16), batch)
    np.testing.assert_allclose(chunked[0], j_loss, rtol=LOSS_RTOL)
    _assert_grads_close(chunked[2], j_grads)


def test_chunked_ce_rejects_ragged_chunks(model):
    jcfg, _, np_params = model
    tcfg = _tcfg(jcfg, ce_chunk=24)
    with pytest.raises(ValueError, match="ce_chunk"):
        tllama.loss_fn(_params(np_params, tcfg),
                       _torch_batch(_batch(1, False, False)), tcfg)


def test_remat_policies_agree(model):
    jcfg, _, np_params = model
    batch = _batch(9, True, True)
    results = {}
    for remat, policy in ((False, "minimal"), (True, "none"),
                          (True, "minimal"), (True, "full")):
        tcfg = _tcfg(jcfg, remat=remat, remat_policy=policy)
        results[remat, policy] = _torch_loss_and_grads(
            _params(np_params, tcfg), tcfg, batch)
    base = results[False, "minimal"]
    for key, (loss, tok, grads) in results.items():
        assert loss == base[0] and tok == base[1], key
        for a, b in zip(grads, base[2]):
            torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_unknown_remat_policy_rejected():
    with pytest.raises(ValueError, match="remat_policy"):
        tllama.LlamaConfig(remat_policy="dots")


def test_dtype_names_from_a_config():
    cfg = tllama.LlamaConfig(dtype="float32", param_dtype="bfloat16")
    assert cfg.dtype == torch.float32 and cfg.param_dtype == torch.bfloat16


@pytest.mark.parametrize("seq", [128, 4096])
def test_flops_per_token_matches_jax(seq):
    jcfg = dataclasses.replace(jllama.LlamaConfig.llama3_8b(), n_layers=4)
    tcfg = dataclasses.replace(tllama.LlamaConfig.llama3_8b(), n_layers=4)
    assert tllama.flops_per_token(tcfg, seq) == jllama.flops_per_token(
        jcfg, seq)
    assert tllama.flops_per_token(tllama.LlamaConfig.tiny(), seq) == \
        jllama.flops_per_token(jllama.LlamaConfig.tiny(), seq)
