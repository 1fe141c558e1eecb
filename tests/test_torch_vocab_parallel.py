"""The vocabulary split's group-free pieces (parallel/sharding.py
`vocab_shard_stats` and `vocab_shard_grad`, models/llama.py
`embed_partial`) against the JAX loss's log_softmax and its gradient
and the JAX embedding lookup, at T = 2 and 4 column (row) blocks of the
vocabulary, the blocks' statistics combined by hand as
`vocab_parallel_ce`'s all-reduces combine them (the max, then the
rescaled sums of exponentials and the target logits summed)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kubeflow_tpu_torch.models import llama as tllama
from kubeflow_tpu_torch.parallel import sharding

V, D, N = 512, 16, 64
# f32 against XLA: the blocks' sums of exponentials rescaled to the
# common max (one more rounding), summed in another order
RTOL = 1e-6


def _inputs():
    rng = np.random.default_rng(3)
    logits = (rng.normal(size=(N, V)) * 3).astype(np.float32)
    targets = rng.integers(0, V, (N,)).astype(np.int32)
    g = rng.random(N).astype(np.float32)
    return logits, targets, g


def _jax_loss(logits, targets, g):
    """The JAX loss_fn's per-token loss (-log_softmax at the target) and
    the gradient of its g-weighted sum."""
    def loss(x):
        logp = jax.nn.log_softmax(x, axis=-1)
        return -jnp.take_along_axis(logp, targets[:, None], axis=-1)[:, 0]
    tl, vjp = jax.vjp(loss, jnp.asarray(logits))
    return np.asarray(tl), np.asarray(vjp(jnp.asarray(g))[0])


@pytest.mark.parametrize("t", [2, 4])
def test_vocab_shard_stats_and_grad_combine_to_jax(t):
    """Each block's statistics, combined, give JAX's per-token loss; each
    block's gradient from the combined max and sum is JAX's gradient on
    those columns."""
    logits, targets, g = _inputs()
    want, want_grad = _jax_loss(logits, targets, g)
    x, tg, gt = (torch.from_numpy(a) for a in (logits, targets, g))
    vr = V // t
    blocks = x.split(vr, dim=-1)
    parts = [sharding.vocab_shard_stats(c, tg.long(), r * vr)
             for r, c in enumerate(blocks)]
    top = torch.stack([m for m, _, _ in parts]).amax(dim=0)
    total = sum(s * torch.exp(m - top) for m, s, _ in parts)
    got = torch.log(total) + top - sum(x for _, _, x in parts)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL)
    grad = torch.cat([
        sharding.vocab_shard_grad(c, tg.long(), r * vr, top, total, gt)
        for r, c in enumerate(blocks)], dim=-1)
    np.testing.assert_allclose(grad.numpy(), want_grad, rtol=RTOL,
                               atol=RTOL * np.abs(want_grad).max())


def test_one_block_equals_the_whole_vocabulary():
    """The group-free statistics over the whole vocabulary (start 0) are
    the loss itself: vocab_parallel_ce without a group is JAX's."""
    logits, targets, g = _inputs()
    want, want_grad = _jax_loss(logits, targets, g)
    x = torch.from_numpy(logits).requires_grad_()
    got = sharding.vocab_parallel_ce(x, torch.from_numpy(targets), 0, None)
    got_grad, = torch.autograd.grad((got * torch.from_numpy(g)).sum(), x)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=RTOL)
    np.testing.assert_allclose(got_grad.numpy(), want_grad, rtol=RTOL,
                               atol=RTOL * np.abs(want_grad).max())


@pytest.mark.parametrize("t", [2, 4])
def test_embed_partials_sum_to_the_jax_lookup(t):
    """The row blocks' masked lookups sum to JAX's `embed[tokens]` bit
    for bit (one block holds each row), and the table's gradient through
    them is JAX's."""
    rng = np.random.default_rng(4)
    table = rng.normal(size=(V, D)).astype(np.float32)
    tokens = rng.integers(0, V, (4, 16)).astype(np.int32)
    cot = rng.normal(size=(4, 16, D)).astype(np.float32)
    want, vjp = jax.vjp(lambda e: e[jnp.asarray(tokens)], jnp.asarray(table))
    want_grad = np.asarray(vjp(jnp.asarray(cot))[0])
    w = torch.from_numpy(table).requires_grad_()
    tok = torch.from_numpy(tokens).long()
    vr = V // t
    got = sum(tllama.embed_partial(blk, tok, r * vr)
              for r, blk in enumerate(w.split(vr, dim=0)))
    assert np.array_equal(got.detach().numpy(), np.asarray(want))
    got_grad, = torch.autograd.grad((got * torch.from_numpy(cot)).sum(), w)
    np.testing.assert_allclose(got_grad.numpy(), want_grad, rtol=RTOL,
                               atol=1e-6)
