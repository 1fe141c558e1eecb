"""The port's optimizer (training/trainer.py `make_optimizer`) against
the optax chain the JAX trainer's `make_optimizer` builds — clip by global
norm, then adamw / adam / sgd(momentum 0.9) scaled by the schedule —
over 5 updates of a fixed param tree, and the schedules against optax's."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from kubeflow_tpu.training import trainer as jtrainer
from kubeflow_tpu_torch.training import trainer as ttrainer

torch.set_num_threads(2)


def _tree(rng, scale):
    return {"a": (rng.normal(size=(4, 3)) * scale).astype(np.float32),
            "b": {"c": (rng.normal(size=(5,)) * scale).astype(np.float32),
                  "d": (rng.normal(size=(2, 2)) * scale).astype(np.float32)}}


@pytest.mark.parametrize("name", ["adamw", "adam", "sgd"])
@pytest.mark.parametrize("schedule", ["cosine", "linear", "constant"])
@pytest.mark.parametrize("mu_dtype", [None, "bfloat16"])
@pytest.mark.parametrize("grad_scale", [0.05, 3.0])   # clip not hit / hit
def test_optimizer_matches_optax(name, schedule, mu_dtype, grad_scale):
    kw = dict(name=name, learning_rate=0.1, warmup_steps=2, total_steps=6,
              weight_decay=0.1, grad_clip=1.0, schedule=schedule,
              mu_dtype=mu_dtype)
    rng = np.random.default_rng(1)
    params = _tree(rng, 1.0)
    grads = [_tree(rng, grad_scale) for _ in range(5)]
    opt = jtrainer.make_optimizer(jtrainer.OptimizerConfig(**kw))
    jp = jax.tree.map(jnp.asarray, params)
    jstate = opt.init(jp)
    topt = ttrainer.make_optimizer(ttrainer.OptimizerConfig(**kw))
    tp = ttrainer.leaves(jax.tree.map(lambda x: torch.from_numpy(x.copy()),
                                      params))
    tstate = topt.init(tp)
    for g in grads:
        upd, jstate = opt.update(jax.tree.map(jnp.asarray, g), jstate, jp)
        jp = optax.apply_updates(jp, upd)
        topt.update([torch.from_numpy(x) for x in jax.tree.leaves(g)],
                    tstate, tp)
        for t, j in zip(tp, jax.tree.leaves(jp)):
            # f32 arithmetic in the same order; the schedule is evaluated
            # in double here and in f32 by optax
            np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6,
                                       atol=1e-7)
    if mu_dtype and name != "sgd":
        assert all(m.dtype == torch.bfloat16 for m in tstate["mu"])
        assert all(n.dtype == torch.float32 for n in tstate["nu"])


def test_first_warmup_step_has_zero_lr():
    sched = ttrainer.make_schedule(ttrainer.OptimizerConfig(
        learning_rate=1.0, warmup_steps=2, total_steps=10))
    ref = optax.warmup_cosine_decay_schedule(0.0, 1.0, 2, 10)
    for count in range(12):
        np.testing.assert_allclose(sched(count), float(ref(count)),
                                   atol=1e-7)
    assert sched(0) == 0.0 and sched(10) == pytest.approx(0.0, abs=1e-12)
