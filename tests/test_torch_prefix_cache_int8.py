"""The port's radix prefix cache with int8 weights and int8 KV on the CPU
against the JAX `LLMEngine(prefix_cache=True)`: the traffic of
test_torch_prefix_cache.py in the slab and the paged engine (tokens,
cached_tokens, prefix metrics, continuation waves, and the cold engine's
tokens); and the int8 store: int8 rows and f32 scales in tensors of
their own per block, and a hit's slot holding, in its prefix rows, the
bytes the JAX continuation writes there."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.models import llama as jllama
from kubeflow_tpu_torch.serving.llm import LLMEngine
from test_torch_prefix_cache import (ENGINE, SHARED, jax_traffic,  # noqa
                                     tiny, traffic_equals_jax)


@pytest.fixture(scope="module")
def jax_run(tiny):
    return jax_traffic(tiny, "int8")


@pytest.mark.parametrize("paged", [False, True], ids=["slab", "paged"])
def test_traffic_equals_jax_engine_int8(tiny, jax_run, paged):
    traffic_equals_jax(tiny, jax_run, paged, "int8")


def test_int8_store_keeps_int8_blocks_and_the_jax_slot_bytes(tiny):
    """Each stored block is int8 rows plus f32 scales in tensors of its
    own (their bytes are the block's bytes); the slot a hit lands in
    holds, in its prefix rows, what the JAX continuation writes there:
    quantize(dequantize(stored block))."""
    _, tcfg, _, tparams = tiny
    eng = LLMEngine(tparams, tcfg, quantize="int8", kv_quantize="int8",
                    prefix_cache=True, device="cpu", **ENGINE)
    eng.generate(SHARED + [5], 4)
    payloads = eng.kvcache.payloads()
    assert len(payloads) == 2
    c = eng.cache
    block_bytes = sum(c[n][:, :1, :8].numel() * c[n].element_size()
                      for n in ("k", "k_s", "v", "v_s"))
    for kq, ks, vq, vs in payloads:
        assert kq.dtype == vq.dtype == torch.int8
        assert ks.dtype == vs.dtype == torch.float32
        assert kq.shape == (tcfg.n_layers, 1, 8, tcfg.n_kv_heads,
                            tcfg.head_dim)
    storages = {a.untyped_storage().data_ptr(): a.untyped_storage().nbytes()
                for b in payloads for a in b}
    assert len(storages) == 8
    assert sum(storages.values()) == 2 * block_bytes
    # the hit lands in a slot never written before: slot 0 is busy
    busy = eng.submit([9] * 5, 40)
    eng.step()
    hit = eng.submit(SHARED + [7, 8], 2)
    eng.step()
    slot = next(s for s in range(ENGINE["n_slots"])
                if eng.scheduler.slot_request(s) == hit)
    assert slot != 0 and eng.cached_tokens(hit) == 16
    chain = eng.kvcache.match(SHARED, max_tokens=16, namespace=0)
    for j, name in enumerate(("k", "k_s", "v", "v_s")):
        stored = torch.cat([b[j] for b in chain.payloads], dim=2)[:, 0]
        assert torch.equal(c[name][:, slot, :16], stored)
    eng.kvcache.release(chain)
    for q_name, s_name in (("k", "k_s"), ("v", "v_s")):
        q = c[q_name][:, slot, :16].numpy()
        s = c[s_name][:, slot, :16].numpy()
        jq, js = jllama.quantize_kv(
            jllama.dequantize_kv(jnp.asarray(q), jnp.asarray(s),
                                 jnp.float32))
        assert np.array_equal(np.asarray(jq), q)
        assert np.array_equal(np.asarray(js), s)
    eng.run_until_idle()
    assert eng.is_done(busy) and eng.is_done(hit)
