"""The port's radix prefix cache in both engines on the CPU against the
JAX `LLMEngine(prefix_cache=True)`: the same traffic (a shared prefix
with two tails, a multi-turn chain, a shared-prefix burst, a chunked
long prompt over a cached head) gives the JAX engine's greedy tokens,
`cached_tokens`, prefix metrics and continuation waves (slab and paged,
f32 here, int8 weights and KV in test_torch_prefix_cache_int8.py), and
the port's cold engine's tokens; the server's `usage.cached_tokens` and
tenants; the sizing and arguments."""

import dataclasses
import json
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.models import llama as jllama
from kubeflow_tpu.serving.llm import LLMEngine as JaxEngine
from kubeflow_tpu_torch.models import interop
from kubeflow_tpu_torch.models import llama as tllama
from kubeflow_tpu_torch.serving.llm import LLMEngine
from kubeflow_tpu_torch.serving.paged import PagedLLMEngine
from kubeflow_tpu_torch.serving.server import CompletionServer

torch.set_num_threads(2)

ENGINE = dict(n_slots=4, max_len=64, buckets=(8, 16, 32), decode_chunk=4)
SHARED = list(range(1, 18))          # 17 tokens: two blocks of 8 cached
PREFIX_KEYS = ("prefill_tokens_computed", "prefix_hits", "prefix_misses",
               "prefix_entries", "prefix_cache")
# what a block pool attached to the trie changes in stats()
POOL_GAUGES = ("free_blocks", "watermark_frac")


@pytest.fixture(scope="module")
def tiny():
    jcfg = dataclasses.replace(jllama.LlamaConfig.tiny(), dtype=jnp.float32)
    tcfg = dataclasses.replace(tllama.LlamaConfig.tiny(),
                               dtype=torch.float32)
    jparams = jllama.init(jax.random.key(0), jcfg)
    tparams = interop.from_jax_params(jax.tree.map(np.asarray, jparams),
                                      tcfg, device="cpu")
    return jcfg, tcfg, jparams, tparams


def _traffic(eng):
    """Greedy tokens and cached_tokens of each request, the prefix
    metrics, and the continuation waves (p, t, width) in dispatch
    order."""
    waves = []
    dispatch = eng._dispatch_prefill_cont_wave

    def recording(p, t, pairs):
        waves.append((p, t, len(pairs)))
        return dispatch(p, t, pairs)

    eng._dispatch_prefill_cont_wave = recording
    rids = {}
    # a shared prefix with two tails (a miss that banks, then a hit)
    for name, tail in (("a", [100, 101, 102]), ("b", [200, 201])):
        rids[name] = eng.submit(SHARED + tail, 8, tenant="acme")
        eng.run_until_idle()
    # a multi-turn chain: each turn resends the last one and 7 tokens
    ctx = list(range(1, 13))
    for turn in range(3):
        rids[f"turn{turn}"] = eng.submit(list(ctx), 4)
        eng.run_until_idle()
        ctx += [40 + turn + j for j in range(7)]
    # a burst of hits sharing (prefix, tail bucket): one wave
    burst = [eng.submit(SHARED + [100 + i], 4) for i in range(4)]
    eng.run_until_idle()
    rids.update({f"burst{i}": r for i, r in enumerate(burst)})
    # a chunked prompt (52 tokens > bucket 32) over the cached head
    rids["long"] = eng.submit(SHARED + list(range(300, 335)), 4)
    eng.run_until_idle()
    m = eng.metrics()
    return {"tokens": {k: eng.result(r) for k, r in rids.items()},
            "cached": {k: eng.cached_tokens(r) for k, r in rids.items()},
            "metrics": {k: m[k] for k in PREFIX_KEYS if k in m},
            "waves": waves}


def jax_traffic(tiny, quant):
    jcfg, _, jparams, _ = tiny
    return _traffic(JaxEngine(jparams, jcfg, prefer_native=False,
                              quantize=quant, kv_quantize=quant,
                              prefix_cache=True, **ENGINE))


def traffic_equals_jax(tiny, want, paged, quant):
    """The port's engine (paged or slab) and its cold twin on _traffic,
    against the JAX engine's run `want`."""
    _, tcfg, _, tparams = tiny
    cls = PagedLLMEngine if paged else LLMEngine
    eng = cls(tparams, tcfg, quantize=quant, kv_quantize=quant,
              prefix_cache=True, device="cpu", **ENGINE)
    got = _traffic(eng)
    assert got["tokens"] == want["tokens"]
    assert got["cached"] == want["cached"]
    assert got["waves"] == want["waves"]
    # the burst's four hits went out as one wave at p = 16
    assert (16, 8, 4) in got["waves"]
    assert [got["cached"][f"turn{i}"] for i in range(3)] == [8, 8, 16]
    assert got["cached"]["long"] == 16
    if paged:
        for m in (got["metrics"]["prefix_cache"],
                  want["metrics"]["prefix_cache"]):
            for key in POOL_GAUGES:
                m.pop(key)
        pool = eng.metrics()["kv_pool"]
        # at idle the pool holds only what the trie banked
        assert pool["used_blocks"] == eng.metrics()["prefix_entries"]
        eng._pool.check_invariants()
    assert got["metrics"] == want["metrics"]
    cold = _traffic(cls(tparams, tcfg, quantize=quant, kv_quantize=quant,
                        device="cpu", **ENGINE))
    assert cold["tokens"] == want["tokens"]
    assert cold["waves"] == [] and "prefix_hits" not in cold["metrics"]


@pytest.fixture(scope="module")
def jax_run(tiny):
    return jax_traffic(tiny, None)


@pytest.mark.parametrize("paged", [False, True], ids=["slab", "paged"])
def test_traffic_equals_jax_engine_f32(tiny, jax_run, paged):
    traffic_equals_jax(tiny, jax_run, paged, None)


def test_server_usage_cached_tokens_and_tenant(tiny):
    _, tcfg, _, tparams = tiny
    config = {"n_slots": 2, "max_len": 48, "buckets": [8, 16],
              "decode_chunk": 4, "prefix_cache": True,
              "prefix_cache_blocks": 8}
    server = CompletionServer.from_config(tparams, tcfg, config,
                                          device="cpu").start()

    def post(body, srv=server):
        req = urllib.request.Request(
            srv.url + "/openai/v1/completions",
            data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            return json.loads(r.read())

    try:
        prompt = SHARED + [3, 4]
        usages = [post({"prompt": prompt, "max_tokens": 3,
                        "user": "acme"})["usage"] for _ in range(2)]
        with pytest.raises(urllib.error.HTTPError) as e:
            post({"prompt": prompt, "max_tokens": 3, "user": ""})
        assert e.value.code == 400
        # read before stop(), which unloads the server's model
        row = server.engine.metrics()["prefix_cache"]["per_tenant"]["acme"]
    finally:
        server.stop()
    assert [u["cached_tokens"] for u in usages] == [0, 16]
    assert usages[1]["prompt_tokens_details"] == {"cached_tokens": 16}
    assert usages[1]["prompt_tokens"] == 19
    assert row == {"hits": 1, "misses": 1, "reused_tokens": 16,
                   "inserted_blocks": 2}
    plain = CompletionServer.from_config(tparams, tcfg, ENGINE,
                                         device="cpu").start()
    try:
        usage = post({"prompt": prompt, "max_tokens": 2}, plain)["usage"]
    finally:
        plain.stop()
    assert "cached_tokens" not in usage


def test_sizing_arguments_and_lookup_clamp_as_jax(tiny):
    jcfg, tcfg, jparams, tparams = tiny
    for kw in ({}, {"max_prefixes": 2}, {"max_prefixes": 0},
               {"prefix_cache_blocks": 5}):
        want = JaxEngine(jparams, jcfg, prefer_native=False,
                         prefix_cache=True, **kw, **ENGINE)
        for cls in (LLMEngine, PagedLLMEngine):
            got = cls(tparams, tcfg, prefix_cache=True, device="cpu", **kw,
                      **ENGINE)
            assert got.prefix_block_tokens == want.prefix_block_tokens == 8
            assert (got.kvcache.capacity_blocks
                    == want.kvcache.capacity_blocks)
    eng = LLMEngine(tparams, tcfg, device="cpu", **ENGINE)
    assert eng.kvcache is None and not eng.prefix_cache_enabled
    assert eng.metrics() == {"queued": 0, "active": 0, "completed": 0,
                             "rejected": 0, "prefill_tokens_computed": 0}
    with pytest.raises(ValueError, match="tenant"):
        eng.submit([1, 2, 3], 2, tenant="x" * 257)
    # a prompt shorter than one block plus a token is neither a hit nor a
    # miss, as in the JAX engine
    eng = LLMEngine(tparams, tcfg, prefix_cache=True, device="cpu", **ENGINE)
    eng.generate([5, 6, 7], 2)
    m = eng.metrics()
    assert m["prefix_hits"] == m["prefix_misses"] == 0
    assert m["prefill_tokens_computed"] == 3
    # the lookup's clamp (the JAX `_prefix_lookup`): a fully cached
    # 16-token prompt reuses 8 (one tail token must remain); with
    # max_len 40 a 28-token prompt over a 16-token hit has a 12-token
    # tail in bucket 32, 48 > 40, so the reuse shrinks to 8
    small = dict(n_slots=2, max_len=40, buckets=(8, 32), decode_chunk=4)
    cold = LLMEngine(tparams, tcfg, device="cpu", **small)
    eng = LLMEngine(tparams, tcfg, prefix_cache=True, device="cpu", **small)
    for prompt, reused in ((SHARED[:16], 0), (SHARED[:16], 8),
                           (SHARED + [9] * 11, 8)):
        rid = eng.submit(prompt, 3)
        eng.run_until_idle()
        assert eng.cached_tokens(rid) == reused
        assert eng.result(rid) == cold.generate(prompt, 3)
