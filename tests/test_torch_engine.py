"""The port's serving engine and server on the CPU: greedy tokens
identical to the JAX `LLMEngine` on the tiny f32 config (plain, and int8
weights with int8 KV), seeded sampling that repeats itself, an HTTP round
trip through the port's server, and entry points that refuse to fall
back to the CPU when CUDA is asked for and absent."""

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
from kubeflow_tpu_torch.serving.scheduler import PromptTooLong
from kubeflow_tpu_torch.serving.server import CompletionServer

torch.set_num_threads(2)

ENGINE = dict(n_slots=2, max_len=48, buckets=(8, 16))
PROMPTS = [[3, 17, 101, 44, 9], list(range(20, 32)),
           [7] * 3 + list(range(200, 213))]
NEW = 8


@pytest.fixture(scope="module")
def tiny():
    jcfg = dataclasses.replace(jllama.LlamaConfig.tiny(), dtype=jnp.float32)
    tcfg = dataclasses.replace(tllama.LlamaConfig.tiny(),
                               dtype=torch.float32)
    jparams = jllama.init(jax.random.key(0), jcfg)
    tparams = interop.from_jax_params(jax.tree.map(np.asarray, jparams),
                                      tcfg, device="cpu")
    return jcfg, tcfg, jparams, tparams


def _run(engine, prompts, **kw):
    rids = [engine.submit(p, NEW, **kw) for p in prompts]
    engine.run_until_idle()
    return [engine.result(r) for r in rids]


@pytest.mark.parametrize("quant", [None, "int8"])
def test_greedy_tokens_identical_to_jax_engine(tiny, quant):
    jcfg, tcfg, jparams, tparams = tiny
    jeng = JaxEngine(jparams, jcfg, prefer_native=False, quantize=quant,
                     kv_quantize=quant, **ENGINE)
    want = _run(jeng, PROMPTS)
    teng = LLMEngine(tparams, tcfg, quantize=quant, kv_quantize=quant,
                     device="cpu", **ENGINE)
    got = _run(teng, PROMPTS)
    assert got == want
    assert all(len(t) == NEW for t in got)


def test_seeded_sampling_repeats(tiny):
    _, tcfg, _, tparams = tiny
    kw = dict(temperature=0.9, top_k=20, top_p=0.9)
    runs = [_run(LLMEngine(tparams, tcfg, sample_seed=7, device="cpu",
                           **ENGINE), PROMPTS, **kw) for _ in range(2)]
    assert runs[0] == runs[1]
    greedy = _run(LLMEngine(tparams, tcfg, device="cpu", **ENGINE), PROMPTS)
    assert runs[0] != greedy   # the sampler really sampled


def test_engine_limits(tiny):
    _, tcfg, _, tparams = tiny
    eng = LLMEngine(tparams, tcfg, device="cpu", eos_id=None, **ENGINE)
    # a prompt past the largest bucket is chunked; one that leaves no
    # room to decode in max_len is refused
    with pytest.raises(PromptTooLong):
        eng.submit(list(range(ENGINE["max_len"])))
    with pytest.raises(ValueError):
        eng.submit([1, 2], temperature=float("nan"))
    # a request longer than the cache room ends with "length" at max_len
    rid = eng.submit(list(range(16)), max_new_tokens=100)
    eng.run_until_idle()
    assert len(eng.result(rid)) == ENGINE["max_len"] - 16 + 1
    assert eng.finish_reason(rid) == "length"


def test_http_round_trip(tiny):
    _, tcfg, _, tparams = tiny
    config = {"quantize": "int8", "kv_quantize": "int8", "n_slots": 2,
              "max_len": 48, "buckets": [8, 16], "decode_chunk": 4}
    server = CompletionServer.from_config(tparams, tcfg, config,
                                          device="cpu").start()
    try:
        with urllib.request.urlopen(server.url + "/v2/health/ready",
                                    timeout=30) as r:
            assert r.status == 200 and json.loads(r.read())["ready"]
        req = urllib.request.Request(
            server.url + "/openai/v1/completions",
            data=json.dumps({"model": "llama", "prompt": "hello",
                             "max_tokens": 5}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            assert r.status == 200
            body = json.loads(r.read())
        assert len(body["choices"][0]["token_ids"]) == 5
        assert body["usage"]["completion_tokens"] == 5
        assert body["usage"]["prompt_tokens"] == 5
        bad = urllib.request.Request(
            server.url + "/openai/v1/completions",
            data=json.dumps({"prompt": "x" * 48}).encode())
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(bad, timeout=30)
        assert e.value.code == 400
    finally:
        server.stop()


def test_entry_points_raise_without_cuda(tiny, monkeypatch):
    jcfg, tcfg, jparams, tparams = tiny
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LLMEngine(tparams, tcfg, **ENGINE)
    with pytest.raises(RuntimeError):
        CompletionServer.from_config(tparams, tcfg, {"max_len": 48,
                                                     "buckets": [8]})
    with pytest.raises(RuntimeError):
        tllama.init(tcfg)
    with pytest.raises(RuntimeError):
        tllama.init_cache(tcfg, 2, 48)
    with pytest.raises(RuntimeError):
        interop.from_jax_params(jax.tree.map(np.asarray, jparams), tcfg)
