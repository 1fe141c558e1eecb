"""Faults C3 and C4 of ROADMAP.md, closed: `LLMModel` takes `mesh` and
`parallel` when every axis is 1 (examples/hf-llama-inference-service.yaml
builds on the CPU) and still refuses more than one card; the engines'
`submit` and `generate` take the JAX engine's parameter order (prompt,
max_new_tokens, temperature, adapter, top_k, ...), with the JAX engine's
greedy tokens for positional calls on `LlamaConfig.tiny()`."""

from __future__ import annotations

import dataclasses
import os

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
from kubeflow_tpu_torch.serving.llm_runtime import LLMModel
from kubeflow_tpu_torch.serving.paged import PagedLLMEngine

yaml = pytest.importorskip("yaml")

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENGINE = dict(n_slots=2, max_len=48, buckets=(8, 16))
PROMPTS = [[3, 17, 101, 44, 9], list(range(20, 32))]


def test_c3_the_hf_isvc_example_config_builds_an_llmmodel():
    with open(os.path.join(ROOT, "examples",
                           "hf-llama-inference-service.yaml")) as f:
        isvc = yaml.safe_load(f)
    config = isvc["spec"]["predictor"]["model"]["config"]
    assert config["mesh"] == {"tensor": 1}
    m = LLMModel("hf-llama", device="cpu", **config)
    assert not m.ready
    for kw in ({"mesh": {"data": -1, "tensor": 1}},
               {"parallel": {"tensor": 1, "stage": 1}},
               {"parallel": {"tensor": 1}, "mesh": {"tensor": 1}}):
        LLMModel("m", device="cpu", **kw)


@pytest.mark.parametrize("kw,match", [
    ({"mesh": {"tensor": 2}}, "A6"),
    ({"mesh": {"fsdp": -1, "data": 4}}, "A6"),
    ({"parallel": {"tensor": 2}}, "A6"),
    # stage 2 alone serves on one card (StageShardedEngine); with a
    # tensor split past one card it still raises
    ({"parallel": {"stage": 2, "tensor": 2}}, "A6"),
    ({"parallel": {"tensor": 2}, "mesh": {"tensor": 1}}, "not both"),
    ({"parallel": {"tensor": 0}}, ">= 1"),
    ({"mesh": {"pipe": 1}}, "unknown mesh axis"),
])
def test_c3_more_than_one_card_still_raises(kw, match):
    with pytest.raises(ValueError, match=match):
        LLMModel("m", device="cpu", **kw)


@pytest.fixture(scope="module")
def tiny():
    jcfg = dataclasses.replace(jllama.LlamaConfig.tiny(), dtype=jnp.float32)
    tcfg = dataclasses.replace(tllama.LlamaConfig.tiny(),
                               dtype=torch.float32)
    jparams = jllama.init(jax.random.key(0), jcfg)
    tparams = interop.from_jax_params(jax.tree.map(np.asarray, jparams),
                                      tcfg, device="cpu")
    return jcfg, tcfg, jparams, tparams


def _positional(engine) -> list[list[int]]:
    """generate(p, n, 0.0) for the first prompt, submit(p, n, 0.0, None)
    for the second."""
    out = [engine.generate(PROMPTS[0], 6, 0.0)]
    rid = engine.submit(PROMPTS[1], 6, 0.0, None)
    engine.run_until_idle()
    out.append(engine.result(rid))
    return out


@pytest.mark.parametrize("engine_cls", [LLMEngine, PagedLLMEngine])
def test_c4_positional_calls_take_the_jax_order(tiny, engine_cls):
    jcfg, tcfg, jparams, tparams = tiny
    want = _positional(JaxEngine(jparams, jcfg, prefer_native=False,
                                 **ENGINE))
    got = _positional(engine_cls(tparams, tcfg, device="cpu", **ENGINE))
    assert got == want
    assert all(len(t) == 6 for t in got)


def test_c4_positional_temperature_samples_and_repeats(tiny):
    jcfg, tcfg, jparams, tparams = tiny
    eng = LLMEngine(tparams, tcfg, device="cpu", **ENGINE)
    greedy = eng.generate(PROMPTS[0], 8, 0.0)
    runs = [eng.generate(PROMPTS[0], 8, 0.7, seed=s)
            for s in (11, 11, 12)]
    assert runs[0] == runs[1] != greedy
    assert runs[2] != runs[0]
    assert len(JaxEngine(jparams, jcfg, prefer_native=False, **ENGINE)
               .generate(PROMPTS[0], 8, 0.7, seed=11)) == 8


def test_c4_an_adapter_still_raises_naming_a3(tiny):
    """Adapters are ported (queue A3 closed): an unknown one raises the
    JAX engine's "unknown adapter", and a loaded one is taken fourth, in
    the JAX engine's positional order, with that engine's tokens."""
    jcfg, tcfg, jparams, tparams = tiny
    eng = LLMEngine(tparams, tcfg, device="cpu", **ENGINE)
    with pytest.raises(ValueError, match="unknown adapter"):
        eng.submit(PROMPTS[0], 4, 0.0, "my-adapter")
    with pytest.raises(ValueError, match="unknown adapter"):
        eng.generate(PROMPTS[0], 4, 0.0, "my-adapter")
    rng = np.random.default_rng(0)
    shapes = tllama.matmul_shapes(tcfg)
    lora = {t: {"a": rng.normal(size=(tcfg.n_layers, shapes[t][0], 2)
                                ).astype(np.float32) * 0.1,
                "b": rng.normal(size=(tcfg.n_layers, 2, shapes[t][1])
                                ).astype(np.float32) * 0.1}
            for t in ("wq", "wv")}
    adapters = {"my-adapter": {"lora": lora, "alpha": 4.0}}
    got = LLMEngine(tparams, tcfg, device="cpu", adapters=adapters,
                    **ENGINE).generate(PROMPTS[0], 6, 0.0, "my-adapter")
    want = JaxEngine(jparams, jcfg, prefer_native=False, adapters=adapters,
                     **ENGINE).generate(PROMPTS[0], 6, 0.0, "my-adapter")
    assert got == want and len(got) == 6
