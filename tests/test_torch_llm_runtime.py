"""The port's `LLMModel` as an InferenceService serves it: the JAX
package's `ModelServer` hosts the JAX `llama` runtime and, through its
`python` runtime (`className: kubeflow_tpu_torch.serving.llm_runtime:
LLMModel`, `device: cpu`), the port's model over a slab and over a paged
KV cache, all three over the same tiny HF directory with the prefix cache
and speculation on. Greedy SSE completions, chat and buffered calls give
the same token ids, text, finish_reason and usage (cached_tokens
included) from both runtimes, with stop strings and logprobs; seeded rows
repeat within the port; the keys of unported paths raise, each naming its
ROADMAP.md item (and the disaggregated keys JAX refuses raise as there),
and a path that is neither an HF directory nor a trainer
checkpoint raises ModelError."""

import json
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.loadgen.http_client import stream_completion
from kubeflow_tpu.serving.model import ModelRepository, load_model
from kubeflow_tpu.serving.server import ModelServer
from kubeflow_tpu_torch.serving.llm_runtime import LLMModel, ModelError

transformers = pytest.importorskip("transformers")

torch.set_num_threads(2)

CLASS = "kubeflow_tpu_torch.serving.llm_runtime:LLMModel"
SERVING = dict(n_slots=2, max_len=64, buckets=[8, 16], decode_chunk=4,
               prefix_cache=True, speculative=3, logprobs_topk=2)
PORT = ("slab", "paged")


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    path = tmp_path_factory.mktemp("hf-llama")
    hf_cfg = transformers.LlamaConfig(
        vocab_size=256, hidden_size=64, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, intermediate_size=128,
        max_position_embeddings=128, rope_theta=10000.0, rms_norm_eps=1e-5,
        tie_word_embeddings=False)
    torch.manual_seed(0)
    transformers.LlamaForCausalLM(hf_cfg).eval().save_pretrained(
        path, safe_serialization=True)
    repo = ModelRepository()
    repo.register(load_model("llama", "jax", str(path),
                             model={"dtype": jnp.float32}, **SERVING))
    for layout in PORT:
        repo.register(load_model("python", layout, str(path),
                                 className=CLASS, device="cpu",
                                 model={"dtype": "float32"},
                                 kv_layout=layout, **SERVING))
    server = ModelServer(repo).start()
    yield server, repo, str(path)
    server.stop()
    for name in repo.names():
        repo.unload(name)


_REFERENCE: dict = {}


def _reference(served, family, run):
    """The JAX model's answers to a family of requests, made once (its
    prefix cache then saw the family once, as each port model does)."""
    if family not in _REFERENCE:
        _REFERENCE[family] = run(served, "jax")
    return _REFERENCE[family]


def _post(server, body, path="/openai/v1/completions"):
    req = urllib.request.Request(server.url + path,
                                 data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def _sse_family(served, model):
    server = served[0]
    out = []
    for body in ({"prompt": "xyz", "max_tokens": 12, "stop": ["Hl"]},
                 {"prompt": "The cat sat", "max_tokens": 16},
                 {"prompt": "The cat sat on the mat", "max_tokens": 8,
                  "logprobs": True},
                 {"prompt": "The cat sat on the mat", "max_tokens": 8}):
        r = stream_completion(server.port, dict(body, model=model))
        assert r["status"] == 200 and r["done_count"] == 1, r
        assert r["usage_count"] == 1 and not r["errors"]
        out.append({k: r[k] for k in ("token_ids", "text", "finish_reason",
                                      "usage")})
    return out


@pytest.mark.parametrize("layout", PORT)
def test_sse_completions_match_jax(served, layout):
    want = _reference(served, "sse", _sse_family)
    got = _sse_family(served, layout)
    assert got == want
    assert want[0]["finish_reason"] == "stop"          # "Hl" matched
    assert want[3]["usage"]["cached_tokens"] == 16     # a prefix hit
    m = served[1].get(layout).metrics()
    assert m["spec_verify_rounds"] > 0 and m["kv_layout"] == layout
    assert m["supervisor"]["lost"] == 0


def _chat_family(served, model):
    server = served[0]
    messages = [{"role": "user", "content": "Hi"}]
    r = stream_completion(server.port, {"model": model, "max_tokens": 6,
                                        "messages": messages},
                          path="/openai/v1/chat/completions")
    assert r["status"] == 200 and r["done_count"] == 1, r
    # a second turn over the first (the prefix cache's chat shape)
    body = _post(server, {"model": model, "max_tokens": 4,
                          "messages": messages + [
                              {"role": "assistant", "content": "Yo"},
                              {"role": "user", "content": "Go"}]},
                 "/openai/v1/chat/completions")
    choice = body["choices"][0]
    return [{k: r[k] for k in ("token_ids", "text", "finish_reason",
                               "usage")},
            {"object": body["object"], "usage": body["usage"],
             "message": choice["message"],
             "token_ids": choice["token_ids"],
             "finish_reason": choice["finish_reason"]}]


@pytest.mark.parametrize("layout", PORT)
def test_chat_matches_jax(served, layout):
    want = _reference(served, "chat", _chat_family)
    assert _chat_family(served, layout) == want
    assert want[1]["object"] == "chat.completion"
    assert want[1]["message"]["role"] == "assistant"


def _buffered_family(served, model):
    server = served[0]
    out = []
    for body in ({"prompt": "Once upon a time", "max_tokens": 10,
                  "logprobs": 2},
                 {"prompt": [72, 105, 33, 32, 120, 121], "max_tokens": 6,
                  "echo": True, "logprobs": True},
                 {"prompt": "xyz xyz", "max_tokens": 9,
                  "presence_penalty": 0.5, "stop": ["v-"]}):
        out.append(_post(server, dict(body, model=model)))
    return out


@pytest.mark.parametrize("layout", PORT)
def test_buffered_completions_match_jax(served, layout):
    want = _reference(served, "buffered", _buffered_family)
    got = _buffered_family(served, layout)
    for g, w in zip(got, want):
        assert g["usage"] == w["usage"] and g["object"] == w["object"]
        (gc,), (wc,) = g["choices"], w["choices"]
        for key in ("token_ids", "text", "finish_reason"):
            assert gc[key] == wc[key], key
        if "logprobs" in wc:
            gl, wl = gc["logprobs"], wc["logprobs"]
            assert gl["token_ids"] == wl["token_ids"]
            np.testing.assert_allclose(
                [np.nan if v is None else v for v in gl["token_logprobs"]],
                [np.nan if v is None else v for v in wl["token_logprobs"]],
                atol=1e-4, rtol=1e-4)
            for gt, wt in zip(gl.get("top_logprobs", []),
                              wl.get("top_logprobs", [])):
                assert sorted(gt) == sorted(wt)
                np.testing.assert_allclose(
                    [gt[k] for k in sorted(gt)], [wt[k] for k in sorted(wt)],
                    atol=1e-4, rtol=1e-4)


def test_seeded_rows_repeat_in_the_port(served):
    server = served[0]
    body = {"prompt": "Seeded: ", "max_tokens": 12, "temperature": 0.9,
            "top_p": 0.95, "seed": 1234}
    runs = [_post(server, dict(body, model=m))["choices"][0]["token_ids"]
            for m in ("slab", "slab", "paged")]
    assert runs[0] == runs[1] == runs[2]
    greedy = _post(server, dict(body, model="slab", temperature=0.0))
    assert greedy["choices"][0]["token_ids"] != runs[0]


def test_v1_predict_matches_jax(served):
    server = served[0]
    body = {"instances": [{"prompt_tokens": [5, 6, 7, 8, 9, 10],
                           "max_new_tokens": 5},
                          {"prompt_tokens": [40, 41], "max_new_tokens": 3}]}
    want = _post(server, body, "/v1/models/jax:predict")
    for layout in PORT:
        assert _post(server, body, f"/v1/models/{layout}:predict") == want
    with urllib.request.urlopen(server.url + "/v2/health/ready",
                                timeout=30) as r:
        assert json.loads(r.read()) == {"ready": True}


def test_unported_keys_raise_naming_their_item(served):
    path = served[2]
    for key, value, item in (("parallel", {"tensor": 2}, "A6"),
                             ("mesh", {"tensor": 2}, "A6")):
        with pytest.raises(ValueError, match=item):
            LLMModel("m", path, device="cpu", **{key: value})
    # disaggregated serving is ported (queue A5) with the JAX runtime's
    # refusals; grpc is the predictor's key, read by the server
    # (CompletionServer.from_config), not this class's
    for cfg, msg in (({"disaggregated": True, "supervised": False},
                      "requires supervised"),
                     ({"disaggregated": True, "kv_layout": "paged"},
                      "kv_layout=paged"),
                     ({"grpc": True}, "unsupported config keys")):
        with pytest.raises(ValueError, match=msg):
            LLMModel("m", path, device="cpu", **cfg)
    # lora and adapters are ported (queue A3): config.lora needs a
    # llama_lora trainer checkpoint, as the JAX runtime's does, and an
    # adapter whose checkpoint holds no step is refused at load
    with pytest.raises(ModelError, match="requires a checkpoint"):
        LLMModel("m", device="cpu", lora={"rank": 8}).load()
    with pytest.raises(ModelError, match="adapter 'a'"):
        LLMModel("m", device="cpu", model={"n_layers": 1, "d_model": 64,
                                           "n_heads": 4, "n_kv_heads": 2,
                                           "d_ff": 128, "vocab_size": 256},
                 adapters={"a": {"checkpoint": str(path) + "-missing"}}
                 ).load()
    with pytest.raises(ValueError, match="unsupported config keys"):
        LLMModel("m", path, device="cpu", beam_width=4)
    # not an HF directory: read as a trainer checkpoint, and one that
    # holds no step is refused, never served with random weights
    m = LLMModel("m", str(served[2]) + "-missing", device="cpu")
    with pytest.raises(ModelError, match="no checkpoint"):
        m.load()
    with pytest.raises(ValueError, match="kv_layout"):
        LLMModel("m", path, device="cpu", kv_layout="ring")


def test_the_model_needs_a_gpu_unless_told(served, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LLMModel("m", served[2])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_model("python", "m", served[2], className=CLASS)


def test_chip_smoke_serves_the_isvc_config_as_written():
    """chip_smoke (e6) builds its LLMModel from
    examples/llama-8b-serving-isvc.yaml's config, key for key."""
    yaml = pytest.importorskip("yaml")
    import chip_smoke

    root = chip_smoke.__file__.rsplit("/", 1)[0]
    with open(f"{root}/examples/llama-8b-serving-isvc.yaml") as f:
        isvc = yaml.safe_load(f)
    assert chip_smoke.E6_ISVC == isvc["spec"]["predictor"]["model"]["config"]


def test_jax_healthz_reads_the_port_models(served):
    """The JAX server's /healthz takes each port model's prefix cache,
    supervisor and device layout sections as it takes its own model's."""
    server = served[0]
    with urllib.request.urlopen(server.url + "/healthz", timeout=30) as r:
        health = json.loads(r.read())
    for name in ("jax",) + PORT:
        assert health["supervisor"][name]["restarts"] == 0
        assert not health["supervisor"][name]["permanent_failed"]
        assert health["mesh"][name]["layout"] == "single"
    for layout in PORT:
        assert health["kv_cache"][layout]["kv_layout"] == layout
        assert (set(health["kv_cache"][layout])
                <= set(health["kv_cache"]["jax"]))


def test_metrics_keys_are_the_jax_engines(served):
    repo = served[1]
    want = repo.get("jax").metrics()
    for layout in PORT:
        got = repo.get(layout).metrics()
        assert set(got) - {"kv_pool", "held_prefills"} <= set(want)
        assert set(got["supervisor"]) == set(want["supervisor"])
        assert set(got["prefix_cache"]) <= set(want["prefix_cache"])
        assert {k for k in got if k.startswith("spec_")} == {
            k for k in want if k.startswith("spec_")}
