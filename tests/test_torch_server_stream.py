"""The port's HTTP server over a supervised `LLMModel`, driven by the
JAX package's jax-free SSE client (`kubeflow_tpu/loadgen/http_client.py`
`stream_completion`): one [DONE] a stream and no duplicate token, a
mid-stream engine crash survived with keepalive comments and the
uncrashed tokens, a client that hangs up cancelled, chat, the routes,
and /metrics series named and labelled as the JAX server's for the same
traffic. Last, the dataplane invariant of the JAX package
(`scripts/check_dataplane.py` rules 1-2) applied to the port's serving
package."""

import ast
import contextlib
import json
import re
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import jax.numpy as jnp
import pytest
import torch

from kubeflow_tpu.chaos import (FaultScriptConfig, FaultSpec,
                                generate_fault_script)
from kubeflow_tpu.chaos.injector import FaultInjector
from kubeflow_tpu.loadgen.http_client import stream_completion
from kubeflow_tpu.serving.model import ModelRepository, load_model
from kubeflow_tpu.serving.server import ModelServer
from kubeflow_tpu_torch.obs.trace import TRACER
from kubeflow_tpu_torch.serving.llm_runtime import LLMModel
from kubeflow_tpu_torch.serving.server import CompletionServer

transformers = pytest.importorskip("transformers")

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
SERVING = dict(n_slots=2, max_len=64, buckets=[8, 16], decode_chunk=4,
               prefix_cache=True, logprobs_topk=2)
PROMPT = [72, 105, 33, 40, 50, 60]
MAX_TOKENS = 12


@pytest.fixture(scope="module")
def hf_dir(tmp_path_factory):
    path = tmp_path_factory.mktemp("hf-llama")
    hf_cfg = transformers.LlamaConfig(
        vocab_size=256, hidden_size=64, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, intermediate_size=128,
        max_position_embeddings=128, rope_theta=10000.0, rms_norm_eps=1e-5,
        tie_word_embeddings=False)
    torch.manual_seed(0)
    transformers.LlamaForCausalLM(hf_cfg).eval().save_pretrained(
        path, safe_serialization=True)
    return str(path)


@pytest.fixture(scope="module")
def port(hf_dir):
    """A supervised port model behind the port's server, with a fast
    restart (0.3 s backoff, no rewarm) and a 50 ms keepalive, so a
    restart window shows keepalives."""
    model = LLMModel("llm", hf_dir, device="cpu", model={"dtype": "float32"},
                     sse_keepalive_s=0.05, usage_timing=True,
                     supervisor={"backoff_base_s": 0.3, "backoff_cap_s": 0.6,
                                 "rewarm": False}, **SERVING)
    server = CompletionServer(model).start()
    yield model, server
    server.stop()


def _post(url, body, path="/openai/v1/completions", headers=None):
    req = urllib.request.Request(
        url + path, data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def _status(url, path, body=None, raw=None):
    data = raw if raw is not None else (
        None if body is None else json.dumps(body).encode())
    req = urllib.request.Request(url + path, data=data)
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


@contextlib.contextmanager
def _slow(sup, seconds=0.05):
    """Each supervised step `seconds` longer: a tiny model on the CPU
    outruns any client, and a stream must last for it to be crashed or
    left."""
    step = sup.step

    def slow_step():
        time.sleep(seconds)
        return step()

    sup.step = slow_step
    try:
        yield
    finally:
        del sup.step


def test_stream_has_one_done_and_no_duplicates(port):
    model, server = port
    r = stream_completion(server.port, {"model": "llm", "prompt": PROMPT,
                                        "max_tokens": MAX_TOKENS,
                                        "logprobs": True})
    assert r["status"] == 200 and r["done_count"] == 1
    assert r["usage_count"] == 1 and not r["errors"]
    assert r["finish_reason"] == "length"
    buffered = _post(server.url, {"model": "llm", "prompt": PROMPT,
                                  "max_tokens": MAX_TOKENS})
    assert r["token_ids"] == buffered["choices"][0]["token_ids"]
    assert len(r["token_ids"]) == MAX_TOKENS
    assert r["usage"]["completion_tokens"] == MAX_TOKENS
    # usage_timing: the phase split rides the usage object
    for u in (r["usage"], buffered["usage"]):
        assert u["prefill_ms"] >= 0 and u["decode_ms"] >= 0


def test_stop_is_held_back_until_the_finish(port):
    """A stop sequence's tokens never reach the stream, also when it
    spans two decode chunks (the stream holds the last tokens back)."""
    model, server = port
    full = _post(server.url, {"prompt": PROMPT, "max_tokens": MAX_TOKENS})
    toks = full["choices"][0]["token_ids"]
    for j in range(1, 8):
        body = {"prompt": PROMPT, "max_tokens": MAX_TOKENS,
                "stop": [toks[j:j + 2]]}
        r = stream_completion(server.port, body)
        cut = _post(server.url, body)["choices"][0]
        assert r["token_ids"] == cut["token_ids"], j
        assert len(cut["token_ids"]) <= j
        assert r["finish_reason"] == cut["finish_reason"] == "stop"


def test_midstream_crash_is_survived_with_keepalives(port):
    model, server = port
    want = stream_completion(server.port, {"prompt": PROMPT,
                                           "max_tokens": 40})["token_ids"]
    sup = model.supervisor
    restarts = sup.accounting()["restarts"]
    script = generate_fault_script(FaultScriptConfig(
        seed=1, duration_s=1.0,
        faults=(FaultSpec("backend_crash", 1, (0.0, 0.0)),)), name="now")
    armed = []

    def on_tokens():
        # arm once the stream has delivered tokens: the crash lands
        # mid-stream, at the supervisor's next step
        while not armed:
            with sup._lock:
                live = [e for e in sup._journal.values() if not e.terminal]
            if live and len(live[0].tokens) >= 3:
                sup.arm_faults(FaultInjector(script))
                armed.append(True)
            time.sleep(0.001)

    th = threading.Thread(target=on_tokens, daemon=True)
    th.start()
    with _slow(sup):
        r = stream_completion(server.port, {"prompt": PROMPT,
                                            "max_tokens": 40})
    th.join(timeout=30)
    assert not th.is_alive()
    acc = sup.accounting()
    assert acc["restarts"] == restarts + 1
    assert r["done_count"] == 1 and r["keepalives"] > 0 and not r["errors"]
    assert r["token_ids"] == want
    assert acc["replay_verified"] >= 1 and acc["lost"] == 0
    assert _status(server.url, "/v2/health/ready") == (200, {"ready": True})


def test_a_client_that_hangs_up_is_cancelled(port):
    model, server = port
    sup = model.supervisor
    cancelled = sup.accounting()["cancelled"]
    with _slow(sup):
        r = stream_completion(server.port, {"prompt": PROMPT,
                                            "max_tokens": 50},
                              cancel_after_s=0.3)
        assert r["client_cancelled"] and r["done_count"] == 0
        assert 0 < len(r["token_ids"]) < 50
        t = time.monotonic()
        while sup.accounting()["in_flight"] and time.monotonic() - t < 30:
            time.sleep(0.01)
    acc = sup.accounting()
    assert acc["cancelled"] == cancelled + 1 and acc["in_flight"] == 0


def test_chat_streams_and_buffers(port):
    model, server = port
    messages = [{"role": "user", "content": "Hi"}]
    r = stream_completion(server.port, {"messages": messages,
                                        "max_tokens": 6},
                          path="/openai/v1/chat/completions")
    body = _post(server.url, {"messages": messages, "max_tokens": 6},
                 "/openai/v1/chat/completions")
    (choice,) = body["choices"]
    assert r["done_count"] == 1 and r["token_ids"] == choice["token_ids"]
    assert body["object"] == "chat.completion"
    assert choice["message"] == {"role": "assistant", "content": r["text"]}
    assert _status(server.url, "/openai/v1/chat/completions",
                   {"messages": []})[0] == 400


def test_routes_and_errors(port):
    model, server = port
    url = server.url
    assert _status(url, "/v1/models") == (200, {"models": ["llm"]})
    assert _status(url, "/v2/models/llm/ready")[0] == 200
    assert _status(url, "/v2/models/nope/ready")[0] == 503
    assert _status(url, "/v2/models/llm")[1]["name"] == "llm"
    assert _status(url, "/v2/health/live") == (200, {"live": True})
    health = _status(url, "/healthz")[1]
    assert health["alive"] and health["supervisor"]["llm"]["restarts"] >= 0
    assert health["mesh"]["llm"]["layout"] == "single"
    assert "kubeflow_tpu_torch" in health["build"]
    assert _status(url, "/nope")[0] == 404
    code, out = _status(url, "/v1/models/llm:predict", {"instances": [
        {"prompt_tokens": PROMPT, "max_new_tokens": 3}]})
    assert code == 200 and len(out["predictions"][0]["output_tokens"]) == 3
    assert _status(url, "/v1/models/llm:explain",
                   {"instances": [1]})[0] == 404
    for body, code in (({"model": "nope", "prompt": "x"}, 404),
                       ({"prompt": "x" * 80}, 400),
                       ({"prompt": "x", "top_k": 65}, 400),
                       ({"prompt": "x", "stream": True, "n": 2}, 400)):
        assert _status(url, "/openai/v1/completions", body)[0] == code, body
    assert _status(url, "/openai/v1/completions", raw=b"{bad")[0] == 400


def test_trace_spans_follow_the_request(port):
    model, server = port
    trace = "feedface" * 4
    _post(server.url, {"prompt": PROMPT, "max_tokens": 4},
          headers={"X-Trace-Id": trace})
    names = {s.name for s in TRACER.sink.spans(trace)}
    assert {"server.http", "supervisor.supervise", "engine.queue",
            "engine.prefill", "engine.decode"} <= names


def _scrape(url: str) -> dict:
    """The /metrics samples as {(name, labels): value}, the histograms'
    buckets left out and the attention impl's name masked (the card's
    kernels or the CPU's plain versions in the port, XLA in JAX)."""
    with urllib.request.urlopen(url + "/metrics", timeout=30) as r:
        text = r.read().decode()
    out = {}
    for line in text.splitlines():
        m = re.match(r"^([a-z_]+)(?:\{(.*)\})? (\S+)$", line)
        if not m or m.group(1).endswith("_bucket"):
            continue
        labels = dict(re.findall(r'(\w+)="([^"]*)"', m.group(2) or ""))
        if "impl" in labels:
            labels["impl"] = "*"
        out[(m.group(1), tuple(sorted(labels.items())))] = m.group(3)
    return out


def test_metrics_series_as_the_jax_server(port, hf_dir):
    model, server = port
    repo = ModelRepository()
    repo.register(load_model("llama", "llm", hf_dir,
                             model={"dtype": jnp.float32}, **SERVING))
    jserver = ModelServer(repo).start()
    changed, scrape = {}, {}
    try:
        for name, srv in (("port", server), ("jax", jserver)):
            before = _scrape(srv.url)
            for stream in (False, True):
                stream_completion(srv.port, {"model": "llm",
                                             "prompt": PROMPT + [1] * 10,
                                             "max_tokens": 5,
                                             "stream": stream})
            stream_completion(srv.port, {
                "model": "llm", "max_tokens": 3,
                "messages": [{"role": "user", "content": "Hi"}]},
                path="/openai/v1/chat/completions")
            scrape[name] = after = _scrape(srv.url)
            changed[name] = {k for k, v in after.items()
                             if before.get(k) != v}
            if name == "port":
                text = urllib.request.urlopen(srv.url + "/metrics").read()
    finally:
        jserver.stop()
        repo.unload("llm")
    # every series either side's traffic touched exists on the other
    got, want = changed["port"], changed["jax"]
    assert got <= set(scrape["jax"]), sorted(got - set(scrape["jax"]))
    assert want <= set(scrape["port"]), sorted(want - set(scrape["port"]))
    for name, labels in (
            ("serving_ttft_seconds_count", (("component", "engine"),)),
            ("serving_requests_total", (("component", "supervisor"),
                                        ("event", "accepted"))),
            ("serving_http_requests_total", (("model", "llm"),
                                             ("verb", "completions"))),
            ("scheduler_queued", (("engine", "engine"),)),
            ("kvcache_free_blocks", (("engine", "engine"),)),
            ("serving_model_ready", (("model", "llm"),))):
        assert (name, labels) in scrape["port"], name
    n = re.search(r'^serving_ttft_seconds_count\{component="engine"\} (\d+)',
                  text.decode(), re.M)
    assert int(n.group(1)) >= 3


def _calls_in(path: Path, names) -> list[tuple[int, str, list[str]]]:
    """(line, class, enclosing functions) of each call to `names`."""
    found, stack = [], []

    class V(ast.NodeVisitor):
        def visit_FunctionDef(self, node):
            stack.append(node.name)
            self.generic_visit(node)
            stack.pop()

        def visit_Call(self, node):
            fn = node.func
            name = (fn.id if isinstance(fn, ast.Name) else
                    fn.attr if isinstance(fn, ast.Attribute) else None)
            if name in names:
                found.append((node.lineno, name, list(stack)))
            self.generic_visit(node)

    V().visit(ast.parse(path.read_text()))
    return found


def test_the_port_keeps_the_dataplane_invariant():
    """Rule 1: inside the port's serving package an engine is built only
    in a function whose name says `factory` (the closure a supervisor
    restarts through); rule 2: the server names no engine class."""
    engines = ("LLMEngine", "PagedLLMEngine", "PrefillEngine",
               "DecodeEngine")
    serving = ROOT / "kubeflow_tpu_torch" / "serving"
    server = (serving / "server.py").read_text()
    assert not [n for n in engines if n in server]
    built = []
    for path in sorted(serving.glob("*.py")):
        if path.name in ("llm.py", "paged.py"):   # where they are defined
            continue
        for line, name, stack in _calls_in(path, engines):
            built.append((path.name, name))
            assert any("factory" in fn for fn in stack), (path, line, name)
    assert ("llm_runtime.py", "LLMEngine") in built
    assert ("llm_runtime.py", "PrefillEngine") in built


def test_echo_and_best_of(port):
    model, server = port
    body = {"prompt": PROMPT, "max_tokens": 4, "echo": True,
            "logprobs": True}
    (choice,) = _post(server.url, body)["choices"]
    assert choice["token_ids"][:len(PROMPT)] == PROMPT
    assert choice["logprobs"]["token_logprobs"][:len(PROMPT)] == [
        None] * len(PROMPT)
    out = _post(server.url, {"prompt": PROMPT, "max_tokens": 4, "n": 2,
                             "best_of": 3, "temperature": 1.0, "seed": 7})
    assert [c["index"] for c in out["choices"]] == [0, 1]
    assert out["usage"]["completion_tokens"] == 12   # all three candidates


def test_timeout_ends_cancelled(port):
    """A request's `timeout` is the engine's deadline: past it the
    request ends "cancelled", streamed or buffered, and usage says so."""
    model, server = port
    body = {"prompt": PROMPT, "max_tokens": 50, "timeout": 0.3}
    with _slow(model.supervisor):
        r = stream_completion(server.port, body)
        out = _post(server.url, body)
    assert r["finish_reason"] == "cancelled" and r["done_count"] == 1
    assert r["usage"]["cancelled"] == 1
    assert out["choices"][0]["finish_reason"] == "cancelled"
    assert out["usage"]["cancelled"] == 1


def test_streamed_logprobs_are_the_buffered_ones(port):
    model, server = port
    body = {"prompt": PROMPT + [9, 9], "max_tokens": 6, "logprobs": True}
    chunks = []
    req = urllib.request.Request(
        server.url + "/openai/v1/completions",
        data=json.dumps(dict(body, stream=True)).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        for line in r:
            if line.startswith(b"data: {"):
                chunks.append(json.loads(line[6:]))
    lps = [c["choices"][0]["logprob"] for c in chunks
           if c["choices"][0].get("token_id") is not None]
    buffered = _post(server.url, body)["choices"][0]["logprobs"]
    assert lps == buffered["token_logprobs"]
    assert chunks[-1]["choices"][0]["finish_reason"] == "length"


def test_healthz_reports_the_cache_and_the_slo(port):
    model, server = port
    _post(server.url, {"prompt": PROMPT + [3] * 12, "max_tokens": 2})
    _post(server.url, {"prompt": PROMPT + [3] * 12, "max_tokens": 2})
    health = _status(server.url, "/healthz")[1]
    assert health["kv_cache"]["llm"]["kv_layout"] == "slab"
    assert health["kv_cache"]["llm"]["request_hits"] >= 1
    slo = health["slo"]["llm"]
    assert slo["aggregate"]["n"] >= 2 and "default" in slo["tenants"]
