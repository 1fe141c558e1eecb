"""OpenAI-style completion server over one LLMEngine (counterpart of the
completion and readiness routes of kubeflow_tpu/serving/server.py):

    POST /openai/v1/completions   {"prompt": str | [ids], "max_tokens",
                                   "temperature", "top_k", "top_p"}
         -> {"choices": [{"text", "token_ids", "finish_reason"}],
             "usage": {"prompt_tokens", "completion_tokens",
                       "total_tokens"}}
    GET  /v2/health/ready         -> {"ready": true}

A `ThreadingHTTPServer` answers each request on its own thread; one
engine thread runs `engine.step()` while there is work and sleeps on a
condition variable otherwise. Non-streaming only.
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any

from kubeflow_tpu_torch.models import llama
from kubeflow_tpu_torch.serving.llm import LLMEngine
from kubeflow_tpu_torch.serving.scheduler import PromptTooLong, QueueFull
from kubeflow_tpu_torch.serving.tokenizer import ByteTokenizer

#: the engine settings a serving config may carry (the keys of
#: examples/llama-8b-serving-isvc.yaml that this engine implements)
CONFIG_KEYS = ("quantize", "kv_quantize", "n_slots", "max_len", "buckets",
               "decode_chunk")


class BadRequest(ValueError):
    """A malformed request (HTTP 400)."""


class CompletionServer:
    def __init__(self, engine: LLMEngine, *, model: str = "llama",
                 tokenizer: Any = None, host: str = "127.0.0.1",
                 port: int = 0):
        self.engine = engine
        self.model = model
        self.tokenizer = tokenizer or ByteTokenizer()
        self._cv = threading.Condition()
        self._stopping = threading.Event()
        self._engine_error: BaseException | None = None
        self._engine_thread: threading.Thread | None = None
        self._http_thread: threading.Thread | None = None
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):
                pass

            def _send(self, code: int, payload: dict[str, Any]) -> None:
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/v2/health/ready":
                    ready = server.ready
                    self._send(200 if ready else 503, {"ready": ready})
                else:
                    self._send(404, {"error": f"no route {self.path}"})

            def do_POST(self):
                if self.path != "/openai/v1/completions":
                    return self._send(404, {"error": f"no route {self.path}"})
                raw = self.rfile.read(int(self.headers.get("Content-Length",
                                                           0)))
                try:
                    body = json.loads(raw) if raw else {}
                    self._send(200, server.complete(body))
                except (BadRequest, PromptTooLong, json.JSONDecodeError) as e:
                    self._send(400, {"error": str(e)})
                except QueueFull as e:
                    self._send(503, {"error": str(e)})
                except Exception as e:   # answer, keep serving
                    self._send(500, {"error": repr(e)})

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self._httpd.server_address[1]

    @classmethod
    def from_config(cls, params, cfg: llama.LlamaConfig,
                    config: dict[str, Any], *, device="cuda",
                    **kw) -> "CompletionServer":
        """Server over a new engine built from a serving config dict."""
        unknown = set(config) - set(CONFIG_KEYS)
        if unknown:
            raise ValueError(f"unsupported config keys {sorted(unknown)}")
        eng_kw = dict(config)
        if "buckets" in eng_kw:
            eng_kw["buckets"] = tuple(eng_kw["buckets"])
        return cls(LLMEngine(params, cfg, device=device, **eng_kw), **kw)

    @property
    def url(self) -> str:
        host, port = self._httpd.server_address[:2]
        return f"http://{host}:{port}"

    @property
    def ready(self) -> bool:
        return (self._engine_thread is not None
                and self._engine_thread.is_alive()
                and self._engine_error is None)

    def start(self) -> "CompletionServer":
        self._engine_thread = threading.Thread(target=self._engine_loop,
                                               name="engine", daemon=True)
        self._engine_thread.start()
        self._http_thread = threading.Thread(
            target=self._httpd.serve_forever, name="http", daemon=True)
        self._http_thread.start()
        return self

    def stop(self) -> None:
        self._stopping.set()
        with self._cv:
            self._cv.notify_all()
        self._httpd.shutdown()
        self._httpd.server_close()
        for t in (self._engine_thread, self._http_thread):
            if t is not None:
                t.join(timeout=30)

    def _engine_loop(self) -> None:
        while not self._stopping.is_set():
            try:
                busy = self.engine.step()
            except Exception as e:    # the engine is dead: fail waiters
                self._engine_error = e
                with self._cv:
                    self._cv.notify_all()
                raise
            with self._cv:
                self._cv.notify_all()
                if not busy:
                    self._cv.wait(timeout=0.05)

    def complete(self, body: Any) -> dict[str, Any]:
        """One completion request, answered when the engine finishes it."""
        if not isinstance(body, dict):
            raise BadRequest("body must be an object")
        prompt = body.get("prompt", "")
        if isinstance(prompt, str):
            ids = self.tokenizer.encode(prompt)
        elif isinstance(prompt, list) and all(isinstance(t, int)
                                              for t in prompt):
            ids = list(prompt)
        else:
            raise BadRequest("prompt must be a string or a list of ids")
        if not ids:
            raise BadRequest("prompt must be non-empty")
        try:
            rid = self.engine.submit(
                ids, int(body.get("max_tokens", 16)),
                temperature=float(body.get("temperature", 0.0)),
                top_k=int(body.get("top_k", 0)),
                top_p=float(body.get("top_p", 1.0)))
        except (TypeError, ValueError) as e:
            if isinstance(e, PromptTooLong):
                raise
            raise BadRequest(str(e)) from e
        with self._cv:
            self._cv.notify_all()
            while not self.engine.is_done(rid):
                if self._engine_error is not None:
                    raise RuntimeError("engine failed") from \
                        self._engine_error
                if self._stopping.is_set():
                    raise RuntimeError("server stopped")
                self._cv.wait(timeout=1.0)
        tokens = self.engine.result(rid)
        reason = self.engine.finish_reason(rid)
        self.engine.release(rid)
        return {"id": f"cmpl-{rid}", "object": "text_completion",
                "created": int(time.time()), "model": self.model,
                "choices": [{"index": 0,
                             "text": self.tokenizer.decode(tokens),
                             "token_ids": tokens,
                             "finish_reason": reason}],
                "usage": {"prompt_tokens": len(ids),
                          "completion_tokens": len(tokens),
                          "total_tokens": len(ids) + len(tokens)}}
