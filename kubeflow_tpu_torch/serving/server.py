"""OpenAI-style completion server over one LLMEngine (counterpart of the
completion and readiness routes of kubeflow_tpu/serving/server.py):

    POST /openai/v1/completions   {"prompt": str | [ids], "max_tokens",
                                   "temperature", "top_k", "top_p", "stop",
                                   "presence_penalty", "frequency_penalty",
                                   "seed", "logprobs", "timeout"}
         -> {"choices": [{"text", "token_ids", "finish_reason",
                          "logprobs"?}],
             "usage": {"prompt_tokens", "completion_tokens",
                       "total_tokens"}}
    GET  /v2/health/ready         -> {"ready": true}

`stop` is a string, or a list of up to 8 strings (encoded by the
server's tokenizer) or token-id lists. `logprobs` true returns each
token's logprob; an int N (at most the engine's logprobs_topk) adds the
top-N alternatives, as OpenAI's `logprobs` object (`tokens`,
`token_logprobs`, `top_logprobs` keyed by token id). A request's
`timeout` seconds, or else the server's `timeout_s` (the ISVC key),
becomes the engine's deadline: past it the request ends "cancelled".

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
               "decode_chunk", "pipeline_decode", "logprobs_topk",
               "timeout_s")


class BadRequest(ValueError):
    """A malformed request (HTTP 400)."""


class CompletionServer:
    def __init__(self, engine: LLMEngine, *, model: str = "llama",
                 tokenizer: Any = None, host: str = "127.0.0.1",
                 port: int = 0, timeout_s: float | None = None):
        if timeout_s is not None and not timeout_s > 0:
            raise ValueError("timeout_s must be positive")
        self.engine = engine
        self.timeout_s = timeout_s
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
        if "timeout_s" in eng_kw:
            kw.setdefault("timeout_s", eng_kw.pop("timeout_s"))
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

    def _stop_sequences(self, stop: Any) -> list[list[int]] | None:
        """`stop` as token sequences: a string, or a list of up to 8
        strings (encoded by the tokenizer) or lists of token ids."""
        if stop is None:
            return None
        if isinstance(stop, str):
            stop = [stop]
        if not isinstance(stop, list) or not 1 <= len(stop) <= 8:
            raise BadRequest(
                "stop must be a non-empty string or a list of up to 8")
        seqs = []
        for item in stop:
            if isinstance(item, str) and item:
                seqs.append(self.tokenizer.encode(item))
            elif (isinstance(item, list) and item
                  and all(isinstance(t, int) and not isinstance(t, bool)
                          for t in item)):
                seqs.append(list(item))
            else:
                raise BadRequest("each stop must be a non-empty string or "
                                 "a non-empty list of token ids")
        return seqs

    def _logprobs_n(self, body: dict) -> int | None:
        """None: no logprobs; 0: the chosen tokens'; N: also the top N."""
        lp = body.get("logprobs")
        if lp is None or lp is False:
            return None
        if lp is True:
            return 0
        if not isinstance(lp, int) or lp < 0:
            raise BadRequest("logprobs must be a bool or a non-negative int")
        if lp > self.engine.logprobs_topk:
            raise BadRequest(
                f"logprobs top-N must be 0..{self.engine.logprobs_topk} "
                "(the engine's logprobs_topk build setting)")
        return lp

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
        stop = self._stop_sequences(body.get("stop"))
        lp_n = self._logprobs_n(body)
        seed = body.get("seed")
        if seed is not None and (not isinstance(seed, int)
                                 or isinstance(seed, bool) or seed < 0):
            raise BadRequest("seed must be a non-negative integer")
        deadline = body.get("timeout", self.timeout_s)
        try:
            rid = self.engine.submit(
                ids, int(body.get("max_tokens", 16)),
                temperature=float(body.get("temperature", 0.0)),
                top_k=int(body.get("top_k", 0)),
                top_p=float(body.get("top_p", 1.0)),
                presence_penalty=float(body.get("presence_penalty", 0.0)),
                frequency_penalty=float(body.get("frequency_penalty", 0.0)),
                seed=seed, stop=stop,
                deadline_s=None if deadline is None else float(deadline))
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
        choice: dict[str, Any] = {"index": 0,
                                  "text": self.tokenizer.decode(tokens),
                                  "token_ids": tokens,
                                  "finish_reason": reason}
        if lp_n is not None:
            logprobs: dict[str, Any] = {
                "tokens": [self.tokenizer.decode([t]) for t in tokens],
                "token_logprobs": self.engine.result_logprobs(rid),
                "top_logprobs": None}
            if lp_n:
                logprobs["top_logprobs"] = [
                    {str(t): v for t, v in sorted(
                        d.items(), key=lambda kv: -kv[1])[:lp_n]}
                    for d in self.engine.result_top_logprobs(rid)]
            choice["logprobs"] = logprobs
        self.engine.release(rid)
        return {"id": f"cmpl-{rid}", "object": "text_completion",
                "created": int(time.time()), "model": self.model,
                "choices": [choice],
                "usage": {"prompt_tokens": len(ids),
                          "completion_tokens": len(tokens),
                          "total_tokens": len(ids) + len(tokens)}}
