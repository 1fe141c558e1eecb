"""The port's model server (counterpart of kubeflow_tpu/serving/
server.py's `ModelServer`): the V1, V2 and OpenAI routes over a
`serving/model.py` `ModelRepository` of named models, `LLMModel`s and
tensor models alike.

    POST /openai/v1/completions        {"model"?, "prompt": str | [ids],
                                        "max_tokens", "temperature",
                                        "top_k", "top_p", "stop",
                                        "presence_penalty",
                                        "frequency_penalty", "seed",
                                        "logprobs", "n", "best_of", "echo",
                                        "timeout", "user", "stream"}
    POST /openai/v1/chat/completions   the same with "messages" for
                                        "prompt" (no echo)
    POST /v1/models/<m>:predict        {"instances": [...]} -> {"predictions":
                                        [...]} (an LLMModel's instances:
                                        {"prompt_tokens",
                                        "max_new_tokens", ...})
    POST /v2/models/<m>/infer          {"id"?, "inputs": [{"name":
                                        "prompt_tokens", "shape",
                                        "datatype", "data"}, ...]} ->
                                        {"model_name", "id", "outputs":
                                        [{"name", ...}, ...]}
    GET  /v1/models | /v2/models       the repository's model names
    GET  /v2/models/<m> | /v2/models/<m>/ready
    GET  /v2/health/live | /v2/health/ready
    GET  /healthz                      liveness, uptime, build stamp, and
                                        each model's prefix cache,
                                        supervisor, disaggregation,
                                        device layout and SLO window
    GET  /metrics                      Prometheus text (obs/metrics.py)

The wire format is the JAX server's. A non-streaming answer is one JSON
object whose choices carry "text" (or a chat "message"), "token_ids",
"finish_reason" and, with `logprobs`, "token_ids"/"tokens"/
"token_logprobs" and the top-N alternatives keyed by token id; `usage`
has prompt, completion and total tokens, `cached_tokens` (and under
`prompt_tokens_details`) on a prefix-cache model, `cancelled` when a
returned choice was. With "stream": true the answer is server-sent
events: one `data: {...}` chunk per token with its text delta and
token_id (and logprob), `: keepalive` comments while the supervisor
restarts the engine, a final chunk with the finish_reason and the usage,
then one `data: [DONE]`; a failure after the headers is an error event
before the [DONE]. A client that hangs up mid-stream is noticed before
the next write (`_client_gone`) and its request cancelled.

The server serves a repository (a replica of one InferenceService with
its TrainedModels, which a `serving/agent.py` `MultiModelAgent` pulls
into and evicts from the same repository). `CompletionServer(model)` is a
repository of one: that model is the server's own, loaded here if it is
not yet and unloaded by stop(); `CompletionServer(repository=...)` serves
a repository its owner loads and unloads. Requests route by the model's
name (completions and chat by the body's "model"); a name the repository
does not hold answers 404. Two deliberate differences from the JAX
server: "model" may be left out when the server has its own model (or
the repository holds one), and `stop` may also give token-id lists. The
server speaks to engines only through the models: it names no engine
class, and `from_config` builds an `LLMModel`, whose supervisor factory
is where an engine is made. The OpenAI `user` field is the request's tenant: its scheduler
queue, fair share and admission caps, and its degraded-mode priority. A
refusal by the scheduler or the supervisor (QueueFull, and its subtypes
TenantOverQuota and TenantShed) answers 503, as the JAX server does.

The V1 `predict` and V2 `infer` routes are the JAX server's: with a
`payload_logger` (`serving/agent.py` `PayloadLogger`) each request is
recorded before it runs and its answer, an error included, after, under
one id; with `batching` ({model name: {maxBatchSize, maxLatencyMs}})
that model's predict is wrapped in a `DynamicBatcher` of its own, made at
its first request. /healthz and readiness look at every model, and a
supervisor out of restarts in any of them makes the replica not ready
(`ModelRepository.permanently_failed`). With `grpc=True` a
`GrpcInferenceServer` (`serving/grpc_server.py`) serves the same
repository over the Open Inference Protocol beside the HTTP server, with
the same batching config, started and stopped with it. `from_config` takes the
predictor-level keys the JAX controller reads: `grpc`, `logger` ({mode,
path | url}) and `batching`.
"""

from __future__ import annotations

import json
import math
import select
import socket
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any

from kubeflow_tpu_torch.obs import metrics as obs_metrics
from kubeflow_tpu_torch.obs.build import build_stamp
from kubeflow_tpu_torch.obs.metrics import render_metrics
from kubeflow_tpu_torch.obs.trace import TRACE_HEADER, TRACER, new_trace_id
from kubeflow_tpu_torch.serving.agent import PayloadLogger
from kubeflow_tpu_torch.serving.batching import DynamicBatcher
from kubeflow_tpu_torch.serving.llm_runtime import LLMModel, ProtocolError
from kubeflow_tpu_torch.serving.model import ModelError, ModelRepository
from kubeflow_tpu_torch.serving.protocol import (InferRequest, InferResponse,
                                                 v1_encode)
from kubeflow_tpu_torch.serving.scheduler import PromptTooLong, QueueFull
from kubeflow_tpu_torch.serving.tokenizer import (StreamDecoder,
                                                  chat_prompt_ids)


class NotReadyError(Exception):
    """The model exists but cannot serve yet (HTTP 503, retryable)."""


#: the exceptions that answer a completion with a status of their own;
#: any other (an engine fault) is a 500
_COMPLETION_ERRORS = (ProtocolError, ModelError, NotReadyError,
                      PromptTooLong, QueueFull)


def _client_gone(sock) -> bool:
    """True when the streaming client hung up. A write into a dead socket
    fails only once the kernel's send buffer fills, so without this an
    abandoned stream decodes on for many chunks. The request body was
    read whole and an SSE client sends nothing more (Connection: close),
    so a readable socket means EOF or RST (or a stray byte, treated the
    same, since MSG_PEEK never drains it). A client that half-closes its
    write side and keeps reading is treated as gone too."""
    try:
        r, _, _ = select.select([sock], [], [], 0)
        if not r:
            return False
        sock.recv(1, socket.MSG_PEEK | socket.MSG_DONTWAIT)
    except (BlockingIOError, InterruptedError):
        return False   # a spurious wakeup or EINTR: still there
    except (OSError, ValueError):
        return True    # closed or invalid descriptor
    return True


def ready_models(repository: ModelRepository) -> bool:
    """Every model ready and no supervisor out of restarts (the replica's
    readiness: /v2/health/ready, gRPC ServerReady)."""
    return (all(repository.ready(n) for n in repository.names())
            and not repository.permanently_failed())


class CompletionServer:
    """A threaded HTTP server over a ModelRepository (each request on its
    own thread; an LLMModel steps its engine on its own). `model` makes a
    repository of one whose model is the server's own: loaded here if it
    is not yet, and unloaded by stop()."""

    def __init__(self, model=None, *, repository: ModelRepository | None = None,
                 name: str = "kubeflow-tpu-torch-server",
                 host: str = "127.0.0.1", port: int = 0,
                 batching: dict[str, Any] | None = None,
                 payload_logger: PayloadLogger | None = None,
                 grpc: bool = False):
        if (model is None) == (repository is None):
            raise ValueError("give a model or a repository")
        self.repository = repository or ModelRepository()
        #: the server's own model (None for a repository server)
        self.model = model
        self.name = name
        self.payload_logger = payload_logger
        self._batch_cfg = batching or {}
        self._batchers: dict[str, DynamicBatcher] = {}
        self._batch_lock = threading.Lock()
        self._owns_model = model is not None and not model.ready
        if model is not None:
            self.repository.register(model)   # loads it if not ready
        server = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

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
                try:
                    if self.path == "/metrics":
                        body = render_metrics().encode()
                        self.send_response(200)
                        self.send_header("Content-Type",
                                         "text/plain; version=0.0.4")
                        self.send_header("Content-Length", str(len(body)))
                        self.end_headers()
                        self.wfile.write(body)
                        return
                    self._send(*server._handle_get(self.path))
                except Exception as e:
                    self._send(500, {"error": str(e)})

            def do_POST(self):
                try:
                    raw = self.rfile.read(
                        int(self.headers.get("Content-Length", 0)))
                    if self.path in ("/openai/v1/completions",
                                     "/openai/v1/chat/completions"):
                        chat = self.path.endswith("chat/completions")
                        try:
                            body = json.loads(raw) if raw else {}
                        except json.JSONDecodeError as e:
                            return self._send(400,
                                              {"error": f"bad json: {e}"})
                        if not isinstance(body, dict):
                            return self._send(
                                400, {"error": "body must be an object"})
                        # the caller's trace id, or minted here, the edge
                        trace = (self.headers.get(TRACE_HEADER)
                                 or new_trace_id())
                        if body.get("stream"):
                            return server._stream_completion(self, body,
                                                             chat, trace)
                        return self._send(
                            *server._completion(body, chat, trace))
                    self._send(*server._handle_post(self.path, raw))
                except Exception as e:
                    self._send(500, {"error": str(e)})

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread: threading.Thread | None = None
        self._t_start = time.monotonic()
        self._stopped = False
        #: the OIP gRPC server beside this one (grpc=True), else None
        self.grpc_server = None
        if grpc:
            from kubeflow_tpu_torch.serving.grpc_server import \
                GrpcInferenceServer

            try:
                self.grpc_server = GrpcInferenceServer(
                    self.repository, host=host, batching=batching)
            except BaseException:
                self._close()
                raise

    @classmethod
    def from_config(cls, params, cfg, config: dict[str, Any], *,
                    device="cuda", model: str = "llama",
                    tokenizer: Any = None, grpc: bool = False,
                    logger: dict[str, Any] | None = None,
                    batching: dict[str, Any] | None = None,
                    **kw) -> "CompletionServer":
        """A server over a new LLMModel of `params`/`cfg` built from a
        serving config dict (the LLMModel keys), loaded now; `grpc`,
        `logger` ({mode, path | url}) and `batching` ({maxBatchSize,
        maxLatencyMs}) are the InferenceService predictor's keys of those
        names."""
        m = LLMModel(model, params=params, llama_config=cfg, device=device,
                     tokenizer=tokenizer, **config)
        if logger:
            kw["payload_logger"] = PayloadLogger(
                path=logger.get("path"), url=logger.get("url"),
                mode=logger.get("mode", "all"))
        if batching:
            kw["batching"] = {m.name: batching}
        return cls(m, grpc=grpc, **kw)

    # -- lifecycle ------------------------------------------------------------

    def start(self) -> "CompletionServer":
        self._t_start = time.monotonic()
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True,
                                        name=f"model-server-{self.port}")
        self._thread.start()
        if self.grpc_server is not None:
            self.grpc_server.start()
        return self

    def _close(self) -> None:
        """Close the sockets, the gRPC server and the batchers."""
        self._stopped = True
        if self._thread is not None:
            self._httpd.shutdown()
        self._httpd.server_close()
        if self.grpc_server is not None:
            self.grpc_server.stop()
        with self._batch_lock:
            for b in self._batchers.values():
                b.stop()
            self._batchers.clear()

    def stop(self) -> None:
        """Stop serving, and unload the model if this server loaded it."""
        self._close()
        if self._owns_model:
            self._owns_model = False
            self.repository.unload(self.model.name)

    @property
    def alive(self) -> bool:
        return (not self._stopped and self._thread is not None
                and self._thread.is_alive())

    @property
    def url(self) -> str:
        host, port = self._httpd.server_address[:2]
        return f"http://{host}:{port}"

    @property
    def engine(self):
        """The model's live engine (see LLMModel.engine)."""
        return self.model.engine

    @property
    def ready(self) -> bool:
        return ready_models(self.repository)

    @property
    def grpc_address(self) -> str | None:
        """host:port of the gRPC server beside this one, if any."""
        return (self.grpc_server.address if self.grpc_server is not None
                else None)

    def _model(self, name: str | None):
        """The model a request names; without a name the server's own
        model, or the repository's only one."""
        if name is None:
            if self.model is not None:
                return self.model
            names = self.repository.names()
            if len(names) != 1:
                raise ProtocolError('"model" is required')
            name = names[0]
        return self.repository.get(name)

    # -- routing --------------------------------------------------------------

    def health(self) -> dict[str, Any]:
        """The /healthz payload: answering at all means the serving thread
        is alive; then each model's prefix cache counters, supervisor
        recovery state, disaggregation, device layout and SLO window."""
        body: dict[str, Any] = {
            "alive": self.alive, "name": self.name,
            "uptime_s": round(time.monotonic() - self._t_start, 3),
            "build": build_stamp()}
        for mname in self.repository.names():
            try:
                model = self.repository.get(mname)
                mm = model.metrics() or {}
            except Exception:
                continue   # liveness answers even if a model is broken
            self._model_health(body, mname, model, mm)
        return body

    @staticmethod
    def _model_health(body: dict[str, Any], mname: str, model,
                      mm: dict[str, Any]) -> None:
        """One model's sections of the /healthz payload, keyed by name."""
        try:
            s = model.slo_tracker.summary()
            if s["aggregate"]["n"]:
                body.setdefault("slo", {})[mname] = s
        except Exception:
            pass
        if mm.get("prefix_cache"):
            body.setdefault("kv_cache", {})[mname] = dict(
                mm["prefix_cache"], kv_layout=mm.get("kv_layout", "slab"))
        if mm.get("mesh"):
            body.setdefault("mesh", {})[mname] = mm["mesh"]
        sup = mm.get("supervisor")
        if sup:
            body.setdefault("supervisor", {})[mname] = {
                "restarts": sup.get("restarts", 0),
                "permanent_failed": bool(sup.get("permanent_failed",
                                                 False)),
                "last_mttr_s": sup.get("last_mttr_s"),
                "journal_depth": sup.get("journal_depth", 0),
                "in_flight": sup.get("in_flight", 0),
                "degraded_rejections": sup.get("shed", 0)}
        dg = mm.get("disagg")
        if dg:
            # backpressure as an operator sees it: the prefill queue, the
            # blocks in flight, the handoff's transport and counts
            body.setdefault("disagg", {})[mname] = {
                "queue_depth": dg.get("queue_depth", 0),
                "inflight_prefills": dg.get("inflight_prefills", 0),
                "blocks_in_flight": dg.get("blocks_in_flight", 0),
                "queue_wait_ms_mean": dg.get("queue_wait_ms_mean"),
                "bypass": dg.get("bypass", 0),
                "handoff": dg.get("handoff"),
                "prefill_restarts": dg.get("prefill_restarts", 0),
                "prefill_permanent_failed": bool(
                    dg.get("prefill_permanent_failed", False))}

    def _handle_get(self, path: str) -> tuple[int, dict[str, Any]]:
        if path == "/healthz":
            return 200, self.health()
        if path in ("/", "/v2"):
            return 200, {"name": self.name, "version": "2",
                         "extensions": ["health", "models", "metrics"]}
        if path == "/v2/health/live":
            return 200, {"live": True}
        if path == "/v2/health/ready":
            ready = self.ready
            return (200 if ready else 503), {"ready": ready}
        if path in ("/v1/models", "/v2/models"):
            return 200, {"models": self.repository.names()}
        parts = path.strip("/").split("/")
        if len(parts) >= 3 and parts[:2] == ["v2", "models"]:
            name = parts[2]
            if len(parts) == 4 and parts[3] == "ready":
                ok = self.repository.ready(name)
                return (200 if ok else 503), {"name": name, "ready": ok}
            if len(parts) == 3:
                try:
                    m = self.repository.get(name)
                except ModelError as e:
                    return 404, {"error": str(e)}
                return 200, {"name": name, "platform": "pytorch-cuda",
                             "inputs": m.input_spec(),
                             "outputs": m.output_spec()}
        return 404, {"error": f"no route {path}"}

    def _handle_post(self, path: str, raw: bytes
                     ) -> tuple[int, dict[str, Any]]:
        try:
            body = json.loads(raw) if raw else {}
        except json.JSONDecodeError as e:
            return 400, {"error": f"bad json: {e}"}
        parts = path.strip("/").split("/")
        try:
            if len(parts) == 3 and parts[:2] == ["v1", "models"]:
                name, _, verb = parts[2].partition(":")
                return self._v1(name, verb or "predict", body)
            if (len(parts) == 4 and parts[:2] == ["v2", "models"]
                    and parts[3] == "infer"):
                return self._v2_infer(parts[2], body)
        except ProtocolError as e:
            return 400, {"error": str(e)}
        except ModelError as e:
            return 404, {"error": str(e)}
        return 404, {"error": f"no route {path}"}

    # -- OpenAI-style completions --------------------------------------------

    def _completion_request(self, body: dict[str, Any], chat: bool = False):
        """The request as (model, payload); raises ProtocolError (400),
        ModelError (404) or NotReadyError (503)."""
        m = self._model(body.get("model"))
        if not hasattr(m, "stream") or not hasattr(m, "tokenizer"):
            raise ProtocolError(
                f"model {m.name!r} does not serve text completions")
        if not m.ready:
            raise NotReadyError(f"model {m.name!r} is not ready")
        if chat:
            messages = body.get("messages")
            if not isinstance(messages, list) or not messages:
                raise ProtocolError('"messages" must be a non-empty list')
            for msg in messages:
                if not (isinstance(msg, dict)
                        and isinstance(msg.get("role"), str)
                        and isinstance(msg.get("content"), str)):
                    raise ProtocolError(
                        "each message needs string role and content")
            try:
                ids = chat_prompt_ids(m.tokenizer, messages)
            except Exception as e:
                raise ProtocolError(
                    f"chat template rejected messages: {e}") from e
        else:
            prompt = body.get("prompt", "")
            if isinstance(prompt, list):
                if not all(isinstance(t, int) for t in prompt):
                    raise ProtocolError(
                        "prompt must be a string or a list of token ids "
                        "(batched string prompts are not supported)")
                ids = list(prompt)
            elif isinstance(prompt, str):
                ids = m.tokenizer.encode(prompt)
            else:
                raise ProtocolError("prompt must be a string or token ids")
        if not ids:
            raise ProtocolError("prompt must be non-empty")
        try:
            max_new = int(body.get("max_tokens", 16))
        except (TypeError, ValueError):
            raise ProtocolError("max_tokens must be an int") from None
        try:
            temperature = float(body.get("temperature", 0.0))
        except (TypeError, ValueError):
            raise ProtocolError("temperature must be a number") from None
        if not (math.isfinite(temperature) and 0 <= temperature <= 100):
            raise ProtocolError("temperature must be finite and in [0, 100]")
        payload: dict[str, Any] = {"prompt_tokens": ids,
                                   "max_new_tokens": max_new,
                                   "temperature": temperature}
        try:
            top_k = int(body.get("top_k", 0))
        except (TypeError, ValueError):
            raise ProtocolError("top_k must be an int") from None
        kmax = m._sample_k_max
        if not 0 <= top_k <= kmax:
            raise ProtocolError(f"top_k must be 0..{kmax}")
        try:
            top_p = float(body.get("top_p", 1.0))
        except (TypeError, ValueError):
            raise ProtocolError("top_p must be a number") from None
        if not (math.isfinite(top_p) and 0 < top_p <= 1):
            raise ProtocolError("top_p must be in (0, 1]")
        stop = body.get("stop")
        if stop is not None:
            if isinstance(stop, str):
                stop = [stop]
            if (not isinstance(stop, list) or not 1 <= len(stop) <= 8
                    or not all((isinstance(s, str) and s)
                               or (isinstance(s, list) and s
                                   and all(isinstance(t, int)
                                           and not isinstance(t, bool)
                                           for t in s))
                               for s in stop)):
                raise ProtocolError(
                    "stop must be a non-empty string or a list of up to 8 "
                    "strings or token-id lists")
            payload["stop"] = stop
        lp_req = body.get("logprobs", False)
        if lp_req is not None and not isinstance(lp_req, (bool, int)):
            raise ProtocolError("logprobs must be a bool or an int")
        lp_n = int(lp_req or 0) if not isinstance(lp_req, bool) else 0
        if lp_n < 0 or lp_n > m._logprobs_topk:
            raise ProtocolError(
                f"logprobs top-N must be 0..{m._logprobs_topk}"
                " (the engine's logprobs_topk build setting)")
        payload["want_logprobs"] = bool(lp_req)
        payload["logprobs_n"] = lp_n
        payload["top_k"] = top_k
        payload["top_p"] = top_p
        for fname in ("presence_penalty", "frequency_penalty"):
            try:
                v = float(body.get(fname, 0.0))
            except (TypeError, ValueError):
                raise ProtocolError(f"{fname} must be a number") from None
            if not (math.isfinite(v) and -2 <= v <= 2):
                raise ProtocolError(f"{fname} must be in [-2, 2]")
            payload[fname] = v
        seed = body.get("seed")
        if seed is not None:
            if not isinstance(seed, int) or isinstance(seed, bool) \
                    or seed < 0:
                raise ProtocolError("seed must be a non-negative integer")
            payload["seed"] = seed
        # OpenAI `user` is the engine's tenant (the prefix cache's rows)
        user = body.get("user")
        if user is not None:
            if not isinstance(user, str) or not 1 <= len(user) <= 256:
                raise ProtocolError("user must be a string of 1..256 chars")
            payload["tenant"] = user
        try:
            n = int(body.get("n", 1))
            best_of = int(body.get("best_of", n))
        except (TypeError, ValueError):
            raise ProtocolError("n/best_of must be integers") from None
        if not 1 <= n <= 8:
            raise ProtocolError("n must be 1..8")
        if not n <= best_of <= 8:
            raise ProtocolError("best_of must be n..8")
        payload["n"] = n
        payload["best_of"] = best_of
        echo = body.get("echo", False)
        if not isinstance(echo, bool):
            raise ProtocolError("echo must be a boolean")
        if echo and chat:
            raise ProtocolError("echo is not supported for chat")
        payload["echo"] = echo
        if body.get("timeout") is not None:
            try:
                payload["deadline_s"] = float(body["timeout"])
            except (TypeError, ValueError):
                raise ProtocolError("timeout must be a number") from None
            if payload["deadline_s"] <= 0:
                raise ProtocolError("timeout must be positive")
        return m, payload

    @staticmethod
    def _completion_error(e: Exception) -> tuple[int, dict[str, Any]]:
        code = (404 if isinstance(e, ModelError)
                else 503 if isinstance(e, (NotReadyError, QueueFull))
                else 400)   # ProtocolError / PromptTooLong
        return code, {"error": str(e)}

    def _build_choice(self, m, payload: dict[str, Any],
                      result: dict[str, Any], index: int,
                      chat: bool) -> dict[str, Any]:
        """One OpenAI choice from an engine result. With echo the prompt
        tokens lead the completion, their logprobs null."""
        tokens, reason = result["token_ids"], result["finish_reason"]
        prompt_ids = list(payload["prompt_tokens"])
        echo = bool(payload.get("echo"))
        out_tokens = (prompt_ids + tokens) if echo else tokens
        text = m.tokenizer.decode(out_tokens)
        choice: dict[str, Any] = {"index": index, "token_ids": out_tokens,
                                  "finish_reason": reason}
        if payload.get("want_logprobs"):
            pad: list[Any] = [None] * len(prompt_ids) if echo else []
            lp: dict[str, Any] = {
                "token_ids": out_tokens,
                "tokens": [m.tokenizer.decode([t]) for t in out_tokens],
                "token_logprobs": pad + result["logprobs"]}
            n = payload.get("logprobs_n", 0)
            if n:
                lp["top_logprobs"] = pad + [
                    {str(t): v for t, v in sorted(
                        d.items(), key=lambda kv: -kv[1])[:n]}
                    for d in result["top_logprobs"]]
            choice["logprobs"] = lp
        if chat:
            choice["message"] = {"role": "assistant", "content": text}
        else:
            choice["text"] = text
        return choice

    def _completion(self, body: dict[str, Any], chat: bool = False,
                    trace: str | None = None) -> tuple[int, dict[str, Any]]:
        t0 = time.perf_counter()
        t_mono = time.monotonic()
        try:
            m, payload = self._completion_request(body, chat)
            if trace:
                payload["trace"] = str(trace)
            best_of = payload.get("best_of", 1)
            if best_of <= 1:
                results = [m.complete(payload)]
            else:
                # best_of clones share the batch; seeded clones take
                # seed + i, so their samples differ reproducibly
                seed = payload.get("seed")
                clones = [dict(payload) if seed is None
                          else dict(payload, seed=seed + i)
                          for i in range(best_of)]
                results = m.complete_many(clones)
        except _COMPLETION_ERRORS as e:
            return self._completion_error(e)
        self._observe(m.name, "completions", time.perf_counter() - t0)
        TRACER.record_span("server.http", "http", trace, t_mono,
                           time.monotonic(), model=m.name,
                           verb="completions", streamed=False)
        n_choices = payload.get("n", 1)
        if len(results) > 1:
            # best_of: the n best by mean logprob
            def score(r):
                lps = r["logprobs"]
                return sum(lps) / max(1, len(lps))

            results = sorted(results, key=score, reverse=True)
        gen_tokens = sum(len(r["token_ids"]) for r in results)
        choices = [self._build_choice(m, payload, r, i, chat)
                   for i, r in enumerate(results[:n_choices])]
        usage = {"prompt_tokens": len(payload["prompt_tokens"]),
                 "completion_tokens": gen_tokens,
                 "total_tokens":
                     len(payload["prompt_tokens"]) + gen_tokens}
        # one prompt, one number: the most any candidate reused
        if any("cached_tokens" in r for r in results):
            cached = min(usage["prompt_tokens"],
                         max(r.get("cached_tokens") or 0 for r in results))
            usage["cached_tokens"] = cached
            usage["prompt_tokens_details"] = {"cached_tokens": cached}
        n_cancelled = sum(r["finish_reason"] == "cancelled"
                          for r in results[:n_choices])
        if n_cancelled:
            usage["cancelled"] = n_cancelled
        timing = next((r["timing"] for r in results if r.get("timing")),
                      None)
        if timing:
            for k, v in timing.items():
                if v is not None:
                    usage[k] = v
        return 200, {
            "object": "chat.completion" if chat else "text_completion",
            "model": m.name, "choices": choices, "usage": usage}

    def _stream_completion(self, handler, body: dict[str, Any],
                           chat: bool = False,
                           trace: str | None = None) -> None:
        """Server-sent events (module docstring). Connection: close, so
        the chunks go out as written, without chunked framing."""
        finish: list[str] = []
        t_mono = time.monotonic()
        try:
            m, payload = self._completion_request(body, chat)
            if trace:
                payload["trace"] = str(trace)
            if payload.get("best_of", 1) > 1 or payload.get("n", 1) > 1:
                raise ProtocolError(
                    "streaming supports n=1 / best_of=1 only")
            # m.stream submits now: PromptTooLong and QueueFull raise
            # here, before the 200 and the SSE headers
            stream_info: dict[str, Any] = {}
            token_iter = m.stream(payload, on_finish=finish.append,
                                  info=stream_info)
        except _COMPLETION_ERRORS as e:
            return handler._send(*self._completion_error(e))
        t0 = time.perf_counter()
        handler.send_response(200)
        handler.send_header("Content-Type", "text/event-stream")
        handler.send_header("Cache-Control", "no-cache")
        handler.send_header("Connection", "close")
        handler.end_headers()
        handler.close_connection = True
        decoder = StreamDecoder(m.tokenizer)
        first = [True]
        want_lp = payload.get("want_logprobs")
        n_sent = 0

        def chunk_of(text: str, token_id: int | None = None,
                     reason: str | None = None,
                     logprob: float | None = None,
                     usage: dict[str, Any] | None = None) -> bytes:
            choice: dict[str, Any] = {"index": 0, "finish_reason": reason}
            if chat:
                choice["delta"] = ({"role": "assistant", "content": text}
                                   if first[0] else {"content": text})
                first[0] = False
            else:
                choice["text"] = text
            if token_id is not None:
                choice["token_id"] = token_id
            if logprob is not None:
                choice["logprob"] = logprob
            out: dict[str, Any] = {
                "object": ("chat.completion.chunk" if chat
                           else "text_completion.chunk"),
                "model": m.name, "choices": [choice]}
            if usage is not None:
                out["usage"] = usage
            return ("data: " + json.dumps(out) + "\n\n").encode()

        try:   # past the headers a disconnect must not reach do_POST's 500
            if payload.get("echo"):
                handler.wfile.write(chunk_of(
                    m.tokenizer.decode(list(payload["prompt_tokens"]))))
                handler.wfile.flush()
            try:
                for tok, lp in token_iter:
                    if _client_gone(handler.connection):
                        raise BrokenPipeError("stream client disconnected")
                    if tok is None:
                        # a keepalive sentinel (the supervisor is
                        # restarting the engine): an SSE comment, which
                        # also probes the socket
                        handler.wfile.write(b": keepalive\n\n")
                        handler.wfile.flush()
                        continue
                    n_sent += 1
                    handler.wfile.write(chunk_of(
                        decoder.push(tok), token_id=int(tok),
                        logprob=(float(lp) if want_lp else None)))
                    handler.wfile.flush()
            except (BrokenPipeError, ConnectionResetError, OSError):
                raise   # the socket died: to the disconnect path below
            except Exception as e:
                handler.wfile.write(
                    f"data: {json.dumps({'error': str(e)})}\n\n".encode())
            else:
                tail = decoder.flush()
                reason = finish[0] if finish else "length"
                n_prompt = len(payload["prompt_tokens"])
                usage = {"prompt_tokens": n_prompt,
                         "completion_tokens": n_sent,
                         "total_tokens": n_prompt + n_sent}
                if "cached_tokens" in stream_info:
                    usage["cached_tokens"] = stream_info["cached_tokens"]
                    usage["prompt_tokens_details"] = {
                        "cached_tokens": stream_info["cached_tokens"]}
                for k, v in (stream_info.get("timing") or {}).items():
                    if v is not None:
                        usage[k] = v
                if reason == "cancelled":
                    usage["cancelled"] = 1
                handler.wfile.write(chunk_of(tail, reason=reason,
                                             usage=usage))
            handler.wfile.write(b"data: [DONE]\n\n")
            handler.wfile.flush()
        except (BrokenPipeError, ConnectionResetError, OSError):
            return   # the client left; closing the generator cancels
        finally:
            # a no-op for a drained generator; a live one (the client
            # left) cancels its request and leaves it to the engine thread
            token_iter.close()
        self._observe(m.name, "completions", time.perf_counter() - t0)
        TRACER.record_span("server.http", "http", trace, t_mono,
                           time.monotonic(), model=m.name,
                           verb="completions", streamed=True,
                           tokens_sent=n_sent)

    # -- V1 predict and V2 infer ----------------------------------------------

    def _predictor(self, model):
        """The model's predict, through its batcher when `batching` names
        it (made at the model's first request)."""
        cfg = self._batch_cfg.get(model.name)
        if not cfg:
            return model.predict
        with self._batch_lock:
            if model.name not in self._batchers:
                self._batchers[model.name] = DynamicBatcher.from_config(
                    model.predict, cfg)
            return self._batchers[model.name]

    def _logged(self, name: str, t0: float, code: int,
                resp: dict[str, Any], rid: str | None
                ) -> tuple[int, dict[str, Any]]:
        if self.payload_logger is not None and rid is not None:
            self.payload_logger.log_response(
                name, rid, resp, (time.perf_counter() - t0) * 1e3, code)
        return code, resp

    def _log_request(self, name: str, body: Any) -> str | None:
        if self.payload_logger is None:
            return None
        rid = self.payload_logger.next_id()
        self.payload_logger.log_request(name, rid, body)
        return rid

    def _log_error(self, name: str, t0: float, rid: str | None,
                   exc: Exception) -> None:
        """Pair an error with its request record, under the status
        _handle_post answers it with."""
        if self.payload_logger is None or rid is None:
            return
        code = (400 if isinstance(exc, ProtocolError)
                else 404 if isinstance(exc, ModelError) else 500)
        self._logged(name, t0, code, {"error": str(exc)}, rid)

    def _v1(self, name: str, verb: str, body: Any
            ) -> tuple[int, dict[str, Any]]:
        rid = self._log_request(name, body)
        t0 = time.perf_counter()
        try:
            model = self.repository.get(name)
            if not model.ready:
                return self._logged(name, t0, 503,
                                    {"error": f"model {name!r} not ready"},
                                    rid)
            if not isinstance(body, dict) or "instances" not in body:
                raise ProtocolError('V1 request must carry "instances"')
            t_infer = time.perf_counter()
            payload = model.preprocess(body["instances"])
            if verb == "predict":
                result = self._predictor(model)(payload)
            elif verb == "explain":
                result = model.explain(payload)
            else:
                return self._logged(name, t0, 400,
                                    {"error": f"unknown verb {verb!r}"}, rid)
            result = model.postprocess(result)
            self._observe(name, verb, time.perf_counter() - t_infer)
            return self._logged(name, t0, 200, v1_encode(result), rid)
        except Exception as e:
            self._log_error(name, t0, rid, e)
            raise

    def _v2_infer(self, name: str, body: Any) -> tuple[int, dict[str, Any]]:
        rid = self._log_request(name, body)
        t0 = time.perf_counter()
        try:
            model = self.repository.get(name)
            if not model.ready:
                return self._logged(name, t0, 503,
                                    {"error": f"model {name!r} not ready"},
                                    rid)
            req = InferRequest.from_json(name, body)
            t_infer = time.perf_counter()
            payload = model.preprocess(req.as_dict())
            result = model.postprocess(self._predictor(model)(payload))
            self._observe(name, "infer", time.perf_counter() - t_infer)
            return self._logged(
                name, t0, 200,
                InferResponse.from_result(name, result, id=req.id).to_json(),
                rid)
        except Exception as e:
            self._log_error(name, t0, rid, e)
            raise

    def _observe(self, model: str, verb: str, dt: float) -> None:
        obs_metrics.HTTP_REQUESTS.inc(model=model, verb=verb)
        obs_metrics.HTTP_LATENCY.observe(dt, model=model, verb=verb)
