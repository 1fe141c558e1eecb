"""Real-socket HTTP/SSE load client (counterpart of
kubeflow_tpu/loadgen/http_client.py).

`run_trace`/`run_scenario` replay through the in-process engine submit
path; everything they measure therefore EXCLUDES the HTTP layer — the
server, the SSE framing, the keepalive machinery that holds a stream open
across an engine restart. This module replays through an actual TCP
socket against a running server, speaking the OpenAI SSE protocol, so
chaos claims ("a streaming client survives a mid-stream engine crash")
are measured where the client lives, not where the engine does.

`stream_completion` drives ONE SSE completion and returns everything a
verifier needs: the token ids actually delivered, keepalive comments
observed (the restart-window liveness signal), typed error events,
duplicate-[DONE]/usage counting, and wall-clock marks; its first data
event is the client's TTFT. `run_trace_http` replays a whole loadgen
trace open-loop over sockets and reduces to the same `loadgen.slo`
summary as the in-process runner, so HTTP-path and engine-path records
are directly comparable.
"""

from __future__ import annotations

import http.client
import json
import socket
import threading
import time
from typing import Any

from kubeflow_tpu_torch.loadgen.slo import RequestRecord, summarize
from kubeflow_tpu_torch.loadgen.trace import Trace


def stream_completion(port: int, payload: dict[str, Any], *,
                      host: str = "127.0.0.1",
                      path: str = "/openai/v1/completions",
                      headers: dict[str, str] | None = None,
                      timeout_s: float = 60.0,
                      cancel_after_s: float | None = None
                      ) -> dict[str, Any]:
    """Drive one streaming completion over a raw socket.

    Returns a dict:
      status          HTTP status (200 = the stream committed)
      body            decoded JSON body for non-200 answers (else None)
      token_ids       every token chunk's token_id, in delivery order
      text            concatenated text deltas
      finish_reason   from the final chunk (None if the stream died)
      usage           the final chunk's usage object (None if absent)
      usage_count     how many chunks carried a usage object (MUST be 1
                      on a healthy stream — the no-duplicate contract)
      done_count      how many `data: [DONE]` lines arrived (MUST be 1)
      keepalives      SSE comment lines observed (restart-window sign)
      errors          data events carrying an "error" member (typed
                      mid-stream failures, permanent-fail terminals)
      client_cancelled True when cancel_after_s closed the socket first
      t_request_s / t_first_token_s / t_done_s   absolute monotonic marks
    """
    out: dict[str, Any] = {
        "status": None, "body": None, "token_ids": [], "text": "",
        "finish_reason": None, "usage": None, "usage_count": 0,
        "done_count": 0, "keepalives": 0, "errors": [],
        "client_cancelled": False,
        "t_request_s": time.monotonic(), "t_first_token_s": None,
        "t_done_s": None,
    }
    body = dict(payload)
    body.setdefault("stream", True)
    conn = http.client.HTTPConnection(host, port, timeout=timeout_s)
    resp = None
    try:
        hdrs = {"Content-Type": "application/json"}
        if headers:
            hdrs.update(headers)
        conn.request("POST", path, body=json.dumps(body).encode(),
                     headers=hdrs)
        resp = conn.getresponse()
        out["status"] = resp.status
        ctype = resp.getheader("Content-Type") or ""
        if not ctype.startswith("text/event-stream"):
            raw = resp.read()
            try:
                out["body"] = json.loads(raw) if raw else None
            except ValueError:
                out["body"] = {"raw": raw.decode("utf-8", "replace")}
            return out
        deadline = time.monotonic() + timeout_s
        cancel_at = (out["t_request_s"] + cancel_after_s
                     if cancel_after_s is not None else None)
        # with Connection: close responses http.client detaches the
        # socket INTO the response (conn.sock goes None at
        # getresponse()), so the wake-up timeouts must be set on the
        # response's underlying socket, not the connection's
        sock = conn.sock
        if sock is None:
            raw = getattr(getattr(resp, "fp", None), "raw", None)
            sock = getattr(raw, "_sock", None)
        while True:
            now = time.monotonic()
            if cancel_at is not None and now >= cancel_at:
                out["client_cancelled"] = True
                return out   # finally closes the socket — the client left
            if now >= deadline:
                return out
            if sock is not None:
                # readline must wake for the cancel instant, not sit out
                # the full timeout on a quiet stream
                wake = deadline
                if cancel_at is not None:
                    wake = min(wake, cancel_at)
                sock.settimeout(max(0.02, wake - now))
            try:
                line = resp.readline()
            except (socket.timeout, TimeoutError):
                continue
            if not line:
                return out   # server EOF
            if line.startswith(b":"):
                out["keepalives"] += 1
                continue
            if not line.startswith(b"data: "):
                continue
            data = line[len(b"data: "):].strip()
            if data == b"[DONE]":
                out["done_count"] += 1
                out["t_done_s"] = time.monotonic()
                continue   # keep reading: a duplicate [DONE] must COUNT
            try:
                chunk = json.loads(data)
            except ValueError:
                continue
            if "error" in chunk:
                out["errors"].append(chunk["error"])
                continue
            if chunk.get("usage") is not None:
                out["usage"] = chunk["usage"]
                out["usage_count"] += 1
            for ch in chunk.get("choices", ()):
                if ch.get("token_id") is not None:
                    if out["t_first_token_s"] is None:
                        out["t_first_token_s"] = time.monotonic()
                    out["token_ids"].append(int(ch["token_id"]))
                delta = (ch.get("text") if "text" in ch
                         else (ch.get("delta") or {}).get("content"))
                if delta:
                    out["text"] += delta
                if ch.get("finish_reason"):
                    out["finish_reason"] = ch["finish_reason"]
    except OSError as e:
        out["errors"].append({"type": "transport", "message": str(e)})
        return out
    finally:
        # with Connection: close responses, http.client detaches the
        # socket into the response object — closing the RESPONSE is what
        # actually sends FIN (a cancel must look like a vanished client)
        try:
            if resp is not None:
                resp.close()
        except OSError:
            pass
        try:
            conn.close()
        except OSError:
            pass


def run_trace_http(port: int, trace: Trace, *, model: str = "llm",
                   host: str = "127.0.0.1",
                   max_wall_s: float | None = None,
                   max_concurrency: int = 32,
                   timeout_s: float = 60.0) -> dict[str, Any]:
    """Replay a loadgen trace open-loop through a REAL socket: one SSE
    request per trace arrival (scheduled instants honored, like
    `run_trace`), tenants carried via the OpenAI `user` field (which is
    also the router's affinity key), client cancellations as actual
    socket closes. Reduces to the standard `loadgen.slo` summary so the
    HTTP-path record reads exactly like the engine-path one; the raw
    per-stream results ride along under "streams" for byte-parity and
    keepalive assertions."""
    cfg = trace.config
    if max_wall_s is None:
        max_wall_s = cfg.duration_s * 4.0 + 60.0
    gate = threading.Semaphore(max_concurrency)
    results: dict[int, dict[str, Any]] = {}
    lock = threading.Lock()
    t0 = time.monotonic()

    def worker(r) -> None:
        with gate:
            res = stream_completion(
                port, {
                    "model": model, "prompt": list(r.prompt),
                    "max_tokens": r.max_new_tokens, "temperature": 0.0,
                    **({"user": r.tenant} if r.tenant else {}),
                },
                host=host, timeout_s=timeout_s,
                cancel_after_s=r.cancel_after_s)
        with lock:
            results[r.index] = res

    threads: list[threading.Thread] = []
    unsubmitted: list[Any] = []
    for r in trace.requests:
        wait = r.arrival_s - (time.monotonic() - t0)
        if wait > 0:
            time.sleep(wait)
        if time.monotonic() - t0 > max_wall_s:
            unsubmitted.append(r)
            continue
        t = threading.Thread(target=worker, args=(r,), daemon=True,
                             name=f"http-load-{r.index}")
        t.start()
        threads.append(t)
    join_deadline = t0 + max_wall_s + timeout_s
    for t in threads:
        t.join(max(0.0, join_deadline - time.monotonic()))
    timed_out = bool(unsubmitted) or any(t.is_alive() for t in threads)

    records: list[RequestRecord] = []
    for r in trace.requests:
        res = results.get(r.index)
        if res is None:
            records.append(RequestRecord(
                index=r.index, tenant=r.tenant, arrival_s=r.arrival_s,
                max_new_tokens=r.max_new_tokens, adapter=r.adapter,
                finish_reason="unsubmitted"))
            continue
        if res["status"] != 200:
            records.append(RequestRecord(
                index=r.index, tenant=r.tenant, arrival_s=r.arrival_s,
                max_new_tokens=r.max_new_tokens, adapter=r.adapter,
                submit_s=res["t_request_s"] - t0,
                finish_reason="rejected"))
            continue
        if res["client_cancelled"]:
            reason = "cancelled"
        elif res["errors"] or not res["done_count"]:
            reason = "error"
        else:
            reason = res["finish_reason"] or "length"
        records.append(RequestRecord(
            index=r.index, tenant=r.tenant, arrival_s=r.arrival_s,
            max_new_tokens=r.max_new_tokens, adapter=r.adapter,
            submit_s=res["t_request_s"] - t0,
            first_token_s=(res["t_first_token_s"] - t0
                           if res["t_first_token_s"] is not None else None),
            finish_s=(res["t_done_s"] - t0
                      if res["t_done_s"] is not None else None),
            n_tokens=len(res["token_ids"]),
            finish_reason=reason,
            client_cancelled=res["client_cancelled"]))
    wall = time.monotonic() - t0
    return {
        "records": records,
        "streams": results,
        "summary": summarize(records, ttft_slo_ms=cfg.ttft_slo_ms,
                             tpot_slo_ms=cfg.tpot_slo_ms,
                             duration_s=max(wall, 1e-9)),
        "wall_s": round(wall, 3),
        "timed_out": timed_out,
    }
