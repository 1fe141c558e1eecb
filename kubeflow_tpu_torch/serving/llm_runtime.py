"""The LLM predictor (counterpart of kubeflow_tpu/serving/llm_runtime.py
`LLMModel`): what an InferenceService serves through the port.

The JAX package's `ModelServer` builds it through its `python` runtime,

    predictor:
      model:
        modelFormat: python
        storageUri: file:///models/llama-3-8b     # an HF safetensors dir
        config:
          className: kubeflow_tpu_torch.serving.llm_runtime:LLMModel
          quantize: int8
          ...                                     # the keys below

and the port's own repository through its `llama` runtime
(`serving/model.py` `load_model("llama", name, uri, **config)`), which
`serving/server.py` serves the same way. The class is not a subclass of
the JAX package's `Model` (the port imports nothing of it) but has its
methods: `load`, `unload`, `ready`, `load_time`, `preprocess`,
`predict`, `postprocess`, `explain`, `input_spec`, `output_spec`, and
`__init__(name, uri=None, **config)` as the runtime calls it.
`ModelError` is `serving/model.py`'s, re-exported here.

`load()` reads an HF directory (`uri` or `checkpoint`) through
`models/llama.py` `load_hf`, weights straight to the card and quantized
there as they arrive; or the params of the port's own trainer checkpoint
(a `checkpoint_dir` of `training/checkpoint.py`, its newest step), with
the architecture from `model` as the JAX runtime takes it and the
config's `quantize` applied as they load; or makes random weights from
`seed` without either. An empty checkpoint directory raises ModelError.
LoRA, as the JAX runtime serves it: `lora: {rank, alpha, targets?}`
reads a `llama_lora` trainer checkpoint's {base, lora} and serves
`models/lora.py` `merge(...)` (quantized after the merge); `adapters:
{name: {checkpoint, rank, alpha, targets?}}` reads only the adapter
shards of each named `llama_lora` checkpoint and serves them beside the
base on one engine, a request picking one by the payload's "adapter".
The engine sits behind a `serving/agent.py` `EngineSupervisor` (unless
`supervised: false`): every request is journaled, and a crash or stall
mid-stream restarts the engine through `engine_factory`, the one place
this module builds an engine, and replays the journal while the SSE
connection stays open (keepalive sentinels). A background thread steps
the supervisor; each request waits on it from its own thread, woken after
every step where the JAX runtime polls every millisecond, so that many
waiting streams do not compete with the engine thread's Python (graph
captures above all) for the GIL.

The config keys are the JAX runtime's, plus `device` ("cuda" by default;
without a GPU that raises unless "cpu" is given). `compile_cache` names a
directory where `ops/_build` keeps the nvcc-built kernel libraries,
under the same source-hash keys, so a restarted predictor skips nvcc; the
decode graphs are still captured by `warmup()` at every load (a CUDA
graph cannot be kept across processes). `mesh` and `parallel` are taken
when every axis is 1 (one card, as `mesh: {tensor: 1}` in
examples/hf-llama-inference-service.yaml); `parallel: {stage: P}` with P
above 1 serves through `serving/multichip.py` `StageShardedEngine` (its
`stage_schedule` key passed through), raising with `kv_layout: paged` or
`disaggregated` as the JAX runtime does; `tensor` or a mesh axis above 1
raises naming ROADMAP.md queue A6c-iii, and the JAX runtime's "pass
parallel OR mesh, not both" holds.

`disaggregated: true` serves through `serving/disagg.py`
`DisaggregatedEngine`: a prefill role (`PrefillEngine`) and a decode role
(`DecodeEngine`), each behind its own `EngineSupervisor` with its own
engine factory, over the one set of weights (quantized once, here, never
per role). `disagg: {handoff: zero_copy | serialized, prefill_slots,
max_inflight_prefills}` tunes it. It requires `supervised`, and raises
with `kv_layout: paged` or `parallel.stage > 1`, as in the JAX runtime.
`supervisor` is then the decode role's supervisor and
`prefill_supervisor` the prefill role's; `usage_timing` adds the
pipeline's `handoff_ms` to the phase split. The predictor-level `grpc`,
`logger` and `batching` keys are the server's (`serving/server.py`
`CompletionServer.from_config`), not this class's.
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time
from typing import Any

from kubeflow_tpu_torch._device import check_one_card_mesh, resolve_device
from kubeflow_tpu_torch.models import llama, lora as lora_lib
from kubeflow_tpu_torch.obs.metrics import add_scrape_hook
from kubeflow_tpu_torch.obs.slo import SloBurnTracker
from kubeflow_tpu_torch.obs.trace import TRACER, new_trace_id
from kubeflow_tpu_torch.ops import _build
from kubeflow_tpu_torch.serving.agent import EngineSupervisor
from kubeflow_tpu_torch.serving.disagg import DisaggregatedEngine
from kubeflow_tpu_torch.serving.model import ModelError, serving_runtime
from kubeflow_tpu_torch.serving.tokenizer import ByteTokenizer, load_tokenizer


class ProtocolError(ValueError):
    """A malformed request (HTTP 400)."""


class LLMModel:
    def __init__(self, name: str, uri: str | None = None, *,
                 model: dict[str, Any] | None = None, n_slots: int = 4,
                 max_len: int = 512, buckets=(64, 128, 256),
                 eos_id: int | None = None, checkpoint: str | None = None,
                 seed: int = 0, timeout_s: float = 300.0,
                 tokenizer: Any = None,
                 prefix_cache: bool = False, max_prefixes: int = 4,
                 prefix_cache_blocks: int | None = None,
                 decode_chunk: int = 8,
                 quantize: str | None = None,
                 kv_quantize: str | None = None,
                 decode_attention_impl: str | None = None,
                 prefill_attention_impl: str | None = None,
                 speculative: int | None = None,
                 spec_ngram: int = 3,
                 spec_adaptive: bool = True,
                 logprobs_topk: int = 0,
                 sample_k_max: int = 64,
                 pipeline_decode: bool = True,
                 compile_cache: str | None = None,
                 supervised: bool = True,
                 supervisor: dict[str, Any] | None = None,
                 sse_keepalive_s: float = 15.0,
                 usage_timing: bool = False,
                 kv_layout: str | None = None,
                 pool_blocks: int | None = None,
                 trace_sample_rate: float | None = None,
                 slo: dict[str, Any] | None = None,
                 mesh: dict[str, Any] | None = None,
                 parallel: dict[str, Any] | None = None,
                 lora: dict[str, Any] | None = None,
                 adapters: dict[str, Any] | None = None,
                 disaggregated: bool = False,
                 disagg: dict[str, Any] | None = None,
                 device: str = "cuda",
                 params: Any = None,
                 llama_config: llama.LlamaConfig | None = None,
                 **rest: Any):
        if rest:
            raise ValueError(f"unsupported config keys {sorted(rest)}")
        # config.disaggregated / config.disagg (module docstring)
        self._disaggregated = bool(disaggregated)
        self._disagg_cfg = dict(disagg or {})
        if self._disaggregated and not supervised:
            raise ValueError(
                "disaggregated serving requires supervised: true (each "
                "role's crash story is its supervisor)")
        # config.parallel {stage, tensor, stage_schedule} and config.mesh:
        # stage > 1 builds the stage-sharded engine (serving/multichip.py);
        # tensor past one card and a mesh past one card are not ported
        self._parallel = dict(parallel or {})
        pp = (1 if self._parallel.get("stage") is None
              else int(self._parallel["stage"]))
        tp = (1 if self._parallel.get("tensor") is None
              else int(self._parallel["tensor"]))
        if pp < 1 or tp < 1:
            raise ValueError("parallel.stage/parallel.tensor must be >= 1")
        if pp > 1 and self._disaggregated:
            raise ValueError(
                "parallel.stage > 1 does not compose with disaggregated "
                "serving yet (the stage pipeline is the prefill/decode "
                "overlap mechanism)")
        if (pp > 1 or tp > 1) and mesh:
            raise ValueError("pass parallel OR mesh, not both")
        if tp > 1:
            raise ValueError(
                f"parallel tensor={tp}: tensor-parallel serving is not "
                "ported yet (ROADMAP.md queue A6c-iii, tensor-parallel "
                "serving)")
        self._pp = pp
        check_one_card_mesh(dict(mesh or {}), "A6c-iii")
        if sample_k_max != 64:
            raise ValueError("sample_k_max: the port's sampler has a fixed "
                             "64-candidate window (LLMEngine.SAMPLE_K_MAX)")
        if (params is None) != (llama_config is None):
            raise ValueError("params and llama_config go together")
        self.name = name
        self.ready = False
        self.load_time: float | None = None
        self.device = resolve_device(device)
        self._cfg_overrides = dict(model or {})
        # config.decode_attention_impl / prefill_attention_impl: the
        # LlamaConfig fields, spelled at the top level (which wins)
        if decode_attention_impl is not None:
            self._cfg_overrides["decode_attention_impl"] = \
                decode_attention_impl
        if prefill_attention_impl is not None:
            self._cfg_overrides["prefill_attention_impl"] = \
                prefill_attention_impl
        # text endpoints: the byte-level tokenizer, a local HF tokenizer
        # directory, or (in-process callers) a tokenizer object
        self.tokenizer = (load_tokenizer(tokenizer)
                          if tokenizer is None or isinstance(tokenizer, str)
                          else tokenizer)
        self._params = params
        self._llama_config = llama_config
        # config.lora {rank, alpha, targets?}: the checkpoint is a
        # llama_lora fine-tune ({"base", "lora"}), served merged
        self._lora = dict(lora) if lora else None
        # config.adapters {name: {checkpoint, rank, alpha, targets?}}:
        # per-request adapters over the one base
        self._adapters_cfg = dict(adapters) if adapters else None
        self._n_slots = n_slots
        self._max_len = max_len
        self._buckets = tuple(buckets)
        self._eos_id = eos_id
        self._checkpoint = checkpoint or uri
        self._prefix_cache = prefix_cache
        self._max_prefixes = max_prefixes
        self._prefix_cache_blocks = prefix_cache_blocks
        self._decode_chunk = decode_chunk
        self._quantize = quantize
        self._kv_quantize = kv_quantize
        self._speculative = speculative
        self._spec_ngram = spec_ngram
        self._spec_adaptive = spec_adaptive
        self._logprobs_topk = logprobs_topk
        self._sample_k_max = sample_k_max
        self._pipeline_decode = pipeline_decode
        self._compile_cache = compile_cache
        # config.supervisor: {stall_timeout_s, stall_min_steps,
        # backoff_base_s, backoff_cap_s, max_restarts, stability_s,
        # rewarm}. rewarm (default True) runs warmup() again at every
        # restart: recovery is slower, and no live request waits on a
        # graph capture
        self._supervised = supervised
        self._sup_cfg = dict(supervisor or {})
        resolved = kv_layout or os.environ.get("KTPU_KV_LAYOUT") or "slab"
        if resolved not in ("slab", "paged"):
            raise ValueError(
                f"kv_layout must be 'slab' or 'paged', got {resolved!r}")
        if resolved == "paged" and pp > 1:
            raise ValueError(
                "kv_layout=paged does not compose with parallel.stage > 1 "
                "yet: the stage-sharded engine keeps per-stage KV slabs "
                "(serving/multichip.py)")
        if resolved == "paged" and self._disaggregated:
            raise ValueError(
                "kv_layout=paged does not compose with disaggregated "
                "serving yet: the prefill->decode handoff moves slab "
                "rows (serving/disagg.py)")
        self._kv_layout = resolved
        self._pool_blocks = pool_blocks
        # config.usage_timing: the request_timing() phase split in the
        # OpenAI usage object; off keeps the usage shape unchanged
        self._usage_timing = bool(usage_timing)
        # config.sse_keepalive_s: the longest silence on a token stream
        # before a keepalive sentinel (an SSE comment) goes out, e.g.
        # while the supervisor restarts the engine
        self._sse_keepalive_s = float(sse_keepalive_s)
        # config.trace_sample_rate: the share of trace ids whose spans the
        # process keeps; None leaves the process tracer's rate alone
        if trace_sample_rate is not None:
            TRACER.set_sample_rate(float(trace_sample_rate))
        # config.slo {ttft_ms, tpot_ms, window_s, budget}: the burn tracker
        # behind /healthz's "slo" section and the slo_* gauges
        slo_cfg = dict(slo or {})
        self.slo_tracker = SloBurnTracker(
            ttft_slo_ms=float(slo_cfg.get("ttft_ms", 2000.0)),
            tpot_slo_ms=float(slo_cfg.get("tpot_ms", 200.0)),
            window_s=float(slo_cfg.get("window_s", 300.0)),
            budget=float(slo_cfg.get("budget", 0.01)))
        add_scrape_hook(self.slo_tracker, SloBurnTracker.publish)
        self._seed = seed
        self._timeout_s = timeout_s
        self._engine = None
        #: load_hf's seconds and bytes, when load() read an HF directory
        self.load_stats: dict[str, Any] | None = None
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()
        self._wake = threading.Event()
        # notified after every engine step: what request threads wait on
        self._stepped = threading.Condition()
        self._loop_error: BaseException | None = None
        # rids whose waiter gave up while still in flight; the engine
        # thread releases them once they finish (a waiter never releases
        # an unfinished request out from under the loop)
        self._abandoned: set[int] = set()

    # -- the Model lifecycle -------------------------------------------------

    def _mark_ready(self) -> None:
        self.ready = True
        self.load_time = time.time()

    def preprocess(self, payload: Any) -> Any:
        return payload

    def postprocess(self, result: Any) -> Any:
        return result

    def explain(self, payload: Any) -> Any:
        raise ModelError(f"model {self.name!r} does not support explain")

    def input_spec(self) -> list[dict[str, Any]]:
        return []

    def output_spec(self) -> list[dict[str, Any]]:
        return []

    def _lora_config(self, spec: dict[str, Any],
                     cfg: llama.LlamaConfig) -> lora_lib.LoraLlamaConfig:
        """A LoraLlamaConfig over the served architecture from a config's
        {rank, alpha, targets?} (the checkpoint holds the base already:
        base_checkpoint is never read again)."""
        kw = {"rank": int(spec.get("rank", 8)),
              "alpha": float(spec.get("alpha", 16.0))}
        if "targets" in spec:
            kw["targets"] = tuple(spec["targets"])
        base = {f.name: getattr(cfg, f.name)
                for f in dataclasses.fields(cfg)}
        return lora_lib.LoraLlamaConfig(llama=base, **kw)

    def _load_adapters(self, cfg: llama.LlamaConfig):
        """config.adapters -> the engine's `adapters=`: each named
        llama_lora checkpoint's adapter shards alone (params/lora); the
        base stays the engine's own params."""
        if not self._adapters_cfg:
            return None
        from kubeflow_tpu_torch.training.checkpoint import restore_params

        out = {}
        for name, spec in self._adapters_cfg.items():
            lcfg = self._lora_config(spec, cfg)
            try:
                restored = restore_params(
                    spec["checkpoint"],
                    lora_lib.abstract_params(lcfg)["lora"],
                    device=self.device, subtree="params/lora")
            except FileNotFoundError as e:
                raise ModelError(f"adapter {name!r}: {e}") from e
            out[name] = {"lora": restored, "alpha": lcfg.alpha}
        return out

    def _load_params(self):
        """(params, cfg): given in-process, a llama_lora checkpoint merged
        (config.lora), from an HF directory, or random from `seed`."""
        if self._lora is not None:
            if not self._checkpoint:
                raise ModelError("config.lora requires a checkpoint")
            from kubeflow_tpu_torch.training.checkpoint import restore_params

            cfg = llama.LlamaConfig(**self._cfg_overrides)
            lcfg = self._lora_config(self._lora, cfg)
            try:
                restored = restore_params(self._checkpoint,
                                          lora_lib.abstract_params(lcfg),
                                          device=self.device)
            except FileNotFoundError as e:
                raise ModelError(str(e)) from e
            params = lora_lib.merge(restored, lcfg, stop_base_gradient=False)
            del restored
            if self._quantize == "int8":
                params = llama.quantize_params(params)
            return params, cfg
        if self._params is not None:
            if self._cfg_overrides:
                raise ValueError("model overrides need no in-process "
                                 "params: pass the config they describe")
            return self._params, self._llama_config
        ckpt = self._checkpoint
        if ckpt and llama.is_hf_checkpoint(ckpt):
            cfg = llama.config_from_hf(ckpt, **self._cfg_overrides)
            t0 = time.monotonic()
            params, cfg = llama.load_hf(ckpt, cfg, device=self.device,
                                        quantize=self._quantize)
            if self.device.type == "cuda":
                import torch

                torch.cuda.synchronize(self.device)
            nbytes = sum(os.path.getsize(os.path.join(ckpt, f))
                         for f in os.listdir(ckpt)
                         if f.endswith(".safetensors"))
            self.load_stats = {"seconds": time.monotonic() - t0,
                               "bytes": nbytes}
            # weights, architecture and tokenizer from one storageUri
            if isinstance(self.tokenizer, ByteTokenizer) and os.path.exists(
                    os.path.join(ckpt, "tokenizer.json")):
                self.tokenizer = load_tokenizer(ckpt)
            if self._eos_id is None:
                self._eos_id = getattr(self.tokenizer, "eos_id", None)
            return params, cfg
        cfg = llama.LlamaConfig(**self._cfg_overrides)
        if ckpt:
            # the port's trainer checkpoint: its params subtree against
            # the model's shapes (no optimizer state), never random
            # weights in place of a configured but empty directory
            from kubeflow_tpu_torch.training.checkpoint import restore_params

            try:
                params = restore_params(ckpt, llama.abstract_params(cfg),
                                        device=self.device)
            except FileNotFoundError as e:
                raise ModelError(str(e)) from e
            if self._quantize == "int8":
                params = llama.quantize_params(params)
            return params, cfg
        return llama.init(cfg, seed=self._seed, device=self.device,
                          quantize=self._quantize), cfg

    def load(self) -> None:
        from kubeflow_tpu_torch.serving.llm import LLMEngine
        from kubeflow_tpu_torch.serving.multichip import StageShardedEngine
        from kubeflow_tpu_torch.serving.paged import PagedLLMEngine

        if self._compile_cache:
            _build.set_build_root(self._compile_cache)
        params, cfg = self._load_params()
        if self._quantize == "int8":
            # once, here: every engine the factories build (both roles,
            # every restart) shares these weights
            params = llama.quantize_params(params)
        engine_kw = dict(n_slots=self._n_slots, max_len=self._max_len,
                         buckets=self._buckets, eos_id=self._eos_id,
                         decode_chunk=self._decode_chunk,
                         prefix_cache=self._prefix_cache,
                         max_prefixes=self._max_prefixes,
                         prefix_cache_blocks=self._prefix_cache_blocks,
                         quantize=self._quantize,
                         kv_quantize=self._kv_quantize,
                         speculative=self._speculative,
                         spec_ngram=self._spec_ngram,
                         spec_adaptive=self._spec_adaptive,
                         logprobs_topk=self._logprobs_topk,
                         pipeline_decode=self._pipeline_decode,
                         adapters=self._load_adapters(cfg),
                         device=self.device)
        # read, never pop: unload and load again must see the same config
        rewarm = bool(self._sup_cfg.get("rewarm", True))
        warmed: list[bool] = []

        def engine_factory():
            # the only place this module builds an engine: the closure
            # the supervisor restarts through. The first build always
            # warms up (no live request waits on a capture); restarts
            # warm up again unless supervisor.rewarm is false
            if self._pp > 1:
                # config.parallel.stage_schedule: "sync" or "overlapped";
                # None defers to KTPU_STAGE_OVERLAP, then "sync"
                eng = StageShardedEngine(
                    params, cfg, stage=self._pp,
                    stage_schedule=self._parallel.get("stage_schedule"),
                    **engine_kw)
            elif self._kv_layout == "paged":
                eng = PagedLLMEngine(params, cfg,
                                     pool_blocks=self._pool_blocks,
                                     **engine_kw)
            else:
                eng = LLMEngine(params, cfg, **engine_kw)
            if rewarm or not warmed:
                eng.warmup()
                warmed.append(True)
            return eng

        # the HTTP path's stall watchdog: conservative next to the
        # supervisor's own 2 s default
        sup_kw = {k: v for k, v in self._sup_cfg.items() if k != "rewarm"}
        sup_kw.setdefault("stall_timeout_s", 10.0)
        if self._disaggregated:
            from kubeflow_tpu_torch.serving.llm import (DecodeEngine,
                                                        PrefillEngine)

            dg = self._disagg_cfg
            pre_kw = dict(engine_kw)
            if dg.get("prefill_slots"):
                pre_kw["n_slots"] = int(dg["prefill_slots"])
            warmed_roles: set[str] = set()

            def warm(eng):
                if rewarm or eng.role not in warmed_roles:
                    eng.warmup()
                    warmed_roles.add(eng.role)
                return eng

            # the roles' engines, like the colocated one, are built only
            # in a supervisor's factory
            def prefill_engine_factory():
                return warm(PrefillEngine(params, cfg, **pre_kw))

            def decode_engine_factory():
                return warm(DecodeEngine(params, cfg, **engine_kw))

            self._engine = DisaggregatedEngine(
                EngineSupervisor(prefill_engine_factory, **sup_kw),
                EngineSupervisor(decode_engine_factory, **sup_kw),
                handoff=dg.get("handoff", "zero_copy"),
                max_inflight_prefills=dg.get("max_inflight_prefills"))
        elif self._supervised:
            self._engine = EngineSupervisor(engine_factory, **sup_kw)
        else:
            # the bare engine, for benches that measure it
            self._engine = engine_factory()
        self._stop.clear()
        self._loop_error = None
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name=f"llm-engine-{self.name}")
        self._thread.start()
        self._mark_ready()

    def _loop(self) -> None:
        try:
            while not self._stop.is_set():
                progressed = self._engine.step()
                self._sweep_abandoned()
                with self._stepped:
                    self._stepped.notify_all()
                if not progressed:
                    # idle: sleep until a submit wakes us
                    self._wake.wait(timeout=0.02)
                    self._wake.clear()
        except BaseException as e:   # surfaced to every waiter
            self._loop_error = e
            raise

    def _sweep_abandoned(self) -> None:
        for rid in list(self._abandoned):
            if self._engine.is_done(rid):
                self._engine.release(rid)
                self._abandoned.discard(rid)

    def unload(self) -> None:
        """Stop the engine thread and free the engine (its KV cache,
        graphs and pool) and the params, so the card's memory is back to
        what it was before load()."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=30)
        if self._engine is not None:
            try:
                self._engine.close()
            except Exception:
                pass   # a dead engine has little left to free
        self._engine = None
        self._abandoned.clear()
        self.ready = False

    @property
    def supervisor(self) -> EngineSupervisor | None:
        """The EngineSupervisor under this model (None with supervised:
        false): chaos drills arm faults here, and /healthz reads its
        accounting. Disaggregated, the decode role's (the replica's
        identity); the prefill role's is `prefill_supervisor`."""
        eng = self._engine
        if isinstance(eng, DisaggregatedEngine):
            return eng.decode
        return eng if isinstance(eng, EngineSupervisor) else None

    @property
    def prefill_supervisor(self) -> EngineSupervisor | None:
        """The prefill role's EngineSupervisor (disaggregated serving
        only, else None): the prefill-crash drill arms faults here."""
        eng = self._engine
        return eng.prefill if isinstance(eng, DisaggregatedEngine) else None

    @property
    def engine(self):
        """The live engine (inside the supervisor, if any; disaggregated,
        the decode role's); None while a supervised engine restarts or
        after unload()."""
        sup = self.supervisor
        return sup.engine if sup is not None else self._engine

    # -- inference -----------------------------------------------------------

    def predict(self, payload: Any) -> Any:
        if isinstance(payload, list):
            return [{"output_tokens": r["token_ids"]}
                    for r in self._submit_wait_all(payload)]
        return {"output_tokens": self._wait(self._submit(payload))}

    def _submit_wait_all(self, payloads: list) -> list[dict[str, Any]]:
        """Every request submitted before any wait, so a burst shares
        prefill waves and decode chunks; on a failure, what is not
        drained yet is cancelled and left to the engine thread."""
        rids: list[int] = []
        out: list[dict[str, Any]] = []
        try:
            for p in payloads:
                rids.append(self._submit(p))
            for rid in rids:
                out.append(self._wait(rid, full=True))
        except BaseException:
            for rid in rids[len(out):]:
                self._engine.cancel(rid)
                self._abandoned.add(rid)
            raise
        return out

    def _encode_stops(self, stop: Any) -> list[list[int]]:
        """OpenAI `stop` (a string, a list of strings, or token-id lists)
        as engine stop sequences, strings encoded by the tokenizer."""
        if stop is None:
            return []
        if isinstance(stop, str):
            stop = [stop]
        if not isinstance(stop, list):
            raise ProtocolError("stop must be a string or a list")
        out: list[list[int]] = []
        for s in stop:
            if isinstance(s, str):
                ids = self.tokenizer.encode(s)
                if ids:
                    out.append(list(ids))
            elif isinstance(s, list):
                out.append([int(t) for t in s])
            else:
                raise ProtocolError(
                    "stop entries must be strings or id lists")
        if len(out) > 8:
            raise ProtocolError("at most 8 stop sequences per request")
        for seq in out:
            if not 1 <= len(seq) <= 64:
                raise ProtocolError(
                    "each stop sequence must encode to 1..64 tokens")
        return out

    def _submit(self, payload: Any) -> int:
        if not isinstance(payload, dict) or "prompt_tokens" not in payload:
            raise ValueError(
                "llama runtime expects {'prompt_tokens': [...], "
                "'max_new_tokens': N}")
        adapter = payload.get("adapter")
        if adapter is not None and adapter not in self._engine._adapter_idx:
            raise ProtocolError(
                f"unknown adapter {adapter!r}; loaded: "
                f"{sorted(self._engine._adapter_idx)}")
        prompt = [int(t) for t in payload["prompt_tokens"]]
        max_new = int(payload.get("max_new_tokens", 32))
        temperature = float(payload.get("temperature", 0.0))
        # the engine's deadline: an abandoned request frees its slot once
        # its budget passes; the implicit one sits past timeout_s, so the
        # waiter's TimeoutError always comes first
        deadline = float(payload.get("deadline_s")
                         or (self._timeout_s + 10.0))
        seed = payload.get("seed")
        # the trace id: the payload's (the HTTP layer maps X-Trace-Id
        # there) or minted here, the edge for direct callers
        trace = str(payload.get("trace") or new_trace_id())
        rid = self._engine.submit(
            prompt, max_new, temperature, adapter=adapter,
            top_k=int(payload.get("top_k", 0)),
            top_p=float(payload.get("top_p", 1.0)),
            presence_penalty=float(payload.get("presence_penalty", 0.0)),
            frequency_penalty=float(payload.get("frequency_penalty", 0.0)),
            seed=None if seed is None else int(seed),
            stop=self._encode_stops(payload.get("stop")),
            deadline_s=deadline,
            tenant=payload.get("tenant"),
            trace=trace)
        self._wake.set()
        return rid

    def _await_step(self, timeout: float) -> None:
        """Sleep until the engine thread finishes a step, or `timeout`."""
        with self._stepped:
            self._stepped.wait(timeout)

    def _check_alive(self, deadline: float) -> None:
        """The liveness and deadline gate of every waiter."""
        if (self._stop.is_set() or self._thread is None
                or not self._thread.is_alive()):
            raise RuntimeError(
                f"llm engine loop is not running ({self._loop_error!r})")
        if time.monotonic() >= deadline:
            raise TimeoutError(
                f"generation timed out after {self._timeout_s}s")

    def stream(self, payload: Any, on_finish=None, info: dict | None = None):
        """A (token_id, logprob) stream for the SSE backend. Submits now
        (PromptTooLong, QueueFull raise before the caller commits an HTTP
        status) and returns the generator that drains the engine, which
        yields (None, None) as a keepalive sentinel after
        sse_keepalive_s of silence. `on_finish(reason)` fires before
        release with the OpenAI finish_reason; `info` is filled at the
        finish with what the final usage chunk carries (cached_tokens,
        and the phase split under usage_timing). With stop sequences the
        last max(len(stop)) tokens are held back until the finish, since
        a stop match removes them."""
        stops = self._encode_stops(payload.get("stop"))
        if stops:   # encoded once; id lists pass _submit's encoding as is
            payload = dict(payload, stop=stops)
        rid = self._submit(payload)
        hold = max((len(s) for s in stops), default=0)
        return self._stream_from(rid, on_finish, hold, info)

    def _timing_fields(self, rid: int) -> dict[str, Any]:
        """The request's phase split for the usage object (read before
        release); a phase not reached yet reads None."""
        try:
            tm = self._engine.request_timing(rid)
        except Exception:
            return {}
        return {k: tm.get(k) for k in
                ("queue_wait_ms", "prefill_ms", "handoff_ms", "decode_ms")
                if k != "handoff_ms" or "handoff_ms" in tm}

    def _slo_record(self, rid: int, reason: str) -> None:
        """One finished request into the burn tracker (read before
        release). Never raises: SLO accounting must not take down the
        serving path."""
        try:
            tm = self._engine.request_timing(rid)
        except Exception:
            return
        sub = tm.get("submit_s")
        first = tm.get("first_token_s")
        fin = tm.get("finish_s")
        n = tm.get("n_tokens") or 0
        ttft = ((first - sub) * 1e3
                if sub is not None and first is not None else None)
        tpot = ((fin - first) / (n - 1) * 1e3
                if first is not None and fin is not None and n >= 2
                else None)
        self.slo_tracker.record(tm.get("tenant"), ttft, tpot,
                                completed=reason in ("stop", "length"))

    def _cached_tokens(self, rid: int) -> int | None:
        """None when the engine runs no prefix cache (the usage object
        then has no cached_tokens); 0 on a miss."""
        eng = self._engine
        if getattr(eng, "kvcache", None) is None \
                and not getattr(eng, "prefix_cache_enabled", False):
            return None
        fn = getattr(eng, "cached_tokens", None)
        return int(fn(rid)) if fn is not None else None

    def _stream_from(self, rid: int, on_finish=None, hold: int = 0,
                     info: dict | None = None):
        deadline = time.monotonic() + self._timeout_s
        sent = 0
        last_emit = time.monotonic()
        try:
            while True:
                done = self._engine.is_done(rid)   # before the drain: a
                # token landing between the two is caught next round
                toks = self._engine.partial_result(rid)
                lps = self._engine.partial_logprobs(rid)
                limit = len(toks) if done else max(0, len(toks) - hold)
                if not done:
                    # the engine thread appends the token, then its
                    # logprob: a token without one waits a round
                    limit = min(limit, len(lps))
                while sent < limit:
                    yield toks[sent], (lps[sent] if sent < len(lps)
                                       else 0.0)
                    sent += 1
                    last_emit = time.monotonic()
                if done:
                    break
                silent = time.monotonic() - last_emit
                if silent >= self._sse_keepalive_s:
                    # silence, typically a restart with the journal
                    # holding this stream: the HTTP layer writes an SSE
                    # comment, which keeps the connection and probes it
                    yield None, None
                    last_emit, silent = time.monotonic(), 0.0
                self._check_alive(deadline)
                self._await_step(min(0.05, self._sse_keepalive_s - silent))
        except BaseException:
            # a dropped client (GeneratorExit from close()), a timeout or
            # a dead loop: cancel, so the slot frees at the next chunk
            self._engine.cancel(rid)
            self._abandoned.add(rid)
            raise
        reason = self._engine.finish_reason(rid)
        if reason == "cancelled" and getattr(self._engine, "failed", False):
            # the supervisor ran out of restarts mid-stream: the client
            # sees a terminal error event, not a silent "cancelled"
            self._abandoned.add(rid)
            raise RuntimeError(
                "backend permanently failed (supervisor restart budget "
                "exhausted) after "
                f"{len(self._engine.partial_result(rid))} tokens")
        if info is not None:
            cached = self._cached_tokens(rid)
            if cached is not None:
                info["cached_tokens"] = cached
            if self._usage_timing:
                info["timing"] = self._timing_fields(rid)
        if on_finish is not None:
            on_finish(reason)
        self._slo_record(rid, reason)
        self._engine.release(rid)

    def complete(self, payload: Any) -> dict[str, Any]:
        """Buffered generation: {"token_ids", "finish_reason", "logprobs"}
        and, on an engine with logprobs_topk > 0, "top_logprobs"."""
        return self._wait(self._submit(payload), full=True)

    def complete_many(self, payloads: list) -> list[dict[str, Any]]:
        """Buffered generation of a burst (OpenAI n/best_of)."""
        return self._submit_wait_all(payloads)

    def _wait(self, rid: int, full: bool = False):
        deadline = time.monotonic() + self._timeout_s
        try:
            while not self._engine.is_done(rid):
                self._check_alive(deadline)
                self._await_step(0.05)
        except BaseException:
            self._engine.cancel(rid)
            self._abandoned.add(rid)   # the engine thread releases it
            raise
        out = self._engine.result(rid)
        reason = self._engine.finish_reason(rid)
        result = {"token_ids": out, "finish_reason": reason,
                  "logprobs": self._engine.result_logprobs(rid)}
        cached = self._cached_tokens(rid)
        if cached is not None:
            result["cached_tokens"] = cached
        if self._usage_timing:
            result["timing"] = self._timing_fields(rid)
        if self._logprobs_topk:
            result["top_logprobs"] = self._engine.result_top_logprobs(rid)
        self._slo_record(rid, reason)
        self._engine.release(rid)
        return result if full else out

    def metrics(self) -> dict[str, Any]:
        """The engine's metrics (with the supervisor's accounting under
        "supervisor"), the KV layout and the device layout."""
        if self._engine is None:
            return {}
        out = dict(self._engine.metrics())
        out["kv_layout"] = self._kv_layout
        eng = self.engine
        if eng is not None:
            out["mesh"] = eng.mesh_info()
        return out


@serving_runtime("llama")
def _llama_runtime(name: str, uri: str | None = None, **config: Any):
    return LLMModel(name, uri, **config)
