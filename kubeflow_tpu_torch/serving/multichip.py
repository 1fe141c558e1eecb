"""Stage-sharded serving (counterpart of kubeflow_tpu/serving/multichip.py
`StageShardedEngine`).

The model is cut into `stage` contiguous layer slabs
(parallel/pipeline.py): stage s holds its slab of the weights (views on
the stacked [L, ...] tensors, no copy) and that slab's KV cache [L_s,
slots, max_len, kv, hd] (with the int8 scale planes), each on its
stage's device. The engine is an `LLMEngine` whose model calls run per
stage; its scheduler, sampler, penalties, stops, cancels and prefix-cache
logic are the base engine's, so greedy and seeded outputs equal the
single-program engine's token for token and logprob for logprob.

  - Prefill: a wave (and a prefix-hit continuation wave, and each link of
    a chunked chain) runs the stages one after the other over the same
    rows: stage 0 embeds, each stage runs `llama.prefill_inner` (or
    `prefill_continue_inner` against its slice of the prefix) on its slab
    and writes its KV rows into its cache, the last stage's lm_head gives
    the logits, and the base engine's sampler tail runs once.
  - Decode: each step splits the slots into microbatches
    (`microbatch_ranges`) and walks the GPipe wavefront: at tick t stage s
    decodes microbatch t - s through `llama.verify_inner(slot_start=...)`
    on its slab's window of slot rows (stage 0 embeds the microbatch's
    last tokens, stage s > 0 takes stage s - 1's activations). The last
    stage's logits are concatenated in slot order, then one `_choose`,
    one count update and one `_pack_out` a step over every slot: the
    single program's draw stream, so seeded sampling matches.
  - Graphs: with every stage on one device (virtual staging), one CUDA
    graph a (span, sample) holds one step's whole wavefront and its
    sampler, and a decode chunk (steps, span, sample) is `steps` replays
    of it: a step's wavefront launches a kernel per layer and microbatch,
    three times the single program's, so capturing each chunk length
    whole would triple the warmup. With `stage_schedule="overlapped"`
    each stage runs on a
    stream of its own inside the capture, joined by events on the edges
    (s - 1, m) -> (s, m) (and (s, m - 1) -> (s, m) by stream order), so
    stage programs of different microbatches are concurrent branches of
    the graph: the port's form of the JAX engine's asynchronous dispatch.
    "sync" keeps one stream. With stages on distinct devices a graph
    cannot span them: each (stage, microbatch, span) is a graph of its
    own, replayed from the host in wavefront order, the activations
    copied into the next stage's static input. On the CPU the same host
    loop runs the stage programs eagerly.
  - `stage_timing`: the sync schedule brackets each stage program, and
    the overlapped one each stage's stream with CUDA events, so the
    chunk runs outside a graph; `pipeline_perf()` then holds the measured
    bubble. For the profiler, never for live traffic.
  - The prefix cache: the store is a `StagePartitionedKVCache` of
    capacity x stages (the stage in the block's namespace), and a block's
    payload is the tuple of its per-stage payloads.

Refused as the JAX engine refuses them: speculative decoding, adapters,
`mesh=`, `kv_layout="paged"` and more stages than layers; `tensor > 1`
raises naming ROADMAP.md A6c-iii (the JAX engine serves it). Only a
supervisor's engine factory builds the engine on the serving path
(serving/llm_runtime.py, `config.parallel: {stage: P}`).
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Any

import torch

from kubeflow_tpu_torch._device import resolve_device
from kubeflow_tpu_torch.kvcache import RadixKVCache, StagePartitionedKVCache
from kubeflow_tpu_torch.models import llama
from kubeflow_tpu_torch.obs.trace import TRACER
from kubeflow_tpu_torch.ops import _build
from kubeflow_tpu_torch.parallel.pipeline import (InferenceStagePlan,
                                                  StageClock,
                                                  resolve_schedule,
                                                  split_stage_params,
                                                  synchronize, wavefront)
from kubeflow_tpu_torch.serving.llm import (LLMEngine, _leaves, _to_device,
                                            gc_paused)


class _StageGraph:
    """One stage program of a decode step captured on its own device
    (stages on distinct devices): the activations of the stage before it
    are copied into a static input, the graph replays, and its static
    output is returned."""

    def __init__(self, engine: "StageShardedEngine", s: int, m: int,
                 span: int):
        plan, cfg = engine._plan, engine.cfg
        dev = plan.devices[s]
        size = plan.mb_ranges[m][1]
        self.static_in = (None if s == 0 else torch.zeros(
            (size, 1, cfg.d_model), dtype=cfg.dtype, device=dev))
        body = functools.partial(engine._stage_decode, s, m, span,
                                 self.static_in)
        with torch.cuda.device(dev):
            # first-use work (handles, kernel loads) outside the capture
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side), _build.recording():
                body()
            torch.cuda.current_stream(dev).wait_stream(side)
            self.graph = torch.cuda.CUDAGraph()
            with _build.recording() as self.launches, gc_paused(), \
                    torch.cuda.graph(self.graph,
                                     capture_error_mode="thread_local"):
                self.out = body()
        engine._graph_captures += 1
        self.engine = engine

    def __call__(self, x: torch.Tensor | None) -> torch.Tensor:
        if self.static_in is not None:
            self.static_in.copy_(x, non_blocking=True)
        self.graph.replay()
        _build.add_counts(self.launches)
        self.engine._graph_replays += 1
        return self.out


class _Chunk:
    """A decode chunk of `steps` steps: `steps` replays of the one-step
    graph of its (span, sample), each step's packed rows copied into a
    static [steps, n_slots, cols] output."""

    def __init__(self, step, steps: int):
        self.step = step
        self.out = step.out.new_empty((steps,) + tuple(step.out.shape[1:]))

    def __call__(self) -> torch.Tensor:
        for row in self.out:
            row.copy_(self.step()[0])
        return self.out


class StageShardedEngine(LLMEngine):
    """A continuous-batching engine whose model runs as `stage` per-stage
    programs over per-stage weight and KV slabs (module docstring): the
    LLMEngine interface, with the single program's outputs."""

    role = "stage_sharded"

    def __init__(self, params, cfg: llama.LlamaConfig, *, stage: int = 2,
                 tensor: int = 1, devices=None, stage_timing: bool = False,
                 stage_schedule: str | None = None, **kw):
        if kw.get("speculative"):
            raise ValueError(
                "speculative decoding is not supported with stage "
                "parallelism (the history buffer threads the single "
                "program); serve spec traffic on the single-program "
                "engine")
        if kw.get("adapters"):
            raise ValueError(
                "multi-adapter serving is not supported with stage "
                "parallelism yet")
        if kw.pop("mesh", None) is not None:
            raise ValueError(
                "StageShardedEngine owns its mesh: pass stage=/tensor=, "
                "not mesh=")
        if kw.pop("kv_layout", "slab") != "slab":
            raise ValueError(
                "StageShardedEngine keeps per-stage KV SLABS: "
                "kv_layout=paged is not supported with stage "
                "parallelism (serving/paged.py is single-program)")
        self.stage_schedule = resolve_schedule(stage_schedule)
        # the plan first: the base __init__ places the params and
        # allocates the cache through it
        self._plan = InferenceStagePlan(
            cfg.n_layers, stage, int(kw.get("n_slots", 4)), tensor=tensor,
            devices=devices, device=resolve_device(kw.get("device", "cuda")))
        self._plan.perf.schedule = self.stage_schedule
        self.n_stages = self._plan.n_stages
        self.tensor = self._plan.tensor
        self.stage_timing = bool(stage_timing)
        self._stage_graphs: dict[tuple, _StageGraph] = {}
        self._step_graphs: dict[tuple, Any] = {}
        # the slot state sits with the sampler on the last stage's device
        kw["device"] = self._plan.devices[-1]
        super().__init__(params, cfg, **kw)
        # each stage's view of (lengths, last tokens): the engine's own
        # tensors on its device, else copies refreshed every step
        self._stage_state = [
            (self.lengths, self.last_tokens) if d == self.device else
            (torch.zeros_like(self.lengths, device=d),
             torch.zeros_like(self.last_tokens, device=d))
            for d in self._plan.devices]
        self._streams = None
        if (self.stage_schedule == "overlapped" and self._plan.virtual
                and self.device.type == "cuda"):
            self._streams = [torch.cuda.Stream(self.device)
                             for _ in range(self.n_stages)]
        if self.kvcache is not None:
            # one logical block costs a block per stage: the capacity the
            # operator configured stays the logical capacity
            self.kvcache = StagePartitionedKVCache(
                RadixKVCache(self.prefix_block_tokens,
                             self.kvcache.capacity_blocks * self.n_stages),
                self.n_stages)

    # -- placement -----------------------------------------------------------

    def _place_params(self, params, quantize: str | None) -> list[dict]:
        """Per-stage slabs, each on its stage's device (views when the
        params are there already), int8-quantized when asked."""
        slabs = []
        for s, slab in enumerate(split_stage_params(params,
                                                    self._plan.bounds)):
            slab = _to_device(slab, self._plan.devices[s])
            slabs.append(llama.quantize_params(slab) if quantize == "int8"
                         else slab)
        return slabs

    def _alloc_cache(self) -> dict:
        """Per-stage KV slabs [L_s, slots, max_len, kv, hd] (and the int8
        scale planes), each on its stage's device; the whole cache never
        exists on one device."""
        stages = []
        for (lo, hi), dev in zip(self._plan.bounds, self._plan.devices):
            scfg = dataclasses.replace(self.cfg, n_layers=hi - lo)
            stages.append(llama.init_cache(scfg, self.n_slots, self.max_len,
                                           self.kv_quantize, device=dev))
        return {"stages": stages}

    # -- prefill -------------------------------------------------------------

    def _prefill_rows(self, tokens, slots, start, prefix=None,
                      write_prefix=False, ids=None) -> torch.Tensor:
        """The stages over the same prompt rows, one after the other: each
        writes its KV rows into its own slab. `prefix` is ([k_s], [v_s]),
        one [L_s, B, start, kv, hd] pair a stage."""
        plan, cfg = self._plan, self.cfg
        x = llama._embed(self.params[0], plan.to_stage(tokens, 0), cfg)
        positions = start + torch.arange(tokens.shape[1], device=x.device)
        for s, slab in enumerate(self.params):
            x, pos = plan.to_stage(x, s), plan.to_stage(positions, s)
            if prefix is None:
                x, (ks, vs) = llama.prefill_inner(slab["layers"], x, pos,
                                                  cfg)
            else:
                x, ks, vs = llama.prefill_continue_inner(
                    slab["layers"], x, prefix[0][s], prefix[1][s], pos, cfg)
            cache = self.cache["stages"][s]
            for i, slot in enumerate(slots):
                if write_prefix:
                    self._cache_write(slot, 0, start, prefix[0][s][:, i],
                                      prefix[1][s][:, i], cache=cache)
                self._cache_write(slot, start, tokens.shape[1], ks[:, i],
                                  vs[:, i], cache=cache)
        return x

    def _lm_head(self, x: torch.Tensor) -> torch.Tensor:
        return llama.lm_head(self.params[-1], x, self.cfg)

    # -- the prefix cache: a block's payload is its per-stage tuple ----------

    def _extract_prefix(self, slot: int, p: int):
        pairs = [LLMEngine._extract_prefix(self, slot, p, cache=c)
                 for c in self.cache["stages"]]
        return [k for k, _ in pairs], [v for _, v in pairs]

    def _extract_prefix_raw(self, slot: int, p: int) -> tuple:
        return tuple(LLMEngine._extract_prefix_raw(self, slot, p, cache=c)
                     for c in self.cache["stages"])

    @staticmethod
    def _payload_slice(parts: tuple, s: int, e: int) -> tuple:
        return tuple(LLMEngine._payload_slice(sp, s, e) for sp in parts)

    def _materialize_prefix(self, payloads: list):
        """Blocks of per-stage payload tuples -> ([k_s], [v_s]), each
        stage's chain materialized on its device."""
        ks, vs = [], []
        for blocks in zip(*payloads):   # one stage's chain
            k, v = LLMEngine._materialize_prefix(self, list(blocks))
            ks.append(k)
            vs.append(v)
        return ks, vs

    @staticmethod
    def _stack_prefix(entries: list):
        n = len(entries[0][0])
        return ([torch.cat([e[0][s] for e in entries], dim=1)
                 for s in range(n)],
                [torch.cat([e[1][s] for e in entries], dim=1)
                 for s in range(n)])

    # -- decode --------------------------------------------------------------

    def _stage_decode(self, s: int, m: int, span: int,
                      x_in: torch.Tensor | None) -> torch.Tensor:
        """Stage s on microbatch m: the slot rows [start, start + size) of
        its slab. Stage 0 embeds the microbatch's last tokens; the last
        stage returns logits [size, vocab] f32, the others activations
        [size, 1, D]."""
        start, size = self._plan.mb_ranges[m]
        slab = self.params[s]
        lengths, last_tokens = self._stage_state[s]
        x = (llama._embed(slab, last_tokens[start:start + size, None],
                          self.cfg) if s == 0 else x_in)
        x = llama.verify_inner(slab["layers"], x, self.cache["stages"][s],
                               lengths[start:start + size], self.cfg,
                               span=span, slot_start=start)
        if s == self.n_stages - 1:
            return llama.lm_head(slab, x, self.cfg)[:, 0]
        return x

    def _stage_fn(self, s: int, m: int, span: int):
        """The program of stage s on microbatch m: a graph of its own with
        stages on distinct CUDA devices, else the eager body."""
        if self._plan.virtual or self.device.type != "cuda":
            return functools.partial(self._stage_decode, s, m, span)
        key = (s, m, span)
        if key not in self._stage_graphs:
            self._stage_graphs[key] = _StageGraph(self, s, m, span)
        return self._stage_graphs[key]

    def _decode_logits(self, span: int) -> torch.Tensor:
        """One step's wavefront over the stages -> logits [n_slots,
        vocab] in slot order (module docstring)."""
        plan = self._plan
        n_mb = plan.n_microbatches
        timing = self.stage_timing
        for (lengths, last_tokens), dev in zip(self._stage_state,
                                                plan.devices):
            if dev != self.device:
                lengths.copy_(self.lengths, non_blocking=True)
                last_tokens.copy_(self.last_tokens, non_blocking=True)
        if timing:
            synchronize(plan.devices)
        t_step = time.perf_counter()
        if self._streams is not None:
            acts = self._overlapped_wavefront(span, timing)
        else:
            clk = StageClock(plan.perf, timing, plan.devices)
            acts = [None] * n_mb
            for _t, s, m in wavefront(n_mb, self.n_stages):
                fn = self._stage_fn(s, m, span)
                x = plan.to_stage(acts[m], s)
                acts[m] = clk.run(s, lambda: fn(x))
        if timing:
            synchronize(plan.devices)
            plan.perf.record_step(n_mb, time.perf_counter() - t_step)
        return acts[0] if n_mb == 1 else torch.cat(acts)

    def _overlapped_wavefront(self, span: int, timing: bool) -> list:
        """The wavefront with each stage on its own stream, forked from
        and joined back to the current stream (inside a graph capture:
        concurrent branches of the graph). Every activation stays
        referenced until the join, so the allocator never hands its
        memory to another stream's program while a later stage may still
        read it. With `timing`, each stage's window from its first
        program to its last is timed with events."""
        n_mb = self._plan.n_microbatches
        cur = torch.cuda.current_stream(self.device)
        done: dict[tuple[int, int], torch.cuda.Event] = {}
        acts: list = [None] * n_mb
        held = []
        marks = []
        for st in self._streams:
            st.wait_stream(cur)
            if timing:
                ev = torch.cuda.Event(enable_timing=True)
                ev.record(st)
                marks.append([ev])
        for _t, s, m in wavefront(n_mb, self.n_stages):
            st = self._streams[s]
            with torch.cuda.stream(st):
                if s:
                    st.wait_event(done[s - 1, m])
                acts[m] = self._stage_decode(s, m, span, acts[m])
                ev = torch.cuda.Event()
                ev.record(st)
            done[s, m] = ev
            held.append(acts[m])
        for s, st in enumerate(self._streams):
            if timing:
                ev = torch.cuda.Event(enable_timing=True)
                ev.record(st)
                marks[s].append(ev)
            cur.wait_stream(st)
        if timing:
            torch.cuda.synchronize(self.device)
            for s, (a, b) in enumerate(marks):
                self._plan.perf.record_stage(s, a.elapsed_time(b) / 1e3)
        return acts

    def _capture(self, key: tuple):
        """The one-step graph of the key's (span, sample), captured on its
        first use; a chunk of more steps replays it (module docstring)."""
        steps, span, sample = key
        one = self._step_graphs.get((span, sample))
        if one is None:
            one = super()._capture((1, span, sample))
            self._step_graphs[span, sample] = one
        return one if steps == 1 else _Chunk(one, steps)

    def _program(self, key: tuple):
        """Virtual staging on the card: the base engine's graph of the
        whole chunk, unless `stage_timing` brackets the stages (the eager
        body, made for each call and kept by no menu). Distinct devices:
        the host-chained body, whose stage programs are graphs."""
        if self.device.type != "cuda" or (self._plan.virtual
                                          and not self.stage_timing):
            return super()._program(key)
        if self._plan.virtual:
            return self._body(key)
        return self._programs.setdefault(key, self._body(key))

    def _decode_chunk(self, steps: int, span: int, active: torch.Tensor,
                      sample: bool = True) -> torch.Tensor:
        out = super()._decode_chunk(steps, span, active, sample)
        if not self.stage_timing:
            # a graph replay runs no Python: the schedule ticks are
            # counted here (a timed body counts its own, with its wall)
            for _ in range(steps):
                self._plan.perf.record_step(self._plan.n_microbatches, 0.0)
        return out

    # -- observability -------------------------------------------------------

    def mesh_info(self) -> dict[str, Any]:
        d = self._plan.describe()
        slab_bytes = ([int(sum(t.nbytes for t in _leaves(slab)))
                       for slab in self.params]
                      if self.params is not None else [])
        return {
            "layout": f"tp{self.tensor}xpp{self.n_stages}",
            "axes": {"stage": self.n_stages, "tensor": self.tensor},
            "device_count": d["device_count"],
            "virtual_stages": d["virtual"],
            "stage_layers": d["stage_layers"],
            "microbatches": d["microbatches"],
            "params_bytes": int(sum(slab_bytes)),
            "per_stage_params_bytes": slab_bytes,
        }

    def warmup(self) -> None:
        """The base warmup through the stage programs, then a reset of the
        pipeline accounting: warmup's chunks are not traffic."""
        super().warmup()
        self._plan.perf.reset()

    def pipeline_perf(self, reset: bool = False) -> dict[str, Any]:
        """Per-stage busy and idle accounting: measured with
        `stage_timing`, from the schedule always."""
        snap = self._plan.perf.snapshot()
        snap["microbatches"] = self._plan.n_microbatches
        snap["stage_timing"] = self.stage_timing
        if reset:
            self._plan.perf.reset()
        return snap

    def metrics(self) -> dict[str, Any]:
        out = super().metrics()
        out["pipeline"] = self.pipeline_perf()
        return out

    def _obs_finish(self, req_id: int) -> None:
        """The base spans, plus one retrospective `stage` span a stage over
        the request's decode window, from the plan's geometry at finish
        (never from inside the wavefront)."""
        trace = self._req_trace.get(req_id)
        first = self._first_token_t.get(req_id)
        fin = self._finish_t.get(req_id)
        super()._obs_finish(req_id)
        if trace is None or first is None or fin is None \
                or not TRACER.sampled(trace):
            return
        perf = self._plan.perf
        for s, (lo, hi) in enumerate(self._plan.bounds):
            TRACER.record_span(
                f"{self.role}.stage{s}", "stage", trace, first, fin,
                stage=s, layers=[lo, hi],
                microbatches=self._plan.n_microbatches,
                tensor=self.tensor,
                schedule_bubble_frac=perf.schedule_bubble_frac())

    def close(self) -> None:
        synchronize(self._plan.devices)
        self._stage_graphs.clear()
        self._step_graphs.clear()
        self._stage_state = []
        self._streams = None
        super().close()
