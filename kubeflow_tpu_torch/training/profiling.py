"""Profiling and tracing hooks (counterpart of
kubeflow_tpu/training/profiling.py), on `torch.profiler`.

Two capture surfaces:

- `trace(logdir)`: a context manager around arbitrary work; the trace
  (CPU activity, and CUDA kernels when a card is present) is written to
  `logdir` by `tensorboard_trace_handler`.
- `StepProfiler`: the training loop's window — starts at `start_step`,
  captures `num_steps` steps, then stops and writes a `PROFILE_DONE`
  marker into the same dir.

And the serving decode breakdown, `serving_decode_breakdown`: one batched
decode step of an idle engine split into buckets by timing the engine's
own decode chunk against variants that differ by one stage, plus probes
for attention (`attn_kernel`, K2), int8 dequantization, a prefill chunk
(`prefill_attn`, K3 — K3's paged mode on a paged engine) and the paged
gather.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Callable

import numpy as np
import torch


def _activities() -> list:
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return acts


def _profiler(logdir: str):
    from torch.profiler import profile, tensorboard_trace_handler

    os.makedirs(logdir, exist_ok=True)
    return profile(activities=_activities(),
                   on_trace_ready=tensorboard_trace_handler(logdir))


@contextlib.contextmanager
def trace(logdir: str):
    """torch.profiler around the block, the dir created up front and the
    trace written into it when the block ends; yields the dir."""
    with _profiler(logdir):
        yield logdir


class StepProfiler:
    """Capture a [start_step, start_step + num_steps) window of the train
    loop. `maybe_stop` takes a sync thunk: launches return before the card
    finishes, so the caller fences the window (torch.cuda.synchronize on
    the card) before the trace stops."""

    def __init__(self, logdir: str, start_step: int = 2, num_steps: int = 3):
        if num_steps < 1:
            raise ValueError("profile_num_steps must be >= 1")
        self.logdir = logdir
        self.start_step = start_step
        self.end_step = start_step + num_steps
        self.active = False
        self.done = False
        self._prof = None

    def maybe_start(self, step: int) -> None:
        if self.done or self.active or step < self.start_step:
            return
        self._prof = _profiler(self.logdir)
        self._prof.start()
        self.active = True

    def maybe_stop(self, step: int,
                   sync: Callable[[], Any] | None = None) -> None:
        if not self.active or step + 1 < self.end_step:
            return
        if sync is not None:
            sync()   # fence: the window's work on the card has retired
        self._prof.stop()
        self._prof = None
        self.active = False
        self.done = True
        with open(os.path.join(self.logdir, "PROFILE_DONE"), "w") as f:
            f.write(f"steps {self.start_step}..{self.end_step - 1}\n")

    def close(self) -> None:
        """Stop a still-open window (loop ended early)."""
        if self.active:
            self._prof.stop()
            self._prof = None
            self.active = False


# -- serving-side decode-step attribution ------------------------------------
#
# Differential timing, not trace parsing: the buckets come from running
# variants of the engine's own decode chunk (`LLMEngine._decode_chunk`)
# that differ by exactly one stage, and probes that run one part of the
# step alone. Every timed run ends in a value fetch (`.item()`), which
# waits for the card, and the dispatch round trip of a one-element add is
# subtracted where the JAX breakdown subtracts it.


def _median_time(run, iters: int):
    return _median_times([run], iters)[0]


def _median_times(runs, iters: int) -> list[float]:
    """The median wall time of each run, the runs taken in turns `iters`
    times: variants that are compared are timed under the same drift of
    the host's speed."""
    ts = [[] for _ in runs]
    for _ in range(iters):
        for run, t in zip(runs, ts):
            t0 = time.perf_counter()
            run()
            t.append(time.perf_counter() - t0)
    return [float(np.median(t)) for t in ts]


def _leaves(tree) -> list[torch.Tensor]:
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _leaves(v)]
    return [tree]


def _words(t: torch.Tensor) -> torch.Tensor:
    """A contiguous tensor's bytes as f32 words (the tensor itself when
    they do not divide into words)."""
    flat = t.reshape(-1)
    if (not t.is_contiguous() or flat.numel() * t.element_size() % 4
            or t.data_ptr() % 4):
        return t
    return flat.view(torch.float32)


def serving_decode_breakdown(engine, *, steps: int | None = None,
                             fill_len: int | None = None, iters: int = 5,
                             trace_dir: str | None = None,
                             hbm_gbps: float | None = None) -> dict:
    """Attribute one batched decode step of an idle LLMEngine (or
    PagedLLMEngine). Returns the JAX breakdown's dict; `buckets_ms` splits
    a decode step into:

      weight_read          — one f32 sum over every non-embed param leaf
                             (int8 weights and their scales on int8
                             params): each byte read once;
      attention_kv_update  — the sampling-stripped chunk less the weight
                             read: attention over the span, the cache
                             write, norms and activations; probed by
                             `attn_kernel` (decode attention per layer
                             over the live span: K2, or K2-paged through
                             the slot tables) and `attn_dequant` (reading
                             and dequantizing the same int8 span; 0.0 on
                             a bf16 cache). Probes, not a partition;
      prefill_attn         — one 32-row continuation chunk of prefill
                             attention per layer at the end of the live
                             span (K3, or K3-paged through the slot
                             tables), per chunk, not per step;
      sampling_penalties   — the full chunk less the sampling-stripped
                             one (`_decode_chunk(sample=False)`; on the
                             card both are replays of the engine's
                             decode graphs);
      dispatch_rtt_per_step, host_fetch_replay_per_step — the one-add
                             round trip per step, and the engine's live
                             perf counters (None before it has decoded);
      kv_gather            — paged engines: the span read through the
                             tables less a contiguous read of the same
                             volume (None on the slab engine);
      kv_handoff           — on a slab engine with the prefix cache:
                             moving one prefix-cache block between
                             engines, a slot's block extracted and
                             sliced into a payload of its own
                             (`_payload_slice`, the banker's copy) and
                             inserted through serving/disagg.py's
                             zero-copy KVHandoff into a scratch
                             RadixKVCache; None without the cache, and
                             on a paged engine by design (banking is
                             refcounts on pool blocks, nothing moves);
      pipeline_bubble      — a stage-sharded engine with `stage_timing`
                             on: the per-stage idle wall a decode step,
                             (stages x window - sum of stage busy) /
                             (stages x steps), from its `pipeline_perf`
                             over the timed chunks (also returned under
                             "pipeline"); None on a single-program engine
                             and with `stage_timing` off.

    weight_read + attention_kv_update + sampling_penalties is the
    measured device step (device_step_ms): the stripped chunk's time is
    taken at most the full one's. The engine's slot state is junk
    during the run and reset after — call only while idle. `fill_len`
    positions the slots mid-generation so the attention span is
    realistic; `hbm_gbps` adds the analytic weight-read floor beside the
    measured one; `trace_dir` captures one full chunk under
    torch.profiler."""
    from kubeflow_tpu_torch.models import llama
    from kubeflow_tpu_torch.ops.flash_decode import gather_pages

    dev = engine.device
    n_slots = engine.n_slots
    if steps is None:
        steps = 1
        while steps * 2 <= engine.decode_chunk:
            steps *= 2

    # every (untimed + timed) run's KV writes must fit max_len so no state
    # reset lands inside a timed window; small caches clamp steps, then
    # iters
    def rows_needed(s, it):
        return (2 * it + 4) * s + 2
    while steps > 1 and rows_needed(steps, iters) > engine.max_len:
        steps //= 2
    while iters > 1 and rows_needed(steps, iters) > engine.max_len:
        iters -= 1
    if rows_needed(steps, iters) > engine.max_len:
        raise ValueError(
            f"max_len {engine.max_len} cannot hold one profiled chunk "
            f"(steps={steps}, iters={iters})")
    if fill_len is None:
        fill_len = max(1, min(engine.max_len // 2,
                              engine.max_len - rows_needed(steps, iters)))
    span = engine._pick_span(min(fill_len + steps, engine.max_len))

    # the slot state is reset in place: the engine's decode graphs read
    # these very tensors
    def reset_samp():
        engine._samp_host[:] = engine._samp_reset()
        engine.samp.copy_(torch.from_numpy(engine._samp_host))

    def reset_state():
        engine.lengths.fill_(fill_len)
        engine.last_tokens.fill_(1)
        reset_samp()

    active = torch.ones(n_slots, dtype=torch.bool, device=dev)

    def run_decode(sample):
        def go():
            out = engine._decode_chunk(steps, span, active, sample=sample)
            out[0, 0, 0].item()   # value fetch: waits for the card
        return go

    # pure weight read: every non-embed leaf reduced once (decode gathers
    # a handful of embed rows, never the table), its bytes summed as f32
    # words where they divide into them: each byte is read once and the
    # reduction runs at the memory's rate (an int8 -> f32 converting sum
    # does not); the value is only a fence. A stage-sharded engine holds
    # a list of per-stage slabs
    slabs = (engine.params if isinstance(engine.params, list)
             else [engine.params])
    read_leaves = [_words(t) for slab in slabs for t in _leaves(
        {k: v for k, v in slab.items() if k != "embed"})]
    read_bytes = int(sum(t.numel() * t.element_size() for t in read_leaves))

    def run_read():
        tot = torch.zeros((), dtype=torch.float32, device=dev)
        for leaf in read_leaves:
            tot = tot + leaf.sum(dtype=torch.float32)
        tot.item()

    # trivial round trip: a one-add launch and a scalar fetch, the
    # per-launch host<->device overhead every chunk pays once
    tiny = torch.zeros((), dtype=torch.float32, device=dev)

    def run_rtt():
        (tiny + 1.0).item()

    # one untimed call each (first-use costs, cold pages); state is reset
    # once up front and fill_len left room for every run's writes
    reset_state()
    for warm in (run_decode(True), run_decode(False), run_read, run_rtt):
        warm()

    t_rtt = _median_time(run_rtt, iters)
    staged = hasattr(engine, "pipeline_perf")
    if staged:
        engine.pipeline_perf(reset=True)   # bracket the timed chunks
    # the full chunk and its sampling-stripped variant in turns: a decode
    # chunk's wall is the host's launch rate, which drifts by tens of
    # percent within seconds, far more than the sampling work it resolves
    t_full, t_nosample = _median_times(
        [run_decode(True), run_decode(False)], iters)
    # pipeline_bubble: the per-stage idle wall a decode step, from the
    # stage-sharded engine's own stage timings (the JAX breakdown's)
    pipe_bubble_ms = pipe_snap = None
    if staged:
        pipe_snap = engine.pipeline_perf(reset=True)
        if pipe_snap["steps"] and pipe_snap["bubble_frac"] is not None:
            n_st = pipe_snap["stages"]
            idle = (n_st * pipe_snap["window_s"]
                    - sum(pipe_snap["stage_busy_s"]))
            pipe_bubble_ms = round(
                max(idle, 0.0) / (n_st * pipe_snap["steps"]) * 1e3, 4)
    t_read = max(_median_time(run_read, iters) - t_rtt, 0.0)

    cfg = engine.cfg
    cache = engine.cache
    # a stage-sharded engine's layers are its stages' slabs' layers
    caches = cache["stages"] if "stages" in cache else [cache]
    cache = caches[0]
    quantized = "k_s" in cache
    # paged engines keep pool blocks: the probes read through the slot
    # block tables, the same indirection the decode step pays
    paged = "tbl" in cache
    bt_blk = int(cache["k"].shape[2]) if paged else 0
    nb = min(span // bt_blk, int(cache["tbl"].shape[1])) if paged else 0
    layers = [(c, i) for c in caches for i in range(c["k"].shape[0])]
    n_layers = len(layers)

    def layer_span(name, li):
        c, i = layers[li]
        rows_all = c[name][i]
        if paged:
            return rows_all   # whole pool layer; the table slices
        return rows_all[:, :span]

    def layer_kv(li):
        return [layer_span(n, li) if n in cache else None
                for n in ("k", "v", "k_s", "v_s")]

    def tables():
        return engine.cache["tbl"][:, :nb] if paged else None

    def probe_q(seed, rows):
        gen = torch.Generator(device=dev).manual_seed(seed)
        return torch.randn((n_slots, rows, cfg.n_heads, cfg.head_dim),
                           generator=gen, device=dev).to(cfg.dtype)

    q_probe = probe_q(7, 1)

    def run_attn():
        acc = torch.zeros((), dtype=torch.float32, device=dev)
        tbl = tables()
        for li in range(n_layers):
            out = llama.decode_attention(cfg, q_probe, *layer_kv(li),
                                         engine.lengths, tbl)
            acc = acc + out.float().sum()
        acc.item()

    run_attn()   # untimed first call
    attn_kernel_ms = round(
        max(_median_time(run_attn, iters) - t_rtt, 0.0) * 1e3, 4)

    # one continuation chunk of prefill attention per layer at the end of
    # the live span: the TTFT-side twin of attn_kernel (K3-paged through
    # the tables on a paged engine)
    span_p = nb * bt_blk if paged else span
    pchunk = max(1, min(32, span_p))
    q_off = span_p - pchunk
    qp_probe = probe_q(11, pchunk)

    def run_prefill_attn():
        acc = torch.zeros((), dtype=torch.float32, device=dev)
        tbl = tables()
        for li in range(n_layers):
            out = llama.prefill_attention(cfg, qp_probe, *layer_kv(li),
                                          q_offset=q_off, tables=tbl)
            acc = acc + out.float().sum()
        acc.item()

    run_prefill_attn()   # untimed first call
    prefill_attn_ms = round(
        max(_median_time(run_prefill_attn, iters) - t_rtt, 0.0) * 1e3, 4)

    def gathered_span(name, li):
        """The slot x span KV volume through the block tables (the paged
        read path): [slots, nb * bt, ...]."""
        return gather_pages(tables(), engine.cache[name][li])[0]

    if quantized:
        def run_dequant():
            acc = torch.zeros((), dtype=torch.float32, device=dev)
            read = gathered_span if paged else layer_span
            for li in range(n_layers):
                k = llama.dequantize_kv(read("k", li), read("k_s", li),
                                        cfg.dtype)
                v = llama.dequantize_kv(read("v", li), read("v_s", li),
                                        cfg.dtype)
                acc = acc + (k.float().sum() + v.float().sum())
            acc.item()

        run_dequant()   # untimed first call
        attn_dequant_ms = round(
            max(_median_time(run_dequant, iters) - t_rtt, 0.0) * 1e3, 4)
    else:
        attn_dequant_ms = 0.0   # nothing to dequantize, by definition

    kv_gather_ms = None
    if paged:
        # the block-table indirection's tax on the span read: the same
        # slot x span volume read through the tables and as a contiguous
        # block range
        vol = min(n_slots * nb, int(cache["k"].shape[1]))

        def run_gather():
            acc = torch.zeros((), dtype=torch.float32, device=dev)
            for li in range(n_layers):
                acc = acc + (gathered_span("k", li).float().sum()
                             + gathered_span("v", li).float().sum())
            acc.item()

        def run_contig():
            acc = torch.zeros((), dtype=torch.float32, device=dev)
            for li in range(n_layers):
                acc = acc + (engine.cache["k"][li][:vol].float().sum()
                             + engine.cache["v"][li][:vol].float().sum())
            acc.item()

        run_gather()
        run_contig()   # untimed first calls
        t_gather, t_contig = _median_times([run_gather, run_contig], iters)
        kv_gather_ms = round(max(t_gather - t_contig, 0.0) * 1e3, 4)

    kv_handoff_ms = None
    if engine.kvcache is not None and not paged:
        from kubeflow_tpu_torch.kvcache import RadixKVCache
        from kubeflow_tpu_torch.serving.disagg import KVHandoff

        bt = engine.prefix_block_tokens
        scratch = RadixKVCache(bt, 4)
        handoff = KVHandoff(lambda: scratch)
        probe_tokens = list(range(1, bt + 1))

        def run_handoff():
            parts = engine._extract_prefix_raw(0, bt)
            payload = engine._payload_slice(parts, 0, bt)
            scratch.clear()   # nothing pins the scratch between runs
            handoff.send(probe_tokens, [payload])
            # value fetch: waits (a stage-sharded payload is per stage)
            _leaves(payload)[-1].flatten()[0].item()

        run_handoff()   # untimed first call
        kv_handoff_ms = round(
            max(_median_time(run_handoff, iters) - t_rtt, 0.0) * 1e3, 4)

    per_step = 1e3 / steps
    dev_full_ms = max(t_full - t_rtt, 0.0) * per_step
    # the stripped chunk does less than the full one: a median above the
    # full chunk's is noise, the sampling stage then being under the
    # timing's resolution (on a host-bound step its launches are about 3%
    # of the step, while the two medians move apart by a few percent from
    # call to call), so its bucket is 0 and the three buckets still
    # partition the measured step
    dev_nosample_ms = min(max(t_nosample - t_rtt, 0.0) * per_step,
                          dev_full_ms)
    weight_read_ms = t_read * 1e3
    sampling_ms = max(dev_full_ms - dev_nosample_ms, 0.0)
    attn_kv_ms = max(dev_nosample_ms - weight_read_ms, 0.0)

    perf = engine.perf_counters()
    host_ms = None
    dispatch_host_ms = None
    if perf.get("decode_steps"):
        host_ms = round(perf["fetch_replay_s"] * 1e3
                        / perf["decode_steps"], 4)
        dispatch_host_ms = round(perf["dispatch_s"] * 1e3
                                 / perf["decode_steps"], 4)

    out = {
        "steps": steps, "span": span, "n_slots": n_slots,
        "fill_len": fill_len, "iters": iters,
        "chunk_wall_ms": round(t_full * 1e3, 4),
        "device_step_ms": round(dev_full_ms, 4),
        "dispatch_rtt_ms": round(t_rtt * 1e3, 4),
        "weight_read_bytes": read_bytes,
        "weight_read_gbps": round(read_bytes / max(t_read, 1e-9) / 1e9, 1),
        "buckets_ms": {
            "weight_read": round(weight_read_ms, 4),
            "attention_kv_update": round(attn_kv_ms, 4),
            # probes of attention_kv_update, not part of the partition
            "attn_kernel": attn_kernel_ms,
            "attn_dequant": attn_dequant_ms,
            # per prefill chunk, not per decode step
            "prefill_attn": prefill_attn_ms,
            "sampling_penalties": round(sampling_ms, 4),
            "dispatch_rtt_per_step": round(t_rtt * per_step, 4),
            "host_fetch_replay_per_step": host_ms,
            "kv_handoff": kv_handoff_ms,
            "kv_gather": kv_gather_ms,
            "pipeline_bubble": pipe_bubble_ms,
        },
        "host_dispatch_per_step_ms": dispatch_host_ms,
        "perf_counters": perf,
    }
    if pipe_snap is not None:
        out["pipeline"] = pipe_snap
    if hbm_gbps:
        floor_ms = read_bytes / (hbm_gbps * 1e9) * 1e3
        out["weight_read_floor_ms"] = round(floor_ms, 4)
        out["weight_read_frac_of_peak"] = round(
            floor_ms / max(weight_read_ms, 1e-9), 4)
    if trace_dir:
        # the trace artifact: one full chunk under torch.profiler
        try:
            reset_state()
            with trace(trace_dir):
                run_decode(True)()
            with open(os.path.join(trace_dir, "PROFILE_DONE"), "w") as f:
                f.write(f"decode chunk steps={steps} span={span}\n")
            out["trace_dir"] = trace_dir
        except Exception as e:   # profiling must never kill the caller
            out["trace_error"] = f"{type(e).__name__}: {e}"

    # leave the engine as a fresh one: slot state reset, host mirrors
    # zeroed (the junk cache rows are dead; the next prefill into a slot
    # rewrites them), the pipeline accounting reset (the trace run's
    # chunk is not traffic)
    if staged:
        engine.pipeline_perf(reset=True)
    engine.lengths.zero_()
    engine.last_tokens.zero_()
    reset_samp()
    engine._host_lengths[:] = 0
    engine._active_host = None   # the next decode uploads its own mask
    return out
