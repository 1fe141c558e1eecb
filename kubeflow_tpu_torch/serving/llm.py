"""Continuous-batching LLM engine (counterpart of kubeflow_tpu/serving/
llm.py `LLMEngine`, slab KV).

One engine owns the params, a slab KV cache [L, n_slots, max_len, kv, hd]
(int8 with per-token scales, or the model dtype) and a scheduler. Each
`step()` runs either one prefill wave — every queued request that gets a
free slot, grouped by prompt bucket, one batched forward per bucket, and
one chained dispatch per prompt longer than the largest bucket (chunked
prefill) — or one decode chunk of up to `decode_chunk` steps over all
slots, with attention bounded to the smallest power-of-two span that
covers every live length (the length-aware span menu). Tokens reach the
host once per wave or chunk, as one packed f32 row per token: [token,
logprob, top-N ids, top-N logprobs] (`_pack_out`, N = logprobs_topk).

The decode program menu. A chunk is a program keyed (k, span, sample):
k steps at attention span `span`, with ("sample") or without the
sampling pipeline. On a CUDA engine each program is a captured
`torch.cuda.CUDAGraph` of `_decode_body` over static buffers (lengths,
last tokens, the sampling rows, the penalty counts, the active mask, the
KV cache), every graph in one memory pool; a chunk is one replay. On a
CPU engine the program is the eager body. `warmup()` captures the JAX
engine's menu; before it a missing key is captured on first use, after
it a key outside the menu runs the full-span program. Every piece of
slot state is updated in place (`copy_`, indexed writes), never rebound,
so the graphs always read the live tensors.

Pipelined decode (`pipeline_decode=True`, the default): chunk N+1 is
dispatched before chunk N's tokens are fetched, so the host's fetch and
replay overlap the card's work. A replay's output is copied, in stream
order, into one of two pinned host buffers behind a CUDA event, since
the next replay of the same graph overwrites the static output. The host
drains the chunk in flight before any prefill and before going idle.

Sampling (`_choose`, the JAX `_choose`): presence/frequency penalties are
the logit edit lg - presence·1[cnt>0] - frequency·cnt over the slot's
generated-token counts, applied unconditionally (a row without penalties
subtracts exactly 0.0, so greedy stays bit-exact); then greedy rows take
the argmax, and sampled rows draw over the candidates that pass top-k and
top-p with the Gumbel-max trick. The draw is counter-based, in torch
integer ops only, and so the same in a graph replay and in the eager
body: the Gumbel noise of vocab entry v is a 32-bit integer hash of (row
key, v). A seeded row's key is a hash of (seed, position) alone,
independent of slot, batchmates, chunking and engine; an unseeded row's
key is a hash of (sample_seed, slot, position, the engine's draw counter,
a device scalar every sampling call advances in place). This replaces
the engine-wide `torch.Generator`, which a graph would have to register.

Host side: stop sequences are matched on the accumulated output at
replay and removed from the tokens and logprobs (finish reason "stop");
`cancel` and deadlines take effect at the top of the next `step()`
(finish reason "cancelled").

Not in this engine yet: the radix prefix cache, speculative decoding,
streaming and adapters.
"""

from __future__ import annotations

import functools
import math
import threading
import time
from typing import Any, Sequence

import numpy as np
import torch

from kubeflow_tpu_torch._device import resolve_device
from kubeflow_tpu_torch.models import llama
from kubeflow_tpu_torch.ops import _build
from kubeflow_tpu_torch.serving.scheduler import (DecodeAction,
                                                  PrefillAction,
                                                  PromptTooLong, PyScheduler)

_M32 = 0xFFFFFFFF


def _to_device(tree: Any, device: torch.device) -> Any:
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device)


def _fold_seed24(seed: int) -> int:
    """Fold a non-negative seed onto the f32-exact 24-bit range the
    sampling row carries, with the splitmix64 finalizer (the JAX engine's
    fold, bit for bit)."""
    mask = (1 << 64) - 1
    z = (seed + 0x9E3779B97F4A7C15) & mask
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & mask
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & mask
    return (z ^ (z >> 31)) & 0xFFFFFF


def _mix32(x):
    """A 32-bit xor-shift-multiply finalizer on int64 tensors (or ints)
    holding values in [0, 2^32): every product stays below 2^63, so CPU
    and CUDA compute the same bits."""
    x = ((x >> 16) ^ x) * 0x45D9F3B & _M32
    x = ((x >> 16) ^ x) * 0x45D9F3B & _M32
    return (x >> 16) ^ x


class _GraphProgram:
    """One captured decode chunk: a replay, the launch counts the capture
    recorded (added once per replay, as the kernels run once per replay),
    and the static output it writes."""

    def __init__(self, engine, graph, out, launches):
        self.engine = engine
        self.graph = graph
        self.out = out
        self.launches = launches

    def __call__(self) -> torch.Tensor:
        self.graph.replay()
        _build.add_counts(self.launches)
        self.engine._graph_replays += 1
        return self.out


class LLMEngine:
    """Slab-KV continuous-batching generation over llama params."""

    #: nucleus/top-k filtering looks at this many top candidates; a
    #: request may not ask for a larger top_k (the JAX engine's default)
    SAMPLE_K_MAX = 64

    def __init__(self, params, cfg: llama.LlamaConfig, *, n_slots: int = 4,
                 max_len: int = 512, buckets: Sequence[int] = (64, 128, 256),
                 eos_id: int | None = None, decode_chunk: int = 8,
                 sample_seed: int = 0, quantize: str | None = None,
                 kv_quantize: str | None = None, logprobs_topk: int = 0,
                 pipeline_decode: bool = True, device="cuda"):
        if max(buckets) >= max_len:
            raise ValueError("largest bucket must leave room to decode")
        if quantize not in (None, "int8"):
            raise ValueError(f"unknown quantize mode {quantize!r}")
        if kv_quantize not in (None, "int8"):
            raise ValueError(f"unknown kv_quantize mode {kv_quantize!r}")
        if not 0 <= logprobs_topk <= 16:
            raise ValueError("logprobs_topk must be 0..16")
        self.device = resolve_device(device)
        if self.device.type == "cuda" and cfg.dtype != torch.bfloat16:
            raise ValueError("the CUDA kernels run bfloat16 models")
        params = _to_device(params, self.device)
        if quantize == "int8":
            params = llama.quantize_params(params)
        self.params = params
        self.cfg = cfg
        self.kv_quantize = kv_quantize
        self.logprobs_topk = logprobs_topk
        self.pipeline_decode = pipeline_decode
        self.n_slots = n_slots
        self.max_len = max_len
        self.buckets = tuple(sorted(buckets))
        self.eos_id = eos_id
        self.decode_chunk = max(1, decode_chunk)
        self.scheduler = PyScheduler(n_slots, self.buckets)
        dev = self.device
        # -- slot state on the device: allocated once, updated in place
        self.cache = self._alloc_cache()
        self.lengths = torch.zeros(n_slots, dtype=torch.int32, device=dev)
        self.last_tokens = torch.zeros(n_slots, dtype=torch.long, device=dev)
        # per-slot (temperature, top_k, top_p, presence, frequency, seed);
        # the host copy decides which program variant a chunk runs, so no
        # device value is read
        self._samp_host = self._samp_reset()
        self.samp = torch.from_numpy(self._samp_host).to(dev)
        # generated-token counts per slot: the penalty state
        self._cnt = torch.zeros((n_slots, cfg.vocab_size), dtype=torch.int32,
                                device=dev)
        self._active_dev = torch.zeros(n_slots, dtype=torch.bool, device=dev)
        self._slot_ids = torch.arange(n_slots, device=dev)
        # -- the counter-based sampler (module docstring)
        self._draws = torch.zeros((), dtype=torch.long, device=dev)
        self._seed_key = _mix32(int(sample_seed) & _M32)
        self._vocab_key = _mix32(
            (torch.arange(cfg.vocab_size, device=dev, dtype=torch.long)
             * 0x9E3779B1 + 0x7F4A7C15) & _M32)
        # -- the program menu
        self._programs: dict[tuple[int, int, bool], Any] = {}
        self._warmed = False
        self._graph_pool = (torch.cuda.graph_pool_handle()
                            if dev.type == "cuda" else None)
        self._graph_captures = 0
        self._graph_replays = 0
        self._host_out: list[torch.Tensor] = []
        self._host_out_next = 0
        # -- pipelining: one dispatched, unfetched chunk may be in flight;
        # _inflight holds its planned KV rows per slot
        self._pending: tuple | None = None
        self._inflight = np.zeros(n_slots, np.int64)
        self._host_lengths = np.zeros(n_slots, np.int64)
        self._active_host: np.ndarray | None = None
        # -- requests
        self._submit_lock = threading.Lock()
        self._prompts: dict[int, list[int]] = {}
        self._req_samp: dict[int, tuple] = {}
        self._req_stop: dict[int, list[list[int]]] = {}
        self._max_new: dict[int, int] = {}
        self._results: dict[int, list[int]] = {}
        self._logprobs: dict[int, list[float]] = {}
        self._toplogprobs: dict[int, list[dict[int, float]]] = {}
        self._finish_reasons: dict[int, str] = {}
        self._submit_t: dict[int, float] = {}
        self._first_token_t: dict[int, float] = {}
        self._done: set[int] = set()
        self._cancel_pending: list[int] = []
        self._deadlines: dict[int, float] = {}
        # host-side decode counters (perf_counters), the JAX engine's keys
        self._perf = {"dispatch_s": 0.0, "fetch_replay_s": 0.0,
                      "decode_chunks": 0, "decode_steps": 0,
                      "active_uploads": 0}

    def _samp_reset(self) -> np.ndarray:
        """Idle per-slot sampling state: all zero (greedy, filters and
        penalties off) but the seed column's -1 (unseeded)."""
        s = np.zeros((self.n_slots, 6), np.float32)
        s[:, 5] = -1.0
        return s

    def _upload(self, dst: torch.Tensor, src: np.ndarray) -> None:
        """Copy a host array into a device tensor in place, in stream
        order: on the card through a pinned staging copy, so the host need
        not wait for a chunk in flight."""
        host = torch.from_numpy(np.ascontiguousarray(src))
        if dst.is_cuda:
            dst.copy_(host.pin_memory(), non_blocking=True)
        else:
            dst.copy_(host)

    def perf_counters(self, reset: bool = False) -> dict[str, Any]:
        """Decode host-side attribution counters: the wall time spent
        issuing each chunk (dispatch_s) and fetching its tokens and
        replaying them into the requests (fetch_replay_s), chunk and step
        counts, and active-mask uploads. The serving profiler
        (training/profiling.serving_decode_breakdown) reads them."""
        out = dict(self._perf)
        if reset:
            for key in self._perf:
                self._perf[key] = type(self._perf[key])(0)
        return out

    def graph_stats(self) -> dict[str, Any]:
        """The program menu: captures, replays, the captured keys and the
        graph pool's memory (the allocator segments of the pool the
        graphs share; 0 on a CPU engine)."""
        pool_bytes = 0
        if self._graph_pool is not None:
            pool = tuple(self._graph_pool)
            pool_bytes = sum(
                seg["total_size"] for seg in torch.cuda.memory_snapshot()
                if tuple(seg.get("segment_pool_id", ())) == pool)
        return {"captures": self._graph_captures,
                "replays": self._graph_replays,
                "keys": sorted(self._programs),
                "pool_bytes": pool_bytes,
                "warmed": self._warmed}

    # -- sampling ------------------------------------------------------------

    def _row_keys(self, samp: torch.Tensor, slots: torch.Tensor,
                  positions: torch.Tensor) -> torch.Tensor:
        """Per-row draw keys in [0, 2^32): seeded rows from (seed,
        position), unseeded rows from (sample_seed, slot, position, draw
        counter)."""
        seeds = samp[:, 5].long()
        pos = positions.long()
        seeded = _mix32(_mix32(seeds.clamp_min(0) + 0x5EED) ^ pos)
        unseeded = _mix32(_mix32(_mix32(self._seed_key ^ slots.long()) ^ pos)
                          ^ (self._draws & _M32))
        return torch.where(seeds >= 0, seeded, unseeded)

    def _gumbel(self, keys: torch.Tensor) -> torch.Tensor:
        """Gumbel noise [R, V] from the row keys: u = (hash >> 9 + 0.5) /
        2^23, exact in f32 and inside (0, 1)."""
        h = _mix32(keys[:, None] ^ self._vocab_key[None])
        u = ((h >> 9).float() + 0.5) * (1.0 / 8388608.0)
        return -torch.log(-torch.log(u))

    def _sample_mask(self, probs: torch.Tensor, topks: torch.Tensor,
                     topps: torch.Tensor) -> torch.Tensor:
        """The candidates each row may draw [R, V] bool: one probability
        threshold from the sorted top SAMPLE_K_MAX candidates (keep j
        while the mass before j is < top_p and j < top_k); rows with both
        filters off keep everything."""
        kmax = min(self.SAMPLE_K_MAX, probs.shape[-1])
        top_vals = torch.topk(probs, kmax, dim=-1).values     # descending
        cum = torch.cumsum(top_vals, dim=-1)
        p_lim = torch.where((topps > 0) & (topps < 1), topps,
                            torch.full_like(topps, 2.0))
        keep_p = (cum - top_vals) < p_lim[:, None]
        kk = torch.where(topks > 0, topks.clamp_max(kmax),
                         torch.full_like(topks, kmax))
        keep = keep_p & (torch.arange(kmax, device=probs.device)[None]
                         < kk[:, None])
        n_keep = keep.sum(dim=-1).clamp_min(1)
        thr = top_vals.gather(1, (n_keep - 1)[:, None])[:, 0]
        use_filter = (topks > 0) | ((topps > 0) & (topps < 1))
        thr = torch.where(use_filter, thr, torch.zeros_like(thr))
        return probs >= thr[:, None]

    def _choose(self, logits: torch.Tensor, samp: torch.Tensor,
                slots: torch.Tensor, counts: torch.Tensor | None,
                positions: torch.Tensor, sampling: bool) -> torch.Tensor:
        """The JAX `_choose`: logits [R, V] f32 raw model logits, samp
        [R, 6] sampling rows, slots [R], counts [R, V] int32 generated
        tokens (None: all zero, the prefill case, where the edit is the
        identity), positions [R] the generation position sampled (the
        seeded key's input) -> tokens [R] long.

        Penalties edit the logits first; temperature-0 rows take the
        argmax of the edited logits, the others draw over the candidates
        that pass top-k/top-p. `sampling` False (no row samples) skips the
        draw and its counter step."""
        if counts is not None:
            logits = (logits
                      - samp[:, 3:4] * (counts > 0).float()
                      - samp[:, 4:5] * counts.float())
        greedy = torch.argmax(logits, dim=-1)
        if not sampling:
            return greedy
        temps, topks, topps = samp[:, 0], samp[:, 1], samp[:, 2]
        scaled = logits / temps.clamp_min(1e-6)[:, None]
        probs = torch.softmax(scaled, dim=-1)
        masked = torch.where(self._sample_mask(probs, topks, topps), scaled,
                             torch.full_like(scaled, -math.inf))
        noise = self._gumbel(self._row_keys(samp, slots, positions))
        self._draws += 1
        sampled = torch.argmax(masked + noise, dim=-1)
        return torch.where(temps > 0, sampled, greedy)

    def _pack_out(self, toks: torch.Tensor,
                  logits: torch.Tensor) -> torch.Tensor:
        """One f32 row per token: [token, its logprob under the raw
        logits, top-N ids, top-N logprobs] (N = logprobs_topk; ids are
        exact in f32 below 2^24)."""
        lse = torch.logsumexp(logits, dim=-1)
        lp = logits.gather(-1, toks[..., None])[..., 0] - lse
        cols = [toks.float()[..., None], lp[..., None]]
        if self.logprobs_topk:
            tv, tid = torch.topk(logits, self.logprobs_topk, dim=-1)
            cols += [tid.float(), tv - lse[..., None]]
        return torch.cat(cols, dim=-1)

    def _unpack_out(self, row) -> tuple[int, float, dict | None]:
        """Host twin of _pack_out: (token, logprob, {id: logprob} of the
        top-N or None)."""
        tok, lp = int(row[0]), float(row[1])
        if not self.logprobs_topk:
            return tok, lp, None
        n = self.logprobs_topk
        return tok, lp, {int(t): float(v)
                         for t, v in zip(row[2:2 + n], row[2 + n:2 + 2 * n])}

    # -- span menu -----------------------------------------------------------

    def _span_menu(self) -> list[int]:
        """Attention spans: powers of two from 128 up to, and always
        including, max_len."""
        spans = []
        s = 128
        while s < self.max_len:
            spans.append(s)
            s *= 2
        spans.append(self.max_len)
        return spans

    def _pick_span(self, needed: int) -> int:
        for s in self._span_menu():
            if s >= needed:
                return s
        return self.max_len

    # -- chunked prefill plan ------------------------------------------------

    def _tail_bucket(self, tail_len: int) -> int | None:
        cands = [b for b in self.buckets if b >= tail_len]
        return min(cands) if cands else None

    def _chunk_plan(self, n: int) -> list[tuple[int, int]]:
        """Chunked-prefill schedule of an n-token prompt longer than the
        largest bucket: [(chunk_len, program_len), ...], full largest-
        bucket chunks, then a tail rounded up to a bucket. Raises
        PromptTooLong when no tail bucket fits inside max_len."""
        big = self.buckets[-1]
        if n >= self.max_len:
            raise PromptTooLong(
                f"prompt_len {n} leaves no room to decode in max_len "
                f"{self.max_len}")
        plan = []
        done = 0
        while n - done > big:
            plan.append((big, big))
            done += big
        tail = n - done
        t = self._tail_bucket(tail)
        if t is None or done + t > self.max_len:
            raise PromptTooLong(
                f"prompt_len {n}: tail {tail} after {done} chunked tokens "
                f"fits no bucket within max_len {self.max_len}")
        plan.append((tail, t))
        return plan

    def _chunk_plan_from(self, n: int, start: int
                         ) -> list[tuple[int, int]] | None:
        """The schedule of tokens [start, n) of a long prompt; None when
        some boundary's continuation cannot fit inside max_len."""
        big = self.buckets[-1]
        plan = []
        done = start
        while n - done > big:
            if done + big > self.max_len:
                return None
            plan.append((big, big))
            done += big
        t = self._tail_bucket(n - done)
        if t is None or done + t > self.max_len:
            return None
        plan.append((n - done, t))
        return plan

    # -- public API ----------------------------------------------------------

    @staticmethod
    def _pack_temp(temp: float) -> int:
        """Nearest milli, with a floor of 1 for any temperature > 0."""
        return max(1, round(temp * 1000)) if temp > 0 else 0

    @staticmethod
    def _pack_milli(v: float) -> int:
        """Signed nearest milli, with a floor of ±1 on nonzero values: a
        penalty below 0.0005 stays a minimal penalty, not off."""
        if v == 0:
            return 0
        q = round(v * 1000)
        return q if q else (1 if v > 0 else -1)

    def _samp_row(self, temperature, top_k, top_p, presence, frequency,
                  seed) -> tuple:
        """A request's sampling row as the JAX engine's programs see it:
        temperature and penalties in milli units, top_p in micro units
        (floor 1), divided back in f32."""
        f32 = np.float32
        topp = 1_000_000 if top_p >= 1 else max(1, round(top_p * 1e6))
        return (f32(self._pack_temp(temperature)) / f32(1000.0),
                f32(int(top_k)), f32(topp) / f32(1e6),
                f32(self._pack_milli(presence)) / f32(1000.0),
                f32(self._pack_milli(frequency)) / f32(1000.0),
                f32(-1 if seed is None else seed))

    def _validate_submit(self, prompt, temperature, top_k, top_p,
                         presence_penalty, frequency_penalty, seed, stop,
                         deadline_s, max_new_tokens):
        """Every submit()-time check, with the JAX engine's messages.
        Returns the normalized (temperature, top_k, top_p, presence,
        frequency, folded seed, stop sequences)."""
        if not (math.isfinite(temperature) and 0 <= temperature <= 100):
            raise ValueError("temperature must be finite and in [0, 100]")
        top_k = int(top_k)
        if not 0 <= top_k <= self.SAMPLE_K_MAX:
            raise ValueError(
                f"top_k must be 0..{self.SAMPLE_K_MAX} (the engine's "
                "static sample_k_max candidate window)")
        top_p = float(top_p)
        if not (math.isfinite(top_p) and 0 < top_p <= 1):
            raise ValueError("top_p must be in (0, 1]")
        presence_penalty = float(presence_penalty)
        frequency_penalty = float(frequency_penalty)
        for name, v in (("presence_penalty", presence_penalty),
                        ("frequency_penalty", frequency_penalty)):
            if not (math.isfinite(v) and -2 <= v <= 2):
                raise ValueError(f"{name} must be finite and in [-2, 2]")
        if seed is not None:
            if not isinstance(seed, int) or isinstance(seed, bool) \
                    or seed < 0:
                raise ValueError("seed must be a non-negative int")
            seed = _fold_seed24(seed)
        stop_seqs: list[list[int]] = []
        for ss in (stop or ()):
            seq = [int(t) for t in ss]
            if not seq or len(seq) > 64:
                raise ValueError("each stop sequence must be 1..64 tokens")
            stop_seqs.append(seq)
        if len(stop_seqs) > 8:
            raise ValueError("at most 8 stop sequences per request")
        if deadline_s is not None and deadline_s <= 0:
            raise ValueError("deadline_s must be positive")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if any(not 0 <= int(t) < self.cfg.vocab_size for t in prompt):
            raise ValueError("prompt token outside the vocabulary")
        if len(prompt) > self.buckets[-1]:
            # chunked prefill: the chain is checked now, not mid-serve
            self._chunk_plan(len(prompt))
        return (temperature, top_k, top_p, presence_penalty,
                frequency_penalty, seed, stop_seqs)

    def submit(self, prompt: Sequence[int], max_new_tokens: int = 32,
               temperature: float = 0.0, top_k: int = 0,
               top_p: float = 1.0, presence_penalty: float = 0.0,
               frequency_penalty: float = 0.0, seed: int | None = None,
               stop: Sequence[Sequence[int]] | None = None,
               deadline_s: float | None = None) -> int:
        """Queue one request. A prompt longer than the largest bucket is
        chunked; PromptTooLong when it is empty or its chain cannot fit
        max_len, QueueFull when the queue is full, ValueError for bad
        arguments. Penalties (OpenAI [-2, 2]) edit the logits of the
        request's generated tokens, greedy rows included; `seed` makes its
        draws depend on (seed, position) alone; `stop`: token sequences
        that end the request (finish reason "stop") and are removed from
        the result; `deadline_s`: past it the request is cancelled at the
        next step."""
        (temperature, top_k, top_p, presence_penalty, frequency_penalty,
         seed, stop_seqs) = self._validate_submit(
            prompt, temperature, top_k, top_p, presence_penalty,
            frequency_penalty, seed, stop, deadline_s, max_new_tokens)
        # the scheduler sees the largest bucket for a chunked prompt: it
        # only picks the bucket; the engine keeps the true length
        sched_len = min(len(prompt), self.buckets[-1])
        with self._submit_lock:
            rid = self.scheduler.submit(sched_len, max_new_tokens)
            self._prompts[rid] = [int(t) for t in prompt]
            self._req_samp[rid] = self._samp_row(
                temperature, top_k, top_p, presence_penalty,
                frequency_penalty, seed)
            if stop_seqs:
                self._req_stop[rid] = stop_seqs
            if deadline_s is not None:
                self._deadlines[rid] = time.monotonic() + deadline_s
            self._max_new[rid] = max_new_tokens
            self._results[rid] = []
            self._logprobs[rid] = []
            if self.logprobs_topk:
                self._toplogprobs[rid] = []
            self._submit_t[rid] = time.monotonic()
        return rid

    def cancel(self, req_id: int) -> bool:
        """Ask the engine to drop a request; it takes effect at the top
        of the next step(). Thread-safe. True when the request was still
        queued or running."""
        with self._submit_lock:
            if req_id in self._done or req_id not in self._results:
                return False
            self._cancel_pending.append(req_id)
            return True

    def _apply_cancellations(self) -> None:
        """Top of step(): drop queued cancellations and expired deadlines
        with finish reason "cancelled"."""
        now = time.monotonic()
        with self._submit_lock:
            pending = self._cancel_pending
            self._cancel_pending = []
            pending += [r for r, dl in self._deadlines.items()
                        if now >= dl and r not in self._done]
            for rid in dict.fromkeys(pending):
                if rid in self._done or rid not in self._results:
                    continue
                self.scheduler.cancel(rid)
                self._finish_reasons[rid] = "cancelled"
                self._forget(rid)

    def step(self) -> bool:
        """One engine iteration: a prefill wave or a decode chunk. False
        when there is nothing to do."""
        self._apply_cancellations()
        with self._submit_lock:
            action = self.scheduler.next()
        if action is None:
            if self._pending is not None:
                self._drain_pending()   # the last chunk's tokens
                return True
            return False
        if isinstance(action, DecodeAction):
            self._do_decode()
            return True
        # the chunk in flight lands first: its replay frees slots, and the
        # prefill below overwrites what it wrote into a reused slot
        self._drain_pending()
        actions = [action]
        while len(actions) < self.n_slots:
            with self._submit_lock:
                nxt = self.scheduler.next()
            if not isinstance(nxt, PrefillAction):
                break    # a decode pass re-derives from slot state later
            actions.append(nxt)
        actions = self._admit_prefills(actions)
        if actions:
            self._run_prefill_actions(actions)
        return True

    def _admit_prefills(self, actions: list[PrefillAction]
                        ) -> list[PrefillAction]:
        """Admission between the scheduler's pop and the waves: the slab
        engine's rows are preallocated per slot, so it admits everything.
        The paged engine reserves KV blocks here and holds back what it
        cannot fund yet."""
        return actions

    def _run_prefill_actions(self, actions: list[PrefillAction]) -> None:
        """One batched prefill per prompt bucket and one chained prefill
        per chunked prompt, all dispatched before any token is fetched."""
        groups: dict[int, list[PrefillAction]] = {}
        chunked = []
        for a in actions:
            if len(self._prompts[a.req_id]) > a.bucket_len:
                chunked.append(a)
            else:
                groups.setdefault(a.bucket_len, []).append(a)
        dispatched = [(wave, self._dispatch_prefill_wave(bucket, wave))
                      for bucket, wave in groups.items()]
        dispatched += [([a], self._dispatch_chunked_prefill(a))
                       for a in chunked]
        for wave, out in dispatched:
            out_np = out.cpu().numpy()    # one fetch per wave
            for i, a in enumerate(wave):
                self._host_lengths[a.slot] = len(self._prompts[a.req_id])
                tok, lp, top = self._unpack_out(out_np[i])
                self._record_token(a.req_id, a.slot, tok, lp, top,
                                   first_token=True)

    def run_until_idle(self) -> None:
        while self.step():
            pass

    def generate(self, prompt: Sequence[int], max_new_tokens: int = 32,
                 **kw) -> list[int]:
        rid = self.submit(prompt, max_new_tokens, **kw)
        while not self.is_done(rid):
            if not self.step():
                raise RuntimeError("engine idle with request outstanding")
        return self.result(rid)

    def is_done(self, req_id: int) -> bool:
        return req_id in self._done

    def result(self, req_id: int) -> list[int]:
        if req_id not in self._done:
            raise KeyError(f"request {req_id} not finished")
        return self._results[req_id]

    def result_logprobs(self, req_id: int) -> list[float]:
        """Per-token logprobs of result(req_id) under the raw model
        distribution (the OpenAI convention)."""
        if req_id not in self._done:
            raise KeyError(f"request {req_id} not finished")
        return self._logprobs[req_id]

    def result_top_logprobs(self, req_id: int) -> list[dict[int, float]]:
        """Per-position top-N alternatives ({token_id: logprob}); needs
        an engine built with logprobs_topk > 0."""
        if not self.logprobs_topk:
            raise ValueError("engine built with logprobs_topk=0")
        if req_id not in self._done:
            raise KeyError(f"request {req_id} not finished")
        return self._toplogprobs[req_id]

    def partial_result(self, req_id: int) -> list[int]:
        """Tokens generated so far (a copy)."""
        return list(self._results.get(req_id, ()))

    def partial_logprobs(self, req_id: int) -> list[float]:
        """Logprobs of the tokens generated so far (a copy)."""
        return list(self._logprobs.get(req_id, ()))

    def finish_reason(self, req_id: int) -> str:
        """"stop" (EOS or a stop sequence), "length" (max_new_tokens or
        cache room) or "cancelled"."""
        return self._finish_reasons.get(req_id, "length")

    def ttft_seconds(self, req_id: int) -> float | None:
        if req_id not in self._first_token_t:
            return None
        return self._first_token_t[req_id] - self._submit_t[req_id]

    def release(self, req_id: int) -> None:
        """Drop a finished request's state; servers call this after
        reading the result."""
        self._done.discard(req_id)
        for d in (self._results, self._logprobs, self._toplogprobs,
                  self._finish_reasons, self._submit_t,
                  self._first_token_t):
            d.pop(req_id, None)

    # -- prefill -------------------------------------------------------------

    def _dispatch_prefill_wave(self, bucket: int,
                               wave: list[PrefillAction]) -> torch.Tensor:
        """One batched prefill of `wave` (prompts right-padded to
        `bucket`): writes each prompt's KV into its slot and samples its
        first token from the last prompt row. Returns the packed rows
        [W, cols] on the device, not fetched."""
        dev = self.device
        tokens = torch.zeros((len(wave), bucket), dtype=torch.long)
        for i, a in enumerate(wave):
            p = self._prompts[a.req_id]
            tokens[i, :len(p)] = torch.tensor(p)
        plens = [len(self._prompts[a.req_id]) for a in wave]
        x, (ks, vs) = llama.prefill_hidden(self.params, tokens.to(dev),
                                           self.cfg)
        for i, a in enumerate(wave):
            self._cache_write(a.slot, 0, bucket, ks[:, i], vs[:, i])
        rows = torch.arange(len(wave), device=dev)
        last = x[rows, torch.tensor(plens, device=dev) - 1]
        return self._prefill_finish(last, wave, plens)

    def _dispatch_chunked_prefill(self, action: PrefillAction
                                  ) -> torch.Tensor:
        """Chained prefill of a prompt longer than the largest bucket: the
        first chunk is an ordinary bucket prefill, each further chunk runs
        `llama.prefill_continue_hidden` against the slot's own first rows
        (`_extract_prefix`, dequantized to the model dtype) and writes its
        rows after them. Returns the packed row [1, cols]."""
        dev = self.device
        prompt = self._prompts[action.req_id]
        n, slot, big = len(prompt), action.slot, self.buckets[-1]
        x, (ks, vs) = llama.prefill_hidden(
            self.params, torch.tensor([prompt[:big]], device=dev), self.cfg)
        self._cache_write(slot, 0, big, ks[:, 0], vs[:, 0])
        done, last = big, None
        for chunk_len, t in self._chunk_plan_from(n, big):
            k_prefix, v_prefix = self._extract_prefix(slot, done)
            tail = torch.zeros((1, t), dtype=torch.long)
            tail[0, :chunk_len] = torch.tensor(prompt[done:done + chunk_len])
            x, ks, vs = llama.prefill_continue_hidden(
                self.params, tail.to(dev), k_prefix, v_prefix, self.cfg)
            self._cache_write(slot, done, t, ks[:, 0], vs[:, 0])
            last = x[:, chunk_len - 1]
            done += chunk_len
        return self._prefill_finish(last, [action], [n])

    def _prefill_finish(self, last: torch.Tensor, wave: list[PrefillAction],
                        plens: list[int]) -> torch.Tensor:
        """The end of every prefill: the last prompt rows' logits, each
        slot's length, sampling row, first token and penalty counts (reset
        to that token's one-hot: penalties count generated tokens, and the
        first one is generated here). Returns the packed rows."""
        dev = self.device
        logits = llama.lm_head(self.params, last[:, None], self.cfg)[:, 0]
        slot_list = [a.slot for a in wave]
        for a in wave:
            self._samp_host[a.slot] = self._req_samp[a.req_id]
        self._upload(self.samp, self._samp_host)
        slots = torch.tensor(slot_list, device=dev)
        plens_dev = torch.tensor(plens, dtype=torch.int32, device=dev)
        self.lengths[slots] = plens_dev
        toks = self._choose(logits, self.samp[slots], slots, None, plens_dev,
                            bool((self._samp_host[slot_list, 0] > 0).any()))
        self.last_tokens[slots] = toks
        self._cnt[slots] = 0
        self._cnt[slots, toks] = 1
        return self._pack_out(toks, logits)

    def _alloc_cache(self) -> dict:
        """The KV cache: a slab [L, n_slots, max_len, kv, hd]."""
        return llama.init_cache(self.cfg, self.n_slots, self.max_len,
                                self.kv_quantize, device=self.device)

    def _cache_write(self, slot: int, start: int, count: int,
                     ks: torch.Tensor, vs: torch.Tensor) -> None:
        """Write [L, count, kv, hd] KV rows into rows [start, start +
        count) of a slot, quantizing when the cache is int8."""
        c = self.cache
        rows = slice(start, start + count)
        if self.kv_quantize == "int8":
            kq, ksc = llama.quantize_kv(ks)
            vq, vsc = llama.quantize_kv(vs)
            c["k"][:, slot, rows] = kq
            c["v"][:, slot, rows] = vq
            c["k_s"][:, slot, rows] = ksc
            c["v_s"][:, slot, rows] = vsc
        else:
            c["k"][:, slot, rows] = ks.to(c["k"].dtype)
            c["v"][:, slot, rows] = vs.to(c["v"].dtype)

    def _extract_prefix(self, slot: int, p: int
                        ) -> tuple[torch.Tensor, torch.Tensor]:
        """A slot's first p KV rows as [L, 1, p, kv, hd] in the model
        dtype (dequantized from int8): the chunked chain's prefix. The JAX
        slab engine also writes these rows back; re-quantizing dequantized
        int8 rows gives the same bytes, so the port leaves them."""
        c = self.cache
        k = c["k"][:, slot, :p][:, None]
        v = c["v"][:, slot, :p][:, None]
        if self.kv_quantize == "int8":
            k = llama.dequantize_kv(k, c["k_s"][:, slot, :p][:, None],
                                    self.cfg.dtype)
            v = llama.dequantize_kv(v, c["v_s"][:, slot, :p][:, None],
                                    self.cfg.dtype)
        return k.to(self.cfg.dtype), v.to(self.cfg.dtype)

    # -- the decode program menu ---------------------------------------------

    def _decode_body(self, steps: int, span: int,
                     sample: bool) -> torch.Tensor:
        """`steps` decode steps over every slot at attention span `span`,
        reading and updating the static slot state in place: the slots
        `_active_dev` marks advance, the others compute and write junk
        their next prefill overwrites. Returns the packed rows [steps,
        n_slots, cols] (`_pack_out` of the raw logits).

        sample=True runs `_choose` in full, penalties and the draw, and
        counts each active slot's token; sample=False is the raw argmax
        (the JAX `_decode_nosample_fn`), for batches with no sampled or
        penalized row, and the profiler's sampling-stripped variant."""
        active = self._active_dev
        step = active.to(torch.int32)
        outs = []
        for _ in range(steps):
            logits = llama.decode_step(self.params, self.last_tokens,
                                       self.cache, self.lengths, self.cfg,
                                       span=span)
            if sample:
                toks = self._choose(logits, self.samp, self._slot_ids,
                                    self._cnt, self.lengths + 1, True)
                self._cnt.scatter_add_(1, toks[:, None], step[:, None])
            else:
                toks = torch.argmax(logits, dim=-1)
            outs.append(self._pack_out(toks, logits))
            self.lengths += step
            self.last_tokens.copy_(torch.where(active, toks,
                                               self.last_tokens))
        return torch.stack(outs)

    def _chunk_state(self) -> list[torch.Tensor]:
        """The slot state a decode chunk changes besides the KV rows it
        writes."""
        return [self.lengths, self.last_tokens, self._cnt, self._draws]

    def _capture(self, key: tuple[int, int, bool]) -> _GraphProgram:
        """Capture the decode chunk `key` as a CUDA graph in the engine's
        pool. The body runs once first on a side stream (first-use work
        must not happen inside a capture), and the slot state it changed
        is put back, so a capture in live traffic is invisible to it: the
        KV rows that run wrote are written again, with the same values, by
        the replay that follows. A capture that fails raises."""
        dev = self.device
        body = functools.partial(self._decode_body, *key)
        counts = _build.snapshot_counts()
        saved = [t.clone() for t in self._chunk_state()]
        current = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            body()
        current.wait_stream(side)
        for t, s in zip(self._chunk_state(), saved):
            t.copy_(s)
        _build.restore_counts(counts)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self._graph_pool):
            out = body()
        launches = _build.counts_since(counts)
        _build.restore_counts(counts)
        self._graph_captures += 1
        return _GraphProgram(self, graph, out, launches)

    def _decode_fn(self, steps: int, span: int, sample: bool = True):
        """The decode program (steps, span, sample), made on first use: a
        captured graph on a CUDA engine, the eager body on a CPU one (the
        JAX `_decode_fn`)."""
        key = (steps, span, sample)
        prog = self._programs.get(key)
        if prog is None:
            if self.device.type == "cuda":
                prog = self._capture(key)
            else:
                prog = functools.partial(self._decode_body, *key)
            self._programs[key] = prog
        return prog

    def _decode_nosample_fn(self, steps: int, span: int):
        """The sampling-stripped program (the JAX `_decode_nosample_fn`)."""
        return self._decode_fn(steps, span, sample=False)

    def _decode_chunk(self, steps: int, span: int, active: torch.Tensor,
                      sample: bool = True) -> torch.Tensor:
        """Run the program (steps, span, sample) once: `active` [n_slots]
        bool on the device says which slots advance. Updates the cache,
        lengths, last tokens and penalty counts, and returns the packed
        rows [steps, n_slots, cols] on the device, not fetched (on the
        card the graph's static output, which the next replay of the same
        graph overwrites). The engine and the serving profiler run this
        same code."""
        if active is not self._active_dev:
            self._active_dev.copy_(active)
        return self._decode_fn(steps, span, sample)()

    def warmup(self) -> None:
        """Run each prefill bucket once and make the decode menu (the JAX
        engine's combos: every (chunk, span) pair when there are at most
        16, else every chunk at full span plus the largest chunk at every
        span; each in both variants), capturing every graph on a CUDA
        engine so live traffic never captures. Slot state is junk while it
        runs and reset in place after; call only while idle."""
        if self._pending is not None or any(
                self.scheduler.slot_request(s) >= 0
                for s in range(self.n_slots)):
            raise RuntimeError("warmup needs an idle engine")
        dev = self.device
        slot0 = self._slot_ids[:1]
        for bucket in self.buckets:
            x, (ks, vs) = llama.prefill_hidden(
                self.params, torch.ones((1, bucket), dtype=torch.long,
                                        device=dev), self.cfg)
            self._cache_write(0, 0, bucket, ks[:, 0], vs[:, 0])
            logits = llama.lm_head(self.params, x[:, -1:], self.cfg)[:, 0]
            toks = self._choose(logits, self.samp[:1], slot0, None,
                                self.lengths[:1], True)
            self._pack_out(toks, logits)
        chunks, k = [], 1
        while k <= self.decode_chunk:
            chunks.append(k)
            k *= 2
        spans = self._span_menu()
        combos = [(c, s) for c in chunks for s in spans]
        if len(combos) > 16:
            combos = ([(c, self.max_len) for c in chunks]
                      + [(chunks[-1], s) for s in spans[:-1]])
        self._active_dev.zero_()
        for c, span in combos:
            for sample in (True, False):
                self._decode_chunk(c, span, self._active_dev, sample)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        self.lengths.zero_()
        self.last_tokens.zero_()
        self._cnt.zero_()
        self._draws.zero_()
        self._samp_host[:] = self._samp_reset()
        self._upload(self.samp, self._samp_host)
        self._host_lengths[:] = 0
        self._inflight[:] = 0
        self._active_host = None
        self._warmed = True

    # -- decode --------------------------------------------------------------

    def _do_decode(self) -> None:
        """Dispatch one chunk of k decode steps over every slot; under
        pipeline_decode, then fetch and replay the chunk before it. k is
        the largest power of two <= decode_chunk that fits the cache
        headroom of the fullest slot (counting the rows of the chunk in
        flight) and is not past every request's remaining budget (less
        what the chunk in flight will deliver)."""
        if self._pending is not None:
            # nothing left for a new chunk to do: every budget is met by
            # the chunk in flight, or a slot has no room past its rows
            psr, psteps = self._pending[:2]
            full = max((int(self._host_lengths[s] + self._inflight[s])
                        for s in range(self.n_slots) if psr[s] >= 0),
                       default=0) >= self.max_len
            need = [self._max_new[r] - len(self._results[r])
                    for r in psr if r >= 0 and r in self._max_new]
            if full or all(n <= psteps for n in need):
                self._drain_pending()
                return
        slot_req = self._mask_unfunded(
            [self.scheduler.slot_request(s) for s in range(self.n_slots)])
        active = np.array([r >= 0 for r in slot_req], bool)
        if not active.any():
            return   # every live slot waits for KV blocks (paged engine)
        credit = [0] * self.n_slots
        if self._pending is not None:
            psr, psteps = self._pending[:2]
            for s, r in enumerate(psr):
                if r >= 0 and r == slot_req[s]:
                    credit[s] = psteps
        remaining = max(max(1, self._max_new[r] - len(self._results[r])
                            - credit[s])
                        for s, r in enumerate(slot_req) if r >= 0)
        planned = self._host_lengths + self._inflight
        longest = int(planned[active].max())
        headroom = self.max_len - longest
        k = 1
        while (k * 2 <= self.decode_chunk and k * 2 <= headroom
               and k < remaining):
            k *= 2
        span = self._pick_span(min(longest + k, self.max_len))
        samp = self._samp_host[active]
        sample = bool(((samp[:, 0] > 0) | (samp[:, 3] != 0)
                       | (samp[:, 4] != 0)).any())
        if self._warmed and (k, span, sample) not in self._programs:
            span = self.max_len   # never capture after warmup
        t_dispatch = time.perf_counter()
        out = self._decode_chunk(k, span, self._active_for(active), sample)
        handle = self._stage_out(out)
        self._perf["dispatch_s"] += time.perf_counter() - t_dispatch
        self._perf["decode_chunks"] += 1
        self._perf["decode_steps"] += k
        rows_added = np.where(active, k, 0)
        self._inflight += rows_added
        prev = self._pending
        self._pending = (slot_req, k, handle, rows_added)
        if not self.pipeline_decode:
            self._drain_pending()
        elif prev is not None:
            self._replay(prev)

    def _stage_out(self, out: torch.Tensor):
        """A chunk's output, safe to fetch later: on the card an
        asynchronous copy, in stream order, into one of two pinned host
        buffers, with an event to wait on; on the CPU the tensor itself."""
        if not out.is_cuda:
            return out, None
        n = out.numel()
        if not self._host_out or self._host_out[0].numel() < n:
            self._host_out = [torch.empty(n, dtype=out.dtype,
                                          pin_memory=True)
                              for _ in range(2)]
        buf = self._host_out[self._host_out_next][:n].view(out.shape)
        self._host_out_next ^= 1
        buf.copy_(out, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return buf, event

    def _drain_pending(self) -> None:
        """Fetch and replay the chunk in flight, if any. Runs before any
        prefill and before going idle."""
        p = self._pending
        if p is not None:
            self._pending = None
            self._replay(p)

    def _replay(self, pending) -> None:
        """Fetch one chunk's rows and replay them into the requests.
        `slot_req` is the slot map at dispatch: a slot that has changed
        hands since (a cancellation while the chunk was in flight) is
        skipped, as is a slot past its request's end."""
        slot_req, _, (buf, event), rows_added = pending
        t_replay = time.perf_counter()
        if event is not None:
            event.synchronize()
        out = buf.numpy()   # one fetch per chunk
        alive = [self.scheduler.slot_request(s) == slot_req[s]
                 for s in range(self.n_slots)]
        done_slots: set[int] = set()
        for row in out:
            for slot, req in enumerate(slot_req):
                if req < 0 or slot in done_slots or not alive[slot]:
                    continue
                self._host_lengths[slot] += 1
                tok, lp, top = self._unpack_out(row[slot])
                if self._record_token(req, slot, tok, lp, top):
                    done_slots.add(slot)
        self._inflight = np.maximum(self._inflight - rows_added, 0)
        self._perf["fetch_replay_s"] += time.perf_counter() - t_replay

    def _active_for(self, active: np.ndarray) -> torch.Tensor:
        """The decode active mask, copied into the static device buffer
        only when it changes (slots move at prefill and finish, not every
        chunk)."""
        if (self._active_host is None
                or not np.array_equal(active, self._active_host)):
            self._active_host = active.copy()
            self._upload(self._active_dev, active)
            self._perf["active_uploads"] += 1
        return self._active_dev

    def _mask_unfunded(self, slot_req: list[int]) -> list[int]:
        """Decode planning sees a slot whose prefill is held (paged
        engine: assigned, no KV funded yet) as empty (-1). The slab engine
        holds nothing."""
        return slot_req

    def _record_token(self, req_id: int, slot: int, token: int,
                      lp: float = 0.0, top: dict[int, float] | None = None,
                      first_token: bool = False) -> bool:
        """Append one token; True when it finished the request."""
        if first_token:
            self._first_token_t[req_id] = time.monotonic()
        res = self._results[req_id]
        res.append(token)
        self._logprobs[req_id].append(lp)
        if top is not None and req_id in self._toplogprobs:
            self._toplogprobs[req_id].append(top)
        hit_eos = self.eos_id is not None and token == self.eos_id
        # a stop sequence is matched on the whole output, so one that
        # spans a chunk boundary is found, and is removed from the result
        hit_stop = 0
        if not hit_eos:
            for ss in self._req_stop.get(req_id, ()):
                if len(res) >= len(ss) and res[-len(ss):] == ss:
                    hit_stop = len(ss)
                    break
        if hit_stop:
            del res[-hit_stop:]
            del self._logprobs[req_id][-hit_stop:]
            if req_id in self._toplogprobs:
                del self._toplogprobs[req_id][-hit_stop:]
        # the next decode writes at _host_lengths, which must stay in
        # the cache
        out_of_room = self._host_lengths[slot] >= self.max_len
        freed = self.scheduler.token_done(
            slot, finished=hit_eos or bool(hit_stop) or out_of_room)
        if freed:
            self._finish_reasons[req_id] = ("stop" if hit_eos or hit_stop
                                            else "length")
            self._forget(req_id)
        return freed

    def _forget(self, req_id: int) -> None:
        """Mark a request finished and drop what only a running request
        needs; its results stay until release()."""
        self._done.add(req_id)
        for d in (self._prompts, self._max_new, self._req_samp,
                  self._req_stop, self._deadlines):
            d.pop(req_id, None)
