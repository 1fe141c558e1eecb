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

The prefix cache (`prefix_cache=True`, the JAX engine's radix reuse): a
`kvcache.RadixKVCache` maps prompt prefixes, in blocks of
`prefix_block_tokens` tokens (the gcd of the buckets), to their KV. After
every prefill the prompt's block-aligned prefix is banked
(`_bank_prefix_blocks`): only blocks not cached yet are stored, each as
tensors of its own (int8 rows and f32 scales on an int8 cache), so
evicting a block frees its bytes. At admission a prompt's longest cached
prefix p is matched and clamped (`_prefix_lookup`: one tail token must
remain, and the tail must fit a bucket inside max_len); hits that share
(p, tail bucket) run as one batched continuation wave
(`_dispatch_prefill_cont_wave`: `llama.prefill_continue_hidden` over the
tails against the dequantized prefixes, K3 at q_offset p), and a long
prompt's chunked chain starts at its cached prefix. On the card a hit
attends over the int8 prefix where a cold prefill attends over fresh
K/V, so the two are close, not bit-equal, as in the JAX engine.

Speculative decoding (`speculative=k_max`, the JAX engine's prompt-lookup
drafting): a decode chunk becomes `steps` verify rounds (`_spec_body`).
Each round drafts up to kd tokens per slot by matching the slot's trailing
n-gram (`spec_ngram`) against its token history `cache["hist"]` (every
prompt and delivered token at its position, written by each prefill and
round), verifies [last ++ drafts] in one forward (`llama.verify_step`:
K1 at m = n_slots x (kd + 1), K2 or K2-paged at S_v = kd + 1) and keeps
the longest run of drafts the greedy prediction matches plus one bonus
token, so greedy output is the plain engine's. Sampled and penalized rows
draft nothing and take one token a round. kd adapts per round
(`AdaptiveDraftLen`, `spec_adaptive`): the smallest menu k (powers of two,
then k_max) covering the most optimistic drafting slot's acceptance EMA.
The verify programs are keyed (steps, span, kd, sample), captured as
graphs by `warmup()` in place of the decode menu, with the JAX fallbacks
after it: a cold key takes full span, then static k_max at full span.

Observability (the JAX engine's): `submit` counts the request and keeps
its trace id; the decode loop only bumps a `StepAggregator`; at finish
the engine observes TTFT, TPOT and queue wait into the obs/metrics.py
histograms and, for a sampled trace, records its queue, prefill and decode
spans from the timestamps it kept (`_obs_finish`); the scheduler's queue
depth and the prefix store's free blocks are gauges a scrape hook
refreshes (`_obs_publish`). `request_timing` reports the same instants
and the phase split, and `close()` frees the KV cache, the graphs and
their pool.

Tenants: a request's `tenant` name maps to a stable integer id
(`_tenant_id`, at most MAX_TENANTS names) that the scheduler's per-tenant
queues, max-min fair pop and admission caps (`set_tenant_limits`) see;
the scheduler is the C++ core (`NativeScheduler`), which raises when its
library cannot be built.

Multi-adapter LoRA serving (`adapters=`, the JAX engine's S-LoRA-style
batch): many fine-tunes of one base share the continuous batch. adapters
= {name: {"lora": {target: {"a": [L, d_in, r], "b": [L, r, d_out]}},
"alpha": float}} is stacked once on the device as [L, A + 1, ...] f32
(`_stack_adapters`): index 0 the all-zero adapter of base-only rows, b
pre-scaled by alpha / rank, names sorted from index 1 (`_adapter_idx`).
`submit(adapter=)` maps a request to its index; every prefill (the wave,
the continuation wave, each chunked link) runs its rows through their
adapters and writes each slot's index into `cache["aids"]`, which every
decode and verify program reads by address, so a captured graph serves
any mix. The radix prefix cache keys each request's prefixes by its
adapter index (a prefix computed through one adapter is wrong KV for
another). An engine without adapters runs exactly the programs it ran
before: no zero bypass, no extra launch.
"""

from __future__ import annotations

import contextlib
import functools
import gc
import math
import threading
import time
from typing import Any, Sequence

import numpy as np
import torch

from kubeflow_tpu_torch._device import resolve_device
from kubeflow_tpu_torch.kvcache import RadixKVCache
from kubeflow_tpu_torch.models import llama
from kubeflow_tpu_torch.obs import metrics as obs_metrics
from kubeflow_tpu_torch.obs.trace import TRACER, StepAggregator
from kubeflow_tpu_torch.ops import _build
from kubeflow_tpu_torch.serving.scheduler import (DecodeAction,
                                                  NativeScheduler,
                                                  PrefillAction,
                                                  PromptTooLong)

_M32 = 0xFFFFFFFF


def _to_device(tree: Any, device: torch.device) -> Any:
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device)


def _leaves(tree: Any) -> list[torch.Tensor]:
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    return [tree]


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


def _ngram_draft(hist: torch.Tensor, lengths: torch.Tensor, k: int,
                 n: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Prompt-lookup drafting over every slot at once (the JAX
    `_ngram_draft`): hist [B, L] int32 token history, real through position
    lengths[b] (the pending token, recorded just before). For each slot,
    the latest window ending at j < lengths whose n tokens equal the
    trailing n-gram hist[lengths - n + 1 .. lengths] proposes the k tokens
    after it. Returns drafts [B, k] int32 and count [B] int32, how many of
    them are known tokens: clip(lengths - j, 0, k), and 0 with no match or
    when lengths < n. A handful of [B, L] compares, with no host sync, so
    it runs inside the verify graph."""
    b, l = hist.shape
    dev = hist.device
    lengths = lengths.long()
    gram_pos = (lengths[:, None]
                + torch.arange(1 - n, 1, device=dev)[None]).clamp(0, l - 1)
    gram = hist.gather(1, gram_pos)                        # [B, n]
    m = hist[:, :l - n + 1] == gram[:, :1]
    for t in range(1, n):
        m = m & (hist[:, t:l - n + 1 + t] == gram[:, t:t + 1])
    jend = torch.arange(n - 1, l, device=dev)[None]   # each window's end
    valid = m & (jend < lengths[:, None]) & (lengths[:, None] >= n)
    j_best = torch.where(valid, jend, -1).amax(dim=1)      # -1: none
    dpos = (j_best[:, None] + 1
            + torch.arange(k, device=dev)[None]).clamp(0, l - 1)
    drafts = hist.gather(1, dpos)
    count = torch.where(j_best >= 0, (lengths - j_best).clamp(0, k), 0)
    return drafts, count.to(torch.int32)


#: EMA step of the speculative acceptance estimates: the per-slot draft
#: length policy and the tokens-per-round estimate that chunk sizing and
#: the drain guard read (the JAX engine's constant)
SPEC_EMA_ALPHA = 0.25


class AdaptiveDraftLen:
    """Per-slot EMA of accepted drafts per verify round -> the next
    round's draft length (the JAX `AdaptiveDraftLen`, host side). The menu
    is the powers of two below k_max, then k_max; a round drafts the
    smallest menu k that covers the most optimistic drafting slot's EMA
    times `headroom`, or the smallest k when no slot drafts. A round that
    accepts all its drafts observes one more (it was cut by k, not by the
    model), capped at k_max, so the estimate can climb back."""

    def __init__(self, k_max: int, n_slots: int, *,
                 alpha: float = SPEC_EMA_ALPHA, headroom: float = 1.25):
        if k_max < 1:
            raise ValueError("k_max must be >= 1")
        self.k_max = k_max
        self.alpha = alpha
        self.headroom = headroom
        menu, k = [], 1
        while k < k_max:
            menu.append(k)
            k *= 2
        menu.append(k_max)
        self.menu: list[int] = menu
        # optimistic start: one round of observations re-anchors
        self.ema = np.full(n_slots, float(k_max))

    def observe(self, slot: int, accepted: int, k_round: int) -> None:
        """One round of `slot`: `accepted` of `k_round` drafts landed."""
        obs = min(self.k_max,
                  accepted + (1 if accepted >= k_round else 0))
        self.ema[slot] += self.alpha * (obs - self.ema[slot])

    def reset_slot(self, slot: int) -> None:
        """A new request took the slot: back to optimistic."""
        self.ema[slot] = float(self.k_max)

    def pick(self, drafting_slots) -> int:
        """The draft length of a round whose drafting slots (greedy,
        penalty-free) are `drafting_slots`."""
        slots = list(drafting_slots)
        if not slots:
            return self.menu[0]
        want = max(self.ema[s] for s in slots) * self.headroom
        for k in self.menu:
            if k >= want:
                return k
        return self.k_max


_gc_lock = threading.Lock()
_gc_pause = {"depth": 0, "was_enabled": True}


@contextlib.contextmanager
def gc_paused():
    """Python's cyclic collector off for the block, on every thread, and
    back to its setting when the last of overlapping blocks ends. A
    collection inside a graph capture can free a dead engine's CUDA
    graphs, and destroying a graph while a stream captures invalidates
    the capture (torch.cuda.graph no longer collects on entry)."""
    with _gc_lock:
        if _gc_pause["depth"] == 0:
            _gc_pause["was_enabled"] = gc.isenabled()
            gc.disable()
        _gc_pause["depth"] += 1
    try:
        yield
    finally:
        with _gc_lock:
            _gc_pause["depth"] -= 1
            if _gc_pause["depth"] == 0 and _gc_pause["was_enabled"]:
                gc.enable()


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
    #: continuation waves write the prefix rows into the slot (slab); the
    #: paged engine splices the cached blocks into the table instead
    _cont_writes_prefix = True
    #: the obs component label and the name of the engine's spans
    role = "engine"
    #: the KV residency: slab rows per slot ("paged": a block pool)
    kv_layout = "slab"
    #: whether the engine decodes: warmup() captures the decode menu only
    #: then (a prefill role's requests end at their first token)
    _decodes = True

    def __init__(self, params, cfg: llama.LlamaConfig, *, n_slots: int = 4,
                 max_len: int = 512, buckets: Sequence[int] = (64, 128, 256),
                 eos_id: int | None = None, decode_chunk: int = 8,
                 sample_seed: int = 0, quantize: str | None = None,
                 kv_quantize: str | None = None, logprobs_topk: int = 0,
                 pipeline_decode: bool = True, prefix_cache: bool = False,
                 max_prefixes: int = 4,
                 prefix_cache_blocks: int | None = None,
                 speculative: int | None = None, spec_ngram: int = 3,
                 spec_adaptive: bool = True,
                 adapters: dict[str, dict[str, Any]] | None = None,
                 device="cuda"):
        if max(buckets) >= max_len:
            raise ValueError("largest bucket must leave room to decode")
        if quantize not in (None, "int8"):
            raise ValueError(f"unknown quantize mode {quantize!r}")
        if kv_quantize not in (None, "int8"):
            raise ValueError(f"unknown kv_quantize mode {kv_quantize!r}")
        if speculative is not None and not 1 <= speculative <= 16:
            raise ValueError("speculative must be 1..16 draft tokens")
        if not 1 <= spec_ngram <= 8:
            raise ValueError("spec_ngram must be 1..8")
        if not 0 <= logprobs_topk <= 16:
            raise ValueError("logprobs_topk must be 0..16")
        self.device = resolve_device(device)
        if self.device.type == "cuda" and cfg.dtype != torch.bfloat16:
            raise ValueError("the CUDA kernels run bfloat16 models")
        self.params = self._place_params(params, quantize)
        self.cfg = cfg
        self.kv_quantize = kv_quantize
        self.logprobs_topk = logprobs_topk
        self.pipeline_decode = pipeline_decode
        self.n_slots = n_slots
        self.max_len = max_len
        self.buckets = tuple(sorted(buckets))
        self.eos_id = eos_id
        self.decode_chunk = max(1, decode_chunk)
        # set_decode_chunk's ceiling once warmup() has captured the menu
        self._decode_chunk_warm = self.decode_chunk
        self.scheduler = NativeScheduler(n_slots, self.buckets)
        # -- speculative decoding (module docstring): the draft length
        # k_max, the n-gram size, the delivered tokens and verify rounds,
        # the adaptive draft length (off, or k_max 1: static k) and the
        # EMA of tokens per round
        self.spec = speculative
        self.spec_ngram = spec_ngram
        self._spec_tokens = 0
        self._spec_verifies = 0
        self.spec_adaptive = bool(spec_adaptive and speculative
                                  and speculative > 1)
        self._spec_adapt = (AdaptiveDraftLen(speculative, n_slots)
                            if self.spec_adaptive else None)
        self._spec_last_k = speculative or 0
        self._spec_round_ema: float | None = None
        # -- the radix prefix cache (module docstring); the store holds
        # max_prefixes largest-bucket prefixes' worth of blocks unless
        # prefix_cache_blocks says otherwise
        self.prefix_cache_enabled = bool(prefix_cache)
        self.max_prefixes = max_prefixes
        self.prefix_block_tokens = 0
        self.kvcache: RadixKVCache | None = None
        if prefix_cache:
            bt = math.gcd(*self.buckets)
            self.prefix_block_tokens = bt
            if prefix_cache_blocks is None:
                prefix_cache_blocks = (max(1, max_prefixes)
                                       * (self.buckets[-1] // bt))
            self.kvcache = RadixKVCache(bt, prefix_cache_blocks)
        self._prefix_hits = 0
        self._prefix_misses = 0
        # request -> reused prefix length (cached_tokens), until release
        self._cached_prefix: dict[int, int] = {}
        # prefill tokens computed and reused, counted with or without the
        # cache
        self._prefill_computed_tokens = 0
        self._prefill_reused_tokens = 0
        dev = self.device
        # -- multi-adapter serving (module docstring): the device stack,
        # name -> index, and each request's index while it runs
        self.adapters = (self._stack_adapters(adapters) if adapters
                         else None)
        self._adapter_idx: dict[str, int] = (
            {n: i + 1 for i, n in enumerate(sorted(adapters))}
            if adapters else {})
        self._req_aids: dict[int, int] = {}
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
        self._hist_pos = torch.arange(max_len, device=dev)[None]
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
        # the program families (kind, kd, sample) whose body has run once
        # before a capture (_capture)
        self._first_use_done: set[tuple] = set()
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
        # tenant name -> the scheduler's integer id (_tenant_id)
        self._tenant_idx: dict[str, int] = {}
        self._req_tenant: dict[int, str] = {}
        self._max_new: dict[int, int] = {}
        self._results: dict[int, list[int]] = {}
        self._logprobs: dict[int, list[float]] = {}
        self._toplogprobs: dict[int, list[dict[int, float]]] = {}
        self._finish_reasons: dict[int, str] = {}
        self._submit_t: dict[int, float] = {}
        self._prefill_start_t: dict[int, float] = {}
        self._first_token_t: dict[int, float] = {}
        self._finish_t: dict[int, float] = {}
        self._req_plen: dict[int, int] = {}
        self._done: set[int] = set()
        self._cancel_pending: list[int] = []
        self._deadlines: dict[int, float] = {}
        # host-side decode counters (perf_counters), the JAX engine's keys
        self._perf = {"dispatch_s": 0.0, "fetch_replay_s": 0.0,
                      "decode_chunks": 0, "decode_steps": 0,
                      "active_uploads": 0}
        # -- observability (module docstring): trace ids, the decode
        # loop's counters and their snapshot at each traced request's
        # first token, and the scrape hook (weakref-held)
        self._req_trace: dict[int, str] = {}
        self._decode_agg = StepAggregator()
        self._decode_mark: dict[int, tuple[int, int]] = {}
        obs_metrics.add_scrape_hook(self, LLMEngine._obs_publish)

    def _place_params(self, params, quantize: str | None):
        """The params on the engine's device, int8-quantized when asked
        (leaves already on it and already quantized are kept as they
        are)."""
        params = _to_device(params, self.device)
        return (llama.quantize_params(params) if quantize == "int8"
                else params)

    def _stack_adapters(self, adapters: dict[str, dict]) -> dict:
        """{name: {"lora": {t: {"a", "b"}}, "alpha": f}} -> the device
        stack {t: {"a": [L, A + 1, d_in, r], "b": [L, A + 1, r, d_out]}}
        in f32, index 0 all zeros, b times alpha / rank. Every adapter
        has the same rank and targets (one gather shape for all)."""
        names = sorted(adapters)
        first = adapters[names[0]]["lora"]
        targets = sorted(first)
        bad = set(targets) - set(llama.QUANT_LEAVES)
        if bad:
            raise ValueError(f"unknown adapter targets {sorted(bad)}; "
                             f"known: {sorted(llama.QUANT_LEAVES)}")
        rank = first[targets[0]]["a"].shape[-1]

        def f32(x) -> torch.Tensor:
            if isinstance(x, torch.Tensor):
                return x.detach().to(self.device, torch.float32)
            return torch.from_numpy(np.asarray(x, np.float32)).to(
                self.device)

        stack = {}
        for t in targets:
            a_rows, b_rows = [], []
            for n in names:
                tree = adapters[n]["lora"]
                if sorted(tree) != targets:
                    raise ValueError(
                        f"adapter {n!r} targets {sorted(tree)} != {targets}")
                a, b = tree[t]["a"], tree[t]["b"]
                if a.shape[-1] != rank:
                    raise ValueError(
                        f"adapter {n!r} rank {a.shape[-1]} != {rank}; "
                        "all adapters in one engine share a rank")
                scale = float(adapters[n].get("alpha", rank)) / rank
                a_rows.append(f32(a))
                b_rows.append(f32(b) * scale)
            stack[t] = {
                "a": torch.stack([torch.zeros_like(a_rows[0])] + a_rows,
                                 dim=1),
                "b": torch.stack([torch.zeros_like(b_rows[0])] + b_rows,
                                 dim=1)}
        return stack

    def _lora_kw(self, ids: torch.Tensor | None) -> dict[str, Any]:
        """The model functions' adapter arguments: none without adapters
        (the base programs), else the stack and each row's index."""
        if self.adapters is None:
            return {}
        return {"lora": self.adapters, "ids": ids}

    def _wave_ids(self, wave) -> torch.Tensor | None:
        """The adapter index of each request of a prefill wave, on the
        device (None without adapters)."""
        if self.adapters is None:
            return None
        return torch.tensor([self._req_aids.get(a.req_id, 0) for a in wave],
                            dtype=torch.long, device=self.device)

    def _ns(self, req_id: int) -> int:
        """The radix namespace of a request: its adapter index (0 for the
        base)."""
        return self._req_aids.get(req_id, 0)

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

    def _validate_submit(self, prompt, temperature, adapter, top_k, top_p,
                         presence_penalty, frequency_penalty, seed, stop,
                         deadline_s, max_new_tokens, tenant=None):
        """Every submit()-time check, with the JAX engine's messages.
        Returns the normalized (temperature, top_k, top_p, presence,
        frequency, folded seed, stop sequences, adapter index)."""
        if tenant is not None and (not isinstance(tenant, str)
                                   or not 1 <= len(tenant) <= 256):
            raise ValueError("tenant must be a string of 1..256 chars")
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
        aid = 0
        if adapter is not None:
            if adapter not in self._adapter_idx:
                raise ValueError(
                    f"unknown adapter {adapter!r}; "
                    f"loaded: {sorted(self._adapter_idx)}")
            aid = self._adapter_idx[adapter]
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if any(not 0 <= int(t) < self.cfg.vocab_size for t in prompt):
            raise ValueError("prompt token outside the vocabulary")
        if len(prompt) > self.buckets[-1]:
            # chunked prefill: the chain is checked now, not mid-serve
            self._chunk_plan(len(prompt))
        return (temperature, top_k, top_p, presence_penalty,
                frequency_penalty, seed, stop_seqs, aid)

    def submit(self, prompt: Sequence[int], max_new_tokens: int = 32,
               temperature: float = 0.0, adapter: str | None = None,
               top_k: int = 0, top_p: float = 1.0,
               presence_penalty: float = 0.0,
               frequency_penalty: float = 0.0, seed: int | None = None,
               stop: Sequence[Sequence[int]] | None = None,
               deadline_s: float | None = None,
               tenant: str | None = None, trace: str | None = None) -> int:
        """Queue one request. A prompt longer than the largest bucket is
        chunked; PromptTooLong when it is empty or its chain cannot fit
        max_len, QueueFull when the queue is full (TenantOverQuota when
        the tenant's queue is at its cap), ValueError for bad arguments.
        Penalties (OpenAI [-2, 2]) edit the logits of the request's
        generated tokens, greedy rows included; `seed` makes its
        draws depend on (seed, position) alone; `stop`: token sequences
        that end the request (finish reason "stop") and are removed from
        the result; `deadline_s`: past it the request is cancelled at the
        next step; `tenant`: the name whose scheduler queue, fair share
        and admission caps the request rides (None: the anonymous tenant
        0), and under which the prefix cache's per-tenant rows count it;
        `trace`: its trace id (obs/trace.py), under which its spans are
        recorded at finish when sampled; `adapter`: the name of a loaded
        adapter the request runs through (None: the base)."""
        try:
            (temperature, top_k, top_p, presence_penalty, frequency_penalty,
             seed, stop_seqs, aid) = self._validate_submit(
                prompt, temperature, adapter, top_k, top_p, presence_penalty,
                frequency_penalty, seed, stop, deadline_s, max_new_tokens,
                tenant)
        except PromptTooLong:
            if len(prompt) > self.buckets[-1]:
                # the scheduler's rejected counter (the operator metric)
                # counts it too; the chunk plan's message is the one raised
                with self._submit_lock:
                    try:
                        self.scheduler.submit(len(prompt), max_new_tokens,
                                              time.monotonic(),
                                              tenant=self._tenant_id(tenant))
                    except PromptTooLong:
                        pass
            raise
        # the scheduler sees the largest bucket for a chunked prompt: it
        # only picks the bucket; the engine keeps the true length
        sched_len = min(len(prompt), self.buckets[-1])
        with self._submit_lock:
            rid = self.scheduler.submit(sched_len, max_new_tokens,
                                        time.monotonic(),
                                        tenant=self._tenant_id(tenant))
            self._prompts[rid] = [int(t) for t in prompt]
            self._req_samp[rid] = self._samp_row(
                temperature, top_k, top_p, presence_penalty,
                frequency_penalty, seed)
            if stop_seqs:
                self._req_stop[rid] = stop_seqs
            if deadline_s is not None:
                self._deadlines[rid] = time.monotonic() + deadline_s
            if tenant is not None:
                self._req_tenant[rid] = tenant
            if aid:
                self._req_aids[rid] = aid
            self._max_new[rid] = max_new_tokens
            self._results[rid] = []
            self._logprobs[rid] = []
            if self.logprobs_topk:
                self._toplogprobs[rid] = []
            self._req_plen[rid] = len(prompt)
            self._submit_t[rid] = time.monotonic()
            if trace is not None:
                self._req_trace[rid] = trace
        obs_metrics.REQUESTS.inc(component=self.role, event="submitted")
        return rid

    #: bound on the distinct tenant names one engine tracks: the OpenAI
    #: `user` field is the client's to choose, so past the cap new names
    #: share the anonymous tenant-0 queue instead of growing the map
    MAX_TENANTS = 65536

    def _tenant_id(self, tenant: str | None) -> int:
        """Tenant name -> stable scheduler id. Called under _submit_lock:
        the id is the map's length, so minting it must be atomic with the
        insert, or two first requests of distinct tenants could share an
        id and so a queue and its caps."""
        if tenant is None:
            return 0
        tid = self._tenant_idx.get(tenant)
        if tid is not None:
            return tid
        if len(self._tenant_idx) >= self.MAX_TENANTS:
            return 0
        tid = len(self._tenant_idx) + 1
        self._tenant_idx[tenant] = tid
        return tid

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
        t_prefill = time.monotonic()
        for a in actions:
            # the request left the queue now (a held paged prefill keeps
            # its first pop)
            self._prefill_start_t.setdefault(a.req_id, t_prefill)
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
        """One batched prefill per prompt bucket, one continuation wave
        per (cached prefix, tail bucket) of prefix-cache hits and one
        chained prefill per chunked prompt, all dispatched before any
        token is fetched; then the hits are counted and unpinned, and
        every dispatched prompt's prefix is banked."""
        chunked: list[PrefillAction] = []
        short: list[PrefillAction] = []
        for a in actions:
            (chunked if len(self._prompts[a.req_id]) > a.bucket_len
             else short).append(a)
        cont: list[tuple] = []       # (action, match, p, t)
        normal = short
        if self.prefix_cache_enabled:
            normal = []
            for a in short:
                hit = self._prefix_lookup(a)
                (cont.append((a,) + hit) if hit is not None
                 else normal.append(a))
        groups: dict[int, list[PrefillAction]] = {}
        for a in normal:
            groups.setdefault(a.bucket_len, []).append(a)
        bt = self.prefix_block_tokens
        cont_groups: dict[tuple[int, int], list] = {}
        for a, m, p, t in cont:
            # the chain truncated to p when the clamp shortened it; the
            # pin holds the blocks until after the dispatch
            cont_groups.setdefault((p, t), []).append(
                (a, m.payloads[:p // bt]))
        dispatched = [(wave, self._dispatch_prefill_wave(bucket, wave))
                      for bucket, wave in groups.items()]
        dispatched += [([a for a, _ in pairs],
                        self._dispatch_prefill_cont_wave(p, t, pairs))
                       for (p, t), pairs in cont_groups.items()]
        dispatched += [([a], self._dispatch_chunked_prefill(a))
                       for a in chunked]
        for a, m, p, _ in cont:
            self._prefix_hits += 1
            self._cached_prefix[a.req_id] = p
            self.kvcache.record_hit(self._req_tenant.get(a.req_id), p)
            self._prefill_reused_tokens += p
            self._prefill_computed_tokens += len(self._prompts[a.req_id]) - p
            self.kvcache.release(m)
        if self.prefix_cache_enabled:
            # before the fetch: the last token of a request pops its
            # prompt, and the rows only need the prefill dispatched
            for wave, _ in dispatched:
                for a in wave:
                    self._bank_prefix_blocks(a)
        for wave, out in dispatched:
            out_np = out.cpu().numpy()    # one fetch per wave
            for i, a in enumerate(wave):
                self._host_lengths[a.slot] = len(self._prompts[a.req_id])
                if self._spec_adapt is not None:
                    # a new occupant drafts optimistically until its own
                    # rounds re-anchor the slot's estimate
                    self._spec_adapt.reset_slot(a.slot)
                tok, lp, top = self._unpack_out(out_np[i])
                self._record_token(a.req_id, a.slot, tok, lp, top,
                                   first_token=True)

    def run_until_idle(self) -> None:
        while self.step():
            pass

    def generate(self, prompt: Sequence[int], max_new_tokens: int = 32,
                 temperature: float = 0.0, adapter: str | None = None,
                 **kw) -> list[int]:
        rid = self.submit(prompt, max_new_tokens, temperature,
                          adapter=adapter, **kw)
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
                  self._first_token_t, self._req_tenant,
                  self._cached_prefix, self._prefill_start_t,
                  self._finish_t, self._req_plen, self._req_trace,
                  self._decode_mark):
            d.pop(req_id, None)

    def cached_tokens(self, req_id: int) -> int:
        """Prompt tokens whose KV came from the prefix cache for this
        request (the OpenAI usage `cached_tokens`): 0 before its prefill,
        on a miss and with the cache off."""
        return self._cached_prefix.get(req_id, 0)

    def request_timing(self, req_id: int) -> dict[str, Any]:
        """One request's wall-clock record (the JAX `request_timing`):
        submit, first-token and finish instants (time.monotonic; None
        until they happen), tenant, tokens so far, prompt_len,
        cached_prefix_len and prefill_tokens, and the phase split:
        queue_wait_ms (submit to the prefill leaving the queue),
        prefill_ms (to the first token) and decode_ms (to the finish),
        each None until its boundary lands. Read before release()."""
        plen = self._req_plen.get(req_id)
        cached = self._cached_prefix.get(req_id, 0)
        sub = self._submit_t.get(req_id)
        pstart = self._prefill_start_t.get(req_id)
        first = self._first_token_t.get(req_id)
        fin = self._finish_t.get(req_id)

        def ms(a, b):
            return (round((b - a) * 1e3, 3)
                    if a is not None and b is not None else None)

        return {"submit_s": sub, "first_token_s": first, "finish_s": fin,
                "tenant": self._req_tenant.get(req_id),
                "n_tokens": len(self._results.get(req_id, ())),
                "prompt_len": plen, "cached_prefix_len": cached,
                "prefill_tokens": (plen - cached if plen is not None
                                   else None),
                "queue_wait_ms": ms(sub, pstart),
                "prefill_ms": ms(pstart, first),
                "decode_ms": ms(first, fin)}

    def set_tenant_limits(self, max_active_per_tenant: int = 0,
                          max_queued_per_tenant: int = 0) -> None:
        """Per-tenant knobs, forwarded to the scheduler: a soft,
        work-conserving share cap on decode slots and a hard admission
        cap on queued requests (past it submit raises TenantOverQuota).
        0 turns either off."""
        self.scheduler.set_fairness(max_active_per_tenant,
                                    max_queued_per_tenant)

    @property
    def decode_chunk_max(self) -> int:
        """The largest decode chunk set_decode_chunk may pick: after
        warmup() the largest captured chunk, so live traffic never
        captures."""
        return self._decode_chunk_warm

    def set_decode_chunk(self, chunk: int) -> int:
        """Re-pick the decode chunk length (the JAX SLO controller's
        surface), applied at the next chunk; after warmup() clamped to
        the captured menu. Returns the value applied."""
        chunk = max(1, int(chunk))
        if self._warmed:
            chunk = min(chunk, self._decode_chunk_warm)
        self.decode_chunk = chunk
        return chunk

    def mesh_info(self) -> dict[str, Any]:
        """The /healthz `mesh` section for the one layout the port has:
        one device, and the params' bytes."""
        leaves = [] if self.params is None else _leaves(self.params)
        return {"layout": "single", "axes": {}, "device_count": 1,
                "params_bytes": int(sum(t.nbytes for t in leaves))}

    def close(self) -> None:
        """Free the device state now: the captured graphs and their pool,
        the KV cache, the prefix store's blocks, the slot state and this
        engine's reference to the params (the caller's own reference
        keeps them). The graphs reference the engine, so `del engine`
        alone would leave all of it to a full gc pass; a restarted
        engine then fits where this one was. The engine is unusable
        after."""
        if self.device.type == "cuda":
            # a pipelined chunk may still run: let it finish before its
            # buffers and graphs go
            torch.cuda.synchronize(self.device)
        self._programs.clear()
        self._pending = None
        self.kvcache = None
        self._host_out = []
        obs_metrics.remove_scrape_hooks(self)
        for name, value in list(vars(self).items()):
            if isinstance(value, torch.Tensor) or name in (
                    "cache", "params", "_graph_pool"):
                setattr(self, name, None)
        gc.collect()

    def _obs_publish(self) -> None:
        """Scrape hook: refresh this engine's queue-depth gauges, the
        attention path it runs and the prefix store's free blocks."""
        s = self.scheduler.stats()
        obs_metrics.SCHED_QUEUED.set(s.queued, engine=self.role)
        obs_metrics.SCHED_ACTIVE.set(s.active, engine=self.role)
        obs_metrics.INFLIGHT.set(s.queued + s.active, component=self.role)
        # the hand-written kernels on the card, their plain versions on
        # the CPU
        impl = "flash" if self.device.type == "cuda" else "plain"
        for phase in ("decode", "prefill"):
            obs_metrics.ATTENTION_IMPL.set(1, engine=self.role, phase=phase,
                                           impl=impl)
        if self.kvcache is not None:
            st = self.kvcache.stats()
            obs_metrics.KV_FREE_BLOCKS.set(st["free_blocks"],
                                           engine=self.role)
            obs_metrics.KV_WATERMARK_FRAC.set(st["watermark_frac"],
                                              engine=self.role)

    def _obs_finish(self, req_id: int) -> None:
        """A finished request's telemetry, once: the lifecycle counter,
        the TTFT, TPOT and queue-wait histograms and, for a sampled trace,
        its queue, prefill and decode spans from the kept timestamps."""
        reason = self._finish_reasons.get(req_id, "length")
        obs_metrics.REQUESTS.inc(component=self.role, event=reason)
        sub = self._submit_t.get(req_id)
        pstart = self._prefill_start_t.get(req_id)
        first = self._first_token_t.get(req_id)
        fin = self._finish_t.get(req_id)
        n_tok = len(self._results.get(req_id, ()))
        if sub is not None and first is not None:
            obs_metrics.TTFT_SECONDS.observe(first - sub,
                                             component=self.role)
        if sub is not None and pstart is not None:
            obs_metrics.QUEUE_WAIT_SECONDS.observe(pstart - sub,
                                                   component=self.role)
        if first is not None and fin is not None and n_tok >= 2:
            obs_metrics.TPOT_SECONDS.observe((fin - first) / (n_tok - 1),
                                             component=self.role)
        trace = self._req_trace.pop(req_id, None)
        mark = self._decode_mark.pop(req_id, None)
        if trace is None or not TRACER.sampled(trace):
            return
        tenant = self._req_tenant.get(req_id)
        TRACER.record_span(f"{self.role}.queue", "queue", trace, sub,
                           pstart, tenant=tenant)
        TRACER.record_span(f"{self.role}.prefill", "prefill", trace,
                           pstart, first, prompt_len=self._req_plen.get(
                               req_id),
                           cached_prefix_len=self._cached_prefix.get(
                               req_id, 0))
        attrs: dict[str, Any] = {"n_tokens": n_tok, "finish_reason": reason,
                                 "tenant": tenant}
        if mark is not None:
            attrs.update(StepAggregator.window(
                mark, self._decode_agg.snapshot()))
        TRACER.record_span(f"{self.role}.decode", "decode", trace, first,
                           fin, **attrs)

    def metrics(self) -> dict[str, Any]:
        """The scheduler, prefill, prefix-cache and speculation counters
        under the JAX engine's keys: the scheduler's queued, active,
        completed and rejected requests and prefill_tokens_computed
        always, tenants_seen once a tenant has submitted; with the cache,
        the hit and miss counts, the stored blocks and `prefix_cache` (the
        radix stats with the per-request rates and the tokens saved); with
        speculation, the verify rounds, the delivered tokens and their
        ratio, k_max, the tokens-per-round estimate and, when adaptive,
        the last draft length and the mean acceptance EMA."""
        s = self.scheduler.stats()
        out: dict[str, Any] = {
            "queued": s.queued, "active": s.active,
            "completed": s.completed, "rejected": s.rejected,
            "prefill_tokens_computed": self._prefill_computed_tokens}
        if self._tenant_idx:
            out["tenants_seen"] = len(self._tenant_idx)
        if self.adapters is not None:
            out["adapters_loaded"] = sorted(self._adapter_idx)
        if self.kvcache is not None:
            st = self.kvcache.stats()
            looked = self._prefix_hits + self._prefix_misses
            out["prefix_hits"] = self._prefix_hits
            out["prefix_misses"] = self._prefix_misses
            out["prefix_entries"] = st["blocks"]
            out["prefix_cache"] = {
                **st,
                "request_hits": self._prefix_hits,
                "request_misses": self._prefix_misses,
                "request_hit_rate": (round(self._prefix_hits / looked, 4)
                                     if looked else None),
                "prefill_tokens_computed": self._prefill_computed_tokens,
                "prefill_tokens_saved": self._prefill_reused_tokens,
            }
        if self.spec:
            out["spec_verify_rounds"] = self._spec_verifies
            out["spec_tokens_emitted"] = self._spec_tokens
            # 1.0: no draft accepted; k_max + 1: every draft accepted
            out["spec_tokens_per_round"] = round(
                self._spec_tokens / max(1, self._spec_verifies), 3)
            out["spec_draft_k_max"] = self.spec
            out["spec_est_round_tokens"] = round(self._est_round_tokens(), 3)
            if self._spec_adapt is not None:
                out["spec_draft_k_last"] = self._spec_last_k
                out["spec_accept_ema"] = round(
                    float(np.mean(self._spec_adapt.ema)), 3)
        return out

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
        self._prefill_computed_tokens += sum(plens)
        tokens = tokens.to(dev)
        x = self._prefill_rows(tokens, [a.slot for a in wave], 0,
                               ids=self._wave_ids(wave))
        for i, a in enumerate(wave):
            self._hist_write(a.slot, 0, tokens[i])
        rows = torch.arange(len(wave), device=dev)
        last = x[rows, torch.tensor(plens, device=dev) - 1]
        return self._prefill_finish(last, wave, plens)

    def _dispatch_prefill_cont_wave(self, p: int, t: int,
                                    pairs: list[tuple]) -> torch.Tensor:
        """One batched continuation prefill of every prefix-cache hit that
        shares (cached prefix p, tail bucket t): the tails (prompt[p:],
        right-padded to t) run `llama.prefill_continue_hidden` against the
        matched prefixes [L, W, p, kv, hd] (K3 at B=W, S=t, q_offset=p);
        each slot gets the prefix rows (`_cont_writes_prefix`) and its
        tail's rows, and its first token from its last prompt row. pairs:
        (action, the matched chain's block payloads). Returns the packed
        rows [W, cols] on the device, not fetched."""
        dev = self.device
        wave = [a for a, _ in pairs]
        tokens = torch.zeros((len(wave), t), dtype=torch.long)
        plens = []
        for i, a in enumerate(wave):
            tail = self._prompts[a.req_id][p:]
            tokens[i, :len(tail)] = torch.tensor(tail)
            plens.append(p + len(tail))
        k_prefix, v_prefix = self._stack_prefix(
            [self._materialize_prefix(payloads) for _, payloads in pairs])
        tokens = tokens.to(dev)
        x = self._prefill_rows(tokens, [a.slot for a in wave], p,
                               (k_prefix, v_prefix), self._cont_writes_prefix,
                               ids=self._wave_ids(wave))
        for i, a in enumerate(wave):
            # the history gets the prefix tokens too: the KV alone cannot
            # give them to the drafter
            self._hist_write(a.slot, 0, self._prompts[a.req_id][:p])
            self._hist_write(a.slot, p, tokens[i])
        rows = torch.arange(len(wave), device=dev)
        last = x[rows, torch.tensor(plens, device=dev) - p - 1]
        return self._prefill_finish(last, wave, plens)

    def _dispatch_chunked_prefill(self, action: PrefillAction
                                  ) -> torch.Tensor:
        """Chained prefill of a prompt longer than the largest bucket: the
        first chunk is an ordinary bucket prefill, each further chunk runs
        `llama.prefill_continue_hidden` against the slot's own first rows
        (`_extract_prefix`, dequantized to the model dtype) and writes its
        rows after them. With the prefix cache the chain starts at the
        longest cached prefix whose remaining chain fits max_len: the
        first link continues from the matched blocks, written into the
        slot first (`_cont_writes_prefix`). Returns the packed row
        [1, cols]."""
        dev = self.device
        prompt = self._prompts[action.req_id]
        n, slot, big = len(prompt), action.slot, self.buckets[-1]
        bt = self.prefix_block_tokens
        ids = self._wave_ids([action])
        done, pending = 0, None
        if self.prefix_cache_enabled and n - 1 >= bt:
            tenant = self._req_tenant.get(action.req_id)
            m = self.kvcache.match(prompt, max_tokens=n - 1,
                                   namespace=self._ns(action.req_id))
            done = m.tokens
            while done > 0 and self._chunk_plan_from(n, done) is None:
                done -= bt
            if done > 0:
                pending = self._materialize_prefix(m.payloads[:done // bt])
                self._prefix_hits += 1
                self._cached_prefix[action.req_id] = done
                self.kvcache.record_hit(tenant, done)
                self._prefill_reused_tokens += done
            else:
                self.kvcache.record_miss(tenant)
                self._prefix_misses += 1
            self.kvcache.release(m)
        self._prefill_computed_tokens += n - done
        if done == 0:
            head = torch.tensor([prompt[:big]], device=dev)
            self._prefill_rows(head, [slot], 0, ids=ids)
            self._hist_write(slot, 0, head[0])
            done = big
        last = None
        for chunk_len, t in self._chunk_plan_from(n, done):
            # the first link after a cache hit writes the matched prefix
            # into the slot; later links read the slot's own rows
            from_store = pending is not None
            if from_store:
                prefix, pending = pending, None
                self._hist_write(slot, 0, prompt[:done])
            else:
                prefix = self._extract_prefix(slot, done)
            tail = torch.zeros((1, t), dtype=torch.long)
            tail[0, :chunk_len] = torch.tensor(prompt[done:done + chunk_len])
            tail = tail.to(dev)
            x = self._prefill_rows(
                tail, [slot], done, prefix,
                from_store and self._cont_writes_prefix, ids=ids)
            self._hist_write(slot, done, tail[0])
            last = x[:, chunk_len - 1]
            done += chunk_len
        return self._prefill_finish(last, [action], [n])

    def _prefill_rows(self, tokens: torch.Tensor, slots: list[int],
                      start: int, prefix: tuple | None = None,
                      write_prefix: bool = False,
                      ids: torch.Tensor | None = None) -> torch.Tensor:
        """The model over prompt rows: tokens [B, T] at positions start ..
        start + T - 1 of slots[b], against the prefix KV (k, v)
        [L, B, start, kv, hd] (None at start 0). Writes each row's T new KV
        rows into its slot, and the prefix rows first when `write_prefix`.
        Returns x [B, T, D] before the final norm."""
        lora_kw = self._lora_kw(ids)
        if prefix is None:
            x, (ks, vs) = llama.prefill_hidden(self.params, tokens, self.cfg,
                                               **lora_kw)
        else:
            x, ks, vs = llama.prefill_continue_hidden(
                self.params, tokens, *prefix, self.cfg, **lora_kw)
        for i, slot in enumerate(slots):
            if write_prefix:
                self._cache_write(slot, 0, start, prefix[0][:, i],
                                  prefix[1][:, i])
            self._cache_write(slot, start, tokens.shape[1], ks[:, i],
                              vs[:, i])
        return x

    def _lm_head(self, x: torch.Tensor) -> torch.Tensor:
        """final_norm and the lm_head over x [B, S, D]: f32 logits."""
        return llama.lm_head(self.params, x, self.cfg)

    def _prefill_finish(self, last: torch.Tensor, wave: list[PrefillAction],
                        plens: list[int]) -> torch.Tensor:
        """The end of every prefill: the last prompt rows' logits, each
        slot's length, sampling row, adapter index, first token and
        penalty counts (reset to that token's one-hot: penalties count
        generated tokens, and the first one is generated here). Returns
        the packed rows."""
        dev = self.device
        logits = self._lm_head(last[:, None])[:, 0]
        slot_list = [a.slot for a in wave]
        for a in wave:
            self._samp_host[a.slot] = self._req_samp[a.req_id]
        self._upload(self.samp, self._samp_host)
        slots = torch.tensor(slot_list, device=dev)
        plens_dev = torch.tensor(plens, dtype=torch.int32, device=dev)
        self.lengths[slots] = plens_dev
        if self.adapters is not None:
            self.cache["aids"][slots] = self._wave_ids(wave)
        toks = self._choose(logits, self.samp[slots], slots, None, plens_dev,
                            bool((self._samp_host[slot_list, 0] > 0).any()))
        self.last_tokens[slots] = toks
        self._cnt[slots] = 0
        self._cnt[slots, toks] = 1
        return self._pack_out(toks, logits)

    def _alloc_cache(self) -> dict:
        """The KV cache: a slab [L, n_slots, max_len, kv, hd] and the
        per-slot buffers (`_slot_buffers`)."""
        return self._slot_buffers(llama.init_cache(
            self.cfg, self.n_slots, self.max_len, self.kv_quantize,
            device=self.device))

    def _slot_buffers(self, cache: dict) -> dict:
        """Adds to `cache` the per-slot state the programs read beside the
        KV: with speculation the token history (`_alloc_hist`), with
        adapters each slot's adapter index "aids" [n_slots] (the JAX
        cache's), 0 (the base) until a prefill writes it."""
        if self.spec:
            cache["hist"] = self._alloc_hist()
        if self.adapters is not None:
            cache["aids"] = torch.zeros(self.n_slots, dtype=torch.long,
                                        device=self.device)
        return cache

    def _alloc_hist(self) -> torch.Tensor:
        """The token history [n_slots, max_len] int32 that the drafter
        reads: each slot's prompt and delivered tokens at their positions,
        mirrored from every prefill and verify round (the JAX engine's
        `hist`). Past a slot's length it holds stale tokens the drafter
        masks."""
        return torch.zeros((self.n_slots, self.max_len), dtype=torch.int32,
                           device=self.device)

    def _hist_write(self, slot: int, start: int, tokens) -> None:
        """With speculation, tokens (a device tensor or a list) into the
        slot's history from position `start`; a no-op without."""
        if not self.spec or len(tokens) == 0:
            return
        if not isinstance(tokens, torch.Tensor):
            tokens = torch.tensor(tokens, device=self.device)
        self.cache["hist"][slot, start:start + len(tokens)] = tokens

    def _cache_write(self, slot: int, start: int, count: int,
                     ks: torch.Tensor, vs: torch.Tensor, *,
                     cache: dict | None = None) -> None:
        """Write [L, count, kv, hd] KV rows into rows [start, start +
        count) of a slot of `cache` (the engine's slab by default),
        quantizing when the cache is int8."""
        c = self.cache if cache is None else cache
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

    def _extract_prefix(self, slot: int, p: int, *, cache: dict | None = None
                        ) -> tuple[torch.Tensor, torch.Tensor]:
        """A slot's first p KV rows of `cache` (the engine's slab by
        default) as [L, 1, p, kv, hd] in the model dtype (dequantized from
        int8): the chunked chain's prefix. The JAX slab engine also writes
        these rows back; re-quantizing dequantized int8 rows gives the
        same bytes, so the port leaves them."""
        c = self.cache if cache is None else cache
        k = c["k"][:, slot, :p][:, None]
        v = c["v"][:, slot, :p][:, None]
        if self.kv_quantize == "int8":
            k = llama.dequantize_kv(k, c["k_s"][:, slot, :p][:, None],
                                    self.cfg.dtype)
            v = llama.dequantize_kv(v, c["v_s"][:, slot, :p][:, None],
                                    self.cfg.dtype)
        return k.to(self.cfg.dtype), v.to(self.cfg.dtype)

    # -- the prefix cache ----------------------------------------------------

    def _prefix_lookup(self, action: PrefillAction):
        """(match, p, t) when the prompt's longest cached chain gives a
        legal continuation: one tail token at least, the tail in a bucket
        t with p + t <= max_len (p shrunk block by block until it fits).
        None on a miss, or for a prompt too short to hold one block
        (neither a hit nor a miss). The match returned is pinned until
        the caller releases it after the dispatch."""
        prompt = self._prompts[action.req_id]
        bt = self.prefix_block_tokens
        if len(prompt) - 1 < bt:
            return None
        tenant = self._req_tenant.get(action.req_id)
        m = self.kvcache.match(prompt, max_tokens=len(prompt) - 1,
                               namespace=self._ns(action.req_id))
        p, t = m.tokens, None
        while p > 0:
            t = self._tail_bucket(len(prompt) - p)
            if t is None:   # shrinking p only grows the tail
                p = 0
                break
            if p + t <= self.max_len:
                break
            p -= bt
        if p <= 0:
            self.kvcache.release(m)
            self.kvcache.record_miss(tenant)
            self._prefix_misses += 1
            return None
        return m, p, t

    def _materialize_prefix(self, payloads: list
                            ) -> tuple[torch.Tensor, torch.Tensor]:
        """A matched block chain -> (k, v) [L, 1, P, kv, hd] in the model
        dtype: the blocks concatenated along the token axis, int8 blocks
        dequantized only here (the store keeps them int8)."""
        parts = [torch.cat([b[j] for b in payloads], dim=2)
                 for j in range(len(payloads[0]))]
        if self.kv_quantize == "int8":
            kq, ks, vq, vs = parts
            return (llama.dequantize_kv(kq, ks, self.cfg.dtype),
                    llama.dequantize_kv(vq, vs, self.cfg.dtype))
        return parts[0].to(self.cfg.dtype), parts[1].to(self.cfg.dtype)

    @staticmethod
    def _stack_prefix(entries: list) -> tuple[torch.Tensor, torch.Tensor]:
        """Per-row materialized prefixes -> the wave's (k, v) prefix
        [L, W, P, kv, hd]."""
        return (torch.cat([e[0] for e in entries], dim=1),
                torch.cat([e[1] for e in entries], dim=1))

    def _extract_prefix_raw(self, slot: int, p: int, *,
                            cache: dict | None = None) -> tuple:
        """A slot's first p KV rows of `cache` (the engine's slab by
        default) as they are stored, views [L, 1, p, ...]: (k, k_scale, v,
        v_scale) on an int8 cache, else (k, v)."""
        c = self.cache if cache is None else cache
        names = (("k", "k_s", "v", "v_s") if self.kv_quantize == "int8"
                 else ("k", "v"))
        return tuple(c[n][:, slot, :p][:, None] for n in names)

    @staticmethod
    def _payload_slice(parts: tuple, s: int, e: int) -> tuple:
        """One block's payload: rows [s, e) of every part, copied into
        tensors of its own (a view would keep the whole slot alive, and
        evicting the block would free nothing)."""
        return tuple(
            a[:, :, s:e].clone(memory_format=torch.contiguous_format)
            for a in parts)

    def _bank_prefix_blocks(self, action: PrefillAction) -> None:
        """After a prefill (a wave, a continuation or a chunked chain),
        bank the slot's block-aligned prompt prefix: probe first (a chain
        cached end to end costs nothing), then copy only the blocks the
        trie does not hold yet."""
        prompt = self._prompts.get(action.req_id)
        if prompt is None:
            return
        bt = self.prefix_block_tokens
        aligned = (len(prompt) // bt) * bt
        ns = self._ns(action.req_id)
        if aligned <= 0 or self.kvcache.cached_prefix_len(
                prompt, max_tokens=aligned, namespace=ns) >= aligned:
            return
        parts = self._extract_prefix_raw(action.slot, aligned)
        self.kvcache.insert(
            prompt, lambda _i, s, e: self._payload_slice(parts, s, e),
            max_tokens=aligned, tenant=self._req_tenant.get(action.req_id),
            namespace=ns)

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
            logits = self._decode_logits(span)
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

    def _decode_logits(self, span: int) -> torch.Tensor:
        """One decode step's model over every slot: logits [n_slots,
        vocab] f32, the KV rows written at `lengths`."""
        return llama.decode_step(
            self.params, self.last_tokens, self.cache, self.lengths,
            self.cfg, span=span, **self._lora_kw(self.cache.get("aids")))

    def _spec_body(self, steps: int, span: int, kd: int,
                   sample: bool) -> torch.Tensor:
        """`steps` speculative verify rounds over every slot at attention
        span `span` with kd drafts (the JAX `_spec_decode`), reading and
        updating the static slot state in place. Each round records the
        pending token into the history (inactive slots write nothing),
        drafts kd tokens (`_ngram_draft`), zeroes the count of sampled and
        penalized rows (their penalties change per token, so they decode
        one token a round), verifies [last ++ drafts] in one
        `llama.verify_step`, accepts the leading run of drafts the greedy
        prediction matches, takes the bonus token from the prediction
        after that run (from `_choose` at position lengths + 1 for sampled
        and penalized rows), counts the emitted tokens for the penalties,
        writes the accepted drafts into the history and advances lengths
        by n_acc + 1. Returns [steps, n_slots, 1 + (kd + 1) * cols]: each
        round's emit count ++ `_pack_out` of its kd + 1 emit positions
        (emitted token j's distribution is verify row j).

        sample=False, for batches with no sampled or penalized row, skips
        `_choose` and the penalty counts, as `_decode_body` does."""
        n, dev = self.n_slots, self.device
        active = self._active_dev
        hist = self.cache["hist"]
        pos = self._hist_pos
        temps = self.samp[:, 0]
        pens = (self.samp[:, 3] != 0) | (self.samp[:, 4] != 0)
        drafting = active & (temps <= 0) & ~pens
        jk = torch.arange(kd, device=dev)[None]
        jj = torch.arange(kd + 1, device=dev)[None]
        pad = torch.zeros((n, 1), dtype=torch.long, device=dev)
        outs = []
        for _ in range(steps):
            lens = self.lengths.long()[:, None]
            last = self.last_tokens
            hist.copy_(torch.where(active[:, None] & (pos == lens),
                                   last[:, None].to(hist.dtype), hist))
            drafts, count = _ngram_draft(hist, self.lengths, kd,
                                         self.spec_ngram)
            drafts = drafts.long()
            count = torch.where(drafting, count, 0)
            logits = llama.verify_step(
                self.params, torch.cat([last[:, None], drafts], dim=1),
                self.cache, self.lengths, self.cfg, span=span,
                **self._lora_kw(self.cache.get("aids")))
            preds = torch.argmax(logits, dim=-1)            # [B, kd + 1]
            match = (preds[:, :kd] == drafts) & (jk < count[:, None])
            n_acc = torch.cumprod(match.long(), dim=1).sum(dim=1)
            bonus = preds.gather(1, n_acc[:, None])[:, 0]
            if sample:
                chosen = self._choose(logits[:, 0], self.samp,
                                      self._slot_ids, self._cnt,
                                      self.lengths + 1, True)
                bonus = torch.where((temps > 0) | pens, chosen, bonus)
            emit = torch.where(
                jj < n_acc[:, None], torch.cat([drafts, pad], dim=1),
                torch.where(jj == n_acc[:, None], bonus[:, None], 0))
            emit_count = torch.where(active, n_acc + 1, 0)
            if sample:
                self._cnt.scatter_add_(
                    1, emit, (jj < emit_count[:, None]).to(self._cnt.dtype))
            # the accepted drafts enter the history; the bonus lands there
            # next round, as the pending token
            off = pos - lens - 1
            accepted = active[:, None] & (off >= 0) & (off < n_acc[:, None])
            hist.copy_(torch.where(
                accepted, drafts.gather(1, off.clamp(0, kd - 1)).to(
                    hist.dtype), hist))
            self.lengths += emit_count.to(torch.int32)
            self.last_tokens.copy_(torch.where(active, bonus, last))
            rows = self._pack_out(emit, logits)        # [B, kd + 1, cols]
            outs.append(torch.cat([emit_count[:, None].float(),
                                   rows.reshape(n, -1)], dim=1))
        return torch.stack(outs)

    def _chunk_state(self) -> list[torch.Tensor]:
        """The slot state a decode chunk changes besides the KV rows it
        writes (and, with speculation, the token history)."""
        state = [self.lengths, self.last_tokens, self._cnt, self._draws]
        return state + ([self.cache["hist"]] if self.spec else [])

    def _body(self, key: tuple):
        """The eager body of program `key`: (steps, span, sample) a decode
        chunk, (steps, span, kd, sample) a chunk of verify rounds."""
        fn = self._spec_body if len(key) == 4 else self._decode_body
        return functools.partial(fn, *key)

    def _capture(self, key: tuple) -> _GraphProgram:
        """Capture the decode chunk `key` as a CUDA graph in the engine's
        pool. The first capture of each program family (decode or verify
        with its kd, each variant) runs the body once first on a side
        stream: first-use work (cuBLAS handles, the kernels' first loads)
        must not happen inside a capture. Keys of one family differ only
        in steps and span, which launch the same kernels, so later
        captures skip that run. The slot state the run changed is put
        back, so a capture in live traffic is invisible to it: the KV rows
        that run wrote are written again, with the same values, by the
        replay that follows. A capture that fails raises."""
        dev = self.device
        body = self._body(key)
        family = (len(key), key[2] if len(key) == 4 else 0, key[-1])
        if family not in self._first_use_done:
            saved = [t.clone() for t in self._chunk_state()]
            current = torch.cuda.current_stream(dev)
            side = torch.cuda.Stream(dev)
            side.wait_stream(current)
            with torch.cuda.stream(side), _build.recording():
                body()   # uncounted: the replays count
            current.wait_stream(side)
            for t, s in zip(self._chunk_state(), saved):
                t.copy_(s)
            self._first_use_done.add(family)
        graph = torch.cuda.CUDAGraph()
        # thread_local: another engine's thread (a disaggregated engine's
        # other role) may allocate and synchronize while this one captures
        with _build.recording() as launches, gc_paused(), torch.cuda.graph(
                graph, pool=self._graph_pool,
                capture_error_mode="thread_local"):
            out = body()
        self._graph_captures += 1
        return _GraphProgram(self, graph, out, launches)

    def _decode_fn(self, steps: int, span: int, sample: bool = True):
        """The decode program (steps, span, sample), made on first use: a
        captured graph on a CUDA engine, the eager body on a CPU one (the
        JAX `_decode_fn`)."""
        return self._program((steps, span, sample))

    def _program(self, key: tuple):
        """Program `key` (`_body`), made on first use."""
        prog = self._programs.get(key)
        if prog is None:
            prog = (self._capture(key) if self.device.type == "cuda"
                    else self._body(key))
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

    def _spec_chunk(self, steps: int, span: int, kd: int,
                    active: torch.Tensor, sample: bool = True
                    ) -> torch.Tensor:
        """Run the verify program (steps, span, kd, sample) once (the JAX
        `_spec_fn`'s program), as `_decode_chunk` runs a decode program;
        returns its rows [steps, n_slots, 1 + (kd + 1) * cols] on the
        device, not fetched."""
        if active is not self._active_dev:
            self._active_dev.copy_(active)
        return self._program((steps, span, kd, sample))()

    def warmup(self) -> None:
        """Run each prefill bucket once and make the decode menu (the JAX
        engine's combos: every (chunk, span) pair when there are at most
        16, else every chunk at full span plus the largest chunk at every
        span; each in both variants), capturing every graph on a CUDA
        engine so live traffic never captures. With speculation the menu
        is the verify programs instead (the JAX spec menu): the combos at
        k_max, then each smaller menu k at full span for the largest chunk
        and for chunk 1. Slot state is junk while it runs and reset in
        place after; call only while idle."""
        if self._pending is not None or any(
                self.scheduler.slot_request(s) >= 0
                for s in range(self.n_slots)):
            raise RuntimeError("warmup needs an idle engine")
        dev = self.device
        slot0 = self._slot_ids[:1]
        for bucket in self.buckets:
            x = self._prefill_rows(
                torch.ones((1, bucket), dtype=torch.long, device=dev), [0],
                0, ids=torch.zeros(1, dtype=torch.long, device=dev))
            logits = self._lm_head(x[:, -1:])[:, 0]
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
        if self.spec:
            menu = [(c, span, self.spec) for c, span in combos]
            if self._spec_adapt is not None:
                menu += [(c, self.max_len, kd)
                         for kd in self._spec_adapt.menu[:-1]
                         for c in sorted({chunks[-1], 1})]
        else:
            menu = combos
        for key in (menu if self._decodes else ()):
            for sample in (True, False):
                self._program(key + (sample,))()
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
        self._decode_chunk_warm = self.decode_chunk
        self._warmed = True

    # -- decode --------------------------------------------------------------

    def _do_decode(self) -> None:
        """Dispatch one chunk of k decode steps (verify rounds, with
        speculation) over every slot; under pipeline_decode, then fetch
        and replay the chunk before it. k is the largest power of two <=
        decode_chunk whose rows (k x (kd + 1) with kd drafts) fit the cache
        headroom of the fullest slot (counting the rows of the chunk in
        flight) and that the likely tokens of k - 1 rounds do not already
        cover for every request's remaining budget (less what the chunk in
        flight will deliver). kd is the adaptive policy's pick over the
        drafting slots (the JAX `_do_decode`)."""
        if self._pending is not None:
            # nothing left for a new chunk to do: every budget is met by
            # the chunk in flight (with speculation: likely met, by the
            # tokens its rounds should deliver), or a slot has no room
            # past its rows
            psr, psteps = self._pending[:2]
            full = max((int(self._host_lengths[s] + self._inflight[s])
                        for s in range(self.n_slots) if psr[s] >= 0),
                       default=0) >= self.max_len
            need = [self._max_new[r] - len(self._results[r])
                    for r in psr if r >= 0 and r in self._max_new]
            likely = psteps * self._est_round_tokens() * 1.25
            if full or all(n <= psteps for n in need) or (
                    self.spec and all(n <= likely for n in need)):
                self._drain_pending()
                return
        slot_req = self._mask_unfunded(
            [self.scheduler.slot_request(s) for s in range(self.n_slots)])
        active = np.array([r >= 0 for r in slot_req], bool)
        if not active.any():
            return   # every live slot waits for KV blocks (paged engine)
        kd = self.spec or 0
        if self._spec_adapt is not None:
            kd = self._spec_adapt.pick(
                [s for s, r in enumerate(slot_req)
                 if r >= 0 and self._draftable(r)])
        per_tok = kd + 1 if self.spec else 1
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
        est = self._est_round_tokens()
        k = 1
        while (k * 2 <= self.decode_chunk and k * 2 * per_tok <= headroom
               and k * est < remaining):
            k *= 2
        span = self._pick_span(min(longest + k * per_tok, self.max_len))
        samp = self._samp_host[active]
        sample = bool(((samp[:, 0] > 0) | (samp[:, 3] != 0)
                       | (samp[:, 4] != 0)).any())
        # never capture after warmup: a key outside the warmed menu takes
        # the full span; a verify key cold there too takes static k_max at
        # full span (every chunk is warm there, and a shorter span would
        # not cover k_max's rows), its chunk shrunk to fit the headroom
        if self.spec:
            if self._warmed and (k, span, kd, sample) not in self._programs:
                if (k, self.max_len, kd, sample) not in self._programs:
                    kd = self.spec
                    while k > 1 and k * (kd + 1) > headroom:
                        k //= 2
                span = self.max_len
            per_tok = kd + 1
        elif self._warmed and (k, span, sample) not in self._programs:
            span = self.max_len
        self._spec_last_k = kd
        t_dispatch = time.perf_counter()
        act = self._active_for(active)
        out = (self._spec_chunk(k, span, kd, act, sample) if self.spec
               else self._decode_chunk(k, span, act, sample))
        handle = self._stage_out(out)
        self._perf["dispatch_s"] += time.perf_counter() - t_dispatch
        self._perf["decode_chunks"] += 1
        self._perf["decode_steps"] += k
        self._decode_agg.note_step(int(active.sum()) * k * per_tok, steps=k)
        rows_added = np.where(active, k * per_tok, 0)
        self._inflight += rows_added
        prev = self._pending
        self._pending = (slot_req, k, handle, rows_added, kd)
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
        slot_req, _, (buf, event), rows_added, kd = pending
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
                if not self.spec:
                    self._host_lengths[slot] += 1
                    tok, lp, top = self._unpack_out(row[slot])
                    if self._record_token(req, slot, tok, lp, top):
                        done_slots.add(slot)
                    continue
                # a verify round: its count of tokens in order; a finish
                # drops the rest
                cnt = int(row[slot, 0])
                emits = row[slot, 1:].reshape(kd + 1, -1)
                self._spec_verifies += 1
                self._observe_round_tokens(cnt)
                if self._spec_adapt is not None:
                    self._spec_adapt.observe(slot, cnt - 1, kd)
                for j in range(cnt):
                    self._host_lengths[slot] += 1
                    self._spec_tokens += 1
                    tok, lp, top = self._unpack_out(emits[j])
                    if self._record_token(req, slot, tok, lp, top):
                        done_slots.add(slot)
                        break
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

    def _draftable(self, req_id: int) -> bool:
        """True when the request's rows draft: greedy and penalty-free,
        the predicate the verify body applies per row."""
        t = self._req_samp.get(req_id)
        return t is None or (t[0] <= 0 and t[3] == 0 and t[4] == 0)

    def _observe_round_tokens(self, n: int) -> None:
        """Fold one verify round's delivered tokens into the EMA that chunk
        sizing and the drain guard read."""
        if self._spec_round_ema is None:
            self._spec_round_ema = float(n)
        else:
            self._spec_round_ema += SPEC_EMA_ALPHA * (
                n - self._spec_round_ema)

    def _est_round_tokens(self) -> float:
        """Expected delivered tokens per decode round: 1 without
        speculation; with it, the EMA of tokens per verify round, k_max + 1
        before any round, within [1, k_max + 1]."""
        if not self.spec:
            return 1.0
        if self._spec_round_ema is None:
            return float(self.spec + 1)
        return min(float(self.spec + 1), max(1.0, self._spec_round_ema))

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
            if req_id in self._req_trace:
                self._decode_mark[req_id] = self._decode_agg.snapshot()
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
        self._finish_t[req_id] = time.monotonic()
        self._done.add(req_id)
        for d in (self._prompts, self._max_new, self._req_samp,
                  self._req_stop, self._deadlines, self._req_aids):
            d.pop(req_id, None)
        self._obs_finish(req_id)


# -- disaggregated serving roles ----------------------------------------------
#
# Prefill and decode want opposite schedules from one engine: a chunked
# prefill chain holds the step loop for a whole chunk plan, while decode
# wants short uniform steps. serving/disagg.py splits the two onto
# dedicated engine roles and moves the finished KV between them as radix
# prefix-cache block payloads. Both roles are ordinary engines (one
# program menu, one scheduler, one parity story); the classes below pin
# what each side of the split relies on. As with LLMEngine, only a
# supervisor's engine factory builds them on the serving path.


class PrefillEngine(LLMEngine):
    """The dedicated prefill worker (the JAX `PrefillEngine`): runs
    (chunked) prefill, starting from the longest chain its own prefix
    cache holds, and stops at the KV. Every submission is clamped to one
    greedy token, which finishes the request at its prefill, so the
    engine never decodes (`warmup()` captures no decode graph). The token
    is discarded; the product is the block-aligned prefix KV banked in
    `self.kvcache`, which the coordinator hands to the decode worker."""

    role = "prefill"
    _decodes = False

    def __init__(self, params, cfg, **kw):
        # the radix cache is the handoff's staging area
        kw["prefix_cache"] = True
        super().__init__(params, cfg, **kw)

    def submit(self, prompt, max_new_tokens: int = 1,
               temperature: float = 0.0, **kw) -> int:
        # clamped, not honoured: the KV is the whole job, and greedy keeps
        # the supervisor's journal replay exact
        return super().submit(prompt, 1, 0.0, **kw)


class DecodeEngine(LLMEngine):
    """The dedicated decode worker (the JAX `DecodeEngine`): admissions
    find their block-aligned prompt prefix in the prefix cache (a handoff
    put it there), so a request's prefill is one tail continuation. An
    admission of at least one block that finds no cached prefix pays a
    full prefill (the handoff was missed: an eviction raced it, or a
    replay landed on a fresh cache after a crash): counted in
    `full_prefills`, never fatal."""

    role = "decode"

    def __init__(self, params, cfg, **kw):
        kw["prefix_cache"] = True
        super().__init__(params, cfg, **kw)
        self.full_prefills = 0

    def _prefix_lookup(self, action: PrefillAction):
        hit = super()._prefix_lookup(action)
        if hit is None and self.prefix_block_tokens \
                and len(self._prompts.get(action.req_id, ())) - 1 \
                >= self.prefix_block_tokens:
            self.full_prefills += 1
        return hit

    def metrics(self) -> dict[str, Any]:
        out = super().metrics()
        out["disagg_full_prefills"] = self.full_prefills
        return out
