"""Continuous-batching LLM engine (counterpart of kubeflow_tpu/serving/
llm.py `LLMEngine`, slab KV).

One engine owns the params, a slab KV cache [L, n_slots, max_len, kv, hd]
(int8 with per-token scales, or the model dtype) and a scheduler. Each
`step()` runs either one prefill wave — every queued request that gets a
free slot, grouped by prompt bucket, one batched forward per bucket — or
one decode chunk of up to `decode_chunk` steps over all slots, with
attention bounded to the smallest power-of-two span that covers every
live length (the length-aware span menu). Tokens reach the host once per
wave or chunk.

Sampling: greedy (temperature 0) is an argmax of the f32 logits;
temperature/top-k/top-p sampling follows the JAX `_choose` (one
probability threshold from the sorted top `SAMPLE_K_MAX` candidates) and
draws with the Gumbel-max trick from the engine's `torch.Generator`,
seeded by `sample_seed`: the same seed and the same submissions give the
same tokens. Penalties, stop sequences, logprobs, the prefix cache,
chunked prefill, speculative decoding and adapters are not in this
engine yet; a prompt longer than the largest bucket raises PromptTooLong.
"""

from __future__ import annotations

import math
import threading
import time
from typing import Any, Sequence

import numpy as np
import torch

from kubeflow_tpu_torch._device import resolve_device
from kubeflow_tpu_torch.models import llama
from kubeflow_tpu_torch.serving.scheduler import (DecodeAction,
                                                  PrefillAction, PyScheduler)


def _to_device(tree: Any, device: torch.device) -> Any:
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device)


class LLMEngine:
    """Slab-KV continuous-batching generation over llama params."""

    #: nucleus/top-k filtering looks at this many top candidates; a
    #: request may not ask for a larger top_k (the JAX engine's default)
    SAMPLE_K_MAX = 64

    def __init__(self, params, cfg: llama.LlamaConfig, *, n_slots: int = 4,
                 max_len: int = 512, buckets: Sequence[int] = (64, 128, 256),
                 eos_id: int | None = None, decode_chunk: int = 8,
                 sample_seed: int = 0, quantize: str | None = None,
                 kv_quantize: str | None = None, device="cuda"):
        if max(buckets) >= max_len:
            raise ValueError("largest bucket must leave room to decode")
        if quantize not in (None, "int8"):
            raise ValueError(f"unknown quantize mode {quantize!r}")
        if kv_quantize not in (None, "int8"):
            raise ValueError(f"unknown kv_quantize mode {kv_quantize!r}")
        self.device = resolve_device(device)
        if self.device.type == "cuda" and cfg.dtype != torch.bfloat16:
            raise ValueError("the CUDA kernels run bfloat16 models")
        params = _to_device(params, self.device)
        if quantize == "int8":
            params = llama.quantize_params(params)
        self.params = params
        self.cfg = cfg
        self.kv_quantize = kv_quantize
        self.n_slots = n_slots
        self.max_len = max_len
        self.buckets = tuple(sorted(buckets))
        self.eos_id = eos_id
        self.decode_chunk = max(1, decode_chunk)
        self.scheduler = PyScheduler(n_slots, self.buckets)
        self.cache = self._alloc_cache()
        self.lengths = torch.zeros(n_slots, dtype=torch.int32,
                                   device=self.device)
        self.last_tokens = torch.zeros(n_slots, dtype=torch.long,
                                       device=self.device)
        # per-slot (temperature, top_k, top_p); the host copy decides
        # whether a batch samples at all, so no device value is read
        self._samp_host = self._samp_reset()
        self.samp = torch.from_numpy(self._samp_host).to(self.device)
        self.generator = torch.Generator(device=self.device).manual_seed(
            sample_seed)
        self._host_lengths = np.zeros(n_slots, np.int64)
        self._submit_lock = threading.Lock()
        self._prompts: dict[int, list[int]] = {}
        self._req_samp: dict[int, tuple[float, int, float]] = {}
        self._max_new: dict[int, int] = {}
        self._results: dict[int, list[int]] = {}
        self._finish_reasons: dict[int, str] = {}
        self._submit_t: dict[int, float] = {}
        self._first_token_t: dict[int, float] = {}
        self._done: set[int] = set()
        # the decode active mask on the device, uploaded when it changes
        self._active_host: np.ndarray | None = None
        self._active_dev: torch.Tensor | None = None
        # host-side decode counters (perf_counters), the JAX engine's keys
        self._perf = {"dispatch_s": 0.0, "fetch_replay_s": 0.0,
                      "decode_chunks": 0, "decode_steps": 0,
                      "active_uploads": 0}

    def _samp_reset(self) -> np.ndarray:
        """Idle per-slot sampling state: greedy (temperature 0, top_k 0,
        top_p 1)."""
        s = np.zeros((self.n_slots, 3), np.float32)
        s[:, 2] = 1.0
        return s

    def perf_counters(self, reset: bool = False) -> dict[str, Any]:
        """Decode host-side attribution counters: the wall time spent
        issuing each chunk's launches (dispatch_s) and fetching its tokens
        and replaying them into the requests (fetch_replay_s), chunk and
        step counts, and active-mask uploads. The serving profiler
        (training/profiling.serving_decode_breakdown) reads them."""
        out = dict(self._perf)
        if reset:
            for key in self._perf:
                self._perf[key] = type(self._perf[key])(0)
        return out

    # -- sampling ------------------------------------------------------------

    def _choose(self, logits: torch.Tensor, samp: torch.Tensor,
                sampling: bool) -> torch.Tensor:
        """logits [R, V] f32, samp [R, 3] = (temperature, top_k, top_p) ->
        tokens [R]. Rows with temperature 0 take the argmax; the others
        sample over the candidates that pass top-k/top-p (JAX `_choose`
        without penalties). `sampling` False (no row samples) skips the
        sampling work."""
        greedy = torch.argmax(logits, dim=-1)
        if not sampling:
            return greedy
        temps, topks, topps = samp[:, 0], samp[:, 1], samp[:, 2]
        scaled = logits / temps.clamp_min(1e-6)[:, None]
        kmax = min(self.SAMPLE_K_MAX, logits.shape[-1])
        probs = torch.softmax(scaled, dim=-1)
        top_vals = torch.topk(probs, kmax, dim=-1).values     # descending
        cum = torch.cumsum(top_vals, dim=-1)
        p_lim = torch.where((topps > 0) & (topps < 1), topps,
                            torch.full_like(topps, 2.0))
        keep_p = (cum - top_vals) < p_lim[:, None]
        kk = torch.where(topks > 0, topks.clamp_max(kmax),
                         torch.full_like(topks, kmax))
        keep = keep_p & (torch.arange(kmax, device=logits.device)[None]
                         < kk[:, None])
        n_keep = keep.sum(dim=-1).clamp_min(1)
        thr = top_vals.gather(1, (n_keep - 1)[:, None])[:, 0]
        use_filter = (topks > 0) | ((topps > 0) & (topps < 1))
        thr = torch.where(use_filter, thr, torch.zeros_like(thr))
        masked = torch.where(probs >= thr[:, None], scaled,
                             torch.full_like(scaled, -math.inf))
        u = torch.rand(masked.shape, generator=self.generator,
                       device=logits.device).clamp_(1e-20, 1.0)
        sampled = torch.argmax(masked - torch.log(-torch.log(u)), dim=-1)
        return torch.where(temps > 0, sampled, greedy)

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

    # -- public API ----------------------------------------------------------

    def submit(self, prompt: Sequence[int], max_new_tokens: int = 32,
               temperature: float = 0.0, top_k: int = 0,
               top_p: float = 1.0) -> int:
        """Queue one request. Raises PromptTooLong for a prompt that is
        empty or longer than the largest bucket, QueueFull when the queue
        is full, ValueError for bad sampling arguments."""
        if not (math.isfinite(temperature) and 0 <= temperature <= 100):
            raise ValueError("temperature must be finite and in [0, 100]")
        top_k = int(top_k)
        if not 0 <= top_k <= self.SAMPLE_K_MAX:
            raise ValueError(f"top_k must be 0..{self.SAMPLE_K_MAX}")
        top_p = float(top_p)
        if not (math.isfinite(top_p) and 0 < top_p <= 1):
            raise ValueError("top_p must be in (0, 1]")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if any(not 0 <= int(t) < self.cfg.vocab_size for t in prompt):
            raise ValueError("prompt token outside the vocabulary")
        with self._submit_lock:
            rid = self.scheduler.submit(len(prompt), max_new_tokens)
            self._prompts[rid] = [int(t) for t in prompt]
            self._req_samp[rid] = (float(temperature), top_k, top_p)
            self._max_new[rid] = max_new_tokens
            self._results[rid] = []
            self._submit_t[rid] = time.monotonic()
        return rid

    def step(self) -> bool:
        """One engine iteration: a prefill wave or a decode chunk. False
        when there is nothing to do."""
        with self._submit_lock:
            action = self.scheduler.next()
        if action is None:
            return False
        if isinstance(action, DecodeAction):
            self._do_decode()
            return True
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
        """One batched prefill wave per prompt bucket."""
        groups: dict[int, list[PrefillAction]] = {}
        for a in actions:
            groups.setdefault(a.bucket_len, []).append(a)
        for bucket, wave in groups.items():
            self._prefill_wave(bucket, wave)

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

    def finish_reason(self, req_id: int) -> str:
        """"stop" (EOS) or "length" (max_new_tokens or cache room)."""
        return self._finish_reasons.get(req_id, "length")

    def ttft_seconds(self, req_id: int) -> float | None:
        if req_id not in self._first_token_t:
            return None
        return self._first_token_t[req_id] - self._submit_t[req_id]

    def release(self, req_id: int) -> None:
        """Drop a finished request's state; servers call this after
        reading the result."""
        self._done.discard(req_id)
        for d in (self._results, self._finish_reasons, self._submit_t,
                  self._first_token_t):
            d.pop(req_id, None)

    # -- prefill -------------------------------------------------------------

    def _prefill_wave(self, bucket: int, wave: list[PrefillAction]) -> None:
        """One batched prefill of `wave` (prompts right-padded to
        `bucket`): writes each prompt's KV into its slot, samples its
        first token from the last prompt row."""
        dev = self.device
        tokens = torch.zeros((len(wave), bucket), dtype=torch.long)
        for i, a in enumerate(wave):
            p = self._prompts[a.req_id]
            tokens[i, :len(p)] = torch.tensor(p)
        plens = [len(self._prompts[a.req_id]) for a in wave]
        x, (ks, vs) = llama.prefill_hidden(self.params, tokens.to(dev),
                                           self.cfg)
        rows = torch.arange(len(wave), device=dev)
        last = x[rows, torch.tensor(plens, device=dev) - 1]
        logits = llama.lm_head(self.params, last[:, None], self.cfg)[:, 0]
        for i, a in enumerate(wave):
            self._cache_write(a.slot, bucket, ks[:, i], vs[:, i])
            self._samp_host[a.slot] = self._req_samp[a.req_id]
        slots = torch.tensor([a.slot for a in wave], device=dev)
        self.samp.copy_(torch.from_numpy(self._samp_host))
        self.lengths[slots] = torch.tensor(plens, dtype=torch.int32,
                                           device=dev)
        samp = self.samp[slots]
        toks = self._choose(logits, samp, bool(
            (self._samp_host[[a.slot for a in wave], 0] > 0).any()))
        self.last_tokens[slots] = toks
        toks_host = toks.tolist()        # one fetch per wave
        now = time.monotonic()
        for i, a in enumerate(wave):
            self._host_lengths[a.slot] = plens[i]
            self._first_token_t[a.req_id] = now
            self._record_token(a.req_id, a.slot, toks_host[i])

    def _alloc_cache(self) -> dict:
        """The KV cache: a slab [L, n_slots, max_len, kv, hd]."""
        return llama.init_cache(self.cfg, self.n_slots, self.max_len,
                                self.kv_quantize, device=self.device)

    def _cache_write(self, slot: int, count: int, ks: torch.Tensor,
                     vs: torch.Tensor) -> None:
        """Write [L, count, kv, hd] KV rows into rows [0, count) of a
        slot, quantizing when the cache is int8."""
        c = self.cache
        if self.kv_quantize == "int8":
            kq, ksc = llama.quantize_kv(ks)
            vq, vsc = llama.quantize_kv(vs)
            c["k"][:, slot, :count] = kq
            c["v"][:, slot, :count] = vq
            c["k_s"][:, slot, :count] = ksc
            c["v_s"][:, slot, :count] = vsc
        else:
            c["k"][:, slot, :count] = ks.to(c["k"].dtype)
            c["v"][:, slot, :count] = vs.to(c["v"].dtype)

    # -- decode --------------------------------------------------------------

    def _do_decode(self) -> None:
        """One chunk of k decode steps over every slot (inactive slots
        compute and write junk their next prefill overwrites). k is the
        largest power of two <= decode_chunk that fits the cache headroom
        of the fullest slot and is not past every request's budget."""
        slot_req = self._mask_unfunded(
            [self.scheduler.slot_request(s) for s in range(self.n_slots)])
        active = np.array([r >= 0 for r in slot_req], bool)
        if not active.any():
            return   # every live slot waits for KV blocks (paged engine)
        remaining = max(max(1, self._max_new[r] - len(self._results[r]))
                        for r in slot_req if r >= 0)
        longest = int(self._host_lengths[active].max())
        headroom = self.max_len - longest
        k = 1
        while (k * 2 <= self.decode_chunk and k * 2 <= headroom
               and k < remaining):
            k *= 2
        span = self._pick_span(min(longest + k, self.max_len))
        sampling = bool((self._samp_host[active, 0] > 0).any())
        t_dispatch = time.perf_counter()
        out = self._decode_chunk(k, span, self._active_for(active),
                                 sample=sampling)
        self._perf["dispatch_s"] += time.perf_counter() - t_dispatch
        self._perf["decode_chunks"] += 1
        self._perf["decode_steps"] += k
        t_replay = time.perf_counter()
        out_host = out.tolist()   # one fetch per chunk: waits for the card
        done_slots: set[int] = set()
        for row in out_host:
            for slot, req in enumerate(slot_req):
                if req < 0 or slot in done_slots:
                    continue
                self._host_lengths[slot] += 1
                if self._record_token(req, slot, row[slot]):
                    done_slots.add(slot)
        self._perf["fetch_replay_s"] += time.perf_counter() - t_replay

    def _decode_chunk(self, steps: int, span: int, active: torch.Tensor,
                      sample: bool = True) -> torch.Tensor:
        """Issue `steps` decode steps over every slot at attention span
        `span`; `active` [n_slots] bool on the device says which slots
        advance (inactive ones compute and write junk). Updates the cache,
        lengths and last tokens, and returns the chunk's tokens [steps,
        n_slots] on the device, not fetched. The engine and the serving
        profiler run this same code.

        sample=True runs the sampling path of `_choose` for every row (a
        row at temperature 0 still takes the argmax). sample=False is the
        profiler's sampling-stripped variant (the JAX engine's
        `_decode_nosample_fn`): the raw argmax and no sampling work. The
        engine itself passes sample=False when no row samples, since the
        tokens are the argmax either way; the profiler's full variant
        passes True, forcing the sampling path on as the JAX compiled
        decode program always runs it."""
        step = active.to(torch.int32)
        out = []
        for _ in range(steps):
            logits = llama.decode_step(self.params, self.last_tokens,
                                       self.cache, self.lengths, self.cfg,
                                       span=span)
            toks = self._choose(logits, self.samp, sample)
            self.lengths += step
            self.last_tokens = torch.where(active, toks, self.last_tokens)
            out.append(toks)
        return torch.stack(out)

    def _active_for(self, active: np.ndarray) -> torch.Tensor:
        """The decode active mask on the device, uploaded again only when
        it changes (slots move at prefill and finish, not every chunk)."""
        if (self._active_host is None
                or not np.array_equal(active, self._active_host)):
            self._active_host = active.copy()
            self._active_dev = torch.from_numpy(active).to(self.device)
            self._perf["active_uploads"] += 1
        return self._active_dev

    def _mask_unfunded(self, slot_req: list[int]) -> list[int]:
        """Decode planning sees a slot whose prefill is held (paged
        engine: assigned, no KV funded yet) as empty (-1). The slab engine
        holds nothing."""
        return slot_req

    def _record_token(self, req_id: int, slot: int, token: int) -> bool:
        """Append one token; True when it finished the request."""
        self._results[req_id].append(token)
        hit_eos = self.eos_id is not None and token == self.eos_id
        # the next decode writes at _host_lengths, which must stay in
        # the cache
        out_of_room = self._host_lengths[slot] >= self.max_len
        freed = self.scheduler.token_done(slot,
                                          finished=hit_eos or out_of_room)
        if freed:
            self._finish_reasons[req_id] = "stop" if hit_eos else "length"
            self._done.add(req_id)
            self._prompts.pop(req_id, None)
            self._max_new.pop(req_id, None)
            self._req_samp.pop(req_id, None)
        return freed
