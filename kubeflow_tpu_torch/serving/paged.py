"""Paged KV serving (counterpart of kubeflow_tpu/serving/paged.py
`PagedLLMEngine`).

The slab engine sizes KV by the worst case, [n_slots, max_len] rows, so a
short request strands max_len - len rows of memory in its slot.
`PagedLLMEngine` keeps KV in the block pool of kvcache/pool.py instead:
fixed blocks of `block_tokens` tokens (bt, the gcd of the prefill
buckets), stitched into each slot's logical rows by a block table, and
admission funds each request with a reservation of blocks:

  - **Model** (models/llama.py `verify_inner`): with "tbl" in the cache,
    position p of slot r is written to block tbl[r, p // bt] at offset
    p % bt, and K2 reads the span through the same table (its paged mode,
    ops/flash_decode.py).
  - **Admission**: `_admit_prefills` reserves ceil(min(max_len,
    prompt + max_new) / bt) blocks per request, all or nothing. A request
    it cannot fund is held: its slot stays assigned, decode treats the
    slot as empty (`_mask_unfunded`), and it is retried first at every
    step. A reservation covers every token the request can deliver, so
    an admitted request always runs to its end.
  - **Prefix cache** (`prefix_cache=True`): the radix payloads are pool
    block ids. Banking a prefix is one pool reference per new block
    (`_bank_prefix_blocks`, no copy); a hit splices the cached blocks
    into the slot's table (`_splice_shared`) and funds only the uncached
    suffix; under block pressure admission evicts unpinned trie blocks
    before it holds a request (the eviction valve in `_fund`), and the
    request's own match stays pinned through it. A trie eviction drops
    the trie's reference (`_on_radix_evict`); the block returns to the
    pool when no table names it and no chunk in flight can reach it.
  - **Junk writes** land in block 0, the pool's trash block: table
    entries past a reservation are 0, a finished slot's row is zeroed
    when it is released, held slots decode as inactive, and positions at
    or past max_len go to block 0.

Prefill runs the slab path's K3 on the wave and scatters the rows through
the table; writes quantize as the slab engine's do, and K2 reads the same
keys in the same order, so the greedy tokens equal the slab engine's. A
chunked prefill gathers the slot's prefix through its table
(`_extract_prefix`) and writes each chunk's rows through it; a prefix
hit's continuation gathers the cached blocks the same way and does not
write the prefix again (the spliced blocks hold its bytes).

Pipelined decode: a finished or cancelled slot's table row is zeroed at
once (later junk writes go to block 0), but its blocks return to the
pool only when no chunk is in flight (`_flush_derefs`): a dispatched,
unfetched chunk still writes through the old table into them. The table
itself is copied into the same device tensor the decode graphs read,
after every splice as after every reservation.

Adapters (`adapters=`, the slab engine's multi-adapter serving) ride the
same way: each slot's adapter index is `cache["aids"]` beside the table,
and a request's cached blocks are matched and banked in its adapter's
radix namespace.
"""

from __future__ import annotations

import math
from typing import Any

import numpy as np
import torch

from kubeflow_tpu_torch.kvcache import BlockPool
from kubeflow_tpu_torch.models import llama
from kubeflow_tpu_torch.serving.llm import LLMEngine


class PagedLLMEngine(LLMEngine):
    """LLMEngine over block-granular paged KV (see the module
    docstring)."""

    kv_layout = "paged"
    _cont_writes_prefix = False   # the spliced blocks hold the prefix

    def __init__(self, params, cfg: llama.LlamaConfig, *,
                 pool_blocks: int | None = None, **kw):
        if kw.get("mesh") is not None:
            raise ValueError(
                "paged KV does not support mesh sharding yet: the pool's "
                "block axis has no GSPMD layout — use kv_layout=slab for "
                "tp/stage-sharded serving")
        n_slots = int(kw.get("n_slots", 4))
        max_len = int(kw.get("max_len", 512))
        buckets = tuple(sorted(kw.get("buckets", (64, 128, 256))))
        kw["buckets"] = buckets
        bt = math.gcd(*buckets)
        if max_len % bt:
            raise ValueError(
                f"paged KV needs block_tokens {bt} (gcd of buckets "
                f"{buckets}) to divide max_len {max_len}")
        self._bt = bt
        self._n_tbl = max_len // bt
        if pool_blocks is None:
            # the slab's memory, so the two layouts compare at equal size
            pool_blocks = n_slots * self._n_tbl
        if pool_blocks < self._n_tbl:
            raise ValueError(
                f"pool_blocks {pool_blocks} cannot fund even one "
                f"max_len request ({self._n_tbl} blocks): admission "
                "would hold it forever")
        # +1: block 0 is the trash sentinel, never allocated
        self._pool = BlockPool(cfg.n_layers, pool_blocks + 1, bt,
                               cfg.n_kv_heads, cfg.head_dim, cfg.dtype,
                               kv_quantize=kw.get("kv_quantize"))
        self._tbl_host = np.zeros((n_slots, self._n_tbl), np.int32)
        #: popped prefills not funded yet (their slots stay assigned)
        self._held: list = []
        #: blocks of finished slots, returned to the pool by _flush_derefs
        self._deferred_derefs: list[int] = []
        super().__init__(params, cfg, **kw)
        for s in self._span_menu():
            if s % bt:
                raise ValueError(
                    f"paged KV needs block_tokens {bt} to divide every "
                    f"attention span (got {s}); pick buckets whose gcd "
                    "divides 128 and max_len")
        if self.kvcache is not None:
            # radix payloads are pool block ids: eviction drops a pool
            # reference, and stats() reports the pool's free blocks
            self.kvcache.attach_pool(self._pool)
            self.kvcache.evict_hook = self._on_radix_evict

    # -- cache layout --------------------------------------------------------

    def _alloc_cache(self) -> dict:
        """The pool's buffers, the device table and the slab engine's
        per-slot buffers (the token history, the adapter indices)."""
        cache = self._pool.device_buffers(self.device)
        cache["tbl"] = torch.tensor(self._tbl_host, device=self.device)
        return self._slot_buffers(cache)

    def _tbl_sync(self) -> None:
        """Copy the host table mirror into the device table after a batch
        of mutations, in place and in stream order (a chunk in flight
        reads the table it was dispatched with). The device never changes
        the table, so the mirror is the truth."""
        self._upload(self.cache["tbl"], self._tbl_host)

    def _cache_write(self, slot: int, start: int, count: int,
                     ks: torch.Tensor, vs: torch.Tensor) -> None:
        """Rows [start, start + count) of `slot` ([L, count, kv, hd])
        scattered into the blocks its table names; entries past its
        reservation are 0, so the prefill's right-pad lands in the trash
        block."""
        bt = self._bt
        if start % bt or count % bt:
            raise ValueError(f"paged cache write of rows [{start}, "
                             f"{start + count}) must be block-aligned "
                             f"(block_tokens={bt})")
        nb = count // bt
        blks = self.cache["tbl"][slot, start // bt:start // bt + nb].long()
        c = self.cache

        def scatter(name, vals):
            c[name][:, blks] = vals.reshape(vals.shape[0], nb, bt,
                                            *vals.shape[2:])

        if self.kv_quantize == "int8":
            kq, ksc = llama.quantize_kv(ks)
            vq, vsc = llama.quantize_kv(vs)
            scatter("k", kq)
            scatter("v", vq)
            scatter("k_s", ksc)
            scatter("v_s", vsc)
        else:
            scatter("k", ks.to(c["k"].dtype))
            scatter("v", vs.to(c["v"].dtype))

    def _extract_prefix(self, slot: int, p: int
                        ) -> tuple[torch.Tensor, torch.Tensor]:
        """The slot's first p KV rows gathered through its table (p a
        block multiple) as [L, 1, p, kv, hd] in the model dtype."""
        return self._gather_blocks(
            self.cache["tbl"][slot, :p // self._bt].long())

    def _gather_blocks(self, blks: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor]:
        """Pool blocks `blks` [nb] -> their rows as a slab-shaped
        [L, 1, nb * bt, kv, hd] in the model dtype (the JAX
        `_gather_blocks`), dequantized from int8 here."""
        c = self.cache
        p = blks.shape[0] * self._bt

        def gather(name):
            g = c[name][:, blks]                       # [L, nb, bt, ...]
            return g.reshape(g.shape[0], p, *g.shape[3:])[:, None]

        k, v = gather("k"), gather("v")
        if self.kv_quantize == "int8":
            k = llama.dequantize_kv(k, gather("k_s"), self.cfg.dtype)
            v = llama.dequantize_kv(v, gather("v_s"), self.cfg.dtype)
        return k.to(self.cfg.dtype), v.to(self.cfg.dtype)

    # -- the prefix cache: zero-copy banking and splicing --------------------

    def _materialize_prefix(self, payloads: list
                            ) -> tuple[torch.Tensor, torch.Tensor]:
        """A matched chain (pool block ids) -> its (k, v) prefix, gathered
        from the pool."""
        return self._gather_blocks(torch.tensor(
            [int(b) for b in payloads], dtype=torch.long,
            device=self.device))

    def _extract_prefix_raw(self, slot: int, p: int) -> tuple:
        raise RuntimeError("a paged engine banks block ids, not KV rows")

    def _bank_prefix_blocks(self, action) -> None:
        """Bank the slot's block-aligned prompt prefix as block ids: one
        pool reference per new block, no copy. The trie's reference
        keeps the block after the slot lets it go."""
        prompt = self._prompts.get(action.req_id)
        if prompt is None:
            return
        bt = self._bt
        aligned = (len(prompt) // bt) * bt
        ns = self._ns(action.req_id)
        if aligned <= 0 or self.kvcache.cached_prefix_len(
                prompt, max_tokens=aligned, namespace=ns) >= aligned:
            return
        row = self._tbl_host[action.slot]

        def payload(_i, s, _e):
            bid = int(row[s // bt])
            self._pool.ref([bid])
            return bid

        self.kvcache.insert(prompt, payload, max_tokens=aligned,
                            tenant=self._req_tenant.get(action.req_id),
                            namespace=ns)

    def _on_radix_evict(self, payload) -> None:
        """A trie eviction drops the trie's reference, through the
        deferred derefs: a chunk in flight may still write through a
        table row that names the block."""
        self._deferred_derefs.append(int(payload))
        self._flush_derefs()

    def _splice_shared(self, slot: int, ids: list[int]) -> None:
        """Point the slot's leading table entries at the cached blocks
        `ids` (one pool reference each) instead of the blocks admission
        reserved there; those were taken this step and no dispatched work
        names them, so they return to the pool at once. Funding already
        splices, so on the engine's own paths this changes nothing."""
        row = self._tbl_host[slot]
        displaced = []
        for i, bid in enumerate(ids):
            if int(row[i]) == int(bid):
                continue
            self._pool.ref([int(bid)])
            if row[i]:
                displaced.append(int(row[i]))
            row[i] = bid
        if displaced:
            self._pool.deref(displaced)

    def _dispatch_prefill_cont_wave(self, p: int, t: int,
                                    pairs: list[tuple]) -> torch.Tensor:
        for a, ids in pairs:
            self._splice_shared(a.slot, [int(b) for b in ids])
        self._tbl_sync()
        return super()._dispatch_prefill_cont_wave(p, t, pairs)

    def _dispatch_chunked_prefill(self, action) -> torch.Tensor:
        """The chunked chain with a cached head start: the reusable blocks
        are spliced into the table first (the same match and clamp as the
        base method's, which then gathers that chain)."""
        prompt = self._prompts[action.req_id]
        n, bt = len(prompt), self._bt
        if self.kvcache is not None and n - 1 >= bt:
            m = self.kvcache.match(prompt, max_tokens=n - 1,
                                   namespace=self._ns(action.req_id))
            done = m.tokens
            while done > 0 and self._chunk_plan_from(n, done) is None:
                done -= bt
            if done > 0:
                self._splice_shared(
                    action.slot, [int(b) for b in m.payloads[:done // bt]])
                self._tbl_sync()
            self.kvcache.release(m)
        return super()._dispatch_chunked_prefill(action)

    # -- admission: reservations and held prefills --------------------------

    def _need_blocks(self, action) -> int:
        """Blocks that fund the request to its end: every position a
        delivered token can occupy is below prompt_len + max_new_tokens
        (at most max_len)."""
        plen = len(self._prompts[action.req_id])
        max_new = self._max_new[action.req_id]
        return -(-min(self.max_len, plen + max_new) // self._bt)

    def _cached_prefix_match(self, action):
        """(match, block ids) of the cached prefix the dispatch will
        splice for this action, under the same clamp as the dispatch path
        it takes (the chunked chain's schedulable boundary, or the tail
        bucket inside max_len), so funding reserves only the uncached
        suffix. The match is pinned; the caller releases it. Accounting
        is the dispatch's."""
        if self.kvcache is None:
            return None, []
        prompt = self._prompts.get(action.req_id)
        bt = self._bt
        if prompt is None or len(prompt) - 1 < bt:
            return None, []
        n = len(prompt)
        m = self.kvcache.match(prompt, max_tokens=n - 1,
                               namespace=self._ns(action.req_id))
        p = m.tokens
        if n > action.bucket_len:
            while p > 0 and self._chunk_plan_from(n, p) is None:
                p -= bt
        else:
            while p > 0:
                t = self._tail_bucket(n - p)
                if t is None:
                    p = 0
                    break
                if p + t <= self.max_len:
                    break
                p -= bt
        return m, [int(b) for b in m.payloads[:p // bt]]

    def _fund(self, action) -> bool:
        """All-or-nothing reservation into the slot's table row, with the
        eviction valve. A cached prefix funds itself: the leading entries
        name the shared blocks (one pool reference each) and only the
        uncached suffix takes fresh blocks. When the pool is short,
        unpinned trie blocks are evicted (recomputable state) before the
        request is held; its own match stays pinned through the valve,
        and a held request probes the cache again at every retry."""
        need = self._need_blocks(action)
        m, cached = self._cached_prefix_match(action)
        alloc_need = need - len(cached)
        ids = self._pool.alloc(alloc_need)
        while ids is None and self.kvcache is not None:
            deficit = alloc_need - self._pool.free_blocks
            if self.kvcache.evict(max(1, deficit)) == 0:
                break   # nothing evictable: hold
            ids = self._pool.alloc(alloc_need)
        if ids is None:
            if m is not None:
                self.kvcache.release(m)
            return False
        if cached:
            self._pool.ref(cached)
        if m is not None:
            self.kvcache.release(m)
        row = self._tbl_host[action.slot]
        row[:] = 0
        row[:len(cached)] = cached
        row[len(cached):need] = ids
        return True

    def _admit_prefills(self, actions: list) -> list:
        self._flush_derefs()
        ready, held = [], []
        for a in self._held + list(actions):
            if self.scheduler.slot_request(a.slot) != a.req_id:
                continue   # cancelled while held
            (ready if self._fund(a) else held).append(a)
        self._held = held
        if ready:
            self._tbl_sync()
        return ready

    def _mask_unfunded(self, slot_req: list[int]) -> list[int]:
        if not self._held:
            return slot_req
        held = {a.slot for a in self._held}
        return [-1 if s in held else r for s, r in enumerate(slot_req)]

    def step(self) -> bool:
        if self._held:
            # held retry first: finished chunks free blocks, so drain the
            # pipeline, then fund held prefills before the scheduler hands
            # out anything new
            self._apply_cancellations()
            self._drain_pending()
            ready = self._admit_prefills([])
            if ready:
                self._run_prefill_actions(ready)
                return True
        return super().step()

    # -- release -------------------------------------------------------------

    def _release_slot_blocks(self, slot: int, sync: bool = True) -> None:
        """Zero the slot's table row (its later junk writes go to the
        trash block) and queue its blocks for return to the pool."""
        row = self._tbl_host[slot]
        ids = [int(b) for b in row if b]
        if not ids:
            return
        row[:] = 0
        if sync:
            self._tbl_sync()
        self._deferred_derefs.extend(ids)
        self._flush_derefs()

    def _flush_derefs(self) -> None:
        """Return released blocks to the pool once no chunk is in flight:
        a dispatched, unfetched chunk writes junk through the old table
        into them, so they may not be handed out before it lands."""
        if self._deferred_derefs and self._pending is None:
            self._pool.deref(self._deferred_derefs)
            self._deferred_derefs = []

    def _record_token(self, req_id: int, slot: int, token: int,
                      lp: float = 0.0, top=None,
                      first_token: bool = False) -> bool:
        freed = super()._record_token(req_id, slot, token, lp, top,
                                      first_token=first_token)
        if freed:
            self._release_slot_blocks(slot)
        return freed

    def _apply_cancellations(self) -> None:
        """Cancelled slots release their blocks; cancelled held prefills
        leave the held list."""
        super()._apply_cancellations()
        changed = False
        for s in range(self.n_slots):
            if self.scheduler.slot_request(s) < 0 and self._tbl_host[s].any():
                self._release_slot_blocks(s, sync=False)
                changed = True
        if changed:
            self._tbl_sync()
        if self._held:
            self._held = [a for a in self._held
                          if self.scheduler.slot_request(a.slot)
                          == a.req_id]

    def _drain_pending(self) -> None:
        super()._drain_pending()
        self._flush_derefs()

    def metrics(self) -> dict[str, Any]:
        out = super().metrics()
        out["kv_pool"] = self._pool.stats()
        out["held_prefills"] = len(self._held)
        return out

    def close(self) -> None:
        """The slab engine's close, and the block pool's buffers."""
        self._held = []
        self._deferred_derefs = []
        super().close()
        self._pool = None
