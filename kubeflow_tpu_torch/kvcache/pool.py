"""KV block pool of paged serving (counterpart of kubeflow_tpu/kvcache/
pool.py).

The paged engine (serving/paged.py) keeps KV in fixed-size blocks of
`block_tokens` tokens drawn from one pool, stitched into logical rows by
per-slot block tables. This module mints the pool's tensors
(`make_block_pool_buffers`) and owns the host allocator over block ids: a
LIFO free list, per-block reference counts and the free-block watermark.
The engine owns the tensors from `device_buffers()` on and asks the pool
only for ids.

Block 0 is the trash sentinel: it is never allocated, every empty table
entry points at it, and every junk write (prefill right-pad past a
reservation, decode rows of inactive slots, positions at or past
max_len) lands there and is never read. The free-list order is the JAX
pool's, so both hand out the same ids in the same order.
"""

from __future__ import annotations

import threading
from typing import Any

import numpy as np
import torch


def make_block_pool_buffers(n_layers: int, n_blocks: int, block_tokens: int,
                            n_kv_heads: int, head_dim: int,
                            dtype: torch.dtype,
                            kv_quantize: str | None = None,
                            device="cpu") -> dict:
    """The pool's tensors: k/v [L, N, bt, kv, hd] (int8 with f32
    per-token scales [L, N, bt, kv], or `dtype`), zeroed on `device`."""
    shape = (n_layers, n_blocks, block_tokens, n_kv_heads, head_dim)
    if kv_quantize == "int8":
        return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_s": torch.zeros(shape[:-1], device=device),
                "v_s": torch.zeros(shape[:-1], device=device)}
    if kv_quantize is not None:
        raise ValueError(f"unknown kv_quantize {kv_quantize!r}")
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


class BlockPool:
    """Host-side allocator over a fixed population of KV blocks;
    thread-safe. Methods trade in integer block ids."""

    def __init__(self, n_layers: int, n_blocks: int, block_tokens: int,
                 n_kv_heads: int, head_dim: int, dtype: torch.dtype,
                 kv_quantize: str | None = None):
        if n_blocks < 2:
            raise ValueError("n_blocks must be >= 2 (block 0 is the "
                             "trash sentinel)")
        if block_tokens < 1:
            raise ValueError("block_tokens must be >= 1")
        self.n_layers = int(n_layers)
        self.n_blocks = int(n_blocks)
        self.block_tokens = int(block_tokens)
        self.n_kv_heads = int(n_kv_heads)
        self.head_dim = int(head_dim)
        self.dtype = dtype
        self.kv_quantize = kv_quantize
        self._lock = threading.Lock()
        # LIFO: recently freed blocks are reused first
        self._free: list[int] = list(range(self.n_blocks - 1, 0, -1))
        self._refs = np.zeros(self.n_blocks, np.int32)
        self._refs[0] = 1          # the sentinel is held for good
        self._buffers_made = False
        self.allocs = 0
        self.frees = 0
        self.alloc_failures = 0

    def device_buffers(self, device="cpu") -> dict:
        """The pool's tensors, minted once; the caller owns them."""
        with self._lock:
            if self._buffers_made:
                raise RuntimeError("BlockPool.device_buffers() is "
                                   "single-shot: the engine cache owns "
                                   "the tensors after construction")
            self._buffers_made = True
        return make_block_pool_buffers(
            self.n_layers, self.n_blocks, self.block_tokens,
            self.n_kv_heads, self.head_dim, self.dtype,
            kv_quantize=self.kv_quantize, device=device)

    @property
    def capacity_blocks(self) -> int:
        """Allocatable blocks (the sentinel excluded)."""
        return self.n_blocks - 1

    @property
    def free_blocks(self) -> int:
        with self._lock:
            return len(self._free)

    @property
    def watermark_frac(self) -> float:
        """Free fraction of the allocatable blocks: 1.0 is an empty pool."""
        cap = self.capacity_blocks
        with self._lock:
            return len(self._free) / cap if cap else 0.0

    def alloc(self, n: int) -> list[int] | None:
        """Take `n` blocks, each at refcount 1, or None (and nothing
        taken) when fewer than `n` are free: two admissions each holding
        half of what they need would deadlock."""
        if n < 0:
            raise ValueError("alloc count must be >= 0")
        with self._lock:
            if n > len(self._free):
                self.alloc_failures += 1
                return None
            ids = [self._free.pop() for _ in range(n)]
            for b in ids:
                self._refs[b] = 1
            self.allocs += n
            return ids

    def ref(self, ids) -> None:
        """One more reference to each id."""
        with self._lock:
            for b in ids:
                if not 0 < b < self.n_blocks:
                    raise ValueError(f"block id {b} out of range")
                if self._refs[b] <= 0:
                    raise ValueError(f"ref of free block {b}")
                self._refs[b] += 1

    def deref(self, ids) -> int:
        """One reference less on each id; blocks at zero go back to the
        free list. Returns how many were freed."""
        freed = 0
        with self._lock:
            for b in ids:
                if not 0 < b < self.n_blocks:
                    raise ValueError(f"block id {b} out of range")
                if self._refs[b] <= 0:
                    raise ValueError(f"deref of free block {b}")
                self._refs[b] -= 1
                if self._refs[b] == 0:
                    self._free.append(b)
                    freed += 1
            self.frees += freed
        return freed

    def refcount(self, block_id: int) -> int:
        with self._lock:
            return int(self._refs[block_id])

    def stats(self) -> dict[str, Any]:
        cap = self.capacity_blocks
        with self._lock:
            free = len(self._free)
            return {
                "pool_blocks": cap,
                "block_tokens": self.block_tokens,
                "free_blocks": free,
                "used_blocks": cap - free,
                "watermark_frac": round(free / cap, 4) if cap else 0.0,
                "allocs": self.allocs,
                "frees": self.frees,
                "alloc_failures": self.alloc_failures,
            }

    def check_invariants(self) -> None:
        with self._lock:
            free = set(self._free)
            assert len(free) == len(self._free), "duplicate free ids"
            assert 0 not in free, "sentinel on the free list"
            assert self._refs[0] >= 1, "sentinel lost its permanent ref"
            for b in range(1, self.n_blocks):
                held = self._refs[b] > 0
                assert held != (b in free), (
                    f"block {b}: refs={self._refs[b]} free={b in free}")
