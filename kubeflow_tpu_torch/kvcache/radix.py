"""Radix prefix index over token sequences -> ref-counted KV blocks
(counterpart of kubeflow_tpu/kvcache/radix.py `RadixKVCache`).

Many requests share a prefix (a system prompt, a few-shot template, a
chat session's history), so the KV one prefill computes is the KV the
next request with that prefix needs. This module is the index over that
sharing:

  - token sequences are cut into blocks of `block_tokens` tokens; a
    cached prefix is a root-to-node chain of a trie whose edges are the
    exact token tuples of one block each (fixed-size blocks make every
    edge the same length, so the radix tree is a block trie);
  - each node owns one block payload (opaque here: the slab engine
    stores the block's KV tensors, the paged engine a pool block id),
    a reference count and an LRU tick;
  - `match()` returns the longest cached block-aligned prefix and pins
    its chain (refs + 1 per block), so eviction never reclaims KV an
    admission is about to read; the caller releases it after use;
  - `insert()` extends chains block by block, storing only blocks not
    cached yet, and evicts LRU leaves with refs == 0 to stay within
    `capacity_blocks`: interior nodes are never evicted (that would
    orphan their descendants), pinned nodes never, and when nothing is
    evictable the insert stops caching;
  - per-tenant accounting (hits, misses, reused tokens, inserted
    blocks) is recorded by explicit `record_hit`/`record_miss` calls,
    not inside match(): the engine may match a prefix and then find no
    legal continuation for it, which is a miss.

One root per namespace (the engines' adapter index, 0 for the base
model): a prefix computed through one adapter is wrong KV for another. Capacity and eviction are shared across namespaces. The
module touches no device and is testable with plain Python payloads;
each hit, miss, insert and eviction also counts in the process's
`kvcache_prefix_events_total` (obs/metrics.py).
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Sequence

from kubeflow_tpu_torch.obs import metrics as obs_metrics


class Block:
    """One cached block: `payload` is opaque, `refs` counts live pins,
    `tick` is the LRU clock."""

    __slots__ = ("payload", "refs", "tick")

    def __init__(self, payload: Any, tick: int):
        self.payload = payload
        self.refs = 0
        self.tick = tick


class _Node:
    __slots__ = ("key", "parent", "children", "block")

    def __init__(self, key: tuple | None, parent: "_Node | None",
                 block: Block | None):
        self.key = key                      # edge label from the parent
        self.parent = parent
        self.children: dict[tuple, _Node] = {}
        self.block = block


class MatchResult:
    """A pinned longest cached prefix: `tokens` matched (a multiple of
    block_tokens) and the `payloads` in chain order. Hold it while the
    payloads must stay alive; `RadixKVCache.release()` unpins. Using
    fewer blocks than matched is fine: the pin covers the whole chain."""

    __slots__ = ("tokens", "payloads", "_nodes", "_released")

    def __init__(self, tokens: int, payloads: list[Any],
                 nodes: list[_Node]):
        self.tokens = tokens
        self.payloads = payloads
        self._nodes = nodes
        self._released = False

    @property
    def n_blocks(self) -> int:
        return len(self._nodes)


class RadixKVCache:
    """Thread-safe block-granular prefix KV index (see the module
    docstring); `check_invariants()` asserts its invariants."""

    def __init__(self, block_tokens: int, capacity_blocks: int):
        if block_tokens < 1:
            raise ValueError("block_tokens must be >= 1")
        if capacity_blocks < 1:
            raise ValueError("capacity_blocks must be >= 1")
        self.block_tokens = int(block_tokens)
        self.capacity_blocks = int(capacity_blocks)
        self._roots: dict[Any, _Node] = {}
        self._n_blocks = 0
        self._tick = 0
        self._lock = threading.RLock()
        # per-tenant rows; tenant None counts under "" so no row has a
        # null key
        self._acct: dict[str, dict[str, int]] = {}
        self._evicted_blocks = 0
        self._inserted_blocks = 0
        #: paged engines: called with a payload (a pool block id) at
        #: every eviction, before the payload is dropped, so evicting
        #: returns the block to the pool
        self.evict_hook: Callable[[Any], None] | None = None
        self._pool = None

    def attach_pool(self, pool) -> None:
        """Bind the block pool whose free blocks stats() reports (paged
        engines); without one, stats() reports this trie's headroom."""
        with self._lock:
            self._pool = pool

    # -- structure -----------------------------------------------------------

    def _touch(self, node: _Node) -> None:
        self._tick += 1
        node.block.tick = self._tick

    def _root_for(self, namespace: Any, create: bool) -> "_Node | None":
        root = self._roots.get(namespace)
        if root is None and create:
            root = _Node(None, None, None)
            self._roots[namespace] = root
        return root

    def _limit(self, tokens: Sequence[int], max_tokens: int | None) -> int:
        return (len(tokens) if max_tokens is None
                else min(len(tokens), max_tokens))

    def match(self, tokens: Sequence[int], *,
              max_tokens: int | None = None,
              namespace: Any = None) -> MatchResult:
        """Longest cached block-aligned prefix of `tokens`, at most
        `max_tokens` (the engine passes len(prompt) - 1: one tail token
        must remain to give the next token's logits). Pins and LRU-
        touches every block of the chain; always pair with release()."""
        bt = self.block_tokens
        limit = self._limit(tokens, max_tokens)
        with self._lock:
            node = self._root_for(namespace, create=False)
            if node is None:
                return MatchResult(0, [], [])
            nodes: list[_Node] = []
            pos = 0
            while pos + bt <= limit:
                child = node.children.get(tuple(tokens[pos:pos + bt]))
                if child is None:
                    break
                nodes.append(child)
                node = child
                pos += bt
            for n in nodes:
                n.block.refs += 1
                self._touch(n)
            return MatchResult(pos, [n.block.payload for n in nodes],
                               nodes)

    def release(self, m: MatchResult) -> None:
        """Unpin a match (idempotent)."""
        with self._lock:
            if m._released:
                return
            m._released = True
            for n in m._nodes:
                n.block.refs -= 1

    def cached_prefix_len(self, tokens: Sequence[int], *,
                          max_tokens: int | None = None,
                          namespace: Any = None) -> int:
        """How many leading tokens a match() would return now, without
        pinning or touching the LRU order (a probe must not keep dead
        entries warm)."""
        bt = self.block_tokens
        limit = self._limit(tokens, max_tokens)
        with self._lock:
            node = self._root_for(namespace, create=False)
            if node is None:
                return 0
            pos = 0
            while pos + bt <= limit:
                child = node.children.get(tuple(tokens[pos:pos + bt]))
                if child is None:
                    break
                node = child
                pos += bt
            return pos

    def insert(self, tokens: Sequence[int],
               payload_fn: Callable[[int, int, int], Any], *,
               max_tokens: int | None = None,
               tenant: str | None = None,
               namespace: Any = None) -> int:
        """Cache the block-aligned prefix of `tokens` (up to
        `max_tokens`), extending the chain already there.
        `payload_fn(block_index, start, end)` is called only for blocks
        not cached yet. Returns the number of new blocks. Stops early
        (still a valid chain) when capacity is full and nothing is
        evictable."""
        bt = self.block_tokens
        limit = self._limit(tokens, max_tokens)
        new_blocks = 0
        with self._lock:
            node = self._root_for(namespace, create=True)
            path: set[int] = {id(node)}
            pos = 0
            while pos + bt <= limit:
                key = tuple(tokens[pos:pos + bt])
                child = node.children.get(key)
                if child is None:
                    if self._n_blocks >= self.capacity_blocks \
                            and not self._evict_one(path):
                        break
                    self._tick += 1
                    block = Block(payload_fn(pos // bt, pos, pos + bt),
                                  self._tick)
                    child = _Node(key, node, block)
                    node.children[key] = child
                    self._n_blocks += 1
                    self._inserted_blocks += 1
                    new_blocks += 1
                    self._row(tenant)["inserted_blocks"] += 1
                    obs_metrics.PREFIX_EVENTS.inc(event="insert")
                else:
                    self._touch(child)
                node = child
                path.add(id(node))
                pos += bt
        return new_blocks

    def _evict_one(self, protect: set[int]) -> bool:
        """Reclaim the LRU evictable leaf (refs == 0, no children, not on
        the insertion path `protect`). False when nothing is evictable."""
        victim: _Node | None = None
        stack = list(self._roots.values())
        while stack:
            n = stack.pop()
            stack.extend(n.children.values())
            if (n.block is not None and not n.children
                    and n.block.refs == 0 and id(n) not in protect
                    and (victim is None
                         or n.block.tick < victim.block.tick)):
                victim = n
        if victim is None:
            return False
        del victim.parent.children[victim.key]
        if self.evict_hook is not None:
            self.evict_hook(victim.block.payload)
        victim.block.payload = None   # drop the block's tensors now
        self._n_blocks -= 1
        self._evicted_blocks += 1
        obs_metrics.PREFIX_EVENTS.inc(event="evict")
        return True

    def evict(self, n_blocks: int) -> int:
        """Evict up to `n_blocks` LRU unpinned leaves: the paged engine's
        admission valve (with an evict_hook each eviction returns a pool
        block; an evicted prefix is recomputed from its tokens). Returns
        how many were evicted."""
        freed = 0
        with self._lock:
            while freed < n_blocks and self._evict_one(set()):
                freed += 1
        return freed

    # -- accounting ----------------------------------------------------------

    def _row(self, tenant: str | None) -> dict[str, int]:
        key = tenant if tenant is not None else ""
        row = self._acct.get(key)
        if row is None:
            row = {"hits": 0, "misses": 0, "reused_tokens": 0,
                   "inserted_blocks": 0}
            self._acct[key] = row
        return row

    def record_hit(self, tenant: str | None, reused_tokens: int) -> None:
        """One admission reused `reused_tokens` cached tokens (called
        once the engine committed to the continuation)."""
        with self._lock:
            row = self._row(tenant)
            row["hits"] += 1
            row["reused_tokens"] += reused_tokens
        obs_metrics.PREFIX_EVENTS.inc(event="hit")

    def record_miss(self, tenant: str | None) -> None:
        with self._lock:
            self._row(tenant)["misses"] += 1
        obs_metrics.PREFIX_EVENTS.inc(event="miss")

    @property
    def n_blocks(self) -> int:
        with self._lock:
            return self._n_blocks

    def stats(self) -> dict[str, Any]:
        """Global counters and per-tenant rows. hit_rate is over recorded
        hits and misses; pinned_blocks (refs > 0) and evictable_blocks
        (unpinned leaves) are live gauges; free_blocks/watermark_frac are
        the attached pool's, else this trie's headroom."""
        with self._lock:
            hits = sum(r["hits"] for r in self._acct.values())
            misses = sum(r["misses"] for r in self._acct.values())
            reused = sum(r["reused_tokens"] for r in self._acct.values())
            pinned = evictable = 0
            stack = list(self._roots.values())
            while stack:
                n = stack.pop()
                stack.extend(n.children.values())
                if n.block is None:
                    continue
                if n.block.refs > 0:
                    pinned += 1
                elif not n.children:
                    evictable += 1
            if self._pool is not None:
                free = self._pool.free_blocks
                cap = self._pool.capacity_blocks
            else:
                free = self.capacity_blocks - self._n_blocks
                cap = self.capacity_blocks
            return {
                "block_tokens": self.block_tokens,
                "capacity_blocks": self.capacity_blocks,
                "blocks": self._n_blocks,
                "pinned_blocks": pinned,
                "evictable_blocks": evictable,
                "free_blocks": free,
                "watermark_frac": round(free / cap, 4) if cap else 0.0,
                "hits": hits,
                "misses": misses,
                "hit_rate": (round(hits / (hits + misses), 4)
                             if hits + misses else None),
                "reused_tokens": reused,
                "inserted_blocks": self._inserted_blocks,
                "evicted_blocks": self._evicted_blocks,
                "per_tenant": {k: dict(v)
                               for k, v in sorted(self._acct.items())},
            }

    def payloads(self) -> list[Any]:
        """Every cached block's payload (in no particular order)."""
        with self._lock:
            out = []
            stack = list(self._roots.values())
            while stack:
                n = stack.pop()
                stack.extend(n.children.values())
                if n.block is not None:
                    out.append(n.block.payload)
            return out

    def clear(self) -> None:
        """Drop every block; refuses while a match is still pinned."""
        with self._lock:
            pinned = sum(self._pinned_count(r)
                         for r in self._roots.values())
            if pinned:
                raise RuntimeError(
                    f"clear() with {pinned} pinned blocks outstanding")
            self._roots = {}
            self._n_blocks = 0

    def _pinned_count(self, node: _Node) -> int:
        n = 1 if node.block is not None and node.block.refs > 0 else 0
        return n + sum(self._pinned_count(c)
                       for c in node.children.values())

    # -- invariants ------------------------------------------------------------

    def check_invariants(self) -> None:
        with self._lock:
            count = 0
            roots = set(map(id, self._roots.values()))
            stack = list(self._roots.values())
            while stack:
                n = stack.pop()
                stack.extend(n.children.values())
                if id(n) in roots:
                    assert n.block is None
                    continue
                count += 1
                assert n.block is not None and n.block.refs >= 0
                assert n.block.payload is not None, \
                    "evicted block still reachable"
                assert len(n.key) == self.block_tokens
                assert n.parent.children[n.key] is n
            assert count == self._n_blocks, (count, self._n_blocks)
            assert count <= self.capacity_blocks


class StageMatchResult:
    """A pinned longest prefix across every stage's chain (the
    stage-sharded engine's MatchResult): `tokens` is the shortest
    per-stage match (a block is usable only while every stage holds it),
    `payloads[i]` the tuple of per-stage payloads of block i. Release
    through StagePartitionedKVCache.release."""

    __slots__ = ("tokens", "payloads", "_inner")

    def __init__(self, tokens: int, payloads: list[tuple],
                 inner: list[MatchResult]):
        self.tokens = tokens
        self.payloads = payloads
        self._inner = inner

    @property
    def n_blocks(self) -> int:
        return len(self.payloads)


class StagePartitionedKVCache:
    """A stage-aware view over one RadixKVCache (the JAX
    `StagePartitionedKVCache`): every logical block is stored once per
    pipeline stage, stage s's slice of the [L, ...] rows, under the
    namespace (ns, stage), so KV banked for one stage never reaches
    another stage's slab. Capacity, eviction and the LRU clock are the
    inner cache's (a logical block costs n_stages blocks; the engine
    scales the capacity by n_stages); per-tenant insert counts are stage
    0's alone, so they stay logical.

    match, insert and cached_prefix_len take the minimum across stages:
    the shared eviction may cut one stage's chain before another's, and
    a prefix is reusable only where every stage still holds its slice."""

    def __init__(self, inner: RadixKVCache, n_stages: int):
        if n_stages < 1:
            raise ValueError("n_stages must be >= 1")
        self.inner = inner
        self.n_stages = int(n_stages)

    @property
    def block_tokens(self) -> int:
        return self.inner.block_tokens

    @property
    def capacity_blocks(self) -> int:
        return self.inner.capacity_blocks

    @property
    def n_blocks(self) -> int:
        return self.inner.n_blocks

    def match(self, tokens: Sequence[int], *,
              max_tokens: int | None = None,
              namespace: Any = None) -> StageMatchResult:
        ms = [self.inner.match(tokens, max_tokens=max_tokens,
                               namespace=(namespace, s))
              for s in range(self.n_stages)]
        pos = min(m.tokens for m in ms)
        nb = pos // self.block_tokens
        payloads = [tuple(m.payloads[i] for m in ms) for i in range(nb)]
        return StageMatchResult(pos, payloads, ms)

    def release(self, m: StageMatchResult) -> None:
        for im in m._inner:
            self.inner.release(im)

    def cached_prefix_len(self, tokens: Sequence[int], *,
                          max_tokens: int | None = None,
                          namespace: Any = None) -> int:
        return min(self.inner.cached_prefix_len(
            tokens, max_tokens=max_tokens, namespace=(namespace, s))
            for s in range(self.n_stages))

    def insert(self, tokens: Sequence[int],
               payload_fn: Callable[[int, int, int], Any], *,
               max_tokens: int | None = None,
               tenant: str | None = None,
               namespace: Any = None) -> int:
        """payload_fn(block_index, start, end) returns the tuple of the
        block's per-stage payloads, made once per block (every stage
        inserts the same new blocks); stage s stores element s under its
        own namespace. Returns stage 0's count of new blocks."""
        memo: dict[int, Any] = {}

        def payload_at(i, a, b):
            if i not in memo:
                memo[i] = payload_fn(i, a, b)
            return memo[i]

        new0 = 0
        for s in range(self.n_stages):
            n = self.inner.insert(
                tokens, lambda i, a, b, s=s: payload_at(i, a, b)[s],
                max_tokens=max_tokens, tenant=tenant if s == 0 else None,
                namespace=(namespace, s))
            if s == 0:
                new0 = n
        return new0

    def record_hit(self, tenant: str | None, reused_tokens: int) -> None:
        self.inner.record_hit(tenant, reused_tokens)

    def record_miss(self, tenant: str | None) -> None:
        self.inner.record_miss(tenant)

    def stats(self) -> dict[str, Any]:
        out = self.inner.stats()
        out["stages"] = self.n_stages
        # the physical blocks count every stage's copy; capacity planning
        # wants the logical count beside the hit rates
        out["logical_blocks"] = out["blocks"] // self.n_stages
        return out

    def clear(self) -> None:
        self.inner.clear()

    def check_invariants(self) -> None:
        self.inner.check_invariants()
