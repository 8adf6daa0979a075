"""Block-pooled KV store: the paged pool's metadata and the contiguous
mode's side prefix pool, both indexed by one prefix trie — port of
deeplearning4j_tpu/inference/kvpool.py (`_Node` :97, `KVPool` :121,
`gather_blocks` :517, `scatter_blocks` :545).

Two modes, as in the JAX package:

**Paged** (``paged=True``): the engine owns the page arrays; this object
is pure host metadata: the pool's sizing from a byte budget, the free
list of page ids, and a radix trie over full blocks of prompt tokens (one
node per block, children keyed by the block's token tuple), whose nodes
own the pages of cached prefixes. Page 0 is the scratch page (masked and
padded writes land there, padded table entries read it), so real pages
are numbered from 1. A page is in exactly one of three places: the free
list, a slot (owned by the slot that `alloc`-ed it, until `free_block`
or `adopt`), or a trie node.

**Contiguous** (``paged=False``): each decode slot has its own stripe of
K/V rows, and the pool is a side cache of finished prompts: ``storage``
holds per-layer K/V blocks ``[capacity + 1, block, Hkv, Dh]`` (row 0
scratch) on the engine's device. `gather_blocks` restores a matched chain
into a slot's stripe rows ``[0, n * block)``; `scatter_blocks` publishes
a finished prompt's stripe rows into the blocks `insert` allocated. Both
are eager indexed copies on the engine's stream.

A slot that restores a prefix pins the deepest matched node (`match` ...
`release`); locked nodes and interior nodes are never evicted, unlocked
leaves are LRU-evicted when the free list runs dry.

Reuse is valid only for prefixes anchored at position 0: cached keys are
stored rotated at their absolute positions, so a prefix from position 0 is
the same bits in every request that shares it.

Observability: with a ``metrics`` registry the pool keeps the JAX
package's series (``prefix_cache_evicted_blocks_total``; paged: the
``kv_pool_blocks_*`` gauges, ``kv_pool_utilization``, the device bytes;
contiguous: ``prefix_cache_used_bytes`` and ``_capacity_bytes``), and
with a ``tracer`` it stamps ``pool_publish`` and ``pool_evict`` instants
on the ``kvpool`` track. `alloc` fires the ``pool.alloc`` failpoint
seam (`failpoints.py`).

Tiering (JAX :115, :202-206, :242-254, :492-497): with ``tier`` set (a
`kvtier.TierManager`, armed by the engine before any traffic) every
trie node carries the chain hash of its block (`kvtier.chain_hash` over
its parent's hash and its tokens), inserts and adopts publish it to the
prefix directory (``note_resident``), and an LRU eviction offers the
victim's page to the tier (``offer_spill``) before the page returns to
the free list. A tierless pool computes no hash.

Threading: every mutation happens on the engine's scheduler thread,
between steps, so the pool takes no lock of its own.
"""
from __future__ import annotations

import heapq
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from . import failpoints

SCRATCH_BLOCK = 0


class _Node:
    """One full block of a cached prefix: ``key`` is the block's token
    tuple (the edge label from the parent), ``block_id`` its page.
    ``lock`` counts live sequences pinning this node. ``hash``: the
    block's chain hash when a tier is armed (None otherwise, "" at the
    root)."""

    __slots__ = ("key", "block_id", "parent", "children", "last_access",
                 "lock", "hash")

    def __init__(self, key: Tuple[int, ...], block_id: int,
                 parent: Optional["_Node"]):
        self.key = key
        self.block_id = block_id
        self.parent = parent
        self.children: Dict[Tuple[int, ...], "_Node"] = {}
        self.last_access = 0
        self.lock = 0
        self.hash: Optional[str] = None


class KVPool:
    """Refcounted block pool + trie prefix index over per-layer K/V pages.

    ``layers``: {layer: (Hkv, Dh, itemsize)} of the model dtype.
    ``cache_dtype="int8"`` (paged only) sizes int8 rows plus one f32 scale
    per (position, head). The budget covers every block the pool holds,
    scratch included: ``(capacity_blocks + 1) * bytes_per_block <=
    budget_bytes``. ``paged=False`` allocates ``storage`` in ``dtype`` on
    ``device``; the paged pool allocates nothing.

    ``shard_factor``: the tensor-parallel size when the head axis is split
    over ranks (`inference/sharding.py`, JAX `shard_factor` :136-187).
    ``layers`` keeps the whole model's Hkv; each rank holds Hkv /
    shard_factor heads of every block, so ``budget_bytes`` is a per-rank
    budget and ``bytes_per_block`` a rank's cost: at a fixed per-rank
    budget the pool holds shard_factor times the blocks. The side pool's
    ``storage`` holds the rank's heads only. The free list, trie and
    refcounts are one logical pool, whatever the rank count."""

    def __init__(self, layers: Dict[str, Tuple[int, int, int]], *,
                 block: int, budget_bytes: int,
                 cache_dtype: Optional[str] = None, paged: bool = True,
                 dtype: torch.dtype = torch.float32,
                 device: torch.device = torch.device("cpu"),
                 shard_factor: int = 1, metrics=None, tracer=None):
        if block < 1:
            raise ValueError(f"block must be >= 1, got {block}")
        if cache_dtype not in (None, "int8"):
            raise ValueError(f"cache_dtype must be None or 'int8', got "
                             f"{cache_dtype!r}")
        if cache_dtype and not paged:
            raise ValueError("cache_dtype='int8' requires paged mode (the "
                             "contiguous side pool stores the model's own "
                             "K/V dtype)")
        self.block = int(block)
        self.paged = bool(paged)
        self.cache_dtype = cache_dtype
        self.budget_bytes = int(budget_bytes)
        self.shard_factor = max(1, int(shard_factor))
        sf = self.shard_factor
        if any(hkv % sf for hkv, _, _ in layers.values()):
            raise ValueError(f"shard_factor={sf} does not divide every "
                             "layer's Hkv")
        layers = {n: (hkv // sf, dh, its)
                  for n, (hkv, dh, its) in layers.items()}
        per_block = 0
        for hkv, dh, itemsize in layers.values():
            if cache_dtype == "int8":
                row_bytes = hkv * dh + hkv * 4
            else:
                row_bytes = itemsize * hkv * dh
            per_block += 2 * self.block * row_bytes
        self.bytes_per_block = per_block
        total = self.budget_bytes // per_block if per_block else 0
        self.capacity_blocks = max(0, int(total) - 1)
        self.storage: Dict[str, Dict[str, torch.Tensor]] = {}
        if self.capacity_blocks > 0 and not self.paged:
            n = self.capacity_blocks + 1
            self.storage = {
                name: {kv: torch.zeros((n, self.block, hkv, dh), dtype=dtype,
                                       device=device) for kv in ("k", "v")}
                for name, (hkv, dh, _) in layers.items()}
        self._free: List[int] = list(range(1, self.capacity_blocks + 1))
        self._root = _Node((), SCRATCH_BLOCK, None)
        self._root.hash = ""
        #: optional kvtier.TierManager (see the module docstring)
        self.tier = None
        self._clock = 0  # logical LRU clock
        # prefix-cache counters, read through stats()
        self.lookups = 0
        self.hits = 0
        self.hit_blocks = 0
        self.evicted_blocks = 0
        self.published_blocks = 0  # blocks indexed by adopt and insert
        self._tracer = tracer
        self._metrics = metrics
        self._g_live = self._m_used = None
        if metrics is not None:
            self._m_evicted = metrics.counter(
                "prefix_cache_evicted_blocks_total")
            if self.paged:
                # live = every allocated block (slot-owned and cached),
                # free = the free list; the ratio is taken at snapshot time
                self._g_live = metrics.gauge("kv_pool_blocks_live")
                self._g_free = metrics.gauge("kv_pool_blocks_free")
                cap = metrics.gauge("kv_pool_blocks_capacity")
                cap.set(self.capacity_blocks)
                metrics.ratio("kv_pool_utilization", self._g_live, cap)
                metrics.gauge("kv_pool_device_bytes").set(
                    (self.capacity_blocks + 1) * per_block)
                self._g_dev_used = metrics.gauge("kv_pool_device_used_bytes")
                self._sync_gauges()
            else:
                self._m_used = metrics.gauge("prefix_cache_used_bytes")
                metrics.gauge("prefix_cache_capacity_bytes").set(
                    (self.capacity_blocks + 1) * per_block
                    if self.capacity_blocks else 0)

    def _sync_gauges(self) -> None:
        if self._g_live is not None:
            self._g_live.set(self.used_blocks)
            self._g_free.set(len(self._free))
            self._g_dev_used.set(self.used_blocks * self.bytes_per_block)
        elif self._m_used is not None:
            self._m_used.set(self.used_bytes)

    def _hash_and_publish(self, node: _Node) -> None:
        """Chain-hash a freshly attached node and publish it to the tier's
        directory (a tierless pool pays nothing, not even the sha1)."""
        tier = self.tier
        if tier is None:
            return
        parent_hash = node.parent.hash
        if parent_hash is None:
            return  # the ancestor predates arming: the branch stays unhashed
        from .kvtier import chain_hash
        node.hash = chain_hash(parent_hash, node.key)
        tier.note_resident(node.hash, parent_hash, node.key)

    # -- accounting ---------------------------------------------------------
    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def used_blocks(self) -> int:
        """Every allocated block: slot-owned and trie-cached."""
        return self.capacity_blocks - len(self._free)

    @property
    def used_bytes(self) -> int:
        """Bytes of the allocated blocks (the eviction pressure signal)."""
        return self.used_blocks * self.bytes_per_block

    def _walk(self):
        stack = list(self._root.children.values())
        while stack:
            n = stack.pop()
            yield n
            stack.extend(n.children.values())

    def outstanding_refs(self) -> int:
        """Live sequence references across the trie: zero when no admitted
        sequence holds a prefix pin."""
        return sum(n.lock for n in self._walk())

    def refcounts(self) -> Dict[int, int]:
        """block_id -> live sequence references on its node."""
        return {n.block_id: n.lock for n in self._walk() if n.lock}

    def stats(self) -> dict:
        """Occupancy, the trie's shape (nodes = indexed blocks, pinned
        refs, deepest chain) and the prefix-cache counters."""
        nodes = depth = refs = 0
        # list() copies each child dict in one step under the GIL, so a
        # reader on another thread (the server's /info) never iterates a
        # dict the scheduler is changing
        stack = [(c, 1) for c in list(self._root.children.values())]
        while stack:
            n, d = stack.pop()
            nodes += 1
            refs += n.lock
            depth = max(depth, d)
            stack.extend((c, d + 1) for c in list(n.children.values()))
        return {"capacity_blocks": self.capacity_blocks,
                "block_positions": self.block,
                "bytes_per_block": self.bytes_per_block,
                "free_blocks": len(self._free),
                "used_blocks": self.used_blocks,
                "utilization": round(self.used_blocks / self.capacity_blocks, 4)
                if self.capacity_blocks else 0.0,
                "trie": {"nodes": nodes, "max_depth_blocks": depth,
                         "pinned_refs": refs},
                "prefix": {"lookups": self.lookups, "hits": self.hits,
                           "hit_blocks": self.hit_blocks,
                           "published_blocks": self.published_blocks,
                           "evicted_blocks": self.evicted_blocks}}

    # -- prefix lookup ------------------------------------------------------
    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    def _walk_prefix(self, tokens: Sequence[int], max_blocks: int
                     ) -> Tuple[_Node, List[int]]:
        """The deepest cached prefix of ``tokens`` (full blocks only, at
        most ``max_blocks``), ticking ``last_access`` on the path: the
        deepest node and the block ids along the path."""
        node, ids = self._root, []
        B = self.block
        while len(ids) < max_blocks:
            child = node.children.get(
                tuple(int(t) for t in tokens[len(ids) * B:(len(ids) + 1) * B]))
            if child is None:
                break
            node = child
            node.last_access = self._tick()
            ids.append(node.block_id)
        return node, ids

    def cached_blocks(self, tokens: Sequence[int], max_blocks: int) -> int:
        """How many full blocks of ``tokens`` are cached (at most
        ``max_blocks``), taking no reference and counting no lookup."""
        return len(self._walk_prefix(tokens, max_blocks)[1])

    def match(self, tokens: Sequence[int], max_blocks: int
              ) -> Tuple[int, List[int], Optional[_Node]]:
        """Longest cached prefix of ``tokens``, at most ``max_blocks`` full
        blocks: ``(n_blocks, block_ids, node)``, taking one reference on
        the deepest matched node (give it back with `release`). No hit
        returns ``(0, [], None)`` and takes no reference."""
        node, ids = self._walk_prefix(tokens, max_blocks)
        self.lookups += 1
        if not ids:
            return 0, [], None
        self.hits += 1
        self.hit_blocks += len(ids)
        node.lock += 1
        return len(ids), ids, node

    def release(self, node: _Node) -> None:
        if node.lock <= 0:
            raise AssertionError("release() without a matching reference")
        node.lock -= 1

    # -- the pool as the live decode cache ----------------------------------
    def alloc(self) -> Optional[int]:
        """One free page for a slot's table, LRU-evicting unreferenced
        cached blocks when the free list is empty. ``None`` means every
        page is owned by a live slot or pinned: the scheduler must
        preempt. The page is owned by the caller until `free_block` or
        `adopt`."""
        failpoints.fire("pool.alloc")  # chaos seam: injected OOM/crash
        if not self._free:
            self._evict_lru()
        bid = self._free.pop() if self._free else None
        self._sync_gauges()
        return bid

    def free_block(self, block_id: int) -> None:
        """Return a slot-owned page (never a trie-owned one: eviction
        frees those) to the free list."""
        if block_id == SCRATCH_BLOCK:
            raise ValueError("the scratch block is never owned")
        self._free.append(block_id)
        self._sync_gauges()

    def adopt(self, tokens: Sequence[int], block_ids: Sequence[int]
              ) -> List[int]:
        """Publish by reference: index the full blocks of ``tokens``, where
        ``block_ids[j]`` is the slot-owned page already holding block
        ``j``'s K/V. Walks the cached prefix, attaches a node for each
        missing block that takes over the caller's page, and returns the
        adopted ids: the caller must not free those (the trie owns them
        now)."""
        B = self.block
        n_total = len(tokens) // B
        node, matched = self._walk_prefix(tokens, n_total)
        adopted: List[int] = []
        for j in range(len(matched), n_total):
            key = tuple(int(t) for t in tokens[j * B:(j + 1) * B])
            child = _Node(key, int(block_ids[j]), node)
            node.children[key] = child
            self._hash_and_publish(child)
            node = child
            node.last_access = self._tick()
            adopted.append(int(block_ids[j]))
        self.published_blocks += len(adopted)
        if adopted and self._tracer is not None:
            self._tracer.instant("pool_publish", track="kvpool",
                                 args={"blocks": len(adopted),
                                       "used_blocks": self.used_blocks,
                                       "zero_copy": True})
        return adopted

    def reclaimable_blocks(self) -> int:
        """Free blocks plus the cached blocks eviction could free (all but
        those on a pinned path): the scheduler's admission gate."""
        pinned = set()
        for n in self._walk():
            if n.lock:
                p = n
                while p is not None and id(p) not in pinned:
                    pinned.add(id(p))
                    p = p.parent
        return len(self._free) + sum(
            1 for n in self._walk() if id(n) not in pinned)

    # -- insertion / eviction -----------------------------------------------
    def insert(self, tokens: Sequence[int]) -> Tuple[int, List[int]]:
        """Index ``tokens`` (a multiple of ``block`` long) on fresh pages:
        walk the cached prefix, then allocate a page for each missing
        block. Returns ``(start_block, new_block_ids)``; the caller fills
        those pages. Best effort: when eviction cannot free a page, the
        rest of the suffix is not cached."""
        B = self.block
        n_total = len(tokens) // B
        node, matched = self._walk_prefix(tokens, n_total)
        start, new_ids, pinned = len(matched), [], []
        if node is not self._root:
            node.lock += 1  # the extension point stays out of eviction
            pinned.append(node)
        try:
            need = (n_total - start) - len(self._free)
            if need > 0:
                self._evict_lru(need)
            for j in range(start, n_total):
                bid = self.alloc()
                if bid is None:
                    break
                key = tuple(int(t) for t in tokens[j * B:(j + 1) * B])
                child = _Node(key, bid, node)
                node.children[key] = child
                self._hash_and_publish(child)
                node = child
                node.last_access = self._tick()
                node.lock += 1  # and so does the fresh chain
                pinned.append(node)
                new_ids.append(bid)
        finally:
            for n in pinned:
                n.lock -= 1
        self.published_blocks += len(new_ids)
        self._sync_gauges()
        if new_ids and self._tracer is not None:
            self._tracer.instant("pool_publish", track="kvpool",
                                 args={"blocks": len(new_ids),
                                       "used_blocks": self.used_blocks})
        return start, new_ids

    def _evict_lru(self, want: int = 1) -> None:
        """Free up to ``want`` pages, least recently used unlocked leaves
        first, in one trie walk (a parent whose last child goes becomes a
        candidate). Interior nodes are never evicted directly: their
        children would become unreachable."""
        heap = [(n.last_access, id(n), n) for n in self._walk()
                if not n.children and not n.lock]
        heapq.heapify(heap)
        freed = 0
        while heap and freed < want:
            _, _, victim = heapq.heappop(heap)
            parent = victim.parent
            del parent.children[victim.key]
            if self.tier is not None:
                # the tier stages the page's rows before the id returns
                # to the free list: its copy is queued ahead of any later
                # write into the page
                self.tier.offer_spill(victim.hash, victim.block_id)
            self._free.append(victim.block_id)
            freed += 1
            if parent is not self._root and not parent.children \
                    and not parent.lock:
                heapq.heappush(heap, (parent.last_access, id(parent), parent))
        self.evicted_blocks += freed
        if freed and self._metrics is not None:
            self._m_evicted.inc(freed)
            self._sync_gauges()
        if freed and self._tracer is not None:
            self._tracer.instant("pool_evict", track="kvpool",
                                 args={"blocks": freed,
                                       "used_blocks": self.used_blocks})


def gather_blocks(states, slot: int, idx: torch.Tensor, storage, *,
                  block: int) -> None:
    """Contiguous prefix restore (JAX `gather_blocks` :517): copy pool
    blocks ``idx`` (a long tensor on the storage's device, padded past
    the hit with `SCRATCH_BLOCK`) into ``slot``'s stripe rows ``[0,
    len(idx) * block)`` of every layer, in place. Padded rows land past
    the restored position, causally invisible until the cold suffix's
    prefill overwrites them. The position itself is the engine's host
    mirror (positions ship with every dispatch)."""
    n = idx.shape[0] * block
    for name, store in storage.items():
        st = states[name]
        for kv in ("k", "v"):
            st[kv][slot, :n] = store[kv][idx].reshape(
                (n,) + tuple(st[kv].shape[2:]))


def scatter_blocks(states, slot: int, start: int, idx: torch.Tensor,
                   storage, *, block: int) -> None:
    """Contiguous publish (JAX `scatter_blocks` :545): copy ``slot``'s
    stripe rows ``[start * block, (start + len(idx)) * block)`` of every
    layer into pool blocks ``idx`` (exact, no padding), in place. A
    restore gathered from those blocks earlier was ordered before this
    write on the same stream, so no reader sees a half-written block."""
    nb = idx.shape[0]
    for name, store in storage.items():
        st = states[name]
        for kv in ("k", "v"):
            rows = st[kv][slot, start * block:(start + nb) * block]
            store[kv][idx] = rows.reshape((nb, block) + tuple(rows.shape[1:]))


def blocks_for(positions: int, block: int) -> int:
    """Blocks of ``block`` positions that cover ``positions``."""
    return -(-positions // block)
