"""Port parity: the paged KV pool's metadata and prefix trie.

The cases of tests/test_kvpool.py's pool unit tests, rewritten for the
port's constructor ({layer: (Hkv, Dh, itemsize)} instead of state arrays),
each run on the JAX `KVPool` (paged mode: metadata only) and on the port's
`KVPool` side by side: the same calls must give the same block ids,
refcounts and occupancy, and the asserts of the JAX suite.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from deeplearning4j_tpu.inference.kvpool import KVPool as JPool
from deeplearning4j_tpu_torch.inference.kvpool import SCRATCH_BLOCK, KVPool

LAYERS, HKV, DH = 2, 2, 8


def _pools(block, budget_bytes, cache_dtype=None):
    """(JAX pool, port pool) over 2 layers of Hkv=2, Dh=8 f32 K/V."""
    attn = {f"l{i}": {"k": jnp.zeros((2, 64, HKV, DH)),
                      "v": jnp.zeros((2, 64, HKV, DH)),
                      "pos": jnp.zeros((2,), jnp.int32)}
            for i in range(LAYERS)}
    jp = JPool(attn, block=block, budget_bytes=budget_bytes, paged=True,
               cache_dtype=cache_dtype)
    tp = KVPool({f"l{i}": (HKV, DH, 4) for i in range(LAYERS)}, block=block,
                budget_bytes=budget_bytes, cache_dtype=cache_dtype)
    return jp, tp


def _state(pool):
    return (pool.capacity_blocks, pool.free_blocks, pool.used_blocks,
            pool.outstanding_refs(), pool.refcounts(),
            pool.reclaimable_blocks())


@pytest.mark.parametrize("cache_dtype", [None, "int8"])
def test_pool_capacity_respects_budget_and_reserves_scratch(cache_dtype):
    # bytes/block: 2 layers * (k+v) * block4 * 2 * 8 * 4B = 1024 (f32);
    # int8 rows: 2 * 8 B + 2 f32 scales = 24 B a row, 384 a block
    jp, tp = _pools(4, 5 * 1024, cache_dtype)
    assert tp.bytes_per_block == jp.bytes_per_block \
        == (1024 if cache_dtype is None else 384)
    assert tp.capacity_blocks == jp.capacity_blocks
    assert (tp.capacity_blocks + 1) * tp.bytes_per_block <= 5 * 1024
    if cache_dtype is None:
        # 5 blocks of budget = scratch + 4 usable
        assert tp.capacity_blocks == 4
    start, ids = tp.insert(list(range(16)))  # 4 blocks
    assert (start, ids) == jp.insert(list(range(16)))
    assert start == 0 and len(ids) == 4
    assert SCRATCH_BLOCK not in ids  # block 0 is never handed out
    assert tp.used_blocks == 4 == jp.used_blocks


def test_pool_match_insert_release_and_refcounts():
    jp, tp = _pools(4, 32 * 1024)
    toks = [1, 2, 3, 4, 5, 6, 7, 8]
    for pool in (jp, tp):
        assert pool.match(toks, max_blocks=2) == (0, [], None)
    start, ids = tp.insert(toks)
    assert (start, ids) == jp.insert(toks)
    assert (start, len(ids)) == (0, 2)
    (n, got, node), (jn, jgot, jnode) = (
        p.match(toks + [9, 9, 9], max_blocks=5) for p in (tp, jp))
    assert (n, got) == (jn, jgot) and n == 2 and got == ids
    assert tp.outstanding_refs() == 1
    assert tp.refcounts() == {ids[1]: 1}  # deepest matched node holds it
    # a second reader shares the same blocks (refcount, not a copy)
    (_, got2, node2), (_, _, jnode2) = (p.match(toks, max_blocks=2)
                                        for p in (tp, jp))
    assert got2 == ids and tp.outstanding_refs() == 2
    assert _state(tp) == _state(jp)
    for pool, nodes in ((tp, (node, node2)), (jp, (jnode, jnode2))):
        for nd in nodes:
            pool.release(nd)
        assert pool.outstanding_refs() == 0 and pool.refcounts() == {}
        with pytest.raises(AssertionError):
            pool.release(nodes[0])
    # extending reuses the shared prefix: only the suffix allocates
    start2, ids2 = tp.insert(toks + [9, 9, 9, 9])
    assert (start2, ids2) == jp.insert(toks + [9, 9, 9, 9])
    assert start2 == 2 and len(ids2) == 1 and ids2[0] not in ids
    st = tp.stats()
    assert st["trie"] == {"nodes": 3, "max_depth_blocks": 3,
                          "pinned_refs": 0}
    assert st["prefix"]["lookups"] == 3 and st["prefix"]["hits"] == 2
    assert st["prefix"]["hit_blocks"] == 4
    assert st["prefix"]["published_blocks"] == 3


def test_pool_lru_eviction_skips_locked_and_interior_nodes():
    jp, tp = _pools(4, 5 * 1024)
    assert tp.capacity_blocks == 4
    for pool in (jp, tp):
        _, a = pool.insert([1] * 8)   # chain of 2: interior + leaf
        _, b = pool.insert([2] * 4)
        _, c = pool.insert([3] * 4)
        assert pool.used_blocks == 4
    (n, _, node), (_, _, jnode) = (p.match([2] * 4, max_blocks=1)
                                   for p in (tp, jp))  # pin b's leaf
    assert n == 1
    _, d = tp.insert([4] * 4)  # full: must evict an unlocked leaf
    assert jp.insert([4] * 4)[1] == d and len(d) == 1
    # b is locked; a's interior block survives only if its leaf does not
    for pool in (jp, tp):
        assert pool.match([2] * 4, max_blocks=1)[0] == 1  # b still cached
        assert pool.used_blocks <= pool.capacity_blocks
        assert pool.match([1] * 8, max_blocks=2)[0] == 1  # a's leaf went
    assert tp.stats()["prefix"]["evicted_blocks"] == 1
    assert _state(tp) == _state(jp)
    tp.release(node)
    jp.release(jnode)


def test_pool_full_of_referenced_blocks_fails_allocation_gracefully():
    jp, tp = _pools(4, 3 * 1024)
    assert tp.capacity_blocks == 2
    for pool in (jp, tp):
        _, ids = pool.insert([1] * 8)
        assert len(ids) == 2
        _, _, node = pool.match([1] * 8, max_blocks=2)
        start, new = pool.insert([9] * 8)  # nothing evictable: best-effort
        assert start == 0 and new == []
        assert pool.alloc() is None  # the engine must preempt
        assert pool.reclaimable_blocks() == 0
        pool.release(node)
        assert pool.reclaimable_blocks() == 2


def test_pool_adopt_is_ownership_transfer_and_frees_by_eviction():
    """The paged publish: a slot's own pages are indexed where they lie;
    blocks the trie already holds are skipped (the caller frees its own
    copies), and eviction later returns adopted pages to the free list."""
    jp, tp = _pools(4, 9 * 1024)
    for pool in (jp, tp):
        assert pool.capacity_blocks == 8
        owned = [pool.alloc() for _ in range(3)]
        toks = list(range(12))
        assert pool.adopt(toks, owned) == owned  # nothing cached yet
        assert pool.used_blocks == 3 and pool.free_blocks == 5
        # a second slot with the same three blocks and one more: only the
        # new block is adopted, the slot frees its three copies
        again = [pool.alloc() for _ in range(4)]
        assert pool.adopt(toks + [7] * 4, again) == [again[3]]
        for bid in again[:3]:
            pool.free_block(bid)
        assert pool.used_blocks == 4 and pool.reclaimable_blocks() == 8
        # the whole pool again: the free list first, then every cached
        # block by eviction, leaves first
        got = [pool.alloc() for _ in range(8)]
        assert sorted(got) == list(range(1, 9))
        assert pool.alloc() is None
    assert tp.stats()["prefix"]["evicted_blocks"] == 4
    assert _state(tp) == _state(jp)


def test_pool_random_traffic_matches_jax_pool():
    """A seeded mix of alloc, free, match, release, adopt and insert
    through a pool small enough to evict: both pools hand out and evict
    the same block ids throughout."""
    rng = np.random.default_rng(0)
    jp, tp = _pools(2, 13 * 512)  # 512 bytes a 2-position block
    assert tp.capacity_blocks == jp.capacity_blocks == 12
    owned, pins = [], []
    for step in range(400):
        op = rng.integers(0, 6)
        toks = [int(t) for t in rng.integers(0, 3, 2 * rng.integers(1, 5))]
        if op == 0:
            got = (tp.alloc(), jp.alloc())
            assert got[0] == got[1]
            if got[0] is not None:
                owned.append(got[0])
        elif op == 1 and owned:
            bid = owned.pop(int(rng.integers(0, len(owned))))
            tp.free_block(bid)
            jp.free_block(bid)
        elif op == 2:
            (n, ids, node), (jn, jids, jnode) = (p.match(toks, 4)
                                                 for p in (tp, jp))
            assert (n, ids) == (jn, jids)
            if node is not None:
                pins.append((node, jnode))
        elif op == 3 and pins:
            node, jnode = pins.pop(int(rng.integers(0, len(pins))))
            tp.release(node)
            jp.release(jnode)
        elif op == 4:
            k = len(toks) // 2
            if len(owned) >= k:
                mine = owned[:k]
                adopted = tp.adopt(toks, mine)
                assert adopted == jp.adopt(toks, mine)
                owned = [b for b in owned if b not in adopted]
        else:
            assert tp.insert(toks) == jp.insert(toks)
        assert _state(tp) == _state(jp), step
    prefix = tp.stats()["prefix"]
    assert prefix["evicted_blocks"] > 0 and prefix["published_blocks"] > 0
    assert prefix["hits"] > 0
