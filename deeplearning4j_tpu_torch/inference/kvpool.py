"""Paged KV pool metadata — port of the paged mode of
deeplearning4j_tpu/inference/kvpool.py.

The engine owns the page arrays; this object is pure host metadata: the
pool's sizing from a byte budget, and the free list of page ids. Page 0
is the scratch page (masked and padded writes land there, padded table
entries read it), so real pages are numbered from 1. The prefix trie,
refcounts and eviction come with a later slice.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

SCRATCH_BLOCK = 0


class KVPool:
    """Free-list block pool over per-layer K/V page arrays.

    ``layers``: {layer: (Hkv, Dh, itemsize)} of the model dtype.
    ``cache_dtype="int8"`` sizes int8 rows plus one f32 scale per
    (position, head). The budget covers every page the engine allocates,
    scratch included: ``(capacity_blocks + 1) * bytes_per_block <=
    budget_bytes``."""

    def __init__(self, layers: Dict[str, Tuple[int, int, int]], *,
                 block: int, budget_bytes: int,
                 cache_dtype: Optional[str] = None):
        if block < 1:
            raise ValueError(f"block must be >= 1, got {block}")
        if cache_dtype not in (None, "int8"):
            raise ValueError(f"cache_dtype must be None or 'int8', got "
                             f"{cache_dtype!r}")
        self.block = int(block)
        self.cache_dtype = cache_dtype
        self.budget_bytes = int(budget_bytes)
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
        self._free: List[int] = list(range(1, self.capacity_blocks + 1))

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def used_blocks(self) -> int:
        return self.capacity_blocks - len(self._free)

    def alloc(self) -> Optional[int]:
        """One free page id, owned by the caller until `free_block`; None
        when the pool is empty."""
        return self._free.pop() if self._free else None

    def free_block(self, block_id: int) -> None:
        if block_id == SCRATCH_BLOCK:
            raise ValueError("the scratch block is never owned")
        self._free.append(block_id)

    def stats(self) -> dict:
        return {"capacity_blocks": self.capacity_blocks,
                "block_positions": self.block,
                "bytes_per_block": self.bytes_per_block,
                "free_blocks": len(self._free),
                "used_blocks": self.used_blocks,
                "utilization": round(self.used_blocks / self.capacity_blocks, 4)
                if self.capacity_blocks else 0.0}


def blocks_for(positions: int, block: int) -> int:
    """Blocks of ``block`` positions that cover ``positions``."""
    return -(-positions // block)
