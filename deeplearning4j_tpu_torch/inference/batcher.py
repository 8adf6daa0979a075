"""Shape buckets — port of `pow2_buckets` and `bucket_for` from
deeplearning4j_tpu/inference/batcher.py (the request micro-batcher comes
with the /predict slice).

The decode engine pads prefill chunks and block-table widths to these
buckets, as the JAX engine does, so both engines run the same shapes.
"""
from __future__ import annotations

from typing import List


def pow2_buckets(max_batch: int) -> List[int]:
    """Ascending powers of two below ``max_batch``, then ``max_batch``."""
    out, b = [], 1
    while b < max_batch:
        out.append(b)
        b *= 2
    out.append(max_batch)
    return out


def bucket_for(n: int, buckets: List[int]) -> int:
    """Smallest bucket covering ``n`` (buckets ascending)."""
    return next(b for b in buckets if b >= n)
