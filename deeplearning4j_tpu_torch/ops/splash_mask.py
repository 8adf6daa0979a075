"""Splash-attention masks and the block tables the splash kernels walk.

Port of the part of the JAX library's splash attention that
`deeplearning4j_tpu/ops/pallas_kernels.py` `_splash_call` (:609) builds on
the host (jax/experimental/pallas/ops/tpu/splash_attention, JAX 0.9.0):

  - the mask objects it constructs: `Mask` (splash_attention_mask.py :26),
    `MultiHeadMask` (:177), `CausalMask` (:295) and `FullMask` (:529);
  - `MaskInfo` (splash_attention_mask_info.py :33) and `_process_mask`
    (:518) on its static path with ``head_shards = q_seq_shards = 1``,
    with the grid shrinking of `_shrink_mask_info` (:965) and
    `_shrink_mask_info_dkv` (:1031), at the library's default block of
    128 (`BlockSizes.get_default`, splash_attention_kernel.py :537).

`_process_mask` yields, per unique head mask, a ``block_mask[r, i, j]`` in
{0 empty, 1 partial, 2 full} and a ``data_next`` that names the block to
fetch next: over (q block, kv step) for the forward and dQ tables, over
(q step, kv block) for the dK/dV table. The CUDA kernels read a compact
form derived from those tables, `BlockList`: per (head row, block of the
launch axis) the ordered non-empty blocks of the other axis and their
kinds. Kind-1 blocks evaluate the mask function on absolute positions
(`CausalMask`'s q >= k; `FullMask` has no partial blocks).

Nothing here imports JAX; `tests/test_torch_splash.py` holds the tables
against the library's own.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

# splash_attention_kernel.py :38: masked scores are filled with this value,
# not -inf, so a row's running max starts finite
DEFAULT_MASK_VALUE = -0.7 * float(np.finfo(np.float32).max)
BLOCK = 128  # BlockSizes.get_default(): q and kv blocks of every kernel


class Mask:
    """A lazy [q_len, kv_len] boolean mask (True = attend)."""

    @property
    def shape(self) -> Tuple[int, ...]:
        raise NotImplementedError

    def __getitem__(self, idx) -> np.ndarray:
        raise NotImplementedError

    def block_kinds(self, bq: int, bkv: int) -> np.ndarray:
        """[q_len / bq, kv_len / bkv] int32: 0 where a block is all False,
        2 where all True, 1 otherwise (`_process_mask` :691-711)."""
        nq, nk = self.shape[0] // bq, self.shape[1] // bkv
        out = np.zeros((nq, nk), np.int32)
        for i in range(nq):
            for j in range(nk):
                chunk = self[slice(i * bq, (i + 1) * bq),
                             slice(j * bkv, (j + 1) * bkv)]
                out[i, j] = 0 if not chunk.any() else (2 if chunk.all() else 1)
        return out


def _fill(sl: slice, size: int) -> slice:
    if sl.step not in (None, 1):
        raise NotImplementedError(f"Unsupported slice step: {sl}")
    start = 0 if sl.start is None else sl.start
    stop = size if sl.stop is None else sl.stop
    if not 0 <= start <= stop <= size:
        raise IndexError(f"slice {sl} out of range for {size}")
    return slice(start, stop)


def _two_slices(mask, idx):
    if len(idx) != 2 or not all(isinstance(s, slice) for s in idx):
        raise NotImplementedError(f"Unsupported slice: {idx}")
    return _fill(idx[0], mask.shape[0]), _fill(idx[1], mask.shape[1])


class FullMask(Mask):
    """Every query attends to every key."""

    def __init__(self, shape: Tuple[int, int]):
        self._shape = tuple(int(s) for s in shape)

    @property
    def shape(self):
        return self._shape

    def __getitem__(self, idx):
        i, j = _two_slices(self, idx)
        return np.ones((i.stop - i.start, j.stop - j.start), np.bool_)

    def block_kinds(self, bq, bkv):
        return np.full((self.shape[0] // bq, self.shape[1] // bkv), 2,
                       np.int32)

    def __eq__(self, other):
        return isinstance(other, FullMask) and self.shape == other.shape

    def __hash__(self):
        return hash((FullMask, self.shape))


class CausalMask(Mask):
    """Query q attends to keys k <= q + offset. It carries ``q_sequence``
    and ``mask_function``, so the kernels compute its partial blocks from
    positions instead of loading them (`_process_mask` :664-680)."""

    def __init__(self, shape: Tuple[int, int], offset: int = 0):
        self._shape = tuple(int(s) for s in shape)
        self.offset = int(offset)
        self.q_sequence = np.arange(self._shape[0], dtype=np.int32)

    @property
    def shape(self):
        return self._shape

    def mask_function(self, q_ids, kv_ids):
        return q_ids + self.offset >= kv_ids

    def __getitem__(self, idx):
        i, j = _two_slices(self, idx)
        rows = self.q_sequence[i]
        cols = np.arange(j.start, j.stop)
        return self.mask_function(rows[:, None], cols[None, :])

    def block_kinds(self, bq, bkv):
        # a block is non-empty where its last query reaches its first key,
        # full where its first query reaches its last key
        q_lo = np.arange(self.shape[0] // bq)[:, None] * bq + self.offset
        k_lo = np.arange(self.shape[1] // bkv)[None, :] * bkv
        any_ = q_lo + bq - 1 >= k_lo
        all_ = q_lo >= k_lo + bkv - 1
        return np.where(all_, 2, np.where(any_, 1, 0)).astype(np.int32)

    def __eq__(self, other):
        return (isinstance(other, CausalMask) and self.shape == other.shape
                and self.offset == other.offset)

    def __hash__(self):
        return hash((CausalMask, self.shape, self.offset))


class MultiHeadMask(Mask):
    """One mask per head, all of one shape."""

    def __init__(self, masks: Sequence[Mask]):
        masks = tuple(masks)
        if not masks:
            raise ValueError("Unsupported empty tuple of masks")
        if any(isinstance(m, MultiHeadMask) for m in masks):
            raise ValueError("Nesting MultiHeadMasks is not supported")
        if any(m.shape != masks[0].shape for m in masks):
            raise ValueError("every head mask must have one shape")
        self.masks = masks

    @property
    def shape(self):
        return (len(self.masks),) + self.masks[0].shape


class MaskInfo(NamedTuple):
    """The library's MaskInfo fields that these masks produce (their
    ``mask_next`` and ``partial_mask_blocks`` are None: `FullMask` has no
    partial block and `CausalMask` computes its own)."""
    data_next: np.ndarray   # [rows, i, j] int32
    block_mask: np.ndarray  # [rows, i, j] int32 in {0, 1, 2}
    q_sequence: Optional[np.ndarray]


def _next_nonzero(flags: np.ndarray, values: np.ndarray) -> np.ndarray:
    """For each position of a flat iteration order, ``values`` at the first
    flagged position at or after it, wrapping to the first flagged one:
    the loop of `_get_mask_info_for_shard` (:269-285) written out."""
    idx = np.flatnonzero(flags)
    if idx.size == 0:
        return np.zeros_like(values)
    at = np.searchsorted(idx, np.arange(flags.size))
    nxt = np.where(at < idx.size, idx[np.minimum(at, idx.size - 1)], idx[0])
    return values[nxt]


def _shrink(block_mask, data_next, is_dkv):
    """`_shrink_mask_info` (fwd, dq: each row's non-empty columns, padded at
    the end) or `_shrink_mask_info_dkv` (each column's non-empty rows,
    padded at the front); padding entries are 0 in both arrays."""
    bm, dn = block_mask[0], data_next[0]
    if is_dkv:
        bm, dn = bm.T, dn.T
    lists = [np.flatnonzero(row) for row in bm]
    width = max(len(x) for x in lists)
    new_bm = np.zeros((len(lists), width), np.int32)
    new_dn = np.zeros((len(lists), width), np.int32)
    for r, cols in enumerate(lists):
        at = slice(width - len(cols), width) if is_dkv else slice(0, len(cols))
        new_bm[r, at] = bm[r, cols]
        new_dn[r, at] = dn[r, cols]
    if is_dkv:
        new_bm, new_dn = new_bm.T, new_dn.T
    return new_bm[None].copy(), new_dn[None].copy()


def process_mask(mask: MultiHeadMask, block_shape: Tuple[int, int],
                 is_dkv: bool) -> MaskInfo:
    """`_process_mask` (:518) with one head shard and one q shard: the
    block kinds of each unique head mask (one row when all heads share a
    mask), ``data_next`` in the library's iteration order ((row, q, kv),
    or (kv, row, q) for dK/dV), then the grid shrunk when one mask serves
    every head."""
    H, q_len, kv_len = mask.shape
    bq, bkv = block_shape
    if q_len % bq or kv_len % bkv:
        raise ValueError(f"blocks {block_shape} must divide the mask "
                         f"{(q_len, kv_len)}")
    unique = list(dict.fromkeys(mask.masks))
    rows = unique if len(unique) == 1 else list(mask.masks)
    block_mask = np.stack([m.block_kinds(bq, bkv) for m in rows])
    R, nq, nk = block_mask.shape
    if is_dkv:  # iterate (kv, row, q); data_next names the q block
        order = block_mask.transpose(2, 0, 1)
        values = np.broadcast_to(np.arange(nq, dtype=np.int32), order.shape)
        data_next = _next_nonzero(order.reshape(-1) != 0,
                                  values.reshape(-1)).reshape(
            order.shape).transpose(1, 2, 0)
    else:  # iterate (row, q, kv); data_next names the kv block
        values = np.broadcast_to(np.arange(nk, dtype=np.int32),
                                 block_mask.shape)
        data_next = _next_nonzero(block_mask.reshape(-1) != 0,
                                  values.reshape(-1)).reshape(
            block_mask.shape)
    data_next = np.ascontiguousarray(data_next, np.int32)
    q_sequence = None
    if len(unique) == 1:
        block_mask, data_next = _shrink(block_mask, data_next, is_dkv)
        q_sequence = getattr(unique[0], "q_sequence", None)
    return MaskInfo(data_next=data_next, block_mask=block_mask,
                    q_sequence=q_sequence)


@dataclass(frozen=True)
class BlockList:
    """What one splash kernel walks: for head row r (0 when the heads share
    a mask) and block i of its launch axis (q blocks for the forward and
    dQ kernels, kv blocks for dK/dV), ``counts[r, i]`` non-empty blocks of
    the other axis, ``blocks[r, i, :counts]`` in the library's order
    (ascending), with ``kinds`` 1 (partial) or 2 (full)."""
    counts: np.ndarray  # [R, n] int32
    blocks: np.ndarray  # [R, n, W] int32
    kinds: np.ndarray   # [R, n, W] int32

    @classmethod
    def from_info(cls, info: MaskInfo, is_dkv: bool) -> "BlockList":
        bm, dn = info.block_mask, info.data_next
        if is_dkv:  # walk each kv block's column of q steps
            bm, dn = bm.transpose(0, 2, 1), dn.transpose(0, 2, 1)
        R, n, _ = bm.shape
        live = bm != 0
        counts = live.sum(axis=2).astype(np.int32)
        W = max(int(counts.max()), 1)
        blocks = np.zeros((R, n, W), np.int32)
        kinds = np.zeros((R, n, W), np.int32)
        for r in range(R):
            for i in range(n):
                at = np.flatnonzero(live[r, i])
                blocks[r, i, :at.size] = dn[r, i, at]
                kinds[r, i, :at.size] = bm[r, i, at]
        return cls(counts, blocks, kinds)

    def dense(self, n_other: int, is_dkv: bool) -> np.ndarray:
        """The block kinds [R, q blocks, kv blocks] this list encodes."""
        R, n, _ = self.blocks.shape
        out = np.zeros((R, n, n_other), np.int32)
        for r in range(R):
            for i in range(n):
                c = self.counts[r, i]
                out[r, i, self.blocks[r, i, :c]] = self.kinds[r, i, :c]
        return out.transpose(0, 2, 1).copy() if is_dkv else out


class SplashTables:
    """The three mask infos `make_splash_mha` builds for
    ``MultiHeadMask([CausalMask | FullMask] * H)`` at block 128, their
    compact block lists, and, per device, the lists as int32 tensors."""

    def __init__(self, L: int, H: int, causal: bool):
        if L % BLOCK:
            raise ValueError(f"splash attention needs L % {BLOCK} == 0, "
                             f"got L={L}")
        self.L, self.H, self.causal = L, H, causal
        head = CausalMask((L, L)) if causal else FullMask((L, L))
        mask = MultiHeadMask([head] * H)
        self.fwd_info = process_mask(mask, (BLOCK, BLOCK), is_dkv=False)
        self.dq_info = process_mask(mask, (BLOCK, BLOCK), is_dkv=False)
        self.dkv_info = process_mask(mask, (BLOCK, BLOCK), is_dkv=True)
        self.lists = {"fwd": BlockList.from_info(self.fwd_info, False),
                      "dq": BlockList.from_info(self.dq_info, False),
                      "dkv": BlockList.from_info(self.dkv_info, True)}
        self._on: dict = {}

    @property
    def rows(self) -> int:
        return self.lists["fwd"].counts.shape[0]

    def block_grid(self, which: str) -> np.ndarray:
        """[R, q blocks, kv blocks] kinds, rebuilt from list ``which``."""
        n = self.L // BLOCK
        return self.lists[which].dense(n, which == "dkv")

    def on(self, device: torch.device, which: str):
        """(counts, blocks, kinds) of list ``which`` as int32 tensors on
        ``device``, made once per device."""
        key = (str(device), which)
        if key not in self._on:
            bl = self.lists[which]
            self._on[key] = tuple(torch.from_numpy(a).to(device)
                                  for a in (bl.counts, bl.blocks, bl.kinds))
        return self._on[key]

    def grid_on(self, device: torch.device, which: str) -> torch.Tensor:
        """`block_grid` of list ``which`` as int8 on ``device`` (the plain
        versions' view of the table), made once per device."""
        key = (str(device), which, "grid")
        if key not in self._on:
            self._on[key] = torch.from_numpy(
                self.block_grid(which).astype(np.int8)).to(device)
        return self._on[key]


@functools.lru_cache(maxsize=16)
def splash_tables(L: int, H: int, causal: bool) -> SplashTables:
    """The tables of ``MultiHeadMask([CausalMask|FullMask((L, L))] * H)``,
    made once per (L, H, causal)."""
    return SplashTables(int(L), int(H), bool(causal))
