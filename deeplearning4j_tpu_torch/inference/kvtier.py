"""Hierarchical KV cache tiering: device pool -> pinned host RAM -> disk
— a port of deeplearning4j_tpu/inference/kvtier.py (`chain_hash` :71,
`prompt_chain` :82, `encode_block` :105, `decode_block` :125,
`TierEntry` :151, `TierManager` :162).

When the paged pool's LRU evicts an unreferenced prefix leaf, the
:class:`TierManager` takes the block's page rows (every layer's K and V
``[block, Hkv, Dh]``, plus the int8 scale rows) into a host-RAM ring
under a ``host_cache_mb`` budget, demotes host overflow to CRC-framed
block files (`serving/durable.py`: a process killed mid-spill leaves a
torn file that reads as a miss, never as wrong bytes) under
``disk_cache_mb``, and promotes blocks back into the pool on a prefix
hit through the pool's adopt path (a table remap).

On the card the bytes move so that a decode step never waits on a tier
copy, and neither thread synchronizes the device:

  - **spill**: the engine's capture hook (called from the pool's
    `_evict_lru`, before the freed page returns to the free list) copies
    the block's rows into staging tensors on the engine's stream — one
    stack of the rows of each dtype and shape — and records a CUDA event
    behind the copy; any later dispatch that reuses the page is queued
    after it. The worker thread takes every queued spill its credit
    covers, waits on the last one's event alone, copies every stack into
    pinned host memory with one call on a stream of its own and waits on
    that copy's event. The engine fills the caching host allocator with
    the host budget's worth of such pinned blocks when it arms the tier,
    so no spill page-locks memory under traffic. Every torch call of the
    worker hands the GIL to the scheduler thread and waits to get it
    back, so the worker makes a few calls a batch, not a few a row;
  - **restore**: the worker stages a promotion's rows in pinned host
    memory (a disk or peer payload is pinned first); the scheduler copies
    them into the pool's page tensors in place, on its own stream, so
    the copy runs before the first replay that reads the block (the
    captured graphs hold those tensors' addresses).

On CPU tensors both sides are plain copies. Every byte moves under a
pacing credit the scheduler grants each iteration (`pace`; JAX's grant,
``tier_chunk_kib`` = 512 KiB, 8 times that when idle): a spill burst
past the queue is dropped (a cold recompute later, counted), never a
stall.

The payload (`encode_block`) is the JAX package's byte for byte — the
same JSON header, dtype names and base64 page rows — so a block that
one package's replica spills decodes in the other's.

The same metadata is the fleet prefix directory: every insert, spill
and eviction appends a sequence-numbered event (``GET
/prefix/directory``), mapping content-addressed block-hash chains to
tiers; a peer fetches a chain over HTTP (``POST /prefix/fetch`` ->
``GET /prefix/block``).

Threading: the dynamic state lives under one condition's lock; the
scheduler thread calls the notify/offer/drain seams, the worker thread
moves bytes, HTTP threads read payloads and insert fetched blocks. The
resource ledger (`analysis/runtime.py`) tracks every host page, disk
block and directory entry by chain hash.
"""
from __future__ import annotations

import base64
import hashlib
import json
import os
import threading
import time
from collections import OrderedDict, deque
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..analysis.runtime import ledger_check_zero, ledger_note
from ..serving.durable import read_block_file, write_block_file
from . import failpoints
from .metrics import MetricsRegistry
from .trace import FlightRecorder

__all__ = ["TIER_LEDGER_KINDS", "BLOCK_SUFFIX", "StagedRows", "TierEntry",
           "TierManager", "chain_hash", "prompt_chain", "encode_block",
           "decode_block"]

#: the ledger kinds this subsystem owns
TIER_LEDGER_KINDS = ("host_page", "disk_block", "directory_entry")

#: disk store file suffix (one CRC-framed file per chain hash)
BLOCK_SUFFIX = ".kvb"

# payload dtype names (numpy's, as the JAX package writes them)
_DTYPES = {"float32": torch.float32, "float16": torch.float16,
           "bfloat16": torch.bfloat16, "float64": torch.float64,
           "int8": torch.int8, "uint8": torch.uint8, "int16": torch.int16,
           "int32": torch.int32, "int64": torch.int64}
_NAMES = {v: k for k, v in _DTYPES.items()}


def chain_hash(parent: str, key: Sequence[int]) -> str:
    """Content address of one trie block: sha1 over the parent block's
    hash and this block's tokens (int64). Identical prompts hash to
    identical chains on every replica, in either package."""
    h = hashlib.sha1()
    h.update(parent.encode("ascii"))
    h.update(b"|")
    h.update(np.asarray(list(key), np.int64).tobytes())
    return h.hexdigest()


def prompt_chain(tokens: Sequence[int], block: int,
                 max_blocks: Optional[int] = None) -> List[str]:
    """Hash chain of every full block of ``tokens``."""
    n = len(tokens) // block
    if max_blocks is not None:
        n = min(n, max_blocks)
    out: List[str] = []
    parent = ""
    for j in range(n):
        parent = chain_hash(parent, tokens[j * block:(j + 1) * block])
        out.append(parent)
    return out


def _row_bytes(a: torch.Tensor) -> Tuple[str, List[int], bytes]:
    """(numpy's dtype name, shape, raw bytes) of a page row."""
    t = a.detach().to("cpu").contiguous()
    raw = t.view(torch.uint8).numpy().tobytes() if t.numel() else b""
    return _NAMES[t.dtype], list(t.shape), raw


def _nbytes(pages: Dict[str, Dict]) -> int:
    return sum(int(a.nbytes) for pks in pages.values() for a in pks.values())


def encode_block(entry: "TierEntry", pages: Dict[str, Dict]) -> bytes:
    """Serialize one tiered block (the entry's metadata and its page rows)
    to the payload the disk store frames and ``/prefix/block`` serves."""
    doc_pages = {}
    for lk, pks in pages.items():
        doc_pages[lk] = {}
        for pk, a in pks.items():
            name, shape, raw = _row_bytes(a)
            doc_pages[lk][pk] = {"dtype": name, "shape": shape,
                                 "data": base64.b64encode(raw).decode("ascii")}
    doc = {"v": 1, "hash": entry.hash, "parent": entry.parent,
           "depth": entry.depth, "prefix": list(entry.prefix),
           "pages": doc_pages}
    return json.dumps(doc).encode("utf-8")


def decode_block(payload: bytes):
    """Inverse of :func:`encode_block`: ``(meta, pages)`` with the rows as
    CPU tensors, or ``None`` on any structural defect (a corrupt payload
    is a miss)."""
    try:
        doc = json.loads(payload.decode("utf-8"))
        if doc.get("v") != 1:
            return None
        prefix = [int(t) for t in doc["prefix"]]
        depth = int(doc["depth"])
        pages: Dict[str, Dict[str, torch.Tensor]] = {}
        for lk, pks in doc["pages"].items():
            pages[lk] = {}
            for pk, spec in pks.items():
                dt = _DTYPES[spec["dtype"]]
                raw = bytearray(base64.b64decode(spec["data"],
                                                 validate=True))
                shape = [int(s) for s in spec["shape"]]
                n = int(np.prod(shape)) if shape else 1
                if len(raw) != n * torch.empty((), dtype=dt).element_size():
                    return None
                t = (torch.frombuffer(raw, dtype=dt) if raw
                     else torch.empty((0,), dtype=dt))
                pages[lk][pk] = t.reshape(shape)
        meta = {"hash": str(doc["hash"]), "parent": str(doc["parent"]),
                "depth": depth, "prefix": prefix}
        return meta, pages
    except (KeyError, ValueError, TypeError, RuntimeError,
            AttributeError):
        return None


class StagedRows(dict):
    """A captured block's rows ``{layer: {page key: tensor}}`` as the
    engine's capture hook hands them over; ``event`` (a CUDA event, None
    on the CPU) is recorded behind the copy that filled them, and
    ``groups`` lists ``(stack, [(layer, page key), ...])``: the rows are
    views of those stacks, one a dtype and shape, moved whole."""

    event = None
    groups = ()


@dataclass
class TierEntry:
    """Directory row for one trie block, keyed by its chain hash."""

    hash: str
    parent: str                 # parent chain hash, "" at the root
    key: Tuple[int, ...]        # this block's tokens
    depth: int                  # blocks from the root (1-based)
    prefix: Tuple[int, ...]     # full token prefix through this block
    tier: str                   # "hbm" | "spilling" | "host" | "disk"


class TierManager:
    """Owns the host-RAM ring, the disk block store, the directory event
    log and the background transfer worker (JAX kvtier.py:162).

    The engine arms it with :meth:`attach_engine` (a capture callable that
    stages one pool block's rows, and the sizing); `kvpool.KVPool` calls
    :meth:`note_resident` on trie insert/adopt and :meth:`offer_spill`
    from ``_evict_lru``; the scheduler loop calls :meth:`pace` and
    :meth:`drain_ready` every iteration; HTTP handlers call
    :meth:`directory_feed`, :meth:`get_block_payload` and
    :meth:`insert_fetched`.
    """

    def __init__(self, *, host_bytes: int, disk_bytes: int = 0,
                 disk_dir: Optional[str] = None,
                 chunk_bytes: int = 512 * 1024,
                 queue_blocks: int = 32, ready_blocks: int = 64,
                 event_log: int = 4096,
                 metrics: Optional[MetricsRegistry] = None,
                 tracer: Optional[FlightRecorder] = None):
        if host_bytes <= 0:
            raise ValueError("host_bytes must be > 0 to arm tiering")
        if disk_bytes > 0 and not disk_dir:
            raise ValueError("disk tier needs disk_dir")
        self.host_budget = int(host_bytes)
        self.disk_budget = int(disk_bytes)
        self.disk_dir = disk_dir
        self.chunk_bytes = int(chunk_bytes)
        self.queue_blocks = int(queue_blocks)
        self.ready_blocks = int(ready_blocks)
        #: process epoch: a restarted replica publishes a fresh one, so
        #: directory consumers drop stale cursors and resync from zero
        self.epoch = os.urandom(8).hex()
        if self.disk_budget > 0:
            os.makedirs(disk_dir, exist_ok=True)

        # engine attachment (written once before traffic, then read-only)
        self._capture: Optional[Callable[[int], dict]] = None
        self._block_bytes = 0
        self.block = 0
        # the engine's CUDA device, None on the CPU: host rows are pinned
        # and device copies ride the worker's own stream
        self._cuda: Optional[torch.device] = None
        self._stream = None
        #: called (no lock held) when a copydown is queued: the engine
        #: wakes its idle loop, so a peer's pull is served at once
        self.wake: Optional[Callable[[], None]] = None

        # -- all dynamic state below lives under _cond's lock -------------
        self._cond = threading.Condition()
        self._index: Dict[str, TierEntry] = {}
        self._children: Dict[str, Dict[Tuple[int, ...], str]] = {}
        self._host: "OrderedDict[str, Tuple[dict, int]]" = OrderedDict()
        self._host_bytes = 0
        self._disk: "OrderedDict[str, int]" = OrderedDict()
        self._disk_bytes = 0
        self._events: deque = deque(maxlen=int(event_log))
        self._seq = 0
        self._spillq: deque = deque()     # (hash, staged rows, is_copy)
        self._restoreq: deque = deque()   # hashes awaiting promotion
        self._restore_pending: set = set()
        self._readyq: deque = deque()     # (entry, host pages, nbytes)
        self._copyq: deque = deque()      # hashes needing a copydown
        self._credits = int(chunk_bytes)
        self._credit_cap = 4 * int(chunk_bytes)
        self._stopped = False
        self.last_error: Optional[str] = None
        # the worker's seconds per moved block, for reports: a spill's
        # event wait and device->host copy; a restore's staging
        self.spill_seconds = 0.0
        self.spill_blocks = 0
        self.spill_batches = 0
        self.spill_queue_peak = 0
        self.spill_credit_wait_seconds = 0.0
        self.spill_event_wait_seconds = 0.0
        self.restore_seconds = 0.0
        self.restore_blocks = 0

        m = metrics
        self.metrics = m
        if m is not None:
            self._c_spilled = m.counter(
                "kv_tier_spilled_blocks_total",
                "prefix blocks demoted from the device pool into the host "
                "ring")
            self._c_spilled_bytes = m.counter(
                "kv_tier_spilled_bytes_total",
                "bytes moved device->host by spills")
            self._c_spill_dropped = m.counter(
                "kv_tier_spill_dropped_total",
                "evicted blocks dropped instead of spilled (queue full, "
                "no capture, or injected fault) — cold recompute later")
            self._c_restored = m.counter(
                "kv_tier_restored_blocks_total",
                "tiered blocks staged host-side for promotion")
            self._c_restored_bytes = m.counter(
                "kv_tier_restored_bytes_total",
                "bytes staged for promotion (host+disk reads)")
            self._c_restore_failed = m.counter(
                "kv_tier_restore_failed_total",
                "restore requests dropped (fault/corrupt payload) — the "
                "slot degrades to cold prefill")
            self._c_lookups = m.counter(
                "kv_tier_lookups_total",
                "admission-time tier directory lookups")
            self._c_hits_host = m.counter(
                "kv_tier_hits_host_total",
                "lookup blocks found in the host ring")
            self._c_hits_disk = m.counter(
                "kv_tier_hits_disk_total",
                "lookup blocks found in the disk store")
            self._c_demoted = m.counter(
                "kv_tier_demoted_disk_blocks_total",
                "host-ring overflow blocks demoted to disk")
            self._c_dropped = m.counter(
                "kv_tier_evicted_blocks_total",
                "blocks that fell off the bottom tier (directory del)")
            self._c_fetched = m.counter(
                "kv_tier_fetched_blocks_total",
                "blocks inserted from a peer replica's tier")
            self._c_copydowns = m.counter(
                "kv_tier_copydowns_total",
                "device->host copydowns serving peer fetches")
            self._c_publish_dropped = m.counter(
                "kv_tier_publish_dropped_total",
                "directory events lost to injected publish faults")
            self._g_host_blocks = m.gauge(
                "kv_tier_host_blocks", "blocks resident in the host ring")
            self._g_host_bytes = m.gauge(
                "kv_tier_host_bytes", "bytes resident in the host ring")
            self._g_disk_blocks = m.gauge(
                "kv_tier_disk_blocks", "blocks resident in the disk store")
            self._g_disk_bytes = m.gauge(
                "kv_tier_disk_bytes", "bytes resident in the disk store")
            self._g_dir_entries = m.gauge(
                "kv_tier_directory_entries",
                "chain hashes tracked in the prefix directory")
            m.ratio("kv_tier_host_hit_rate",
                    self._c_hits_host, self._c_lookups,
                    "fraction of tier lookups served by the host ring")
            m.ratio("kv_tier_disk_hit_rate",
                    self._c_hits_disk, self._c_lookups,
                    "fraction of tier lookups served by the disk store")
        self.tracer = tracer

        self._worker = threading.Thread(
            target=self._worker_loop, name="kvtier-worker", daemon=True)
        self._worker.start()

    # -- engine attachment (setup-time, single-threaded) --------------------

    def attach_engine(self, capture: Callable[[int], dict],
                      block_bytes: int, block: int,
                      device: Optional[torch.device] = None) -> None:
        """Arm the device side: ``capture(block_id)`` stages one pool
        block's rows (a :class:`StagedRows`, or any ``{layer: {key:
        tensor}}``); the sizing feeds the pacing credit cap so one full
        block can always earn enough credits to move. ``device``: the
        engine's device (a CUDA one pins the host rows)."""
        with self._cond:
            self._capture = capture
            self._block_bytes = int(block_bytes)
            self.block = int(block)
            self._credit_cap = max(4 * self.chunk_bytes, 2 * block_bytes)
            self._credits = min(self._credits, self._credit_cap)
            if device is not None and torch.device(device).type == "cuda":
                self._cuda = torch.device(device)

    # -- directory bookkeeping (scheduler thread via kvpool) ----------------

    def note_resident(self, h: str, parent: str,
                      key: Sequence[int]) -> None:
        """Trie insert/adopt hook: record (or re-tier) a resident block.
        A host/disk payload for the same hash is kept: it serves peer
        fetches, and a later eviction flips the tier without recopying."""
        key = tuple(int(t) for t in key)
        with self._cond:
            e = self._index.get(h)
            if e is None:
                if parent:
                    pe = self._index.get(parent)
                    if pe is None:
                        return  # broken chain (an ancestor dropped)
                    prefix = pe.prefix + key
                    depth = pe.depth + 1
                else:
                    prefix = key
                    depth = 1
                e = TierEntry(h, parent, key, depth, prefix, "hbm")
                self._index[h] = e
                self._children.setdefault(parent, {})[key] = h
                ledger_note("directory_entry", h, +1)
            else:
                e.tier = "hbm"
            self._restore_pending.discard(h)
            self._publish_locked("put", e)
            self._sync_gauges_locked()

    def offer_spill(self, h: Optional[str], block_id: int) -> None:
        """`_evict_lru` hook, called BEFORE the block id returns to the
        free list: stage the block's rows (the capture's copy is queued
        ahead of any later write into the page) and queue them for the
        worker. On any degradation — queue full, no capture, injected
        fault — the block is dropped from the directory and recomputed
        cold later."""
        if h is None:
            return
        with self._cond:
            e = self._index.get(h)
            if e is None:
                return
            if h in self._host or h in self._disk:
                # payload already tiered (write-back cache): flip only
                e.tier = "host" if h in self._host else "disk"
                self._publish_locked("put", e)
                return
            cap = self._capture
            if cap is None or len(self._spillq) >= self.queue_blocks:
                self._drop_entry_locked(e)
                if self.metrics is not None:
                    self._c_spill_dropped.inc()
                self._sync_gauges_locked()
                return
            e.tier = "spilling"
        try:
            failpoints.fire("tier.spill")
            dev = cap(int(block_id))
        except failpoints.InjectedFault as exc:
            with self._cond:
                ent = self._index.get(h)
                if ent is not None:
                    self._drop_entry_locked(ent)
                if self.metrics is not None:
                    self._c_spill_dropped.inc()
                self.last_error = f"tier.spill: {exc}"
                self._sync_gauges_locked()
            return
        with self._cond:
            self._spillq.append((h, dev, False))
            self.spill_queue_peak = max(self.spill_queue_peak,
                                        len(self._spillq))
            self._cond.notify_all()

    def evicted_everywhere(self, h: str) -> None:
        """Drop a chain hash from every tier (test/maintenance seam)."""
        with self._cond:
            e = self._index.get(h)
            if e is not None:
                self._drop_entry_locked(e)
                self._sync_gauges_locked()

    # -- admission-side lookup / promotion (scheduler thread) ---------------

    def lookup_extension(self, frontier: str, prompt: Sequence[int],
                         from_block: int, max_blocks: int) -> List[str]:
        """The chain of host/disk blocks that extend ``prompt``'s resident
        prefix past the trie's frontier. One lookup is counted per call;
        each returned block counts as a hit of its tier."""
        out: List[str] = []
        with self._cond:
            B = self.block
            if B <= 0:
                return []
            if self.metrics is not None:
                self._c_lookups.inc()
            h = frontier
            j = from_block
            while j < max_blocks:
                key = tuple(int(t) for t in prompt[j * B:(j + 1) * B])
                ch = self._children.get(h, {}).get(key)
                if ch is None:
                    break
                e = self._index.get(ch)
                if e is None or e.tier not in ("host", "disk"):
                    break
                if self.metrics is not None:
                    (self._c_hits_host if e.tier == "host"
                     else self._c_hits_disk).inc()
                out.append(ch)
                h = ch
                j += 1
        return out

    def request_restore(self, hashes: Sequence[str]) -> int:
        """Queue tiered blocks for promotion (idempotent per hash)."""
        n = 0
        with self._cond:
            for h in hashes:
                if h in self._restore_pending:
                    continue
                e = self._index.get(h)
                if e is None or e.tier not in ("host", "disk"):
                    continue
                self._restore_pending.add(h)
                self._restoreq.append(h)
                n += 1
            if n:
                self._cond.notify_all()
        return n

    def drain_ready(self, max_bytes: int,
                    max_blocks: int = 8) -> List[Tuple[TierEntry, dict]]:
        """Pop promotion payloads staged by the worker, chain-ordered
        (parents first), bounded by the per-iteration upload budget."""
        out: List[Tuple[TierEntry, dict]] = []
        budget = int(max_bytes)
        with self._cond:
            while self._readyq and len(out) < max_blocks:
                entry, pages, nbytes = self._readyq[0]
                if out and nbytes > budget:
                    break
                self._readyq.popleft()
                budget -= nbytes
                out.append((entry, pages))
        return out

    def entry_info(self, h: str) -> Optional[Tuple[Tuple[int, ...], int]]:
        """(prefix tokens, depth) for a tracked chain hash, or None."""
        with self._cond:
            e = self._index.get(h)
            return None if e is None else (e.prefix, e.depth)

    def holds(self, h: str) -> bool:
        """True when this process already has the block in ANY tier."""
        with self._cond:
            e = self._index.get(h)
            if e is None:
                return False
            return (e.tier in ("hbm", "spilling") or h in self._host
                    or h in self._disk)

    def promotion_done(self, h: str, ok: bool) -> None:
        """The engine's verdict on one drained payload: ``ok`` means it
        was adopted back into the trie (note_resident re-tiered it); a
        failure clears the pending mark so a later hit can retry."""
        with self._cond:
            self._restore_pending.discard(h)
            if not ok and self.metrics is not None:
                self._c_restore_failed.inc()

    # -- pacing (scheduler thread) ------------------------------------------

    def pace(self, nbytes: int) -> None:
        """Grant the worker a transfer budget for this iteration."""
        with self._cond:
            self._credits = min(self._credits + int(nbytes),
                                self._credit_cap)
            self._cond.notify_all()

    # -- copydown (HTTP thread requests, scheduler thread serves) -----------

    def pending_copydowns(self, max_n: int = 4) -> List[str]:
        out: List[str] = []
        with self._cond:
            while self._copyq and len(out) < max_n:
                out.append(self._copyq.popleft())
        return out

    def complete_copydown(self, h: str, dev: dict) -> None:
        """The scheduler hands over a staged device-resident block; the
        worker lands it in the host ring (the tier stays ``hbm``: the
        copy serves peer fetches, it frees nothing)."""
        with self._cond:
            if len(self._spillq) >= self.queue_blocks:
                return  # the waiter times out; the peer recomputes
            self._spillq.append((h, dev, True))
            if self.metrics is not None:
                self._c_copydowns.inc()
            self._cond.notify_all()

    # -- HTTP-facing payload plane ------------------------------------------

    def get_block_payload(self, h: str,
                          timeout: float = 0.0) -> Optional[bytes]:
        """Encoded payload for one chain hash, from host or disk. A
        device-resident entry triggers a copydown request and (with a
        timeout) waits, bounded, for the scheduler to serve it."""
        deadline = time.monotonic() + max(0.0, timeout)
        requested = False
        while True:
            wake = None
            with self._cond:
                e = self._index.get(h)
                if e is None or self._stopped:
                    return None
                hit = self._host.get(h)
                if hit is not None:
                    self._host.move_to_end(h)
                    return encode_block(e, hit[0])
                if h in self._disk:
                    payload = read_block_file(self._disk_path(h))
                    if payload is not None:
                        return payload
                    self._disk_forget_locked(h)  # torn/corrupt = miss
                    self._drop_entry_locked(e)
                    self._sync_gauges_locked()
                    return None
                if e.tier == "hbm" and not requested:
                    self._copyq.append(h)
                    requested = True
                    self._cond.notify_all()
                    wake = self.wake
                else:
                    remain = deadline - time.monotonic()
                    if remain <= 0:
                        return None
                    self._cond.wait(min(0.05, remain))
            if wake is not None:
                wake()

    def insert_fetched(self, payload: bytes) -> Optional[str]:
        """Land a peer-fetched block payload in the host ring (parents
        must arrive before children, or the chain stays unreachable).
        Returns the chain hash, or None on a corrupt payload or a broken
        chain."""
        dec = decode_block(payload)
        if dec is None:
            return None
        meta, pages = dec
        pages = self._pinned(pages)
        h = meta["hash"]
        nbytes = _nbytes(pages)
        with self._cond:
            e = self._index.get(h)
            if e is not None and (e.tier == "hbm" or h in self._host
                                  or h in self._disk):
                return h  # already held locally in some tier
            if e is None:
                parent = meta["parent"]
                if parent and parent not in self._index:
                    return None
                prefix = tuple(meta["prefix"])
                key = prefix[-self.block:] if self.block else prefix
                if parent:
                    key = prefix[len(self._index[parent].prefix):]
                e = TierEntry(h, parent, tuple(key), meta["depth"],
                              prefix, "host")
                self._index[h] = e
                self._children.setdefault(parent, {})[tuple(key)] = h
                ledger_note("directory_entry", h, +1)
            e.tier = "host"
            self._host_put_locked(h, pages, nbytes)
            if self.metrics is not None:
                self._c_fetched.inc()
            self._publish_locked("put", e)
            self._sync_gauges_locked()
            self._cond.notify_all()
        return h

    def directory_feed(self, since: int = 0) -> dict:
        """Events with seq > ``since``, or a full ``reset`` snapshot when
        the cursor predates the ring (or is zero). ``epoch`` changes on
        process restart."""
        with self._cond:
            oldest = self._events[0]["seq"] if self._events else self._seq + 1
            if since <= 0 or since + 1 < oldest:
                snap = [{"seq": self._seq, "op": "put", "hash": e.hash,
                         "parent": e.parent, "depth": e.depth,
                         "tier": e.tier}
                        for e in self._index.values()
                        if e.tier in ("hbm", "host", "disk")]
                return {"epoch": self.epoch, "next": self._seq,
                        "reset": True, "events": snap}
            evs = [dict(ev) for ev in self._events if ev["seq"] > since]
            return {"epoch": self.epoch, "next": self._seq,
                    "reset": False, "events": evs}

    # -- census / teardown ---------------------------------------------------

    def stats(self) -> dict:
        with self._cond:
            return {
                "epoch": self.epoch,
                "host": {"blocks": len(self._host),
                         "bytes": self._host_bytes,
                         "budget_bytes": self.host_budget},
                "disk": {"blocks": len(self._disk),
                         "bytes": self._disk_bytes,
                         "budget_bytes": self.disk_budget},
                "directory_entries": len(self._index),
                "events": self._seq,
                "queues": {"spill": len(self._spillq),
                           "restore": len(self._restoreq),
                           "ready": len(self._readyq),
                           "copydown": len(self._copyq)},
                "credits_bytes": self._credits,
                "last_error": self.last_error,
            }

    def host_rows(self, h: str) -> Optional[dict]:
        """The host ring's rows of one chain hash, or None (the chip
        check compares promoted pool rows with them)."""
        with self._cond:
            hit = self._host.get(h)
            return None if hit is None else hit[0]

    def stop(self, check: bool = True) -> None:
        """Join the worker, release every held resource in the ledger,
        and (by default) assert the tier balance sheet zeroes."""
        with self._cond:
            self._stopped = True
            self._cond.notify_all()
        self._worker.join(timeout=10.0)
        with self._cond:
            for h in list(self._host):
                self._host.pop(h)
                ledger_note("host_page", h, -1)
            self._host_bytes = 0
            for h in list(self._disk):
                # the files stay (disk is the durable tier); the ledger
                # releases in-process ownership only
                self._disk.pop(h)
                ledger_note("disk_block", h, -1)
            self._disk_bytes = 0
            for h in list(self._index):
                del self._index[h]
                ledger_note("directory_entry", h, -1)
            self._children.clear()
            self._spillq.clear()
            self._restoreq.clear()
            self._restore_pending.clear()
            self._readyq.clear()
            self._copyq.clear()
            self._sync_gauges_locked()
        if check:
            ledger_check_zero("kvtier.stop", TIER_LEDGER_KINDS)

    # -- internals (lock held unless noted) ----------------------------------

    def _disk_path(self, h: str) -> str:
        return os.path.join(self.disk_dir, h + BLOCK_SUFFIX)

    def _publish_locked(self, op: str, e: TierEntry) -> None:
        try:
            failpoints.fire("directory.publish")
        except failpoints.InjectedFault as exc:
            if self.metrics is not None:
                self._c_publish_dropped.inc()
            self.last_error = f"directory.publish: {exc}"
            return
        self._seq += 1
        self._events.append({"seq": self._seq, "op": op, "hash": e.hash,
                             "parent": e.parent, "depth": e.depth,
                             "tier": e.tier})

    def _sync_gauges_locked(self) -> None:
        if self.metrics is None:
            return
        self._g_host_blocks.set(len(self._host))
        self._g_host_bytes.set(self._host_bytes)
        self._g_disk_blocks.set(len(self._disk))
        self._g_disk_bytes.set(self._disk_bytes)
        self._g_dir_entries.set(len(self._index))

    def _drop_entry_locked(self, e: TierEntry) -> None:
        """Remove one entry from the directory and free its payloads.
        Descendants stay indexed (unreachable until an ancestor is
        recomputed, then the chain reconnects)."""
        h = e.hash
        if h in self._host:
            _, nbytes = self._host.pop(h)
            self._host_bytes -= nbytes
            ledger_note("host_page", h, -1)
        if h in self._disk:
            try:
                os.remove(self._disk_path(h))
            except OSError:
                pass
            self._disk_forget_locked(h)
        kids = self._children.get(e.parent)
        if kids is not None and kids.get(e.key) == h:
            del kids[e.key]
            if not kids:
                del self._children[e.parent]
        self._index.pop(h, None)
        self._restore_pending.discard(h)
        ledger_note("directory_entry", h, -1)
        if self.metrics is not None:
            self._c_dropped.inc()
        self._publish_locked("del", e)

    def _disk_forget_locked(self, h: str) -> None:
        nbytes = self._disk.pop(h, None)
        if nbytes is not None:
            self._disk_bytes -= nbytes
            ledger_note("disk_block", h, -1)

    def _host_put_locked(self, h: str, pages: dict, nbytes: int) -> None:
        """Insert into the host ring; overflow demotes the LRU block to
        disk (or drops it when there is no disk tier or it is full)."""
        if h in self._host:
            _, old = self._host.pop(h)
            self._host_bytes -= old
            ledger_note("host_page", h, -1)
        self._host[h] = (pages, nbytes)
        self._host_bytes += nbytes
        ledger_note("host_page", h, +1)
        while self._host_bytes > self.host_budget and len(self._host) > 1:
            old_h, (old_pages, old_nb) = self._host.popitem(last=False)
            self._host_bytes -= old_nb
            ledger_note("host_page", old_h, -1)
            oe = self._index.get(old_h)
            if oe is None:
                continue
            if self.disk_budget > 0 and self._demote_disk_locked(
                    oe, old_pages):
                if oe.tier == "host":
                    oe.tier = "disk"
                    self._publish_locked("put", oe)
            elif oe.tier == "host":
                self._drop_entry_locked(oe)
        self._cond.notify_all()

    def _demote_disk_locked(self, e: TierEntry, pages: dict) -> bool:
        payload = encode_block(e, pages)
        try:
            write_block_file(self._disk_path(e.hash), payload)
        except (OSError, ValueError) as exc:
            self.last_error = f"disk write: {exc}"
            return False
        self._disk[e.hash] = len(payload)
        self._disk_bytes += len(payload)
        ledger_note("disk_block", e.hash, +1)
        if self.metrics is not None:
            self._c_demoted.inc()
        while self._disk_bytes > self.disk_budget and len(self._disk) > 1:
            old_h = next(iter(self._disk))
            oe = self._index.get(old_h)
            try:
                os.remove(self._disk_path(old_h))
            except OSError:
                pass
            self._disk_forget_locked(old_h)
            if oe is not None and oe.tier == "disk":
                self._drop_entry_locked(oe)
        return True

    # -- worker thread (no lock held unless noted) ---------------------------

    def _pinned(self, pages: Dict[str, Dict]) -> Dict[str, Dict]:
        """CPU rows pinned for an asynchronous upload (a no-op off the
        card): a pageable source would make the scheduler's copy wait for
        its stream. The rows of each dtype and shape are stacked into one
        pinned tensor, a size the engine warmed the allocator with."""
        if self._cuda is None:
            return pages
        groups: Dict[tuple, list] = {}
        for lk, pks in pages.items():
            for pk, a in pks.items():
                groups.setdefault((a.dtype, tuple(a.shape)), []).append(
                    (lk, pk, a))
        out: Dict[str, Dict] = {}
        for (dt, shape), members in groups.items():
            h = torch.empty((len(members),) + shape, dtype=dt,
                            pin_memory=True)
            torch.stack([a for _, _, a in members], out=h)
            for (lk, pk, _), view in zip(members, h.unbind(0)):
                out.setdefault(lk, {})[pk] = view
        return out

    def _to_host(self, devs: List[Dict[str, Dict]]) -> List[Dict]:
        """The device->host move of a batch of spills: wait for the last
        staging event (the stagings are in one stream's order), copy every
        block's staged stacks (its rows, for a capture without stacks)
        into pinned tensors of their own with one call on the worker's
        stream, and wait for that copy's event. No device-wide sync. On
        the CPU the stacks are taken as they are; plain CPU rows pass
        through."""
        cuda = any(a.is_cuda for d in devs for pks in d.values()
                   for a in pks.values())
        if not cuda and not any(getattr(d, "groups", ()) for d in devs):
            return list(devs)
        stacks = [list(getattr(d, "groups", ())) or [
            (a.unsqueeze(0), [(lk, pk)])
            for lk, pks in d.items() for pk, a in pks.items()] for d in devs]
        if cuda:
            ev = getattr(devs[-1], "event", None)
            if ev is not None:
                t0 = time.monotonic()
                ev.synchronize()
                self.spill_event_wait_seconds += time.monotonic() - t0
            dev0 = stacks[0][0][0].device
            if self._stream is None:
                self._stream = torch.cuda.Stream(dev0)
            with torch.cuda.device(dev0), torch.cuda.stream(self._stream):
                # one pinned tensor a stack: the sizes the engine warmed
                # the caching host allocator with (`prewarm_host`)
                hosts = [[torch.empty(st.shape, dtype=st.dtype,
                                      pin_memory=True) for st, _ in block]
                         for block in stacks]
                torch._foreach_copy_(
                    [h for hb in hosts for h in hb],
                    [st for block in stacks for st, _ in block],
                    non_blocking=True)
                done = torch.cuda.Event()
                done.record(self._stream)
            done.synchronize()
        else:
            hosts = [[st for st, _ in block] for block in stacks]
        out: List[Dict[str, Dict]] = []
        for block, hb in zip(stacks, hosts):
            rows: Dict[str, Dict] = {}
            for (_, keys), h in zip(block, hb):
                for (lk, pk), view in zip(keys, h.unbind(0)):
                    rows.setdefault(lk, {})[pk] = view
            out.append(rows)
        return out

    def prewarm_host(self, shapes: Sequence[Tuple[tuple, torch.dtype]]
                     ) -> None:
        """Fill the caching host allocator with the host budget's worth of
        pinned blocks of one spill's stack shapes, and free them: the
        spills then take cached pinned memory instead of page-locking new
        memory under traffic (about a microsecond a KiB, and a stall of
        other CUDA calls). The memory stays with the allocator."""
        if self._cuda is None:
            return
        per = sum(int(np.prod(s)) * torch.empty((), dtype=d).element_size()
                  for s, d in shapes)
        n = min(self.host_budget // max(per, 1) + 1, 1 << 16)
        warm = [torch.empty(s, dtype=d, pin_memory=True)
                for _ in range(n) for s, d in shapes]
        del warm

    def _take_spills_locked(self) -> List[Tuple[str, dict, bool]]:
        """Pop the queued spills the pacing credit covers: the first one
        waits for its credit (bounded waits), the rest only while the
        credit lasts. Empty when the manager stops."""
        h, dev, is_copy = self._spillq.popleft()
        t0 = time.monotonic()
        ok = self._take_credits_locked(_nbytes(dev))
        self.spill_credit_wait_seconds += time.monotonic() - t0
        if not ok:
            return []
        batch = [(h, dev, is_copy)]
        while self._spillq and len(batch) < self.queue_blocks:
            need = min(_nbytes(self._spillq[0][1]), self._credit_cap)
            if self._credits < need:
                break
            self._credits -= need
            batch.append(self._spillq.popleft())
        return batch

    def _take_credits_locked(self, nbytes: int) -> bool:
        """Block (bounded waits, re-checked predicate) until the pacing
        budget covers ``nbytes`` or the manager stops."""
        need = min(int(nbytes), self._credit_cap)
        while self._credits < need and not self._stopped:
            self._cond.wait(0.1)
        if self._stopped:
            return False
        self._credits -= need
        return True

    def _worker_loop(self) -> None:
        while True:
            batch = None
            restore_h = None
            with self._cond:
                while (not self._stopped and not self._spillq
                       and not self._restoreq):
                    self._cond.wait(0.2)
                if self._stopped:
                    return
                if self._spillq:
                    batch = self._take_spills_locked()
                elif self._restoreq:
                    restore_h = self._restoreq.popleft()
            try:
                if batch:
                    self._process_spills(batch)
                elif restore_h is not None:
                    self._process_restore(restore_h)
            except Exception as exc:  # degrade, never kill the worker
                with self._cond:
                    self.last_error = (
                        f"worker: {exc}" if isinstance(
                            exc, failpoints.InjectedFault)
                        else f"worker: {exc!r}")
                    if restore_h is not None:
                        self._restore_pending.discard(restore_h)
                        if self.metrics is not None:
                            self._c_restore_failed.inc()

    def _process_spills(self, batch: List[Tuple[str, dict, bool]]) -> None:
        """Land a batch of spills (their credit taken) in the host ring."""
        t0 = time.monotonic()
        moved = self._to_host([dev for _, dev, _ in batch])
        dt = time.monotonic() - t0
        landed = []
        with self._cond:
            self.spill_seconds += dt
            self.spill_blocks += len(batch)
            self.spill_batches += 1
            for (h, dev, is_copy), pages in zip(batch, moved):
                e = self._index.get(h)
                if e is None:
                    continue  # dropped while in flight
                nbytes = _nbytes(pages)
                self._host_put_locked(h, pages, nbytes)
                if not is_copy and e.tier == "spilling":
                    e.tier = "host"
                    self._publish_locked("put", e)
                if self.metrics is not None:
                    self._c_spilled.inc()
                    self._c_spilled_bytes.inc(nbytes)
                landed.append((h, nbytes, is_copy))
            self._sync_gauges_locked()
        if self.tracer is not None:
            for h, nbytes, is_copy in landed:
                self.tracer.instant(
                    "tier_spill", track="kvtier",
                    args={"hash": h[:12], "bytes": nbytes,
                          "copydown": bool(is_copy)})

    def _process_restore(self, h: str) -> None:
        failpoints.fire("tier.restore")
        t0 = time.monotonic()
        with self._cond:
            e = self._index.get(h)
            if e is None or h not in self._restore_pending:
                self._restore_pending.discard(h)
                return
            pages = None
            nbytes = 0
            hit = self._host.get(h)
            if hit is not None:
                pages, nbytes = hit[0], hit[1]
                self._host.move_to_end(h)
        if pages is None:
            payload = read_block_file(self._disk_path(h)) \
                if self.disk_dir else None
            dec = decode_block(payload) if payload is not None else None
            if dec is None:
                with self._cond:
                    # torn/corrupt disk block: a miss, never wrong bytes
                    self._disk_forget_locked(h)
                    e2 = self._index.get(h)
                    if e2 is not None:
                        self._drop_entry_locked(e2)
                    self._restore_pending.discard(h)
                    if self.metrics is not None:
                        self._c_restore_failed.inc()
                    self._sync_gauges_locked()
                return
            pages = self._pinned(dec[1])
            nbytes = _nbytes(pages)
        staged = time.monotonic() - t0
        with self._cond:
            if not self._take_credits_locked(nbytes):
                self._restore_pending.discard(h)
                return
            e = self._index.get(h)
            if e is None:
                self._restore_pending.discard(h)
                return
            if len(self._readyq) >= self.ready_blocks:
                self._restore_pending.discard(h)
                if self.metrics is not None:
                    self._c_restore_failed.inc()
                return
            self._readyq.append((e, pages, nbytes))
            # staging time: a host hit, or a disk read, decode and pin
            self.restore_seconds += staged
            self.restore_blocks += 1
            if self.metrics is not None:
                self._c_restored.inc()
                self._c_restored_bytes.inc(nbytes)
        if self.tracer is not None:
            self.tracer.instant(
                "tier_restore", track="kvtier",
                args={"hash": h[:12], "bytes": nbytes})
