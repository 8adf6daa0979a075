"""Continuous-batching decode over a paged KV pool — a reduced port of
deeplearning4j_tpu/inference/engine.py (`DecodeScheduler`, paged mode).

One scheduler thread loops over iterations. Each iteration:

  1. evicts cancelled requests, re-matches mid-prefill slots against the
     prefix trie, and admits queued requests into free slots, each
     restoring its longest cached prefix;
  2. runs at most one prefill chunk (round-robin over prefilling slots),
     padded to a pow2 chunk bucket: lanes past the real tokens write to
     the scratch page, and the slot's position advances by the real
     token count only (JAX `_prefill_paged_fn`, engine.py:1420);
  3. runs one decode step over all slots ([n_slots, 1] tokens) with the
     ``live`` mask as write mask: idle and mid-prefill slots write to
     the scratch page and do not advance (JAX `_step_paged_fn` :1241 and
     `_freeze_states` :1182).

Positions and block tables are host-authoritative: the host holds each
slot's depth (``written``) and its table row, and ships both with every
dispatch; a masked row's position simply is not advanced. Tables are
sliced to a pow2 bucket covering the deepest live slot, as in the JAX
engine. Every request samples on the host from its own
``np.random.default_rng(seed)``, so its tokens do not depend on the
schedule.

The pool (`kvpool.KVPool`) is the live cache and the prefix cache at once:

  - prefix restore is a table remap (JAX `_try_restore_paged` :1952): the
    slot's table points at the trie's pages, pinned through the deepest
    matched node, and its position jumps past the hit; no K/V is copied.
    A hit may cover the whole prompt: the last prompt token is re-fed;
  - copy-on-write (`_ensure_writable` :1837): the first write into a
    shared (trie-owned) page copies that page into a fresh one first;
  - publish is an ownership transfer (`_publish_paged` :2018): at finish
    the prompt's full blocks are adopted by the trie where they lie;
  - blocks are allocated lazily as a slot's depth crosses a block
    boundary. Admission is by pool bytes (free plus evictable blocks
    against the prompt's blocks); when allocation fails even after LRU
    eviction, the latest-submitted live slot is preempted: its blocks
    and pin are released, its generated tokens folded into its prompt,
    and it is requeued at the front, to re-prefill on resume with its
    RNG untouched (`_preempt` :1884).

``paged_kernel``: "on" (default) reads decode attention through the
hand-written CUDA kernel (the plain version on CPU tensors); "off" is
the caller's explicit choice of the layer's gather body.

Still to come (listed in ROADMAP.md): contiguous mode, `warmup()`,
metrics, trace, the CUDA-graph capture of the decode step, speculation,
logit processors and masks, tiering, supervisor, mesh, profiler and
failpoints.
"""
from __future__ import annotations

import itertools
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..models.sampling import sample_logits
from ..nn.layers.attention import SelfAttentionLayerImpl
from ..util.device import DeviceLike, resolve_device
from .batcher import bucket_for, pow2_buckets
from .kvpool import SCRATCH_BLOCK, KVPool, blocks_for

# smallest prefill chunk bucket (JAX engine.py:122)
_MIN_CHUNK_BUCKET = 16
_REQUEST_IDS = itertools.count(1)


class PromptTooLongError(ValueError):
    """The request's prompt plus max_new_tokens cannot fit the KV pool."""


class QueueFullError(RuntimeError):
    """The decode queue is full."""


class EngineCrashedError(RuntimeError):
    """The scheduler loop died with this request in flight."""


class DecodeHandle:
    """Completion handle for one submitted generation request."""

    def __init__(self, prompt_len: int, max_new_tokens: int,
                 request_id: Optional[str] = None):
        self.prompt_len = prompt_len
        self.max_new_tokens = max_new_tokens
        self.request_id = request_id or f"r{next(_REQUEST_IDS):06d}"
        self.tokens: List[int] = []
        self.finish_reason: Optional[str] = None  # "length" | "eos" | "cancelled"
        self._done = threading.Event()
        self._cancel = threading.Event()
        self._error: Optional[BaseException] = None
        self.t_submit = time.monotonic()
        self.t_first_token: Optional[float] = None
        self.t_done: Optional[float] = None

    def timings(self) -> Dict[str, float]:
        """Wall-time breakdown (ms): submit -> first token -> done."""
        end = self.t_done if self.t_done is not None else time.monotonic()
        first = self.t_first_token if self.t_first_token is not None else end
        return {"ttft_ms": round((first - self.t_submit) * 1e3, 3),
                "decode_ms": round((end - first) * 1e3, 3),
                "total_ms": round((end - self.t_submit) * 1e3, 3)}

    def _finish(self, err: Optional[BaseException] = None) -> None:
        if self._done.is_set():
            return
        self._error = err
        self.t_done = time.monotonic()
        self._done.set()

    def done(self) -> bool:
        return self._done.is_set()

    def cancel(self) -> None:
        """Ask the scheduler to evict this request at its next iteration."""
        self._cancel.set()

    def cancelled(self) -> bool:
        return self._cancel.is_set()

    def result(self, timeout: Optional[float] = None) -> List[int]:
        if not self._done.wait(timeout):
            raise TimeoutError("generation not finished")
        if self._error is not None:
            raise self._error
        return self.tokens


class _ActiveSeq:
    """Book-keeping for one request."""
    __slots__ = ("handle", "prompt", "fed", "rng", "temperature", "top_k",
                 "top_p", "eos_id", "pool_node", "block_ids", "shared",
                 "written", "folded", "cow_starved")

    def __init__(self, handle: DecodeHandle, prompt: Sequence[int],
                 temperature: float, top_k: Optional[int],
                 top_p: Optional[float], seed: int, eos_id: Optional[int]):
        self.handle = handle
        self.prompt = [int(t) for t in prompt]
        self.fed = 0  # prompt tokens fed so far
        self.rng = np.random.default_rng(seed)
        self.temperature = temperature
        self.top_k = top_k
        self.top_p = top_p
        self.eos_id = eos_id
        self.pool_node = None  # pinned trie node of the restored prefix
        self.block_ids: List[int] = []  # table entries, logical order
        self.shared: List[bool] = []  # True = trie-owned (COW on write)
        self.written = 0  # positions written to the slot's KV pages
        self.folded = 0  # generated tokens folded into `prompt` by preempts
        # set when a COW page could not be had even by preempting (every
        # page backs this very prompt's pinned prefix): the resume's
        # restore then stops one block short, once
        self.cow_starved = False

    def next_input(self) -> int:
        if self.fed < len(self.prompt):
            return self.prompt[self.fed]
        return self.handle.tokens[-1]

    @property
    def sampling(self) -> bool:
        """Past the last prompt token, every step's output is sampled."""
        return self.fed >= len(self.prompt)


class DecodeScheduler:
    """Continuous-batching paged decode over a transformer ComputationGraph.

    ``net``: a port `ComputationGraph` (e.g. `models/zoo.transformer_lm`)
    whose output is a next-token distribution; it must live on
    ``device``. ``kv_pool_mb``: byte budget (MiB) of the paged KV pool,
    required (> 0: the port's engine is paged only). ``kv_block``:
    positions per page. ``kv_dtype="int8"`` stores int8 pages with f32
    per-(position, head) scales. ``prefill_chunk``: max prompt tokens per
    prefill dispatch (<= 1 feeds prompts token by token through the
    decode step). ``device`` defaults to "cuda" and raises without one.
    """

    def __init__(self, net, vocab_size: int, *, n_slots: int = 4,
                 max_queue: int = 64, prefill_chunk: int = 64,
                 kv_block: int = 16, kv_pool_mb: float = 0.0,
                 kv_dtype: Optional[str] = None, paged_kernel: str = "on",
                 device: DeviceLike = "cuda"):
        self.device = resolve_device(device)
        if net.device != self.device:
            raise ValueError(f"the net lives on {net.device}, the engine "
                             f"was asked for {self.device}")
        if n_slots < 1:
            raise ValueError(f"n_slots must be >= 1, got {n_slots}")
        if kv_dtype not in (None, "int8"):
            raise ValueError(f"kv_dtype must be None or 'int8', got {kv_dtype!r}")
        if paged_kernel not in ("on", "off"):
            raise ValueError(f"paged_kernel must be 'on' or 'off', got "
                             f"{paged_kernel!r}")
        if not kv_pool_mb or kv_pool_mb <= 0:
            raise ValueError("kv_pool_mb must be > 0: the engine decodes "
                             "from a paged KV pool")
        if self.device.type == "cuda":
            # f32 matmuls at full f32 precision: TF32 keeps ~10 mantissa
            # bits, enough to flip near-tied tokens against the reference
            # decode. Process-wide switches, set before any dispatch.
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        net._check_init()
        self.net = net
        self.vocab_size = int(vocab_size)
        self.n_slots = int(n_slots)
        self.max_queue = int(max_queue)
        self.prefill_chunk = int(prefill_chunk)
        self.kv_block = int(kv_block)
        self.kv_dtype = kv_dtype
        self.paged_kernel = paged_kernel
        self._out_name = net.conf.network_outputs[0]
        attn = {name: impl for name, impl in sorted(net._impls.items())
                if isinstance(impl, SelfAttentionLayerImpl)}
        if not attn:
            raise ValueError("the decode engine serves attention nets: this "
                             "net has no SelfAttentionLayer to page")
        itemsize = torch.empty((), dtype=net.dtype).element_size()
        shapes = {name: (impl._kv_heads(), impl.conf.n_out // impl.conf.n_heads)
                  for name, impl in attn.items()}
        self.pool = KVPool({n: (h, d, itemsize) for n, (h, d) in shapes.items()},
                           block=self.kv_block,
                           budget_bytes=int(kv_pool_mb * (1 << 20)),
                           cache_dtype=kv_dtype)
        if self.pool.capacity_blocks < 1:
            raise ValueError(f"kv_pool_mb={kv_pool_mb} holds fewer than two "
                             f"{self.kv_block}-position blocks")
        pages = self.pool.capacity_blocks + 1  # page 0 = scratch
        dev = self.device
        self._states: Dict[str, Dict[str, torch.Tensor]] = {}
        for name, (hkv, dh) in shapes.items():
            shape = (pages, self.kv_block, hkv, dh)
            if kv_dtype == "int8":
                self._states[name] = {
                    "k_pages": torch.zeros(shape, dtype=torch.int8, device=dev),
                    "v_pages": torch.zeros(shape, dtype=torch.int8, device=dev),
                    "k_scales": torch.zeros(shape[:-1], dtype=torch.float32,
                                            device=dev),
                    "v_scales": torch.zeros(shape[:-1], dtype=torch.float32,
                                            device=dev)}
            else:
                self._states[name] = {
                    "k_pages": torch.zeros(shape, dtype=net.dtype, device=dev),
                    "v_pages": torch.zeros(shape, dtype=net.dtype, device=dev)}
        self._cache_cap = self.pool.capacity_blocks * self.kv_block
        self.table_buckets = pow2_buckets(self.pool.capacity_blocks)
        self._table = np.full((self.n_slots, self.pool.capacity_blocks),
                              SCRATCH_BLOCK, np.int32)
        if self.prefill_chunk > 1:
            lo = min(_MIN_CHUNK_BUCKET, self.prefill_chunk)
            self.prefill_buckets = [b for b in pow2_buckets(self.prefill_chunk)
                                    if b >= lo]
        else:
            self.prefill_buckets = []
        self._slots: List[Optional[_ActiveSeq]] = [None] * self.n_slots
        self._queue: List[_ActiveSeq] = []
        self._cond = threading.Condition()
        self._running = False
        self._thread: Optional[threading.Thread] = None
        self._prefill_next = 0
        self._published_seen = 0  # pool.published_blocks at the last upgrade
        self.crashed: Optional[BaseException] = None
        # scheduler-thread counters, read by callers between runs
        self.decode_steps = 0
        self.decode_seconds = 0.0
        self.prefill_chunks = 0
        self.prefill_seconds = 0.0
        self.tokens_emitted = 0
        self.preemptions = 0
        self.cow_copies = 0
        self.restored_tokens = 0  # prompt positions skipped by prefix hits

    # -- submission --------------------------------------------------------
    def submit(self, prompt_ids: Sequence[int], max_new_tokens: int, *,
               temperature: float = 0.0, top_k: Optional[int] = None,
               top_p: Optional[float] = None, seed: int = 0,
               eos_id: Optional[int] = None,
               request_id: Optional[str] = None) -> DecodeHandle:
        if not len(prompt_ids):
            raise ValueError("prompt_ids must be non-empty")
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
        bad = [int(t) for t in prompt_ids if not 0 <= int(t) < self.vocab_size]
        if bad:
            raise ValueError(f"prompt ids out of range [0, {self.vocab_size}): "
                             f"{bad[:5]}")
        # the last sampled token is never fed back, so it needs no row.
        # Pool-bytes admission: "too long" means more blocks than the
        # whole pool has (there is no per-slot stripe to outgrow)
        needed = len(prompt_ids) + max_new_tokens - 1
        need_blocks = blocks_for(needed, self.kv_block)
        if need_blocks > self.pool.capacity_blocks:
            err = PromptTooLongError(
                f"prompt ({len(prompt_ids)}) + max_new_tokens "
                f"({max_new_tokens}) needs {need_blocks} KV blocks of "
                f"{self.kv_block} positions but the pool has "
                f"{self.pool.capacity_blocks}")
            err.blocks_needed = need_blocks
            err.blocks_available = self.pool.capacity_blocks
            raise err
        handle = DecodeHandle(len(prompt_ids), max_new_tokens,
                              request_id=request_id)
        seq = _ActiveSeq(handle, prompt_ids, float(temperature), top_k, top_p,
                         int(seed), eos_id)
        with self._cond:
            if not self._running:
                raise RuntimeError("scheduler is not running (call start())")
            if len(self._queue) >= self.max_queue:
                raise QueueFullError(f"decode queue full ({self.max_queue} "
                                     "waiting)")
            self._queue.append(seq)
            self._cond.notify()
        return handle

    def generate_handle(self, prompt_ids: Sequence[int], max_new_tokens: int,
                        timeout: Optional[float] = 120.0, **kw) -> DecodeHandle:
        """Blocking submit returning the completed handle; a timed-out
        wait cancels the request."""
        handle = self.submit(prompt_ids, max_new_tokens, **kw)
        try:
            handle.result(timeout)
        except TimeoutError:
            handle.cancel()
            raise
        return handle

    def generate(self, prompt_ids: Sequence[int], max_new_tokens: int,
                 timeout: Optional[float] = 120.0, **kw) -> List[int]:
        return self.generate_handle(prompt_ids, max_new_tokens,
                                    timeout=timeout, **kw).tokens

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "DecodeScheduler":
        with self._cond:
            if self._running:
                return self
            self._running = True
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="decode-scheduler")
        self._thread.start()
        return self

    def stop(self) -> None:
        with self._cond:
            self._running = False
            pending = self._queue[:]
            self._queue.clear()
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=30)
            if self._thread.is_alive():
                raise RuntimeError("decode scheduler thread did not stop")
            self._thread = None
        for seq in pending:
            seq.handle._finish(RuntimeError("scheduler stopped"))
        for i, seq in enumerate(self._slots):
            if seq is not None:
                self._drop_slot(i, seq)
                seq.handle._finish(RuntimeError("scheduler stopped"))

    def reset_counters(self) -> None:
        self.decode_steps = 0
        self.decode_seconds = 0.0
        self.prefill_chunks = 0
        self.prefill_seconds = 0.0
        self.tokens_emitted = 0
        self.preemptions = 0
        self.cow_copies = 0
        self.restored_tokens = 0

    def _loop(self) -> None:
        while True:
            with self._cond:
                if not self._running:
                    return
            try:
                with torch.no_grad():
                    stepped = self._step_once()
            except Exception as e:  # the loop's boundary: fail in-flight
                self._crash(e)
                return
            if not stepped:
                with self._cond:
                    if not self._running:
                        return
                    if not self._queue:
                        self._cond.wait(timeout=0.1)

    def _crash(self, exc: BaseException) -> None:
        self.crashed = exc
        err = EngineCrashedError(f"decode scheduler crashed: {exc!r}")
        err.__cause__ = exc
        with self._cond:
            self._running = False
            pending = self._queue[:]
            self._queue.clear()
        for seq in pending:
            seq.handle._finish(err)
        for i, seq in enumerate(self._slots):
            if seq is not None:
                self._drop_slot(i, seq)
                seq.handle._finish(err)

    # -- pool bookkeeping: lazy growth, COW, preemption --------------------
    def _alloc_or_preempt(self, slot: int, seq: _ActiveSeq) -> Optional[int]:
        """One pool block under the preempt policy (JAX :1792): when even
        LRU eviction frees none, preempt the latest-submitted live slot
        and retry. None means ``seq`` itself was the victim (already
        requeued: the caller skips its dispatch)."""
        while True:
            bid = self.pool.alloc()
            if bid is not None:
                return bid
            victim = self._pick_victim()
            if victim is None or victim[1] is seq:
                self._preempt(slot, seq)
                return None
            self._preempt(*victim)

    def _ensure_blocks(self, slot: int, seq: _ActiveSeq, upto_pos: int) -> bool:
        """Grow the slot's table to cover positions [0, upto_pos) (JAX
        :1811). False means ``seq`` was preempted by its own allocation."""
        need = blocks_for(upto_pos, self.kv_block)
        while len(seq.block_ids) < need:
            bid = self._alloc_or_preempt(slot, seq)
            if bid is None:
                return False
            self._table[slot, len(seq.block_ids)] = bid
            seq.block_ids.append(bid)
            seq.shared.append(False)
        return True

    def _ensure_writable(self, slot: int, seq: _ActiveSeq, pos: int) -> bool:
        """Copy-on-write before the first write into a shared block (JAX
        :1837): the block holding ``pos`` — the one a full-prompt hit's
        refeed writes — is copied into a fresh page and the table
        repointed, so the cached original stays intact for its other
        readers. Only the first block of a write can be shared."""
        j = pos // self.kv_block
        if j >= len(seq.block_ids) or not seq.shared[j]:
            return True
        bid = self._alloc_or_preempt(slot, seq)
        if bid is None:
            # every page backs this prompt's own pinned prefix: the resume
            # must restore one block short instead
            seq.cow_starved = True
            return False
        src = seq.block_ids[j]
        for st in self._states.values():
            for pages in st.values():  # K/V pages, and int8 scales
                pages[bid].copy_(pages[src])
        self.cow_copies += 1
        seq.block_ids[j] = bid
        seq.shared[j] = False
        self._table[slot, j] = bid
        return True

    def _pick_victim(self) -> Optional[Tuple[int, _ActiveSeq]]:
        """The latest-submitted live slot (JAX :1870): the earliest request
        keeps its progress. May be the requester itself."""
        cands = [(s.handle.t_submit, i, s)
                 for i, s in enumerate(self._slots) if s is not None]
        if not cands:
            return None
        _, i, s = max(cands, key=lambda c: c[:2])
        return i, s

    def _preempt(self, slot: int, seq: _ActiveSeq) -> None:
        """Swap a sequence out under pool pressure (JAX :1884): release its
        blocks and trie pin (K/V is dropped: the resume re-prefills it),
        fold its generated tokens into its prompt, and requeue it at the
        front. The host RNG is untouched, so the resumed output is the
        same tokens as an unpreempted run."""
        self.preemptions += 1
        self._release_pool(seq)
        self._release_slot_blocks(slot, seq)
        h = seq.handle
        seq.prompt.extend(h.tokens[seq.folded:])
        seq.folded = len(h.tokens)
        seq.fed = 0
        seq.written = 0
        self._slots[slot] = None
        with self._cond:
            self._queue.insert(0, seq)

    def _release_pool(self, seq: _ActiveSeq) -> None:
        """Drop the sequence's trie pin (every slot-freeing path comes
        through here, or the matched blocks stay pinned forever)."""
        if seq.pool_node is not None:
            self.pool.release(seq.pool_node)
            seq.pool_node = None

    def _release_slot_blocks(self, slot: int, seq: _ActiveSeq,
                             keep: frozenset = frozenset()) -> None:
        """Return the slot's owned blocks to the pool (shared ones belong
        to the trie; ``keep``: ids the trie adopted at publish) and reset
        its table row to scratch (JAX :1935)."""
        for bid, sh in zip(seq.block_ids, seq.shared):
            if not sh and bid not in keep:
                self.pool.free_block(bid)
        seq.block_ids = []
        seq.shared = []
        self._table[slot, :] = SCRATCH_BLOCK

    def _drop_slot(self, slot: int, seq: _ActiveSeq) -> None:
        """Free a slot without publishing (cancel, stop, crash: the prompt
        may be half-written)."""
        self._release_pool(seq)
        self._release_slot_blocks(slot, seq)
        self._slots[slot] = None

    def _try_restore_paged(self, slot: int, seq: _ActiveSeq) -> None:
        """Prefix restore as a table remap (JAX :1952): point the slot's
        table at the cached blocks, pinned through the trie, and set its
        position past the hit; no K/V is copied. The hit may cover the
        whole prompt: the last token is then re-fed, and its write
        copy-on-writes the last shared block."""
        B = self.kv_block
        max_hit = len(seq.prompt) // B
        if seq.cow_starved:
            # the last attempt's full hit left no page for the refeed's COW
            # copy: leave the tail block unpinned (evictable) this time
            max_hit -= 1
            seq.cow_starved = False
        if max_hit < 1:
            return
        n_blk, ids, node = self.pool.match(seq.prompt, max_hit)
        seq.pool_node = node
        if not n_blk:
            return
        seq.block_ids = [int(b) for b in ids]
        seq.shared = [True] * n_blk
        self._table[slot, :n_blk] = ids
        seq.fed = seq.written = min(n_blk * B, len(seq.prompt) - 1)
        self.restored_tokens += seq.fed

    def _try_upgrade_slots(self) -> None:
        """Re-match mid-prefill slots against the trie (JAX :3123): a slot
        whose next blocks were published since it was admitted swaps its
        pin to the deeper node, remaps its table onto those blocks and
        skips past them. A COW-starved slot is left alone, so a full-pool
        full-prompt hit converges instead of starving again. Only blocks
        published since the last pass can deepen a hit, so a pass with
        none is skipped."""
        if self.pool.published_blocks == self._published_seen:
            return
        self._published_seen = self.pool.published_blocks
        B = self.kv_block
        for i, seq in enumerate(self._slots):
            if seq is None or seq.fed >= len(seq.prompt) or seq.cow_starved:
                continue
            cur = seq.fed // B
            max_hit = len(seq.prompt) // B
            if max_hit <= cur or \
                    self.pool.cached_blocks(seq.prompt, max_hit) * B <= seq.fed:
                continue
            n2, ids2, node2 = self.pool.match(seq.prompt, max_hit)
            self._release_pool(seq)
            seq.pool_node = node2
            for j in range(cur, n2):
                if j < len(seq.block_ids):
                    if not seq.shared[j] and seq.block_ids[j] != ids2[j]:
                        self.pool.free_block(seq.block_ids[j])
                    seq.block_ids[j] = ids2[j]
                    seq.shared[j] = True
                else:
                    seq.block_ids.append(ids2[j])
                    seq.shared.append(True)
                self._table[i, j] = ids2[j]
            fed = min(n2 * B, len(seq.prompt) - 1)
            self.restored_tokens += fed - seq.fed
            seq.fed = seq.written = fed

    def _publish_paged(self, seq: _ActiveSeq) -> frozenset:
        """Publish as ownership transfer (JAX :2018): the finished prompt's
        full blocks are adopted by the trie where they lie. Returns the
        adopted ids; blocks the trie already indexes (the restored prefix,
        or a COW copy of one) are freed as usual."""
        n_full = len(seq.prompt) // self.kv_block
        if n_full < 1 or n_full > len(seq.block_ids):
            return frozenset()
        return frozenset(self.pool.adopt(seq.prompt[:n_full * self.kv_block],
                                         seq.block_ids[:n_full]))

    def _retire(self, slot: int, seq: _ActiveSeq) -> None:
        """Finish a sequence: publish its prompt's blocks for the next
        request sharing the prefix, drop its pin, free the rest."""
        adopted = self._publish_paged(seq)
        self._release_pool(seq)
        self._release_slot_blocks(slot, seq, keep=adopted)
        self._slots[slot] = None
        seq.handle._finish()

    def _table_for(self, max_pos: int) -> np.ndarray:
        """The host table sliced to the pow2 bucket covering ``max_pos``."""
        nb = bucket_for(max(1, blocks_for(max_pos, self.kv_block)),
                        self.table_buckets)
        return np.ascontiguousarray(self._table[:, :nb])

    # -- scheduler iteration ----------------------------------------------
    def _evict_cancelled(self) -> None:
        for i, seq in enumerate(self._slots):
            if seq is not None and seq.handle.cancelled():
                self._drop_slot(i, seq)
                seq.handle.finish_reason = "cancelled"
                seq.handle._finish()

    def _admit(self) -> None:
        """Fill free slots from the queue head by pool bytes (JAX :2420):
        with any slot live, a prompt is admitted only when the free plus
        evictable blocks, less the prompt blocks already promised to
        resident slots, cover its prompt. Decode growth is not reserved:
        that is what preemption is for. The oldest request waits rather
        than being overtaken (a preempted one is back at the front)."""
        B = self.kv_block
        pending = sum(max(0, blocks_for(len(s.prompt), B) - len(s.block_ids))
                      for s in self._slots if s is not None)
        reclaim = None
        admitted = []
        with self._cond:
            for i in range(self.n_slots):
                if self._slots[i] is not None:
                    continue
                while self._queue and self._queue[0].handle.cancelled():
                    seq = self._queue.pop(0)
                    seq.handle.finish_reason = "cancelled"
                    seq.handle._finish()
                if not self._queue:
                    break
                seq = self._queue[0]
                need = blocks_for(len(seq.prompt), B)
                if any(s is not None for s in self._slots):
                    if reclaim is None:
                        reclaim = self.pool.reclaimable_blocks()
                    if reclaim - pending < need:
                        break
                self._queue.pop(0)
                self._slots[i] = seq
                pending += need
                admitted.append((i, seq))
        for i, seq in admitted:
            self._try_restore_paged(i, seq)

    def _pick_chunk(self, seq: _ActiveSeq) -> Tuple[int, int]:
        """(bucket, n_real) of this sequence's next prefill chunk, or
        (0, 0) when no bucket fits under the pool's depth."""
        n_real = min(len(seq.prompt) - seq.fed, self.prefill_chunk)
        bucket = bucket_for(n_real, self.prefill_buckets)
        if seq.fed + bucket > self._cache_cap:
            fitting = [b for b in self.prefill_buckets
                       if seq.fed + b <= self._cache_cap]
            if not fitting:
                return 0, 0
            bucket = fitting[-1]
            n_real = min(n_real, bucket)
        return bucket, n_real

    def _onehot(self, ids: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(ids.astype(np.int64)).to(self.device)
        return F.one_hot(t, self.vocab_size).to(self.net.dtype)

    def _forward(self, x, pos, table, wmask):
        """One forward of one-hots ``x`` [B, T, vocab] with the paged
        states; returns the output distributions [B, T, vocab]."""
        sts = {name: {**st, "pos": pos, "table": table, "wmask": wmask,
                      "paged_kernel": self.paged_kernel}
               for name, st in self._states.items()}
        acts, _ = self.net._forward_impl(self.net.params, [x], states=sts)
        return acts[self._out_name]

    def _run_prefill_chunk(self) -> Optional[int]:
        """At most one prefill chunk per iteration, round-robin over
        prefilling slots. Returns the chunked slot index, or None."""
        if not self.prefill_buckets:
            return None
        for off in range(self.n_slots):
            i = (self._prefill_next + off) % self.n_slots
            seq = self._slots[i]
            if seq is None or seq.fed >= len(seq.prompt):
                continue
            bucket, n_real = self._pick_chunk(seq)
            if not n_real:
                continue  # no headroom: token-by-token through decode
            t0 = time.monotonic()
            # lazy allocation and COW before the dispatch: every block the
            # chunk writes is allocated and owned by the slot
            if not self._ensure_blocks(i, seq, seq.written + n_real) \
                    or not self._ensure_writable(i, seq, seq.written):
                continue  # seq itself was preempted for blocks
            ids = np.zeros((bucket,), np.int32)
            ids[:n_real] = seq.prompt[seq.fed:seq.fed + n_real]
            dev = self.device
            # the table bucket covers the PADDED chunk end, so the layer's
            # overflow guard never fires on padding lanes
            table = torch.from_numpy(
                self._table_for(seq.written + bucket)[i:i + 1]).to(dev)
            pos = torch.tensor([seq.written], dtype=torch.int32, device=dev)
            wmask = (torch.arange(bucket, device=dev) < n_real)[None, :]
            out = self._forward(self._onehot(ids)[None], pos, table, wmask)
            last = out[0, n_real - 1].cpu().numpy()
            self.prefill_chunks += 1
            self.prefill_seconds += time.monotonic() - t0
            seq.written += n_real
            seq.fed += n_real
            if seq.sampling:  # final chunk: its output is the first token
                self._consume(i, seq, last)
            self._prefill_next = (i + 1) % self.n_slots
            return i
        return None

    def _consume(self, slot: int, seq: _ActiveSeq, probs_row: np.ndarray) -> None:
        """Sample one token; finish and free the slot on max tokens / EOS."""
        tok = sample_logits(probs_row, seq.temperature, seq.top_k, seq.rng,
                            seq.top_p)
        h = seq.handle
        h.tokens.append(tok)
        self.tokens_emitted += 1
        if h.t_first_token is None:
            h.t_first_token = time.monotonic()
        eos = seq.eos_id is not None and tok == seq.eos_id
        if len(h.tokens) >= h.max_new_tokens or eos:
            h.finish_reason = "eos" if eos else "length"
            self._retire(slot, seq)

    def _step_once(self) -> bool:
        """One iteration: admission, at most one prefill chunk, then the
        all-slots decode step. Returns False when it idled."""
        self._evict_cancelled()
        self._try_upgrade_slots()
        self._admit()
        if all(s is None for s in self._slots):
            return False
        chunked = self._run_prefill_chunk()
        fed: List[Tuple[int, _ActiveSeq]] = []
        # oldest first: a preemption takes the latest-submitted slot, which
        # comes last here, so a slot already in `fed` never loses its blocks
        active = sorted(((i, s) for i, s in enumerate(self._slots)
                         if s is not None), key=lambda e: e[1].handle.t_submit)
        for i, seq in active:
            if self._slots[i] is not seq or i == chunked:
                continue  # preempted above, or had its chunk turn
            if not seq.sampling and self.prefill_buckets \
                    and self._pick_chunk(seq)[1]:
                continue  # mid-prefill: waits for its chunk turn
            if not self._ensure_blocks(i, seq, seq.written + 1) \
                    or not self._ensure_writable(i, seq, seq.written):
                continue  # seq itself was preempted for blocks
            fed.append((i, seq))
        if fed:
            self._decode(fed)
        return True

    def _decode(self, fed: List[Tuple[int, _ActiveSeq]]) -> None:
        t0 = time.monotonic()
        ids = np.zeros((self.n_slots,), np.int32)
        live = np.zeros((self.n_slots,), bool)
        pos = np.zeros((self.n_slots,), np.int32)
        for i, seq in fed:
            ids[i] = seq.next_input()
            live[i] = True
            pos[i] = seq.written
        dev = self.device
        table = torch.from_numpy(
            self._table_for(max(s.written + 1 for _, s in fed))).to(dev)
        out = self._forward(self._onehot(ids)[:, None],
                            torch.from_numpy(pos).to(dev), table,
                            torch.from_numpy(live).to(dev)[:, None])
        probs = out[:, -1, :].cpu().numpy()
        self.decode_steps += 1
        self.decode_seconds += time.monotonic() - t0
        for i, seq in fed:
            seq.written += 1
            was_sampling = seq.sampling
            if seq.fed < len(seq.prompt):
                seq.fed += 1
            if not was_sampling and not seq.sampling:
                continue  # still prefilling token by token
            self._consume(i, seq, probs[i])
