"""Continuous-batching decode over a paged KV pool, per-slot stripes or
per-slot recurrent state rows — a reduced port of
deeplearning4j_tpu/inference/engine.py (`DecodeScheduler`).

One scheduler thread loops over iterations. Each iteration:

  1. evicts cancelled requests, re-matches mid-prefill slots against the
     prefix trie (paged), and admits queued requests into free slots,
     each restoring its longest cached prefix;
  2. runs at most one prefill chunk (round-robin over prefilling slots),
     padded to a pow2 chunk bucket; the slot's position advances by the
     real token count only (JAX `_prefill_fn` :1352, `_prefill_paged_fn`
     :1420);
  3. runs one decode step over all slots ([n_slots, 1] tokens) with the
     ``live`` mask: idle and mid-prefill rows are batch padding whose
     position does not advance (JAX `_step_fn` :1208, `_step_paged_fn`
     :1241, `_freeze_states` :1182).

Two KV layouts, as in the JAX package:

  - **contiguous** (``kv_pool_mb=0``, the default): each slot owns a
    stripe of every attention layer's cache (``init_state(batch=
    n_slots)``: K/V [n_slots, max_cache_len, Hkv, Dh]). A masked row
    writes at its own frozen position, which the slot's next real write
    overwrites. Prefix reuse goes through a side pool
    (``prefix_cache_mb``): a hit is copied into the stripe
    (`kvpool.gather_blocks`), a finished prompt is copied out
    (`kvpool.scatter_blocks`). A prompt longer than the stripe is refused
    at submit;
  - **paged** (``kv_pool_mb > 0``): the pool (`kvpool.KVPool`) is the
    live cache and the prefix cache at once. Restore is a table remap,
    the first write into a shared page copies it (COW), publish is an
    ownership transfer, blocks are allocated lazily, admission is by pool
    bytes, and a pool that runs dry preempts the latest-submitted slot,
    which re-prefills on resume with its RNG untouched (JAX `_preempt`
    :1884). Masked rows write to the scratch page.

Positions (and, paged, block tables) are host-authoritative: the host
holds each slot's depth (``written``) and ships it with every dispatch.
Every request samples on the host from its own
``np.random.default_rng(seed)``, so its tokens do not depend on the
schedule.

The decode step and the prefill chunks (``decode_graphs``): "on" (the
default) runs each on static buffers — the counterpart of the JAX
package's one jitted program per bucket: one decode runner
(`_DecodeRunner`) per table bucket (paged) or one (contiguous), and one
chunk runner (`_ChunkRunner`) per (chunk bucket, table bucket) pair
(paged) or per chunk bucket (contiguous; the slot is a device index, so
one graph serves every slot). On CUDA tensors each runner is captured
once into a CUDA graph and replayed: the host stages the inputs in one
pinned vector, ships it with one copy, and replays. A decode replay's
``probs`` come back for sampling; a chunk's one output row [vocab] (the
row of its last real token, picked on the device) is copied to the host
only when the chunk ends the prompt (JAX `host_read` under ``if
seq.sampling``, :2768): a non-final chunk makes no device->host copy and
no sync. On CPU tensors the same static-buffer steps run eagerly. "off"
is the caller's explicit choice of the eager step and chunk. A capture
that fails raises; there is no quiet fallback. ``decode_captures`` and
``prefill_captures`` count runners built: at most one per bucket (pair)
over the engine's life, none once `warmup()` has run. Restores,
publishes and COW copies run eagerly.

``transfer_guard``: the counterpart of the JAX engine's device-residency
audit (JAX :479-502). "disallow" runs every scheduler iteration under
``torch.cuda.set_sync_debug_mode("error")``: any synchronizing copy or
read in the loop raises, except the declared ones
— a decode step's probs and a final chunk's row. torch's mode is
process-wide, not per thread: while a guarded engine runs, a sync by any
other thread of the process (a ``/predict`` forward, another engine)
raises too, so a guarded server takes ``/generate`` traffic only. The
guard needs ``decode_graphs="on"`` (the eager step reads positions on
the host); it does nothing on CPU tensors.

``paged_kernel``: "on" (default) reads paged decode attention through the
hand-written CUDA kernel (the plain version on CPU tensors); "off" is the
caller's explicit choice of the layer's gather body.

``metrics`` / ``tracer``: the JAX engine's series (`inference/metrics.py`)
and request spans (`inference/trace.py`): queued, prefix_restore,
prefill (per-chunk spans on the slot track), decode, finish or cancel,
preempted; admit/free, block_alloc, block_cow, preempt/resume and capture
instants.

The supervisor's surface (`inference/supervisor.py`, JAX :559-582,
:3350-3441): the loop stamps ``heartbeat`` once per pass, idle passes
included, and counts ``iterations``; a crash is recorded in ``crashed``
and, supervised (``_on_crash`` set), leaves the handles open for the
supervisor to requeue (unsupervised, it fails them fast); ``fence()``
disowns the engine, so a thread that wakes from a hang exits without
touching a handle; ``shed_queued`` and ``chunk_cap`` are the degradation
ladder's hooks; ``submit(_handle=, _front=)`` is the requeue path. The
failpoint seams ``scheduler.iteration``, ``dispatch.prefill`` and
``dispatch.decode`` fire on the host before the work they guard, and the
fence is checked after each.

Recurrent nets (JAX :82-84, :1182-1216, :1352-1418, :1598): a
`MultiLayerNetwork` (or graph) whose stateful layers are LSTM, GravesLSTM
or GRU is served from the engine's own [n_slots, hidden] h (and c) rows
per layer, never the net's ``_rnn_state``. Admission zeroes the slot's
rows; the decode step writes back only the live rows (``torch.where`` on
the ``live`` mask into the static state buffers), so idle and mid-prefill
slots do not advance; a prefill chunk runs its C positions as C
single-token steps on the slot's rows, the padded steps masked out of the
carry, as the JAX scan does, and writes the rows back by a device index.
Both are captured like the attention ones. There are no positions: no
pool, no prefix reuse (``kv_pool_mb`` or ``prefix_cache_mb`` warn and are
ignored), no length limit.

The logit pipeline (JAX :2090, :2596-2660): a request may carry stop
sequences, a compiled grammar (`logitproc.CompiledGrammar`) and
repetition / presence / frequency penalties; its `logitproc.LogitState`
shapes the host probability row before sampling and finishes the request
with ``"stop"`` (the stop tokens cut off) or ``"grammar"`` (the grammar
admits nothing more). A grammar's additive rows (0 allowed, -inf
forbidden) are uploaded once at admission into a fixed ``[mask_rows,
vocab]`` device table at the compute dtype, by an in-place copy, so the
captured graphs keep their pointers; while a device-resident grammar is
in the batch the step is the masked variant (its own runners: ``out +
masks[mstate]``, row 0 all zeros, so an admit-all grammar is bitwise the
unmasked step). A grammar that does not fit the table is masked on the
host only (``grammar_mask_spills_total``); the host's exact ``allow`` row
applies either way. `warmup(masks=True)` captures the masked family too;
without it the masked runners are captured at first use.

Best-of-n (JAX :2252, :2566): `generate_many` submits a fork group
(`speculative.ForkGroup`); paged, the primary publishes its prompt's
blocks when its prefill ends and the followers, held in the queue until
then, restore them as table remaps.

A net whose compute dtype is bf16 decodes with its caches, one-hots and
mask table at bf16 and its probability rows read back as f32; the paged
kernel declines a query that is not f32, so the paged layers take their
gather body, as in the JAX package.

Speculative decoding (``speculate`` = G > 0; JAX :928-1083, :2776-3045):
a cheap draft proposes G tokens per decode-ready slot per iteration in G
lockstep single-token rounds, and ONE verify forward of the target over
``[n_slots, G + 1]`` chains keeps every position's distribution;
`speculative.accept_tokens` samples each position with the sequence's
own RNG and logit pipeline, so the tokens are those of solo decode. The
draft is the target's first ``draft_blocks`` transformer blocks wired
into its own head (`speculative.build_shallow_draft`, params by
reference) unless ``draft_net`` is given; it keeps a private contiguous
KV stripe per slot even under a paged main cache, fed by a draft chunk
beside every prefill chunk and caught up after prefix restores and
resumes. The verify writes its G + 1 rows (paged, through the table
with ``live`` as the write mask; contiguous, with masked rows written
back unchanged) and the rejected tail is rolled back on the host:
positions are host-authoritative, so rollback is the ``written`` and
``draft_fed`` bookkeeping, plus, paged, returning the pages wholly past
the accepted frontier. The verify (per table bucket, paged), the draft
step and a draft chunk per chunk bucket are runners like the decode
step, captured by `warmup()`; their grammar-masked variants (``out +
masks[mstate]`` per position or round) are captured on first use or by
``warmup(masks=True)``. The verify is a T > 1 step, so it takes the gather
body; the draft's steps are contiguous; only a speculating engine's plain
decode steps launch the paged kernel. The failpoint seam
``dispatch.verify`` fires before the verify opens any span. A net the
speculation cannot serve (recurrent, or a graph the surgery cannot cut,
with no ``draft_net``), or an engine without chunked prefill, warns and
runs unarmed (``speculate == 0``).

KV tiering (``host_cache_mb`` > 0, paged only; JAX :866-897,
:3045-3180, `kvtier.py`): the pool's LRU evictions spill page rows into a
pinned host ring and then CRC-framed disk files (``disk_cache_mb``,
``tier_dir``), and admission looks up the tier past the trie's resident
frontier: a hit queues a background promotion while the slot prefills
its cold suffix, and a promotion that lands is adopted into the trie (an
in-place copy into the pool's page tensors, on the engine's stream,
ordered before the first replay that reads it) and upgrades mid-prefill
slots past it (``kv_tier_restored_tokens_total``). The spill capture
copies the evicted page's rows into a staging tensor on the engine's
stream in the same iteration as the eviction, behind a recorded event the
tier worker waits on; no thread synchronizes the device, and a decode
step never waits on a tier copy. Contiguous and recurrent engines warn
and stay tierless.

The profiler plane (JAX :525-533, :3193-3379, :3686-3836,
`profiler.py`): every iteration's phases are stamped into a
`StepPhaseProfiler` and every dispatch counted by ``(family, bucket)``;
`attribute_costs` installs the analytic cost table, and
`debug_snapshot` (``GET /debug/engine``) reports the slot table, the
pool, the tier, `paged_kernel_status`, the costs and the phase
decomposition. ``profile=False`` disarms the stamps.

Tensor parallelism (``mesh``; JAX :416-428, :602-660,
`inference/sharding.py`): under a ``tp`` mesh of N ranks this process is
rank 0, the driver, and N - 1 spawned followers each hold a shard
(`parallel/mesh.py`). Attention heads and the FFN's hidden units split
Megatron-style (the output head replicated), the KV pages, stripes, int8
scale pages and the side pool split by head, so ``kv_pool_mb`` and
``prefix_cache_mb`` are per-rank budgets and the pool holds N times the
blocks. Every device operation the engine issues — the decode step, a
prefill chunk, a slot reset, a contiguous restore and publish, a COW
copy, a grammar's mask upload — is broadcast first as one command (op,
args and the step's packed int32 vector, `_DecodeRunner`'s layout), and
every rank runs it on its shard with the same two all-reduces a
transformer block; the scheduler, the pool's books, sampling and the
logit pipeline stay on the driver. The tp step runs eagerly
(``decode_graphs="on"`` with tp > 1 raises: a gloo collective cannot sit
in a captured graph; ROADMAP A7.2.6). Speculation joins the mesh (JAX
:996-1000): the draft runs sharded under the target's specs with
head-split stripes, and the verify, the draft step and the draft chunk
are one command each, rollback staying the driver's bookkeeping. The KV
tiers stay on the driver and hold whole blocks: a spill gathers every
rank's head slice of the evicted page (one all-gather a page group), a
promotion broadcasts the block's rows and each rank copies its heads in
place; both run on the tier's path, never the step's. A follower that
dies fails the driver's next collective:
the engine records a crash, and a supervised server rebuilds it with new
followers. ``tp`` is the tp in force (1 where the disable rules apply,
with JAX's warnings), ``mesh_topology()`` reports it.
"""
from __future__ import annotations

import contextlib
import threading
import time
import warnings
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models.sampling import sample_logits
from ..nn.layers.attention import SelfAttentionLayerImpl
from ..nn.layers.base import BaseRecurrentImpl
from ..nn.layers.recurrent import GravesBidirectionalLSTMImpl
from ..nn.step_graph import gc_paused
from ..ops import cuda_kernels as ck
from ..util.device import DeviceLike, resolve_device
from . import failpoints
from .batcher import QueueFullError, bucket_for, pow2_buckets
from .kvpool import (SCRATCH_BLOCK, KVPool, blocks_for, gather_blocks,
                     scatter_blocks)
from .logitproc import CompiledGrammar, LogitState, MaskPool
from .metrics import MetricsRegistry, default_registry
from .profiler import StepPhaseProfiler, device_peak_flops, program_costs
from .sharding import (TP_AXIS, decode_mesh, effective_specs,
                       kv_heads_shardable, shard_decode_params, shard_graph,
                       shard_modes)
from .speculative import accept_tokens, build_shallow_draft
from .trace import FlightRecorder, default_recorder, new_request_id
from ..parallel.mesh import COLLECTIVE_KINDS, SERVICE_OPS

# smallest prefill chunk bucket (JAX engine.py:122)
_MIN_CHUNK_BUCKET = 16

# the device operations a tensor-parallel driver mirrors to its followers
# (parallel/mesh.py's command loop): the decode step, a prefill chunk, a
# slot reset (which zeroes the draft stripe rows too), a contiguous
# restore (gather) and publish (scatter), a COW page copy and a grammar
# mask upload; speculation's verify (paged per table bucket, or
# contiguous), draft step and draft chunk; the KV tier's spill capture
# (each rank's head slice of evicted pages, gathered to the driver) and
# promotion (the driver's rows, each rank copying its head slice in place)
(OP_DECODE, OP_PREFILL, OP_RESET, OP_GATHER, OP_SCATTER, OP_COPY,
 OP_MASK, OP_VERIFY, OP_DRAFT, OP_DRAFT_CHUNK, OP_SPILL,
 OP_PROMOTE) = range(SERVICE_OPS, SERVICE_OPS + 12)

# transfer_guard level -> torch.cuda.set_sync_debug_mode level
_GUARD_MODES = {None: None, "disallow": "error"}

# one side stream per device for every engine's captures: cuBLAS keeps a
# workspace for each stream it has run on for the life of the process, so
# a stream per engine would keep one more workspace per engine restart
_CAPTURE_STREAMS: Dict[torch.device, "torch.cuda.Stream"] = {}
_CAPTURE_STREAMS_LOCK = threading.Lock()


def _capture_stream(device: torch.device) -> "torch.cuda.Stream":
    with _CAPTURE_STREAMS_LOCK:
        s = _CAPTURE_STREAMS.get(device)
        if s is None:
            s = _CAPTURE_STREAMS[device] = torch.cuda.Stream(device)
        return s

__all__ = ["DecodeScheduler", "DecodeHandle", "PromptTooLongError",
           "QueueFullError", "LoadSheddedError", "EngineCrashedError"]


class PromptTooLongError(ValueError):
    """The request cannot fit the KV cache: contiguous mode ``len(prompt)
    + max_new_tokens - 1 > max_cache_len``; paged mode more blocks than
    the whole pool (``blocks_needed`` / ``blocks_available``)."""

    blocks_needed: Optional[int] = None
    blocks_available: Optional[int] = None


class LoadSheddedError(QueueFullError):
    """The request was dropped from the queue by the degradation ladder
    (`inference/supervisor.py` level >= 1). A QueueFullError, so the
    server's retryable 503 applies unchanged."""


class EngineCrashedError(RuntimeError):
    """The scheduler loop died with this request in flight and no
    supervisor attached to recover it."""


class _EngineFenced(Exception):
    """Raised inside a fenced engine's thread: a supervisor disowned it,
    so it must exit without touching a handle."""


class DecodeHandle:
    """Completion handle for one submitted generation request."""

    def __init__(self, prompt_len: int, max_new_tokens: int,
                 request_id: Optional[str] = None, priority: int = 0):
        self.prompt_len = prompt_len
        self.max_new_tokens = max_new_tokens
        self.request_id = request_id or new_request_id()
        self.priority = int(priority)  # shedding order (higher lasts)
        self.retries = 0  # crash-recovery resubmissions (supervisor)
        self.tokens: List[int] = []
        # "length" | "eos" | "stop" | "grammar" | "cancelled"
        self.finish_reason: Optional[str] = None
        # the SSE backing (logitproc.TokenStream): the scheduler pushes
        # each token as it decodes, _finish() closes it
        self.stream = None
        self._done = threading.Event()
        self._cancel = threading.Event()
        self._error: Optional[BaseException] = None
        self.t_submit = time.monotonic()
        # stamped by the scheduler thread: queued [submit, admitted],
        # restore [admitted, restored], prefill [restored, first token],
        # decode [first token, done] are contiguous, so timings() sums
        self.t_admitted: Optional[float] = None
        self.t_restored: Optional[float] = None
        self.t_first_token: Optional[float] = None
        self.t_done: Optional[float] = None
        # engine iterations this sequence was stepped before its first token
        self.steps_to_first_token: Optional[int] = None

    def timings(self) -> Dict[str, float]:
        """Per-phase wall time (ms), JAX engine.py:206: ``queue_ms +
        restore_ms + prefill_ms + decode_ms == total_ms`` (a request that
        never reached a boundary reports 0 for the phases past it)."""
        end = self.t_done if self.t_done is not None else time.monotonic()
        admitted = self.t_admitted if self.t_admitted is not None else end
        restored = self.t_restored if self.t_restored is not None \
            else admitted
        first = self.t_first_token if self.t_first_token is not None else end
        first = max(first, restored)
        return {"queue_ms": round((admitted - self.t_submit) * 1e3, 3),
                "restore_ms": round((restored - admitted) * 1e3, 3),
                "prefill_ms": round((first - restored) * 1e3, 3),
                "decode_ms": round((end - first) * 1e3, 3),
                "total_ms": round((end - self.t_submit) * 1e3, 3)}

    def _finish(self, err: Optional[BaseException] = None) -> None:
        if self._done.is_set():
            return  # first finisher wins (a supervisor's shutdown can
            # race the engine's own teardown over the same handle)
        self._error = err
        self.t_done = time.monotonic()
        self._done.set()
        if self.stream is not None:
            self.stream.close(self, err)

    def _reset_for_retry(self) -> None:
        """Crash recovery (JAX :238): wipe the partial progress so the
        resubmission re-runs the request from scratch on the rebuilt
        engine. The resubmitted sequence reseeds its RNG, so the re-run
        gives the same tokens; ``t_submit`` survives (latency counts from
        the original submit). The stream is kept: its pushes dedupe by
        index, so a streaming client sees no restart."""
        if self._done.is_set():
            raise RuntimeError("cannot retry a handle that already finished")
        self.retries += 1
        self.tokens = []
        self._error = None
        self.t_admitted = self.t_restored = None
        self.t_first_token = self.t_done = None
        self.steps_to_first_token = None
        self.finish_reason = None

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
                 "top_p", "eos_id", "steps", "pool_node", "block_ids",
                 "shared", "written", "phase", "resumed", "folded",
                 "cow_starved", "proc", "fork", "draft_fed")

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
        self.steps = 0  # engine iterations that advanced this sequence
        self.pool_node = None  # pinned trie node of the restored prefix
        self.block_ids: List[int] = []  # paged: table entries, logical order
        self.shared: List[bool] = []  # True = trie-owned (COW on write)
        self.written = 0  # positions written to the slot's KV rows
        # the request-track span open now: "queued" -> "prefill" ->
        # "decode", with "preempted" bridging a swap-out
        self.phase = "queued"
        self.resumed = False  # preempted at least once
        self.folded = 0  # generated tokens folded into `prompt` by preempts
        # set when a COW page could not be had even by preempting (every
        # page backs this very prompt's pinned prefix): the resume's
        # restore then stops one block short, once
        self.cow_starved = False
        self.proc: Optional[LogitState] = None  # the logit pipeline
        self.fork = None  # speculative.ForkGroup of a best-of-n candidate
        # speculation: tokens of `full_context()` the draft has ingested
        # (its stripe's depth)
        self.draft_fed = 0

    def known_tokens(self) -> int:
        """len(full_context()) without building the list."""
        return len(self.prompt) + len(self.handle.tokens) - self.folded

    def full_context(self) -> List[int]:
        """Every token the sequence is conditioned on (the prompt, which
        absorbs preempt-folded tokens, then the unfolded generated tail):
        the draft's catch-up target."""
        return self.prompt + self.handle.tokens[self.folded:]

    def tail_context(self, k: int) -> List[int]:
        """The last ``k`` tokens of `full_context`, in O(k)."""
        gen = self.handle.tokens[self.folded:] if k > 0 else []
        if len(gen) >= k:
            return gen[len(gen) - k:]
        return self.prompt[len(self.prompt) - (k - len(gen)):] + gen

    def next_input(self) -> int:
        if self.fed < len(self.prompt):
            return self.prompt[self.fed]
        return self.handle.tokens[-1]

    @property
    def sampling(self) -> bool:
        """Past the last prompt token, every step's output is sampled."""
        return self.fed >= len(self.prompt)


class _DecodeRunner:
    """One all-slots step of ``width`` tokens a slot at table bucket ``nb``
    (None: contiguous) on static buffers: the counterpart of one jitted
    program of the JAX engine. ``family``: "decode" (width 1; JAX
    `_step_fn`), "verify" (width G + 1; `_verify_fn`) or "draft" (width
    1, the draft net; `_draft_step_fn`), each with a ``masked`` variant.

    The inputs live in one int32 vector ``packed`` = [ids (n_slots x
    width) | live | pos | mstate (masked: each slot's mask-table row per
    position) | table rows], filled from the host buffer ``stage`` (pinned
    on the card) by one copy per step; ``out`` (the f32 probs, [n_slots,
    vocab] or [n_slots, width, vocab]) is the one output. Every step ends
    with the probs copy to the host, which waits for the staging copy
    too, so the next fill never overwrites a stage still being read.
    ``graph`` is the captured step on the card (None on the CPU, where the
    step runs eagerly on the same buffers), and ``launches`` the kernel
    launches one replay makes, counted at capture."""

    def __init__(self, n_slots: int, nb: Optional[int],
                 device: torch.device, masked: bool = False,
                 width: int = 1, family: str = "decode"):
        s, w = n_slots, width
        off = [0]

        def take(n):
            v = self.packed[off[0]:off[0] + n]
            off[0] += n
            return v
        n = s * (2 * w + 2 if masked else w + 2) + s * (nb or 0)
        self.nb = nb
        self.key = nb
        self.masked = masked
        self.width = w
        self.family = ("masked_" if masked else "") + family
        self.stage = torch.zeros(n, dtype=torch.int32,
                                 pin_memory=device.type == "cuda")
        self.host = self.stage.numpy()
        self.packed = torch.zeros(n, dtype=torch.int32, device=device)
        self.ids = take(s * w).view(s, w) if w > 1 else take(s)
        self.live = take(s)
        self.pos = take(s)
        self.mstate = ((take(s * w).view(s, w) if w > 1 else take(s))
                       if masked else None)
        self.table = take(s * nb).view(s, nb) if nb else None
        self.out: Optional[torch.Tensor] = None
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.launches: Dict[str, int] = {}

    def fill(self, ids: np.ndarray, live: np.ndarray, pos: np.ndarray,
             table: Optional[np.ndarray],
             mstate: Optional[np.ndarray] = None) -> None:
        h = self.host
        parts = [ids, live, pos] + ([mstate] if self.masked else []) \
            + ([table] if self.nb else [])
        o = 0
        for a in parts:
            a = np.asarray(a).reshape(-1)
            h[o:o + a.shape[0]] = a
            o += a.shape[0]
        self.packed.copy_(self.stage, non_blocking=True)


class _ChunkRunner:
    """One prefill chunk of ``bucket`` positions at table bucket ``nb``
    (None in contiguous mode) on static buffers: the counterpart of one
    jitted prefill program of the JAX engine (`_prefill_paged_fn` :1420,
    `_prefill_fn` :1352).

    The inputs live in one int32 vector ``packed`` = [ids (bucket) |
    n_real | pos | slot | table row (nb)]: the write mask, the one-hot
    and the pick of the last real row are built from them on the device,
    and the contiguous slot is a device index (an indexed read and write
    of its stripe rows), so one graph serves every slot. ``out`` [vocab]
    is the one output. A non-final chunk is not followed by any host
    read, so each fill stages into a fresh pinned block of the caching
    host allocator, which keeps the block until its copy has run (a
    static stage could be overwritten under a copy still queued)."""

    def __init__(self, bucket: int, nb: Optional[int], device: torch.device,
                 family: str = "prefill"):
        self.bucket = bucket
        self.nb = nb
        self.key = (bucket, nb)
        # "prefill", or "draft_prefill": the draft's chunk into its own
        # stripe (JAX `_draft_prefill_fn` :1501)
        self.family = family
        self.device = device
        b = bucket
        self.packed = torch.zeros(b + 3 + (nb or 0), dtype=torch.int32,
                                  device=device)
        self.ids = self.packed[:b]
        self.n_real = self.packed[b:b + 1]
        self.pos = self.packed[b + 1:b + 2]
        self.slot = self.packed[b + 2:b + 3]
        self.table = self.packed[b + 3:].view(1, nb) if nb else None
        self.host: Optional[np.ndarray] = None
        self.out: Optional[torch.Tensor] = None
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.launches: Dict[str, int] = {}

    def fill(self, ids: np.ndarray, n_real: int, pos: int, slot: int,
             table_row: Optional[np.ndarray]) -> None:
        b = self.bucket
        h = np.empty(self.packed.shape[0], np.int32)
        h[:b] = ids
        h[b:b + 3] = (n_real, pos, slot)
        if self.nb:
            h[b + 3:] = table_row
        self.host = h  # what a tp driver ships to its followers
        src = torch.from_numpy(h)
        if self.device.type == "cuda":
            src = src.pin_memory()
        self.packed.copy_(src, non_blocking=True)


class DecodeScheduler:
    """Continuous-batching decode over a transformer ComputationGraph or a
    recurrent MultiLayerNetwork.

    ``net``: a port `ComputationGraph` (e.g. `models/zoo.transformer_lm`)
    or `MultiLayerNetwork` (e.g. `models/zoo.char_rnn_lstm`) whose output
    is a next-token distribution; it must live on ``device``. Its stateful
    layers are either all attention layers (KV caches) or all recurrent
    (h/c rows; the pool and prefix options are ignored with a warning). ``kv_pool_mb``: byte budget (MiB) of the paged KV pool;
    0 (default) gives contiguous per-slot stripes, with a side prefix
    pool of ``prefix_cache_mb`` MiB when that is > 0. ``kv_block``:
    positions per page or pool block. ``kv_dtype="int8"`` stores int8
    pages with f32 per-(position, head) scales (paged only).
    ``prefill_chunk``: max prompt tokens per prefill dispatch (<= 1 feeds
    prompts token by token through the decode step). ``decode_graphs``:
    "on" or "off", for the decode step and the prefill chunks alike;
    ``transfer_guard``: None or "disallow" (see the module docstring).
    ``mask_rows``: rows of the grammar mask table (row 0 the admit-all
    row); <= 1 masks grammars on the host only. ``speculate``: draft G
    tokens a slot an iteration and verify them in one forward (0: off);
    ``draft_blocks``: the depth of the default shallow draft (default
    half the attention blocks); ``draft_net``: an explicit draft
    ComputationGraph on the same device and vocabulary instead (see the
    module docstring). ``host_cache_mb`` / ``disk_cache_mb``: the KV
    tiers' budgets (MiB; paged only), ``tier_dir`` the disk tier's
    directory (a fresh temporary one by default), ``tier_chunk_kib`` the
    tier worker's pacing grant an iteration (8 times that while idle).
    ``profiler``: a `StepPhaseProfiler` to stamp (default: a fresh one on
    the engine's metrics, armed unless ``profile=False``). ``mesh``:
    None, an int N > 1 or a `parallel.mesh.ProcessMesh` with a ``tp``
    axis: tensor-parallel decode over N ranks, this process rank 0 (see
    the module docstring and `_init_mesh`). ``device`` defaults to "cuda"
    and raises without one.
    """

    def __init__(self, net, vocab_size: int, *, n_slots: int = 4,
                 max_queue: int = 64, prefill_chunk: int = 64,
                 prefix_cache_mb: float = 0.0, kv_block: int = 16,
                 kv_pool_mb: float = 0.0, kv_dtype: Optional[str] = None,
                 paged_kernel: str = "on", decode_graphs: str = "on",
                 mask_rows: int = 64, speculate: int = 0,
                 draft_blocks: Optional[int] = None, draft_net=None,
                 host_cache_mb: float = 0.0, disk_cache_mb: float = 0.0,
                 tier_dir: Optional[str] = None, tier_chunk_kib: int = 512,
                 metrics: Optional[MetricsRegistry] = None,
                 tracer: Optional[FlightRecorder] = None,
                 profiler: Optional[StepPhaseProfiler] = None,
                 profile: bool = True,
                 transfer_guard: Optional[str] = None,
                 mesh=None,
                 device: DeviceLike = "cuda", _tp_shard=None):
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
        if decode_graphs not in ("on", "off"):
            raise ValueError(f"decode_graphs must be 'on' or 'off', got "
                             f"{decode_graphs!r}")
        if transfer_guard not in _GUARD_MODES:
            raise ValueError(f"transfer_guard must be None or 'disallow', "
                             f"got {transfer_guard!r}")
        if _GUARD_MODES[transfer_guard] and decode_graphs != "on":
            raise ValueError("transfer_guard needs decode_graphs='on': the "
                             "eager step reads positions on the host")
        if self.device.type == "cuda":
            # f32 matmuls at full f32 precision: TF32 keeps ~10 mantissa
            # bits, enough to flip near-tied tokens against the reference
            # decode. Process-wide switches, set before any dispatch or
            # capture.
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        if _tp_shard is None:
            net._check_init()
        self.net = net
        # the one-hots, caches, recurrent rows and mask table: the compute
        # dtype (JAX `_compute_dtype_of`)
        self._dtype = net.compute_dtype
        self.vocab_size = int(vocab_size)
        self.n_slots = int(n_slots)
        self.max_queue = int(max_queue)
        self.prefill_chunk = int(prefill_chunk)
        self.kv_block = int(kv_block)
        self.paged_kernel = paged_kernel
        self.decode_graphs = decode_graphs
        self.transfer_guard = transfer_guard
        # torch's sync debug level while the loop runs (CUDA only)
        self._guard_mode = (_GUARD_MODES[transfer_guard]
                            if self.device.type == "cuda" else None)
        self.metrics = metrics if metrics is not None else default_registry()
        self.tracer = tracer if tracer is not None else default_recorder()
        # the step-phase profiler: single-writer state the scheduler
        # thread stamps; disarmed, every stamp is one attribute test
        self.profiler = profiler if profiler is not None else \
            StepPhaseProfiler(self.metrics, enabled=bool(profile),
                              peak_flops=device_peak_flops(
                                  self.device, net.compute_dtype))
        # serializes attribute_costs' first computation between HTTP
        # readers (never taken by the scheduler thread)
        self._attr_lock = threading.Lock()
        self._attr_failed = False
        sfx = self.tracer.track_scope("engine")
        self._sched_track = "scheduler" + sfx
        self._slot_tracks = [f"slot {i}{sfx}" for i in range(self.n_slots)]
        self._graph = hasattr(net.conf, "vertices")  # facade
        self._out_name = net.conf.network_outputs[0] if self._graph else None
        items = sorted(net._impls.items()) if self._graph \
            else enumerate(net._impls)
        stateful = {k: impl for k, impl in items
                    if isinstance(impl, BaseRecurrentImpl)}
        attn = {k: impl for k, impl in stateful.items()
                if isinstance(impl, SelfAttentionLayerImpl)}
        rec = {k: impl for k, impl in stateful.items() if k not in attn}
        if not stateful:
            raise ValueError("the decode engine serves stateful nets: this "
                             "net has no SelfAttentionLayer to page and no "
                             "recurrent layer to step")
        if attn and rec:
            raise ValueError("the decode engine serves attention nets or "
                             "recurrent nets, not a net with both")
        if any(isinstance(i, GravesBidirectionalLSTMImpl)
               for i in rec.values()):
            raise ValueError("a bidirectional LSTM needs the whole sequence "
                             "and cannot be stepped token by token")
        # recurrent: h/c rows per slot, no positions (JAX :398, :406)
        self.recurrent = bool(rec)
        # -- the tensor-parallel mesh (inference/sharding.py; JAX
        # :602-660), resolved before the KV layout: the pool's budget is
        # per rank and its pages hold the rank's heads
        self._init_mesh(mesh, attn, _tp_shard, decode_graphs=decode_graphs,
                        kw=dict(n_slots=n_slots, prefill_chunk=prefill_chunk,
                                prefix_cache_mb=prefix_cache_mb,
                                kv_block=kv_block, kv_pool_mb=kv_pool_mb,
                                kv_dtype=kv_dtype, paged_kernel=paged_kernel,
                                mask_rows=mask_rows, speculate=speculate,
                                draft_blocks=draft_blocks))
        tp = self.tp
        itemsize = torch.empty((), dtype=self._dtype).element_size()
        shapes = {name: (impl._kv_heads(), impl.conf.n_out // impl.conf.n_heads)
                  for name, impl in attn.items()}
        # the rank's own attention impls (its local heads under tp)
        attn_local = ({name: self._fwd_net._impls[name] for name in attn}
                      if tp > 1 else attn)
        layers = {n: (h, d, itemsize) for n, (h, d) in shapes.items()}
        dev = self.device
        self.paged = bool(kv_pool_mb and kv_pool_mb > 0) and not self.recurrent
        self.kv_dtype: Optional[str] = None
        self.pool: Optional[KVPool] = None
        self.restore_buckets: List[int] = []
        self.table_buckets: List[int] = []
        self._table: Optional[np.ndarray] = None
        self._states: Dict = {}
        if self.recurrent:
            if kv_pool_mb and kv_pool_mb > 0:
                warnings.warn(
                    f"kv_pool_mb={kv_pool_mb} requested but paged KV decode "
                    "is DISABLED (contiguous per-slot state instead): the "
                    "model has no attention KV cache to page",
                    RuntimeWarning, stacklevel=2)
            if prefix_cache_mb and prefix_cache_mb > 0:
                warnings.warn(
                    f"prefix_cache_mb={prefix_cache_mb} requested but the "
                    "prefix KV pool is DISABLED: the model has no attention "
                    "KV cache to share", RuntimeWarning, stacklevel=2)
            if kv_dtype:
                warnings.warn(
                    f"kv_dtype={kv_dtype!r} requested but the paged KV pool "
                    "did not engage (a KV cache dtype applies to the pool's "
                    "pages); serving with the model-dtype state instead",
                    RuntimeWarning, stacklevel=2)
            for key, impl in rec.items():
                self._states[key] = impl.init_state(self.n_slots,
                                                    dtype=self._dtype,
                                                    device=dev)
            self._cache_cap: Optional[int] = None
        elif self.paged:
            self.kv_dtype = kv_dtype
            self.pool = KVPool(layers, block=self.kv_block,
                               budget_bytes=int(kv_pool_mb * (1 << 20)),
                               cache_dtype=kv_dtype, shard_factor=tp,
                               metrics=self.metrics, tracer=self.tracer)
            if self.pool.capacity_blocks < 1:
                raise ValueError(f"kv_pool_mb={kv_pool_mb} holds fewer than "
                                 f"two {self.kv_block}-position blocks")
            if prefix_cache_mb and prefix_cache_mb > 0:
                warnings.warn(
                    "prefix_cache_mb is ignored when kv_pool_mb is set: the "
                    "paged pool IS the prefix cache", RuntimeWarning,
                    stacklevel=2)
            pages = self.pool.capacity_blocks + 1  # page 0 = scratch
            for name, (hkv, dh) in shapes.items():
                shape = (pages, self.kv_block, hkv // tp, dh)
                if kv_dtype == "int8":
                    self._states[name] = {
                        "k_pages": torch.zeros(shape, dtype=torch.int8,
                                               device=dev),
                        "v_pages": torch.zeros(shape, dtype=torch.int8,
                                               device=dev),
                        "k_scales": torch.zeros(shape[:-1],
                                                dtype=torch.float32, device=dev),
                        "v_scales": torch.zeros(shape[:-1],
                                                dtype=torch.float32, device=dev)}
                else:
                    self._states[name] = {
                        "k_pages": torch.zeros(shape, dtype=self._dtype,
                                               device=dev),
                        "v_pages": torch.zeros(shape, dtype=self._dtype,
                                               device=dev)}
            self._cache_cap = self.pool.capacity_blocks * self.kv_block
            self.table_buckets = pow2_buckets(self.pool.capacity_blocks)
            self._table = np.full((self.n_slots, self.pool.capacity_blocks),
                                  SCRATCH_BLOCK, np.int32)
        else:
            if kv_dtype:
                warnings.warn(
                    f"kv_dtype={kv_dtype!r} requested but the paged KV pool "
                    "did not "
                    "engage (int8 KV lives in the pool's pages); serving "
                    "with the model-dtype cache instead", RuntimeWarning,
                    stacklevel=2)
            # per-slot stripes; positions stay on the host
            for name, impl in attn_local.items():
                st = impl.init_state(self.n_slots, dtype=self._dtype,
                                     device=dev)
                self._states[name] = {"k": st["k"], "v": st["v"]}
            self._cache_cap = min(int(st["k"].shape[1])
                                  for st in self._states.values())
            if prefix_cache_mb and prefix_cache_mb > 0:
                pool = None
                if self._cache_cap >= self.kv_block:
                    pool = KVPool(layers, block=self.kv_block,
                                  budget_bytes=int(prefix_cache_mb * (1 << 20)),
                                  paged=False, dtype=self._dtype, device=dev,
                                  shard_factor=tp, metrics=self.metrics,
                                  tracer=self.tracer)
                if pool is not None and pool.capacity_blocks > 0:
                    self.pool = pool
                    self.restore_buckets = pow2_buckets(
                        self._cache_cap // self.kv_block)
                else:
                    warnings.warn(
                        f"prefix_cache_mb={prefix_cache_mb} requested but the "
                        "prefix KV pool is DISABLED: "
                        + (f"kv_block={kv_block} exceeds max_cache_len="
                           f"{self._cache_cap}" if pool is None
                           else "the byte budget is smaller than two "
                                f"{self.kv_block}-position blocks"),
                        RuntimeWarning, stacklevel=2)
        if self.prefill_chunk > 1:
            lo = min(_MIN_CHUNK_BUCKET, self.prefill_chunk)
            self.prefill_buckets = [b for b in pow2_buckets(self.prefill_chunk)
                                    if b >= lo]
        else:
            self.prefill_buckets = []
        # the grammar mask table (JAX :899-925): [mask_rows, vocab] at the
        # compute dtype, additive (0 allowed, -inf forbidden), row 0 the
        # admit-all row; a grammar's rows are copied in place at admission
        self.mask_rows = int(mask_rows)
        self.maskpool: Optional[MaskPool] = None
        self._masks: Optional[torch.Tensor] = None
        self.mask_buckets: List[int] = []
        if self.mask_rows > 1:
            lo = min(8, self.mask_rows - 1)
            self.mask_buckets = [b for b in pow2_buckets(self.mask_rows - 1)
                                 if b >= lo]
            self.maskpool = MaskPool(self.mask_rows, self.mask_buckets)
            self._masks = torch.zeros((self.mask_rows, self.vocab_size),
                                      dtype=self._dtype, device=dev)
        self._init_speculation(speculate, draft_blocks, draft_net, attn,
                               None if _tp_shard is None else _tp_shard[5])
        if self._tp_driver:
            self._attach_followers()
        # -- hierarchical KV tiering (JAX :866-897, kvtier.py): opt-in;
        # host_cache_mb=0 builds no TierManager and adds no hot-path work
        self.tier = None
        self._tier_chunk = int(tier_chunk_kib) << 10
        if host_cache_mb and host_cache_mb > 0:
            if not self.paged:
                warnings.warn(
                    f"host_cache_mb={host_cache_mb} requested but paged KV "
                    "decode is disabled — KV tiering needs the paged pool "
                    "and stays off", RuntimeWarning, stacklevel=2)
            else:
                from .kvtier import TierManager
                if disk_cache_mb and disk_cache_mb > 0 and not tier_dir:
                    import tempfile
                    tier_dir = tempfile.mkdtemp(prefix="kvtier-")
                self.tier = TierManager(
                    host_bytes=int(host_cache_mb * (1 << 20)),
                    disk_bytes=int(disk_cache_mb * (1 << 20)),
                    disk_dir=tier_dir, chunk_bytes=self._tier_chunk,
                    metrics=self.metrics, tracer=self.tracer)
                self.pool.tier = self.tier
                # the tier holds whole blocks (every head): under tp a
                # block is tp ranks' pages
                self.tier.attach_engine(self._tier_capture,
                                        self.pool.bytes_per_block * self.tp,
                                        self.kv_block, device=self.device)
                # one spill's stacks: a [rows, block, ...] tensor per
                # dtype and shape of the page tensors
                stacks: Dict[tuple, int] = {}
                for st in self._states.values():
                    for pages in st.values():
                        k = (self._full_row_shape(pages), pages.dtype)
                        stacks[k] = stacks.get(k, 0) + 1
                self.tier.prewarm_host([((n,) + s, d)
                                        for (s, d), n in stacks.items()])
                self.tier.wake = self._wake
        self._slots: List[Optional[_ActiveSeq]] = [None] * self.n_slots
        self._queue: List[_ActiveSeq] = []
        self._cond = threading.Condition()
        self._running = False
        self._thread: Optional[threading.Thread] = None
        self._prefill_next = 0
        self._published_seen = 0  # pool.published_blocks at the last upgrade
        self._emitted_this_iter = 0
        # -- the supervisor's surface (inference/supervisor.py) --
        # stamped once per loop pass, idle passes included (the idle wait
        # wakes every 0.1 s), so staleness means stuck, not quiet
        self.heartbeat = time.monotonic()
        self.iterations = 0  # loop passes completed
        self.crashed: Optional[BaseException] = None
        # set by fence(): a disowned engine's thread exits at its next
        # check without touching a handle its replacement now owns
        self._fenced = False
        # the supervisor's crash hook; None: a crash fails handles fast
        self._on_crash: Optional[Callable[[BaseException], None]] = None
        # degradation level >= 2 caps prefill chunks (the smaller
        # buckets' runners exist already: nothing new is captured)
        self.chunk_cap: Optional[int] = None
        # the captured steps: one decode runner per table bucket (paged)
        # or one (contiguous, key None), one chunk runner per (chunk
        # bucket, table bucket) (contiguous: (chunk bucket, None)), all
        # sharing one graph memory pool
        self._runners: Dict[Optional[int], _DecodeRunner] = {}
        self._chunk_runners: Dict[Tuple[int, Optional[int]],
                                  _ChunkRunner] = {}
        # the masked decode steps, one per table bucket like the unmasked
        # ones; captured by warmup(masks=True), else at first use
        self._mrunners: Dict[Optional[int], _DecodeRunner] = {}
        self._graph_pool = None
        self.decode_captures = 0
        self.prefill_captures = 0
        self.masked_captures = 0
        self._warmed = False
        self.warmup_seconds: Optional[float] = None
        # scheduler-thread counters, read by callers between runs
        self.decode_steps = 0
        self.decode_seconds = 0.0
        self.prefill_chunks = 0
        self.prefill_seconds = 0.0
        self.final_chunks = 0  # chunks that ended a prompt
        self.chunk_row_reads = 0  # chunk output rows copied to the host
        self.preemptions = 0
        self.cow_copies = 0
        self.restored_tokens = 0  # prompt positions skipped by prefix hits
        self.masked_steps = 0  # decode steps that ran the masked variant
        self.masked_seconds = 0.0
        self.forks = 0  # best-of-n followers that attached to a publish
        # speculation: the speculative runners by (family, key), their
        # captures by family, and the scheduler thread's counters
        self._spec_runners: Dict[Tuple[str, object], object] = {}
        self.spec_captures: Dict[str, int] = {}
        self.spec_rounds = 0  # verify dispatches
        self.spec_proposed = 0
        self.spec_accepted = 0
        self.draft_steps = 0
        self.draft_chunks = 0
        self.verify_seconds = 0.0
        self.draft_seconds = 0.0
        # kernel launches inside the verify and the draft's dispatches
        self.spec_launches = 0
        # tiering: blocks promoted into the trie, prompt tokens that
        # mid-prefill upgrades skipped onto them, and the scheduler's
        # seconds spent integrating promotions
        self.promoted_blocks = 0
        self.tier_restored_tokens = 0
        self.promote_seconds = 0.0
        m = self.metrics
        if self.tp > 1:
            # the mesh's size for /metrics, /info and the serve banner (the
            # per-rank pool bytes are kvpool.py's gauges)
            m.gauge("decode_mesh_devices").set(self.tp)
        self._m_queue_depth = m.gauge("decode_queue_depth")
        self._m_active = m.gauge("decode_active_slots")
        self._m_occupancy = m.histogram("decode_slot_occupancy", lo=1.0,
                                        hi=float(self.n_slots) + 1,
                                        per_decade=12)
        self._m_tokens = m.counter("decode_tokens_total")
        self._m_seqs = m.counter("decode_sequences_total")
        self._m_rejected = m.counter("decode_rejected_total")
        self._m_cancelled = m.counter("decode_cancelled_total")
        self._m_latency = m.histogram("decode_seq_latency_sec")
        self._m_ttft = m.histogram("decode_time_to_first_token_sec")
        self._m_step_time = m.histogram("decode_step_time_sec")
        self._m_prefill_tokens = m.counter("prefill_tokens_total")
        self._m_first_token = m.histogram(
            "generate_first_token_seconds",
            help="submit -> first output token (TTFT), seconds")
        self._m_constrained = m.counter(
            "constrained_requests_total",
            help="requests submitted with a grammar constraint")
        if self.maskpool is not None:
            self._m_mask_rows = m.gauge(
                "grammar_mask_rows_resident",
                help="device mask-table rows held by resident grammars")
            self._m_mask_spill = m.counter(
                "grammar_mask_spills_total",
                help="grammar admissions masked on the host only (mask "
                     "table full or grammar too large)")
        self._m_prefill_chunk = m.histogram(
            "prefill_chunk_size", lo=1.0,
            hi=float(max(self.prefill_buckets or [1])) + 1, per_decade=12)
        if self.paged:
            m.gauge("paged_kernel_engaged",
                    help="paged decode attention runs through the "
                         "hand-written kernel").set(
                1.0 if paged_kernel == "on" else 0.0)
            self._m_preempted = m.counter("decode_preempted_total")
            # best-of-n followers that attached to their group's
            # published prompt blocks (table remaps)
            self._m_forks = m.counter("decode_forks_total")
        if self.pool is not None:
            self._m_prefix_lookups = m.counter("prefix_cache_lookups_total")
            self._m_prefix_hits = m.counter("prefix_cache_hits_total")
            self._m_prefix_lookup_tokens = m.counter(
                "prefix_cache_lookup_tokens_total")
            self._m_prefix_hit_tokens = m.counter(
                "prefix_cache_hit_tokens_total")
            m.ratio("prefix_cache_hit_rate", self._m_prefix_hit_tokens,
                    self._m_prefix_lookup_tokens)
        if self.tier is not None:
            self._m_tier_promoted = m.counter(
                "kv_tier_promoted_blocks_total",
                "tiered blocks adopted back into the device trie")
            self._m_tier_tokens = m.counter(
                "kv_tier_restored_tokens_total",
                "prompt tokens served from tier promotions instead of "
                "recompute (mid-prefill upgrades)")
        if self.speculate:
            self._m_spec_proposed = m.counter("spec_tokens_proposed_total")
            self._m_spec_accepted = m.counter("spec_tokens_accepted_total")
            m.ratio("spec_acceptance_rate", self._m_spec_accepted,
                    self._m_spec_proposed)

    def _init_mesh(self, mesh, attn, shard, *, decode_graphs, kw) -> None:
        """Resolve ``mesh`` (JAX :602-660): an int N > 1 builds a ``tp``
        mesh of N ranks (`sharding.decode_mesh`: ``cuda:0`` .. ``cuda:N-1``
        for an engine on the card, CPU ranks for a CPU engine) that the
        engine owns and closes; a `parallel.mesh.ProcessMesh` with a
        ``tp`` axis (``devices[0]`` the engine's device) is the engine's
        too when the engine starts it, else the caller's. Tensor parallelism is disabled with a warning (JAX's)
        for a mesh without a tp axis, a net that is not a transformer
        ComputationGraph, and an Hkv that tp does not divide; under tp > 1
        captured steps raise. Then rank 0's graph is built over its slices
        of the params; once the engine is built (the draft too),
        `_attach_followers` has every follower build the same engine over
        its own (`_tp_follower`). ``shard``: (comm, tp, modes, params,
        variables, draft spec) of a follower rank."""
        self.mesh = None
        self.tp = 1
        self._fwd_net = self.net  # the graph the steps run: the rank's
        self._mesh_owned = False
        self._tp_driver = False
        self._svc = 0
        self._attach_payload = None
        if shard is not None:
            comm, tp, modes, params, variables, _ = shard
            self.mesh, self.tp = comm, tp
            self._fwd_net = shard_graph(self.net.conf, modes, tp, params,
                                        variables, self.device, comm)
            return
        if mesh is None or (isinstance(mesh, int) and mesh <= 1):
            return
        if isinstance(mesh, int):
            tp = int(mesh)
        else:
            tp = int(mesh.shape.get(TP_AXIS, 1))
            if tp <= 1:
                # a mesh without a real tp axis would be silently ignored:
                # name the contract instead
                warnings.warn(
                    f"mesh {dict(mesh.shape)} has no '{TP_AXIS}' axis of "
                    "size > 1; tensor-parallel decode is DISABLED (build the "
                    "mesh with inference.sharding.decode_mesh, or pass "
                    "mesh=<rank count>)", RuntimeWarning, stacklevel=3)
                return
        kv = {name: impl._kv_heads() for name, impl in attn.items()}
        if not (self._graph and attn and not self.recurrent
                and kv_heads_shardable(kv, tp)):
            warnings.warn(
                f"mesh tp={tp} requested but tensor-parallel decode is "
                "DISABLED (single-device engine instead): "
                + ("the model is not a transformer ComputationGraph with an "
                   "attention KV cache to shard"
                   if not (self._graph and attn and not self.recurrent)
                   else "an attention layer's n_kv_heads is not divisible "
                        f"by the tp axis size {tp} (the head-sharded cache "
                        "cannot split a head)"),
                RuntimeWarning, stacklevel=3)
            return
        if decode_graphs == "on":
            raise ValueError(
                f"tensor-parallel decode (tp={tp}) with decode_graphs='on': "
                "a gloo collective cannot sit in a captured CUDA graph, so "
                "the tp step runs eagerly (pass decode_graphs='off'; a "
                "captured tp step under NCCL is ROADMAP A7.2.6)")
        if isinstance(mesh, int):
            mesh = decode_mesh(tp, None if self.device.type == "cuda"
                               else ["cpu"] * tp)
            self._mesh_owned = True
        elif not mesh.alive():
            # a mesh the engine starts is the engine's: it stops it (a
            # server's factory hands each rebuild a fresh one)
            self._mesh_owned = True
        if mesh.device != self.device:
            raise ValueError(f"the mesh's rank 0 runs on {mesh.device}, the "
                             f"engine on {self.device}")
        eff = effective_specs(self.net, tp)
        modes = shard_modes(self.net.conf, eff)
        params, variables = shard_decode_params(self.net, tp, 0, specs=eff)
        self._fwd_net = shard_graph(self.net.conf, modes, tp, params,
                                    variables, self.device, mesh)
        self._tp_eff = eff
        self.mesh, self.tp, self._tp_driver = mesh, tp, True
        self._attach_payload = {
            "conf": self.net.conf, "vocab": self.vocab_size, "specs": eff,
            "modes": modes, "kw": kw, "draft": None,
            "params": {n: {k: v.detach().cpu() for k, v in lp.items()}
                       for n, lp in self.net.params.items()},
            "variables": {n: {k: v.detach().cpu() for k, v in lv.items()}
                          for n, lv in variables.items()}}

    def _attach_followers(self) -> None:
        """Start the mesh and have every follower build its engine from
        the driver's payload (`_tp_follower`): the last step of a tp
        driver's construction."""
        mesh, payload = self.mesh, self._attach_payload
        self._attach_payload = None
        try:
            mesh.start()
            self._svc = mesh.attach(
                "deeplearning4j_tpu_torch.inference.engine:_tp_follower",
                payload)
        except BaseException:
            if self._mesh_owned:
                mesh.close()
            raise

    # -- the tp command loop: every device operation, mirrored -------------
    def _mirror(self, op: int, args, payload, fn):
        """Run the device operation ``fn()`` on this rank; a tp driver
        first broadcasts it (one command) to the followers, which run the
        same operation on their shards (`_exec`)."""
        if not self._tp_driver:
            return fn()
        with self.mesh.exclusive():
            self.mesh.command(op, self._svc, args, payload)
            return fn()

    def _exec(self, op: int, args, payload: np.ndarray):
        """A follower's side of `_mirror`: the same operation from the
        command's args and int32 payload."""
        if op == OP_DECODE:
            return self._exec_decode(args, payload)
        if op == OP_PREFILL:
            return self._exec_prefill(args, payload)
        if op == OP_RESET:
            return self._exec_reset(args[0])
        if op == OP_GATHER:
            return gather_blocks(self._states, args[0],
                                 self._to_device(payload.astype(np.int64)),
                                 self.pool.storage, block=args[1])
        if op == OP_SCATTER:
            return scatter_blocks(self._states, args[0], args[1],
                                  self._to_device(payload.astype(np.int64)),
                                  self.pool.storage, block=args[2])
        if op == OP_COPY:
            return self._exec_copy(args[0], args[1])
        if op == OP_MASK:
            return self._exec_mask(args[0], args[1], None)
        if op in (OP_VERIFY, OP_DRAFT, OP_DRAFT_CHUNK):
            return self._exec_spec(op, args, payload)
        if op == OP_SPILL:
            return self._exec_spill(args[0])
        if op == OP_PROMOTE:
            return self._exec_promote(args[0], args[1])
        raise ValueError(f"unknown engine command {op}")

    def _exec_decode(self, args, payload: np.ndarray) -> torch.Tensor:
        """One eager decode step from the packed vector [ids | live | pos
        | mstate (masked) | table (nb)] — `_DecodeRunner`'s layout —
        copied to the device once."""
        masked, nb = args[0], args[1]
        s = self.n_slots
        v = self._to_device(payload)
        o = 3 * s
        mstate = None
        if masked:
            mstate = v[o:o + s]
            o += s
        table = v[o:o + s * nb].view(s, nb) if nb else None
        return self._step(v[:s], v[s:2 * s], v[2 * s:3 * s], table, mstate)

    def _eager_decode(self, ids, live, pos, table, mstate) -> np.ndarray:
        """The eager decode step from host inputs, mirrored under tp."""
        nb = 0 if table is None else int(table.shape[1])
        parts = [ids, live, pos] + ([mstate] if mstate is not None else []) \
            + ([table] if nb else [])
        payload = np.concatenate([np.asarray(a, np.int32).reshape(-1)
                                  for a in parts])
        args = (int(mstate is not None), nb)
        out = self._mirror(OP_DECODE, args, payload,
                           lambda: self._exec_decode(args, payload))
        return out.cpu().numpy()

    def _exec_prefill(self, args, payload: np.ndarray) -> torch.Tensor:
        slot, written, n_real, bucket, nb = args[:5]
        if nb:
            self._table[slot, :nb] = payload[bucket:bucket + nb]
        return self._prefill_forward(slot, payload[:bucket], written, n_real,
                                     nb or None)

    def _eager_chunk(self, slot: int, ids: np.ndarray, written: int,
                     n_real: int, nb: Optional[int] = None) -> torch.Tensor:
        """`_prefill_forward`, mirrored under tp (the table row rides in
        the command)."""
        if not self._tp_driver:
            return self._prefill_forward(slot, ids, written, n_real, nb)
        bucket = int(ids.shape[0])
        row = np.zeros((0,), np.int32)
        if self.paged:
            rows = self._table_for(written + bucket) if nb is None \
                else self._table[:, :nb]
            nb = int(rows.shape[1])
            row = rows[slot]
        args = (slot, written, n_real, bucket, nb or 0)
        payload = np.concatenate([np.asarray(ids, np.int32),
                                  np.asarray(row, np.int32)])
        return self._mirror(OP_PREFILL, args, payload,
                            lambda: self._exec_prefill(args, payload))

    def _exec_copy(self, src: int, dst: int) -> None:
        for st in self._states.values():
            for pages in st.values():  # K/V pages, and int8 scales
                pages[dst].copy_(pages[src])

    def _exec_mask(self, start: int, bucket: int,
                   rows: Optional[np.ndarray]) -> None:
        """Copy a grammar's rows into the mask table in place; under tp
        the driver's rows reach the followers in one data broadcast."""
        if self.tp > 1:
            t = torch.zeros((bucket, self.vocab_size), dtype=torch.float32) \
                if rows is None else torch.from_numpy(rows)
            rows = self.mesh.broadcast_data(t).numpy()
        self._masks[start:start + bucket].copy_(self._to_device(rows))

    def _exec_reset(self, slot: int) -> None:
        states = list(self._draft_states.values())
        if not self.paged:
            states += list(self._states.values())
        for st in states:
            for rows in st.values():
                rows[slot].zero_()

    def _collective_audit(self, program: str = "decode"
                          ) -> List[Dict[str, int]]:
        """`sharding.collective_counts`: one all-idle dispatch of
        ``program`` — "decode" (the step), "verify" (a speculating
        engine's verify chain) or "draft" (its draft step) — at the
        smallest table bucket, with every rank's counts zeroed before it
        and read after it. Idle lanes write nothing that is read again:
        paged rows go to the scratch page, contiguous verify rows are
        written back unchanged, and draft rows land in each stripe's last
        row, which admission zeroes."""
        if self._running:
            raise RuntimeError("collective_counts needs the scheduler "
                               "stopped (or not started)")
        if program not in ("decode", "verify", "draft"):
            raise ValueError(f"unknown program {program!r}")
        if program != "decode" and not self.speculate:
            raise ValueError(f"the {program} program needs a speculating "
                             "engine")
        if not self._tp_driver:
            return [dict.fromkeys(COLLECTIVE_KINDS, 0)]
        s = self.n_slots
        z = np.zeros((s,), np.int32)
        table = (np.full((s, self.table_buckets[0]), SCRATCH_BLOCK, np.int32)
                 if self.paged else None)
        with torch.no_grad(), self.mesh.exclusive():
            self.mesh.reset_counts()
            if program == "decode":
                self._eager_decode(z, z, z, table, None)
            elif program == "verify":
                w = self.speculate + 1
                self._run_spec("verify", table.shape[1] if self.paged
                               else None, lambda r: r.fill(
                                   np.zeros((s, w), np.int32), z, z, table))
            else:
                last = np.full((s,), self._draft_cap - 1, np.int32)
                self._run_spec("draft", None,
                               lambda r: r.fill(z, z, last, None))
            return self.mesh.query_counts()

    def _close_mesh(self, kill: bool = False) -> None:
        """Detach this engine's followers (an owned mesh: stop them; with
        ``kill``, at once, as for a hung or fenced engine)."""
        mesh, self._tp_driver = self.mesh, False
        if mesh is None or not hasattr(mesh, "detach"):
            return
        if self._mesh_owned:
            mesh.kill() if kill else mesh.close()
        elif kill:
            mesh.kill()
        else:
            mesh.detach(self._svc)

    def _init_speculation(self, speculate, draft_blocks, draft_net,
                          attn, shard_draft=None) -> None:
        """Arm speculation (JAX :928-1025), or warn and leave it off: the
        draft and its private contiguous stripes (K layers, ``n_slots``
        rows each) at the compute dtype. Under tp the draft joins the mesh
        (JAX :996-1000): the same Megatron specs (a shallow exit's conf is
        a prefix of the target's), its stripes split by head, and every
        rank runs its shard (`_fwd_draft`); ``shard_draft``: a follower's
        spec of the driver's draft (`_shard_draft`)."""
        self.speculate = 0
        self.draft = None
        self._fwd_draft = None  # the draft graph the rank's steps run
        self.draft_blocks = 0
        self._draft_states: Dict[str, Dict[str, torch.Tensor]] = {}
        self._draft_cap: Optional[int] = None
        if not speculate or int(speculate) <= 0:
            return
        if self.mesh is not None and not self._tp_driver:
            # a follower: the driver's draft, or none when the driver
            # left speculation off
            if shard_draft is None:
                return
            self._arm_draft(speculate, self._draft_from_spec(shard_draft),
                            int(shard_draft["blocks"]))
            return
        reason = None
        if not (self._graph and attn):
            reason = ("the model is not a transformer ComputationGraph with "
                      "an attention KV cache to verify against")
        elif not self.prefill_buckets:
            reason = ("chunked prefill is disabled (prefill_chunk <= 1) and "
                      "the draft needs its chunk programs")
        draft = draft_net
        kk = int(draft_blocks) if draft_blocks else max(1, len(attn) // 2)
        if reason is None and draft is None:
            # a paged engine decodes past the conf's max_cache_len, but the
            # draft's stripes are dense: cap them at the model's own depth
            # (deeper sequences decode plain, `_spec_ready`)
            depth = None
            if self.paged:
                depth = min([self._cache_cap] + [
                    int(getattr(i.conf, "max_cache_len", 1024))
                    for i in attn.values()])
            try:
                draft = build_shallow_draft(self.net, kk,
                                            max_cache_len=depth)
            except ValueError as e:
                reason = f"no self-speculative draft ({e})"
        if reason is not None:
            warnings.warn(
                f"speculate={speculate} requested but speculative decoding "
                f"is DISABLED: {reason}; pass draft_net= for models the "
                "shallow-exit surgery cannot cut", RuntimeWarning,
                stacklevel=3)
            return
        if draft.device != self.device:
            raise ValueError(f"the draft lives on {draft.device}, the engine "
                             f"on {self.device}")
        dattn = {k: i for k, i in sorted(draft._impls.items())
                 if isinstance(i, BaseRecurrentImpl)}
        if not dattn or any(not isinstance(i, SelfAttentionLayerImpl)
                            for i in dattn.values()):
            raise ValueError("a draft net must carry attention layers only "
                             "as its stateful layers")
        fwd = draft
        if self._tp_driver:
            if not kv_heads_shardable({k: i._kv_heads()
                                       for k, i in dattn.items()}, self.tp):
                raise ValueError(
                    f"the draft's n_kv_heads do not divide tp={self.tp}: its "
                    "head-split stripes cannot split a head")
            fwd = self._shard_draft(draft, draft_net is None,
                                    kk if draft_net is None else 0)
        self.draft = draft
        self._arm_draft(speculate, fwd, kk if draft_net is None else 0)

    def _arm_draft(self, speculate, fwd, blocks: int) -> None:
        """Speculation on, with ``fwd`` (this rank's draft graph) and its
        stripes: the rank's heads, ``n_slots`` rows each."""
        self.speculate = int(speculate)
        self.draft = self.draft if self.draft is not None else fwd
        self._fwd_draft = fwd
        self.draft_blocks = blocks
        for name, impl in sorted(fwd._impls.items()):
            if not isinstance(impl, SelfAttentionLayerImpl):
                continue
            st = impl.init_state(self.n_slots, dtype=self._dtype,
                                 device=self.device)
            self._draft_states[name] = {"k": st["k"], "v": st["v"]}
        self._draft_cap = min(int(st["k"].shape[1])
                              for st in self._draft_states.values())

    def _shard_draft(self, draft, shallow: bool, blocks: int):
        """The driver's draft shard, and its spec in the followers' attach
        payload. A shallow exit takes the target's specs and its shard
        tensors by reference (each follower does the same from its own
        shard); an explicit draft net gets its own effective specs and
        ships its params whole, for each follower to slice."""
        if shallow:
            eff = {n: self._tp_eff[n] for n in draft.params}
            params, variables = self._shard_slices(eff)
        else:
            eff = effective_specs(draft, self.tp)
            params, variables = shard_decode_params(draft, self.tp, 0,
                                                    specs=eff)
        modes = shard_modes(draft.conf, eff)
        self._attach_payload["draft"] = {
            "conf": draft.conf, "specs": eff, "modes": modes,
            "blocks": blocks,
            "params": None if shallow else {
                n: {k: v.detach().cpu() for k, v in lp.items()}
                for n, lp in draft.params.items()},
            "variables": {n: {k: v.detach().cpu() for k, v in lv.items()}
                          for n, lv in variables.items()}}
        return shard_graph(draft.conf, modes, self.tp, params, variables,
                           self.device, self.mesh)

    def _shard_slices(self, names):
        """This rank's target shard tensors (params, variables) of the
        vertices ``names``, by reference: a shallow exit's draft."""
        net = self._fwd_net
        return ({n: net.params[n] for n in names},
                {n: net.variables[n] for n in names if n in net.variables})

    def _draft_from_spec(self, spec):
        """A follower's draft shard from the driver's spec: a shallow
        exit's tensors are this rank's target shard, by reference; an
        explicit draft's are sliced from the shipped params."""
        from .sharding import _slice
        comm = self.mesh
        if spec["params"] is None:
            params, variables = self._shard_slices(spec["specs"])
        else:
            params = {n: {k: _slice(v, spec["specs"][n][k], self.tp,
                                    comm.rank) for k, v in lp.items()}
                      for n, lp in spec["params"].items()}
            variables = spec["variables"]
        return shard_graph(spec["conf"], spec["modes"], self.tp, params,
                           variables, self.device, comm)

    # -- submission --------------------------------------------------------
    def _reject(self, rid: str, msg: str, **args) -> PromptTooLongError:
        self._m_rejected.inc()
        self.tracer.instant("reject", req=rid, args={
            "request_id": rid, "reason": "prompt_too_long", **args})
        return PromptTooLongError(msg)

    def submit(self, prompt_ids: Sequence[int], max_new_tokens: int, *,
               temperature: float = 0.0, top_k: Optional[int] = None,
               top_p: Optional[float] = None, seed: int = 0,
               eos_id: Optional[int] = None,
               request_id: Optional[str] = None, priority: int = 0,
               stop: Optional[Sequence[Sequence[int]]] = None,
               grammar: Optional[CompiledGrammar] = None,
               repetition_penalty: Optional[float] = None,
               presence_penalty: Optional[float] = None,
               frequency_penalty: Optional[float] = None,
               stream=None, fork=None,
               _handle: Optional[DecodeHandle] = None,
               _front: bool = False) -> DecodeHandle:
        """Queue one request (JAX :2090). ``priority``: the degradation
        ladder's shedding order (higher survives longer). ``stop``: token
        sequences that end the request when emitted (cut off the output,
        ``finish_reason="stop"``), matched across token boundaries.
        ``grammar``: a `logitproc.CompiledGrammar` compiled ahead of
        admission; forbidden tokens get probability exactly 0 and the
        request finishes with ``"grammar"`` when the grammar admits
        nothing more. The penalties act on the host probability row over
        the generated tokens' counts. ``stream``: a `logitproc.TokenStream`
        the scheduler pushes each released token into (the SSE backing; a
        live partial stop match is held back). ``fork``: the
        `speculative.ForkGroup` of a best-of-n candidate (see
        `generate_many`). ``_handle``/``_front``: the supervisor's requeue
        path (JAX :2094): reuse the original (reset) handle, so the
        caller blocked in ``result()`` never sees the restart, and queue
        it at the front."""
        rid = _handle.request_id if _handle is not None \
            else (request_id or new_request_id())
        if not len(prompt_ids):
            raise ValueError("prompt_ids must be non-empty")
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
        bad = [int(t) for t in prompt_ids if not 0 <= int(t) < self.vocab_size]
        if bad:
            raise ValueError(f"prompt ids out of range [0, {self.vocab_size}): "
                             f"{bad[:5]}")
        # the last sampled token is never fed back, so it needs no row
        needed = len(prompt_ids) + max_new_tokens - 1
        if self.paged:
            # pool-bytes admission: "too long" means more blocks than the
            # whole pool has (there is no per-slot stripe to outgrow)
            need_blocks = blocks_for(needed, self.kv_block)
            if need_blocks > self.pool.capacity_blocks:
                err = self._reject(
                    rid, f"prompt ({len(prompt_ids)}) + max_new_tokens "
                    f"({max_new_tokens}) needs {need_blocks} KV blocks of "
                    f"{self.kv_block} positions but the pool has "
                    f"{self.pool.capacity_blocks}",
                    blocks_needed=need_blocks,
                    blocks_available=self.pool.capacity_blocks)
                err.blocks_needed = need_blocks
                err.blocks_available = self.pool.capacity_blocks
                raise err
        elif self._cache_cap is not None and needed > self._cache_cap:
            raise self._reject(
                rid, f"prompt ({len(prompt_ids)}) + max_new_tokens "
                f"({max_new_tokens}) needs a KV cache of {needed} but "
                f"max_cache_len={self._cache_cap}",
                needed=needed, cache=self._cache_cap)
        handle = _handle if _handle is not None else DecodeHandle(
            len(prompt_ids), max_new_tokens, request_id=rid,
            priority=priority)
        if stream is not None:
            handle.stream = stream
        seq = _ActiveSeq(handle, prompt_ids, float(temperature), top_k, top_p,
                         int(seed), eos_id)
        # built here, the supervisor's resubmission included, so a
        # re-decode observes from a clean pipeline state
        if (grammar is not None or stop or repetition_penalty
                or presence_penalty or frequency_penalty):
            seq.proc = LogitState(self.vocab_size, grammar=grammar, stop=stop,
                                  repetition_penalty=repetition_penalty,
                                  presence_penalty=presence_penalty,
                                  frequency_penalty=frequency_penalty)
            if grammar is not None and _handle is None:
                self._m_constrained.inc()
        if fork is not None:
            fork.bind_primary(handle)
            seq.fork = fork
        with self._cond:
            if not self._running:
                raise RuntimeError("scheduler is not running (call start())")
            if len(self._queue) >= self.max_queue:
                self._m_rejected.inc()
                self.tracer.instant("reject", req=rid, args={
                    "request_id": rid, "reason": "queue_full",
                    "waiting": len(self._queue)})
                raise QueueFullError(f"decode queue full ({self.max_queue} "
                                     "waiting)")
            if _front:
                self._queue.insert(0, seq)
            else:
                self._queue.append(seq)
            self._m_queue_depth.set(len(self._queue))
            # opened under the queue lock, so the scheduler's end("queued")
            # can never come first
            self.tracer.begin("queued", req=rid,
                              args={"prompt_tokens": len(seq.prompt),
                                    "max_new_tokens": max_new_tokens})
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

    def generate_many(self, prompt_ids: Sequence[int], n: int,
                      max_new_tokens: int,
                      timeout: Optional[float] = 120.0, *, seed: int = 0,
                      **kw) -> List[DecodeHandle]:
        """Best-of-n over one prompt (JAX :2252): ``n`` candidates
        submitted as one fork group, candidate i seeded with ``seed + i``
        (candidate 0 is the n = 1 output). Paged, the primary prefills the
        prompt once and publishes its blocks when its prefill ends; the
        followers restore them as table remaps (``decode_forks_total``).
        A timeout cancels every unfinished candidate."""
        from .speculative import await_fork_group, submit_fork_group
        handles = submit_fork_group(self.submit, prompt_ids, n,
                                    max_new_tokens, seed=seed, **kw)
        await_fork_group(handles, timeout)
        return handles

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
        if self._fenced:
            # a fenced engine's handles are disowned (the supervisor
            # requeued them onto a replacement): finishing them here would
            # fail requests another engine is serving. Drop the
            # references; a stuck thread exits at its next fence check
            with self._cond:
                self._running = False
                self._queue.clear()
                self._cond.notify_all()
            if self._thread is not None:
                self._thread.join(timeout=1)
                self._thread = None
            self._slots = [None] * self.n_slots
            if self.tier is not None:
                # disowned engine: stop the worker, skip the balance check
                self.tier.stop(check=False)
            self._close_mesh(kill=True)
            return
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
        # a preemption racing the drain above can requeue a sequence after
        # the queue was cleared: drain again now that the thread is joined
        with self._cond:
            pending += self._queue
            self._queue.clear()
        self._fail_all(pending, RuntimeError("scheduler stopped"))
        if self.tier is not None:
            # joins the transfer worker and zeroes the tier's ledger
            # (host_page / disk_block / directory_entry)
            self.tier.stop()
        # a crashed driver may have left followers inside a collective
        self._close_mesh(kill=self.crashed is not None)

    def _fail_all(self, pending: List[_ActiveSeq],
                  err: BaseException) -> None:
        """Finish every queued and slot-resident handle with ``err``."""
        for seq in pending:
            seq.handle._finish(err)
            self._trace_done("cancel", seq)
        for i, seq in enumerate(self._slots):
            if seq is not None:
                self._drop_slot(i, seq)
                seq.handle._finish(err)
                self._trace_done("cancel", seq, slot=i)
        self._m_queue_depth.set(0)
        self._m_active.set(0)

    def reset_counters(self) -> None:
        self.decode_steps = 0
        self.decode_seconds = 0.0
        self.prefill_chunks = 0
        self.prefill_seconds = 0.0
        self.final_chunks = 0
        self.chunk_row_reads = 0
        self.preemptions = 0
        self.cow_copies = 0
        self.restored_tokens = 0
        self.masked_steps = 0
        self.masked_seconds = 0.0
        self.forks = 0
        self.spec_rounds = 0
        self.spec_proposed = 0
        self.spec_accepted = 0
        self.draft_steps = 0
        self.draft_chunks = 0
        self.verify_seconds = 0.0
        self.draft_seconds = 0.0
        self.spec_launches = 0
        self.promoted_blocks = 0
        self.tier_restored_tokens = 0
        self.promote_seconds = 0.0

    @contextlib.contextmanager
    def _sync_guard(self):
        """The transfer guard around one iteration (a no-op when off)."""
        if self._guard_mode is None:
            yield
            return
        torch.cuda.set_sync_debug_mode(self._guard_mode)
        try:
            yield
        finally:
            torch.cuda.set_sync_debug_mode("default")

    @contextlib.contextmanager
    def _allow_sync(self):
        """A declared sync inside a guarded iteration."""
        if self._guard_mode is None:
            yield
            return
        torch.cuda.set_sync_debug_mode("default")
        try:
            yield
        finally:
            torch.cuda.set_sync_debug_mode(self._guard_mode)

    def _host_read(self, t: torch.Tensor) -> np.ndarray:
        """A declared device->host read: allowed under the guard."""
        with self._allow_sync():
            return t.cpu().numpy()

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        """A host array on the engine's device: on the card through a
        pinned block, without a sync (the caching host allocator keeps the
        block until the copy has run)."""
        t = torch.from_numpy(np.ascontiguousarray(a))
        if self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def _loop(self) -> None:
        while True:
            self.heartbeat = time.monotonic()
            with self._cond:
                if not self._running:
                    return
            try:
                with torch.no_grad(), self._sync_guard():
                    stepped = self._step_once()
            except _EngineFenced:
                return  # a supervisor already disowned this engine
            except Exception as e:  # the loop's boundary: report the crash
                self._crash(e)
                return
            self.iterations += 1
            if not stepped:
                # idle pass: decay the rate gauges (iter_end never runs)
                self.profiler.idle_tick()
                with self._cond:
                    if not self._running:
                        return
                    if not self._queue:
                        self._cond.wait(timeout=0.1)

    def _crash(self, exc: BaseException) -> None:
        """Terminal bookkeeping on the dying loop thread (JAX :3386).
        Supervised (``_on_crash`` set): the handles stay open, the
        supervisor requeues each onto a rebuilt engine. Unsupervised:
        every in-flight and queued handle fails fast with
        EngineCrashedError."""
        if self._fenced:
            return  # declared dead and disowned already
        self.crashed = exc
        with self._cond:
            self._running = False
            self._cond.notify_all()
        self.tracer.instant("engine_crash", track=self._sched_track,
                            args={"error": type(exc).__name__,
                                  "detail": str(exc)[:200],
                                  "iterations": self.iterations})
        if self._on_crash is not None:
            self._close_request_spans()
            self._on_crash(exc)
            return
        err = EngineCrashedError(f"decode scheduler crashed: {exc!r}")
        err.__cause__ = exc
        with self._cond:
            pending = self._queue[:]
            self._queue.clear()
        self._fail_all(pending, err)

    def _close_request_spans(self) -> None:
        """Close every in-flight request's open phase span without
        finishing its handle (a supervised crash: the supervisor bridges
        the gap with a ``recovered`` span)."""
        if not self.tracer.enabled:
            return
        with self._cond:
            seqs = self._queue[:]
        for seq in seqs + [s for s in self._slots if s is not None]:
            self._close_phase_span(seq)

    def fence(self) -> None:
        """Disown this engine (JAX :3425): a supervisor that declared it
        dead fences it before requeueing its work elsewhere. A stuck loop
        thread that wakes sees the fence at its next iteration, seam or
        emission and exits without touching a handle. A lock-free bool:
        the thread it must reach may be stuck in a device call."""
        self._fenced = True
        with self._cond:
            self._running = False
            self._cond.notify_all()

    def _release_device(self) -> None:
        """Drop a fenced engine's device state — the KV pages or stripes,
        the side pool's storage, every runner and its CUDA graph, the
        graph pool — so that a restart does not keep one engine's memory
        per fault. A thread still running (a real hang) keeps what its
        frames hold until it exits; once it wakes it fails at the fence."""
        self._states = {}
        self._draft_states = {}
        self._runners = {}
        self._mrunners = {}
        self._chunk_runners = {}
        self._spec_runners = {}
        self._graph_pool = None
        self._masks = None
        self.pool = None
        if self.tier is not None:
            self.tier.stop(check=False)
        # the followers go too: the replacement starts its own
        self._close_mesh(kill=True)
        self._fwd_net = self.net

    def inflight(self) -> int:
        """Queued + slot-resident requests (the drain condition)."""
        with self._cond:
            n = len(self._queue)
        return n + sum(s is not None for s in self._slots)

    def queue_depth(self) -> int:
        """Waiting (not yet admitted) requests: the ladder's pressure."""
        with self._cond:
            return len(self._queue)

    def shed_queued(self, target_depth: int) -> int:
        """Degradation level >= 1 (JAX :3839): drop queued requests until
        at most ``target_depth`` wait, lowest priority first, newest first
        within a priority, each failed with LoadSheddedError (a retryable
        503). Returns how many were shed."""
        shed: List[_ActiveSeq] = []
        with self._cond:
            excess = len(self._queue) - max(0, int(target_depth))
            if excess > 0:
                shed = sorted(self._queue,
                              key=lambda s: (s.handle.priority,
                                             -s.handle.t_submit))[:excess]
                doomed = set(map(id, shed))
                self._queue[:] = [s for s in self._queue
                                  if id(s) not in doomed]
                self._m_queue_depth.set(len(self._queue))
        for seq in shed:
            self._m_rejected.inc()
            seq.handle._finish(LoadSheddedError(
                "request shed by the degradation ladder (queue under "
                "sustained pressure); retry with backoff"))
            self._trace_done("cancel", seq)
        return len(shed)

    # -- trace ---------------------------------------------------------------
    def _trace_done(self, outcome: str, seq: _ActiveSeq,
                    slot: Optional[int] = None) -> None:
        """Close the request's open phase span, then stamp the
        ``finish``/``cancel`` instant with its timings (JAX :2357); call
        after ``handle._finish()``."""
        tr = self.tracer
        if not tr.enabled:
            return
        h = seq.handle
        rid = h.request_id
        self._close_phase_span(seq)
        tr.instant(outcome, req=rid, args={"request_id": rid,
                                           **({"retries": h.retries}
                                              if h.retries else {}),
                                           "tokens": len(h.tokens),
                                           **h.timings()})
        if slot is not None:
            tr.instant("free", track=self._slot_tracks[slot],
                       args={"request": rid})

    def _close_phase_span(self, seq: _ActiveSeq) -> None:
        """End the request-track span open now (queued, prefill,
        preempted or decode)."""
        tr = self.tracer
        h = seq.handle
        rid = h.request_id
        if seq.phase == "queued":
            tr.end("queued", req=rid)
        elif seq.phase == "prefill":
            tr.end("prefill", req=rid, args={"fed_tokens": seq.fed})
        elif seq.phase == "preempted":
            tr.end("preempted", req=rid)
        else:
            tr.end("decode", req=rid,
                   args={"tokens": len(h.tokens), "iterations": seq.steps})

    # -- pool bookkeeping: lazy growth, COW, preemption (paged) ------------
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
        added = 0
        while len(seq.block_ids) < need:
            bid = self._alloc_or_preempt(slot, seq)
            if bid is None:
                return False
            self._table[slot, len(seq.block_ids)] = bid
            seq.block_ids.append(bid)
            seq.shared.append(False)
            added += 1
        if added and self.tracer.enabled:
            self.tracer.instant("block_alloc", track=self._slot_tracks[slot],
                                args={"request": seq.handle.request_id,
                                      "blocks": added,
                                      "free": self.pool.free_blocks})
        return True

    def _copy_page(self, src: int, dst: int) -> None:
        self._mirror(OP_COPY, (src, dst), None,
                     lambda: self._exec_copy(src, dst))

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
        self._copy_page(src, bid)
        self.cow_copies += 1
        seq.block_ids[j] = bid
        seq.shared[j] = False
        self._table[slot, j] = bid
        if self.tracer.enabled:
            self.tracer.instant("block_cow", track=self._slot_tracks[slot],
                                args={"request": seq.handle.request_id,
                                      "src": src, "dst": bid,
                                      "block_index": j})
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
        self._m_preempted.inc()
        h = seq.handle
        tr = self.tracer
        if tr.enabled:
            if seq.phase == "prefill":
                tr.end("prefill", req=h.request_id,
                       args={"fed_tokens": seq.fed})
            elif seq.phase == "decode":
                tr.end("decode", req=h.request_id,
                       args={"tokens": len(h.tokens), "preempted": True})
            tr.instant("preempt", track=self._slot_tracks[slot],
                       args={"request": h.request_id,
                             "blocks_released": sum(
                                 1 for sh in seq.shared if not sh),
                             "tokens_done": len(h.tokens)})
            tr.begin("preempted", req=h.request_id)
        self._release_pool(seq)
        self._release_slot_blocks(slot, seq)
        self._release_mask(seq)  # re-acquired (usually cached) on resume
        seq.prompt.extend(h.tokens[seq.folded:])
        seq.folded = len(h.tokens)
        seq.fed = 0
        seq.written = 0
        seq.draft_fed = 0  # the draft re-ingests on resume too
        seq.phase = "preempted"
        seq.resumed = True
        self._slots[slot] = None
        with self._cond:
            self._queue.insert(0, seq)
            self._m_queue_depth.set(len(self._queue))
        self._m_active.set(sum(s is not None for s in self._slots))

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
        if self.pool is not None:
            self._release_pool(seq)
            if self.paged:
                self._release_slot_blocks(slot, seq)
        self._release_mask(seq)
        self._slots[slot] = None

    # -- prefix reuse --------------------------------------------------------
    def _reset_slot_state(self, slot: int) -> None:
        """Zero a contiguous slot's stripe rows, or a recurrent slot's h/c
        rows, and its draft stripe rows, at admission (JAX
        `_reset_slot_state` :1699, `_zero_fn` :1598). Paged pages are
        shared storage and stay; a fresh paged slot starts from a scratch
        table row and position 0."""
        if self.paged and not self._draft_states:
            return  # nothing to zero
        self._mirror(OP_RESET, (slot,), None,
                     lambda: self._exec_reset(slot))

    def _try_restore(self, slot: int, seq: _ActiveSeq) -> None:
        """Contiguous prefix restore (JAX :1714): copy the longest cached
        block chain into the freshly zeroed stripe and start the sequence
        past it. The hit is capped one token short of the prompt: the
        last prompt token must run through the model to give the first
        output's distribution."""
        B = self.pool.block
        max_hit = (len(seq.prompt) - 1) // B
        self._m_prefix_lookups.inc()
        self._m_prefix_lookup_tokens.inc(len(seq.prompt))
        if max_hit < 1:
            return
        n_blk, ids, node = self.pool.match(seq.prompt, max_hit)
        seq.pool_node = node
        if not n_blk:
            return
        bucket = bucket_for(n_blk, self.restore_buckets)
        idx = np.full((bucket,), SCRATCH_BLOCK, np.int64)
        idx[:n_blk] = ids
        self._mirror(OP_GATHER, (slot, B), idx.astype(np.int32),
                     lambda: gather_blocks(self._states, slot,
                                           self._to_device(idx),
                                           self.pool.storage, block=B))
        seq.fed = seq.written = n_blk * B
        self.restored_tokens += seq.fed
        self._m_prefix_hits.inc()
        self._m_prefix_hit_tokens.inc(seq.fed)

    def _try_restore_paged(self, slot: int, seq: _ActiveSeq) -> None:
        """Prefix restore as a table remap (JAX :1952): point the slot's
        table at the cached blocks, pinned through the trie, and set its
        position past the hit; no K/V is copied. The hit may cover the
        whole prompt: the last token is then re-fed, and its write
        copy-on-writes the last shared block."""
        B = self.kv_block
        self._m_prefix_lookups.inc()
        self._m_prefix_lookup_tokens.inc(len(seq.prompt))
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
        if self.tier is not None:
            # the tier past the resident frontier (JAX :1979): queue
            # host/disk blocks for promotion; the slot does not wait, it
            # prefills its cold suffix, and a promotion that lands
            # upgrades it mid-prefill (`_tier_tick`)
            frontier = node.hash if node is not None else ""
            if frontier is not None:
                ext = self.tier.lookup_extension(frontier, seq.prompt,
                                                 n_blk, max_hit)
                if ext:
                    self.tier.request_restore(ext)
        if not n_blk:
            return
        seq.block_ids = [int(b) for b in ids]
        seq.shared = [True] * n_blk
        self._table[slot, :n_blk] = ids
        seq.fed = seq.written = min(n_blk * B, len(seq.prompt) - 1)
        self.restored_tokens += seq.fed
        self._m_prefix_hits.inc()
        self._m_prefix_hit_tokens.inc(seq.fed)
        if seq.fork is not None and seq.fork.primary_handle is not seq.handle \
                and not seq.resumed:
            # a best-of-n follower attached to its group's published
            # prompt blocks (the primary's own hits and a resume's
            # re-restore are ordinary prefix hits)
            self.forks += 1
            self._m_forks.inc()
            if self.tracer.enabled:
                self.tracer.instant("fork", track=self._slot_tracks[slot],
                                    args={"request": seq.handle.request_id,
                                          "role": "attach", "blocks": n_blk})

    def _try_upgrade_slots(self, from_tier: bool = False) -> None:
        """Re-match mid-prefill slots against the trie (JAX :3123): a slot
        whose next blocks were published since it was admitted swaps its
        pin to the deeper node, remaps its table onto those blocks and
        skips past them. A COW-starved slot is left alone, so a full-pool
        full-prompt hit converges instead of starving again. Only blocks
        published since the last pass can deepen a hit, so a pass with
        none is skipped. ``from_tier``: the pass right after promotions
        landed, whose skipped tokens count as
        ``kv_tier_restored_tokens_total``."""
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
            gained = fed - seq.fed
            self.restored_tokens += gained
            seq.fed = seq.written = fed
            self._m_prefix_hits.inc()
            if from_tier:
                self.tier_restored_tokens += gained
                self._m_tier_tokens.inc(gained)
                if self.tracer.enabled:
                    self.tracer.instant(
                        "tier_restore", track=self._slot_tracks[i],
                        args={"request": seq.handle.request_id,
                              "tokens": gained, "blocks": n2 - cur})

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

    def _fork_publish(self, slot: int, seq: _ActiveSeq) -> None:
        """Best-of-n early publish (JAX :2566): the fork group's primary
        just ended its prefill; the finish-time ownership transfer runs
        now, so its queued siblings restore the prompt's blocks as table
        remaps instead of each prefilling them. The adopted blocks turn
        shared in the slot's own books and the slot pins them through the
        trie, so eviction cannot take rows it still reads."""
        group = seq.fork
        adopted = self._publish_paged(seq)
        if adopted:
            for j, bid in enumerate(seq.block_ids):
                if bid in adopted:
                    seq.shared[j] = True
            self._release_pool(seq)
            n_full = len(seq.prompt) // self.kv_block
            _, _, node = self.pool.match(seq.prompt, n_full)
            seq.pool_node = node
            if self.tracer.enabled:
                self.tracer.instant("fork", track=self._slot_tracks[slot],
                                    args={"request": seq.handle.request_id,
                                          "role": "publish",
                                          "blocks": len(adopted),
                                          "candidates": group.n})
        group.published = True

    def _attach_mask(self, slot: int, seq: _ActiveSeq) -> None:
        """Make an admitted request's grammar device-resident (JAX
        :2039): take (or share) its mask-row range and, on first
        residency, copy its rows into the table in place (the captured
        graphs keep the table's pointer). A grammar that does not fit is
        masked on the host only (``mask_base`` None): the exact allow row
        applies at sampling either way."""
        proc = seq.proc
        if proc is None or proc.grammar is None or self.maskpool is None:
            return
        g = proc.grammar
        start, upload = self.maskpool.acquire(g)
        if start is None:
            proc.mask_base = None
            self._m_mask_spill.inc()
            return
        if upload:
            bucket = bucket_for(g.n_states, self.mask_buckets)
            rows = np.zeros((bucket, self.vocab_size), np.float32)
            rows[:g.n_states] = g.mask_table(np.float32)
            self._mirror(OP_MASK, (start, bucket), None,
                         lambda: self._exec_mask(start, bucket, rows))
        proc.mask_base = start
        self._m_mask_rows.set(self.maskpool.resident_rows())
        if self.tracer.enabled:
            self.tracer.instant("grammar_attach",
                                track=self._slot_tracks[slot],
                                args={"request": seq.handle.request_id,
                                      "states": g.n_states, "row": start,
                                      "uploaded": bool(upload)})

    def _release_mask(self, seq: _ActiveSeq) -> None:
        """Drop the request's mask-row reference (every slot-freeing path
        comes here); the rows stay cached for the next request with the
        same grammar until pressure evicts them."""
        proc = seq.proc
        if proc is not None and proc.mask_base is not None:
            self.maskpool.release(proc.grammar.key)
            proc.mask_base = None
            self._m_mask_rows.set(self.maskpool.resident_rows())

    def _publish_prompt(self, slot: int, seq: _ActiveSeq) -> None:
        """Contiguous publish (JAX :1753): index the finished prompt's
        full blocks in the trie (allocating, LRU-evicting when full) and
        copy the slot's stripe rows into the new blocks, covering them
        with a greedy walk over descending restore buckets."""
        B = self.pool.block
        n_full = len(seq.prompt) // B
        if n_full < 1:
            return
        start, new_ids = self.pool.insert(seq.prompt[:n_full * B])
        off = 0
        while off < len(new_ids):
            b = max(k for k in self.restore_buckets
                    if k <= len(new_ids) - off)
            idx = np.asarray(new_ids[off:off + b], np.int64)
            at = start + off
            self._mirror(OP_SCATTER, (slot, at, B), idx.astype(np.int32),
                         lambda: scatter_blocks(self._states, slot, at,
                                                self._to_device(idx),
                                                self.pool.storage, block=B))
            off += b

    def _retire(self, slot: int, seq: _ActiveSeq) -> None:
        """Finish a sequence: publish its prompt's blocks for the next
        request sharing the prefix, drop its pin, free the rest."""
        now = time.monotonic()
        if self.pool is not None:
            if self.paged:
                adopted = self._publish_paged(seq)
                self._release_pool(seq)
                self._release_slot_blocks(slot, seq, keep=adopted)
            else:
                self._publish_prompt(slot, seq)
                self._release_pool(seq)
        self._release_mask(seq)
        h = seq.handle
        h._finish()
        self._trace_done("finish", seq, slot=slot)
        self._m_latency.record(now - h.t_submit)
        self._slots[slot] = None

    # -- scheduler iteration ----------------------------------------------
    def _evict_cancelled(self) -> None:
        for i, seq in enumerate(self._slots):
            if seq is not None and seq.handle.cancelled():
                self._m_cancelled.inc()
                self._drop_slot(i, seq)
                seq.handle.finish_reason = "cancelled"
                seq.handle._finish()
                self._trace_done("cancel", seq, slot=i)

    def _admit(self) -> None:
        """Fill free slots from the queue head (JAX :2449). Paged, by pool
        bytes: with any slot live, a prompt is admitted only when the free
        plus evictable blocks, less the prompt blocks already promised to
        resident slots, cover its prompt. Decode growth is not reserved:
        that is what preemption is for. The oldest request waits rather
        than being overtaken (a preempted one is back at the front). A
        best-of-n follower (paged) stays queued, and is passed over, until
        its primary has published the prompt's blocks (or finished)."""
        B = self.kv_block
        pending = sum(max(0, blocks_for(len(s.prompt), B) - len(s.block_ids))
                      for s in self._slots if s is not None) \
            if self.paged else 0
        reclaim = None
        admitted = []
        with self._cond:
            blocked = False
            for i in range(self.n_slots):
                if blocked or self._slots[i] is not None:
                    continue
                qi = 0
                while qi < len(self._queue):
                    seq = self._queue[qi]
                    if seq.handle.cancelled():
                        self._queue.pop(qi)
                        self._m_cancelled.inc()
                        seq.handle.finish_reason = "cancelled"
                        seq.handle._finish()
                        self._trace_done("cancel", seq)
                        continue
                    if (self.paged and seq.fork is not None
                            and seq.fork.waiting(seq.handle)):
                        qi += 1  # waits for its primary's publish
                        continue
                    if self.paged:
                        need = blocks_for(len(seq.prompt), B)
                        if any(s is not None for s in self._slots):
                            if reclaim is None:
                                reclaim = self.pool.reclaimable_blocks()
                            if reclaim - pending < need:
                                blocked = True
                                break
                        pending += need
                    self._queue.pop(qi)
                    self._slots[i] = seq
                    if not seq.resumed:
                        self._m_seqs.inc()
                    admitted.append((i, seq))
                    break
            self._m_queue_depth.set(len(self._queue))
            self._m_active.set(sum(s is not None for s in self._slots))
        tr = self.tracer
        for i, seq in admitted:
            h = seq.handle
            rid = h.request_id
            h.t_admitted = time.monotonic()
            if seq.phase == "preempted":
                tr.end("preempted", req=rid)
                tr.instant("resume", track=self._slot_tracks[i],
                           args={"request": rid,
                                 "refeed_tokens": len(seq.prompt)})
            else:
                tr.end("queued", req=rid)
            tr.instant("admit", track=self._slot_tracks[i],
                       args={"request": rid})
            tr.begin("prefix_restore", req=rid)
            self._reset_slot_state(i)
            if self.pool is not None:
                if self.paged:
                    self._try_restore_paged(i, seq)
                else:
                    self._try_restore(i, seq)
            # the grammar's rows ride the admission too (a resumed request
            # re-acquires them, usually still cached: a refcount)
            self._attach_mask(i, seq)
            h.t_restored = time.monotonic()
            tr.end("prefix_restore", req=rid,
                   args={"hit_tokens": seq.fed, "slot": i,
                         **({"remap_blocks": len(seq.block_ids),
                             "kv_copies": 0} if self.paged else {})})
            tr.begin("prefill", req=rid,
                     args={"prompt_tokens": len(seq.prompt),
                           "restored_tokens": seq.fed, "slot": i})
            seq.phase = "prefill"

    def _pick_chunk(self, seq: _ActiveSeq) -> Tuple[int, int]:
        """(bucket, n_real) of this sequence's next prefill chunk, or
        (0, 0) when no bucket fits under the cache's depth."""
        cap = self.prefill_chunk
        if self.chunk_cap:
            # degradation level >= 2: smaller chunks shorten each
            # iteration's device hold; their runners exist already
            cap = max(1, min(cap, int(self.chunk_cap)))
        n_real = min(len(seq.prompt) - seq.fed, cap)
        bucket = bucket_for(n_real, self.prefill_buckets)
        if self._cache_cap is not None and seq.fed + bucket > self._cache_cap:
            # padded writes past the cap would trip the layer's overflow
            # guard: shrink to the largest bucket inside the headroom
            fitting = [b for b in self.prefill_buckets
                       if seq.fed + b <= self._cache_cap]
            if not fitting:
                return 0, 0
            bucket = fitting[-1]
            n_real = min(n_real, bucket)
        return bucket, n_real

    def _onehot(self, ids: torch.Tensor) -> torch.Tensor:
        """One-hot rows of device ids, at the compute dtype, built on the
        device (JAX `_step_fn` builds them in-program)."""
        ar = torch.arange(self.vocab_size, device=ids.device)
        return (ids.long()[..., None] == ar).to(self._dtype)

    def _dispatch_states(self, pos, table=None, wmask=None,
                         slot: Optional[int] = None):
        """The attention states of one dispatch: paged, the page arrays
        with this call's positions, table and write mask; contiguous, the
        stripes (``slot``: a view of that slot's rows, so the step's
        in-place write lands in its stripe) with this call's positions."""
        out = {}
        for name, st in self._states.items():
            if self.paged:
                out[name] = {**st, "pos": pos, "table": table,
                             "wmask": wmask, "paged_kernel": self.paged_kernel}
            elif slot is None:
                out[name] = {**st, "pos": pos}
            else:
                out[name] = {"k": st["k"][slot:slot + 1],
                             "v": st["v"][slot:slot + 1], "pos": pos}
        return out

    def _forward_states(self, x, states):
        """One forward of one-hots ``x`` [B, T, vocab] through the net with
        the given states: (the output distributions [B, T, vocab], the
        stateful layers' new states). Attention layers write their K/V
        in place."""
        if self._graph:
            net = self._fwd_net
            acts, new = net._forward_impl(net.params, [x], states=states)
            return acts[self._out_name], new
        acts, _, new, _ = self.net._forward_impl(
            self.net.params, self.net.variables, x, train=False,
            states=states)
        return acts[-1], new

    def _forward(self, x, states):
        return self._forward_states(x, states)[0]

    def _rnn_step(self, x: torch.Tensor, live: torch.Tensor) -> torch.Tensor:
        """The recurrent decode step (JAX `_step_fn` + `_freeze_states`
        :1182-1216): one token of every slot from the engine's h/c rows;
        only the live rows' new state is written back into the static
        state buffers (masked rows are batch padding). Returns [n_slots,
        vocab]."""
        out, new = self._forward_states(
            x, {k: dict(st) for k, st in self._states.items()})
        keep = live[:, None]
        for k, st in self._states.items():
            for n, rows in st.items():
                rows.copy_(torch.where(keep, new[k][n], rows))
        return out[:, -1, :]

    def _rnn_chunk(self, ids: torch.Tensor, n_real: torch.Tensor,
                   slot: torch.Tensor) -> torch.Tensor:
        """One recurrent prefill chunk (JAX `_prefill_fn`'s scan path
        :1395-1418): the chunk's C positions as C single-token steps on
        the slot's rows (a device index), each padded step (``t >=
        n_real``) masked out of the carry; the rows are written back in
        place. Returns the output row [vocab] of the last real token."""
        sl = slot.long()
        sub = {k: {n: rows.index_select(0, sl) for n, rows in st.items()}
               for k, st in self._states.items()}
        x = self._onehot(ids)
        outs = []
        for t in range(ids.shape[0]):
            out, new = self._forward_states(x[None, t:t + 1], sub)
            keep = (n_real > t)[:, None]
            sub = {k: {n: torch.where(keep, new[k][n], v)
                       for n, v in st.items()} for k, st in sub.items()}
            outs.append(out[0, -1])
        for k, st in self._states.items():
            for n, rows in st.items():
                rows.index_copy_(0, sl, sub[k][n])
        last = torch.clamp(n_real.long() - 1, min=0)
        return torch.stack(outs).index_select(0, last)[0]

    def _prefill_forward(self, slot: int, ids: np.ndarray, written: int,
                         n_real: int, nb: Optional[int] = None) -> torch.Tensor:
        """The eager prefill chunk (``decode_graphs="off"``): one padded
        chunk of ``slot`` at depth ``written``; its output distributions
        [bucket, vocab]. Paged: the table bucket covers the padded chunk
        end (``nb`` forces one), so the layer's overflow guard never fires
        on padding lanes, which write to the scratch page; contiguous:
        padding rows land past the position, causally invisible until the
        next real write overwrites them; recurrent: the chunk's last real
        row alone, [1, vocab]."""
        dev = self.device
        bucket = ids.shape[0]
        pos = torch.tensor([written], dtype=torch.int32, device=dev)
        if self.recurrent:
            return self._rnn_chunk(
                torch.from_numpy(ids).to(dev),
                torch.tensor([n_real], dtype=torch.int32, device=dev),
                torch.tensor([slot], dtype=torch.int32, device=dev))[None]
        if self.paged:
            rows = self._table_for(written + bucket) if nb is None \
                else self._table[:, :nb]
            table = torch.from_numpy(
                np.ascontiguousarray(rows[slot:slot + 1])).to(dev)
            wmask = (torch.arange(bucket, device=dev) < n_real)[None, :]
            sts = self._dispatch_states(pos, table, wmask)
        else:
            sts = self._dispatch_states(pos, slot=slot)
        x = self._onehot(torch.from_numpy(ids).to(dev))
        return self._forward(x[None], sts)[0]

    def _chunk_body(self, r: _ChunkRunner) -> torch.Tensor:
        """One prefill chunk on ``r``'s static buffers — what a capture
        records (JAX `_prefill_paged_fn` :1420, `_prefill_fn` :1352): the
        one-hot from the ids, the write mask from ``n_real`` (paged), the
        slot's stripe by a device index (contiguous), and the output row
        of the last real token, all on the device; recurrent, C
        single-token steps (`_rnn_chunk`). Returns [vocab] f32."""
        dev = r.packed.device
        if self.recurrent:
            return self._rnn_chunk(r.ids, r.n_real, r.slot).float()
        x = self._onehot(r.ids)[None]
        if self.paged:
            wmask = (torch.arange(r.bucket, device=dev) < r.n_real)[None, :]
            sts = self._dispatch_states(r.pos, r.table, wmask)
        else:
            sts = {name: {"k": st["k"], "v": st["v"], "pos": r.pos,
                          "slot": r.slot}
                   for name, st in self._states.items()}
        out = self._forward(x, sts)[0]
        last = torch.clamp(r.n_real.long() - 1, min=0)
        return out.index_select(0, last)[0].float()

    def _new_chunk_runner(self, bucket: int, nb: Optional[int]
                          ) -> _ChunkRunner:
        """Static buffers for chunk bucket ``bucket`` at table bucket
        ``nb`` (None: contiguous), under the capture budget: one runner
        per pair over the engine's life, none once warmup() has run."""
        if (bucket, nb) in self._chunk_runners or self._warmed:
            raise RuntimeError(f"capture budget spent: the prefill chunk of "
                               f"bucket {(bucket, nb)} was built already or "
                               "warmup() has run")
        return _ChunkRunner(bucket, nb, self.device)

    def _chunk_row(self, slot: int, seq: _ActiveSeq, ids: np.ndarray,
                   n_real: int) -> Optional[np.ndarray]:
        """Run one chunk; its last real row on the host when the chunk
        ends the prompt (the only read), else None (no copy, no sync)."""
        bucket = ids.shape[0]
        written = seq.written
        final = seq.fed + n_real >= len(seq.prompt)
        if self._cache_cap is not None and written + bucket > self._cache_cap:
            # the replay cannot check the position: the host does, first
            raise ValueError(f"KV cache overflow: chunk at {written}+"
                             f"{bucket} exceeds {self._cache_cap} positions")
        if self.decode_graphs != "on":
            out = self._eager_chunk(slot, ids, written, n_real)
            row = out[-1] if self.recurrent else out[n_real - 1]
            return self._read_row(row.float()) if final else None
        table_row = None
        nb = None
        if self.paged:
            rows = self._table_for(written + bucket)
            nb = rows.shape[1]
            table_row = rows[slot]
        r = self._chunk_runners.get((bucket, nb))
        new = r is None
        if new:
            r = self._new_chunk_runner(bucket, nb)
        r.fill(ids, n_real, written, slot, table_row)
        if new:
            # captured on this chunk's inputs: the capture's eager run
            # writes just what the replay writes
            self._build(r)
        self._replay(r)
        return self._read_row(r.out) if final else None

    def _read_row(self, row: torch.Tensor) -> np.ndarray:
        self.chunk_row_reads += 1
        return self._host_read(row)

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
            if self.paged and (
                    not self._ensure_blocks(i, seq, seq.written + n_real)
                    or not self._ensure_writable(i, seq, seq.written)):
                continue  # seq itself was preempted for blocks
            ids = np.zeros((bucket,), np.int32)
            ids[:n_real] = seq.prompt[seq.fed:seq.fed + n_real]
            failpoints.fire("dispatch.prefill")  # chaos seam
            if self._fenced:
                raise _EngineFenced
            if self.tracer.enabled:
                self.tracer.begin("prefill_chunk", track=self._slot_tracks[i],
                                  args={"request": seq.handle.request_id,
                                        "bucket": bucket, "tokens": n_real})
            self.profiler.count("prefill", bucket)
            last = self._chunk_row(i, seq, ids, n_real)
            if self.speculate and seq.draft_fed == seq.fed \
                    and seq.draft_fed + bucket <= self._draft_cap:
                # the draft ingests the same chunk (JAX :2749): it must
                # hold the prompt to propose from it. A slot whose main
                # cache jumped (a restore) catches up instead
                self._draft_chunk(i, ids, n_real, seq.draft_fed)
                seq.draft_fed += n_real
            self.prefill_chunks += 1
            self.prefill_seconds += time.monotonic() - t0
            seq.written += n_real
            seq.fed += n_real
            seq.steps += 1
            self._m_prefill_tokens.inc(n_real)
            self._m_prefill_chunk.record(n_real)
            if seq.sampling:  # final chunk: its output is the first token
                self.final_chunks += 1
                self._consume(i, seq, last)
            self.tracer.end("prefill_chunk", track=self._slot_tracks[i])
            self._prefill_next = (i + 1) % self.n_slots
            return i
        return None

    def _consume(self, slot: int, seq: _ActiveSeq, probs_row: np.ndarray) -> None:
        """Sample one token (through the request's logit pipeline, when it
        has one: penalties, then the exact host grammar mask) and emit it
        (JAX `_consume` :2541)."""
        if self._fenced:
            # a fenced thread woke mid-iteration: this handle may be
            # requeued on the replacement already
            raise _EngineFenced
        proc = seq.proc
        if proc is None:
            tok = sample_logits(probs_row, seq.temperature, seq.top_k,
                                seq.rng, seq.top_p)
        else:
            tok = sample_logits(proc.adjust(probs_row), seq.temperature,
                                seq.top_k, seq.rng, seq.top_p,
                                allow=proc.allow_row())
            proc.advance(tok)
        self._emit(slot, seq, tok)

    def _emit(self, slot: int, seq: _ActiveSeq, tok: int) -> None:
        """Append one sampled token (JAX `_emit` :2596); finish and free
        the slot on a stop sequence (cut off), max tokens or EOS. A
        stream gets the tokens past any live partial stop match."""
        h = seq.handle
        if h.done():
            return  # a speculative chain ran past a stop or a grammar's
            # end: the tail was sampled but is not output
        h.tokens.append(tok)
        self._emitted_this_iter += 1
        if h.t_first_token is None:
            now = time.monotonic()
            h.t_first_token = now
            h.steps_to_first_token = seq.steps
            ttft = now - h.t_submit
            self._m_ttft.record(ttft)
            self._m_first_token.record(ttft, exemplar=h.request_id)
            if self.tracer.enabled:
                self.tracer.instant("first_token", req=h.request_id,
                                    args={"request_id": h.request_id,
                                          "ttft_ms": round(ttft * 1e3, 3)})
        if seq.phase == "prefill":
            # keyed on the phase: a resumed sequence re-runs prefill with
            # its first token long stamped
            self.tracer.end("prefill", req=h.request_id,
                            args={"steps": seq.steps})
            self.tracer.begin("decode", req=h.request_id)
            seq.phase = "decode"
            if (self.paged and seq.fork is not None
                    and seq.fork.primary_handle is h
                    and not seq.fork.published):
                self._fork_publish(slot, seq)
        proc = seq.proc
        if proc is not None:
            matched = proc.stop_feed(tok)
            if matched:
                del h.tokens[len(h.tokens) - matched:]
                h.finish_reason = "stop"
                self._retire(slot, seq)
                return
        if h.stream is not None:
            safe = len(h.tokens) - (proc.stop_pending if proc is not None
                                    else 0)
            for idx in range(h.stream.sent, safe):
                h.stream.push(idx, h.tokens[idx])
        eos = seq.eos_id is not None and tok == seq.eos_id
        if len(h.tokens) >= h.max_new_tokens or eos:
            h.finish_reason = "eos" if eos else "length"
            self._retire(slot, seq)

    def _step_once(self) -> bool:
        """One iteration: admission, at most one prefill chunk, then the
        all-slots decode step. Returns False when it idled."""
        if self._fenced:
            raise _EngineFenced
        failpoints.fire("scheduler.iteration")  # chaos seam
        if self._fenced:
            raise _EngineFenced
        prof = self.profiler
        prof.iter_begin()
        self._evict_cancelled()
        if self.paged:
            self._try_upgrade_slots()
            if self.tier is not None:
                # pace the tier worker and integrate landed promotions
                # before admission, idle passes included (JAX :3196)
                self._tier_tick()
        self._admit()
        active = [(i, s) for i, s in enumerate(self._slots) if s is not None]
        if not active:
            return False  # idle pass: no laps recorded
        prof.lap("admit")
        t0 = time.monotonic()
        self._emitted_this_iter = 0
        chunked = self._run_prefill_chunk()
        prof.lap("prefill")
        self._run_draft_catchup()
        prof.lap("draft")
        # the decode-ready slots: speculating ones (`spec`) take the draft
        # and verify path; the rest (mid-catch-up, out of headroom, one
        # token from done) decode plain (`fed`)
        fed: List[Tuple[int, _ActiveSeq]] = []
        spec: List[Tuple[int, _ActiveSeq]] = []
        G = self.speculate
        # oldest first: a preemption takes the latest-submitted slot, which
        # comes last here, so a slot already in `fed` never loses its blocks
        for i, seq in sorted(active, key=lambda e: e[1].handle.t_submit):
            if self._slots[i] is not seq or i == chunked:
                continue  # preempted above, or had its chunk turn
            if seq.sampling and seq.proc is not None \
                    and seq.proc.exhausted():
                # the grammar admits nothing more: the structured output
                # is complete, finished before any dispatch
                seq.handle.finish_reason = "grammar"
                self._retire(i, seq)
                continue
            if not seq.sampling and self.prefill_buckets \
                    and self._pick_chunk(seq)[1]:
                continue  # mid-prefill: waits for its chunk turn
            want = G + 1 if G and seq.sampling and self._spec_ready(seq) \
                else 1
            if self.paged and (
                    not self._ensure_blocks(i, seq, seq.written + want)
                    or not self._ensure_writable(i, seq, seq.written)):
                continue  # seq itself was preempted for blocks
            (spec if want > 1 else fed).append((i, seq))
        prof.lap("pool")
        if fed:
            self._decode(fed)  # laps "decode" after its host read
        prof.lap("accept")
        if spec:
            self._run_speculation(spec)
        prof.lap("verify")
        if self._emitted_this_iter:
            self._m_tokens.inc(self._emitted_this_iter)
        self._m_occupancy.record(len(active))
        self._m_step_time.record(time.monotonic() - t0)
        prof.iter_end(tokens=self._emitted_this_iter)
        return True

    # -- the decode step ------------------------------------------------------
    def _table_for(self, max_pos: int) -> np.ndarray:
        """The host table sliced to the pow2 bucket covering ``max_pos``."""
        nb = bucket_for(max(1, blocks_for(max_pos, self.kv_block)),
                        self.table_buckets)
        return np.ascontiguousarray(self._table[:, :nb])

    def _decode_inputs(self, fed: List[Tuple[int, _ActiveSeq]]):
        """(ids, live, pos) [n_slots] of one decode step. A masked row
        keeps its slot's position (contiguous: it writes there, and the
        slot's next real write overwrites it; paged: it writes to the
        scratch page); an idle slot sits at 0."""
        ids = np.zeros((self.n_slots,), np.int32)
        live = np.zeros((self.n_slots,), np.int32)
        pos = np.zeros((self.n_slots,), np.int32)
        for i, seq in enumerate(self._slots):
            if seq is not None:
                pos[i] = seq.written
        for i, seq in fed:
            ids[i] = seq.next_input()
            live[i] = 1
        return ids, live, pos

    def _step(self, ids, live, pos, table, mstate) -> torch.Tensor:
        """One decode step of every slot from device inputs (ids, live,
        pos [n_slots]; table [n_slots, nb] or None; mstate [n_slots] or
        None): the one-hot is built here, on the device, as JAX `_step_fn`
        does in-program; with ``mstate`` each slot's mask-table row is
        added (JAX `_step_masked_fn` :1265). Returns [n_slots, vocab]
        f32."""
        x = self._onehot(ids)[:, None]
        lv = live != 0
        if self.recurrent:
            out = self._rnn_step(x, lv)
        else:
            sts = self._dispatch_states(pos, table, lv[:, None])
            out = self._forward(x, sts)[:, -1, :]
        if mstate is not None:
            out = out + self._masks.index_select(0, mstate.long())
        return out.float()

    def _step_body(self, r: _DecodeRunner) -> torch.Tensor:
        """The decode step on ``r``'s static buffers — what a capture
        records."""
        return self._step(r.ids, r.live, r.pos, r.table, r.mstate)

    def _new_runner(self, nb: Optional[int],
                    masked: bool = False) -> _DecodeRunner:
        """Static buffers for table bucket ``nb`` (None: contiguous),
        under the capture budget: one runner per bucket and variant over
        the engine's life, and no unmasked one once warmup() has run (a
        masked one is captured on first use unless warmup(masks=True)
        built it)."""
        runners = self._mrunners if masked else self._runners
        if nb in runners or (self._warmed and not masked):
            raise RuntimeError(f"capture budget spent: the "
                               f"{'masked ' if masked else ''}decode step of "
                               f"bucket {nb} was built already or warmup() "
                               "has run")
        return _DecodeRunner(self.n_slots, nb, self.device, masked=masked)

    def _body(self, r):
        fam = r.family
        if fam == "prefill":
            return self._chunk_body(r)
        if fam == "draft_prefill":
            return self._draft_chunk_body(r)
        if fam.endswith("verify"):
            return self._verify_body(r)
        if fam.endswith("draft"):
            return self._draft_body(r)
        return self._step_body(r)

    def _build(self, r, trace: bool = True) -> None:
        """Capture runner ``r`` (a decode step or a prefill chunk) on the
        card, on the inputs it holds now, and register it; stamps a
        ``capture`` instant when ``trace``. A capture is a one-off setup
        event: the transfer guard lets its eager run read positions."""
        if self.device.type == "cuda":
            with self._allow_sync():
                self._capture(r)
        kind = r.family
        if kind == "prefill":
            self._chunk_runners[r.key] = r
            self.prefill_captures += 1
        elif kind == "masked_decode":
            self._mrunners[r.key] = r
            self.masked_captures += 1
        elif kind == "decode":
            self._runners[r.key] = r
            self.decode_captures += 1
        else:
            self._spec_runners[(kind, r.key)] = r
            self.spec_captures[kind] = self.spec_captures.get(kind, 0) + 1
        if trace and self.tracer.enabled:
            self.tracer.instant("capture", track=self._sched_track,
                                args={"bucket": r.key, "kind": kind,
                                      "graph": r.graph is not None,
                                      "captures": self.decode_captures
                                      + self.prefill_captures
                                      + self.masked_captures
                                      + sum(self.spec_captures.values())})

    def _capture(self, r) -> None:
        """Record ``r``'s body into a CUDA graph. The body runs eagerly
        once on a side stream first, as capture requires (the kernel
        libraries load, cuBLAS makes its handles, the allocator its
        blocks); on the inputs staged now it writes what the replay will
        write again, so it changes nothing. Kernel launches of the two
        runs are taken back out of ``LAUNCHES``; the capture's own count
        is added on every replay. A failure raises.

        The capture is begun and ended on the graph itself, not through
        the ``torch.cuda.graph`` context, whose entry synchronizes the
        device and empties the allocator's cache on every capture: for
        warmup()'s dozens of captures that was most of their time. In
        its place automatic garbage collection is paused across the
        capture (`gc_paused`), as the context's collection beforehand
        meant to ensure: a collection inside could destroy another,
        unreachable graph (a stopped engine's), which invalidates it."""
        dev = self.device
        if self._graph_pool is None:
            self._graph_pool = torch.cuda.graph_pool_handle()
        s = _capture_stream(dev)
        before = dict(ck.LAUNCHES)
        s.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(s):
            self._body(r)
        torch.cuda.current_stream(dev).wait_stream(s)
        g = torch.cuda.CUDAGraph()
        mark = dict(ck.LAUNCHES)
        with gc_paused(), torch.cuda.stream(s):
            g.capture_begin(pool=self._graph_pool,
                            capture_error_mode="thread_local")
            try:
                r.out = self._body(r)
            finally:
                g.capture_end()
        r.launches = {k: ck.LAUNCHES[k] - mark[k] for k in mark
                      if ck.LAUNCHES[k] != mark[k]}
        ck.LAUNCHES.update(before)
        r.graph = g

    def _replay(self, r) -> None:
        """Run ``r``'s body: replay its graph (adding its launches), or run
        it eagerly on the CPU; the output lands in ``r.out``."""
        if r.graph is None:
            r.out = self._body(r)
        else:
            r.graph.replay()
            for k, n in r.launches.items():
                ck.LAUNCHES[k] += n
            if r.family not in ("decode", "masked_decode", "prefill"):
                self.spec_launches += sum(r.launches.values())

    def _decode(self, fed: List[Tuple[int, _ActiveSeq]]) -> None:
        failpoints.fire("dispatch.decode")  # chaos seam
        if self._fenced:
            raise _EngineFenced
        t0 = time.monotonic()
        ids, live, pos = self._decode_inputs(fed)
        # the masked variant only while a device-resident grammar is in
        # the batch; other slots point at row 0 (all zeros)
        mstate = None
        if self._masks is not None:
            for i, seq in fed:
                p = seq.proc
                if p is not None and p.mask_base is not None:
                    if mstate is None:
                        mstate = np.zeros((self.n_slots,), np.int32)
                    mstate[i] = p.mask_base + p.gstate
        masked = mstate is not None
        deepest = max(s.written + 1 for _, s in fed)
        if self.decode_graphs == "on":
            table = self._table_for(deepest) if self.paged else None
            nb = table.shape[1] if self.paged else None
            self.profiler.count("decode", nb or 0)
            r = (self._mrunners if masked else self._runners).get(nb)
            new = r is None
            if new:
                r = self._new_runner(nb, masked)
            r.fill(ids, live, pos, table, mstate)
            if new:
                # captured on this step's inputs: the capture's eager run
                # writes just what the replay writes
                self._build(r)
            self._replay(r)
            probs = self._host_read(r.out)
        else:
            table = self._table_for(deepest) if self.paged else None
            self.profiler.count("decode", table.shape[1] if self.paged else 0)
            probs = self._eager_decode(ids, live, pos, table, mstate)
        self.profiler.lap("decode")
        self.decode_steps += 1
        dt = time.monotonic() - t0
        self.decode_seconds += dt
        if masked:
            self.masked_steps += 1
            self.masked_seconds += dt
        for i, seq in fed:
            seq.steps += 1
            seq.written += 1
            was_sampling = seq.sampling
            if seq.fed < len(seq.prompt):
                seq.fed += 1
            if not was_sampling and not seq.sampling:
                continue  # still prefilling token by token
            self._consume(i, seq, probs[i])

    # -- speculative decoding: draft, verify, accept, roll back ------------
    def _draft_forward(self, x, states) -> torch.Tensor:
        """One forward of one-hots ``x`` through the draft net (the rank's
        shard under tp) with its stripes' states (JAX `_draft_forward`
        :1486)."""
        d = self._fwd_draft
        acts, _ = d._forward_impl(d.params, [x], states=states)
        return acts[d.conf.network_outputs[0]]

    def _draft_body(self, r: _DecodeRunner) -> torch.Tensor:
        """One token of every slot through the draft (JAX `_draft_step_fn`
        :1493), at each slot's draft depth; with ``mstate`` each slot's
        mask-table row is added (`_draft_step_masked_fn` :1302). A masked
        row writes at its own depth, past what the slot's draft holds, and
        the slot's next real draft write overwrites it. Returns [n_slots,
        vocab] f32."""
        x = self._onehot(r.ids)[:, None]
        sts = {name: {"k": st["k"], "v": st["v"], "pos": r.pos}
               for name, st in self._draft_states.items()}
        out = self._draft_forward(x, sts)[:, -1, :]
        if r.masked:
            out = out + self._masks.index_select(0, r.mstate.long())
        return out.float()

    def _draft_chunk_body(self, r: _ChunkRunner) -> torch.Tensor:
        """One chunk into one slot's draft stripe, the slot a device index
        (JAX `_draft_prefill_fn` :1501). Returns the last real row."""
        x = self._onehot(r.ids)[None]
        sts = {name: {"k": st["k"], "v": st["v"], "pos": r.pos,
                      "slot": r.slot}
               for name, st in self._draft_states.items()}
        out = self._draft_forward(x, sts)[0]
        last = torch.clamp(r.n_real.long() - 1, min=0)
        return out.index_select(0, last)[0].float()

    def _verify_body(self, r: _DecodeRunner) -> torch.Tensor:
        """THE verify (JAX `_verify_fn` :1528, `_verify_paged_fn` :1542):
        one target forward over [n_slots, G + 1] chains at per-slot
        depths, every position's distribution kept. ``live`` broadcast
        over the chain is the write mask: paged, a masked row writes to the
        scratch page; contiguous, it writes its rows back unchanged. With
        ``mstate`` [n_slots, G + 1] each position's mask-table row is added
        (`_verify_masked_fn` :1284). Returns [n_slots, G + 1, vocab] f32."""
        x = self._onehot(r.ids)
        wmask = (r.live != 0)[:, None].expand(-1, r.width)
        if self.paged:
            sts = self._dispatch_states(r.pos, r.table, wmask)
        else:
            sts = {name: {"k": st["k"], "v": st["v"], "pos": r.pos,
                          "wmask": wmask}
                   for name, st in self._states.items()}
        out = self._forward(x, sts)
        if r.masked:
            out = out + self._masks[r.mstate.long()]
        return out.float()

    def _new_spec_runner(self, family: str, key):
        """Static buffers of one speculative runner under the capture
        budget: one per (family, key) over the engine's life, and none but
        the masked ones once warmup() has run."""
        if (family, key) in self._spec_runners or (
                self._warmed and not family.startswith("masked_")):
            raise RuntimeError(f"capture budget spent: the {family} step of "
                               f"bucket {key} was built already or warmup() "
                               "has run")
        masked = family.startswith("masked_")
        base = family[len("masked_"):] if masked else family
        if base == "draft_prefill":
            return _ChunkRunner(key[0], None, self.device,
                                family="draft_prefill")
        width = self.speculate + 1 if base == "verify" else 1
        return _DecodeRunner(self.n_slots, key, self.device, masked=masked,
                             width=width, family=base)

    def _run_spec(self, family: str, key, fill) -> torch.Tensor:
        """Run one speculative step: its runner (built, and captured when
        the decode graphs are on, at first use), ``fill(runner)`` staging
        the inputs, then the replay. Returns the runner's output."""
        r = self._spec_runners.get((family, key))
        new = r is None
        if new:
            r = self._new_spec_runner(family, key)
        fill(r)
        if new:
            if self.decode_graphs == "on":
                self._build(r)
            else:
                self._spec_runners[(family, key)] = r
        if r.graph is None and self.device.type == "cuda":
            n0 = sum(ck.LAUNCHES.values())
            self._mirror_spec(r)
            self.spec_launches += sum(ck.LAUNCHES.values()) - n0
        else:
            self._mirror_spec(r)
        return r.out

    def _mirror_spec(self, r) -> None:
        """Replay speculative runner ``r``; a tp driver first broadcasts
        its staged int32 vector in one command (`OP_VERIFY`, `OP_DRAFT`,
        `OP_DRAFT_CHUNK`), and every follower runs the same body on its
        own runner (`_exec_spec`)."""
        if not self._tp_driver:
            return self._replay(r)
        base = r.family[len("masked_"):] if r.family.startswith("masked_") \
            else r.family
        if base == "draft_prefill":
            op, args = OP_DRAFT_CHUNK, (r.bucket,)
        else:
            op = OP_VERIFY if base == "verify" else OP_DRAFT
            args = (int(r.masked), r.nb or 0)
        self._mirror(op, args, r.host, lambda: self._replay(r))

    def _exec_spec(self, op: int, args, payload: np.ndarray) -> torch.Tensor:
        """A follower's side of `_mirror_spec`: the runner of the same
        (family, key), built at first use, its vector from the payload."""
        if op == OP_DRAFT_CHUNK:
            fam, key = "draft_prefill", (args[0], None)
        else:
            fam = ("masked_" if args[0] else "") + (
                "verify" if op == OP_VERIFY else "draft")
            key = args[1] or None
        r = self._spec_runners.get((fam, key))
        if r is None:
            r = self._spec_runners[(fam, key)] = \
                self._new_spec_runner(fam, key)
        r.packed.copy_(self._to_device(payload))
        return self._body(r)

    def _draft_chunk(self, slot: int, ids: np.ndarray, n_real: int,
                     pos: int) -> None:
        """One chunk of ``slot`` into its draft stripe at depth ``pos``."""
        t0 = time.monotonic()
        self.profiler.count("draft_prefill", ids.shape[0])
        self._run_spec("draft_prefill", (ids.shape[0], None),
                       lambda r: r.fill(ids, n_real, pos, slot, None))
        self.draft_chunks += 1
        self.draft_seconds += time.monotonic() - t0

    def _spec_ready(self, seq: _ActiveSeq) -> bool:
        """Can this decode-ready slot speculate this iteration (JAX :2776)?
        The draft within lockstep range (lag 1 after a plain accept, 2
        after a full one), G + 1 rows of headroom in the main cache and G
        in the draft's, and at least 2 tokens still wanted."""
        G = self.speculate
        h = seq.handle
        lag = seq.known_tokens() - seq.draft_fed
        if not 1 <= lag <= min(2, G):
            return False
        if h.max_new_tokens - len(h.tokens) < 2:
            return False
        if self._cache_cap is not None and \
                seq.written + G + 1 > self._cache_cap:
            return False
        return seq.draft_fed + G <= self._draft_cap

    def _run_draft_catchup(self) -> Optional[int]:
        """At most one draft catch-up chunk an iteration (JAX :2802): a
        decoding slot whose main cache jumped past tokens the draft never
        saw (a prefix restore, a resume) feeds the gap, up to the token
        before the last, through the draft's chunk. Returns the slot."""
        if not self.speculate:
            return None
        for i, seq in enumerate(self._slots):
            if seq is None or not seq.sampling:
                continue
            lag = seq.known_tokens() - seq.draft_fed
            if lag <= 2:
                continue
            n_real = min(lag - 1, self.prefill_chunk)
            bucket = bucket_for(n_real, self.prefill_buckets)
            if seq.draft_fed + bucket > self._draft_cap:
                fitting = [b for b in self.prefill_buckets
                           if seq.draft_fed + b <= self._draft_cap]
                if not fitting:
                    continue  # no draft headroom: the slot decodes plain
                bucket = fitting[-1]
                n_real = min(n_real, bucket)
            full = seq.full_context()
            ids = np.zeros((bucket,), np.int32)
            ids[:n_real] = full[seq.draft_fed:seq.draft_fed + n_real]
            self._draft_chunk(i, ids, n_real, seq.draft_fed)
            seq.draft_fed += n_real
            return i
        return None

    def _truncate_blocks(self, slot: int, seq: _ActiveSeq) -> int:
        """Paged rollback (JAX :2846): pop the slot's table entries wholly
        past the accepted frontier (the verify allocated through written +
        G + 1) and return the owned pages to the pool. Returns the blocks
        popped."""
        need = blocks_for(seq.written, self.kv_block)
        freed = 0
        while len(seq.block_ids) > need:
            bid = seq.block_ids.pop()
            if not seq.shared.pop():
                self.pool.free_block(bid)
            self._table[slot, len(seq.block_ids)] = SCRATCH_BLOCK
            freed += 1
        return freed

    def _run_speculation(self, spec: List[Tuple[int, _ActiveSeq]]) -> None:
        """The speculative iteration of every eligible slot at once (JAX
        :2864): G lockstep draft rounds (round r < lag feeds a token the
        draft has not ingested, later rounds the last proposal; a grammar
        slot proposes the argmax its host ``allow`` row admits, along its
        speculative DFA chain), ONE verify, `accept_tokens` with each
        sequence's own RNG and logit pipeline, then the rollback: the
        host's ``written`` and ``draft_fed`` step back over the rejected
        tail and, paged, the pages past the frontier return to the pool."""
        G = self.speculate
        tr = self.tracer
        n = self.n_slots
        t0 = time.monotonic()
        info = []
        for i, seq in spec:
            known = seq.known_tokens()
            lag = known - seq.draft_fed
            info.append((i, seq, known, lag, seq.tail_context(lag), []))
        live = np.zeros((n,), np.int32)
        for i, *_ in info:
            live[i] = 1
        # schain[i][j]: the grammar state after proposals[0..j-1], from the
        # pipeline's live state; drives the per-round draft mask, the
        # per-position verify mask and the host mask on the draft's argmax
        schain: Dict[int, List[int]] = {}
        use_mask = False
        for i, seq, *_ in info:
            p = seq.proc
            if p is not None and p.grammar is not None:
                schain[i] = [p.gstate]
                if p.mask_base is not None:
                    use_mask = True
        fam = "masked_draft" if use_mask else "draft"
        base = np.zeros((n,), np.int32)
        for i, seq in enumerate(self._slots):
            if seq is not None:
                # a frozen row writes past its slot's draft depth (at the
                # last row when the stripe is full: never read again)
                base[i] = min(seq.draft_fed, self._draft_cap - 1)
        for r in range(G):
            ids = np.zeros((n,), np.int32)
            pos = base.copy()
            mstate = np.zeros((n,), np.int32) if use_mask else None
            for i, seq, known, lag, tail, props in info:
                ids[i] = tail[r] if r < lag else props[r - lag]
                pos[i] = seq.draft_fed + r
                p = seq.proc
                if use_mask and p is not None and p.mask_base is not None:
                    mstate[i] = p.mask_base + schain[i][-1]
            self.profiler.count("draft", 0)
            out = self._run_spec(fam, None, lambda rr: rr.fill(
                ids, live, pos, None, mstate))
            rows = self._host_read(out)
            self.draft_steps += 1
            for i, seq, known, lag, tail, props in info:
                if r < lag - 1:
                    continue  # a catch-up round: its output is known
                row = rows[i]
                if i in schain:
                    g = seq.proc.grammar
                    # softmax rows are >= 0: -1 never wins
                    row = np.where(g.allow[schain[i][-1]], row, -1.0)
                    prop = int(row.argmax())
                    schain[i].append(g.step(schain[i][-1], prop))
                    props.append(prop)
                    continue
                props.append(int(row.argmax()))
        t1 = time.monotonic()
        self.draft_seconds += t1 - t0
        # the seam before any span opens: an injected crash must not
        # strand an unclosed span
        failpoints.fire("dispatch.verify")
        if self._fenced:
            raise _EngineFenced
        ids2 = np.zeros((n, G + 1), np.int32)
        pos2 = np.zeros((n,), np.int32)  # masked rows: writes discarded
        for i, seq, known, lag, tail, props in info:
            chain = [tail[-1]] + props
            chain += [chain[-1]] * (G + 1 - len(chain))  # pad lanes
            ids2[i] = chain
            pos2[i] = seq.written
            if tr.enabled:
                tr.instant("draft", track=self._slot_tracks[i],
                           args={"request": seq.handle.request_id,
                                 "proposed": len(props)})
                tr.begin("verify", req=seq.handle.request_id,
                         args={"slot": i, "proposed": len(props)})
        mstate2 = None
        if use_mask:
            # position j's row: the state after proposals[0..j-1]; pad
            # lanes repeat the last state (their rows are never read)
            mstate2 = np.zeros((n, G + 1), np.int32)
            for i, seq, *_ in info:
                p = seq.proc
                if p is not None and p.mask_base is not None:
                    chain = schain[i]
                    chain = chain + [chain[-1]] * (G + 1 - len(chain))
                    mstate2[i] = [p.mask_base + st for st in chain[:G + 1]]
        table = self._table_for(max(s.written + G + 1 for _, s, *_ in info)) \
            if self.paged else None
        nb = table.shape[1] if self.paged else None
        self.profiler.count("verify", nb or 0)
        out = self._run_spec("masked_verify" if use_mask else "verify", nb,
                             lambda rr: rr.fill(ids2, live, pos2, table,
                                                mstate2))
        rows2 = self._host_read(out)
        self.spec_rounds += 1
        self.verify_seconds += time.monotonic() - t1
        if self._fenced:
            raise _EngineFenced
        proposed = accepted = 0
        for i, seq, known, lag, tail, props in info:
            h = seq.handle
            emitted, matched = accept_tokens(
                rows2[i], props, seq.temperature, seq.top_k, seq.top_p,
                seq.rng, h.max_new_tokens - len(h.tokens), seq.eos_id,
                proc=seq.proc)
            proposed += len(props)
            accepted += matched
            seq.steps += 1
            seq.written += len(emitted)
            seq.draft_fed = known + min(G - lag, matched)
            for tok in emitted:
                self._emit(i, seq, tok)
            freed = 0
            if self.paged and self._slots[i] is seq:
                freed = self._truncate_blocks(i, seq)
            if tr.enabled:
                tr.end("verify", req=h.request_id,
                       args={"accepted": len(emitted), "matched": matched})
                if len(emitted) < len(props) + 1:
                    # mismatch: the target's token left the draft (not an
                    # EOS, a budget or a grammar cut); tokens: the output's
                    # length after the last accepted token
                    j = len(emitted) - 1
                    tr.instant("rollback", track=self._slot_tracks[i],
                               args={"request": h.request_id,
                                     "rejected": len(props) + 1
                                     - len(emitted),
                                     "blocks_freed": freed,
                                     "tokens": len(h.tokens),
                                     "mismatch": j < len(props)
                                     and emitted[j] != props[j]})
        self.spec_proposed += proposed
        self.spec_accepted += accepted
        self._m_spec_proposed.inc(proposed)
        if accepted:
            self._m_spec_accepted.inc(accepted)

    def _warm_speculation(self, masks: bool) -> None:
        """warmup()'s speculative captures (JAX :3615): the verify per
        table bucket (contiguous: one), the draft step, a draft chunk per
        chunk bucket, and with ``masks`` the masked verify and draft; all
        lanes masked (paged rows to the scratch page, contiguous rows
        written back unchanged; the draft rows land in idle stripes, which
        admission zeroes)."""
        s, w = self.n_slots, self.speculate + 1
        zeros = np.zeros((s,), np.int32)
        fams = [("verify", "draft")] + ([("masked_verify", "masked_draft")]
                                        if masks and self._masks is not None
                                        else [])
        for vfam, dfam in fams:
            mst = np.zeros((s, w), np.int32) if vfam.startswith("masked") \
                else None
            for nb in (self.table_buckets if self.paged else [None]):
                if (vfam, nb) in self._spec_runners:
                    continue
                r = self._new_spec_runner(vfam, nb)
                r.fill(np.zeros((s, w), np.int32), zeros, zeros,
                       np.full((s, nb), SCRATCH_BLOCK, np.int32)
                       if nb else None, mst)
                self._build(r, trace=False)
            if (dfam, None) not in self._spec_runners:
                r = self._new_spec_runner(dfam, None)
                r.fill(zeros, zeros, zeros, None,
                       zeros if mst is not None else None)
                self._build(r, trace=False)
        for b in self.prefill_buckets:
            if ("draft_prefill", (b, None)) in self._spec_runners:
                continue
            r = self._new_spec_runner("draft_prefill", (b, None))
            r.fill(np.zeros((b,), np.int32), 0, 0, 0, None)
            self._build(r, trace=False)
        for st in self._draft_states.values():
            for rows in st.values():
                rows[0].zero_()

    def warmup(self, masks: Optional[bool] = None) -> None:
        """Build everything the serving loop would otherwise build under
        traffic (JAX :3496): the kernels, every decode step (paged: one
        per table bucket; contiguous and recurrent: the one) and every
        prefill chunk (paged: one per (chunk bucket, table bucket) pair;
        contiguous and recurrent: one per chunk bucket), captured on the
        card, with all lanes masked to the scratch page (paged) or frozen
        (recurrent), or on slot 0 followed by its reset, and one scratch
        -> scratch COW copy; a speculating engine's verify (per table
        bucket), draft step and draft chunks (`_warm_speculation`). With
        ``decode_graphs="off"`` the chunks run once eagerly instead. ``masks``: also capture the masked decode
        steps (default: only when grammars are resident already; a
        deployment expecting grammars passes True, and may call warmup
        again for them on an idle engine). Nothing observable changes: no
        metrics, no trace records, no pool state, no slot bookkeeping.
        Call it before traffic (no slot resident); once it has run, live
        traffic captures nothing of what it built."""
        if any(s is not None for s in self._slots):
            raise RuntimeError("warmup() runs before traffic: a slot is "
                               "resident")
        if masks is None:
            masks = (self.maskpool is not None
                     and self.maskpool.resident_rows() > 0)
        t0 = time.monotonic()
        s = self.n_slots
        zeros = np.zeros((s,), np.int32)
        graphs = self.decode_graphs == "on"
        with torch.no_grad():
            if self.device.type == "cuda" and self.paged \
                    and self.paged_kernel == "on":
                ck._lib("paged_decode_attention")
            for nb in (self.table_buckets if self.paged else [None]):
                if not graphs or nb in self._runners:
                    continue
                # every lane masked at position 0: paged rows write to the
                # scratch page, contiguous rows into idle stripes, which
                # admission zeroes
                r = self._new_runner(nb)
                r.fill(zeros, zeros, zeros,
                       np.full((s, nb), SCRATCH_BLOCK, np.int32)
                       if nb else None)
                self._build(r, trace=False)
            for nb in (self.table_buckets if self.paged else [None]):
                if not (graphs and masks and self._masks is not None) \
                        or nb in self._mrunners:
                    continue
                r = self._new_runner(nb, masked=True)
                r.fill(zeros, zeros, zeros,
                       np.full((s, nb), SCRATCH_BLOCK, np.int32)
                       if nb else None, zeros)
                self._build(r, trace=False)
            # no slot is resident: every table row is scratch, and no lane
            # is real (n_real 0), so paged writes go to the scratch page
            for b in self.prefill_buckets:
                ids = np.zeros((b,), np.int32)
                for nb in (self.table_buckets if self.paged else [None]):
                    if not graphs:
                        if self.paged:
                            self._eager_chunk(0, ids, 0, 0, nb)
                        else:
                            self._eager_chunk(0, ids, 0, 1)
                        continue
                    if (b, nb) in self._chunk_runners:
                        continue
                    r = self._new_chunk_runner(b, nb)
                    r.fill(ids, 0, 0, 0,
                           np.full((nb,), SCRATCH_BLOCK, np.int32)
                           if nb else None)
                    self._build(r, trace=False)
                if not self.paged:
                    self._reset_slot_state(0)
            if self.speculate and graphs:
                self._warm_speculation(masks)
            if self.paged:
                self._copy_page(SCRATCH_BLOCK, SCRATCH_BLOCK)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        if graphs:
            self._warmed = True
        # the analytic cost table takes milliseconds (a rebuilt engine
        # over the same net takes the cached one): install it now, after
        # the captures that decide each bucket's "fused" flag, so the
        # FLOPs window counts from the first iteration (JAX defers its
        # XLA lowering to the first /debug/engine read)
        self.attribute_costs()
        self.warmup_seconds = time.monotonic() - t0

    # -- KV tiering (kvtier.py; JAX :1657-1700, :3045-3180) -----------------
    def _wake(self) -> None:
        """Wake an idle loop (a copydown is waiting for the next tick)."""
        with self._cond:
            self._cond.notify_all()

    def _full_row_shape(self, pages: torch.Tensor) -> tuple:
        """One page row's shape with every head: [block, Hkv, Dh] (int8
        scales [block, Hkv]); a rank's pages hold Hkv / tp of them."""
        shape = list(pages.shape[1:])
        shape[1] *= self.tp
        return tuple(shape)

    def _page_groups(self) -> List[list]:
        """The page tensors grouped by dtype and row shape, in the same
        order on every rank: [(layer, page key, pages), ...] a group."""
        groups: Dict[tuple, list] = {}
        for lk, st in self._states.items():
            for pk, pages in st.items():
                groups.setdefault((pages.dtype, tuple(pages.shape[1:])),
                                  []).append((lk, pk, pages))
        return list(groups.values())

    def _tier_capture(self, bid: int):
        """The TierManager's capture hook (scheduler thread, from the
        pool's `_evict_lru` or a copydown): copy page ``bid``'s rows of
        every layer (K/V, and the int8 scale rows) into staging tensors
        on the engine's stream — one stack of the rows of each dtype and
        shape, which the worker moves whole — and record an event behind
        the copies. A later dispatch that reuses the page is queued after
        them; the worker waits on the event, never on the device. Under
        tp the capture is one command (`OP_SPILL`): every rank stacks its
        head slice and the stacks reach the driver whole through one
        all-gather a group, on the host (the tier's path, never the
        step's), so the block is tiered with every head, as at tp = 1."""
        from .kvtier import StagedRows
        groups = self._page_groups()
        if self._tp_driver:
            stacks = self._mirror(OP_SPILL, (bid,), None,
                                  lambda: self._exec_spill(bid))
        else:
            stacks = [torch.stack([pages[bid] for _, _, pages in members])
                      for members in groups]
        rows = StagedRows()
        rows.groups = []
        for members, stack in zip(groups, stacks):
            keys = [(lk, pk) for lk, pk, _ in members]
            rows.groups.append((stack, keys))
            for (lk, pk), view in zip(keys, stack.unbind(0)):
                rows.setdefault(lk, {})[pk] = view
        if self.device.type == "cuda" and not self._tp_driver:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(self.device))
            rows.event = ev
        return rows

    def _exec_spill(self, bid: int) -> List[torch.Tensor]:
        """Every rank's side of a tp spill: its head slice of page
        ``bid``, a stack a group, gathered along the head axis into the
        whole block's stacks (host tensors)."""
        return [self.mesh.all_gather(
            torch.stack([pages[bid] for _, _, pages in members]).cpu(), 2)
            for members in self._page_groups()]

    def _exec_promote(self, bid: int, nbytes: int,
                      rows: Optional[dict] = None) -> None:
        """Copy a promoted block's rows into page ``bid`` in place. Under
        tp the driver's whole rows reach every rank in one data broadcast
        (packed bytes in `_page_groups` order) and each rank copies its
        head slice; ``rows`` is None on a follower."""
        members = [m for g in self._page_groups() for m in g]
        if self.tp > 1:
            if rows is not None:
                buf = torch.cat([rows[lk][pk].detach().cpu()
                                 .to(pages.dtype).contiguous()
                                 .view(torch.uint8).reshape(-1)
                                 for lk, pk, pages in members])
            else:
                buf = torch.zeros(nbytes, dtype=torch.uint8)
            buf = self.mesh.broadcast_data(buf)
            rows, o = {}, 0
            for lk, pk, pages in members:
                shape = self._full_row_shape(pages)
                n = int(np.prod(shape)) * pages.element_size()
                rows.setdefault(lk, {})[pk] = buf[o:o + n].clone().view(
                    pages.dtype).view(shape)
                o += n
        dst, src = [], []
        for lk, pk, pages in members:
            a = rows[lk][pk]
            if self.tp > 1:
                h = pages.shape[2]
                a = a.narrow(1, self.mesh.rank * h, h)
            dst.append(pages[bid])
            src.append(a)
        # one call for every row: each torch call hands the GIL around
        torch._foreach_copy_(dst, src, non_blocking=True)

    def _tier_tick(self) -> None:
        """Per-iteration tier maintenance (JAX :3045): grant the worker
        its pacing credit, serve pending copydowns (peer fetches),
        integrate the promotions the worker staged, and upgrade
        mid-prefill slots onto them. Every step is bounded: the decode
        never waits on a transfer, and a promotion that has not landed
        leaves its slot prefilling its cold suffix."""
        tier = self.tier
        idle = all(s is None for s in self._slots)
        # idle passes wake at 10 Hz: a bigger grant drains a backlog
        grant = self._tier_chunk * (8 if idle else 1)
        tier.pace(grant)
        for h in tier.pending_copydowns(4):
            self._tier_copydown(h)
        promoted = False
        for entry, rows in tier.drain_ready(grant):
            promoted = self._integrate_promotion(entry, rows) or promoted
        if promoted:
            self._try_upgrade_slots(from_tier=True)

    def _tier_copydown(self, h: str) -> None:
        """Stage a device-resident chain block into the host ring (no
        eviction) so ``/prefix/block`` can serve it to a peer."""
        tier = self.tier
        info = tier.entry_info(h)
        if info is None:
            return
        prefix, depth = info
        node, ids = self.pool._walk_prefix(list(prefix), depth)
        if len(ids) != depth or node.hash != h:
            return  # no longer resident: the waiter times out
        tier.complete_copydown(h, self._tier_capture(node.block_id))

    def _integrate_promotion(self, entry, rows) -> bool:
        """Copy one promoted block's rows into a free page, in place (the
        captured graphs hold the page tensors' addresses; the copy rides
        the engine's stream, so it runs before the first replay that
        reads the page), and adopt the page into the trie. A block whose
        parent chain is gone, that finds no free page, or whose rows do
        not fit the pool's pages is dropped (the prefix recomputes cold,
        counted as a failed restore). The parent is pinned across the
        allocation: otherwise, as the only unpinned leaf of a full pool,
        its own page would be evicted and handed back as the child's."""
        tier = self.tier
        tokens = list(entry.prefix)
        depth = int(entry.depth)
        node, ids = self.pool._walk_prefix(tokens, depth)
        if len(ids) == depth:
            tier.promotion_done(entry.hash, True)  # resident already
            return False
        if len(ids) != depth - 1 or not self._rows_fit(rows):
            tier.promotion_done(entry.hash, False)
            return False
        t0 = time.monotonic()
        node.lock += 1
        try:
            bid = self.pool.alloc()
            if bid is None:
                # every page is referenced: a promotion never preempts
                tier.promotion_done(entry.hash, False)
                return False
            try:
                nbytes = sum(int(np.prod(self._full_row_shape(pages)))
                             * pages.element_size()
                             for g in self._page_groups()
                             for _, _, pages in g)
                self._mirror(OP_PROMOTE, (bid, nbytes), None,
                             lambda: self._exec_promote(bid, nbytes, rows))
            except Exception:
                self.pool.free_block(bid)
                tier.promotion_done(entry.hash, False)
                raise
            self.pool.adopt(tokens, ids + [bid])  # note_resident re-tiers it
        finally:
            node.lock -= 1
        tier.promotion_done(entry.hash, True)
        self.promoted_blocks += 1
        self.promote_seconds += time.monotonic() - t0
        self._m_tier_promoted.inc()
        if self.tracer.enabled:
            self.tracer.instant("tier_restore", track=self._sched_track,
                                args={"hash": entry.hash[:12],
                                      "depth": depth, "block": bid})
        return True

    def _rows_fit(self, rows) -> bool:
        """A promotion's rows name exactly this pool's layers and page
        keys, each of one page row's shape with every head."""
        if set(rows) != set(self._states):
            return False
        for lk, pks in rows.items():
            st = self._states[lk]
            if set(pks) != set(st):
                return False
            for pk, a in pks.items():
                if tuple(a.shape) != self._full_row_shape(st[pk]):
                    return False
        return True

    # -- attribution (profiler.py; JAX :3686-3836) --------------------------
    def attribute_costs(self) -> None:
        """Install the per-invocation cost table (`profiler.program_costs`,
        analytic from the net's shapes, cached per (net, engine shape)).
        Called lazily by `debug_snapshot`; best effort: a failure leaves
        MFU at 0 once and is not retried."""
        if not self.profiler.enabled:
            return
        with self._attr_lock:
            if self.profiler.costs or self._attr_failed:
                return
            try:
                self.profiler.ingest_costs(program_costs(self))
            except Exception as e:
                self._attr_failed = True
                if self.tracer.enabled:
                    self.tracer.instant(
                        "cost_attribution_skipped", track=self._sched_track,
                        args={"error": type(e).__name__,
                              "detail": str(e)[:200]})

    def paged_kernel_status(self) -> dict:
        """The paged kernel's engagement (JAX :3716): the mode, whether it
        runs, and per table bucket the kernel's split count S
        (`cuda_kernels._paged_splits`) where it runs — read from the
        launches counted when the bucket's decode graph was captured (the
        eager step on the card always launches it) — False where the
        layer's gather body runs (mode "off", or CPU tensors), None for a
        bucket not captured yet. The port does not autotune: there is no
        autotune block."""
        out = {"mode": self.paged_kernel, "engaged": False, "buckets": {}}
        if not self.paged:
            return out
        on = self.paged_kernel == "on" and self.device.type == "cuda"
        hkv = {impl._kv_heads() for impl in self._fwd_net._impls.values()
               if isinstance(impl, SelfAttentionLayerImpl)} \
            if self._graph else set()
        for nb in self.table_buckets:
            if not on:
                v = False
            elif self.decode_graphs != "on":
                v = True
            else:
                r = self._runners.get(nb)
                v = None if r is None else bool(
                    r.launches.get("paged_decode_attention"))
            out["buckets"][nb] = (
                {"S": {h: ck._paged_splits(self.n_slots, h, nb)
                       for h in sorted(hkv)}} if v else v)
        out["engaged"] = any(bool(v) for v in out["buckets"].values())
        return out

    def _capture_counts(self) -> Dict[str, int]:
        """The captured runners by family: the port's counterpart of the
        JAX engine's compile-cache census."""
        return {"decode": self.decode_captures,
                "prefill": self.prefill_captures,
                "masked_decode": self.masked_captures,
                **self.spec_captures}

    def mesh_topology(self) -> dict:
        """The tp actually in force, the ranks' devices and the backend
        (``/info``, ``/debug/engine``, the serve banner)."""
        devs = [str(d) for d in getattr(self.mesh, "devices",
                                        [self.device])] \
            if self._tp_driver else [str(self.device)]
        return {"tp": self.tp, "devices": len(devs), "device_list": devs,
                "backend": getattr(self.mesh, "backend", None)
                if self.tp > 1 else None}

    def debug_snapshot(self) -> dict:
        """``GET /debug/engine`` (JAX :3763): the slot table, the queue,
        the pool and its trie, the captures, the tier, speculation, the
        per-family costs with the rolling tokens/s and MFU estimates, and
        the step-phase decomposition. Called from HTTP threads against
        scheduler-owned state: every read is a GIL-atomic load, one
        iteration stale at worst."""
        slots = []
        for i, seq in enumerate(list(self._slots)):
            if seq is None:
                slots.append(None)
                continue
            h = seq.handle
            slots.append({
                "slot": i, "request_id": h.request_id, "phase": seq.phase,
                "prompt_tokens": len(seq.prompt), "fed": seq.fed,
                "written": seq.written, "tokens_out": len(h.tokens),
                "max_new_tokens": h.max_new_tokens,
                "blocks": len(seq.block_ids), "resumed": seq.resumed})
        out = {"n_slots": self.n_slots, "paged": self.paged,
               "iterations": self.iterations,
               "queue_depth": self.queue_depth(), "slots": slots,
               "compile_cache": self._capture_counts(),
               "mesh": self.mesh_topology(), "chunk_cap": self.chunk_cap}
        if self.maskpool is not None:
            out["grammar_masks"] = self.maskpool.stats()
        if self.paged:
            out["paged_kernel"] = self.paged_kernel_status()
        if self.pool is not None:
            try:
                out["pool"] = self.pool.stats()
            except RuntimeError:  # the trie changed mid-walk
                out["pool"] = {"error": "pool busy, retry"}
        if self.tier is not None:
            out["tier"] = self.tier.stats()
        if self.speculate:
            out["speculative"] = {
                "gamma": self.speculate, "draft_blocks": self.draft_blocks,
                "proposed": self._m_spec_proposed.value,
                "accepted": self._m_spec_accepted.value}
        self.attribute_costs()  # lazy for a never-warmed engine
        if self.profiler.enabled:
            out["costs"] = self.profiler.cost_snapshot()
            out["phases"] = self.profiler.decomposition()
        return out


class _TpFollower:
    """A follower rank's service (`parallel/mesh.py`): its engine runs
    each mirrored device operation on the rank's shard."""

    def __init__(self, engine: DecodeScheduler):
        self.engine = engine

    def handle(self, cmd) -> None:
        with torch.no_grad():
            self.engine._exec(cmd.op, cmd.args, cmd.payload)

    def close(self) -> None:
        self.engine = None


def _tp_follower(comm, p) -> _TpFollower:
    """Build a follower's engine: the same engine arguments over its own
    slices of the params (`sharding.effective_specs`), on its device,
    with eager steps; never started (the driver's commands run it)."""
    from ..nn.graph import ComputationGraph
    from .sharding import _slice
    tp, rank = comm.size, comm.rank
    skeleton = ComputationGraph(p["conf"], device=comm.device)
    params = {n: {k: _slice(v, p["specs"][n][k], tp, rank)
                  for k, v in lp.items()}
              for n, lp in p["params"].items()}
    eng = DecodeScheduler(
        skeleton, p["vocab"], decode_graphs="off", metrics=MetricsRegistry(),
        tracer=FlightRecorder(16, enabled=False), profile=False,
        device=comm.device,
        _tp_shard=(comm, tp, p["modes"], params, p["variables"],
                   p["draft"]), **p["kw"])
    return _TpFollower(eng)
