"""HTTP serving endpoint — a port of deeplearning4j_tpu/serving/server.py.

`InferenceServer` loads a model (a port net, or a model zip restored onto
``device``) and answers on a stdlib ThreadingHTTPServer:

  - ``/predict`` and ``/predict/csv`` run the net's forward. By default
    every request goes through a `MicroBatcher` (one per input signature,
    at most ``max_signatures``; past the cap a signature takes the
    lock-serialized path): concurrent clients' rows become one padded
    pow2-bucketed batch on the net's device, with one device->host copy
    per batch. ``batching=False`` serializes forwards under one lock.
  - ``/generate`` runs a `DecodeScheduler` — contiguous per-slot stripes
    by default (``kv_pool_mb=0``, with a side prefix pool of
    ``prefix_cache_mb``), or a paged pool of ``kv_pool_mb`` MiB; its
    decode steps and prefill chunks captured into CUDA graphs before the
    server answers (``decode_graphs="on"``). The engine runs under an
    `EngineSupervisor` by default (``supervise=False`` opts out): a
    watchdog reads the loop's heartbeat, and a crashed or hung engine is
    fenced, rebuilt by the server's factory — with the same device,
    ``paged_kernel``, ``decode_graphs`` and speculation — warmed, and every in-flight
    request resubmitted with its original handle and seed (the same
    tokens; a bounded backoff and a per-request ``retry_budget``, whose
    exhaustion is a structured 503 naming the ``request_id``). Queue
    pressure walks the degradation ladder. ``decode_transfer_guard``
    ("disallow") runs the scheduler loop under torch's sync debug mode
    (process-wide: serve ``/generate`` traffic only under it).
    ``speculate``/``draft_blocks``/``draft_net`` arm the engine's
    speculative decoding (`inference/engine.py`); ``/info`` reports whether
    it armed. A `nn.quantization` int8 program is served as any net: a
    `QuantizedNetwork` behind ``/predict``, a `quantize_graph` clone behind
    ``/generate`` too. ``host_cache_mb``/``disk_cache_mb``/``tier_dir``
    arm the paged engine's KV tiers (`inference/kvtier.py`; a rebuilt
    engine tiers again) and the ``/prefix/*`` directory below.
  - The SLO plane (`inference/profiler.py`): every served ``/predict``,
    ``/predict/csv`` and ``/generate`` request's end-to-end latency is
    observed per route (its histogram's exemplars carry the
    ``request_id``) against the ``slo_p99_ms`` objective (None tracks
    percentiles and never burns); the burn rate is the supervisor's
    second escalation input. Fast rejects (shed, admission-rejected,
    backpressure, shutdown), client errors and client disconnects are not
    sampled: they are the ladder's own output. ``profile=False`` disarms
    the engine's step-phase profiler.

The decode engine serves a ComputationGraph LM: ``decode_vocab=None``
takes its vocabulary from the output layer's width (the JAX server needs
it given). A recurrent MultiLayerNetwork (the char-RNN) is served when
``decode_vocab`` is given, as the JAX server does; ``decode_vocab=0``, or
a MultiLayerNetwork without it, serves no ``/generate``. Grammars are
compiled ahead of admission and cached by content (at most 32); a spec
that does not compile answers 400. The server owns a `MetricsRegistry`
and a span `FlightRecorder` (``trace_buffer`` events; 0 disables
recording) that the engine, the supervisor and the batchers write.

Every POST carries an ``X-Request-Id`` response header: a well-formed
client-supplied id (``[A-Za-z0-9._:-]{1,128}``) becomes the prefix of a
server-uniquified one, anything else is replaced by a fresh id; error
bodies quote it. A valid ``X-Graft-Trace`` header (`serving/telemetry.py`:
fleet trace id, parent span, hop, send time) wins over ``X-Request-Id``:
its trace id becomes the prefix, and the handler runs inside an ``rpc``
span carrying the flow edge, so `telemetry.TraceAggregator` joins this
server's spans to the sender's. A malformed header degrades to the
``X-Request-Id`` rule, never to a 500.

Endpoints:
  GET  /health            {"status": "ok", "model", "params"}
  GET  /healthz           liveness: the process answers (always 200)
  GET  /readyz            readiness: 200 while the heartbeat is fresh and
                          nothing drains or recovers, else 503 (+ status)
  GET  /info              model summary, config JSON, device, batching,
                          the engine (KV mode, captures, pool), the
                          supervisor's state, the SLO snapshot and the
                          profiler's headline (tokens/s, MFU estimate)
  GET  /debug/engine      the engine's anatomy (`debug_snapshot`: slot
                          table, pool and trie, captures, paged kernel,
                          tier, costs, phases) + supervisor + SLO; 404
                          without a decode engine
  GET  /prefix/directory  the tier's prefix-directory feed (?since=N
                          tails from a previous "next"; 0 or a cursor
                          older than the ring -> a reset snapshot); 404
                          without tiering
  GET  /prefix/block      ?hash=H -> one block's encoded payload
                          (application/octet-stream), 404 if not held
  GET  /metrics           JSON snapshot; ?format=prometheus (or an Accept:
                          application/openmetrics-text scrape) for the
                          OpenMetrics exposition with exemplars; Accept:
                          text/plain for Prometheus text 0.0.4;
                          ?format=text for the summary text
  GET  /trace             flight-recorder dump (?limit=N newest events;
                          ?since=CURSOR tails from a previous next_cursor;
                          ?format=chrome for Perfetto)
  GET  /trace/clock       the clock-alignment handshake (monotonic, wall,
                          trace_t0, pid)
  POST /predict           {"data": [[...], ...]} -> {"predictions",
                          "classes"} (?timeout_ms=N: an expired request
                          gets 504, a full queue 503)
  POST /predict/csv       text/plain CSV rows -> the same
  POST /generate          {"prompt": [ids], "max_new_tokens"?,
                          "temperature"?, "top_k"?, "top_p"?, "seed"?,
                          "eos_id"?, "priority"?, "stop"? ([ids] or
                          [[ids], ...]), "grammar"? ({"type": "admit_all"}
                          | {"type": "trie", "sequences": [[ids], ...]} |
                          {"type": "json_schema", "schema": {...},
                          "alphabet": token texts}), "repetition_penalty"?,
                          "presence_penalty"?, "frequency_penalty"?, "n"?
                          (best-of-n, at most 4 x decode slots), "stream"?}
                          -> {"tokens", "request_id", "finish_reason",
                          "timings", "retries"? (engine restarts it
                          survived)}; with n > 1 also "candidates" (each
                          {"tokens", "request_id", "finish_reason",
                          "timings"}, candidate i seeded seed + i) and
                          "n"; ?timeout_ms=N
                          (expiry cancels the decode -> 504); a full queue
                          -> 503; a prompt the cache cannot hold -> 413;
                          an unknown field, a grammar that does not
                          compile, n > 1 with stream, or a malformed body
                          -> 400. {"stream": true} ->
                          text/event-stream: one `data: {"token",
                          "index"}` event per token, then `data: {"done":
                          true, request_id, tokens, finish_reason,
                          timings}`; a client that hangs up cancels the
                          decode (slot and blocks reclaimed,
                          stream_disconnects_total)
  POST /prefix/fetch      {"peer": URL, "hashes": [parent first]} ->
                          {"fetched", "skipped", "failed"}: pull a chain
                          from a peer's /prefix/block into the local tier
                          and queue its promotion (400 without peer or
                          hashes, 404 without tiering)
  POST /admin/drain       draining restart (202; watch /readyz flip)
  GET/POST /admin/failpoints  chaos control (opt-in failpoint_endpoint):
                          {"name": seam, "spec": "crash@n:3"} arms, spec
                          null disarms, name "*" disarms all
"""
from __future__ import annotations

import hashlib
import json
import os
import re
import select
import socket
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple, Union
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from ..inference import failpoints
from ..inference.batcher import MicroBatcher, QueueFullError, _to_host
from ..inference.engine import (DecodeScheduler, EngineCrashedError,
                                PromptTooLongError)
from ..inference.failpoints import InjectedFault
from ..inference.logitproc import (GrammarError, TokenStream, admit_all,
                                   compile_json_schema, compile_trie)
from ..inference.metrics import MetricsRegistry
from ..inference.profiler import SLOMonitor
from ..inference.supervisor import (AdmissionRejectedError, EngineSupervisor,
                                    RetryBudgetExceededError,
                                    ShuttingDownError)
from ..inference.trace import FlightRecorder, new_request_id
from ..util.device import DeviceLike, resolve_device
from .streaming import RecordToDataSetConverter
from .telemetry import TRACE_HEADER, parse_trace_header

__all__ = ["InferenceServer"]

# what a client-supplied X-Request-Id may look like before it is echoed
# into a response HEADER: an obs-folded header reaches `headers.get()`
# with embedded CR/LF, and an unvalidated id would be header injection
_REQUEST_ID_RE = re.compile(r"[A-Za-z0-9._:\-]{1,128}")

# the /generate fields the port serves; any other is refused, not
# ignored (a deliberate difference from the JAX server, ROADMAP C)
_GENERATE_FIELDS = frozenset({"prompt", "max_new_tokens", "temperature",
                              "top_k", "top_p", "seed", "eos_id", "priority",
                              "stop", "grammar", "repetition_penalty",
                              "presence_penalty", "frequency_penalty", "n",
                              "stream"})
_DECODE_KWARGS = ("temperature", "top_k", "top_p", "seed", "eos_id",
                  "priority", "repetition_penalty", "presence_penalty",
                  "frequency_penalty")

# the grammar-compile cache: compiled ahead of admission, shared by
# requests carrying equal grammar specs, at most this many entries
_GRAMMAR_CACHE_CAP = 32


class _HTTPServer(ThreadingHTTPServer):
    # the listen backlog: the stdlib's 5 resets or delays (by a SYN
    # retransmit, 1 s) connections that arrive at once past it
    request_queue_size = 128


def _peer_gone(sock) -> bool:
    """True when the SSE client hung up: the socket is readable and a
    zero-byte MSG_PEEK confirms EOF (an RST raises OSError, also True).
    Polled between events, so a silent disconnect is noticed even when
    the send buffer would absorb the next write."""
    try:
        readable, _, _ = select.select([sock], [], [], 0)
        if not readable:
            return False
        return sock.recv(1, socket.MSG_PEEK) == b""
    except (OSError, ValueError):
        return True


class InferenceServer:
    def __init__(self, net=None, model_path: Union[str, Path, None] = None,
                 port: int = 0, host: str = "127.0.0.1",
                 max_batch: int = 1024,
                 converter: Optional[RecordToDataSetConverter] = None,
                 batching: bool = True, batch_window_ms: float = 2.0,
                 max_queue: int = 256,
                 default_timeout_ms: Optional[float] = None,
                 decode_vocab: Optional[int] = None, decode_slots: int = 4,
                 prefill_chunk: int = 64, decode_queue: int = 64,
                 prefix_cache_mb: float = 0.0, kv_block: int = 16,
                 kv_pool_mb: float = 0.0, kv_dtype: Optional[str] = None,
                 paged_kernel: str = "on", decode_graphs: str = "on",
                 metrics: Optional[MetricsRegistry] = None,
                 trace_buffer: int = 8192,
                 tracer: Optional[FlightRecorder] = None,
                 supervise: bool = True, hang_timeout_s: float = 5.0,
                 retry_budget: int = 3,
                 decode_transfer_guard: Optional[str] = None,
                 mask_rows: int = 64, speculate: int = 0,
                 draft_blocks: Optional[int] = None, draft_net=None,
                 host_cache_mb: float = 0.0, disk_cache_mb: float = 0.0,
                 tier_dir: Optional[str] = None,
                 slo_p99_ms: Optional[float] = None,
                 slo: Optional[SLOMonitor] = None, profile: bool = True,
                 failpoint_endpoint: bool = False,
                 decode_tp: int = 0,
                 decode_tp_devices: Optional[Sequence] = None,
                 device: DeviceLike = "cuda"):
        self.device = resolve_device(device)
        if net is None:
            if model_path is None:
                raise ValueError("pass a net or a model_path")
            from ..util.model_serializer import restore_model
            net = restore_model(model_path, device=self.device)
        self.net = net
        if decode_vocab is None and hasattr(net.conf, "vertices"):
            out = net.conf.network_outputs[0]
            decode_vocab = int(net.conf.vertices[out].layer.n_out)
        self.decode_vocab = int(decode_vocab or 0)
        self.decode_slots = int(decode_slots)
        self.max_batch = int(max_batch)
        self.converter = converter or RecordToDataSetConverter(label_index=None)
        self.batching = bool(batching)
        self.batch_window_ms = float(batch_window_ms)
        self.max_queue = int(max_queue)
        self.default_timeout_ms = default_timeout_ms
        self._decode_kw = dict(
            n_slots=decode_slots, max_queue=decode_queue,
            prefill_chunk=prefill_chunk, prefix_cache_mb=prefix_cache_mb,
            kv_block=kv_block, kv_pool_mb=kv_pool_mb, kv_dtype=kv_dtype,
            paged_kernel=paged_kernel, decode_graphs=decode_graphs,
            mask_rows=mask_rows, transfer_guard=decode_transfer_guard,
            speculate=speculate, draft_blocks=draft_blocks,
            draft_net=draft_net, host_cache_mb=host_cache_mb,
            disk_cache_mb=disk_cache_mb, tier_dir=tier_dir, profile=profile)
        # tensor-parallel decode (JAX :224, :423): every (re)build gets a
        # fresh mesh of decode_tp ranks (new followers after a crash); the
        # devices default to the engine's rule (cuda:0..N-1 on the card,
        # CPU ranks for a CPU server)
        self.decode_tp = int(decode_tp or 0)
        self.decode_tp_devices = (list(decode_tp_devices)
                                  if decode_tp_devices else None)
        self.supervise = bool(supervise)
        self.hang_timeout_s = float(hang_timeout_s)
        self.retry_budget = int(retry_budget)
        # the chaos control plane must be opted into: a production server
        # must not let clients arm crash seams
        self.failpoint_endpoint = bool(failpoint_endpoint)
        self.supervisor: Optional[EngineSupervisor] = None
        self._decoder_direct: Optional[DecodeScheduler] = None
        self._shutting_down = False
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.slo = slo if slo is not None else SLOMonitor(
            objective_p99_s=slo_p99_ms / 1e3 if slo_p99_ms else None,
            metrics=self.metrics)
        self.tracer = tracer if tracer is not None else FlightRecorder(
            trace_buffer, enabled=trace_buffer > 0)
        self._host = host
        self._port = port
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()  # the unbatched /predict path
        # one batcher per trailing input signature, bounded: a client
        # controls the signature, and each batcher costs a thread
        self._batchers: Dict[Tuple, MicroBatcher] = {}
        self._batchers_lock = threading.Lock()
        self.max_signatures = 16
        self._m_stream_reqs = self.metrics.counter(
            "stream_requests_total",
            help="/generate requests served as SSE token streams")
        self._m_stream_disconnects = self.metrics.counter(
            "stream_disconnects_total",
            help="SSE clients that hung up mid-stream (decode "
                 "cancelled, slot reclaimed)")
        self._grammar_cache: Dict[str, object] = {}
        self._grammar_lock = threading.Lock()
        self._m_grammar_compiles = self.metrics.counter(
            "grammar_compiles_total",
            help="grammar specs compiled (cache misses)")

    @property
    def port(self) -> int:
        return self._httpd.server_address[1] if self._httpd else self._port

    @property
    def decoder(self) -> Optional[DecodeScheduler]:
        """The live decode engine: a supervised server swaps engines on
        recovery and drain, so this resolves through the supervisor."""
        if self.supervisor is not None:
            return self.supervisor.engine
        return self._decoder_direct

    def _decoder_factory(self) -> DecodeScheduler:
        """Every (re)build: the same device and modes (kernel, graphs,
        speculation, tiers): a rebuilt engine speculates and tiers
        again."""
        mesh = None
        if self.decode_tp > 1:
            from ..inference.sharding import decode_mesh
            devices = self.decode_tp_devices or (
                None if self.device.type == "cuda"
                else ["cpu"] * self.decode_tp)
            mesh = (decode_mesh(self.decode_tp, devices)
                    if devices is not None else self.decode_tp)
        return DecodeScheduler(self.net, self.decode_vocab,
                               metrics=self.metrics, tracer=self.tracer,
                               device=self.device, mesh=mesh,
                               **self._decode_kw)

    def ready(self) -> Tuple[bool, dict]:
        """`/readyz` verdict + body. An unsupervised server is ready while
        not shutting down."""
        if self._shutting_down:
            return False, {"ready": False, "reason": "shutting_down"}
        if self.supervisor is not None:
            status = self.supervisor.status()
            return status["ready"], status
        return True, {"ready": True}

    def info(self) -> dict:
        dev = self.device
        body = {"model": type(self.net).__name__,
                "config": json.loads(self.net.conf.to_json()),
                "params": self.net.num_params(),
                "batching": self.batching,
                "device": {"type": dev.type,
                           "name": (torch.cuda.get_device_name(dev)
                                    if dev.type == "cuda" else "cpu")}}
        dec = self.decoder
        if dec is not None:
            body["decode"] = {
                "slots": dec.n_slots, "prefill_chunk": dec.prefill_chunk,
                "kv_mode": ("paged" if dec.paged else "recurrent"
                            if dec.recurrent else "contiguous"),
                "mask_rows": dec.mask_rows,
                "kv_dtype": dec.kv_dtype, "paged_kernel": dec.paged_kernel,
                "decode_graphs": dec.decode_graphs,
                "decode_captures": dec.decode_captures,
                "prefill_captures": dec.prefill_captures,
                "speculate": dec.speculate,
                "draft_blocks": dec.draft_blocks,
                "spec_captures": dict(dec.spec_captures),
                "int8_vertices": list(getattr(
                    self.net, "_quantized_vertices", [])),
                "transfer_guard": dec.transfer_guard,
                "pool": dec.pool.stats() if dec.pool else None}
        # the mesh in force (JAX :805): the engine's tp, not the flag
        body["mesh"] = dec.mesh_topology() if dec is not None else {
            "tp": 1, "devices": 1, "device_list": [str(dev)],
            "backend": None}
        if self.supervisor is not None:
            body["supervisor"] = self.supervisor.status()
        body["slo"] = self.slo.snapshot()
        prof = getattr(dec, "profiler", None)
        if prof is not None and prof.enabled:
            # the attribution headline; the detail is GET /debug/engine
            body["profiler"] = prof.rates()
        return body

    def _tier(self):
        """The live engine's TierManager, or None (tiering off, or no
        decode engine)."""
        dec = self.decoder
        return getattr(dec, "tier", None) if dec is not None else None

    def _prefix_fetch(self, payload: dict) -> Tuple[int, dict]:
        """POST /prefix/fetch (JAX :366): pull a block-hash chain from a
        peer's ``/prefix/block`` into the local tier. The hashes arrive
        parent first: a child whose parent chain is unknown is refused,
        so a failed parent stops the pull."""
        tier = self._tier()
        if tier is None:
            return 404, {"error": "KV tiering disabled"}
        peer = payload.get("peer") or "" if isinstance(payload, dict) \
            else ""
        hashes = payload.get("hashes") if isinstance(payload, dict) else None
        if not peer or not isinstance(hashes, list):
            return 400, {"error": "need peer URL and hashes list"}
        import urllib.request
        fetched, skipped, failed = 0, 0, 0
        inserted = []
        for h in hashes:
            h = str(h)
            if tier.holds(h):
                skipped += 1
                continue
            try:
                with urllib.request.urlopen(
                        peer.rstrip("/") + "/prefix/block?hash=" + h,
                        timeout=10.0) as resp:
                    body = resp.read()
            except OSError:
                failed += 1
                break
            if tier.insert_fetched(body) is None:
                failed += 1
                break
            fetched += 1
            inserted.append(h)
        if inserted:
            # warm the chain now: its request is usually right behind
            tier.request_restore(inserted)
        return 200, {"fetched": fetched, "skipped": skipped,
                     "failed": failed}

    # -- /predict ------------------------------------------------------------
    def _net_output(self, arr: np.ndarray):
        """One forward; a ComputationGraph's first output (its output() is
        a list, and /predict answers one tensor)."""
        out = self.net.output(arr)
        if isinstance(out, (list, tuple)):
            out = out[0]
        return out

    def _batcher_for(self, arr: np.ndarray) -> Optional[MicroBatcher]:
        sig = (arr.shape[1:], str(arr.dtype))
        with self._batchers_lock:
            b = self._batchers.get(sig)
            if b is None:
                if len(self._batchers) >= self.max_signatures:
                    return None  # signature-cap overflow: direct path
                b = MicroBatcher(
                    self._net_output, max_batch=self.max_batch,
                    max_queue=self.max_queue,
                    batch_window_s=self.batch_window_ms / 1e3,
                    metrics=self.metrics, tracer=self.tracer,
                    name="predict").start()
                self._batchers[sig] = b
            return b

    def _forward(self, arr: np.ndarray,
                 timeout_ms: Optional[float]) -> np.ndarray:
        if self.batching:
            batcher = self._batcher_for(arr)
            if batcher is not None:
                timeout_s = (timeout_ms / 1e3 if timeout_ms is not None
                             else None)
                return batcher.predict(arr, timeout_s=timeout_s)
        outs = []
        with self._lock, torch.no_grad():
            for off in range(0, arr.shape[0], self.max_batch):
                outs.append(_to_host(self._net_output(
                    arr[off:off + self.max_batch])))
        return np.concatenate(outs)

    def _predict(self, arr: np.ndarray,
                 timeout_ms: Optional[float] = None) -> dict:
        if timeout_ms is None:
            timeout_ms = self.default_timeout_ms
        out = (self._forward(arr, timeout_ms) if arr.shape[0]
               else np.zeros((0, 0), np.float32))
        return {"predictions": out.astype(float).tolist(),
                "classes": np.argmax(out, axis=-1).astype(int).tolist()
                if out.ndim >= 2 and out.shape[-1] > 0 else []}

    # -- /generate -----------------------------------------------------------
    def _generation(self):
        gen = self.supervisor if self.supervisor is not None \
            else self._decoder_direct
        if gen is None:
            raise ValueError("generation is disabled: this server has no "
                             "decode engine (a ComputationGraph LM, or "
                             "decode_vocab > 0; CLI: --generate)")
        return gen

    def _compile_grammar(self, spec, eos_id: Optional[int]):
        """Compile a /generate ``grammar`` spec ahead of admission (JAX
        :494), cached by a digest of the spec and ``eos_id``, so a
        repeated schema compiles once. Forms: ``{"type": "admit_all"}``,
        ``{"type": "trie", "sequences": [[ids], ...]}`` (exactly one of
        the sequences), ``{"type": "json_schema", "schema": {...},
        "alphabet": token id -> text}`` (`logitproc.compile_json_schema`'s
        subset). Raises GrammarError (-> 400)."""
        if not isinstance(spec, dict):
            raise GrammarError("grammar must be an object")
        key = hashlib.sha1(json.dumps([spec, eos_id],
                                      sort_keys=True).encode()).hexdigest()
        with self._grammar_lock:
            g = self._grammar_cache.get(key)
        if g is not None:
            return g
        typ = spec.get("type")
        if typ == "admit_all":
            g = admit_all(self.decode_vocab)
        elif typ == "trie":
            g = compile_trie(spec.get("sequences") or [],
                             self.decode_vocab, eos_id=eos_id)
        elif typ == "json_schema":
            alphabet = spec.get("alphabet")
            if alphabet is None:
                raise GrammarError(
                    "json_schema grammar needs an 'alphabet' (token id "
                    "-> decoded text)")
            if len(alphabet) != self.decode_vocab:
                raise GrammarError(f"alphabet length {len(alphabet)} != "
                                   f"vocab {self.decode_vocab}")
            g = compile_json_schema(spec.get("schema") or {}, alphabet,
                                    eos_id=eos_id)
        else:
            raise GrammarError(f"unknown grammar type {typ!r} (admit_all "
                               "| trie | json_schema)")
        self._m_grammar_compiles.inc()
        with self._grammar_lock:
            if len(self._grammar_cache) >= _GRAMMAR_CACHE_CAP:
                # bounded: the oldest entry goes (insertion order)
                self._grammar_cache.pop(next(iter(self._grammar_cache)))
            self._grammar_cache[key] = g
        return g

    def _parse_generate(self, payload) -> Tuple[list, int, dict]:
        """(prompt, max_new_tokens, the engine's keyword arguments) of a
        /generate body (JAX `_decode_kwargs` :550): the sampling knobs,
        the penalties, the stop sequences (one bare sequence or a list)
        and the compiled grammar. ``n`` is read by the caller."""
        if not isinstance(payload, dict) or "prompt" not in payload:
            raise ValueError("body must be a JSON object with a 'prompt'")
        unknown = sorted(set(payload) - _GENERATE_FIELDS)
        if unknown:
            raise ValueError(f"unknown /generate field(s) {unknown}")
        kw = {k: payload[k] for k in _DECODE_KWARGS if k in payload}
        stop = payload.get("stop")
        if stop:
            if isinstance(stop[0], (int, float)):
                stop = [stop]  # one bare sequence
            kw["stop"] = [[int(t) for t in q] for q in stop]
        if payload.get("grammar") is not None:
            kw["grammar"] = self._compile_grammar(payload["grammar"],
                                                  payload.get("eos_id"))
        prompt = [int(t) for t in payload["prompt"]]
        return prompt, int(payload.get("max_new_tokens", 16)), kw

    def _timeout_s(self, timeout_ms: Optional[float]) -> float:
        if timeout_ms is None:
            timeout_ms = self.default_timeout_ms
        return timeout_ms / 1e3 if timeout_ms is not None else 120.0

    def _generate(self, payload: dict, timeout_ms: Optional[float],
                  request_id: Optional[str] = None) -> dict:
        gen = self._generation()
        prompt, max_new, kw = self._parse_generate(payload)
        timeout = self._timeout_s(timeout_ms)
        n = int(payload.get("n", 1))
        if n < 1:
            raise ValueError(f"n must be >= 1, got {n}")
        if n > 1:
            # best-of-n (JAX :584): n candidates as one fork group, the
            # i-th seeded seed + i; the client ranks them
            cap = max(self.decode_slots, 1) * 4
            if n > cap:
                raise ValueError(f"n={n} exceeds the candidate cap ({cap} "
                                 "= 4x decode slots)")
            handles = gen.generate_many(prompt, n, max_new, timeout=timeout,
                                        request_id=request_id, **kw)
            return {"tokens": handles[0].tokens,
                    "candidates": [{"tokens": h.tokens,
                                    "request_id": h.request_id,
                                    "finish_reason": h.finish_reason,
                                    "timings": h.timings()}
                                   for h in handles],
                    "n": n,
                    "request_id": request_id or handles[0].request_id,
                    "finish_reason": handles[0].finish_reason,
                    "timings": handles[0].timings()}
        # supervised: tracked for crash recovery (a restart resubmits it
        # with the same handle and seed; the client never sees the crash)
        handle = gen.generate_handle(prompt, max_new, timeout=timeout,
                                     request_id=request_id, **kw)
        out = {"tokens": handle.tokens, "request_id": handle.request_id,
               "finish_reason": handle.finish_reason,
               "timings": handle.timings()}
        if handle.retries:
            out["retries"] = handle.retries  # survived engine crash(es)
        return out

    def _generate_stream(self, handler, payload: dict,
                         timeout_ms: Optional[float], rid: str) -> str:
        """POST /generate with ``"stream": true`` — SSE token emission,
        written directly on ``handler``: one ``data: {"token", "index"}``
        event per decoded token, then the terminal ``data: {"done": true,
        ...}`` event. Submit-time failures (413/503/400) raise before any
        byte is written, so do_POST's error mapping answers them as JSON;
        after the headers, failures are reported in-band. A client
        disconnect (EOF peek between events, or EPIPE) cancels the decode
        — the slot, its blocks and its prefix pin are reclaimed at the
        scheduler's next sweep. Returns "ok" | "disconnect"."""
        gen = self._generation()
        if int(payload.get("n", 1)) != 1:
            raise ValueError("stream=true supports n=1 only (best-of-n "
                             "candidates finish at different times; rank "
                             "buffered candidates instead)")
        prompt, max_new, kw = self._parse_generate(payload)
        timeout = self._timeout_s(timeout_ms)
        stream = TokenStream()
        handle = gen.submit(prompt, max_new, request_id=rid, stream=stream,
                            **kw)
        self._m_stream_reqs.inc()
        status = "ok"
        try:
            handler.send_response(200)
            handler.send_header("Content-Type", "text/event-stream")
            handler.send_header("Cache-Control", "no-cache")
            handler.send_header("X-Request-Id", rid)
            handler.end_headers()
            deadline = time.monotonic() + timeout
            conn = handler.connection
            try:
                for evt in stream.events(deadline=deadline):
                    if _peer_gone(conn):
                        raise BrokenPipeError("SSE client hung up")
                    handler.wfile.write(
                        b"data: " + json.dumps(evt).encode() + b"\n\n")
                    handler.wfile.flush()
            except TimeoutError:
                # the request's own deadline (buffered mode's 504),
                # reported in-band: the headers are out already
                handle.cancel()
                self.metrics.counter("http_errors_total").inc()
                self.tracer.instant("reject", track="http", args={
                    "request_id": rid, "reason": "stream_timeout"})
                handler.wfile.write(
                    b"data: " + json.dumps(
                        {"done": True, "request_id": rid,
                         "error": "deadline exceeded",
                         "finish_reason": "timeout"}).encode() + b"\n\n")
                handler.wfile.flush()
        except OSError:  # BrokenPipeError, ConnectionResetError, ...
            # cancel-on-disconnect: the slot is reclaimed instead of
            # decoding to max_new_tokens for a client that left
            status = "disconnect"
            handle.cancel()
            self._m_stream_disconnects.inc()
            self.tracer.instant("stream_disconnect", req=rid,
                                args={"request_id": rid,
                                      "streamed": stream.sent})
        except Exception as e:  # post-header: report in-band, never a
            handle.cancel()     # second status line into the stream
            try:
                handler.wfile.write(
                    b"data: " + json.dumps(
                        {"done": True, "request_id": rid,
                         "error": str(e)}).encode() + b"\n\n")
                handler.wfile.flush()
            except OSError:
                status = "disconnect"
        finally:
            if self.supervisor is not None:
                # a client that got its stream (or gave up) must not have
                # the request replayed by a later restart
                self.supervisor.untrack(rid)
        return status

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "InferenceServer":
        server = self
        self._shutting_down = False
        failpoints.bind_metrics(self.metrics)
        if self.decode_vocab and self.decoder is None:
            if self.supervise:
                # the supervisor builds, warms (every graph captured
                # before traffic) and starts the engine
                self.supervisor = EngineSupervisor(
                    self._decoder_factory,
                    hang_timeout_s=self.hang_timeout_s,
                    retry_budget=self.retry_budget, slo=self.slo,
                    metrics=self.metrics, tracer=self.tracer)
            else:
                eng = self._decoder_factory()
                eng.warmup()
                self._decoder_direct = eng.start()
        m_http = self.metrics.counter("http_requests_total")
        m_err = self.metrics.counter("http_errors_total")

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):  # quiet
                pass

            def _send(self, obj, code=200, content_type="application/json",
                      request_id=None, headers=None):
                body = (obj if isinstance(obj, bytes)
                        else json.dumps(obj).encode())
                self.send_response(code)
                self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(body)))
                if request_id:
                    self.send_header("X-Request-Id", request_id)
                for name, value in (headers or {}).items():
                    self.send_header(name, value)
                self.end_headers()
                self.wfile.write(body)

            def _metrics(self, q):
                fmt = q.get("format", [""])[0]
                accept = self.headers.get("Accept", "") or ""
                reg = server.metrics
                if fmt == "text":
                    self._send(reg.render_text().encode(),
                               content_type="text/plain; version=0.0.4")
                elif fmt == "prometheus" or (
                        not fmt and "openmetrics" in accept):
                    # the full exposition, exemplars and '# EOF' included
                    self._send(reg.render_prometheus().encode(),
                               content_type="application/openmetrics-text; "
                                            "version=1.0.0; charset=utf-8")
                elif not fmt and "text/plain" in accept:
                    # a 0.0.4 scraper: the same families, no exemplars
                    self._send(reg.render_prometheus(
                        openmetrics=False).encode(),
                        content_type="text/plain; version=0.0.4; "
                                     "charset=utf-8")
                else:
                    self._send(reg.snapshot())

            def _trace(self, q):
                try:
                    limit = int(q.get("limit", ["0"])[0]) or None
                    # presence, not truthiness: ?since=0 is the initial
                    # cursor, distinct from no cursor
                    since = int(q["since"][0]) if "since" in q else None
                except ValueError:
                    return self._send(
                        {"error": "limit/since must be integers"}, 400)
                if q.get("format", [""])[0] == "chrome":
                    self._send(server.tracer.chrome_trace(limit=limit))
                else:
                    self._send(server.tracer.snapshot(limit=limit,
                                                      since=since))

            def do_GET(self):
                m_http.inc()
                url = urlparse(self.path)
                q = parse_qs(url.query)
                path = url.path
                if path == "/health":
                    self._send({"status": "ok",
                                "model": type(server.net).__name__,
                                "params": server.net.num_params()})
                elif path == "/healthz":
                    # liveness only: a recovering engine is still a live
                    # process; /readyz tells the two apart
                    self._send({"status": "up"})
                elif path == "/readyz":
                    ok, body = server.ready()
                    self._send(body, 200 if ok else 503)
                elif path == "/info":
                    self._send(server.info())
                elif path == "/metrics":
                    self._metrics(q)
                elif path == "/trace/clock":
                    self._send({**server.tracer.clock(), "pid": os.getpid()})
                elif path == "/trace":
                    self._trace(q)
                elif path == "/admin/failpoints":
                    if not server.failpoint_endpoint:
                        return self._send(
                            {"error": "failpoint endpoint disabled (start "
                             "the server with failpoint_endpoint=True)"},
                            403)
                    self._send({"armed": failpoints.snapshot(),
                                "seams": list(failpoints.SEAMS)})
                elif path == "/debug/engine":
                    dec = server.decoder
                    if dec is None:
                        return self._send(
                            {"error": "no decode engine (start the server "
                             "with a vocabulary / --generate)"}, 404)
                    body = dec.debug_snapshot()
                    if server.supervisor is not None:
                        body["supervisor"] = server.supervisor.status()
                    body["slo"] = server.slo.snapshot()
                    self._send(body)
                elif path == "/prefix/directory":
                    tier = server._tier()
                    if tier is None:
                        return self._send(
                            {"error": "KV tiering disabled (start with "
                             "--host-cache-mb)"}, 404)
                    try:
                        since = int(q.get("since", ["0"])[0])
                    except ValueError:
                        return self._send(
                            {"error": "since must be an integer"}, 400)
                    self._send(tier.directory_feed(since))
                elif path == "/prefix/block":
                    tier = server._tier()
                    if tier is None:
                        return self._send({"error": "KV tiering disabled"},
                                          404)
                    h = q.get("hash", [""])[0]
                    payload = (tier.get_block_payload(h, timeout=5.0)
                               if h else None)
                    if payload is None:
                        return self._send({"error": "block not available",
                                           "hash": h}, 404)
                    self._send(payload,
                               content_type="application/octet-stream")
                else:
                    self._send({"error": "not found"}, 404)

            def do_POST(self):
                m_http.inc()
                url = urlparse(self.path)
                q = parse_qs(url.query)
                # a well-formed client id is kept as the PREFIX of a
                # server-uniquified id (two live retries sharing one id
                # must not merge onto one trace track); anything else,
                # length-capped before matching, gets a fresh id. A valid
                # X-Graft-Trace header (serving/telemetry.py) WINS the
                # identity: its fleet trace id becomes the prefix, so one
                # request keeps one greppable identity across client ->
                # router -> replica; a malformed one degrades to the
                # X-Request-Id rule, never a 500
                ctx = parse_trace_header(self.headers.get(TRACE_HEADER))
                rid = (ctx.request_id if ctx is not None
                       else (self.headers.get("X-Request-Id") or "")[:256])
                rid = (f"{rid}.{new_request_id()}"
                       if _REQUEST_ID_RE.fullmatch(rid)
                       else new_request_id())
                timeout_ms = None
                if "timeout_ms" in q:
                    try:
                        timeout_ms = float(q["timeout_ms"][0])
                    except ValueError:
                        m_err.inc()
                        return self._send(
                            {"error": "timeout_ms must be a number",
                             "request_id": rid}, 400, request_id=rid)
                n = int(self.headers.get("Content-Length", 0))
                raw = self.rfile.read(n)
                t_route = time.monotonic()
                # the SLO's sample: flipped off by fast rejects, client
                # errors and disconnects
                slo_sample = True
                if server._shutting_down:
                    # stop() raced this POST: a structured 503 instead of
                    # running into half-torn-down components
                    m_err.inc()
                    return self._send({"error": "shutting_down",
                                       "request_id": rid}, 503,
                                      request_id=rid)
                if ctx is not None:
                    # this server's half of the cross-process waterfall:
                    # an `rpc` span on the request track around the
                    # handler (closed in the finally, error paths too),
                    # carrying the flow edge (origin = the sender's span
                    # id) and the gap since the sender's send time
                    server.tracer.begin(
                        "rpc", req=rid,
                        origin=ctx.parent or ctx.request_id,
                        parent=ctx.parent or ctx.request_id,
                        args={"path": url.path, "hop": ctx.hop,
                              "trace": ctx.request_id,
                              "net_gap_ms": round(
                                  (time.time() - ctx.origin_ts) * 1e3,
                                  3)})
                try:
                    if url.path == "/admin/drain":
                        if server.supervisor is None:
                            return self._send(
                                {"error": "draining needs a supervised "
                                 "decode engine", "request_id": rid},
                                400, request_id=rid)
                        server.supervisor.drain_async()
                        return self._send(
                            {"status": "draining", "request_id": rid,
                             **server.supervisor.status()}, 202,
                            request_id=rid)
                    if url.path == "/admin/failpoints":
                        if not server.failpoint_endpoint:
                            return self._send(
                                {"error": "failpoint endpoint disabled",
                                 "request_id": rid}, 403, request_id=rid)
                        payload = json.loads(raw.decode())
                        name = payload["name"]
                        spec = payload.get("spec")
                        if spec:
                            failpoints.arm(name, spec)
                        else:
                            failpoints.disarm(None if name == "*" else name)
                        return self._send(
                            {"armed": failpoints.snapshot(),
                             "request_id": rid}, request_id=rid)
                    # the seam comes AFTER the /admin/* branches: an armed
                    # http.handler must not block its own disarm path
                    failpoints.fire("http.handler")
                    if url.path == "/predict/csv":
                        rows = [line.split(",") for line in
                                raw.decode().strip().splitlines()
                                if line.strip()]
                        ds = server.converter.convert(rows)
                        self._send(server._predict(np.asarray(ds.features),
                                                   timeout_ms),
                                   request_id=rid)
                    elif url.path == "/predict":
                        payload = json.loads(raw.decode())
                        arr = np.asarray(payload["data"], np.float32)
                        self._send(server._predict(arr, timeout_ms),
                                   request_id=rid)
                    elif url.path == "/generate":
                        payload = json.loads(raw.decode())
                        if isinstance(payload, dict) and payload.get("stream"):
                            # writes the response itself; submit-time
                            # errors raise before any byte is written
                            if server._generate_stream(
                                    self, payload, timeout_ms,
                                    rid) == "disconnect":
                                slo_sample = False  # the client ended it
                        else:
                            self._send(server._generate(
                                payload, timeout_ms, request_id=rid),
                                request_id=rid)
                    elif url.path == "/prefix/fetch":
                        payload = json.loads(raw.decode())
                        code, body = server._prefix_fetch(payload)
                        body["request_id"] = rid
                        self._send(body, code, request_id=rid)
                    else:
                        self._send({"error": "not found",
                                    "request_id": rid}, 404, request_id=rid)
                except PromptTooLongError as e:
                    # refused before queueing: the payload itself is the
                    # problem (paged: the body carries the pool's math)
                    body = {"error": f"prompt too long: {e}",
                            "request_id": rid}
                    if e.blocks_needed is not None:
                        body["blocks_needed"] = e.blocks_needed
                        body["blocks_available"] = e.blocks_available
                    m_err.inc()
                    slo_sample = False  # a client error, ~1 ms
                    self._send(body, 413, request_id=rid)
                except TimeoutError as e:  # RequestTimeoutError too; a
                    # timed-out decode was cancelled before this
                    m_err.inc()
                    server.tracer.instant("reject", track="http", args={
                        "request_id": rid, "reason": "timeout_504"})
                    self._send({"error": f"deadline exceeded: {e}",
                                "request_id": rid}, 504, request_id=rid)
                except RetryBudgetExceededError as e:
                    # every attempt saw the engine die: a structured 503
                    # naming the request, never silence
                    m_err.inc()
                    server.tracer.instant("reject", track="http", args={
                        "request_id": rid,
                        "reason": "retry_budget_exhausted"})
                    self._send({"error": "retry_budget_exhausted",
                                "detail": str(e), "request_id": rid},
                               503, request_id=rid)
                except ShuttingDownError:
                    m_err.inc()
                    slo_sample = False
                    self._send({"error": "shutting_down",
                                "request_id": rid}, 503, request_id=rid)
                except AdmissionRejectedError as e:
                    # ladder level 3 or a drain: Retry-After tells a client
                    # how long to back off
                    m_err.inc()
                    slo_sample = False
                    server.tracer.instant("reject", track="http", args={
                        "request_id": rid, "reason": "degraded_503"})
                    self._send(
                        {"error": "not_admitting", "detail": str(e),
                         "retry_after_s": e.retry_after_s,
                         "request_id": rid}, 503, request_id=rid,
                        headers={"Retry-After":
                                 str(max(1, int(e.retry_after_s)))})
                except QueueFullError as e:  # LoadSheddedError too
                    m_err.inc()
                    slo_sample = False
                    server.tracer.instant("reject", track="http", args={
                        "request_id": rid, "reason": "backpressure_503"})
                    self._send({"error": f"over capacity: {e}",
                                "request_id": rid}, 503, request_id=rid)
                except InjectedFault as e:
                    # a chaos seam fired: a retryable server fault
                    m_err.inc()
                    self._send({"error": "injected_fault",
                                "seam": e.seam, "request_id": rid}, 500,
                               request_id=rid)
                except EngineCrashedError as e:
                    # an unsupervised engine died with this request
                    m_err.inc()
                    self._send({"error": "engine_crashed", "detail": str(e),
                                "request_id": rid}, 500, request_id=rid)
                except Exception as e:  # bad payloads must not kill the server
                    m_err.inc()
                    slo_sample = False  # client errors would dilute the burn
                    self._send({"error": str(e), "request_id": rid}, 400,
                               request_id=rid)
                finally:
                    if ctx is not None:
                        server.tracer.end("rpc", req=rid)
                    if slo_sample and url.path in ("/predict",
                                                   "/predict/csv",
                                                   "/generate"):
                        # served requests' end-to-end latency, timeouts
                        # included (a 504 burned the budget)
                        server.slo.observe(url.path,
                                           time.monotonic() - t_route,
                                           request_id=rid)

        self._httpd = _HTTPServer((self._host, self._port), Handler)
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True, name="http-server")
        self._thread.start()
        return self

    def stop(self) -> None:
        # flag FIRST: handler threads past accept answer a structured 503
        # instead of racing the teardown below
        self._shutting_down = True
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None
        if self.supervisor is not None:
            # fails every tracked in-flight request fast with
            # ShuttingDownError: the blocked handlers answer 503
            self.supervisor.stop()
        if self._decoder_direct is not None:
            self._decoder_direct.stop()
        with self._batchers_lock:
            batchers = list(self._batchers.values())
            self._batchers.clear()
        for b in batchers:
            b.stop()
