"""Fleet front end: a crash-surviving multi-replica router with a durable
request journal — a port of deeplearning4j_tpu/serving/router.py.

The supervisor of `inference/supervisor.py` recovers an engine within one
process. This tier routes traffic ACROSS replica processes
(`serving/replica.py`) and survives what one process cannot: a replica
host dying mid-decode, or the router itself SIGKILLed mid-flight. The
router runs on the host only; each replica is a port `InferenceServer`
whose decode steps launch the paged decode kernel on its card.

**Prefix-affine routing.** Naive balancing dilutes the prefix cache by N:
a repeated system prompt lands on a different replica each time and every
replica pays its own cold prefill. The router hashes the first
``kv_block``-aligned prompt tokens (:func:`affinity_key`: the unit the
prefix trie indexes by, so equal keys mean equal cacheable blocks) and
rendezvous-hashes that key over the READY replicas (:func:`pick_replica`:
minimal reshuffle when a replica dies or rejoins). Both functions are the
JAX package's, bit for bit: the same key and names pick the same replica
in either package. With ``prefix_directory`` the router also tails each
replica's ``/prefix/directory`` feed and routes a prompt to the replica
holding its deepest block chain in any KV tier (``prefix_fetch``: keep the
rendezvous target and have it pull the chain from the holder's
``/prefix/block`` first).

**SLO-aware admission.** The router scrapes its replicas' Prometheus
expositions through `telemetry.FleetMetrics` and applies
`inference.profiler.burn_verdict` to the federated burn rates: the same
thresholds each replica's degradation ladder uses. While the fleet burns,
new work is rejected up front with a 503 + ``Retry-After``. A replica's
own 503 (draining, degraded, budget exhausted) reaches the client
UNCHANGED, ``Retry-After`` included.

**The durable request journal.** Every accepted ``/generate`` is appended
to a `durable.DurableLogProducer` log (CRC-framed, fsynced,
torn-tail-truncating) BEFORE dispatch, and gets a terminal record
(finish/fail) once the client's answer is known. A router SIGKILLed
mid-flight replays exactly the accepted-but-unterminated requests on
restart (`RequestJournal.recover`), deduplicated by request id:
at-least-once execution with exactly-once terminal records, and
token-identical because replicas are deterministic (seeded params, greedy
or seeded sampling). The consumer cursor advances per record
(`DurableLogConsumer.commit_through`). The journal is the JAX package's
format: a journal either package writes, the other recovers. The chaos
seams ``router.journal`` (before the append) and ``router.dispatch``
(after it, before the forward) let a test SIGKILL a router process at an
exact point.

Endpoints (`FleetRouter.start`):
  GET  /healthz          router process liveness (always 200)
  GET  /readyz           fleet readiness: 200 while >= quorum replicas
                         ready and not shutting down; the body carries
                         the per-replica probe verdicts + journal stats
  GET  /metrics          the router's own registry (?format=prometheus
                         / text, same negotiation as a replica)
  GET  /fleet            federated fleet exposition (FleetMetrics)
  GET  /fleet/summary    federated JSON summary (per-replica burn)
  GET  /router/journal   journal counters + cursor state
  GET  /trace[?...]      the router's flight-recorder ring (the fleet
                         aggregator tails it like any replica's)
  GET  /trace/clock      clock-alignment handshake
  POST /generate         journaled, affinity-routed decode (SSE
                         pass-through with {"stream": true})
  POST /predict          round-robin stateless prediction
  POST /admin/drain      rolling draining restart across replicas (202)

``python -m deeplearning4j_tpu_torch.serving.router`` runs the router as
its own OS process: attach to running replicas with ``--replicas
URL,URL`` or spawn them with ``--spawn N`` (on ``--device``, cuda by
default).
"""
from __future__ import annotations

import json
import os
import re
import signal
import sys
import threading
import time
import urllib.error
import urllib.request
import zlib
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Sequence, Tuple
from urllib.parse import parse_qs, urlparse

from ..analysis.runtime import (ledger_check_request, ledger_forget,
                                ledger_note)
from ..inference import failpoints
from ..inference.metrics import MetricsRegistry
from ..inference.profiler import SLOMonitor, burn_verdict
from ..inference.trace import FlightRecorder
from .durable import DurableLogConsumer, DurableLogProducer
from .replica import (ReplicaProcess, ReplicaSupervisor, _argv_device,
                      _get_json, write_announce)
from .telemetry import (TRACE_HEADER, FleetMetrics, TraceContext,
                        format_trace_header, new_trace_id,
                        parse_trace_header, span_id)

__all__ = ["FleetRouter", "RequestJournal", "ReplicaEndpoint",
           "affinity_key", "pick_replica", "NoReplicaError", "main"]

_REQUEST_ID_RE = re.compile(r"[A-Za-z0-9._:\-]{1,128}")

# the resource kind the router's ledger seams own: journal records only —
# engine kinds for the same request id belong to the replica's
# DecodeScheduler, never judged here
_JOURNAL_KINDS = frozenset(("journal_record",))


class _RouterHTTPServer(ThreadingHTTPServer):
    # the listen backlog: the stdlib's 5 resets or delays (by a SYN
    # retransmit, 1 s) a burst of clients arriving at once past it, as
    # the serving server's does
    request_queue_size = 128
    daemon_threads = True


class NoReplicaError(RuntimeError):
    """Every dispatch attempt failed (no ready replica, or all tried
    replicas errored): the router's 502 — retryable, nothing lost (a
    journaled request stays pending for replay)."""


# ---------------------------------------------------------------------------
# prefix-affine routing
# ---------------------------------------------------------------------------

def affinity_key(prompt: Sequence[int], kv_block: int,
                 affinity_blocks: int = 1) -> bytes:
    """The routing key: the first ``affinity_blocks`` complete
    ``kv_block``-aligned blocks of the prompt (the unit the prefix
    trie indexes by — equal keys mean equal cacheable leading blocks).
    A prompt shorter than one block keys on its full token run:
    distinct short prompts still spread across the fleet instead of
    all hashing to the empty prefix."""
    n = (len(prompt) // kv_block) * kv_block
    n = min(n, max(1, affinity_blocks) * kv_block)
    head = prompt[:n] if n else prompt
    return (",".join(str(int(t)) for t in head)).encode()


def pick_replica(key: bytes,
                 candidates: Sequence[Tuple[str, str]]) -> Tuple[str, str]:
    """Rendezvous (highest-random-weight) hash of ``key`` over
    ``(name, url)`` candidates: deterministic, and when a replica
    leaves/rejoins only ITS keys move — the other replicas' warm
    prefix caches stay warm (a modulo hash would reshuffle nearly
    every key on any membership change)."""
    if not candidates:
        raise NoReplicaError("no ready replicas")
    return max(candidates,
               key=lambda c: (zlib.crc32(key + b"|" + c[0].encode()),
                              c[0]))


# ---------------------------------------------------------------------------
# the durable request journal
# ---------------------------------------------------------------------------

class RequestJournal:
    """At-least-once request ledger over `durable.py`'s CRC-framed log.

    Record grammar (JSON rows): ``{"t": "accept", "rid", "req", "path"}``
    appended (fsynced) BEFORE dispatch; ``{"t": "finish", "rid",
    "tokens", "replica", "replay"}`` or ``{"t": "fail", "rid", "error",
    "status"}`` appended once the client's answer is known. An ``accept``
    with no terminal record is exactly an in-flight request the crashed
    router owes the fleet: :meth:`recover` returns them in order and
    :meth:`finish` deduplicates by request id, so replay after a SIGKILL
    is at-least-once execution with exactly-once terminal records.

    The group cursor advances per-record (`commit_through`): a record is
    committable once it is itself terminal, or is an accept whose
    terminal record has been READ — so a restart re-reads only the
    unfinished tail, not every batch that happened to share a poll."""

    def __init__(self, path: str, group: str = "router",
                 fsync_every: int = 1):
        self.path = path
        self._lock = threading.Lock()
        # producer FIRST: it truncates a torn tail before the consumer
        # maps offsets (and enforces single-writer — a second live
        # router on one journal would corrupt the replay contract)
        self._producer = DurableLogProducer(path, fsync_every=fsync_every)
        self._consumer = DurableLogConsumer(path, group=group)
        self._terminal: set = set()
        self._window: List[Tuple[str, str]] = []  # delivered (type, rid)
        self._closed = False
        self.accepted_total = 0
        self.finished_total = 0
        self.failed_total = 0
        self.duplicate_finishes_suppressed = 0

    def recover(self) -> List[dict]:
        """Read everything past the committed cursor; returns the
        accept records with no terminal record — the crashed
        incarnation's in-flight requests, in acceptance order."""
        with self._lock:
            accepts: Dict[str, dict] = {}
            while True:
                recs = self._consumer.poll(256)
                if not recs:
                    break
                for rec in recs:
                    self._ingest(rec, accepts)
            recovered = [accepts[rid] for rid in accepts
                         if rid not in self._terminal]
            for rec in recovered:
                # this incarnation inherits the open obligation: clear
                # any stale balance a crashed same-process predecessor
                # left (its accept was its own debt), then re-open it —
                # the replay's terminal record settles it
                ledger_forget(rec["rid"], _JOURNAL_KINDS)
                ledger_note("journal_record", rec["rid"], +1)
            return recovered

    def _ingest(self, rec: dict, accepts: Optional[dict] = None) -> None:
        # caller holds self._lock
        t, rid = rec.get("t"), rec.get("rid")
        if not rid:
            return
        if t == "accept":
            if accepts is not None:
                accepts[rid] = rec
        else:  # finish / fail
            self._terminal.add(rid)
        self._window.append((t, rid))

    def accept(self, rid: str, req: dict, path: str = "/generate") -> None:
        with self._lock:
            if self._closed:  # handler racing stop(): the 503 fast
                return  # path answers the client, nothing to journal
            self._producer.send({"t": "accept", "rid": rid, "req": req,
                                 "path": path, "ts": time.time()})
            self.accepted_total += 1
            ledger_note("journal_record", rid, +1)

    def _terminate(self, rid: str, rec: dict) -> bool:
        with self._lock:
            if self._closed:
                # a replay dispatch outliving stop()'s bounded join: the
                # record stays UNTERMINATED and the next incarnation
                # replays it — at-least-once holds, and nothing writes
                # to a closed producer
                return False
            if rid in self._terminal:
                self.duplicate_finishes_suppressed += 1
                return False
            self._producer.send(rec)
            self._terminal.add(rid)
            ledger_note("journal_record", rid, -1)
            return True

    def finish(self, rid: str, tokens=None, replica: Optional[str] = None,
               replay: bool = False) -> bool:
        """Terminal success. Returns False (and appends NOTHING) when
        ``rid`` already has a terminal record — the zero-double-finish
        dedup for a replay racing a live dispatch."""
        ok = self._terminate(rid, {"t": "finish", "rid": rid,
                                   "tokens": tokens, "replica": replica,
                                   "replay": bool(replay)})
        if ok:
            with self._lock:
                self.finished_total += 1
        return ok

    def fail(self, rid: str, error: str, status: int = 0) -> bool:
        """Terminal failure — the client SAW this error (propagated
        503/4xx, exhausted dispatch attempts), so a restart must not
        resurrect the request the client already gave up on."""
        ok = self._terminate(rid, {"t": "fail", "rid": rid,
                                   "error": str(error)[:512],
                                   "status": int(status)})
        if ok:
            with self._lock:
                self.failed_total += 1
        return ok

    def advance(self) -> int:
        """Poll newly appended records and durably commit the longest
        prefix of delivered records that needs no replay (terminal
        records, and accepts whose terminal record has been read).
        Called periodically from the router's scrape loop; returns how
        many records were committed."""
        with self._lock:
            while True:
                recs = self._consumer.poll(256)
                if not recs:
                    break
                for rec in recs:
                    self._ingest(rec)
            n = 0
            pruned = []
            for t, rid in self._window:
                if t == "accept":
                    if rid not in self._terminal:
                        break
                    pruned.append(rid)
                n += 1
            if n:
                self._consumer.commit_through(n)
                del self._window[:n]
                # bound the dedup set: a rid whose ACCEPT is durably
                # committed can never be replayed, so it needs no
                # terminal marker any more (without this the set grows
                # one entry per request for the life of the router)
                self._terminal.difference_update(pruned)
            return n

    def stats(self) -> dict:
        with self._lock:
            return {
                "path": self.path,
                "accepted_total": self.accepted_total,
                "finished_total": self.finished_total,
                "failed_total": self.failed_total,
                "duplicate_finishes_suppressed":
                    self.duplicate_finishes_suppressed,
                "uncommitted_records": len(self._window),
                "committed_offset": self._consumer.offset,
            }

    def close(self) -> None:
        with self._lock:
            if not self._closed:
                self._closed = True
                self._producer.close()


# ---------------------------------------------------------------------------
# attach-mode replica (no process handle)
# ---------------------------------------------------------------------------

class ReplicaEndpoint:
    """An already-running replica known only by URL: probed like a
    :class:`ReplicaProcess` but not restartable (its host owns its
    lifecycle — the supervisor can only report it down)."""

    restartable = False

    def __init__(self, url: str, name: str):
        self._url = url.rstrip("/")
        self.name = name
        self.generation = 0
        self.proc = None
        # the port is known from the URL up front (scheme default when
        # implicit): the supervisor's probe loop treats a port-less
        # replica as still booting, which an endpoint never is
        from urllib.parse import urlsplit
        split = urlsplit(self._url if "://" in self._url
                         else f"http://{self._url}")
        self.port = split.port or (443 if split.scheme == "https" else 80)

    @property
    def base_url(self) -> str:
        return self._url

    def alive(self) -> bool:
        return True  # liveness is only probeable over HTTP

    def spawn(self):
        return self

    def await_ready(self, timeout: float = 120.0) -> str:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            try:
                code, _ = _get_json(self._url + "/readyz", timeout=5)
                if code == 200:
                    return self._url
            except (OSError, ValueError):
                pass
            time.sleep(0.05)
        raise TimeoutError(f"replica {self.name} at {self._url} "
                           "never became ready")

    def kill(self) -> None:
        pass

    def terminate(self, timeout: float = 30.0, wait: bool = True) -> None:
        pass


# ---------------------------------------------------------------------------
# the router
# ---------------------------------------------------------------------------

class FleetRouter:
    """HTTP front-end over a :class:`ReplicaSupervisor` — see the
    module docstring for the routing/admission/journal semantics."""

    def __init__(self, supervisor: Optional[ReplicaSupervisor] = None,
                 replica_urls: Optional[Sequence[str]] = None,
                 journal_path: Optional[str] = None,
                 port: int = 0, kv_block: int = 16,
                 affinity_blocks: int = 1, quorum: int = 1,
                 dispatch_timeout_s: float = 120.0,
                 dispatch_attempts: int = 4,
                 scrape_interval_s: float = 0.5,
                 admission_burn: bool = True,
                 fast_burn: float = 6.0, slow_burn: float = 3.0,
                 retry_after_s: float = 1.0,
                 replay_timeout_s: float = 120.0,
                 startup_wait_s: float = 300.0,
                 metrics: Optional[MetricsRegistry] = None,
                 tracer: Optional[FlightRecorder] = None,
                 trace_buffer: int = 8192,
                 prefix_directory: bool = True,
                 prefix_fetch: bool = False,
                 directory_max_blocks: int = 64):
        if supervisor is None:
            if not replica_urls:
                raise ValueError("pass a ReplicaSupervisor or replica_urls")
            supervisor = ReplicaSupervisor(
                [ReplicaEndpoint(u, f"r{i}")
                 for i, u in enumerate(replica_urls)])
        self.supervisor = supervisor
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        if supervisor._metrics is None:
            # the supervisor predates the router's registry: adopt it so
            # fleet_replicas_up / restart counters land in GET /metrics
            supervisor._metrics = self.metrics
            supervisor._g_up = self.metrics.gauge(
                "fleet_replicas_up",
                help="replicas currently answering /readyz 200")
            supervisor._c_restarts = self.metrics.counter(
                "fleet_replica_restarts_total",
                help="replica subprocesses respawned by the fleet "
                     "supervisor")
        self.tracer = tracer if tracer is not None else FlightRecorder(
            trace_buffer, enabled=trace_buffer > 0)
        self.journal = (RequestJournal(journal_path)
                        if journal_path else None)
        self.kv_block = int(kv_block)
        self.affinity_blocks = int(affinity_blocks)
        self.quorum = max(1, int(quorum))
        self.dispatch_timeout_s = float(dispatch_timeout_s)
        self.dispatch_attempts = int(dispatch_attempts)
        self.scrape_interval_s = float(scrape_interval_s)
        self.admission_burn = bool(admission_burn)
        self.fast_burn = float(fast_burn)
        self.slow_burn = float(slow_burn)
        self.retry_after_s = float(retry_after_s)
        self.replay_timeout_s = float(replay_timeout_s)
        self.startup_wait_s = float(startup_wait_s)
        # router-side route percentiles (no objective: the BURN signal
        # is federated from the replicas, which measure engine time —
        # the router only adds its own p50/p95/p99 observability)
        self.slo = SLOMonitor(objective_p99_s=None, metrics=self.metrics)
        self._lock = threading.Lock()
        # admission verdict, REBOUND whole by the scrape thread each
        # pass; handlers snapshot the ref under the lock
        self._admission: dict = {"burning": False, "fast": 0.0,
                                 "slow": 0.0, "replicas_up": 0}
        self._fleet: Optional[FleetMetrics] = None
        self._fleet_urls: Tuple[str, ...] = ()
        self._rr = 0  # /predict round-robin cursor
        self._draining = False
        self._shutting_down = False
        self._scrape_error: Optional[str] = None
        self._recovered: List[dict] = (self.journal.recover()
                                       if self.journal else [])
        self.replayed_total = 0
        self.replay_abandoned_total = 0
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self._scrape_thread: Optional[threading.Thread] = None
        self._replay_thread: Optional[threading.Thread] = None
        self._stop_scrape = threading.Event()
        self._stop_replay = threading.Event()
        self._port = port
        m = self.metrics
        self._m_req = m.counter("router_requests_total",
                                help="requests entering the router")
        self._m_err = m.counter("router_errors_total")
        self._m_retries = m.counter(
            "router_dispatch_retries_total",
            help="dispatch attempts beyond the first (replica died or "
                 "errored mid-request)")
        self._m_rejected = m.counter(
            "router_admission_rejected_total",
            help="requests 503d by SLO-aware admission (fleet burning)")
        self._m_propagated = m.counter(
            "router_replica_503_propagated_total",
            help="replica 503s passed through unchanged "
                 "(Retry-After preserved)")
        self._m_replayed = m.counter(
            "router_journal_replayed_total",
            help="journaled in-flight requests re-executed after a "
                 "router restart")
        self._m_stream_reqs = m.counter(
            "router_stream_requests_total",
            help="/generate stream=true requests proxied as SSE "
                 "pass-through")
        # fleet prefix directory: block-hash chains -> the
        # replicas holding them (any tier), fed by tailing each
        # replica's /prefix/directory on the scrape cadence
        self.prefix_directory = bool(prefix_directory)
        self.prefix_fetch = bool(prefix_fetch)
        self.directory_max_blocks = int(directory_max_blocks)
        self._dir_entries: Dict[str, Dict[str, str]] = {}  # hash -> {name: tier}
        self._dir_state: Dict[str, dict] = {}  # name -> {epoch, next, skip_until}
        self._g_dir_entries = m.gauge(
            "router_directory_entries",
            help="distinct block hashes the router can route to "
                 "(union over replicas and tiers)")
        self._m_dir_hits = m.counter(
            "router_directory_hits_total",
            help="dispatches routed to a replica BECAUSE the prefix "
                 "directory says it holds the deepest prompt chain")
        self._m_prefix_fetches = m.counter(
            "router_prefix_fetches_total",
            help="peer-pull instructions (/prefix/fetch) issued to the "
                 "affinity target before admission")
        self._m_stream_disconnects = m.counter(
            "router_stream_disconnects_total",
            help="SSE clients that hung up mid-stream at the router "
                 "(upstream replica connection torn down -> its "
                 "cancel-on-disconnect reclaims the slot). Namespaced "
                 "router_*: the replica the hangup cascades to counts "
                 "its own stream_disconnects_total — one client hangup "
                 "is one tick at EACH tier, never summed")

    @property
    def port(self) -> int:
        return self._httpd.server_address[1] if self._httpd else self._port

    # -- scrape / admission loop -------------------------------------------
    def _scrape_pass(self) -> None:
        ready = self.supervisor.ready_replicas()
        urls = tuple(u for _n, u in ready)
        with self._lock:
            fleet = self._fleet
            if urls != self._fleet_urls:
                # membership changed (restart -> new ephemeral port):
                # rebuild the federation over the live set
                fleet = FleetMetrics(list(urls),
                                     names=[n for n, _u in ready],
                                     fast_burn=self.fast_burn,
                                     slow_burn=self.slow_burn) \
                    if urls else None
                self._fleet = fleet
                self._fleet_urls = urls
        verdict = {"burning": False, "fast": 0.0, "slow": 0.0,
                   "replicas_up": len(urls)}
        if fleet is not None:
            fleet.scrape()  # network OUTSIDE the lock
            fed = fleet.federate()
            burning, _calm = burn_verdict(fed["burn_rate_fast"],
                                          fed["burn_rate_slow"],
                                          self.fast_burn, self.slow_burn)
            verdict = {"burning": burning,
                       "fast": fed["burn_rate_fast"],
                       "slow": fed["burn_rate_slow"],
                       "replicas_up": fed["replicas_up"]}
        with self._lock:
            self._admission = verdict
        if self.prefix_directory:
            self._poll_directory(ready)  # network OUTSIDE the lock
        if self.journal is not None:
            self.journal.advance()

    # -- fleet prefix directory ---------------------------------------------
    def _poll_directory(self, ready) -> None:
        """Tail every ready replica's ``/prefix/directory`` feed. A 404
        means that replica runs without tiering — back off polling it
        for a while instead of knocking every scrape pass."""
        now = time.monotonic()
        for name, url in ready:
            with self._lock:
                st = self._dir_state.setdefault(
                    name, {"epoch": None, "next": 0, "skip_until": 0.0})
                if now < st["skip_until"]:
                    continue
                since = st["next"] if st["epoch"] is not None else 0
            try:
                with urllib.request.urlopen(
                        f"{url}/prefix/directory?since={since}",
                        timeout=2.0) as resp:
                    feed = json.loads(resp.read().decode())
            except urllib.error.HTTPError as e:
                e.close()
                if e.code == 404:
                    with self._lock:
                        st["skip_until"] = now + 10.0
                continue
            except (urllib.error.URLError, OSError, ValueError):
                continue  # flaky scrape: next pass retries
            self._directory_ingest(name, feed)

    def _directory_ingest(self, name: str, feed: dict) -> None:
        with self._lock:
            st = self._dir_state.setdefault(
                name, {"epoch": None, "next": 0, "skip_until": 0.0})
            st["skip_until"] = 0.0
            if feed.get("reset") or feed.get("epoch") != st["epoch"]:
                # replica restarted (new epoch) or our cursor fell off
                # its ring: drop everything it published and resync
                # from the snapshot
                for h in [h for h, holders in self._dir_entries.items()
                          if name in holders]:
                    holders = self._dir_entries[h]
                    holders.pop(name, None)
                    if not holders:
                        del self._dir_entries[h]
                st["epoch"] = feed.get("epoch")
            for ev in feed.get("events") or []:
                h = ev.get("hash")
                if not h:
                    continue
                if ev.get("op") == "put":
                    self._dir_entries.setdefault(h, {})[name] = \
                        ev.get("tier", "host")
                else:
                    holders = self._dir_entries.get(h)
                    if holders is not None:
                        holders.pop(name, None)
                        if not holders:
                            del self._dir_entries[h]
            nxt = feed.get("next", 0)  # parsed-JSON host scalar
            st["next"] = int(nxt)
            self._g_dir_entries.set(len(self._dir_entries))

    def _directory_chain(self, prompt: Sequence[int]) -> List[str]:
        if not prompt:
            return []
        from ..inference.kvtier import prompt_chain
        return prompt_chain(prompt, self.kv_block,
                            self.directory_max_blocks)

    def _directory_pick(self, prompt: Sequence[int],
                        tried: set) -> Optional[Tuple[str, str, int,
                                                      List[str]]]:
        """(name, url, depth_blocks, chain_hashes) for the untried
        ready replica holding the DEEPEST block-hash chain of this
        prompt in any tier, or None when the directory has nothing.
        Ties at a depth prefer warmer tiers (hbm > host > disk)."""
        chain = self._directory_chain(prompt)
        if not chain:
            return None
        ready = dict(self.supervisor.ready_replicas())
        rank = {"hbm": 0, "spilling": 0, "host": 1, "disk": 2}
        with self._lock:
            for i in range(len(chain) - 1, -1, -1):
                holders = self._dir_entries.get(chain[i])
                if not holders:
                    continue
                best = None
                for nm, tier in holders.items():
                    if nm in tried or nm not in ready:
                        continue
                    r = rank.get(tier, 3)
                    if best is None or r < best[0]:
                        best = (r, nm)
                if best is not None:
                    nm = best[1]
                    return nm, ready[nm], i + 1, chain[:i + 1]
        return None

    def _prefix_warm(self, target_url: str, holder_url: str,
                     hashes: List[str]) -> None:
        """Instruct the affinity target to pull the chain from the
        holder before the request lands (prefix-fetch mode). Best
        effort: a failed warm just means a cold prefill."""
        body = json.dumps({"peer": holder_url,
                           "hashes": hashes}).encode()
        try:
            req = urllib.request.Request(
                target_url + "/prefix/fetch", data=body,
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=5.0) as resp:
                resp.read()
            self._m_prefix_fetches.inc()
        except (urllib.error.URLError, OSError, ValueError):
            pass

    def _pick_with_directory(self, attempt: int, key: bytes,
                             prompt: Sequence[int], tried: set,
                             deadline: float) -> Optional[Tuple[str, str]]:
        """Candidate selection with prefix-directory awareness: on the
        FIRST attempt, a directory hit either routes straight to the
        holder (default) or keeps the rendezvous choice and warms it
        from the holder (``prefix_fetch``). Failover attempts fall back
        to plain rendezvous ranking — correctness never depends on the
        directory being fresh."""
        if attempt == 0 and self.prefix_directory:
            hint = self._directory_pick(prompt, tried)
            if hint is not None:
                name, url, _depth, hashes = hint
                if not self.prefix_fetch:
                    self._m_dir_hits.inc()
                    return name, url
                cand = self._next_candidate(key, tried, deadline)
                if cand is None or cand[0] == name:
                    self._m_dir_hits.inc()
                    return (name, url) if cand is None else cand
                self._prefix_warm(cand[1], url, hashes)
                return cand
        return self._next_candidate(key, tried, deadline)

    def _scrape_loop(self) -> None:
        while not self._stop_scrape.wait(self.scrape_interval_s):
            try:
                self._scrape_pass()
            except Exception as e:  # a flaky scrape must not kill the
                # admission loop; the last error is surfaced on /readyz
                with self._lock:
                    self._scrape_error = repr(e)

    def admission_verdict(self) -> dict:
        with self._lock:
            return self._admission

    # -- dispatch ----------------------------------------------------------
    def _next_candidate(self, key: bytes, tried: set,
                        deadline: float) -> Optional[Tuple[str, str]]:
        """The next untried (name, url) by rendezvous rank over the
        READY replicas, with one probe-lag grace poll when none are
        visible yet (probes may trail a restart by a cycle). The ONE
        candidate-selection policy shared by buffered dispatch, journal
        replay, and the SSE stream pump — so the failover loops cannot
        drift apart. None = nobody left to try."""
        cands = [c for c in self.supervisor.ready_replicas()
                 if c[0] not in tried]
        if not cands and time.monotonic() < deadline:
            time.sleep(0.05)
            cands = [c for c in self.supervisor.ready_replicas()
                     if c[0] not in tried]
        if not cands:
            return None
        return pick_replica(key, cands)

    def _forward(self, url: str, path: str, body: bytes,
                 headers: Dict[str, str], timeout: float) -> dict:
        req = urllib.request.Request(
            url + path, data=body,
            headers={"Content-Type": "application/json", **headers})
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return json.loads(resp.read().decode())

    @staticmethod
    def _raise_for_status(name: str, e: urllib.error.HTTPError) -> None:
        """THE replica-error classification ladder, shared by buffered
        dispatch and the SSE stream pump (two inline copies would
        silently drift): 503 → :class:`_Replica503` (propagate
        unchanged, Retry-After preserved), 504 → :class:`_DispatchTimeout`
        (terminal — the request's budget is spent), other 4xx →
        :class:`_ReplicaClientError` (terminal — the payload is the
        problem), 5xx → plain return (the replica is sick; the caller
        fails over). Drains and closes ``e`` either way."""
        hdrs = dict(e.headers.items()) if e.headers else {}
        detail = e.read()
        e.close()
        if e.code == 503:
            raise _Replica503(name, detail, hdrs)
        if e.code == 504:
            raise _DispatchTimeout(name, detail)
        if e.code < 500:
            raise _ReplicaClientError(name, e.code, detail)

    def _dispatch(self, rid: str, payload: dict, path: str = "/generate",
                  ctx: Optional[TraceContext] = None,
                  deadline_s: Optional[float] = None) -> Tuple[str, int, dict]:
        """Affinity-routed forward with failover: tries up to
        ``dispatch_attempts`` DISTINCT replicas (preferring the affinity
        choice, then the next-highest rendezvous weights), retrying
        connection errors and 5xx. A replica's 503 short-circuits out
        unchanged (:class:`_Replica503`); 4xx raises
        :class:`_ReplicaClientError` (the payload is the problem — no
        other replica will like it better). Returns
        (replica_name, attempts_used, parsed_response)."""
        body = json.dumps(payload).encode()
        key = affinity_key(payload.get("prompt") or [], self.kv_block,
                           self.affinity_blocks)
        egress = (ctx.child() if ctx is not None else
                  TraceContext(rid, span_id(rid, 0), 0, time.time()))
        headers = {TRACE_HEADER: format_trace_header(egress),
                   "X-Request-Id": rid}
        deadline = (time.monotonic() + self.dispatch_timeout_s
                    if deadline_s is None else deadline_s)
        tried: set = set()
        last_err: Optional[BaseException] = None
        for attempt in range(self.dispatch_attempts):
            cand = self._pick_with_directory(
                attempt, key, payload.get("prompt") or [], tried,
                deadline)
            if cand is None:
                break
            name, url = cand
            tried.add(name)
            if attempt:
                self._m_retries.inc()
            self.tracer.instant("route", req=rid, args={
                "request_id": rid, "replica": name, "attempt": attempt})
            try:
                timeout = max(0.05, deadline - time.monotonic())
                return name, attempt + 1, self._forward(
                    url, path, body, headers, timeout)
            except urllib.error.HTTPError as e:
                self._raise_for_status(name, e)
                last_err = e  # 5xx: the replica is sick, fail over
            except (urllib.error.URLError, OSError, TimeoutError) as e:
                if time.monotonic() >= deadline:
                    # the DEADLINE expired, not the replica: terminal
                    # 504 — retrying elsewhere would burn every
                    # replica's slots decoding into a dead socket
                    raise _DispatchTimeout(name, None) from e
                last_err = e  # connection refused/reset: replica died
        raise NoReplicaError(
            f"dispatch failed after trying {sorted(tried) or 'no'} "
            f"replica(s): {last_err!r}")

    # -- journal replay -----------------------------------------------------
    def _replay(self) -> None:
        deadline = time.monotonic() + self.replay_timeout_s
        for rec in self._recovered:
            if self._stop_replay.is_set():
                # router stopping mid-replay: the remaining records
                # stay UNTERMINATED in the journal — the next
                # incarnation recovers them (at-least-once holds)
                return
            rid, req = rec["rid"], rec.get("req") or {}
            if req.get("stream"):
                # a replayed stream has no client to stream to: re-run
                # it BUFFERED so the terminal record (and the replica's
                # prefix-cache publish) still lands — at-least-once is
                # about effects, not transport
                req = {k: v for k, v in req.items() if k != "stream"}
            self.tracer.instant("journal_replay", req=rid,
                                args={"request_id": rid})
            while not self._stop_replay.is_set():
                try:
                    name, _attempts, resp = self._dispatch(
                        rid, req, rec.get("path") or "/generate",
                        deadline_s=deadline)
                    if self.journal.finish(rid, tokens=resp.get("tokens"),
                                           replica=name, replay=True):
                        with self._lock:
                            self.replayed_total += 1
                        self._m_replayed.inc()
                    break
                except _ReplicaClientError as e:
                    self.journal.fail(rid, f"replay rejected: {e}",
                                      status=e.status)
                    break
                except (_Replica503, NoReplicaError,
                        _DispatchTimeout) as e:
                    if time.monotonic() >= deadline:
                        # NOT silently dropped: counted, journaled as
                        # failed, and visible in /router/journal
                        self.journal.fail(rid, f"replay abandoned: {e!r}")
                        with self._lock:
                            self.replay_abandoned_total += 1
                        break
                    self._stop_replay.wait(0.2)

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> "FleetRouter":
        if self.supervisor._thread is None:
            # wait=False: a quorum fleet must come up with a MINORITY
            # of replicas down (the blocking per-replica barrier would
            # fail the whole router on one dead endpoint); quorum is
            # awaited below instead, bounded — and on timeout the
            # router still serves, with /readyz reporting the shortfall
            self.supervisor.start(wait=False)
        deadline = time.monotonic() + self.startup_wait_s
        while (self.supervisor.ready_count() < self.quorum
               and time.monotonic() < deadline):
            time.sleep(0.1)
        self._scrape_pass()  # admission + federation live before serving
        router = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):  # quiet
                pass

            def _send(self, obj, code=200,
                      content_type="application/json",
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

            def do_GET(self):
                router._m_req.inc()
                url = urlparse(self.path)
                if url.path == "/healthz":
                    self._send({"status": "up", "tier": "router"})
                elif url.path == "/readyz":
                    ok, body = router.ready()
                    self._send(body, 200 if ok else 503)
                elif url.path == "/metrics":
                    q = parse_qs(url.query)
                    fmt = q.get("format", [""])[0]
                    accept = self.headers.get("Accept", "") or ""
                    if fmt == "prometheus" or "openmetrics" in accept:
                        self._send(
                            router.metrics.render_prometheus().encode(),
                            content_type="application/openmetrics-text; "
                                         "version=1.0.0; charset=utf-8")
                    elif fmt == "text" or "text/plain" in accept:
                        self._send(
                            router.metrics.render_prometheus(
                                openmetrics=False).encode(),
                            content_type="text/plain; version=0.0.4; "
                                         "charset=utf-8")
                    else:
                        self._send(router.metrics.snapshot())
                elif url.path == "/fleet":
                    fleet = router.fleet()
                    if fleet is None:
                        return self._send(
                            {"error": "no replicas federated yet"}, 503)
                    self._send(fleet.render_prometheus().encode(),
                               content_type="text/plain; version=0.0.4; "
                                            "charset=utf-8")
                elif url.path == "/fleet/summary":
                    fleet = router.fleet()
                    if fleet is None:
                        return self._send(
                            {"error": "no replicas federated yet"}, 503)
                    self._send(fleet.summary())
                elif url.path == "/router/journal":
                    if router.journal is None:
                        return self._send(
                            {"error": "journal disabled "
                             "(start the router with journal_path)"}, 404)
                    body = router.journal.stats()
                    with router._lock:
                        body["replayed_total"] = router.replayed_total
                        body["replay_abandoned_total"] = \
                            router.replay_abandoned_total
                    self._send(body)
                elif url.path == "/trace/clock":
                    self._send({**router.tracer.clock(),
                                "pid": os.getpid()})
                elif url.path == "/trace":
                    q = parse_qs(url.query)
                    try:
                        limit = int(q.get("limit", ["0"])[0]) or None
                        since = (int(q["since"][0]) if "since" in q
                                 else None)
                    except ValueError:
                        return self._send(
                            {"error": "limit/since must be integers"}, 400)
                    if q.get("format", [""])[0] == "chrome":
                        self._send(router.tracer.chrome_trace(limit=limit))
                    else:
                        self._send(router.tracer.snapshot(limit=limit,
                                                          since=since))
                else:
                    self._send({"error": "not found"}, 404)

            def do_POST(self):
                router._m_req.inc()
                url = urlparse(self.path)
                q = parse_qs(url.query)
                ctx = parse_trace_header(self.headers.get(TRACE_HEADER))
                base = (ctx.request_id if ctx is not None
                        else (self.headers.get("X-Request-Id") or "")[:256])
                rid = (f"{base}.{new_trace_id()}"
                       if _REQUEST_ID_RE.fullmatch(base)
                       else new_trace_id())
                try:
                    n = int(self.headers.get("Content-Length", 0))
                except ValueError:
                    router._m_err.inc()
                    return self._send(
                        {"error": "bad Content-Length",
                         "request_id": rid}, 400, request_id=rid)
                raw = self.rfile.read(n)
                with router._lock:
                    down = router._shutting_down
                if down:
                    router._m_err.inc()
                    return self._send({"error": "shutting_down",
                                       "request_id": rid}, 503,
                                      request_id=rid)
                t_route = time.monotonic()
                timeout_ms = None
                if "timeout_ms" in q:
                    try:
                        timeout_ms = float(q["timeout_ms"][0])
                    except ValueError:
                        router._m_err.inc()
                        return self._send(
                            {"error": "timeout_ms must be a number",
                             "request_id": rid}, 400, request_id=rid)
                slo_sample = True
                if ctx is not None:
                    router.tracer.begin(
                        "rpc", req=rid,
                        origin=ctx.parent or ctx.request_id,
                        parent=ctx.parent or ctx.request_id,
                        args={"path": url.path, "hop": ctx.hop,
                              "trace": ctx.request_id})
                try:
                    if url.path == "/admin/drain":
                        started = router.drain_async()
                        return self._send(
                            {"status": ("draining" if started
                                        else "already_draining"),
                             "replicas": [r.name for r in
                                          router.supervisor.replicas],
                             "request_id": rid}, 202, request_id=rid)
                    if url.path == "/generate":
                        payload = json.loads(raw.decode())
                        if payload.get("stream"):
                            # SSE pass-through: the handler writes the
                            # response itself (chunked as the replica
                            # emits; failover only before the first
                            # byte; journal terminal at stream end)
                            outcome = router.handle_generate_stream(
                                self, rid, payload, ctx, timeout_ms)
                            if outcome != "ok":
                                slo_sample = False
                        else:
                            out, code, extra = router.handle_generate(
                                rid, raw, ctx, timeout_ms,
                                payload=payload)
                            self._send(out, code, request_id=rid,
                                       headers=extra)
                            if code >= 400:
                                # fast rejects and propagated errors are
                                # not SLO samples (the same dilution
                                # argument as the replica's own observe
                                # policy)
                                slo_sample = False
                    elif url.path in ("/predict", "/predict/csv"):
                        out, code, extra = router.handle_predict(
                            rid, url.path, raw, ctx, timeout_ms)
                        self._send(out, code, request_id=rid,
                                   headers=extra)
                        if code >= 400:
                            # fast rejects are not SLO samples here
                            # either (same dilution argument as
                            # /generate)
                            slo_sample = False
                    else:
                        self._send({"error": "not found",
                                    "request_id": rid}, 404,
                                   request_id=rid)
                        slo_sample = False
                except failpoints.InjectedFault as e:
                    router._m_err.inc()
                    slo_sample = False
                    self._send({"error": "injected_fault", "seam": e.seam,
                                "request_id": rid}, 500, request_id=rid)
                except Exception as e:
                    router._m_err.inc()
                    slo_sample = False
                    self._send({"error": str(e), "request_id": rid}, 400,
                               request_id=rid)
                finally:
                    if url.path == "/generate":
                        # request-end ledger invariant: whatever path
                        # answered the client (success, propagated
                        # error, injected fault), the journal record
                        # must have reached its terminal by now
                        ledger_check_request(rid, _JOURNAL_KINDS)
                    if ctx is not None:
                        router.tracer.end("rpc", req=rid)
                    if slo_sample and url.path in ("/generate", "/predict",
                                                   "/predict/csv"):
                        router.slo.observe(url.path,
                                           time.monotonic() - t_route,
                                           request_id=rid)

        self._httpd = _RouterHTTPServer(("127.0.0.1", self._port), Handler)
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True, name="router-http")
        self._thread.start()
        self._scrape_thread = threading.Thread(
            target=self._scrape_loop, daemon=True, name="router-scrape")
        self._scrape_thread.start()
        if self.journal is not None and self._recovered:
            self._replay_thread = threading.Thread(
                target=self._replay, daemon=True, name="router-replay")
            self._replay_thread.start()
        return self

    # -- request handling (thread-per-request via ThreadingHTTPServer) ----
    def handle_generate(self, rid: str, raw: bytes,
                        ctx: Optional[TraceContext],
                        timeout_ms: Optional[float],
                        payload: Optional[dict] = None):
        """(body, status, extra_headers) for POST /generate.
        ``payload``: the already-parsed body when the caller peeked at
        it (do_POST reads the stream flag) — avoids a second
        O(body) json.loads on the routing hot path."""
        if payload is None:
            payload = json.loads(raw.decode())
        if not isinstance(payload.get("prompt"), list):
            return ({"error": "prompt must be a list of token ids",
                     "request_id": rid}, 400, None)
        verdict = self.admission_verdict()
        if self.admission_burn and verdict["burning"]:
            # the fleet is violating its own SLO: reject up front with
            # the ladder's own back-off hint instead of queueing more
            self._m_rejected.inc()
            self.tracer.instant("reject", track="router", args={
                "request_id": rid, "reason": "fleet_burning"})
            return ({"error": "fleet_burning",
                     "burn_rate_fast": verdict["fast"],
                     "burn_rate_slow": verdict["slow"],
                     "retry_after_s": self.retry_after_s,
                     "request_id": rid}, 503,
                    {"Retry-After": str(max(1, int(self.retry_after_s)))})
        failpoints.fire("router.journal")
        if self.journal is not None:
            self.journal.accept(rid, payload)
        deadline = (time.monotonic() + timeout_ms / 1e3
                    if timeout_ms else None)
        # the client's deadline rides through to the replica (it arms
        # its own 504 + decode-cancel, reclaiming the slot) — without
        # this the router's socket timeout would read as a dead replica
        # and fail the same doomed request over to every survivor
        path = ("/generate" + (f"?timeout_ms={timeout_ms:g}"
                               if timeout_ms else ""))
        try:
            # the dispatch seam sits INSIDE the journaling try: any
            # fault it injects still answers the client an error, so it
            # must leave a terminal record like every other dispatch
            # failure (an unterminated accept would wedge the cursor
            # and be falsely replayed)
            failpoints.fire("router.dispatch")
            name, attempts, resp = self._dispatch(rid, payload,
                                                  path, ctx,
                                                  deadline_s=deadline)
        except _Replica503 as e:
            # the replica's own admission verdict: propagate UNCHANGED,
            # Retry-After included (the degradation ladder's hint must
            # survive the extra tier) — and journal it terminal: the
            # client saw the answer, a restart must not replay it
            self._m_propagated.inc()
            if self.journal is not None:
                self.journal.fail(rid, f"replica {e.replica} 503",
                                  status=503)
            hdrs = ({"Retry-After": e.headers["Retry-After"]}
                    if "Retry-After" in e.headers else None)
            return (e.body_bytes(), 503, hdrs)
        except _ReplicaClientError as e:
            if self.journal is not None:
                self.journal.fail(rid, f"replica {e.replica} "
                                  f"{e.status}", status=e.status)
            return (e.body_bytes(), e.status, None)
        except _DispatchTimeout as e:
            self._m_err.inc()
            self.tracer.instant("reject", track="router", args={
                "request_id": rid, "reason": "timeout_504"})
            if self.journal is not None:
                self.journal.fail(rid, f"deadline exceeded "
                                  f"(replica {e.replica})", status=504)
            return (e.body_bytes(rid), 504, None)
        except NoReplicaError as e:
            self._m_err.inc()
            if self.journal is not None:
                self.journal.fail(rid, repr(e), status=502)
            return ({"error": "no_replica", "detail": str(e),
                     "request_id": rid}, 502, None)
        except BaseException as e:
            # ANY other dispatch failure (injected fault, malformed
            # replica body, ...) still answers the client an error via
            # do_POST — so it must be journaled terminal too, or the
            # unterminated accept would wedge cursor advancement for
            # the router's lifetime and be falsely replayed after a
            # restart
            if self.journal is not None:
                self.journal.fail(rid, f"dispatch error: {e!r}",
                                  status=500)
            raise
        if self.journal is not None:
            self.journal.finish(rid, tokens=resp.get("tokens"),
                                replica=name)
        resp["router"] = {"replica": name, "attempts": attempts,
                          "request_id": rid}
        return resp, 200, None

    def handle_generate_stream(self, handler, rid: str, payload: dict,
                               ctx: Optional[TraceContext],
                               timeout_ms: Optional[float]) -> str:
        """POST /generate ``{"stream": true}`` — SSE pass-through.

        Same admission/affinity/journal discipline as buffered
        `handle_generate`, but the replica's event stream is forwarded
        chunk-by-chunk as it arrives instead of being buffered and
        re-serialized. FAILOVER HAPPENS ONLY BEFORE THE FIRST BODY BYTE:
        a replica that refuses the connection or 5xxes pre-stream is
        retried on the next rendezvous candidate exactly like buffered
        dispatch; once any byte has been forwarded the stream is
        committed to that replica — a mid-stream replica death truncates
        the client's stream (journaled ``fail``, the client re-submits),
        because silently re-running the request elsewhere would replay
        already-delivered tokens into the same stream.

        The journal's terminal record is written AT STREAM END: clean
        EOF → ``finish`` (with the terminal SSE event's token list when
        parseable), client hangup → ``fail`` (closing the upstream
        socket fires the replica's own cancel-on-disconnect, so the
        slot is reclaimed fleet-wide), mid-stream replica death →
        ``fail``. Exactly one terminal per accept, dedup'd by the
        journal. Returns "ok" | "disconnect" | "rejected" | "truncated"
        (only "ok" is an SLO sample)."""
        if not isinstance(payload.get("prompt"), list):
            # validated BEFORE the journal accept, like the buffered
            # path: an accept with no possible terminal record would
            # wedge cursor advancement and be falsely replayed
            handler._send({"error": "prompt must be a list of token "
                           "ids", "request_id": rid}, 400,
                          request_id=rid)
            return "rejected"
        verdict = self.admission_verdict()
        if self.admission_burn and verdict["burning"]:
            self._m_rejected.inc()
            self.tracer.instant("reject", track="router", args={
                "request_id": rid, "reason": "fleet_burning"})
            handler._send(
                {"error": "fleet_burning",
                 "burn_rate_fast": verdict["fast"],
                 "burn_rate_slow": verdict["slow"],
                 "retry_after_s": self.retry_after_s,
                 "request_id": rid}, 503, request_id=rid,
                headers={"Retry-After":
                         str(max(1, int(self.retry_after_s)))})
            return "rejected"
        failpoints.fire("router.journal")
        if self.journal is not None:
            self.journal.accept(rid, payload)
        self._m_stream_reqs.inc()
        try:
            # EVERYTHING past the accept sits inside the journaling
            # contract, exactly like buffered handle_generate: any
            # escape (injected fault, malformed token id in
            # affinity_key, ...) still answers the client an error via
            # do_POST, so it must leave a terminal record too
            return self._dispatch_stream(handler, rid, payload, ctx,
                                         timeout_ms)
        except BaseException as e:
            if self.journal is not None:
                self.journal.fail(rid, f"dispatch error: {e!r}",
                                  status=500)
            raise

    def _dispatch_stream(self, handler, rid: str, payload: dict,
                         ctx: Optional[TraceContext],
                         timeout_ms: Optional[float]) -> str:
        """The SSE dispatch loop proper (journal accept already
        written; the caller owns the journal-on-escape contract).
        Candidate selection and replica-error classification are the
        SAME `_next_candidate` / `_raise_for_status` the buffered path
        uses — only the answer transport differs."""
        body = json.dumps(payload).encode()
        key = affinity_key(payload.get("prompt") or [], self.kv_block,
                           self.affinity_blocks)
        egress = (ctx.child() if ctx is not None else
                  TraceContext(rid, span_id(rid, 0), 0, time.time()))
        headers = {TRACE_HEADER: format_trace_header(egress),
                   "X-Request-Id": rid,
                   "Content-Type": "application/json"}
        path = ("/generate" + (f"?timeout_ms={timeout_ms:g}"
                               if timeout_ms else ""))
        deadline = time.monotonic() + (timeout_ms / 1e3 if timeout_ms
                                       else self.dispatch_timeout_s)
        failpoints.fire("router.dispatch")
        tried: set = set()
        last_err: Optional[BaseException] = None
        for attempt in range(self.dispatch_attempts):
            cand = self._pick_with_directory(
                attempt, key, payload.get("prompt") or [], tried,
                deadline)
            if cand is None:
                break
            name, url = cand
            tried.add(name)
            if attempt:
                self._m_retries.inc()
            self.tracer.instant("route", req=rid, args={
                "request_id": rid, "replica": name, "attempt": attempt,
                "stream": True})
            try:
                req = urllib.request.Request(
                    url + path, data=body, headers=headers)
                resp = urllib.request.urlopen(
                    req, timeout=max(0.05,
                                     deadline - time.monotonic()))
            except urllib.error.HTTPError as e:
                try:
                    self._raise_for_status(name, e)
                    last_err = e  # 5xx pre-stream: fail over
                    continue
                except _Replica503 as exc:
                    # the replica's own admission verdict: propagated
                    # unchanged, Retry-After preserved, terminal
                    self._m_propagated.inc()
                    if self.journal is not None:
                        self.journal.fail(rid, f"replica {name} 503",
                                          status=503)
                    handler._send(
                        exc.body_bytes(), 503, request_id=rid,
                        headers=({"Retry-After":
                                  exc.headers["Retry-After"]}
                                 if "Retry-After" in exc.headers
                                 else None))
                    return "rejected"
                except _DispatchTimeout as exc:
                    # terminal — the request's budget is spent (same
                    # error counter + reject instant as buffered: a
                    # streamed timeout must not vanish from
                    # router_errors_total)
                    self._m_err.inc()
                    self.tracer.instant("reject", track="router", args={
                        "request_id": rid, "reason": "timeout_504"})
                    if self.journal is not None:
                        self.journal.fail(rid, f"replica {name} 504",
                                          status=504)
                    handler._send(exc.body_bytes(rid), 504,
                                  request_id=rid)
                    return "rejected"
                except _ReplicaClientError as exc:
                    # terminal — no other replica will like the payload
                    if self.journal is not None:
                        self.journal.fail(
                            rid, f"replica {name} {exc.status}",
                            status=exc.status)
                    handler._send(exc.body_bytes(), exc.status,
                                  request_id=rid)
                    return "rejected"
            except (urllib.error.URLError, OSError, TimeoutError) as e:
                if time.monotonic() >= deadline:
                    self._m_err.inc()
                    self.tracer.instant("reject", track="router", args={
                        "request_id": rid, "reason": "timeout_504"})
                    if self.journal is not None:
                        self.journal.fail(
                            rid, "deadline exceeded pre-stream",
                            status=504)
                    handler._send(
                        {"error": "deadline exceeded at the router",
                         "request_id": rid}, 504, request_id=rid)
                    return "rejected"
                last_err = e  # connection refused/reset: failover
                continue
            outcome = self._pump_stream(handler, rid, name, resp)
            if outcome == "failover":
                last_err = RuntimeError(
                    f"replica {name} died before its first stream byte")
                continue
            return outcome
        self._m_err.inc()
        if self.journal is not None:
            self.journal.fail(rid, repr(last_err), status=502)
        handler._send({"error": "no_replica", "detail": repr(last_err),
                       "request_id": rid}, 502, request_id=rid)
        return "rejected"

    def _pump_stream(self, handler, rid: str, name: str, resp) -> str:
        """Forward one replica's SSE body to the client as it arrives.
        Returns "ok" (clean EOF, journaled finish), "disconnect" (the
        CLIENT hung up — upstream closed so the replica cancels),
        "truncated" (the replica died mid-stream after bytes were
        forwarded), or "failover" (upstream died before its first byte
        AND nothing was sent — the caller retries elsewhere; the
        client's response is untouched)."""
        sent = 0
        tail = b""
        started = False
        try:
            try:
                while True:
                    try:
                        # read1: returns as soon as ANY bytes are
                        # available — a full read(n) would buffer the
                        # very tokens streaming exists to deliver early
                        chunk = resp.read1(8192)
                    except (OSError, ValueError) as e:
                        if not started:
                            return "failover"
                        self._m_err.inc()
                        if self.journal is not None:
                            self.journal.fail(
                                rid, f"replica {name} died mid-stream: "
                                f"{e!r}", status=502)
                        return "truncated"
                    if not chunk:
                        break  # EOF — clean only if the terminal event
                        # arrived (checked below: a SIGKILLed replica's
                        # FIN reads as EOF too, because SSE bodies are
                        # close-delimited, not length-framed)
                    if not started:
                        started = True
                        handler.send_response(200)
                        handler.send_header(
                            "Content-Type",
                            resp.headers.get("Content-Type",
                                             "text/event-stream"))
                        handler.send_header("Cache-Control", "no-cache")
                        handler.send_header("X-Request-Id", rid)
                        handler.end_headers()
                    # keep a bounded tail so the terminal event's token
                    # list can land in the journal without buffering
                    # the whole stream. Trim at EVENT boundaries: a
                    # blind byte cap would slice the `data: ` prefix
                    # off a terminal event larger than the cap and
                    # misread a cleanly finished long completion as
                    # truncated — so the tail always holds the current
                    # (last) event whole, shedding only earlier ones
                    tail += chunk
                    if len(tail) > 65536:
                        cut = tail.rfind(b"data: ")
                        if cut > 0:
                            tail = tail[cut:]
                    handler.wfile.write(chunk)
                    handler.wfile.flush()
                    sent += len(chunk)
            except (BrokenPipeError, ConnectionResetError, OSError):
                # the CLIENT hung up mid-stream: the finally's
                # resp.close() tears down the replica socket, firing
                # the replica's own cancel-on-disconnect — the slot is
                # reclaimed fleet-wide, and the journal records the
                # terminal exactly once
                self._m_stream_disconnects.inc()
                self.tracer.instant(
                    "stream_disconnect", req=rid,
                    args={"request_id": rid, "replica": name,
                          "bytes": sent})
                if self.journal is not None:
                    self.journal.fail(
                        rid, "client disconnected mid-stream",
                        status=499)
                return "disconnect"
        finally:
            try:
                resp.close()
            except OSError:
                pass
        # EOF is only a CLEAN end when the terminal SSE event arrived:
        # SSE bodies are close-delimited, so a replica SIGKILLed
        # mid-stream produces the same zero-byte read as a finished one
        # — journaling that as "finish" would silently drop the request
        # from replay (and, pre-first-byte, answer the client nothing)
        tokens = None
        saw_done = False
        for line in tail.decode("utf-8", "replace").splitlines():
            if not line.startswith("data: "):
                continue
            try:
                evt = json.loads(line[len("data: "):])
            except ValueError:
                continue  # torn tail line; keep scanning
            if evt.get("done"):
                saw_done = True
                tokens = evt.get("tokens")
        if not saw_done:
            if not started:
                return "failover"  # died before any byte: retry elsewhere
            self._m_err.inc()
            if self.journal is not None:
                self.journal.fail(
                    rid, f"replica {name} stream ended without a "
                    "terminal event", status=502)
            return "truncated"
        if self.journal is not None:
            self.journal.finish(rid, tokens=tokens, replica=name)
        return "ok"

    def handle_predict(self, rid: str, path: str, raw: bytes,
                       ctx: Optional[TraceContext],
                       timeout_ms: Optional[float]):
        """Stateless prediction: round-robin over ready replicas (no
        affinity — there is no KV state to be affine to), no journal
        (idempotent, client-retryable)."""
        cands = self.supervisor.ready_replicas()
        if not cands:
            return ({"error": "no_replica", "request_id": rid}, 502, None)
        with self._lock:
            self._rr += 1
            start = self._rr
        egress = (ctx.child() if ctx is not None else
                  TraceContext(rid, span_id(rid, 0), 0, time.time()))
        headers = {TRACE_HEADER: format_trace_header(egress),
                   "X-Request-Id": rid,
                   "Content-Type": ("text/plain" if path.endswith("csv")
                                    else "application/json")}
        timeout = (timeout_ms / 1e3 if timeout_ms
                   else self.dispatch_timeout_s)
        if timeout_ms:
            # the client's deadline rides through (the replica's own
            # 504/cancel path, same as /generate)
            path = f"{path}?timeout_ms={timeout_ms:g}"
        last: Optional[BaseException] = None
        for i in range(len(cands)):
            name, url = cands[(start + i) % len(cands)]
            if i:
                self._m_retries.inc()
            try:
                resp = self._forward(url, path, raw, headers, timeout)
                resp["router"] = {"replica": name, "request_id": rid}
                return resp, 200, None
            except urllib.error.HTTPError as e:
                body = e.read()
                hdrs = dict(e.headers.items()) if e.headers else {}
                e.close()
                if e.code == 503:
                    ra = ({"Retry-After": hdrs["Retry-After"]}
                          if "Retry-After" in hdrs else None)
                    return body, 503, ra
                if e.code == 504 or e.code < 500:
                    # the deadline (504) or the payload (4xx) is the
                    # problem — no other replica will do better
                    return body, e.code, None
                last = e
            except (urllib.error.URLError, OSError, TimeoutError) as e:
                last = e
        self._m_err.inc()
        return ({"error": "no_replica", "detail": repr(last),
                 "request_id": rid}, 502, None)

    def drain_async(self) -> bool:
        """Kick ONE rolling drain across the fleet (the per-replica
        drain protocol, one replica at a time). Returns False — and
        starts nothing — while a drain is already running: two
        concurrent rolling drains could take two replicas down at once,
        exactly the dip the rolling discipline exists to prevent."""
        with self._lock:
            if self._draining:
                return False
            self._draining = True

        def run():
            try:
                self.supervisor.rolling_drain()
            finally:
                with self._lock:
                    self._draining = False

        threading.Thread(target=run, daemon=True,
                         name="fleet-drain").start()
        return True

    # -- status -------------------------------------------------------------
    def ready(self) -> Tuple[bool, dict]:
        """The quorum `/readyz`: ready while at least ``quorum``
        replicas' last probe was ready and the router is not shutting
        down. A ROLLING drain is reported (``draining``) but does not
        gate readiness — the fleet keeps serving through it; that is
        the point of draining one replica at a time. The body carries
        every replica's cached probe verdict — the "which replica is
        down" runbook read."""
        states = self.supervisor.states()
        ready_n = sum(1 for s in states.values() if s.get("ready"))
        with self._lock:
            draining = self._draining
            down = self._shutting_down
            verdict = self._admission
            scrape_error = self._scrape_error
        ok = ready_n >= self.quorum and not down
        body = {
            "ready": ok,
            "tier": "router",
            "replicas_ready": ready_n,
            "replicas_total": len(self.supervisor.replicas),
            "quorum": self.quorum,
            "draining": draining,
            "admission": verdict,
            "replicas": states,
        }
        if not ok:
            body["reason"] = ("shutting_down" if down else
                              f"quorum {ready_n}/{self.quorum}")
        if scrape_error:
            body["scrape_error"] = scrape_error
        with self.supervisor._lock:
            probe_error = self.supervisor.probe_error
        if probe_error:
            body["probe_error"] = probe_error
        if self.journal is not None:
            body["journal"] = self.journal.stats()
        return ok, body

    def fleet(self) -> Optional[FleetMetrics]:
        with self._lock:
            return self._fleet

    def stop(self, stop_replicas: bool = True) -> None:
        with self._lock:
            self._shutting_down = True
        self._stop_scrape.set()
        self._stop_replay.set()
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        # the replay thread exits promptly on the stop event (any
        # records it never terminated stay pending in the journal for
        # the next incarnation) — it must be DOWN before close(), or a
        # late finish/fail would write to a closed producer
        for th in (self._scrape_thread, self._replay_thread):
            if th is not None:
                th.join(timeout=30)
        self._scrape_thread = self._replay_thread = None
        if stop_replicas:
            self.supervisor.stop()
        if self.journal is not None:
            self.journal.close()


class _Replica503(Exception):
    """A replica answered 503: its own admission/drain/ladder verdict,
    to be propagated through the router unchanged."""

    def __init__(self, replica: str, body: bytes, headers: Dict[str, str]):
        self.replica = replica
        self.body = body
        self.headers = headers
        super().__init__(f"replica {replica} answered 503")

    def body_bytes(self) -> bytes:
        return self.body or b'{"error": "replica_busy"}'


class _DispatchTimeout(Exception):
    """The request's deadline expired (router-side) or the replica
    answered 504 (its own timeout-cancel): terminal, never failed over
    — the budget is spent; a 504 reaches the client either way."""

    def __init__(self, replica: str, body: Optional[bytes]):
        self.replica = replica
        self.body = body
        super().__init__(f"deadline exceeded dispatching to {replica}")

    def body_bytes(self, rid: str) -> bytes:
        return self.body or json.dumps(
            {"error": "deadline exceeded at the router",
             "replica": self.replica, "request_id": rid}).encode()


class _ReplicaClientError(Exception):
    """A replica answered 4xx: the payload is the problem — propagated,
    never failed over (no other replica will accept it either)."""

    def __init__(self, replica: str, status: int, body: bytes):
        self.replica = replica
        self.status = int(status)
        self.body = body
        super().__init__(f"replica {replica} answered {status}")

    def body_bytes(self) -> bytes:
        return self.body or b'{"error": "bad_request"}'


# ---------------------------------------------------------------------------
# subprocess entry point
# ---------------------------------------------------------------------------

def main(argv: Optional[List[str]] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m deeplearning4j_tpu_torch.serving.router",
        description="fleet router process: journaled, prefix-affine "
                    "routing over N engine replicas")
    ap.add_argument("--replicas", default=None,
                    help="comma-separated base URLs of RUNNING replicas "
                         "(attach mode)")
    ap.add_argument("--spawn", type=int, default=0,
                    help="spawn N replica subprocesses (mutually "
                         "exclusive with --replicas); remaining replica "
                         "knobs ride --replica-arg")
    ap.add_argument("--replica-arg", action="append", default=[],
                    help="argv fragment forwarded to every spawned "
                         "replica (repeatable), e.g. "
                         "--replica-arg=--model --replica-arg=m.zip")
    ap.add_argument("--journal", default=None,
                    help="durable request-journal path (crash replay "
                         "needs it; omit to route without durability)")
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--announce", default=None,
                    help="JSON file to write {port, pid} into once "
                         "serving")
    ap.add_argument("--kv-block", type=int, default=16)
    ap.add_argument("--paged-kernel", choices=["on", "off"],
                    default=None,
                    help="forward the paged decode kernel's mode to every "
                         "SPAWNED replica (replicas default to 'on': the "
                         "CUDA kernel on the card)")
    ap.add_argument("--device", default="cuda",
                    help="the device every SPAWNED replica serves on: cuda "
                         "(default; fails without a CUDA device) or cpu")
    ap.add_argument("--affinity-blocks", type=int, default=1)
    ap.add_argument("--quorum", type=int, default=1)
    ap.add_argument("--scrape-interval", type=float, default=0.5)
    ap.add_argument("--dispatch-attempts", type=int, default=4)
    ap.add_argument("--no-admission", action="store_true",
                    help="disable SLO-aware admission (route even while "
                         "the fleet burns)")
    ap.add_argument("--no-prefix-directory", action="store_true",
                    help="disable the fleet prefix directory (route by "
                         "rendezvous affinity only)")
    ap.add_argument("--prefix-fetch", action="store_true",
                    help="directory hits keep the rendezvous target and "
                         "instruct it to PULL the chain from the holder "
                         "(instead of routing to the holder)")
    args = ap.parse_args(argv)
    if bool(args.replicas) == bool(args.spawn):
        ap.error("pass exactly one of --replicas or --spawn")

    armed = failpoints.arm_from_env()  # router seams arm from the env
    if args.spawn:
        # --device first: a --replica-arg fragment naming its own wins
        replica_argv = ["--device", args.device, *args.replica_arg]
        if args.paged_kernel is not None:
            replica_argv += ["--paged-kernel", args.paged_kernel]
        # no card for cuda replicas: fail here, loudly, instead of
        # respawning replicas that can never come up
        from ..util.device import resolve_device
        resolve_device(_argv_device(replica_argv))
        sup = ReplicaSupervisor(
            [ReplicaProcess(replica_argv, name=f"r{i}")
             for i in range(args.spawn)])
    else:
        sup = ReplicaSupervisor(
            [ReplicaEndpoint(u.strip(), f"r{i}") for i, u in
             enumerate(args.replicas.split(",")) if u.strip()])
    router = FleetRouter(
        supervisor=sup, journal_path=args.journal, port=args.port,
        kv_block=args.kv_block, affinity_blocks=args.affinity_blocks,
        quorum=args.quorum, scrape_interval_s=args.scrape_interval,
        dispatch_attempts=args.dispatch_attempts,
        admission_burn=not args.no_admission,
        prefix_directory=not args.no_prefix_directory,
        prefix_fetch=args.prefix_fetch).start()

    stop = threading.Event()

    def _term(_sig, _frm):
        stop.set()

    signal.signal(signal.SIGTERM, _term)
    signal.signal(signal.SIGINT, _term)
    if args.announce:
        write_announce(args.announce, router.port, armed)
    n = len(sup.replicas)
    print(f"fleet router pid={os.getpid()} on http://127.0.0.1:"
          f"{router.port} fronting {n} replica(s)"
          + (f", journal {args.journal}" if args.journal else "")
          + (f" (failpoints armed: {', '.join(armed)})" if armed else ""),
          flush=True)
    stop.wait()
    router.stop(stop_replicas=bool(args.spawn))
    return 0


if __name__ == "__main__":
    sys.exit(main())
