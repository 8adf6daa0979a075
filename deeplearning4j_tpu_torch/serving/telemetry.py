"""Fleet telemetry plane — a port of deeplearning4j_tpu/serving/telemetry.py:
cross-process trace propagation, the multi-replica waterfall merge, and
federated metrics and SLO. Host-only (no device work): it speaks HTTP to the
port's servers and builds on `inference/trace.py` (`FlightRecorder`,
`render_chrome_events`), `inference/metrics.py` (`merge_histograms`,
`series_key`) and `inference/profiler.py` (`burn_verdict`).

**Context propagation** (the ``X-Graft-Trace`` header). A traceparent-
style value ``<request_id>;<parent_span>;<hop>;<origin_send_ts>``: the
fleet-wide request identity, the sender's span id (the flow-edge identity
the Chrome export's ``s``/``f`` flow events share), a hop count (bounded:
an overflowed hop means a forwarding loop and degrades to a fresh
context), and the sender's wall-clock send time (so the receiver can
report the network and queue gap between tiers). `serving/server.py`
parses it on ingress (a malformed value degrades to a fresh context,
never a 500) and :class:`ClientTracer` and the router stamp it on egress,
so one request carries one identity across client -> router -> replica.
The header format is the JAX package's, so either package's header
parses in the other.

**Trace aggregation** (:class:`TraceAggregator`). Tails N processes'
``GET /trace?since=CURSOR`` cursors, places each process's clock with an
RTT-bounded handshake against ``GET /trace/clock`` (the minimum-RTT
probe bounds the epoch estimate to +-RTT/2), and merges everything into
ONE Perfetto-loadable trace: a track group (pid) per process, flow
arrows joining each request's spans across processes, and visible
``ring_dropped`` markers wherever a ring overwrote events between polls.

**Metrics federation** (:class:`FleetMetrics`). Scrapes N
``/metrics?format=prometheus`` expositions, sums counters, merges
cumulative histogram buckets (boundaries are canonical across replicas; a
mismatch raises), recomputes fleet p50/p95/p99 per route from the MERGED
buckets, traffic-weights the replicas' fast/slow burn rates into fleet
burn rates (verdict by `burn_verdict`), and re-exposes one fleet
exposition plus ``fleet_replicas_up`` / ``fleet_scrape_errors_total``:
the signals the router's SLO-aware admission reads.

CLI (also ``python -m deeplearning4j_tpu_torch.cli.main telemetry``)::

    python -m deeplearning4j_tpu_torch.serving.telemetry \\
        --targets http://127.0.0.1:8080,http://127.0.0.1:8081 \\
        --out fleet_trace.json --serve-port 9090

``--serve-port`` exposes ``GET /fleet`` (the federated Prometheus
exposition), ``GET /fleet/summary`` (JSON) and ``GET /fleet/trace`` (the
merged Perfetto trace, refreshed per poll). ``--ui`` (the training UI's
``/serving`` fleet line) waits for the port of the UI and raises
NotImplementedError.
"""
from __future__ import annotations

import json
import math
import re
import sys
import threading
import time
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, List, NamedTuple, Optional

from ..inference.metrics import merge_histograms, series_key
from ..inference.profiler import burn_verdict
from ..inference.trace import FlightRecorder, render_chrome_events

__all__ = ["TRACE_HEADER", "TraceContext", "parse_trace_header",
           "format_trace_header", "new_trace_id", "ClientTracer",
           "ClockSync", "probe_clock", "TraceAggregator", "FleetMetrics",
           "FleetTelemetryServer", "parse_prometheus"]

# ---------------------------------------------------------------------------
# trace-context propagation (the X-Graft-Trace header)
# ---------------------------------------------------------------------------

TRACE_HEADER = "X-Graft-Trace"

# header id alphabets: the request_id field uses the SAME alphabet the
# server's X-Request-Id honoring does (serving/server.py
# _REQUEST_ID_RE) — a rid the server would refuse to echo must degrade
# the whole context HERE, not half-apply (rpc span claiming one trace
# while the response header carries a fresh id); span ids additionally
# allow "/" ("<rid>/hN"). Anything else — control characters, quotes,
# overlength — fails the match and the whole header degrades to a
# fresh context before it can reach trace records or the Prometheus
# exemplar escaping.
_RID_RE = re.compile(r"[A-Za-z0-9._:\-]{1,128}")
_ID_RE = re.compile(r"[A-Za-z0-9._:/\-]{1,128}")
_HEADER_MAX = 256  # hard cap BEFORE any parsing work
_HOP_MAX = 64  # beyond this the context is a forwarding loop, not a path

_pid_tag = None
_pid_of_tag = None
_tid_counter = None
_tid_lock = threading.Lock()


def new_trace_id() -> str:
    """Fleet-wide trace id (``t<pid-hex>.000001``): unlike
    `trace.new_request_id` (process-unique only), these must not
    collide when traces from SEVERAL client/replica processes merge
    onto one timeline, so the process id is baked in. Initialization
    is locked (concurrent FIRST calls from load-generator threads must
    not each install a fresh counter and mint duplicate ids) and
    re-keyed after fork; the steady-state path is one lock-free atomic
    ``next()`` like the recorder's ring."""
    global _pid_tag, _pid_of_tag, _tid_counter
    import os
    counter = _tid_counter
    if counter is None or _pid_of_tag != os.getpid():
        with _tid_lock:
            if _tid_counter is None or _pid_of_tag != os.getpid():
                import itertools
                _pid_of_tag = os.getpid()
                _pid_tag = f"t{_pid_of_tag:x}"
                _tid_counter = itertools.count(1)
            counter = _tid_counter
    return f"{_pid_tag}.{next(counter):06d}"


class TraceContext(NamedTuple):
    """One hop's trace context: the fleet-wide ``request_id``, the
    sender's span id (``parent`` — empty on an origin with no recorded
    client span), the ``hop`` count, and the sender's wall-clock send
    timestamp ``origin_ts`` (seconds; lets the receiver report the
    network/queue gap between tiers, clock-skew-bounded)."""
    request_id: str
    parent: str
    hop: int
    origin_ts: float

    def child(self, now: Optional[float] = None) -> "TraceContext":
        """The context to stamp on the NEXT egress hop: same identity,
        hop+1, this process's span id as the new parent."""
        return TraceContext(self.request_id, span_id(self.request_id,
                                                     self.hop + 1),
                            self.hop + 1,
                            time.time() if now is None else now)


def span_id(request_id: str, hop: int) -> str:
    """The span id a sender advertises for hop ``hop`` — also the flow
    EDGE id both sides record (sender as ``origin`` without ``parent``,
    receiver as ``origin`` + ``parent``), so the merged Chrome export's
    ``s``/``f`` flow events pair up by construction."""
    return f"{request_id}/h{hop}"


def format_trace_header(ctx: TraceContext) -> str:
    return (f"{ctx.request_id};{ctx.parent};{int(ctx.hop)};"
            f"{ctx.origin_ts:.6f}")


def parse_trace_header(value: Optional[str]) -> Optional[TraceContext]:
    """Parse an ``X-Graft-Trace`` header value; ``None`` for ANY
    malformed input (the ingress contract: degrade to a fresh context,
    never 500, never let attacker-shaped bytes reach trace records).

    Rejected shapes, each fuzz-tested: absent/empty, oversized (> 256
    chars before any parsing), wrong field count, a request id outside
    the server's ``X-Request-Id`` alphabet (no ``/`` — span ids allow
    it, request ids must stay echoable verbatim), span ids outside
    ``[A-Za-z0-9._:/-]{1,128}`` (both cover control characters,
    embedded newlines from obs-folded headers, and non-UTF8 bytes that
    arrive latin-1-decoded), non-integer or overflowed hop counts
    (> 64 means a forwarding loop), and non-finite timestamps."""
    if not value or len(value) > _HEADER_MAX:
        return None
    parts = value.split(";")
    if len(parts) != 4:
        return None
    rid, parent, hop_s, ts_s = parts
    if not _RID_RE.fullmatch(rid):
        return None
    if parent and not _ID_RE.fullmatch(parent):
        return None
    try:
        hop = int(hop_s)
        ts = float(ts_s)
    except ValueError:
        return None
    if not 0 <= hop <= _HOP_MAX or not math.isfinite(ts):
        return None
    return TraceContext(rid, parent, hop, ts)


class ClientTracer:
    """Client-side request spans + egress context: one ``request`` span
    per call —
    send → ``first_byte`` instant → done — into a local
    `FlightRecorder`, stamped with the flow-edge ``origin`` so the
    aggregator's merged trace joins it to the server's spans by an
    arrow, with the network/queue gap between the two measurable."""

    def __init__(self, recorder: Optional[FlightRecorder] = None):
        self.recorder = (recorder if recorder is not None
                         else FlightRecorder(8192))

    def send(self, path: str = "",
             ctx: Optional[TraceContext] = None) -> TraceContext:
        """Open the client span and mint the egress context — a fresh
        trace for a new request, or ``ctx.child()`` when forwarding an
        existing one (the router's shape: hop+1, same identity)."""
        if ctx is None:
            rid = new_trace_id()
            out = TraceContext(rid, span_id(rid, 0), 0, time.time())
        else:
            out = ctx.child()
        self.recorder.begin(
            "request", req=out.request_id, origin=out.parent,
            args={"path": path, "hop": out.hop})
        return out

    def headers(self, ctx: TraceContext) -> Dict[str, str]:
        """The egress headers: the propagated context plus a matching
        ``X-Request-Id`` (servers keep it as the prefix of their
        uniquified id, so logs grep across tiers)."""
        return {TRACE_HEADER: format_trace_header(ctx),
                "X-Request-Id": ctx.request_id}

    def first_byte(self, ctx: TraceContext) -> None:
        self.recorder.instant("first_byte", req=ctx.request_id)

    def done(self, ctx: TraceContext, ok: bool = True,
             args: Optional[dict] = None) -> None:
        a = dict(args or {})
        a.setdefault("ok", bool(ok))
        self.recorder.end("request", req=ctx.request_id, args=a)


# ---------------------------------------------------------------------------
# clock alignment (GET /trace/clock)
# ---------------------------------------------------------------------------

class ClockSync(NamedTuple):
    """One replica's clock placement: ``epoch`` is the aggregator-wall
    instant at which that replica's trace ``ts`` axis reads 0 (so
    ``epoch + ev["ts"]`` puts any of its events on the local wall
    axis), bounded to ±``rtt``/2 by the minimum-RTT probe;
    ``wall_offset`` is the replica's wall clock minus ours (reported,
    not used for alignment — the monotonic pair is skew-proof)."""
    epoch: float
    rtt: float
    wall_offset: float


def _fetch_json(url: str, timeout: float = 5.0) -> dict:
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return json.loads(resp.read())


def _fan_out(fn: Callable, items: List) -> List:
    """Run ``fn`` over ``items`` concurrently, one thread per item,
    results in order (``fn`` must catch its own exceptions). A poll or
    scrape pass over N replicas must cost max(per-target time), not
    the sum — one wedged replica (accepting connections, never
    answering: exactly when telemetry matters most) would otherwise
    stall the whole loop, letting healthy replicas' cursors fall
    behind their rings. Thread.join is the happens-before edge that
    publishes the slots back to the caller."""
    if len(items) <= 1:
        return [fn(x) for x in items]
    out: List = [None] * len(items)

    def run(i: int, x) -> None:
        out[i] = fn(x)

    threads = [threading.Thread(target=run, args=(i, x), daemon=True)
               for i, x in enumerate(items)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return out


def probe_clock(base_url: str, probes: int = 5, timeout: float = 5.0,
                fetch: Callable[[str], dict] = None) -> ClockSync:
    """RTT-bounded clock handshake: hit ``GET /trace/clock`` ``probes``
    times, bracket each response with the LOCAL wall clock, and keep
    the minimum-RTT sample — its midpoint pins the replica's
    (monotonic, trace_t0) pair to our wall axis with error ≤ RTT/2."""
    url = f"{base_url.rstrip('/')}/trace/clock"
    fetch = fetch or (lambda u: _fetch_json(u, timeout))
    best: Optional[ClockSync] = None
    for _ in range(max(1, probes)):
        l0 = time.time()
        c = fetch(url)
        l1 = time.time()
        rtt = l1 - l0
        mid = (l0 + l1) / 2.0
        sync = ClockSync(
            epoch=mid - (float(c["monotonic"]) - float(c["trace_t0"])),
            rtt=rtt,
            wall_offset=float(c["wall"]) - mid)
        if best is None or sync.rtt < best.rtt:
            best = sync
    return best


def local_clock_sync(recorder: FlightRecorder) -> ClockSync:
    """The zero-RTT handshake for an IN-PROCESS recorder (the client
    side of the merge): same math, no HTTP."""
    c = recorder.clock()
    return ClockSync(
        epoch=time.time() - (c["monotonic"] - c["trace_t0"]),
        rtt=0.0, wall_offset=0.0)


# ---------------------------------------------------------------------------
# multi-replica trace merge
# ---------------------------------------------------------------------------

class _TraceSource:
    """One process's tail state: cursor, events fetched so far, drop
    accounting, and its clock placement. ``target`` is a base URL, or
    None for the in-process client recorder."""

    def __init__(self, name: str, target: Optional[str],
                 recorder: Optional[FlightRecorder] = None):
        self.name = name
        self.target = target
        self.recorder = recorder
        self.cursor = 0
        self.dropped = 0
        self.total_recorded = 0
        self.events: List[dict] = []
        self.merged = 0  # events EVER tailed (survives retention trims)
        self.trimmed = 0
        self.clock: Optional[ClockSync] = None
        self.scrape_errors = 0


class TraceAggregator:
    """Tail N replicas' flight recorders into ONE merged, clock-aligned
    Perfetto trace (plus the in-process client recorder, if given).

    Lock discipline: all network I/O happens OUTSIDE ``_lock``; the
    lock only guards the per-source state mutations and the render-side
    copies, so a slow replica can never block a `/fleet/trace` read."""

    def __init__(self, targets: List[str],
                 client_recorder: Optional[FlightRecorder] = None,
                 names: Optional[List[str]] = None,
                 timeout: float = 5.0, max_events: int = 65536):
        self.timeout = float(timeout)
        # per-source retention cap: an always-on aggregator (--serve-
        # port with no --duration) tails BOUNDED replica rings forever,
        # so its own store must be a ring too — beyond the cap the
        # oldest events are trimmed (flight-recorder semantics, counted
        # in stats()["trimmed"], completeness accounting unaffected:
        # trimmed events WERE merged)
        self.max_events = max(1024, int(max_events))
        self._lock = threading.Lock()
        self._sources: List[_TraceSource] = []
        if client_recorder is not None:
            self._sources.append(
                _TraceSource("client", None, client_recorder))
        for i, t in enumerate(targets):
            name = (names[i] if names and i < len(names)
                    else f"replica {i} ({t})")
            self._sources.append(_TraceSource(name, t))

    # -- clock sync --------------------------------------------------------
    def sync_clocks(self, probes: int = 5) -> Dict[str, ClockSync]:
        """Handshake every source; returns name -> ClockSync. A replica
        that cannot be reached keeps ``clock=None`` (its events are
        excluded from the merge until a later sync succeeds) and counts
        a scrape error."""
        out = {}
        for src in self._sources:
            try:
                sync = (local_clock_sync(src.recorder)
                        if src.target is None
                        else probe_clock(src.target, probes,
                                         self.timeout))
            except Exception:
                with self._lock:
                    src.scrape_errors += 1
                continue
            with self._lock:
                src.clock = sync
            out[src.name] = sync
        return out

    # -- polling -----------------------------------------------------------
    def poll(self) -> int:
        """One tail pass over every source (``GET /trace?since=cursor``
        / the in-process equivalent). Appends new events, advances
        cursors, and inserts a ``ring_dropped`` gap marker on any
        source whose ring overwrote events since the last poll.
        Returns the number of events fetched across all sources."""

        def fetch(src: _TraceSource):
            try:
                if src.target is None:
                    return src.recorder.export(since=src.cursor)
                return _fetch_json(
                    f"{src.target.rstrip('/')}/trace"
                    f"?since={src.cursor}", self.timeout)
            except Exception:
                return None

        fetched = 0
        for src, snap in zip(self._sources,
                             _fan_out(fetch, self._sources)):
            if snap is None:
                with self._lock:
                    src.scrape_errors += 1
                continue
            evs = snap.get("events", [])
            with self._lock:
                # a hole is NOT the server's cumulative `dropped` (a
                # frequent poller tails events before the ring
                # overwrites them, so server-side drops can be fully
                # covered) — it is the cursor falling BEHIND the ring:
                # the oldest surviving event past our cursor means
                # (first_seq - cursor) events were overwritten before
                # this poll could fetch them. Perfetto shows WHERE the
                # history hole is instead of silently eliding it.
                missed = (evs[0]["seq"] - src.cursor
                          if evs and evs[0]["seq"] > src.cursor else 0)
                if missed > 0:
                    src.dropped += missed
                    src.events.append({
                        "ts": evs[0]["ts"], "ph": "i",
                        "name": "ring_dropped", "track": "ring gap",
                        "args": {"dropped_delta": missed,
                                 "dropped_total": src.dropped}})
                src.events.extend(evs)
                src.merged += len(evs)
                if len(src.events) > self.max_events:
                    cut = len(src.events) - self.max_events
                    del src.events[:cut]
                    src.trimmed += cut
                src.cursor = int(snap.get("next_cursor", src.cursor))
                src.total_recorded = int(
                    snap.get("total_recorded", src.total_recorded))
            fetched += len(evs)
        return fetched

    # -- render ------------------------------------------------------------
    def merged_chrome_trace(self) -> dict:
        """ONE Perfetto-loadable trace: a track group (pid) per
        process, every event's ``ts`` moved onto the aggregator's wall
        axis via that process's clock sync (so one request's
        client/server/replica spans line up as a single waterfall,
        with the inter-tier queue gap readable off the timeline), flow
        arrows from the propagated ``origin``/``parent`` fields, and
        ``ring_dropped`` instants marking trace holes."""
        with self._lock:
            snaps = [(src.name, src.clock, list(src.events))
                     for src in self._sources]
        procs = [(name, clock, evs) for name, clock, evs in snaps
                 if clock is not None and evs]
        base = min((clock.epoch + min(ev["ts"] for ev in evs)
                    for _, clock, evs in procs), default=0.0)
        out: List[dict] = []
        meta: List[dict] = []
        for pid, (name, clock, evs) in enumerate(procs):
            shift = clock.epoch - base
            # max(0, ·): base is the min over (epoch + ts) computed in
            # a different float association than (ts + shift), so the
            # globally-first event can land one ulp below zero
            shifted = sorted(
                (dict(ev, ts=max(0.0, ev["ts"] + shift)) for ev in evs),
                key=lambda e: e["ts"])
            tids: Dict[str, tuple] = {}

            def tid_of(track: str, _pid=pid, _tids=tids) -> tuple:
                if track not in _tids:
                    _tids[track] = (_pid, len(_tids) + 1)
                return _tids[track]

            render_chrome_events(shifted, tid_of, out)
            meta.append({"name": "process_name", "ph": "M", "pid": pid,
                         "tid": 0, "args": {"name": name}})
            meta += [{"name": "thread_name", "ph": "M", "pid": p,
                      "tid": t, "args": {"name": track}}
                     for track, (p, t) in sorted(tids.items())]
        return {"displayTimeUnit": "ms", "traceEvents": meta + out}

    def stats(self) -> dict:
        """Merge accounting: per-source events/drops/clock quality and
        the completeness ratio (events_merged / events_emitted; 1.0
        when no ring wrapped between polls)."""
        with self._lock:
            per = [{"name": src.name,
                    "events": src.merged,
                    "dropped": src.dropped,
                    "trimmed": src.trimmed,
                    "scrape_errors": src.scrape_errors,
                    "clock_rtt_ms": (round(src.clock.rtt * 1e3, 3)
                                     if src.clock else None),
                    "wall_offset_ms": (
                        round(src.clock.wall_offset * 1e3, 3)
                        if src.clock else None),
                    "total_recorded": src.total_recorded}
                   for src in self._sources]
        merged = sum(p["events"] for p in per)
        emitted = sum(p["total_recorded"] for p in per)
        return {"sources": per, "events_merged": merged,
                "events_emitted": emitted,
                "completeness": (round(merged / emitted, 6)
                                 if emitted else 1.0),
                "dropped_total": sum(p["dropped"] for p in per),
                "trimmed_total": sum(p["trimmed"] for p in per)}


# ---------------------------------------------------------------------------
# Prometheus exposition parsing + federation
# ---------------------------------------------------------------------------

# one sample line: name, optional {label set}, value (exemplars are
# stripped before matching). Regex-based on purpose: the federation
# scrapes re-parse every replica's full exposition each pass, and a
# char-loop parser costs GIL time the replicas' scheduler threads need
_SAMPLE_RE = re.compile(
    r"([A-Za-z_:][A-Za-z0-9_:]*)(\{.*\})?\s+(\S+)")
_LABEL_RE = re.compile(r'([A-Za-z_][A-Za-z0-9_]*)="((?:[^"\\]|\\.)*)"')
_UNESCAPE_RE = re.compile(r"\\(.)")


def _parse_labels(s: str) -> Dict[str, str]:
    """Inner of a ``{...}`` label set, honoring backslash escapes in
    quoted values (the inverse of `metrics._escape_label`)."""
    out: Dict[str, str] = {}
    for key, raw in _LABEL_RE.findall(s):
        out[key] = (_UNESCAPE_RE.sub(
            lambda m: {"n": "\n"}.get(m.group(1), m.group(1)), raw)
            if "\\" in raw else raw)
    return out


def parse_prometheus(text: str) -> dict:
    """Parse a Prometheus/OpenMetrics exposition into federation-ready
    state: ``counters``/``gauges`` map canonical series key -> (base
    name, value); ``histograms`` map the le-less series key -> a
    `merge_histograms`-shaped snapshot dict (cumulative buckets
    de-cumulated, ``+Inf`` folded into the overflow slot) plus its
    base name and labels. ``# TYPE`` lines are the classification
    authority (OpenMetrics counter families drop the ``_total`` suffix
    there; sample lines keep it). Exemplars (`` # {...} v ts``) are
    stripped."""
    types: Dict[str, str] = {}
    counters: Dict[str, tuple] = {}
    gauges: Dict[str, tuple] = {}
    hists: Dict[str, dict] = {}

    def _hist_family(name: str, suffix: str) -> Optional[str]:
        if not name.endswith(suffix):
            return None
        fam = name[: -len(suffix)]
        return fam if types.get(fam) == "histogram" else None

    for line in text.splitlines():
        if not line:
            continue
        if line[0] == "#":
            parts = line.split(None, 3)
            if len(parts) >= 4 and parts[1] == "TYPE":
                types[parts[2]] = parts[3].strip()
            continue
        body = (line.split(" # ", 1)[0] if " # " in line
                else line)  # strip OM exemplar
        m = _SAMPLE_RE.match(body)
        if m is None:
            continue
        name, label_blob, val_s = m.groups()
        labels = _parse_labels(label_blob[1:-1]) if label_blob else {}
        value = float(val_s)
        fam = _hist_family(name, "_bucket")
        if fam and "le" in labels:
            le = labels.pop("le")
            h = hists.setdefault(series_key(fam, labels), {
                "name": fam, "labels": dict(labels),
                "bounds": [], "cum": [], "inf": 0.0,
                "sum": 0.0, "count": 0})
            if le == "+Inf":
                h["inf"] = value
            else:
                h["bounds"].append(float(le))
                h["cum"].append(value)
            continue
        fam = _hist_family(name, "_sum")
        if fam:
            h = hists.setdefault(series_key(fam, labels), {
                "name": fam, "labels": dict(labels), "bounds": [],
                "cum": [], "inf": 0.0, "sum": 0.0, "count": 0})
            h["sum"] = value
            continue
        fam = _hist_family(name, "_count")
        if fam:
            h = hists.setdefault(series_key(fam, labels), {
                "name": fam, "labels": dict(labels), "bounds": [],
                "cum": [], "inf": 0.0, "sum": 0.0, "count": 0})
            h["count"] = int(value)
            continue
        kind = types.get(name) or (
            "counter" if name.endswith("_total")
            and types.get(name[:-6]) == "counter" else None)
        if kind is None:
            kind = "counter" if name.endswith("_total") else "gauge"
        key = series_key(name, labels)
        if kind == "counter":
            counters[key] = (name, value)
        else:
            gauges[key] = (name, value)
    # cumulative -> per-bucket counts (+ overflow), merge-ready
    for h in hists.values():
        cum = h.pop("cum")
        inf = h.pop("inf")
        counts = [cum[0] if cum else inf]
        counts += [cum[i] - cum[i - 1] for i in range(1, len(cum))]
        if cum:
            counts.append(inf - cum[-1])
        h["counts"] = [max(0, int(round(c))) for c in counts]
        if not h["count"]:
            h["count"] = int(inf)
    return {"types": types, "counters": counters, "gauges": gauges,
            "histograms": hists}


# federation semantics for a gauge family, by name shape. ADDITIVE
# gauges (queue depths, pool blocks, byte budgets, per-second
# throughputs) sum; NON-additive ones — burn rates, ratios, estimates,
# latencies, levels, high-water ``_max`` marks — must NOT: three
# replicas each at burn 0.5 summing to a fleet burn of 1.5 would fire
# a "burning" alert on a calm fleet under the exact series name
# dashboards already watch. Those federate as the fleet MAX (the worst
# replica — what an alert on that family means fleet-wide);
# ``serving_ready`` as the MIN (the fleet is ready only if every
# replica is).
_GAUGE_MAX_NAMES = frozenset({"slo_burn_rate_fast",
                              "slo_burn_rate_slow", "uptime_sec"})
_NON_ADDITIVE_SUFFIXES = ("_rate", "_ratio", "_estimate", "_level",
                          "_ms", "_sec", "_utilization", "_max")


def _gauge_agg(name: str) -> str:
    if name == "serving_ready":
        return "min"
    if name in _GAUGE_MAX_NAMES:
        return "max"
    if name.endswith("_per_sec") or name.endswith("_gbps"):
        return "sum"  # throughputs are additive across replicas
    if name.endswith(_NON_ADDITIVE_SUFFIXES):
        return "max"
    return "sum"


class FleetMetrics:
    """Scrape N replicas' Prometheus expositions and federate them into
    one fleet view: counters sum; additive gauges sum while
    non-additive families (rates, ratios, estimates, latencies,
    ``_max`` marks) take the fleet max — the worst replica — and
    ``serving_ready`` the fleet min (see :func:`_gauge_agg`);
    histograms merge bucket-wise
    (`merge_histograms`, boundary-checked), per-route fleet p50/p95/p99
    come from the MERGED buckets, and fleet burn rates are the
    replicas' burn gauges weighted by their share of traffic since the
    previous scrape (a hot replica's burn must not be diluted by an
    idle one — "which replica is burning" stays answerable from the
    per-replica block of :meth:`summary`)."""

    def __init__(self, targets: List[str],
                 names: Optional[List[str]] = None,
                 timeout: float = 5.0,
                 fast_burn: float = 6.0, slow_burn: float = 3.0):
        self.targets = list(targets)
        self.names = [names[i] if names and i < len(names) else t
                      for i, t in enumerate(targets)]
        self.timeout = float(timeout)
        self.fast_burn = float(fast_burn)
        self.slow_burn = float(slow_burn)
        self._lock = threading.Lock()
        self._parsed: List[Optional[dict]] = [None] * len(targets)
        self._up: List[bool] = [False] * len(targets)
        self._prev_http: List[float] = [0.0] * len(targets)
        self._weights: List[float] = [0.0] * len(targets)
        self.scrape_errors_total = 0

    @staticmethod
    def _http_count(parsed: dict) -> float:
        return sum(h["count"] for h in parsed["histograms"].values()
                   if h["name"] == "http_route_latency_seconds")

    def scrape(self) -> int:
        """One federation pass (network OUTSIDE the lock, targets
        fetched concurrently — see :func:`_fan_out`). Returns how many
        replicas answered."""

        def fetch(t: str) -> Optional[dict]:
            try:
                url = f"{t.rstrip('/')}/metrics?format=prometheus"
                with urllib.request.urlopen(
                        url, timeout=self.timeout) as resp:
                    return parse_prometheus(
                        resp.read().decode("utf-8", "replace"))
            except Exception:
                return None

        results = _fan_out(fetch, self.targets)
        with self._lock:
            for i, parsed in enumerate(results):
                self._up[i] = parsed is not None
                if parsed is None:
                    self.scrape_errors_total += 1
                    self._weights[i] = 0.0
                    continue
                cur = self._http_count(parsed)
                # traffic since the previous scrape: the burn-rate
                # weight (first scrape weights by absolute count)
                self._weights[i] = max(0.0, cur - self._prev_http[i])
                self._prev_http[i] = cur
                self._parsed[i] = parsed
        return sum(1 for r in results if r is not None)

    # -- federation --------------------------------------------------------
    def federate(self) -> dict:
        """The merged fleet state (pure function of the last scrape):
        summed counters, aggregated gauges, merged histograms, fleet
        route quantiles, weighted burn rates, and replica liveness."""
        with self._lock:
            parsed = list(self._parsed)
            up = list(self._up)
            weights = list(self._weights)
            errors = self.scrape_errors_total
        counters: Dict[str, float] = {}
        counter_names: Dict[str, str] = {}
        gauges: Dict[str, float] = {}
        gauge_names: Dict[str, str] = {}
        hist_groups: Dict[str, List[dict]] = {}
        hist_meta: Dict[str, tuple] = {}
        live = [p for i, p in enumerate(parsed) if p is not None
                and up[i]]
        for p in live:
            for key, (name, v) in p["counters"].items():
                counters[key] = counters.get(key, 0.0) + v
                counter_names[key] = name
            for key, (name, v) in p["gauges"].items():
                agg = _gauge_agg(name)
                if agg == "sum":
                    gauges[key] = gauges.get(key, 0.0) + v
                elif agg == "min":
                    gauges[key] = min(gauges.get(key, math.inf), v)
                else:
                    gauges[key] = max(gauges.get(key, -math.inf), v)
                gauge_names[key] = name
            for key, h in p["histograms"].items():
                hist_groups.setdefault(key, []).append(h)
                hist_meta[key] = (h["name"], h["labels"])
        merged_hists = {key: merge_histograms(group)
                        for key, group in hist_groups.items()}
        # fleet burn rates: traffic-weighted mean of the replicas' own
        # windowed burn gauges (bucketed cumulative histograms cannot
        # reproduce a sliding window, so the replicas' windowed numbers
        # are the right primary source — weighting keeps an idle
        # replica from averaging a burning one back under threshold)
        fast = slow = 0.0
        wsum = 0.0
        for i, p in enumerate(parsed):
            if p is None or not up[i]:
                continue
            g = p["gauges"]
            f = g.get("slo_burn_rate_fast", (None, 0.0))[1]
            s = g.get("slo_burn_rate_slow", (None, 0.0))[1]
            w = weights[i] if weights[i] > 0 else 1.0
            fast += w * f
            slow += w * s
            wsum += w
        fast = fast / wsum if wsum else 0.0
        slow = slow / wsum if wsum else 0.0
        routes = {}
        for key, m in merged_hists.items():
            name, labels = hist_meta[key]
            if name == "http_route_latency_seconds" and m.get("count"):
                routes[labels.get("route", key)] = {
                    "count": m["count"],
                    "p50_ms": round(m["p50"] * 1e3, 3),
                    "p95_ms": round(m["p95"] * 1e3, 3),
                    "p99_ms": round(m["p99"] * 1e3, 3)}
        return {
            "replicas_total": len(self.targets),
            "replicas_up": sum(up),
            "scrape_errors_total": errors,
            "burn_rate_fast": round(fast, 4),
            "burn_rate_slow": round(slow, 4),
            "burning": burn_verdict(fast, slow, self.fast_burn,
                                    self.slow_burn)[0],
            "routes": routes,
            "counters": counters, "counter_names": counter_names,
            "gauges": gauges, "gauge_names": gauge_names,
            "histograms": merged_hists, "histogram_meta": hist_meta,
        }

    def render_prometheus(self) -> str:
        """The federated exposition (`GET /fleet`): fleet liveness and
        SLO headline first, then every merged family — Prometheus 0.0.4
        text (full family names, no exemplars: exemplar→trace links
        stay per-replica where the rings live)."""
        fed = self.federate()
        lines = [
            "# TYPE fleet_replicas_up gauge",
            f"fleet_replicas_up {fed['replicas_up']}",
            "# TYPE fleet_replicas_total gauge",
            f"fleet_replicas_total {fed['replicas_total']}",
            "# TYPE fleet_scrape_errors_total counter",
            f"fleet_scrape_errors_total {fed['scrape_errors_total']}",
            "# TYPE fleet_slo_burn_rate_fast gauge",
            f"fleet_slo_burn_rate_fast {fed['burn_rate_fast']}",
            "# TYPE fleet_slo_burn_rate_slow gauge",
            f"fleet_slo_burn_rate_slow {fed['burn_rate_slow']}",
        ]
        for q in ("p50", "p95", "p99"):
            lines.append(f"# TYPE fleet_route_{q}_ms gauge")
            for route, r in sorted(fed["routes"].items()):
                lines.append(
                    f"{series_key(f'fleet_route_{q}_ms', {'route': route})}"
                    f" {r[f'{q}_ms']}")
        typed = set()

        def head(name: str, kind: str) -> None:
            if name not in typed:
                typed.add(name)
                lines.append(f"# TYPE {name} {kind}")

        def num(v: float) -> str:
            # full precision, integers rendered as integers: %g would
            # quantize a summed token counter to 6 significant digits,
            # making rate() over /fleet freeze-then-jump while each
            # replica's own exposition stays exact
            return str(int(v)) if float(v).is_integer() else repr(v)

        for key in sorted(fed["counters"]):
            head(fed["counter_names"][key], "counter")
            lines.append(f"{key} {num(fed['counters'][key])}")
        for key in sorted(fed["gauges"]):
            head(fed["gauge_names"][key], "gauge")
            lines.append(f"{key} {num(fed['gauges'][key])}")
        for key in sorted(fed["histograms"]):
            m = fed["histograms"][key]
            name, _labels = fed["histogram_meta"][key]
            head(name, "histogram")
            if "bounds" not in m:
                continue  # merged-empty family
            from ..inference.metrics import _with_label, _suffixed
            cum = 0
            for bound, c in zip(list(m["bounds"]) + ["+Inf"],
                                m["counts"]):
                cum += c
                le = bound if bound == "+Inf" else f"{bound:.9g}"
                lines.append(
                    _with_label(key, name, f'le="{le}"', "_bucket")
                    + f" {cum}")
            lines.append(f"{_suffixed(key, name, '_sum')} "
                         f"{round(m.get('sum', 0.0), 9)}")
            lines.append(f"{_suffixed(key, name, '_count')} "
                         f"{m.get('count', 0)}")
        return "\n".join(lines) + "\n"

    def summary(self) -> dict:
        """The JSON headline (`GET /fleet/summary`, the UI fleet line,
        the CLI's end-of-run print): fleet liveness, burn, per-route
        fleet percentiles, and the per-replica block that answers
        "which replica is burning"."""
        fed = self.federate()
        with self._lock:
            parsed = list(self._parsed)
            up = list(self._up)
        replicas = []
        for i, name in enumerate(self.names):
            entry = {"target": self.targets[i], "name": name,
                     "up": up[i]}
            p = parsed[i]
            if p is not None:
                g = p["gauges"]
                entry["burn_rate_fast"] = g.get(
                    "slo_burn_rate_fast", (None, 0.0))[1]
                entry["burn_rate_slow"] = g.get(
                    "slo_burn_rate_slow", (None, 0.0))[1]
                for key, (gname, v) in g.items():
                    if gname == "slo_route_p99_ms":
                        route = _parse_labels(key).get("route", "all")
                        entry.setdefault("route_p99_ms", {})[route] = v
            replicas.append(entry)
        return {k: fed[k] for k in
                ("replicas_total", "replicas_up", "scrape_errors_total",
                 "burn_rate_fast", "burn_rate_slow", "burning",
                 "routes")} | {"replicas": replicas}


# ---------------------------------------------------------------------------
# the /fleet exposition server + CLI
# ---------------------------------------------------------------------------

class FleetTelemetryServer:
    """Tiny read-only HTTP front for a running aggregator+federation
    pair: ``GET /fleet`` (federated Prometheus exposition),
    ``GET /fleet/summary`` (JSON), ``GET /fleet/trace`` (the merged
    Perfetto trace so far). Polling/scraping cadence belongs to the
    CLI loop, not this server — a scrape storm of /fleet reads must
    not multiply load on the replicas."""

    def __init__(self, fleet: FleetMetrics,
                 aggregator: Optional[TraceAggregator] = None,
                 port: int = 0):
        self.fleet = fleet
        self.aggregator = aggregator
        self._port = port
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self._httpd.server_address[1] if self._httpd else self._port

    def start(self) -> "FleetTelemetryServer":
        srv = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):
                pass

            def _send(self, body: bytes, content_type: str,
                      code: int = 200) -> None:
                self.send_response(code)
                self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path.split("?")[0] == "/fleet":
                    self._send(srv.fleet.render_prometheus().encode(),
                               "text/plain; version=0.0.4; charset=utf-8")
                elif self.path.split("?")[0] == "/fleet/summary":
                    body = srv.fleet.summary()
                    if srv.aggregator is not None:
                        body["trace"] = srv.aggregator.stats()
                    self._send(json.dumps(body).encode(),
                               "application/json")
                elif (self.path.split("?")[0] == "/fleet/trace"
                        and srv.aggregator is not None):
                    self._send(json.dumps(
                        srv.aggregator.merged_chrome_trace()).encode(),
                        "application/json")
                else:
                    self._send(b'{"error": "not found"}',
                               "application/json", 404)

        self._httpd = ThreadingHTTPServer(("127.0.0.1", self._port),
                                          Handler)
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None


def main(argv: Optional[List[str]] = None) -> int:
    import argparse

    p = argparse.ArgumentParser(
        prog="python -m deeplearning4j_tpu_torch.serving.telemetry",
        description="Fleet telemetry: tail N replicas' traces into one "
                    "Perfetto waterfall and federate their metrics/SLO")
    p.add_argument("--targets", required=True,
                   help="comma-separated replica base URLs "
                        "(http://host:port)")
    p.add_argument("--out", default=None,
                   help="write the merged Perfetto trace here at exit")
    p.add_argument("--serve-port", type=int, default=None,
                   help="expose GET /fleet (federated Prometheus "
                        "exposition), /fleet/summary, /fleet/trace")
    p.add_argument("--interval", type=float, default=1.0,
                   help="poll/scrape cadence, seconds")
    p.add_argument("--duration", type=float, default=None,
                   help="run this long then exit (default: one pass "
                        "without --serve-port, forever with it)")
    p.add_argument("--clock-probes", type=int, default=5,
                   help="RTT-bounded /trace/clock probes per replica")
    p.add_argument("--ui", default=None,
                   help="training-UI base URL: push the fleet summary "
                        "line to its /serving page each poll (not ported "
                        "yet: raises)")
    args = p.parse_args(argv)
    if args.ui:
        # refused up front, not skipped: a push that silently never
        # happens would read as a calm fleet on the UI
        raise NotImplementedError(
            "telemetry --ui pushes to the training UI's /serving page, "
            "which the port does not have yet (ROADMAP A9: ui/)")

    targets = [t.strip() for t in args.targets.split(",") if t.strip()]
    if not targets:
        print("error: --targets is empty", file=sys.stderr)
        return 2
    agg = TraceAggregator(targets)
    fleet = FleetMetrics(targets)
    synced = agg.sync_clocks(args.clock_probes)
    print(f"clock sync: {len(synced)}/{len(targets)} replicas "
          + ", ".join(f"{n}: rtt {s.rtt * 1e3:.2f}ms "
                      f"(offset {s.wall_offset * 1e3:+.2f}ms)"
                      for n, s in synced.items()), file=sys.stderr)
    server = None
    if args.serve_port is not None:
        server = FleetTelemetryServer(fleet, agg,
                                      port=args.serve_port).start()
        print(f"fleet exposition on http://127.0.0.1:{server.port}"
              "/fleet (also /fleet/summary, /fleet/trace)",
              file=sys.stderr)
    deadline = (time.monotonic() + args.duration
                if args.duration is not None
                else (math.inf if server else time.monotonic()))
    try:
        while True:
            agg.poll()
            fleet.scrape()
            if time.monotonic() >= deadline:
                break
            time.sleep(args.interval)
    except KeyboardInterrupt:
        pass
    finally:
        if server is not None:
            server.stop()
    if args.out:
        trace = agg.merged_chrome_trace()
        with open(args.out, "w") as fh:
            json.dump(trace, fh)
        n = len(trace.get("traceEvents", []))
        print(f"{args.out}: {n} merged events (open at "
              "https://ui.perfetto.dev)", file=sys.stderr)
    print(json.dumps({"fleet": fleet.summary(),
                      "trace": agg.stats()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
