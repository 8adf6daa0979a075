"""Request-lifecycle tracing: a span flight recorder for the serving stack —
the port's copy of deeplearning4j_tpu/inference/trace.py.

Host-only (no torch), kept record for record and export for export with
the JAX package's module, so one package's traces merge with the other's.

Metrics answer "how is the fleet doing"; they cannot answer "where did
THIS request's time go": a p99 time to first token may be queueing,
waiting for a free slot, missing the prefix cache, or sitting behind
another slot's prefill chunks. This module is per-request causality,
cheap enough to stay on in production.

Design: a process-wide **flight recorder** — a fixed-capacity ring buffer
of span/event records. Appends are O(1) and lock-free:

  - the ring is preallocated (``[None] * capacity``) and never grows; an
    append builds ONE record tuple and stores it at ``seq % capacity``,
    overwriting the oldest record (flight-recorder semantics: the last N
    events always survive, history beyond that is intentionally lost);
  - the sequence numbers come from ``itertools.count()``, whose
    ``__next__`` is atomic in CPython — concurrent writers (HTTP handler
    threads, the scheduler loop) each claim a distinct slot with no lock
    at all. Two writers a full ``capacity`` apart may target the same
    ring index; the younger record wins, which is exactly the overwrite
    semantics the ring already has. List item assignment is atomic, so
    a reader never observes a torn record.

Record taxonomy (the span tree every request gets from the decode
engine, `inference/engine.py`):

  ``queued`` -> ``admit``(slot) -> ``prefix_restore``(hit_tokens) ->
  ``prefill`` [with per-chunk ``prefill_chunk``(bucket) spans on the slot
  track] -> ``decode``(iterations, tokens) -> ``finish``/``cancel``;
  plus scheduler-level instants: slot ``admit``/``free`` occupancy
  changes, ``pool_evict``/``pool_publish`` from the KV pool, ``capture``
  where the engine builds a decode step's static buffers (and, on the
  card, captures its CUDA graph), and ``reject`` instants for
  backpressure.

  Paged-KV engines add block-lifecycle instants on the slot tracks —
  ``block_alloc``, ``block_cow``, ``preempt``/``resume`` — and a
  ``preempted`` span on the request track bridging the swap gap.

Tracks: every record resolves to a named track at append time — a slot
track (``slot N``), a request track (``request <id>``), or a named
component track (``scheduler``, ``kvpool``). The Chrome trace-event
export groups slot tracks under one process and request tracks under
another, so Perfetto renders the serving waterfall: one row per slot
showing interleaved prefill chunks, one row per request showing its
queued/prefill/decode life.

Exports:
  - ``snapshot(limit)``    -> JSON-able dict; ``snapshot(since=cursor)``
                              / ``export(since=)`` tail the ring
                              incrementally — every response carries a
                              ``next_cursor`` the next poll passes back
  - ``chrome_trace(limit)``-> Chrome trace-event JSON, Perfetto-loadable;
                              every ``B`` is closed by a matching ``E``
                              even when the ring wrapped mid-span, and
                              ``ts`` is monotonic per track
  - ``request_summaries(limit)`` -> per-request phase timings
  - ``python -m deeplearning4j_tpu_torch.inference.trace dump --url ...``
                              fetches a serving server's Chrome trace to
                              a file for Perfetto's "Open trace file"

Cross-process context: records carry optional ``parent``/``origin``
fields — ``origin`` is a flow-edge id, ``parent`` the upstream process's
span id, present only on the receiving side. The Chrome export turns
them into flow events, so a trace merged from several processes draws
one arrowed waterfall per request; :meth:`FlightRecorder.clock` is the
monotonic-epoch + wall handshake that puts N processes' timestamps on
one axis.
"""
from __future__ import annotations

import itertools
import json
import sys
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

__all__ = ["FlightRecorder", "default_recorder", "new_request_id",
           "render_chrome_events"]

# record tuple layout (kept positional: one tuple alloc per append);
# _PARENT/_ORIGIN are the cross-process trace-context fields, None for
# every purely-local record
_SEQ, _TS, _PH, _NAME, _TRACK, _ARGS, _PARENT, _ORIGIN = range(8)

_rid_counter = itertools.count(1)


def new_request_id() -> str:
    """Process-unique request id (``r000001``, ...): claimed lock-free
    from an `itertools.count`, same atomicity argument as the ring."""
    return f"r{next(_rid_counter):06d}"


class FlightRecorder:
    """Fixed-capacity ring buffer of span begin/end and instant events.

    ``capacity``: how many records the ring holds (oldest overwritten
    first). ``capacity <= 0`` or ``enabled=False`` builds a disabled
    recorder whose append methods return immediately — the hot-path cost
    of tracing-off is one attribute test.
    """

    def __init__(self, capacity: int = 8192, *, enabled: bool = True):
        self.capacity = max(0, int(capacity))
        self.enabled = bool(enabled) and self.capacity > 0
        self._buf: List[Optional[tuple]] = [None] * self.capacity
        self._seq = itertools.count()
        self._scopes: Dict[str, int] = {}
        self._t0 = time.monotonic()

    def track_scope(self, kind: str) -> str:
        """Track-name suffix disambiguating multiple instances of one
        component kind writing to the SAME recorder (two per-signature
        batchers, two schedulers on the process-wide recorder): the
        first claimant gets "" (the pretty bare track names), later ones
        " (2)", " (3)", ... — without this, same-name spans from two
        writers interleave on one track and the export's LIFO pairing
        crosses their begin/ends. Called at component construction, not
        on the hot path."""
        n = self._scopes.get(kind, 0) + 1
        self._scopes[kind] = n
        return "" if n == 1 else f" ({n})"

    # -- hot path ----------------------------------------------------------
    def _append(self, ph: str, name: str, req: Optional[str],
                slot: Optional[int], track: Optional[str],
                args: Optional[dict], parent: Optional[str] = None,
                origin: Optional[str] = None) -> None:
        if track is None:
            if slot is not None:
                track = f"slot {slot}"
            elif req is not None:
                track = f"request {req}"
            else:
                track = "scheduler"
        seq = next(self._seq)  # atomic claim; no lock
        self._buf[seq % self.capacity] = (
            seq, time.monotonic(), ph, name, track, args, parent, origin)

    def begin(self, name: str, req: Optional[str] = None,
              slot: Optional[int] = None, track: Optional[str] = None,
              args: Optional[dict] = None, parent: Optional[str] = None,
              origin: Optional[str] = None) -> None:
        """Open a span on the resolved track (close with :meth:`end`).

        ``origin``: the flow-edge id this span belongs to (a hop's
        sender span id, derived from the fleet-wide ``X-Graft-Trace``
        identity) — the Chrome export emits a flow event binding the
        span into the cross-process request chain. ``parent``: the
        upstream process's span id; set (alongside ``origin``) on the
        RECEIVING side of a hop, absent on the originating side, so
        the export knows which side is the arrow's tail (``s``) and
        which the head (``f``)."""
        if self.enabled:
            self._append("B", name, req, slot, track, args, parent, origin)

    def end(self, name: str, req: Optional[str] = None,
            slot: Optional[int] = None, track: Optional[str] = None,
            args: Optional[dict] = None) -> None:
        if self.enabled:
            self._append("E", name, req, slot, track, args)

    def instant(self, name: str, req: Optional[str] = None,
                slot: Optional[int] = None, track: Optional[str] = None,
                args: Optional[dict] = None) -> None:
        if self.enabled:
            self._append("i", name, req, slot, track, args)

    def clock(self) -> dict:
        """Monotonic-epoch + wall handshake pair (``GET /trace/clock``):
        event ``ts`` values are seconds since this recorder's monotonic
        ``trace_t0``, so an aggregator that reads (monotonic, wall,
        trace_t0) in one response — and brackets the request with its
        OWN wall clock for an RTT bound — can place every event of this
        process on its local wall axis to within ±RTT/2."""
        return {"monotonic": time.monotonic(), "wall": time.time(),
                "trace_t0": self._t0}

    # -- read side ---------------------------------------------------------
    def _records(self) -> List[tuple]:
        """Surviving raw records, ts-ordered (seq breaks ties): one
        lock-free list copy, then sort — records written while copying
        either make it in whole or not at all (item assignment is
        atomic), never torn. Sorted by TIMESTAMP: seq claim and
        `time.monotonic()` stamp are two steps, so a preempted writer
        can hold an older seq with a newer ts — ts order is the true
        temporal order the exports guarantee per track."""
        recs = [r for r in list(self._buf) if r is not None]
        recs.sort(key=lambda r: (r[_TS], r[_SEQ]))
        return recs

    def _to_dicts(self, recs: List[tuple]) -> List[dict]:
        out = []
        for r in recs:
            e = {"seq": r[_SEQ], "ts": round(r[_TS] - self._t0, 6),
                 "ph": r[_PH], "name": r[_NAME], "track": r[_TRACK]}
            if r[_ARGS]:
                e["args"] = r[_ARGS]
            if r[_PARENT]:
                e["parent"] = r[_PARENT]
            if r[_ORIGIN]:
                e["origin"] = r[_ORIGIN]
            out.append(e)
        return out

    def events(self, limit: Optional[int] = None) -> List[dict]:
        """The surviving records, oldest first, as JSON-able dicts.
        ``limit`` keeps only the newest N."""
        recs = self._records()
        if limit is not None and limit > 0:
            recs = recs[-limit:]
        return self._to_dicts(recs)

    def snapshot(self, limit: Optional[int] = None,
                 since: Optional[int] = None) -> dict:
        """``GET /trace`` body: the events plus ring accounting (how many
        records ever written, how many the ring has since overwritten).

        ``since``: incremental-tail cursor — only events with ``seq >=
        since`` are returned, and the response's ``next_cursor`` is what
        the next poll should pass as ``since`` (`GET /trace?since=N`):
        the UI and external pollers tail the ring in O(new events)
        instead of re-downloading the whole buffer each poll. A cursor
        that fell behind the ring (older than ``total_recorded -
        capacity``) silently returns the oldest surviving events — the
        ``dropped`` delta tells the poller what it missed.

        Best-effort like every read of this lock-free ring: seq claim
        and slot store are two steps, so a writer preempted between
        them holds a seq BELOW a later writer's already-visible record;
        a poll snapshotting in that sub-microsecond window advances
        ``next_cursor`` past the in-flight seq and the tail never
        delivers it (the same class of loss as ring overwrite — the
        recorder trades completeness for its zero-lock hot path, and a
        full re-download shows the record).

        Cursor tails really are O(new events): records behind the
        cursor are dropped at the raw-tuple stage, BEFORE any dict
        building — a 20 Hz fleet poller against a full 8192-slot ring
        pays for what changed, not the whole buffer: scraping must not
        perturb the engines."""
        recs = self._records()
        total = (max(r[_SEQ] for r in recs) + 1) if recs else 0
        cursor = total
        if since is not None and since >= 0:
            # since=0 is the documented INITIAL cursor and must take
            # this branch: falling through to the legacy newest-N limit
            # semantics would silently skip the oldest events on the
            # very first page of a tail
            recs = [r for r in recs if r[_SEQ] >= since]
            if limit is not None and 0 < limit < len(recs):
                # cursor mode pages FORWARD: keep the OLDEST N so the
                # next poll's since resumes exactly after the last
                # returned event — keeping the newest N here (the
                # legacy limit semantics) would silently skip the
                # middle of a burst and next_cursor would paper over it
                recs = recs[:limit]
                cursor = max(r[_SEQ] for r in recs) + 1
        elif limit is not None and limit > 0:
            recs = recs[-limit:]
        return {"capacity": self.capacity, "total_recorded": total,
                "dropped": max(0, total - self.capacity),
                "next_cursor": cursor,
                "events": self._to_dicts(recs)}

    def export(self, since: Optional[int] = None,
               limit: Optional[int] = None) -> dict:
        """Cursor-first alias of :meth:`snapshot` for programmatic
        pollers: ``cur = 0;  while ...: batch = tracer.export(since=cur);
        cur = batch["next_cursor"]`` tails the ring incrementally."""
        return self.snapshot(limit=limit, since=since)

    def clear(self) -> None:
        """Reset the ring (tests / between bench rounds). Not safe
        against concurrent writers — quiesce first: that contract (not a
        lock) is what orders this swap against `_append`'s lock-free
        slot claims."""
        self._buf = [None] * self.capacity
        self._seq = itertools.count()
        # same quiesce-first contract as _buf above: a concurrent
        # snapshot during clear() is caller error, not a data race
        self._t0 = time.monotonic()

    # -- Chrome trace-event export -----------------------------------------
    def chrome_trace(self, limit: Optional[int] = None) -> dict:
        """Chrome trace-event JSON (Perfetto / chrome://tracing loadable).

        Tracks map to (pid, tid): slot tracks under the ``decode slots``
        process, request tracks under ``requests``, component tracks
        under ``serving``. Ring wraparound can orphan one side of a span:
        an ``E`` whose ``B`` was overwritten is dropped, a ``B`` whose
        ``E`` is missing (still open, or overwritten) is closed at the
        last exported timestamp — so every emitted ``B`` has a matching
        ``E``, properly nested per track, with monotonic ``ts``. Spans
        carrying cross-process context (``origin``) additionally emit a
        flow event, so a merged multi-process trace draws one arrow
        chain per request."""
        evs = self.events(limit)
        tids: Dict[str, tuple] = {}
        counters = {0: 0, 1: 0, 2: 0}

        def tid_of(track: str) -> tuple:
            if track not in tids:
                pid = (1 if track.startswith("slot ")
                       else 2 if track.startswith("request ") else 0)
                counters[pid] += 1
                tids[track] = (pid, counters[pid])
            return tids[track]

        out: List[dict] = []
        render_chrome_events(evs, tid_of, out)
        meta = [{"name": "process_name", "ph": "M", "pid": p, "tid": 0,
                 "args": {"name": label}}
                for p, label in ((0, "serving"), (1, "decode slots"),
                                 (2, "requests")) if counters[p]]
        meta += [{"name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
                  "args": {"name": track}}
                 for track, (pid, tid) in sorted(tids.items())]
        return {"displayTimeUnit": "ms", "traceEvents": meta + out}

    # -- waterfall summaries -----------------------------------------------
    def request_summaries(self, limit: int = 16) -> List[dict]:
        """The newest N completed requests' phase timings, oldest first —
        scraped from the ``finish``/``cancel`` instants the scheduler
        stamps with the handle's timing breakdown. Feeds the UI
        ``/serving`` waterfall lines."""
        done = [e for e in self.events()
                if e["ph"] == "i" and e["name"] in ("finish", "cancel")
                and e.get("args", {}).get("request_id")]
        done = done[-max(1, limit):]
        return [{"outcome": e["name"], **e["args"]} for e in done]


def render_chrome_events(evs: List[dict],
                         tid_of: Callable[[str], Tuple[int, int]],
                         out: List[dict]) -> float:
    """Render ``events()``-shaped dicts into Chrome trace events on
    ``out`` — the core shared by :meth:`FlightRecorder.chrome_trace`
    (one process) and a fleet trace aggregator (N processes merged onto
    one axis; the caller pre-aligns ``ts`` and maps each
    process to its own pid group via ``tid_of``).

    Guarantees: every ``B`` is closed by a matching ``E`` (orphan ends
    dropped, orphan begins closed at the last timestamp), LIFO-nested
    and ts-monotonic per (pid, tid). Spans carrying ``origin`` (the
    fleet-wide trace id) emit a flow event at the span's begin — phase
    ``s`` on the originating side (no ``parent``), phase ``f`` with
    ``bp: "e"`` (bind to enclosing slice) on each receiving side — so
    Perfetto draws one arrow chain per propagated request.

    Returns the last rendered timestamp (seconds)."""
    stacks: Dict[tuple, List[dict]] = {}
    last_ts = 0.0

    def emit(ph: str, name: str, ts: float, pid: int, tid: int,
             args: Optional[dict]) -> dict:
        e = {"name": name, "ph": ph, "ts": round(ts * 1e6, 1),
             "pid": pid, "tid": tid}
        if ph == "i":
            e["s"] = "t"  # thread-scoped instant
        if args:
            e["args"] = args
        out.append(e)
        return e

    for ev in evs:
        pid, tid = tid_of(ev["track"])
        ts = ev["ts"]
        last_ts = max(last_ts, ts)
        args = ev.get("args")
        if ev["ph"] == "B":
            stacks.setdefault((pid, tid), []).append(
                emit("B", ev["name"], ts, pid, tid, args))
            origin = ev.get("origin")
            if origin:
                # flow events share the slice's (ts, pid, tid) so the
                # binding slice is unambiguous; the id IS the fleet
                # trace id, so sides emitted by different processes
                # join into one flow once merged
                flow = {"name": "graft", "cat": "graft",
                        "id": str(origin), "ts": round(ts * 1e6, 1),
                        "pid": pid, "tid": tid}
                if ev.get("parent"):
                    flow["ph"] = "f"
                    flow["bp"] = "e"
                else:
                    flow["ph"] = "s"
                out.append(flow)
        elif ev["ph"] == "E":
            stack = stacks.get((pid, tid), [])
            if not any(b["name"] == ev["name"] for b in stack):
                continue  # orphan end: its begin was overwritten
            # close intervening opens first (their end was lost to
            # the ring, or the writer died mid-span) to keep nesting
            while stack and stack[-1]["name"] != ev["name"]:
                inner = stack.pop()
                emit("E", inner["name"], ts, pid, tid, None)
            stack.pop()
            emit("E", ev["name"], ts, pid, tid, args)
        else:
            emit("i", ev["name"], ts, pid, tid, args)
    for (pid, tid), stack in stacks.items():
        while stack:  # still-open spans close at the last timestamp
            b = stack.pop()
            emit("E", b["name"], last_ts, pid, tid, None)
    return last_ts


_default: Optional[FlightRecorder] = None


def default_recorder() -> FlightRecorder:
    """Process-wide recorder for components not handed an explicit one
    (same pattern as `metrics.default_registry`). Creation is idempotent
    enough lock-free: a lost race leaks one empty ring, never records."""
    global _default
    if _default is None:
        _default = FlightRecorder()
    return _default


# -- CLI: dump a serving server's trace for Perfetto ------------------------
def main(argv=None) -> int:
    import argparse
    import urllib.request

    p = argparse.ArgumentParser(
        prog="python -m deeplearning4j_tpu_torch.inference.trace",
        description="Fetch a serving server's flight-recorder trace")
    sub = p.add_subparsers(dest="cmd", required=True)
    d = sub.add_parser("dump", help="write the Chrome trace-event JSON "
                                    "(load it at ui.perfetto.dev)")
    d.add_argument("--url", default="http://127.0.0.1:8080",
                   help="serving server base URL")
    d.add_argument("--out", default="trace.json",
                   help="output path (Chrome trace-event JSON)")
    d.add_argument("--limit", type=int, default=0,
                   help="newest N events only (0 = everything surviving)")
    args = p.parse_args(argv)
    url = f"{args.url.rstrip('/')}/trace?format=chrome"
    if args.limit:
        url += f"&limit={args.limit}"
    with urllib.request.urlopen(url) as resp:
        trace = json.loads(resp.read())
    with open(args.out, "w") as fh:
        json.dump(trace, fh)
    n = len(trace.get("traceEvents", []))
    tracks = len({(e.get("pid"), e.get("tid")) for e in
                  trace.get("traceEvents", []) if e.get("ph") != "M"})
    print(f"{args.out}: {n} events on {tracks} tracks "
          "(open at https://ui.perfetto.dev)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
