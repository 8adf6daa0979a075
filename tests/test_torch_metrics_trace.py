"""Port parity: the host-only metrics and flight-recorder modules.

The JAX package's unit cases for `inference/metrics.py` and
`inference/trace.py` (tests/test_inference_engine.py:45-139,
tests/test_telemetry.py:123-153, tests/test_trace.py:73-146), each run
against both copies: the JAX package's module and the port's. The port
keeps the same names and output, so the last cases hold one copy's
snapshot, text exposition and Chrome export against the other's on the
same records.
"""
import random
import threading
import time

import numpy as np
import pytest

from deeplearning4j_tpu.inference import metrics as jmetrics
from deeplearning4j_tpu.inference import trace as jtrace
from deeplearning4j_tpu_torch.inference import metrics as tmetrics
from deeplearning4j_tpu_torch.inference import trace as ttrace

METRICS = pytest.mark.parametrize("mod", [jmetrics, tmetrics],
                                  ids=["jax", "port"])
TRACE = pytest.mark.parametrize("mod", [jtrace, ttrace], ids=["jax", "port"])


# ---------------------------------------------------------------- metrics --
@METRICS
def test_histogram_percentiles(mod):
    m = mod.MetricsRegistry()
    h = m.histogram("lat")
    for v in np.linspace(0.001, 0.1, 1000):
        h.record(float(v))
    assert h.count == 1000
    assert 0.03 < h.percentile(0.5) < 0.08
    assert 0.08 < h.percentile(0.95) <= 0.1
    snap = h.snapshot()
    assert snap["count"] == 1000 and snap["p50"] <= snap["p95"] <= snap["p99"]
    assert snap["min"] == pytest.approx(0.001)
    assert snap["max"] == pytest.approx(0.1)


class _CountingLock:
    """Lock proxy counting acquisitions (context-manager uses only)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.acquisitions = 0

    def __enter__(self):
        self._lock.acquire()
        self.acquisitions += 1
        return self

    def __exit__(self, *exc):
        self._lock.release()
        return False


@METRICS
def test_histogram_snapshot_is_one_atomic_lock_acquisition(mod):
    h = mod.MetricsRegistry().histogram("atomic")
    for v in (0.002, 0.02, 0.2):
        h.record(v)
    counter = _CountingLock()
    h._lock = counter
    snap = h.snapshot()
    assert counter.acquisitions == 1
    assert snap["count"] == 3
    assert snap["min"] <= snap["p50"] <= snap["p95"] <= snap["p99"] \
        <= snap["max"]
    counter.acquisitions = 0
    h.percentile(0.5)
    assert counter.acquisitions == 1


@METRICS
def test_histogram_snapshot_consistent_under_concurrent_records(mod):
    h = mod.MetricsRegistry().histogram("hammer")
    stop = threading.Event()

    def writer():
        vals = (0.001, 0.005, 0.05, 0.5)
        i = 0
        while not stop.is_set():
            h.record(vals[i % 4])
            i += 1

    t = threading.Thread(target=writer, daemon=True)
    t.start()
    try:
        deadline = time.monotonic() + 1.0
        checked = 0
        while time.monotonic() < deadline:
            snap = h.snapshot()
            if not snap.get("count"):
                continue
            checked += 1
            assert snap["min"] <= snap["p50"] <= snap["p95"] \
                <= snap["p99"] <= snap["max"]
            assert snap["min"] <= snap["mean"] <= snap["max"]
            assert snap["mean"] == pytest.approx(
                snap["sum"] / snap["count"], abs=2e-6)
        assert checked > 50
    finally:
        stop.set()
        t.join(timeout=10)


@METRICS
def test_registry_snapshot_and_text(mod):
    m = mod.MetricsRegistry()
    m.counter("reqs").inc(3)
    m.gauge("depth").set(7)
    m.histogram("lat").record(0.01)
    snap = m.snapshot()
    assert snap["counters"]["reqs"] == 3
    assert snap["gauges"]["depth"]["value"] == 7
    assert snap["histograms"]["lat"]["count"] == 1
    text = m.render_text()
    assert "reqs 3" in text and 'lat{quantile="0.5"}' in text


@METRICS
def test_merge_histograms_equals_union_stream(mod):
    rng = random.Random(7)
    h1, h2, h3 = (mod.Histogram("x") for _ in range(3))
    for _ in range(1000):
        v = rng.lognormvariate(-4.5, 1.8)
        (h1 if rng.random() < 0.3 else h2).record(v)
        h3.record(v)
    m = mod.merge_histograms([h1.bucket_snapshot(), h2.bucket_snapshot()])
    s3 = h3.bucket_snapshot()
    assert m["counts"] == s3["counts"]
    assert m["count"] == s3["count"] == 1000
    assert abs(m["sum"] - s3["sum"]) < 1e-9 * max(1.0, s3["sum"])
    assert m["min"] == s3["min"] and m["max"] == s3["max"]
    for q in (0.50, 0.95, 0.99):
        assert abs(m[f"p{int(q * 100)}"] - h3.percentile(q)) < 1e-12


@METRICS
def test_merge_histograms_empty_and_single(mod):
    h = mod.Histogram("x")
    h.record(0.01)
    m = mod.merge_histograms([h.bucket_snapshot(),
                              mod.Histogram("x").bucket_snapshot()])
    assert m["count"] == 1 and m["min"] == m["max"] == 0.01
    assert mod.merge_histograms([]) == {"count": 0}


@METRICS
def test_merge_histograms_rejects_mismatched_bounds(mod):
    a = mod.Histogram("a")
    b = mod.Histogram("b", lo=1e-3, hi=10.0)
    a.record(0.1)
    b.record(0.1)
    with pytest.raises(ValueError, match="mismatched bucket boundaries"):
        mod.merge_histograms([a.bucket_snapshot(), b.bucket_snapshot()])
    bad = a.bucket_snapshot()
    bad["counts"] = bad["counts"][:-2]
    with pytest.raises(ValueError, match="counts length"):
        mod.merge_histograms([a.bucket_snapshot(), bad])


def _fill(mod):
    m = mod.MetricsRegistry()
    m.counter("decode_tokens_total", help="tokens").inc(5)
    m.gauge("decode_queue_depth").set(3)
    m.gauge("decode_queue_depth").set(1)
    h = m.histogram("decode_step_time_sec", labels={"phase": "decode"})
    for v in (0.001, 0.004, 0.02):
        h.record(v, exemplar="r000001")
    m.ratio("hit_rate", m.counter("hits"), m.counter("lookups"))
    return m


def _strip_times(text):
    return [ln for ln in text.splitlines()
            if not ln.startswith("uptime_sec") and " # {" not in ln]


def test_port_metrics_output_is_the_jax_output():
    """Same records, same snapshot (less the uptime), text and
    Prometheus exposition (less the uptime and the exemplars' wall
    time) from both copies."""
    j, t = _fill(jmetrics), _fill(tmetrics)
    js, ts = j.snapshot(), t.snapshot()
    js.pop("uptime_sec")
    ts.pop("uptime_sec")
    assert ts == js
    assert _strip_times(t.render_text()) == _strip_times(j.render_text())
    assert _strip_times(t.render_prometheus()) \
        == _strip_times(j.render_prometheus())


# ------------------------------------------------------------------ trace --
def _validate_chrome(trace):
    """Every B closed by an E of the same name on the same (pid, tid),
    LIFO-nested, with monotonic timestamps; instants carry a scope."""
    stacks, last_ts = {}, {}
    for e in trace["traceEvents"]:
        ph = e["ph"]
        if ph == "M":
            continue
        key = (e["pid"], e["tid"])
        assert e["ts"] >= last_ts.get(key, 0.0), (e, last_ts)
        last_ts[key] = e["ts"]
        if ph == "B":
            stacks.setdefault(key, []).append(e["name"])
        elif ph == "E":
            assert stacks.get(key), f"E without open B: {e}"
            assert stacks[key][-1] == e["name"], (e, stacks[key])
            stacks[key].pop()
        elif ph == "i":
            assert e.get("s") == "t"
        else:
            raise AssertionError(f"unexpected phase {ph!r}: {e}")
    assert all(not s for s in stacks.values()), f"unclosed spans: {stacks}"


@TRACE
def test_ring_wraparound_under_concurrent_writers(mod):
    rec = mod.FlightRecorder(256)
    n_threads, n_each = 8, 500

    def writer(t):
        for i in range(n_each):
            rec.instant("w", slot=t, args={"i": i})

    threads = [threading.Thread(target=writer, args=(t,))
               for t in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    snap = rec.snapshot()
    evs = snap["events"]
    assert len(evs) == 256
    seqs = [e["seq"] for e in evs]
    assert len(set(seqs)) == len(seqs)
    ts = [e["ts"] for e in evs]
    assert ts == sorted(ts)
    assert snap["total_recorded"] == n_threads * n_each
    assert snap["dropped"] == n_threads * n_each - 256
    for e in evs:
        assert e["ph"] == "i" and e["name"] == "w" and "i" in e["args"]


@TRACE
def test_disabled_recorder_records_nothing(mod):
    rec = mod.FlightRecorder(0)
    rec.begin("x")
    rec.instant("y")
    rec.end("x")
    assert not rec.enabled
    assert rec.snapshot()["events"] == []
    assert rec.chrome_trace()["traceEvents"] == []
    rec2 = mod.FlightRecorder(64, enabled=False)
    rec2.instant("y")
    assert rec2.snapshot()["events"] == []


@TRACE
def test_chrome_export_repairs_wraparound_orphans(mod):
    rec = mod.FlightRecorder(4)
    rec.begin("lost")
    for name in "abcd":
        rec.instant(name)
    rec.end("lost")
    rec.begin("open")
    trace = rec.chrome_trace()
    names = [(e["ph"], e["name"]) for e in trace["traceEvents"]
             if e["ph"] != "M"]
    assert ("E", "lost") not in names
    assert ("B", "open") in names and ("E", "open") in names
    _validate_chrome(trace)


@TRACE
def test_limit_keeps_newest_events(mod):
    rec = mod.FlightRecorder(128)
    for i in range(50):
        rec.instant("e", args={"i": i})
    evs = rec.events(limit=10)
    assert len(evs) == 10 and evs[-1]["args"]["i"] == 49


@TRACE
def test_request_ids_are_unique(mod):
    ids = {mod.new_request_id() for _ in range(100)}
    assert len(ids) == 100


def test_port_chrome_export_is_the_jax_export():
    """The same events rendered by both copies' `render_chrome_events`
    give the same Chrome trace events."""
    rec = jtrace.FlightRecorder(64)
    rec.begin("queued", req="r1")
    rec.instant("admit", slot=0, args={"request": "r1"})
    rec.end("queued", req="r1")
    rec.begin("prefill", req="r1", origin="o1", parent="p1")
    rec.begin("lost_end", slot=0)
    evs = rec.events()

    def render(mod):
        tids, out = {}, []
        mod.render_chrome_events(
            evs, lambda tr: tids.setdefault(tr, (0, len(tids) + 1)), out)
        return out

    assert render(ttrace) == render(jtrace)
