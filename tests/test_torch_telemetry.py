"""Port: the fleet telemetry plane (`serving/telemetry.py`) and the
server's ``X-Graft-Trace`` ingress.

- Every case of tests/test_telemetry.py, parametrised over the JAX
  package and the port (each package's own telemetry module, server and
  recorder): header parsing and its fuzz corpus, the live-ingress fuzz
  over a raw socket, the ``rpc`` span, the two-server merged waterfall,
  ring-wrap gap markers, metrics federation, burn weighting, the
  /fleet server and the CLI, the retention cap, concurrent trace ids and
  the gauge federation rules. The `merge_histograms` cases run over both
  packages in tests/test_torch_metrics_trace.py.
  `test_serving_update_merges_pushers` waits for the port of the training
  UI (ROADMAP A9); the port's ``telemetry --ui`` raises instead.
- Cross-package: a header minted by one package parses in the other; a
  server of one package joins a trace whose client is the other's; each
  package's `parse_prometheus` reads the other's exposition as it reads
  its own.
"""
import bisect
import json
import random
import socket
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.cli import main as jcli
from deeplearning4j_tpu.inference import metrics as jmetrics
from deeplearning4j_tpu.inference import trace as jtrace
from deeplearning4j_tpu.models.zoo import transformer_lm as jlm
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.serving import telemetry as jtele
from deeplearning4j_tpu.serving.server import InferenceServer as JServer
from deeplearning4j_tpu_torch.cli import main as tcli
from deeplearning4j_tpu_torch.inference import metrics as tmetrics
from deeplearning4j_tpu_torch.inference import trace as ttrace
from deeplearning4j_tpu_torch.models.zoo import transformer_lm as tlm
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph as TGraph
from deeplearning4j_tpu_torch.serving import telemetry as ttele
from deeplearning4j_tpu_torch.serving.server import InferenceServer as TServer

TELE = {"jax": jtele, "port": ttele}
METRICS = {"jax": jmetrics, "port": tmetrics}
TRACE = {"jax": jtrace, "port": ttrace}
PKGS = pytest.mark.parametrize("pkg", ["jax", "port"])


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _set_cache(conf, cache=96):
    for vert in conf.vertices.values():
        layer = getattr(vert, "layer", None)
        if layer is not None and hasattr(layer, "max_cache_len"):
            layer.max_cache_len = cache
    return conf


@pytest.fixture(scope="module")
def nets():
    jnet = JGraph(_set_cache(jlm(vocab_size=13, d_model=16, n_heads=2,
                                 n_blocks=2, rope=True))).init()
    tnet = TGraph(_set_cache(tlm(vocab_size=13, d_model=16, n_heads=2,
                                 n_blocks=2, rope=True)),
                  device="cpu").init()
    return {"jax": jnet, "port": tnet}


def _server(nets, pkg, **kw):
    if pkg == "jax":
        return JServer(net=nets["jax"], decode_vocab=13, decode_slots=2,
                       **kw).start()
    return TServer(net=nets["port"], decode_slots=2, device="cpu",
                   **kw).start()


def _post(port, path, body, headers=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=body,
        headers={"Content-Type": "application/json", **(headers or {})})
    resp = urllib.request.urlopen(req, timeout=120)
    return json.loads(resp.read()), dict(resp.headers)


def _validate_chrome(trace, allow_flows=True):
    """Perfetto-loadability: every B closed by a same-name E on its
    (pid, tid), LIFO-nested, ts monotonic per track; flow events inside
    an open slice."""
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
        elif ph in ("s", "f"):
            assert allow_flows and e.get("id"), e
            assert stacks.get(key), f"flow outside any open slice: {e}"
        else:
            raise AssertionError(f"unexpected phase {ph!r}: {e}")
    assert all(not s for s in stacks.values()), f"unclosed: {stacks}"


# ------------------------------------------------------ header parsing --
@PKGS
def test_header_roundtrip_and_child(pkg):
    t = TELE[pkg]
    ctx = t.TraceContext("tabc.000007", "tabc.000007/h0", 0, 1723.25)
    assert t.parse_trace_header(t.format_trace_header(ctx)) == ctx
    child = ctx.child(now=1724.0)
    assert child.request_id == ctx.request_id
    assert child.hop == 1 and child.parent == "tabc.000007/h1"
    assert t.parse_trace_header(t.format_trace_header(child)) == child


MALFORMED = [
    None, "", ";;;", "a;b;c", "x" * 300, "rid;p;0;1.0;extra",
    "r id;p;0;1.0", "rid\nX-Evil: 1;p;0;1.0", "rid;p;notanint;1.0",
    "rid;p;65;1.0", "rid;p;-1;1.0", "rid;p;99999999999999999999;1.0",
    "rid;p;0;nan", "rid;p;0;inf", "rid;p;0;xx", "rid;\x00\x01;0;1.0",
    "r\x7fd;p;0;1.0", "ríd;p;0;1.0", "a/b;a/b/h0;0;1.0"]


@PKGS
@pytest.mark.parametrize("value", MALFORMED)
def test_malformed_headers_degrade_to_none(pkg, value):
    assert TELE[pkg].parse_trace_header(value) is None


@pytest.mark.parametrize("minter,parser", [("jax", "port"), ("port", "jax")])
def test_header_minted_by_one_package_parses_in_the_other(minter, parser):
    """The header is the shared wire format: a client tracer's egress
    context, and its forwarded child, read back in the other package
    (the send time at the header's microseconds) and re-format to the
    same bytes; the span ids agree."""
    ct = TELE[minter].ClientTracer(TRACE[minter].FlightRecorder(64))
    ctx = ct.send("/generate")
    fwd = ct.send("/generate", ctx=ctx)
    for c in (ctx, fwd):
        hdr = ct.headers(c)[TELE[minter].TRACE_HEADER]
        got = TELE[parser].parse_trace_header(hdr)
        assert tuple(got)[:3] == tuple(c)[:3]
        assert got.origin_ts == float(f"{c.origin_ts:.6f}")
        assert TELE[parser].format_trace_header(got) == hdr
    assert TELE[minter].span_id(ctx.request_id, 3) == \
        TELE[parser].span_id(ctx.request_id, 3)
    assert TELE[minter].TRACE_HEADER == TELE[parser].TRACE_HEADER


@PKGS
def test_parse_prometheus_roundtrip_with_exemplars_and_labels(pkg):
    m, t = METRICS[pkg], TELE[pkg]
    reg = m.MetricsRegistry()
    reg.counter("reqs_total", help="requests").inc(7)
    reg.gauge("depth").set(3.5)
    reg.gauge("depth_max").set(9)
    h = reg.histogram("lat_seconds", labels={"route": "/p"})
    for v in (0.001, 0.01, 0.01, 2.0):
        h.record(v, exemplar='r"esc\\aped')  # hostile exemplar label
    parsed = t.parse_prometheus(reg.render_prometheus())
    assert parsed["counters"]["reqs_total"] == ("reqs_total", 7.0)
    assert parsed["gauges"]["depth"][1] == 3.5
    hp = parsed["histograms"]['lat_seconds{route="/p"}']
    assert hp["count"] == 4 and abs(hp["sum"] - 2.021) < 1e-9
    assert sum(hp["counts"]) == 4
    mm = m.merge_histograms([hp, hp])
    assert mm["count"] == 8 and abs(mm["sum"] - 4.042) < 1e-6


# ------------------------------------------- HTTP header fuzz, live --
@pytest.fixture(scope="module")
def servers(nets):
    srvs = {pkg: _server(nets, pkg, slo_p99_ms=500.0)
            for pkg in ("jax", "port")}
    yield srvs
    for s in srvs.values():
        s.stop()


@PKGS
def test_trace_clock_endpoint(servers, pkg):
    c = json.loads(urllib.request.urlopen(
        f"http://127.0.0.1:{servers[pkg].port}/trace/clock").read())
    for k in ("monotonic", "wall", "trace_t0", "pid"):
        assert k in c, c
    assert c["monotonic"] >= c["trace_t0"]


@PKGS
def test_malformed_context_never_500s_over_http(servers, pkg):
    """Hostile X-Graft-Trace / X-Request-Id values over a raw socket: a
    200 with a fresh server-minted id, and the Chrome export and the
    exposition stay well formed."""
    srv = servers[pkg]
    body = json.dumps({"prompt": [1, 2, 3], "max_new_tokens": 2}).encode()
    hostile = [
        b"X-Graft-Trace: " + b"A" * 4096,
        b"X-Graft-Trace: rid;p;99999999999;1.0",
        b"X-Graft-Trace: rid;\xff\xfe\x80;0;1.0",
        b"X-Graft-Trace: a;b;c",
        b"X-Request-Id: " + b"B" * 4096,
        b"X-Request-Id: \xc3\x28bad",
        b"X-Graft-Trace: rid;p;0;1.0\r\n folded-continuation; more",
    ]
    for hdr in hostile:
        req = (b"POST /generate HTTP/1.1\r\nHost: x\r\n"
               b"Content-Type: application/json\r\n"
               b"Content-Length: " + str(len(body)).encode() + b"\r\n"
               + hdr + b"\r\nConnection: close\r\n\r\n" + body)
        with socket.create_connection(("127.0.0.1", srv.port),
                                      timeout=30) as s:
            s.settimeout(60)
            s.sendall(req)
            resp = b""
            while True:
                chunk = s.recv(65536)
                if not chunk:
                    break
                resp += chunk
        status = resp.split(b"\r\n", 1)[0]
        assert b"200" in status, (hdr, status)
        head = resp.split(b"\r\n\r\n", 1)[0].decode("latin-1")
        rid = [ln.split(":", 1)[1].strip() for ln in head.splitlines()
               if ln.lower().startswith("x-request-id:")][0]
        assert "A" * 100 not in rid and "B" * 100 not in rid
        assert "\n" not in rid and len(rid) <= 128
    trace = json.loads(urllib.request.urlopen(
        f"http://127.0.0.1:{srv.port}/trace?format=chrome").read())
    _validate_chrome(trace)
    text = urllib.request.urlopen(
        f"http://127.0.0.1:{srv.port}/metrics?format=prometheus"
    ).read().decode()
    TELE[pkg].parse_prometheus(text)


@pytest.mark.parametrize("client,server", [
    ("jax", "jax"), ("port", "port"), ("jax", "port"), ("port", "jax")])
def test_propagated_context_stamps_rpc_span(servers, client, server):
    """A traced client's context wins the server's request identity and
    stamps its rpc span, whichever package minted the header."""
    srv = servers[server]
    ct = TELE[client].ClientTracer(TRACE[client].FlightRecorder(256))
    ctx = ct.send("/generate")
    out, headers = _post(srv.port, "/generate",
                         json.dumps({"prompt": [1, 2, 3],
                                     "max_new_tokens": 2}).encode(),
                         headers=ct.headers(ctx))
    ct.done(ctx)
    assert out["request_id"].startswith(ctx.request_id + ".")
    assert headers["X-Request-Id"] == out["request_id"]
    evs = srv.tracer.events()
    rpc_b = [e for e in evs if e["name"] == "rpc" and e["ph"] == "B"
             and e.get("origin") == ctx.parent]
    assert rpc_b, "no rpc span carrying the flow edge"
    b = rpc_b[0]
    assert b["parent"] == ctx.parent
    assert b["args"]["trace"] == ctx.request_id
    assert b["args"]["hop"] == 0
    assert "net_gap_ms" in b["args"]
    assert any(e["ph"] == "E" and e["name"] == "rpc"
               and e["track"] == b["track"] for e in evs)


# --------------------------------------- two-server merge acceptance --
def _drive_fleet(t, srv_a, srv_b, client, n_requests=6, new_tokens=3):
    """One logical request crosses BOTH live servers: hop 0 to A, then
    forwarded hop 1 to B under the same fleet identity."""
    rng = np.random.default_rng(0)
    ids = []
    for _ in range(n_requests):
        prompt = rng.integers(0, 13, 8).tolist()
        body = json.dumps({"prompt": prompt,
                           "max_new_tokens": new_tokens}).encode()
        ctx = client.send("/generate")
        out_a, _ = _post(srv_a.port, "/generate", body,
                         headers=client.headers(ctx))
        fwd = client.send("/generate", ctx=ctx)
        out_b, _ = _post(srv_b.port, "/generate", body,
                         headers=client.headers(fwd))
        client.done(fwd)
        client.done(ctx)
        assert out_a["request_id"].startswith(ctx.request_id + ".")
        assert out_b["request_id"].startswith(ctx.request_id + ".")
        ids.append(ctx.request_id)
    return ids


@PKGS
def test_two_process_merged_waterfall(nets, pkg):
    """Two live servers + a traced client merge into one Perfetto trace:
    three track groups, one flow per hop edge, per-track monotonic
    timestamps after clock alignment, each client span opening before
    its downstream rpc spans."""
    t = TELE[pkg]
    srv_a, srv_b = _server(nets, pkg), _server(nets, pkg)
    client = t.ClientTracer(TRACE[pkg].FlightRecorder(4096))
    try:
        ids = _drive_fleet(t, srv_a, srv_b, client)
        agg = t.TraceAggregator(
            [f"http://127.0.0.1:{srv_a.port}",
             f"http://127.0.0.1:{srv_b.port}"],
            client_recorder=client.recorder,
            names=["replica A", "replica B"])
        synced = agg.sync_clocks()
        assert len(synced) == 3
        assert all(s.rtt < 5.0 for s in synced.values())
        agg.poll()
        trace = agg.merged_chrome_trace()
        _validate_chrome(trace)
        evs = trace["traceEvents"]
        assert {e["pid"] for e in evs if e["ph"] != "M"} == {0, 1, 2}
        names = {e["pid"]: e["args"]["name"] for e in evs
                 if e["ph"] == "M" and e["name"] == "process_name"}
        assert names[0] == "client"
        srcs = [e for e in evs if e["ph"] == "s"]
        fins = [e for e in evs if e["ph"] == "f"]
        assert len(srcs) == 2 * len(ids)
        assert sorted(e["id"] for e in srcs) == sorted(e["id"] for e in fins)
        for rid in ids:
            edges = {e["id"] for e in srcs if e["id"].startswith(rid)}
            assert edges == {f"{rid}/h0", f"{rid}/h1"}, edges
        tid_name = {(e["pid"], e["tid"]): e["args"]["name"]
                    for e in evs if e["ph"] == "M"
                    and e["name"] == "thread_name"}
        client_open = {}
        for e in evs:
            if e["pid"] == 0 and e["ph"] == "B" and e["name"] == "request":
                track = tid_name[(e["pid"], e["tid"])]
                client_open.setdefault(track.split()[-1], e["ts"])
        rpc_spans = [e for e in evs if e["ph"] == "B" and e["name"] == "rpc"]
        assert len(rpc_spans) == 2 * len(ids)
        for rpc in rpc_spans:
            trace_id = rpc["args"]["trace"]
            assert trace_id in client_open, trace_id
            assert client_open[trace_id] <= rpc["ts"]
        stats = agg.stats()
        assert stats["completeness"] == 1.0
        assert stats["dropped_total"] == 0
    finally:
        srv_a.stop()
        srv_b.stop()


def test_port_and_jax_servers_merge_into_one_waterfall(servers):
    """A port aggregator over a JAX server and a port server, with a port
    client: one flow per hop edge across the two packages' servers."""
    client = ttele.ClientTracer(ttrace.FlightRecorder(4096))
    ids = _drive_fleet(ttele, servers["jax"], servers["port"], client,
                       n_requests=3)
    agg = ttele.TraceAggregator(
        [f"http://127.0.0.1:{servers['jax'].port}",
         f"http://127.0.0.1:{servers['port'].port}"],
        client_recorder=client.recorder)
    assert len(agg.sync_clocks()) == 3
    agg.poll()
    trace = agg.merged_chrome_trace()
    _validate_chrome(trace)
    srcs = [e for e in trace["traceEvents"] if e["ph"] == "s"]
    fins = [e for e in trace["traceEvents"] if e["ph"] == "f"]
    for rid in ids:
        assert {e["id"] for e in srcs if e["id"].startswith(rid)} == \
            {e["id"] for e in fins if e["id"].startswith(rid)} == \
            {f"{rid}/h0", f"{rid}/h1"}


@PKGS
def test_gap_markers_on_ring_wraparound(nets, pkg):
    """A server with a 64-event ring under enough load to wrap: the
    aggregator marks the hole and reports completeness < 1."""
    t = TELE[pkg]
    srv = _server(nets, pkg, trace_buffer=64)
    try:
        base = f"http://127.0.0.1:{srv.port}"
        agg = t.TraceAggregator([base])
        agg.sync_clocks()
        rng = np.random.default_rng(1)
        for _ in range(12):
            _post(srv.port, "/generate", json.dumps(
                {"prompt": rng.integers(0, 13, 8).tolist(),
                 "max_new_tokens": 3}).encode())
        snap = json.loads(urllib.request.urlopen(
            base + "/trace?since=0").read())
        assert snap["dropped"] > 0, "ring did not wrap; grow the load"
        agg.poll()
        trace = agg.merged_chrome_trace()
        gaps = [e for e in trace["traceEvents"]
                if e["name"] == "ring_dropped"]
        assert gaps and gaps[0]["args"]["dropped_delta"] >= 1
        stats = agg.stats()
        assert stats["dropped_total"] > 0
        assert stats["completeness"] < 1.0
    finally:
        srv.stop()


# ------------------------------------------------- metrics federation --
@PKGS
def test_fleet_federation_two_servers(nets, pkg):
    """Counters sum, fleet_replicas_up tracks liveness, and the fleet p99
    from MERGED buckets lands within one bucket of the pooled samples'."""
    t = TELE[pkg]
    srv_a = _server(nets, pkg, slo_p99_ms=500.0)
    srv_b = _server(nets, pkg, slo_p99_ms=500.0)
    try:
        rng = np.random.default_rng(2)
        for i in range(14):
            srv = srv_a if i % 2 else srv_b
            _post(srv.port, "/generate", json.dumps(
                {"prompt": rng.integers(0, 13, 8).tolist(),
                 "max_new_tokens": 3}).encode())
        targets = [f"http://127.0.0.1:{srv_a.port}",
                   f"http://127.0.0.1:{srv_b.port}"]
        fleet = t.FleetMetrics(targets)
        assert fleet.scrape() == 2
        fed = fleet.federate()
        assert fed["replicas_up"] == 2
        assert fed["counters"]["http_requests_total"] >= 14
        pooled = sorted(lat for srv in (srv_a, srv_b)
                        for buf in srv.slo._samples.values()
                        for _, lat in buf)
        assert len(pooled) == 14
        sample_p99 = pooled[min(len(pooled) - 1, int(0.99 * len(pooled)))]
        fleet_p99 = fed["routes"]["/generate"]["p99_ms"] / 1e3
        bounds = METRICS[pkg].Histogram("x")._bounds
        assert abs(bisect.bisect_left(bounds, sample_p99)
                   - bisect.bisect_left(bounds, fleet_p99)) <= 1
        text = fleet.render_prometheus()
        assert "fleet_replicas_up 2" in text
        assert "fleet_route_p99_ms{route=\"/generate\"}" in text
        reparsed = t.parse_prometheus(text)
        assert reparsed["histograms"][
            'http_route_latency_seconds{route="/generate"}']["count"] == 14
        srv_b.stop()
        fleet.scrape()
        fed2 = fleet.federate()
        assert fed2["replicas_up"] == 1
        assert fed2["scrape_errors_total"] >= 1
        summary = fleet.summary()
        assert summary["replicas"][1]["up"] is False
        assert summary["replicas"][0]["up"] is True
    finally:
        srv_a.stop()
        srv_b.stop()


def test_parse_prometheus_reads_the_other_packages_exposition(servers):
    """Both parsers read both servers' expositions identically, and the
    port server's exposition parses to the families the JAX server's
    does for the traffic both served: the route histogram, the request
    counters, the burn gauges."""
    body = json.dumps({"prompt": [4, 5, 6], "max_new_tokens": 2}).encode()
    texts = {}
    for pkg, srv in servers.items():
        _post(srv.port, "/generate", body)
        texts[pkg] = urllib.request.urlopen(
            f"http://127.0.0.1:{srv.port}/metrics?format=prometheus"
        ).read().decode()
    parsed = {}
    for pkg, text in texts.items():
        a, b = jtele.parse_prometheus(text), ttele.parse_prometheus(text)
        assert a == b, pkg
        parsed[pkg] = a
    route = 'http_route_latency_seconds{route="/generate"}'
    for pkg in ("jax", "port"):
        p = parsed[pkg]
        assert p["histograms"][route]["count"] >= 1
        assert len(p["histograms"][route]["counts"]) == \
            len(p["histograms"][route]["bounds"]) + 1
        assert p["counters"]["http_requests_total"][1] >= 1
        assert "slo_burn_rate_fast" in p["gauges"]
    jh, th = (parsed[k]["histograms"][route] for k in ("jax", "port"))
    assert jh["bounds"] == th["bounds"]
    # the port's route histogram merges with the JAX one (one fleet of
    # mixed replicas federates)
    merged = tmetrics.merge_histograms([jh, th])
    assert merged["count"] == jh["count"] + th["count"]


@PKGS
def test_fleet_burn_rates_weighted_toward_traffic(pkg):
    fleet = TELE[pkg].FleetMetrics(["http://x", "http://y"])

    def mk(fast, slow, n):
        return {"counters": {}, "types": {},
                "gauges": {"slo_burn_rate_fast": ("slo_burn_rate_fast", fast),
                           "slo_burn_rate_slow": ("slo_burn_rate_slow", slow)},
                "histograms": {'http_route_latency_seconds{route="/g"}': {
                    "name": "http_route_latency_seconds",
                    "labels": {"route": "/g"}, "bounds": [1.0],
                    "counts": [n, 0], "sum": 0.1 * n, "count": n}}}
    with fleet._lock:
        fleet._parsed = [mk(8.0, 4.0, 90), mk(0.0, 0.0, 10)]
        fleet._up = [True, True]
        fleet._weights = [90.0, 10.0]
    fed = fleet.federate()
    assert fed["burn_rate_fast"] == pytest.approx(7.2)
    assert fed["burn_rate_slow"] == pytest.approx(3.6)
    assert fed["burning"] is True


# ------------------------------------------------------- CLI + server --
@PKGS
def test_fleet_server_and_cli(nets, pkg, tmp_path):
    t = TELE[pkg]
    srv = _server(nets, pkg)
    try:
        base = f"http://127.0.0.1:{srv.port}"
        _post(srv.port, "/generate", json.dumps(
            {"prompt": [1, 2, 3], "max_new_tokens": 2}).encode())
        fleet = t.FleetMetrics([base])
        agg = t.TraceAggregator([base])
        agg.sync_clocks()
        agg.poll()
        fleet.scrape()
        fsrv = t.FleetTelemetryServer(fleet, agg).start()
        try:
            fbase = f"http://127.0.0.1:{fsrv.port}"
            text = urllib.request.urlopen(fbase + "/fleet").read().decode()
            assert "fleet_replicas_up 1" in text
            summ = json.loads(urllib.request.urlopen(
                fbase + "/fleet/summary").read())
            assert summ["replicas_up"] == 1
            assert summ["trace"]["events_merged"] > 0
            _validate_chrome(json.loads(urllib.request.urlopen(
                fbase + "/fleet/trace").read()))
            with pytest.raises(urllib.error.HTTPError) as ei:
                urllib.request.urlopen(fbase + "/nope")
            assert ei.value.code == 404
            ei.value.read()
        finally:
            fsrv.stop()
        out = tmp_path / "fleet_trace.json"
        rc = t.main(["--targets", base, "--out", str(out),
                     "--duration", "0", "--clock-probes", "2"])
        assert rc == 0
        trace = json.loads(out.read_text())
        _validate_chrome(trace)
        assert trace["traceEvents"], "CLI produced an empty merge"
    finally:
        srv.stop()


@PKGS
def test_cli_subcommand_wires_through(pkg, capsys):
    cli = {"jax": jcli, "port": tcli}[pkg]
    args = cli.build_parser().parse_args(
        ["telemetry", "--targets", "http://127.0.0.1:1",
         "--duration", "0", "--clock-probes", "1"])
    fn = args.func if pkg == "jax" else args.fn
    assert fn(args) == 0  # unreachable target: degrades, no raise
    payload = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert payload["fleet"]["replicas_up"] == 0
    assert payload["fleet"]["scrape_errors_total"] >= 1


def test_port_telemetry_ui_push_raises_not_skips():
    """The UI push needs the training UI (ROADMAP A9): the port refuses
    ``--ui`` loudly, from the module and from the CLI, before it scrapes
    anything."""
    with pytest.raises(NotImplementedError, match="A9"):
        ttele.main(["--targets", "http://127.0.0.1:1", "--duration", "0",
                    "--ui", "http://127.0.0.1:2"])
    args = tcli.build_parser().parse_args(
        ["telemetry", "--targets", "http://127.0.0.1:1", "--duration", "0",
         "--ui", "http://127.0.0.1:2"])
    with pytest.raises(NotImplementedError, match="A9"):
        args.fn(args)


@PKGS
def test_aggregator_retention_cap_keeps_completeness(pkg):
    rec = TRACE[pkg].FlightRecorder(4096)
    for i in range(3000):
        rec.instant("e", slot=i % 4)
    agg = TELE[pkg].TraceAggregator([], client_recorder=rec, max_events=1024)
    agg.sync_clocks()
    agg.poll()
    stats = agg.stats()
    assert stats["events_merged"] == 3000
    assert stats["trimmed_total"] == 3000 - 1024
    assert stats["completeness"] == 1.0
    assert len(agg._sources[0].events) == 1024
    assert agg.merged_chrome_trace()["traceEvents"]


@PKGS
def test_new_trace_id_unique_under_concurrent_first_use(pkg):
    tm = TELE[pkg]
    tm._tid_counter = None  # force the re-init race window
    ids = []
    barrier = threading.Barrier(8)

    def mint():
        barrier.wait()
        for _ in range(50):
            ids.append(tm.new_trace_id())

    threads = [threading.Thread(target=mint) for _ in range(8)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert len(ids) == len(set(ids)) == 400


@PKGS
def test_gauge_federation_semantics(pkg):
    t = TELE[pkg]
    assert t._gauge_agg("slo_burn_rate_fast") == "max"
    assert t._gauge_agg("slo_route_p99_ms") == "max"
    assert t._gauge_agg("device_mfu_estimate") == "max"
    assert t._gauge_agg("kv_pool_utilization") == "max"
    assert t._gauge_agg("decode_queue_depth_max") == "max"
    assert t._gauge_agg("serving_ready") == "min"
    assert t._gauge_agg("decode_queue_depth") == "sum"
    assert t._gauge_agg("decode_tokens_per_sec") == "sum"
    assert t._gauge_agg("device_hbm_gbps") == "sum"
    assert t._gauge_agg("kv_pool_blocks_capacity") == "sum"
    fleet = t.FleetMetrics(["http://x", "http://y", "http://z"])

    def mk(burn, ready, depth):
        return {"counters": {}, "types": {}, "histograms": {},
                "gauges": {"slo_burn_rate_fast": ("slo_burn_rate_fast", burn),
                           "serving_ready": ("serving_ready", ready),
                           "decode_queue_depth": ("decode_queue_depth",
                                                  depth)}}
    with fleet._lock:
        fleet._parsed = [mk(0.5, 1, 2), mk(0.5, 1, 3), mk(0.5, 0, 4)]
        fleet._up = [True, True, True]
        fleet._weights = [1.0, 1.0, 1.0]
    fed = fleet.federate()
    assert fed["gauges"]["slo_burn_rate_fast"] == 0.5
    assert fed["gauges"]["serving_ready"] == 0
    assert fed["gauges"]["decode_queue_depth"] == 9


def test_gauge_rules_and_parse_equal_jax_on_random_expositions():
    """The federation rules and the parser are the JAX package's: on
    random family names and random registries both packages agree."""
    rng = random.Random(3)
    stems = ["decode_queue_depth", "slo_burn_rate_fast", "x_per_sec",
             "kv_pool_utilization", "a_ms", "b_max", "serving_ready",
             "uptime_sec", "c_gbps", "d_ratio", "e_total", "f_level"]
    for s in stems:
        assert jtele._gauge_agg(s) == ttele._gauge_agg(s)
    reg = tmetrics.MetricsRegistry()
    for i in range(20):
        kind = rng.choice(["counter", "gauge", "histogram"])
        name = f"fam{i}_" + rng.choice(["total", "ms", "depth"])
        labels = {"route": rng.choice(["/a", "/b"])} if rng.random() < 0.5 \
            else None
        if kind == "counter":
            reg.counter(name + "_c", labels=labels).inc(rng.randint(0, 9))
        elif kind == "gauge":
            reg.gauge(name + "_g", labels=labels).set(rng.random())
        else:
            h = reg.histogram(name + "_h", labels=labels)
            for _ in range(rng.randint(1, 30)):
                h.record(rng.lognormvariate(-4, 2))
    for om in (True, False):
        text = reg.render_prometheus(openmetrics=om)
        assert ttele.parse_prometheus(text) == jtele.parse_prometheus(text)
