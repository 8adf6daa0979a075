"""Port: the serving surface beyond /generate's tokens.

- Request ids, timings, error bodies and a malformed id replaced: the
  cases of tests/test_trace.py (:290-432) on the port's server.
- SSE: streamed tokens equal the buffered ones, a client that hangs up
  frees its slot and blocks (tests/test_logitproc.py :522, :595), the
  grammar, stop, penalty and ``n`` fields are served, and a field the
  port does not know is refused with 400.
- /predict: the `MicroBatcher` cases of tests/test_inference_engine.py
  (:175-312) parametrised over the JAX class and the port's; batched
  answers bit-identical to unbatched; the deadline's 504; a graph zip's
  predictions equal to the JAX server's within 1e-5
  (tests/test_decode_prefill.py :362). No test races throughput.
- /metrics in its four formats parses; /health, /info, /trace/clock,
  /admin/drain with requests in flight (none dropped), and the opt-in
  /admin/failpoints.
- The CLI parses serve's flags, arms failpoints from them and from the
  environment, and runs predict; `serving/streaming.py` against the JAX
  module.
"""
import http.client
import json
import re
import socket
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.inference.batcher import MicroBatcher as JBatcher
from deeplearning4j_tpu.inference.batcher import \
    QueueFullError as JQueueFullError
from deeplearning4j_tpu.inference.batcher import \
    RequestTimeoutError as JTimeoutError
from deeplearning4j_tpu_torch.inference import failpoints
from deeplearning4j_tpu_torch.inference.batcher import (MicroBatcher,
                                                        QueueFullError,
                                                        RequestTimeoutError)
from deeplearning4j_tpu_torch.inference.metrics import MetricsRegistry
from deeplearning4j_tpu_torch.models.sampling import generate_transformer
from deeplearning4j_tpu_torch.models.zoo import mlp_iris, transformer_lm
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.serving.server import InferenceServer
from deeplearning4j_tpu_torch.util.model_serializer import write_model

from test_torch_metrics_trace import _validate_chrome

V = 13
BATCHERS = {"jax": (JBatcher, JQueueFullError, JTimeoutError),
            "port": (MicroBatcher, QueueFullError, RequestTimeoutError)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tier-1 runs several test files at once on a few cores; one torch
    intra-op thread keeps this file from starving the others' timings."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_NETS = {}


def _lm(cache=96):
    if cache not in _NETS:
        conf = transformer_lm(vocab_size=V, d_model=16, n_heads=2,
                              n_blocks=2, rope=True)
        for vert in conf.vertices.values():
            layer = getattr(vert, "layer", None)
            if layer is not None and hasattr(layer, "max_cache_len"):
                layer.max_cache_len = cache
        _NETS[cache] = ComputationGraph(conf, device="cpu").init()
    return _NETS[cache]


def _mlp():
    return MultiLayerNetwork(mlp_iris(), device="cpu").init()


def _features(n, seed=0):
    return np.random.default_rng(seed).normal(size=(n, 4)).astype(np.float32)


def _post(port, path, body, headers=None, timeout=120):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=body if isinstance(body, bytes) else json.dumps(body).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def _get(port, path, headers=None):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 headers=headers or {})
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.status, r.headers, r.read()


def _read_sse(resp):
    buf, events = b"", []
    while True:
        chunk = resp.read1(65536)
        if not chunk:
            break
        buf += chunk
        while b"\n\n" in buf:
            line, buf = buf.split(b"\n\n", 1)
            assert line.startswith(b"data: ")
            events.append(json.loads(line[len(b"data: "):]))
    return events


# ------------------------------------------------ request ids and /trace --
def test_generate_response_carries_request_id_and_timings():
    net = _lm()
    prompt = np.random.default_rng(2).integers(0, V, 20).tolist()
    solo = generate_transformer(net, prompt, 4, V, use_cache=True)
    srv = InferenceServer(net=net, decode_slots=2, prefill_chunk=16,
                          device="cpu").start()
    try:
        base = f"http://127.0.0.1:{srv.port}"
        body = json.dumps({"prompt": prompt, "max_new_tokens": 4}).encode()
        req = urllib.request.Request(
            base + "/generate", data=body,
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as resp:
            rid = resp.headers["X-Request-Id"]
            out = json.loads(resp.read())
        assert out["tokens"] == solo
        assert rid and out["request_id"] == rid
        t = out["timings"]
        phases = t["queue_ms"] + t["restore_ms"] + t["prefill_ms"] \
            + t["decode_ms"]
        assert phases == pytest.approx(t["total_ms"], rel=0.05, abs=0.2)
        # a client-supplied id survives as the prefix of a unique one
        req = urllib.request.Request(
            base + "/generate", data=body,
            headers={"Content-Type": "application/json",
                     "X-Request-Id": "client-abc"})
        with urllib.request.urlopen(req, timeout=120) as resp:
            crid = resp.headers["X-Request-Id"]
            assert json.loads(resp.read())["request_id"] == crid
        assert re.fullmatch(r"client-abc\.r\d+", crid), crid
        snap = json.loads(_get(srv.port, "/trace")[2])
        tracks = {e["track"] for e in snap["events"]}
        assert f"request {rid}" in tracks and f"request {crid}" in tracks
        chrome = json.loads(_get(srv.port, "/trace?format=chrome")[2])
        _validate_chrome(chrome)
        thread_names = [e["args"]["name"] for e in chrome["traceEvents"]
                        if e["ph"] == "M" and e["name"] == "thread_name"]
        assert any(n.startswith("slot ") for n in thread_names)
        assert any(n.startswith("request ") for n in thread_names)
        limited = json.loads(_get(srv.port, "/trace?limit=5")[2])
        assert len(limited["events"]) == 5
        tail = json.loads(_get(
            srv.port, f"/trace?since={limited['next_cursor'] - 2}")[2])
        assert len(tail["events"]) == 2
        clock = json.loads(_get(srv.port, "/trace/clock")[2])
        assert {"monotonic", "wall", "trace_t0", "pid"} <= set(clock)
        with pytest.raises(urllib.error.HTTPError) as ei:
            _get(srv.port, "/trace?limit=x")
        assert ei.value.code == 400
    finally:
        srv.stop()


def test_error_bodies_quote_the_request_id():
    net = _lm(cache=24)
    srv = InferenceServer(net=net, decode_slots=1, prefill_chunk=16,
                          device="cpu").start()
    try:
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(srv.port, "/generate", {"prompt": list(range(5)) * 10,
                                          "max_new_tokens": 8})
        assert e.value.code == 413
        err = json.loads(e.value.read())
        rid = err["request_id"]
        assert rid and e.value.headers["X-Request-Id"] == rid
        assert any(ev["name"] == "reject"
                   and ev["args"].get("request_id") == rid
                   and ev["args"]["reason"] == "prompt_too_long"
                   for ev in srv.tracer.events())
        # a malformed body and an unknown path quote their ids too
        for path, body, code in (("/generate", b"{not json", 400),
                                 ("/nowhere", b"{}", 404)):
            with pytest.raises(urllib.error.HTTPError) as e:
                _post(srv.port, path, body)
            assert e.value.code == code
            assert json.loads(e.value.read())["request_id"] \
                == e.value.headers["X-Request-Id"]
    finally:
        srv.stop()


def test_malformed_client_request_id_is_replaced_not_echoed():
    """An obs-folded X-Request-Id reaches the handler with embedded CR/LF;
    echoing it would be response-header injection."""
    srv = InferenceServer(net=_lm(), prefill_chunk=16, device="cpu").start()
    try:
        body = json.dumps({"prompt": [1, 2, 3],
                           "max_new_tokens": 2}).encode()
        raw = (b"POST /generate HTTP/1.1\r\n"
               b"Host: 127.0.0.1\r\n"
               b"Content-Type: application/json\r\n"
               b"X-Request-Id: abc\r\n\tSet-Cookie: evil=1\r\n"
               b"Content-Length: " + str(len(body)).encode() + b"\r\n"
               b"Connection: close\r\n\r\n" + body)
        with socket.create_connection(("127.0.0.1", srv.port),
                                      timeout=120) as s:
            s.sendall(raw)
            s.settimeout(120)
            resp = b""
            while True:
                chunk = s.recv(65536)
                if not chunk:
                    break
                resp += chunk
        head, _, payload = resp.partition(b"\r\n\r\n")
        assert b"Set-Cookie" not in head
        out = json.loads(payload)
        assert re.fullmatch(r"r\d+", out["request_id"])
        hdr = [ln for ln in head.split(b"\r\n")
               if ln.lower().startswith(b"x-request-id:")]
        assert hdr == [b"X-Request-Id: " + out["request_id"].encode()]
    finally:
        srv.stop()


def test_trace_buffer_zero_disables_the_recorder():
    srv = InferenceServer(net=_lm(), trace_buffer=0, device="cpu").start()
    try:
        out = _post(srv.port, "/generate", {"prompt": [1, 2, 3],
                                            "max_new_tokens": 2})
        assert len(out["tokens"]) == 2 and "timings" in out
        snap = json.loads(_get(srv.port, "/trace")[2])
        assert snap["events"] == [] and snap["capacity"] == 0
    finally:
        srv.stop()


# ------------------------------------------------------------------- SSE --
@pytest.fixture(scope="module")
def paged_server():
    srv = InferenceServer(net=_lm(), decode_slots=2, prefill_chunk=16,
                          kv_pool_mb=0.5, kv_block=8, hang_timeout_s=600,
                          device="cpu").start()
    yield srv
    srv.stop()


def _prompt():
    return [int(t) for t in np.random.default_rng(5).integers(0, V, 30)]


def test_http_stream_token_identical_to_buffered(paged_server):
    srv = paged_server
    prompt = _prompt()
    base = _post(srv.port, "/generate", {"prompt": prompt,
                                         "max_new_tokens": 8})
    sampled = _post(srv.port, "/generate",
                    {"prompt": prompt, "max_new_tokens": 8,
                     "temperature": 0.8, "top_k": 5, "seed": 3})
    before = srv.metrics.counter("stream_requests_total").value
    for want, extra in ((base, {}),
                        (sampled, {"temperature": 0.8, "top_k": 5,
                                   "seed": 3})):
        conn = http.client.HTTPConnection("127.0.0.1", srv.port,
                                          timeout=300)
        conn.request("POST", "/generate",
                     json.dumps({"prompt": prompt, "max_new_tokens": 8,
                                 "stream": True, **extra}).encode(),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        assert resp.status == 200
        assert resp.getheader("Content-Type") == "text/event-stream"
        rid = resp.getheader("X-Request-Id")
        events = _read_sse(resp)
        conn.close()
        toks = [e["token"] for e in events if not e.get("done")]
        assert [e["index"] for e in events if not e.get("done")] \
            == list(range(8))
        done = events[-1]
        assert toks == done["tokens"] == want["tokens"]
        assert done["request_id"] == rid
        assert done["finish_reason"] == "length"
        assert set(done["timings"]) >= {"queue_ms", "prefill_ms",
                                        "decode_ms", "total_ms"}
    assert srv.metrics.counter("stream_requests_total").value == before + 2


@pytest.mark.parametrize("extra", [
    {"grammar": {"type": "admit_all"}}, {"stop": [[1, 2]]},
    {"repetition_penalty": 1.2}, {"n": 2}])
def test_unported_generate_fields_are_refused_not_ignored(paged_server,
                                                          extra):
    """The fields that were refused until the logit processors and
    best-of-n were ported are now served, buffered and streamed, and act
    on the output (none is ignored); ``n`` > 1 with ``stream`` and a
    field the port does not know stay 400."""
    srv = paged_server
    prompt = _prompt()
    body = {"prompt": prompt, "max_new_tokens": 6, **extra}
    plain = _post(srv.port, "/generate", {"prompt": prompt,
                                          "max_new_tokens": 6})
    c0 = srv.metrics.counter("constrained_requests_total").value
    out = _post(srv.port, "/generate", body)
    if "n" in extra:
        assert len(out["candidates"]) == 2
        assert out["tokens"] == out["candidates"][0]["tokens"] \
            == plain["tokens"]
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(srv.port, "/generate", {**body, "stream": True})
        assert ei.value.code == 400
        assert "n=1" in json.loads(ei.value.read())["error"]
    else:
        conn = http.client.HTTPConnection("127.0.0.1", srv.port,
                                          timeout=300)
        conn.request("POST", "/generate",
                     json.dumps({**body, "stream": True}).encode(),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        assert resp.status == 200
        events = _read_sse(resp)
        conn.close()
        assert events[-1]["tokens"] == out["tokens"]
        assert events[-1]["finish_reason"] == out["finish_reason"]
    if "grammar" in extra:  # counted, and admit-all changes no token
        assert srv.metrics.counter(
            "constrained_requests_total").value == c0 + 2
        assert out["tokens"] == plain["tokens"]
    if "stop" in extra:
        assert all(out["tokens"][i:i + 2] != [1, 2]
                   for i in range(len(out["tokens"])))
        assert out["finish_reason"] in ("stop", "length")
    if "repetition_penalty" in extra:
        assert len(out["tokens"]) == 6
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(srv.port, "/generate", {**body, "logit_bias": {"1": 2.0}})
    assert ei.value.code == 400
    assert "unknown /generate field" in json.loads(ei.value.read())["error"]


def test_http_stream_disconnect_reclaims_slot_and_pins(paged_server):
    srv = paged_server
    eng = srv.decoder
    d0 = srv.metrics.counter("stream_disconnects_total").value
    free0 = eng.pool.free_blocks
    reclaim0 = eng.pool.reclaimable_blocks()
    s = socket.create_connection(("127.0.0.1", srv.port), timeout=60)
    body = json.dumps({"prompt": _prompt(), "max_new_tokens": 60,
                       "stream": True}).encode()
    s.sendall(b"POST /generate HTTP/1.1\r\nHost: x\r\n"
              b"Content-Type: application/json\r\n"
              b"Content-Length: " + str(len(body)).encode()
              + b"\r\n\r\n" + body)
    head = s.recv(256)  # the stream started
    assert b"200" in head
    s.close()  # hang up mid-decode
    deadline = time.monotonic() + 120
    while time.monotonic() < deadline:
        if (srv.metrics.counter("stream_disconnects_total").value > d0
                and eng.inflight() == 0
                and eng.pool.free_blocks == free0):
            break
        time.sleep(0.05)
    assert srv.metrics.counter("stream_disconnects_total").value == d0 + 1
    assert eng.inflight() == 0
    assert srv.metrics.counter("decode_cancelled_total").value >= 1
    assert eng.pool.free_blocks == free0
    assert eng.pool.reclaimable_blocks() == reclaim0
    assert eng.pool.outstanding_refs() == 0


# ----------------------------------------------------- the micro-batcher --
@pytest.mark.parametrize("pkg", list(BATCHERS))
def test_batcher_aggregates_and_scatters(pkg):
    cls, _, _ = BATCHERS[pkg]
    seen = []

    def fwd(a):
        seen.append(a.shape[0])
        return a * 2.0

    b = cls(fwd, max_batch=16, batch_window_s=0.05,
            metrics=MetricsRegistry()).start()
    try:
        futs = [b.submit(np.full((2, 3), i, np.float32)) for i in range(4)]
        outs = [f.result(10) for f in futs]
        for i, o in enumerate(outs):
            np.testing.assert_array_equal(o, np.full((2, 3), 2.0 * i))
        assert seen == [8]  # 4 requests, 8 rows, one bucketed forward
        assert b.metrics.histogram("batcher_batch_occupancy").mean == 4
    finally:
        b.stop()


@pytest.mark.parametrize("pkg", list(BATCHERS))
def test_batcher_bucketed_padding(pkg):
    cls, _, _ = BATCHERS[pkg]
    shapes = []

    def fwd(a):
        shapes.append(a.shape[0])
        return a

    b = cls(fwd, max_batch=32, batch_window_s=0.0,
            metrics=MetricsRegistry()).start()
    try:
        np.testing.assert_array_equal(b.predict(np.ones((5, 2), np.float32)),
                                      np.ones((5, 2), np.float32))
        assert shapes == [8]  # 5 rows pad to the 8-bucket, result unpadded
        big = np.arange(80, dtype=np.float32).reshape(40, 2)
        np.testing.assert_array_equal(b.predict(big), big)
        assert shapes[1:] == [32, 8]  # chunked at max_batch, each bucketed
    finally:
        b.stop()


@pytest.mark.parametrize("pkg", list(BATCHERS))
def test_batcher_backpressure_and_deadline(pkg):
    cls, qfull, rtimeout = BATCHERS[pkg]
    release = threading.Event()

    def slow_fwd(a):
        release.wait(10)
        return a

    b = cls(slow_fwd, max_batch=4, max_queue=2, batch_window_s=0.0,
            metrics=MetricsRegistry()).start()
    try:
        first = b.submit(np.zeros((1, 2), np.float32))  # holds the thread
        time.sleep(0.1)
        b.submit(np.zeros((1, 2), np.float32))
        b.submit(np.zeros((1, 2), np.float32))
        with pytest.raises(qfull):
            b.submit(np.zeros((1, 2), np.float32))
        assert b.metrics.counter("batcher_rejected_total").value == 1
        with pytest.raises((qfull, rtimeout)):
            b.predict(np.zeros((1, 2), np.float32), timeout_s=0.0)
        release.set()
        assert first.result(10).shape == (1, 2)
    finally:
        release.set()
        b.stop()


@pytest.mark.parametrize("pkg", list(BATCHERS))
def test_batcher_model_error_fails_request_not_dispatcher(pkg):
    cls, _, _ = BATCHERS[pkg]
    calls = {"n": 0}

    def flaky(a):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("boom")
        return a

    b = cls(flaky, batch_window_s=0.0, metrics=MetricsRegistry()).start()
    try:
        with pytest.raises(RuntimeError, match="boom"):
            b.predict(np.zeros((1, 2), np.float32))
        assert b.predict(np.zeros((1, 2), np.float32)).shape == (1, 2)
    finally:
        b.stop()


def test_port_batcher_one_host_copy_per_dispatch():
    """A forward that returns a tensor comes to the host once per batch,
    under no_grad, whatever the number of requests in it."""
    copies = []

    class T(torch.Tensor):
        def cpu(self, *a, **k):
            copies.append(1)
            return super().cpu(*a, **k)

    def fwd(a):
        assert not torch.is_grad_enabled()
        return torch.from_numpy(a * 3.0).as_subclass(T)

    b = MicroBatcher(fwd, max_batch=16, batch_window_s=0.05,
                     metrics=MetricsRegistry()).start()
    try:
        futs = [b.submit(np.full((1, 2), i, np.float32)) for i in range(5)]
        for i, f in enumerate(futs):
            np.testing.assert_array_equal(f.result(10),
                                          np.full((1, 2), 3.0 * i))
        assert b.metrics.counter("batcher_batches_total").value == len(copies)
        assert len(copies) < 5
    finally:
        b.stop()


# --------------------------------------------------------------- /predict --
def test_server_batched_matches_unbatched_bit_identical():
    net = _mlp()
    sb = InferenceServer(net=net, batching=True, batch_window_ms=2.0,
                         device="cpu").start()
    su = InferenceServer(net=net, batching=False, device="cpu").start()
    try:
        body = {"data": _features(9).tolist()}
        ob = _post(sb.port, "/predict", body)
        ou = _post(su.port, "/predict", body)
        assert ob["predictions"] == ou["predictions"]  # bit-identical JSON
        assert ob["classes"] == ou["classes"]
        want = net.output(_features(9)).numpy()
        np.testing.assert_allclose(ob["predictions"], want, rtol=1e-6)
        csv = "\n".join(",".join(str(v) for v in row)
                        for row in _features(9).tolist()).encode()
        oc = _post(sb.port, "/predict/csv", csv,
                   headers={"Content-Type": "text/plain"})
        np.testing.assert_allclose(oc["predictions"], want, rtol=1e-6)
    finally:
        sb.stop()
        su.stop()


def test_server_concurrent_load_batches_and_reports_metrics():
    net = _mlp()
    srv = InferenceServer(net=net, batching=True, batch_window_ms=10.0,
                          device="cpu").start()
    try:
        body = {"data": _features(4).tolist()}
        expect = _post(srv.port, "/predict", body)
        results, errors = [], []

        def client():
            try:
                for _ in range(6):
                    results.append(_post(srv.port, "/predict", body))
            except Exception as e:  # pragma: no cover - diagnostic
                errors.append(e)

        threads = [threading.Thread(target=client) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not errors and len(results) == 48
        for r in results:  # batching must not mix rows across requests
            assert r["predictions"] == expect["predictions"]
        m = json.loads(_get(srv.port, "/metrics")[2])
        occ = m["histograms"]["predict_batch_occupancy"]
        lat = m["histograms"]["predict_latency_sec"]
        assert occ["count"] > 0 and occ["mean"] > 1.0, occ
        assert lat["count"] >= 48 and lat["p99"] > 0, lat
        assert m["gauges"]["predict_queue_depth"]["max"] >= 1
        assert m["counters"]["predict_requests_total"] >= 49
    finally:
        srv.stop()


def test_server_deadline_expires_server_stays_up():
    srv = InferenceServer(net=_mlp(), batching=True, batch_window_ms=5.0,
                          device="cpu").start()
    try:
        body = {"data": _features(2).tolist()}
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(srv.port, "/predict?timeout_ms=0", body)
        assert ei.value.code == 504
        assert len(_post(srv.port, "/predict", body)["classes"]) == 2
        m = json.loads(_get(srv.port, "/metrics")[2])
        assert m["counters"]["predict_timeouts_total"] >= 1
    finally:
        srv.stop()


def test_predict_on_graph_zip_matches_the_jax_server(tmp_path):
    """/predict on a ComputationGraph zip slices the batch axis of the
    graph's first output; the port's answer equals the JAX server's."""
    from deeplearning4j_tpu.models.zoo import transformer_lm as jlm
    from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
    from deeplearning4j_tpu.serving import InferenceServer as JServer
    from deeplearning4j_tpu.util.model_serializer import \
        write_model as jwrite
    jnet = JGraph(jlm(vocab_size=V, d_model=16, n_heads=2, n_blocks=2,
                      rope=True)).init()
    path = tmp_path / "lm.zip"
    jwrite(jnet, path)
    x = np.eye(V, dtype=np.float32)[
        np.random.default_rng(8).integers(0, V, (3, 6))]
    js = JServer(net=jnet, batching=True).start()
    ts = InferenceServer(model_path=path, decode_vocab=0,
                         device="cpu").start()
    try:
        want = np.asarray(_post(js.port, "/predict",
                                {"data": x.tolist()})["predictions"])
        got = np.asarray(_post(ts.port, "/predict",
                               {"data": x.tolist()})["predictions"])
        assert got.shape == want.shape == (3, 6, V)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        with pytest.raises(urllib.error.HTTPError) as ei:  # no engine
            _post(ts.port, "/generate", {"prompt": [1], "max_new_tokens": 2})
        assert ei.value.code == 400
    finally:
        js.stop()
        ts.stop()


# ------------------------------------------------- the GET surface, admin --
def _parse_exposition(text, exemplars):
    """Every sample line is `name{labels} value [# exemplar]`."""
    samples = {}
    for ln in text.splitlines():
        if not ln or ln.startswith("#"):
            continue
        body, sep, ex = ln.partition(" # ")
        assert exemplars or not sep, ln
        name, value = body.rsplit(" ", 1)
        assert re.fullmatch(r"[a-zA-Z_:][a-zA-Z0-9_:]*(\{.*\})?", name), ln
        samples[name] = float(value)
    return samples


def test_metrics_formats_parse_and_get_endpoints(paged_server):
    srv = paged_server
    _post(srv.port, "/generate", {"prompt": [1, 2, 3], "max_new_tokens": 2})
    code, hdr, raw = _get(srv.port, "/metrics")
    snap = json.loads(raw)
    assert snap["counters"]["decode_tokens_total"] >= 2
    assert "serving_ready" in snap["gauges"]
    for path, accept, ctype, exemplars in (
            ("/metrics?format=prometheus", None, "openmetrics", True),
            ("/metrics", "application/openmetrics-text", "openmetrics",
             True),
            ("/metrics", "text/plain", "version=0.0.4", False)):
        code, hdr, raw = _get(srv.port, path,
                              {"Accept": accept} if accept else None)
        assert ctype in hdr["Content-Type"]
        text = raw.decode()
        if exemplars:
            assert text.rstrip().endswith("# EOF")
        samples = _parse_exposition(text, exemplars)
        assert samples["decode_tokens_total"] >= 2
        assert samples["engine_restarts_total"] == 0
    code, hdr, raw = _get(srv.port, "/metrics?format=text")
    assert "text/plain" in hdr["Content-Type"] and b"decode_tokens" in raw
    health = json.loads(_get(srv.port, "/health")[2])
    assert health["status"] == "ok" and health["params"] > 0
    assert json.loads(_get(srv.port, "/healthz")[2]) == {"status": "up"}
    ready = json.loads(_get(srv.port, "/readyz")[2])
    assert ready["ready"] is True and ready["restarts"] == 0
    info = json.loads(_get(srv.port, "/info")[2])
    assert info["supervisor"]["ready"] and info["batching"]
    assert info["decode"]["prefill_captures"] == \
        len(srv.decoder._chunk_runners) > 0
    code, _, raw = _get(srv.port, "/debug/engine")
    dbg = json.loads(raw)
    assert code == 200 and dbg["paged"] is True
    assert len(dbg["slots"]) == srv.decoder.n_slots
    assert {"costs", "phases"} <= set(dbg)
    assert dbg["costs"]["per_invocation"]["decode"]
    with pytest.raises(urllib.error.HTTPError) as ei:  # opt-in only
        _get(srv.port, "/admin/failpoints")
    assert ei.value.code == 403


def test_admin_drain_with_requests_in_flight_drops_none():
    net = _lm()
    srv = InferenceServer(net=net, decode_slots=2, prefill_chunk=16,
                          failpoint_endpoint=True, device="cpu").start()
    try:
        old = srv.decoder
        prompts = [[int(t) for t in np.random.default_rng(i).integers(
            0, V, 20)] for i in range(4)]
        want = [generate_transformer(net, p, 40, V) for p in prompts]
        outs = [None] * len(prompts)

        def client(i):
            outs[i] = _post(srv.port, "/generate",
                            {"prompt": prompts[i], "max_new_tokens": 40})

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(prompts))]
        for t in threads:
            t.start()
        # every request admitted or queued before the drain: in flight
        deadline = time.monotonic() + 60
        while old.inflight() < len(prompts) and time.monotonic() < deadline:
            time.sleep(0.002)
        resp = _post(srv.port, "/admin/drain", {})
        assert resp["status"] == "draining" and resp["request_id"]
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        assert [o["tokens"] for o in outs] == want
        deadline = time.monotonic() + 60
        while srv.decoder is old and time.monotonic() < deadline:
            time.sleep(0.02)
        assert srv.decoder is not old and srv.ready()[0]
        # the failpoint control plane, opted into
        armed = _post(srv.port, "/admin/failpoints",
                      {"name": "dispatch.decode", "spec": "crash@n:50"})
        assert armed["armed"]["dispatch.decode"]["spec"] == "crash@n:50"
        listing = json.loads(_get(srv.port, "/admin/failpoints")[2])
        assert "pool.alloc" in listing["seams"]
        assert _post(srv.port, "/admin/failpoints",
                     {"name": "*", "spec": None})["armed"] == {}
    finally:
        failpoints.disarm()
        srv.stop()


# -------------------------------------------------------------------- CLI --
def test_cli_serve_flags_parse_and_predict_runs(tmp_path, capsys,
                                                monkeypatch):
    from deeplearning4j_tpu_torch.cli.main import build_parser, main
    args = build_parser().parse_args(
        ["serve", "--model", "m.zip", "--max-batch", "8", "--no-batching",
         "--batch-window-ms", "3", "--queue-size", "9", "--no-supervise",
         "--hang-timeout", "2.5", "--retry-budget", "4",
         "--failpoint", "dispatch.decode=crash@n:2",
         "--failpoint", "pool.alloc=oom", "--failpoint-endpoint"])
    assert (args.max_batch, args.no_batching, args.batch_window_ms,
            args.queue_size, args.no_supervise, args.hang_timeout,
            args.retry_budget, args.failpoint_endpoint) == (
        8, True, 3.0, 9, True, 2.5, 4, True)
    assert args.failpoint == ["dispatch.decode=crash@n:2", "pool.alloc=oom"]
    net = _mlp()
    mpath = tmp_path / "mlp.zip"
    write_model(net, mpath)
    x = _features(7, seed=3)
    csv = tmp_path / "data.csv"
    csv.write_text("\n".join(",".join(str(v) for v in list(row) + [0])
                             for row in x.tolist()) + "\n")
    out = tmp_path / "preds.txt"
    assert main(["predict", "--model", str(mpath), "--input", str(csv),
                 "--output", str(out), "--batch", "3",
                 "--device", "cpu"]) == 0
    got = [int(v) for v in out.read_text().split()]
    assert got == net.predict(x).tolist()
    # serve without --generate: /predict only, micro-batched
    assert main(["serve", "--model", str(mpath), "--device", "cpu",
                 "--once"]) == 0
    banner = capsys.readouterr().out
    assert "micro-batched" in banner and "/generate" not in banner
    # serve --generate with chaos seams from a flag and the environment
    lpath = tmp_path / "lm.zip"
    write_model(_lm(), lpath)
    monkeypatch.setenv("DL4J_FAILPOINTS", "pool.alloc=oom@n:1000")
    try:
        assert main(["serve", "--model", str(lpath), "--generate",
                     "--prefill-chunk", "16", "--hang-timeout", "2",
                     "--failpoint", "dispatch.decode=crash@n:1000",
                     "--failpoint-endpoint", "--device", "cpu",
                     "--once"]) == 0
        banner = capsys.readouterr().out
        assert set(failpoints.snapshot()) == {"dispatch.decode",
                                             "pool.alloc"}
    finally:
        failpoints.disarm()
    assert "failpoints ARMED: dispatch.decode, pool.alloc" in banner
    assert "supervised (hang timeout 2.0s" in banner
    assert "prefill graphs 1" in banner
    assert main(["serve", "--model", str(lpath), "--generate",
                 "--failpoint", "nonsense", "--device", "cpu",
                 "--once"]) == 2


# -------------------------------------------------------------- streaming --
def test_streaming_converter_and_pipeline_match_the_jax_module():
    from deeplearning4j_tpu.serving.streaming import \
        RecordToDataSetConverter as JConv
    from deeplearning4j_tpu_torch.serving.streaming import (
        QueueDataSetIterator, RecordToDataSetConverter,
        StreamingTrainingPipeline)
    rng = np.random.default_rng(4)
    records = [[str(v) for v in rng.normal(size=4)] + [str(int(c))]
               for c in rng.integers(0, 3, 12)]
    for kw in ({"label_index": -1}, {"label_index": -1, "num_classes": 3},
               {"label_index": 0, "regression": True},
               {"label_index": None}):
        a, b = JConv(**kw).convert(records), \
            RecordToDataSetConverter(**kw).convert(records)
        np.testing.assert_array_equal(np.asarray(a.features), b.features)
        np.testing.assert_array_equal(np.asarray(a.labels), b.labels)
    with pytest.raises(ValueError, match="num_classes"):
        RecordToDataSetConverter(label_index=-1, num_classes=2).convert(
            records)
    it = QueueDataSetIterator(idle_timeout=0.05, poll_timeout=0.01)
    assert it.next_batch() is None  # idle past the timeout
    # train from a stream: the same steps as fit_batch on the same batches
    batches = [records[i:i + 4] for i in range(0, 12, 4)]
    conv = RecordToDataSetConverter(label_index=-1, num_classes=3)
    streamed, direct = _mlp(), _mlp()
    pipe = StreamingTrainingPipeline(streamed, conv).start()
    for b in batches:
        pipe.push_records(b)
    pipe.finish(timeout=60)
    for b in batches:
        ds = conv.convert(b)
        direct.fit_batch(ds.features, ds.labels)
    assert len(streamed.params) == len(direct.params)
    for sp, dp in zip(streamed.params, direct.params):
        for n, a in dp.items():
            torch.testing.assert_close(sp[n], a)
