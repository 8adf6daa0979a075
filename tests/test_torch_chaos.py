"""Port chaos suite: the cases of tests/test_chaos.py (:171-320) on the
port's supervised server, on the CPU.

Every seam the port plants is armed in turn under concurrent /generate
load (4 clients, 8 requests, half greedy, half seeded-sampled), with the
engine's transfer guard on. Per seam:

  - no request lost (the retrying client rides the 5xx windows);
  - none answered twice (each request_id has at most one ``finish``
    record in the flight recorder: a fenced engine cannot finish a
    handle its replacement owns);
  - the tokens equal the JAX `DecodeScheduler`'s no-fault tokens for the
    same prompts and seeds (the port net carries the JAX params);
  - engine seams force a restart whose engine built every runner in its
    warmup and none under traffic; recovered requests report ``retries``.

`/readyz` flips unready during a hang's recovery and back; the paged
engine survives an injected OOM out of `KVPool.alloc`; the batcher seam
fails a batch, and the retry gets the fault-free predictions; the Chrome
export carries the recovery records with every span closed.
"""
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.inference import DecodeScheduler as JEngine
from deeplearning4j_tpu.inference import MetricsRegistry as JRegistry
from deeplearning4j_tpu.models.zoo import transformer_lm as jlm
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu_torch.inference import failpoints
from deeplearning4j_tpu_torch.nn.conf.graph import \
    ComputationGraphConfiguration as TConf
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph as TGraph
from deeplearning4j_tpu_torch.serving.server import InferenceServer
from deeplearning4j_tpu_torch.util.model_serializer import params_from_jax

from test_torch_metrics_trace import _validate_chrome

V = 13
N_CLIENTS = 4
REQS_EACH = 2
NEW_TOKENS = 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tier-1 runs several test files at once on a few cores; one torch
    intra-op thread keeps this file from starving the others' timings."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def nets():
    conf = jlm(vocab_size=V, d_model=16, n_heads=2, n_blocks=2, rope=True)
    for vert in conf.vertices.values():
        layer = getattr(vert, "layer", None)
        if layer is not None and hasattr(layer, "max_cache_len"):
            layer.max_cache_len = 96
    jnet = JGraph(conf).init()
    tnet = TGraph(TConf.from_json(jnet.conf.to_json()), device="cpu").init()
    tnet.set_params(params_from_jax(
        {k: {n: np.asarray(a) for n, a in lp.items()}
         for k, lp in jnet.params.items()}))
    return jnet, tnet


def _mk_prompts():
    rng = np.random.default_rng(42)
    prompts = []
    for i in range(N_CLIENTS * REQS_EACH):
        p = [int(t) for t in rng.integers(0, V, int(rng.integers(5, 40)))]
        kw = ({} if i % 2 == 0 else
              {"temperature": 0.9, "top_k": 5, "seed": 1000 + i})
        prompts.append((p, kw))
    return prompts


@pytest.fixture(scope="module")
def expected(nets):
    """The JAX engine's no-fault tokens for every request."""
    jnet, _ = nets
    eng = JEngine(jnet, V, n_slots=2, prefill_chunk=16,
                  metrics=JRegistry()).start()
    try:
        hs = [eng.submit(p, NEW_TOKENS, **kw) for p, kw in _mk_prompts()]
        return [h.result(timeout=300) for h in hs]
    finally:
        eng.stop()


def _post_retry(port, path, body, timeout=120, max_retries=10):
    """The chaos client: capped-backoff retries on 5xx and connection
    errors, Retry-After honoured — a request is only lost if even this
    gives up."""
    attempt = 0
    while True:
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}{path}", data=body,
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=timeout) as r:
                return json.loads(r.read())
        except urllib.error.HTTPError as e:
            if e.code < 500:
                raise
            delay = min(1.0, 0.05 * (2 ** attempt))
            ra = e.headers.get("Retry-After") if e.headers else None
            if ra:
                delay = max(delay, float(ra))
            e.read()
        except urllib.error.URLError:
            delay = min(1.0, 0.05 * (2 ** attempt))
        attempt += 1
        if attempt > max_retries:
            raise RuntimeError(f"request lost: {max_retries} retries "
                               "exhausted")
        time.sleep(delay)


def _drive_generate(srv, prompts):
    """Concurrent /generate load; the outputs by request index."""
    out = [None] * len(prompts)
    errors = []

    def client(k):
        for i in range(k, len(prompts), N_CLIENTS):
            prompt, kw = prompts[i]
            body = json.dumps({"prompt": prompt,
                               "max_new_tokens": NEW_TOKENS, **kw}).encode()
            try:
                out[i] = _post_retry(srv.port, "/generate", body)
            except Exception as e:  # noqa: BLE001 - the lost-request record
                errors.append((i, repr(e)))

    threads = [threading.Thread(target=client, args=(k,))
               for k in range(N_CLIENTS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    assert not errors, f"requests lost under chaos: {errors}"
    return out


def _finish_counts(tracer):
    """request_id -> number of terminal `finish` records."""
    counts = {}
    for ev in tracer.events():
        if ev["ph"] == "i" and ev["name"] == "finish":
            rid = ev.get("args", {}).get("request_id")
            if rid:
                counts[rid] = counts.get(rid, 0) + 1
    return counts


def _await_ready(srv, deadline_s=60):
    deadline = time.monotonic() + deadline_s
    while time.monotonic() < deadline:
        ok, _ = srv.ready()
        if ok:
            return
        time.sleep(0.02)
    raise AssertionError("server never became ready again")


def _warmed_only(eng):
    """The engine built every runner in warmup() and none since."""
    tables = eng.table_buckets if eng.paged else [None]
    return (eng._warmed and eng.decode_captures == len(tables)
            and eng.prefill_captures
            == len(eng.prefill_buckets) * len(tables))


def _restart_report(srv, before_restarts, fired):
    """What a failed restart count needs to name its cause: the restarts
    and faults of this case, each restart's recorded reason (crash or
    hang, with the dead engine's passes and heartbeat age) and the live
    engine's captures against its buckets."""
    sup = srv.supervisor
    eng = sup.engine
    tables = eng.table_buckets if eng.paged else [None]
    return (f"restarts {before_restarts} -> {sup.restarts}, faults fired "
            f"{fired}; reasons {sup.restart_log[before_restarts:]}; engine "
            f"warmed {eng._warmed}, decode captures {eng.decode_captures} "
            f"of {len(tables)}, prefill captures {eng.prefill_captures} of "
            f"{len(eng.prefill_buckets) * len(tables)}")


@pytest.fixture(scope="module")
def decode_server(nets):
    """One supervised /generate server shared by the engine-seam cases
    (each arms, drives, disarms, waits ready), the transfer guard on
    through the crashes."""
    _, tnet = nets
    srv = InferenceServer(net=tnet, decode_slots=2, prefill_chunk=16,
                          hang_timeout_s=1.0, retry_budget=6,
                          decode_transfer_guard="disallow",
                          device="cpu").start()
    srv.supervisor.poll_interval_s = 0.02
    srv.supervisor.backoff_base_s = 0.01
    srv.supervisor.backoff_max_s = 0.1
    yield srv
    failpoints.disarm()
    srv.stop()


@pytest.fixture(scope="module")
def reference(decode_server, expected):
    """The no-fault run on the port's server equals the JAX engine's."""
    prompts = _mk_prompts()
    outs = _drive_generate(decode_server, prompts)
    assert [o["tokens"] for o in outs] == expected
    return prompts, expected


@pytest.mark.parametrize("seam,spec", [
    ("scheduler.iteration", "crash@n:4"),
    ("dispatch.decode", "crash@once"),
    ("dispatch.prefill", "crash@once"),
    ("dispatch.decode", "oom@n:3"),
    ("scheduler.iteration", "hang:2000@once"),
    ("http.handler", "crash@n:3"),
])
def test_seam_armed_no_loss_no_dup_token_identical(decode_server,
                                                   reference, seam, spec):
    srv = decode_server
    prompts, expected = reference
    before_restarts = srv.supervisor.restarts
    triggers_before = srv.metrics.counter("failpoint_triggers_total").value
    failpoints.arm(seam, spec)
    try:
        outs = _drive_generate(srv, prompts)
    finally:
        failpoints.disarm()
    _await_ready(srv)
    fired = srv.metrics.counter("failpoint_triggers_total").value \
        - triggers_before
    assert fired >= 1, "the seam never fired"
    assert [o["tokens"] for o in outs] == expected, f"seam {seam}"
    dups = {rid: n for rid, n in
            _finish_counts(srv.tracer).items() if n > 1}
    assert not dups, f"double-finished requests under {seam}: {dups}"
    if seam != "http.handler":
        # one restart per fault fired
        report = _restart_report(srv, before_restarts, fired)
        assert srv.supervisor.restarts - before_restarts == fired, report
        assert _warmed_only(srv.supervisor.engine), report
        assert any(o.get("retries") for o in outs), \
            "no request reports surviving the restart"


def test_readyz_flips_unready_during_recovery_and_back(decode_server,
                                                       reference):
    srv = decode_server
    prompts, expected = reference
    readyz_codes = []
    stop_probe = threading.Event()

    def probe():
        while not stop_probe.is_set():
            try:
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{srv.port}/readyz",
                        timeout=10) as r:
                    readyz_codes.append(r.status)
            except urllib.error.HTTPError as e:
                readyz_codes.append(e.code)
                e.read()
            time.sleep(0.01)

    th = threading.Thread(target=probe)
    th.start()
    # a hang long enough that the unready window spans several samples
    failpoints.arm("scheduler.iteration", "hang:2000@once")
    try:
        outs = _drive_generate(srv, prompts)
    finally:
        failpoints.disarm()
        _await_ready(srv)
        time.sleep(0.05)
        stop_probe.set()
        th.join(timeout=10)
    assert not th.is_alive()
    assert [o["tokens"] for o in outs] == expected
    assert 503 in readyz_codes, "readyz never flipped unready"
    assert readyz_codes[-1] == 200, "readyz did not recover"


def test_pool_alloc_oom_seam_paged_engine(nets, expected):
    """InjectedOOM out of KVPool.alloc kills the paged engine's loop;
    recovery rebuilds the pool and tables and replays — the same
    tokens."""
    _, tnet = nets
    srv = InferenceServer(net=tnet, decode_slots=4, prefill_chunk=16,
                          kv_pool_mb=1.0, kv_block=8, hang_timeout_s=30.0,
                          retry_budget=6, decode_transfer_guard="disallow",
                          device="cpu").start()
    srv.supervisor.backoff_base_s = 0.01
    srv.supervisor.backoff_max_s = 0.1
    try:
        assert srv.supervisor.engine.paged
        prompts = _mk_prompts()
        assert [o["tokens"] for o in _drive_generate(srv, prompts)] \
            == expected
        failpoints.arm("pool.alloc", "oom@n:2")
        try:
            outs = _drive_generate(srv, prompts)
        finally:
            failpoints.disarm()
        assert [o["tokens"] for o in outs] == expected
        assert srv.supervisor.restarts == 1
        assert _warmed_only(srv.supervisor.engine)
        dups = {rid: n for rid, n in
                _finish_counts(srv.tracer).items() if n > 1}
        assert not dups
    finally:
        failpoints.disarm()
        srv.stop()


def test_batcher_flush_seam_predict_path():
    """An injected crash in the micro-batcher's dispatch fails that
    batch's futures -> HTTP 500 -> the retrying client resubmits -> the
    fault-free predictions."""
    from deeplearning4j_tpu_torch.nn.conf.config import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.conf.layers import (DenseLayer,
                                                          OutputLayer)
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    b = NeuralNetConfiguration.builder().seed(1).learning_rate(0.01).list()
    b.layer(DenseLayer(n_in=8, n_out=16, activation="relu"))
    b.layer(OutputLayer(n_in=16, n_out=3, activation="softmax",
                        loss="mcxent"))
    net = MultiLayerNetwork(b.build(), device="cpu").init()
    srv = InferenceServer(net=net, batching=True, batch_window_ms=1.0,
                          device="cpu").start()
    try:
        rng = np.random.default_rng(0)
        body = json.dumps({"data": rng.standard_normal((4, 8)).tolist()}
                          ).encode()
        expected = _post_retry(srv.port, "/predict", body)
        failpoints.arm("batcher.flush", "crash@once")
        try:
            out = _post_retry(srv.port, "/predict", body)
        finally:
            failpoints.disarm()
        assert out["predictions"] == expected["predictions"]
        assert srv.metrics.counter("failpoint_triggers_total").value >= 1
    finally:
        failpoints.disarm()
        srv.stop()


def test_chrome_export_carries_recovery_records(decode_server):
    trace = decode_server.tracer.chrome_trace()
    names = {e["name"] for e in trace["traceEvents"]}
    assert {"engine_restart", "recovered"} <= names, sorted(names)
    assert "engine_crash" in names or "engine_hang" in names
    _validate_chrome(trace)
