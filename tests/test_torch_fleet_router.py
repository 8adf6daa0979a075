"""Port: the fleet — the journaled router (`serving/router.py`), replica
processes (`serving/replica.py`) and the durable request journal.

- The unit and stub-replica cases of tests/test_fleet_router.py,
  parametrised over the JAX package and the port: affinity keys, portless
  endpoint URLs, rendezvous determinism and minimal reshuffle, quorum
  readiness, a replica's 503 passed through with its Retry-After, a 504
  kept terminal, the journal replay balancing the resource ledger, and
  the burning fleet's admission reject.
- Cross-package: `affinity_key` and `pick_replica` pick the same replica
  over 1000 seeded keys and 2-5 names; a journal either package's
  `RequestJournal` writes, the other's recovers.
- The fleet path: a port `FleetRouter` over two in-process port
  `InferenceServer`s loaded from one JAX-written model zip serves the
  JAX `DecodeScheduler`'s tokens, greedy and seeded, and a repeat routes
  by the prefix directory to the replica holding the chain
  (tests/test_kvtier.py:572).
- The subprocess drills of tests/test_fleet_router.py with port replicas
  on ``--device cpu`` at the JAX suite's widths: clean-fleet identity and
  affinity, a replica SIGKILLed mid-decode, a router SIGKILLed between
  its journal append and its dispatch (``router.dispatch`` armed through
  ``DL4J_FAILPOINTS`` in the child), env-armed seams inside a replica,
  the rolling drain, and the JAX race checker over the port router's
  shared state. The port's CLI ``router`` subcommand, and its refusal to
  spawn cuda replicas without a card.
- The port's new modules import neither jax nor deeplearning4j_tpu.
"""
import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
import zlib
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.analysis import resource_ledger as jledger
from deeplearning4j_tpu.inference import MetricsRegistry as JMetrics
from deeplearning4j_tpu.serving import durable as jdurable
from deeplearning4j_tpu.serving import replica as jreplica
from deeplearning4j_tpu.serving import router as jrouter
from deeplearning4j_tpu_torch.analysis.runtime import \
    resource_ledger as tledger
from deeplearning4j_tpu_torch.inference import failpoints as tfailpoints
from deeplearning4j_tpu_torch.inference.metrics import \
    MetricsRegistry as TMetrics
from deeplearning4j_tpu_torch.serving import durable as tdurable
from deeplearning4j_tpu_torch.serving import replica as treplica
from deeplearning4j_tpu_torch.serving import router as trouter
from deeplearning4j_tpu_torch.serving.replica import (ReplicaProcess,
                                                      ReplicaSupervisor,
                                                      lm_spec_argv)
from deeplearning4j_tpu_torch.serving.router import FleetRouter

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
V = 13
KV_BLOCK = 8
NEW_TOKENS = 8
N_CLIENTS = 4

ROUTER = {"jax": jrouter, "port": trouter}
REPLICA = {"jax": jreplica, "port": treplica}
DURABLE = {"jax": jdurable, "port": tdurable}
METRICS = {"jax": JMetrics, "port": TMetrics}
LEDGER = {"jax": jledger, "port": tledger}
PKGS = pytest.mark.parametrize("pkg", ["jax", "port"])


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _disarm():
    yield
    tfailpoints.disarm()


def _replica_argv():
    return lm_spec_argv(vocab=V, d_model=16, n_heads=2, n_blocks=2,
                        cache=96) + [
        "--device", "cpu", "--slots", "2", "--prefill-chunk", "16",
        "--prefix-cache-mb", "8", "--kv-block", str(KV_BLOCK),
        "--hang-timeout", "5", "--retry-budget", "6"]


def _post_retry(port, path, body, timeout=120, max_retries=12,
                headers=None):
    """The chaos client: rides 5xx and connection-refused windows with a
    capped backoff, honours Retry-After; a request is lost only if even
    this gives up."""
    attempt = 0
    while True:
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}{path}", data=body,
            headers={"Content-Type": "application/json",
                     **(headers or {})})
        try:
            return json.loads(urllib.request.urlopen(req, timeout=timeout)
                              .read())
        except urllib.error.HTTPError as e:
            if e.code < 500 and e.code != 503:
                raise
            delay = min(1.0, 0.05 * (2 ** attempt))
            ra = e.headers.get("Retry-After") if e.headers else None
            if ra:
                delay = max(delay, float(ra))
            e.read()
        except (urllib.error.URLError, OSError):
            delay = min(1.0, 0.05 * (2 ** attempt))
        attempt += 1
        if attempt > max_retries:
            raise RuntimeError(f"request lost: {max_retries} retries "
                               "exhausted")
        time.sleep(delay)


def _mk_prompts(n=8, repeat=2):
    """n distinct prompts, each `repeat` times, all greedy."""
    rng = np.random.default_rng(7)
    distinct = [[int(t) for t in rng.integers(0, V,
                                              int(rng.integers(12, 40)))]
                for _ in range(n)]
    return [p for p in distinct for _ in range(repeat)]


def _drive(port, prompts, max_new=NEW_TOKENS):
    out = [None] * len(prompts)
    errors = []

    def client(k):
        for i in range(k, len(prompts), N_CLIENTS):
            body = json.dumps({"prompt": prompts[i],
                               "max_new_tokens": max_new}).encode()
            try:
                out[i] = _post_retry(port, "/generate", body)
            except Exception as e:  # noqa: BLE001 - the lost-request record
                errors.append((i, repr(e)))

    threads = [threading.Thread(target=client, args=(k,))
               for k in range(N_CLIENTS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, f"requests lost: {errors}"
    return out


def _replica_finish_counts(url):
    """request_id -> finish-instant count from a replica's recorder."""
    snap = json.loads(urllib.request.urlopen(
        url + "/trace", timeout=10).read())
    counts = {}
    for ev in snap.get("events", []):
        if ev.get("ph") == "i" and ev.get("name") == "finish":
            rid = (ev.get("args") or {}).get("request_id")
            if rid:
                counts[rid] = counts.get(rid, 0) + 1
    return counts


def _journal_records(path, pkg="port"):
    c = DURABLE[pkg].DurableLogConsumer(
        path, group=f"audit{time.monotonic_ns()}")
    recs = []
    while True:
        batch = c.poll(256)
        if not batch:
            break
        recs += batch
    if os.path.exists(c.cursor_path):
        os.unlink(c.cursor_path)
    return recs


def _journal_audit(path, pkg="port"):
    """(accept rids, finish counts per rid, fail counts per rid)."""
    accepts, finishes, fails = [], {}, {}
    for r in _journal_records(path, pkg):
        if r["t"] == "accept":
            accepts.append(r["rid"])
        elif r["t"] == "finish":
            finishes[r["rid"]] = finishes.get(r["rid"], 0) + 1
        elif r["t"] == "fail":
            fails[r["rid"]] = fails.get(r["rid"], 0) + 1
    return accepts, finishes, fails


# ---------------------------------------------------------------------------
# pure units: affinity + rendezvous
# ---------------------------------------------------------------------------

@PKGS
def test_affinity_key_is_block_aligned(pkg):
    affinity_key = ROUTER[pkg].affinity_key
    a = affinity_key(list(range(20)), kv_block=8)
    b = affinity_key(list(range(8)) + [99] * 12, kv_block=8)
    assert a == b
    assert affinity_key(list(range(20)), 8) != affinity_key(
        [1] + list(range(1, 20)), 8)
    assert affinity_key([1, 2, 3], 8) != affinity_key([4, 5], 8)
    c = affinity_key(list(range(32)), 8, affinity_blocks=2)
    d = affinity_key(list(range(8)) + [99] * 24, 8, affinity_blocks=2)
    assert c != d
    assert affinity_key(list(range(32)), 8) == affinity_key(
        list(range(8)) + [99] * 24, 8)


@PKGS
def test_replica_endpoint_parses_portless_urls(pkg):
    ep = ROUTER[pkg].ReplicaEndpoint
    assert ep("http://replica-a.internal", "a").port == 80
    assert ep("https://replica-b.internal", "b").port == 443
    assert ep("http://10.0.0.1:8080/v1", "c").port == 8080
    assert ep("127.0.0.1:9999", "d").port == 9999


@PKGS
def test_rendezvous_is_deterministic_and_minimal_reshuffle(pkg):
    r = ROUTER[pkg]
    cands = [(f"r{i}", f"u{i}") for i in range(4)]
    keys = [r.affinity_key([i, i + 1, i + 2] * 5, 4) for i in range(64)]
    owner = {k: r.pick_replica(k, cands) for k in keys}
    assert owner == {k: r.pick_replica(k, cands) for k in keys}
    assert len({o[0] for o in owner.values()}) > 1
    survivors = [c for c in cands if c[0] != "r1"]
    for k, o in owner.items():
        if o[0] != "r1":
            assert r.pick_replica(k, survivors) == o
    with pytest.raises(r.NoReplicaError):
        r.pick_replica(b"x", [])


def test_rendezvous_picks_equal_jax_over_seeded_keys():
    """The same key and names pick the same replica in both packages:
    1000 seeded prompts (lengths 1-80, kv_block 8 or 16, 1-3 affinity
    blocks) over 2-5 replica names."""
    rng = np.random.default_rng(0)
    for _ in range(1000):
        prompt = [int(t) for t in rng.integers(0, 50000,
                                               int(rng.integers(1, 81)))]
        kv_block = int(rng.choice([8, 16]))
        blocks = int(rng.integers(1, 4))
        jk = jrouter.affinity_key(prompt, kv_block, blocks)
        tk = trouter.affinity_key(prompt, kv_block, blocks)
        assert jk == tk
        n = int(rng.integers(2, 6))
        names = [f"r{int(x)}" for x in rng.choice(100, n, replace=False)]
        cands = [(nm, f"http://h{nm}") for nm in names]
        assert jrouter.pick_replica(jk, cands) == \
            trouter.pick_replica(tk, cands)


# ---------------------------------------------------------------------------
# stub-replica units: quorum readiness + Retry-After propagation
# ---------------------------------------------------------------------------

class _StubReplica:
    """A fake replica: scripted /readyz and /generate answers."""

    def __init__(self, ready=True, generate=None):
        self.ready = ready
        self.generate = generate or (200, {"tokens": [1, 2]}, {})
        stub = self

        class H(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _send(self, code, body, headers=None):
                raw = json.dumps(body).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(raw)))
                for k, v in (headers or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(raw)

            def do_GET(self):
                if self.path.startswith("/readyz"):
                    self._send(200 if stub.ready else 503,
                               {"ready": stub.ready})
                elif self.path.startswith("/metrics"):
                    self._send(200, {})
                else:
                    self._send(404, {})

            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0))
                self.rfile.read(n)
                code, body, headers = stub.generate
                self._send(code, body, headers)

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), H)
        # a short shutdown poll: a stub's stop() should not cost 0.5 s
        self.thread = threading.Thread(target=self.httpd.serve_forever,
                                       args=(0.05,), daemon=True)
        self.thread.start()

    @property
    def url(self):
        return f"http://127.0.0.1:{self.httpd.server_address[1]}"

    def stop(self):
        self.httpd.shutdown()
        self.httpd.server_close()


@PKGS
def test_readyz_aggregates_quorum(tmp_path, pkg):
    r, rep = ROUTER[pkg], REPLICA[pkg]
    up, down = _StubReplica(ready=True), _StubReplica(ready=False)
    sup = rep.ReplicaSupervisor(
        [r.ReplicaEndpoint(up.url, "up"), r.ReplicaEndpoint(down.url, "down")],
        poll_interval_s=0.05, metrics=METRICS[pkg]())
    sup.start(wait=False)
    router = r.FleetRouter(supervisor=sup, quorum=2,
                           journal_path=str(tmp_path / "j.log"),
                           scrape_interval_s=0.05, startup_wait_s=0).start()
    try:
        ok, body = router.ready()
        assert not ok and body["replicas_ready"] == 1
        assert body["reason"].startswith("quorum")
        assert body["replicas"]["down"]["ready"] is False
        assert body["replicas"]["up"]["ready"] is True
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(
                f"http://127.0.0.1:{router.port}/readyz", timeout=10)
        assert ei.value.code == 503
        ei.value.read()
        down.ready = True
        deadline = time.monotonic() + 5
        while time.monotonic() < deadline and not router.ready()[0]:
            time.sleep(0.05)
        assert router.ready()[0]
    finally:
        router.stop(stop_replicas=False)
        sup.stop()
        up.stop()
        down.stop()


@PKGS
def test_replica_503_retry_after_propagates_unchanged(tmp_path, pkg):
    r, rep = ROUTER[pkg], REPLICA[pkg]
    busy = _StubReplica(
        ready=True,
        generate=(503, {"error": "not_admitting", "retry_after_s": 7.0},
                  {"Retry-After": "7"}))
    sup = rep.ReplicaSupervisor([r.ReplicaEndpoint(busy.url, "busy")],
                                poll_interval_s=0.05,
                                metrics=METRICS[pkg]())
    router = r.FleetRouter(supervisor=sup, quorum=1,
                           journal_path=str(tmp_path / "j.log"),
                           scrape_interval_s=0.05).start()
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{router.port}/generate",
            data=json.dumps({"prompt": [1, 2, 3],
                             "max_new_tokens": 2}).encode(),
            headers={"Content-Type": "application/json"})
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(req, timeout=10)
        e = ei.value
        body = json.loads(e.read().decode())
        assert e.code == 503
        assert e.headers.get("Retry-After") == "7"
        assert body["error"] == "not_admitting"
        assert body["retry_after_s"] == 7.0
        accepts, finishes, fails = _journal_audit(str(tmp_path / "j.log"),
                                                  pkg)
        assert len(accepts) == 1 and not finishes
        assert fails[accepts[0]] == 1
    finally:
        router.stop(stop_replicas=False)
        sup.stop()
        busy.stop()


@PKGS
def test_replica_504_is_terminal_not_failed_over(tmp_path, pkg):
    r, rep = ROUTER[pkg], REPLICA[pkg]
    slow = _StubReplica(ready=True,
                        generate=(504, {"error": "deadline exceeded"}, {}))
    ok_rep = _StubReplica(ready=True)
    sup = rep.ReplicaSupervisor(
        [r.ReplicaEndpoint(slow.url, "slow"),
         r.ReplicaEndpoint(ok_rep.url, "ok")],
        poll_interval_s=0.05, metrics=METRICS[pkg]())
    router = r.FleetRouter(supervisor=sup, quorum=1,
                           journal_path=str(tmp_path / "j.log"),
                           scrape_interval_s=0.05).start()
    try:
        prompt = [1, 2, 3]
        for seed in range(64):
            prompt = [seed, seed + 1, seed + 2]
            cands = sorted((n, u) for n, u in sup.ready_replicas())
            if r.pick_replica(r.affinity_key(prompt, 16),
                              cands)[0] == "slow":
                break
        req = urllib.request.Request(
            f"http://127.0.0.1:{router.port}/generate",
            data=json.dumps({"prompt": prompt,
                             "max_new_tokens": 2}).encode(),
            headers={"Content-Type": "application/json"})
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(req, timeout=10)
        assert ei.value.code == 504
        assert json.loads(ei.value.read())["error"] == "deadline exceeded"
        accepts, finishes, fails = _journal_audit(str(tmp_path / "j.log"),
                                                  pkg)
        assert len(accepts) == 1 and not finishes
        assert fails[accepts[0]] == 1
    finally:
        router.stop(stop_replicas=False)
        sup.stop()
        slow.stop()
        ok_rep.stop()


@PKGS
def test_journal_replay_balances_resource_ledger(tmp_path, pkg):
    """A predecessor's journal holds an accept with no terminal record;
    the next incarnation inherits it (+1 on its ledger), the replay's
    finish settles it, and a live request's pair balances too."""
    r, rep = ROUTER[pkg], REPLICA[pkg]
    jpath = str(tmp_path / "j.log")
    j = r.RequestJournal(jpath)
    j.accept("req-inherited", {"prompt": [1, 2, 3], "max_new_tokens": 2})
    j.close()
    ok_rep = _StubReplica(ready=True)
    with LEDGER[pkg]() as led:
        sup = rep.ReplicaSupervisor([r.ReplicaEndpoint(ok_rep.url, "r0")],
                                    poll_interval_s=0.05,
                                    metrics=METRICS[pkg]())
        router = r.FleetRouter(supervisor=sup, quorum=1, journal_path=jpath,
                               scrape_interval_s=0.05).start()
        try:
            body = json.dumps({"prompt": [4, 5, 6],
                               "max_new_tokens": 2}).encode()
            live = _post_retry(router.port, "/generate", body)
            assert live.get("tokens") is not None
            deadline = time.monotonic() + 60
            while time.monotonic() < deadline:
                with router._lock:
                    if router.replayed_total >= 1:
                        break
                time.sleep(0.05)
            with router._lock:
                assert router.replayed_total == 1
        finally:
            router.stop(stop_replicas=False)
            sup.stop()
    ok_rep.stop()
    accepts, finishes, fails = _journal_audit(jpath, pkg)
    assert finishes.get("req-inherited") == 1 and not fails
    snap = led.snapshot()
    assert snap["kinds"]["journal_record"]["acquires"] >= 2
    led.assert_clean()


@PKGS
def test_burning_fleet_rejects_with_retry_after(tmp_path, pkg):
    r, rep = ROUTER[pkg], REPLICA[pkg]
    ok_rep = _StubReplica(ready=True)
    sup = rep.ReplicaSupervisor([r.ReplicaEndpoint(ok_rep.url, "r0")],
                                poll_interval_s=0.05,
                                metrics=METRICS[pkg]())
    router = r.FleetRouter(supervisor=sup, quorum=1,
                           journal_path=str(tmp_path / "j.log"),
                           scrape_interval_s=3600).start()
    try:
        body = json.dumps({"prompt": [1, 2, 3],
                           "max_new_tokens": 2}).encode()
        assert _post_retry(router.port, "/generate", body)["tokens"] == [1, 2]
        with router._lock:
            router._admission = {"burning": True, "fast": 9.0,
                                 "slow": 4.0, "replicas_up": 1}
        req = urllib.request.Request(
            f"http://127.0.0.1:{router.port}/generate", data=body,
            headers={"Content-Type": "application/json"})
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(req, timeout=10)
        assert ei.value.code == 503
        assert ei.value.headers.get("Retry-After") is not None
        assert json.loads(ei.value.read().decode())["error"] == \
            "fleet_burning"
        accepts, _f, _x = _journal_audit(str(tmp_path / "j.log"), pkg)
        assert len(accepts) == 1
        with router._lock:
            router._admission = {"burning": False, "fast": 0.0,
                                 "slow": 0.0, "replicas_up": 1}
        assert _post_retry(router.port, "/generate",
                           body)["tokens"] == [1, 2]
    finally:
        router.stop(stop_replicas=False)
        sup.stop()
        ok_rep.stop()


# ---------------------------------------------------------------------------
# journals across the packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_journal_written_by_one_package_recovers_in_the_other(tmp_path,
                                                              writer,
                                                              reader):
    """A crashed router of one package left three accepts, one finished
    and one failed; the other package's journal recovers exactly the
    unterminated one, in order, then dedups a second terminal record and
    commits the whole journal through."""
    jpath = str(tmp_path / "j.log")
    j = ROUTER[writer].RequestJournal(jpath)
    for i in range(4):
        j.accept(f"rid-{i}", {"prompt": [i, i + 1], "max_new_tokens": 2})
    j.finish("rid-0", tokens=[5, 6], replica="r0")
    j.fail("rid-2", "replica r1 503", status=503)
    j.close()
    j2 = ROUTER[reader].RequestJournal(jpath)
    rec = j2.recover()
    assert [x["rid"] for x in rec] == ["rid-1", "rid-3"]
    assert rec[0]["req"] == {"prompt": [1, 2], "max_new_tokens": 2}
    assert j2.finish("rid-1", tokens=[1], replica="r0", replay=True)
    assert j2.finish("rid-3", tokens=[3], replica="r1", replay=True)
    assert not j2.finish("rid-3", tokens=[3], replica="r1")
    assert j2.stats()["duplicate_finishes_suppressed"] == 1
    j2.advance()
    assert j2.stats()["uncommitted_records"] == 0
    j2.close()
    # the writer's package reads the whole journal back, record for record
    recs = _journal_records(jpath, writer)
    assert [(x["t"], x["rid"]) for x in recs] == [
        ("accept", "rid-0"), ("accept", "rid-1"), ("accept", "rid-2"),
        ("accept", "rid-3"), ("finish", "rid-0"), ("fail", "rid-2"),
        ("finish", "rid-1"), ("finish", "rid-3")]
    assert ROUTER[writer].RequestJournal(jpath).recover() == []


# ---------------------------------------------------------------------------
# the fleet path over in-process port servers, against JAX's engine
# ---------------------------------------------------------------------------

def _block_bytes():
    return 2 * 2 * KV_BLOCK * 2 * 8 * 4  # layers x (K, V) x B x Hkv x Dh x 4


@pytest.fixture(scope="module")
def jax_zip(tmp_path_factory):
    """One JAX-written LM zip (cache 96) and the JAX DecodeScheduler's
    greedy and seeded tokens for a few prompts."""
    from deeplearning4j_tpu.inference import DecodeScheduler as JEngine
    from deeplearning4j_tpu.models.zoo import transformer_lm as jlm
    from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
    from deeplearning4j_tpu.util.model_serializer import write_model
    conf = jlm(vocab_size=V, d_model=16, n_heads=2, n_blocks=2, rope=True)
    for vert in conf.vertices.values():
        layer = getattr(vert, "layer", None)
        if layer is not None and hasattr(layer, "max_cache_len"):
            layer.max_cache_len = 96
    jnet = JGraph(conf).init()
    path = str(tmp_path_factory.mktemp("zip") / "lm.zip")
    write_model(jnet, path)
    rng = np.random.default_rng(11)
    bodies = []
    for i in range(6):
        body = {"prompt": [int(t) for t in rng.integers(0, V, 17 + 5 * i)],
                "max_new_tokens": 6}
        if i % 2:
            body.update(temperature=0.8, top_k=5, seed=40 + i)
        bodies.append(body)
    # its own registry: the JAX engine's default is process-wide, and a
    # later test in this worker may count on it
    eng = JEngine(jnet, V, n_slots=2, prefill_chunk=16,
                  metrics=JMetrics()).start()
    try:
        want = [eng.generate(b["prompt"], 6, timeout=120,
                             **{k: b[k] for k in ("temperature", "top_k",
                                                  "seed") if k in b})
                for b in bodies]
    finally:
        eng.stop()
    return path, bodies, want


def _port_servers(path, **kw):
    from deeplearning4j_tpu_torch.serving.server import InferenceServer
    return [InferenceServer(model_path=path, decode_slots=2,
                            prefill_chunk=16, kv_block=KV_BLOCK,
                            device="cpu", **kw).start() for _ in range(2)]


def test_port_router_serves_jax_engine_tokens(jax_zip, tmp_path):
    """A port FleetRouter over two port servers restored from one
    JAX-written zip: every answer, greedy and seeded, is the JAX
    DecodeScheduler's; repeats stay on one replica; the journal closes
    every accept with one finish."""
    path, bodies, want = jax_zip
    servers = _port_servers(path, prefix_cache_mb=8)
    jpath = str(tmp_path / "j.log")
    router = FleetRouter(
        replica_urls=[f"http://127.0.0.1:{s.port}" for s in servers],
        kv_block=KV_BLOCK, journal_path=jpath, scrape_interval_s=0.1,
        quorum=2, metrics=TMetrics()).start()
    try:
        outs = [_post_retry(router.port, "/generate",
                            json.dumps(b).encode()) for b in bodies]
        assert [o["tokens"] for o in outs] == want
        again = [_post_retry(router.port, "/generate",
                             json.dumps(b).encode()) for b in bodies]
        assert [o["tokens"] for o in again] == want
        assert [o["router"]["replica"] for o in again] == \
            [o["router"]["replica"] for o in outs]
        accepts, finishes, fails = _journal_audit(jpath)
        assert len(accepts) == 2 * len(bodies) and not fails
        assert all(finishes.get(rid) == 1 for rid in accepts)
        hits = sum(s.metrics.counter("prefix_cache_hits_total").value
                   for s in servers)
        assert hits >= 1
    finally:
        router.stop(stop_replicas=False)
        for s in servers:
            s.stop()


def test_router_routes_repeat_to_the_replica_holding_the_prefix(jax_zip):
    """tests/test_kvtier.py:572 on the port: replica A serves a prompt
    and publishes its chain; the router's directory poll ingests it; the
    repeat is a directory hit routed to the holder, token-identical."""
    path, _bodies, _want = jax_zip
    a, b = _port_servers(path, kv_pool_mb=13 * _block_bytes() / 2 ** 20,
                         host_cache_mb=4.0)
    prompt = [int(x) for x in np.random.default_rng(3).integers(0, V, 41)]
    router = None
    try:
        expected = _post_retry(a.port, "/generate", json.dumps(
            {"prompt": prompt, "max_new_tokens": 6}).encode())
        router = FleetRouter(
            replica_urls=[f"http://127.0.0.1:{a.port}",
                          f"http://127.0.0.1:{b.port}"],
            kv_block=KV_BLOCK, scrape_interval_s=0.1,
            metrics=TMetrics()).start()
        deadline = time.monotonic() + 20
        while time.monotonic() < deadline:
            if router.metrics.gauge("router_directory_entries").value >= 5:
                break
            time.sleep(0.05)
        assert router.metrics.gauge("router_directory_entries").value >= 5
        out = _post_retry(router.port, "/generate", json.dumps(
            {"prompt": prompt, "max_new_tokens": 6}).encode())
        assert out["tokens"] == expected["tokens"]
        assert out["router"]["replica"] == "r0"
        assert router.metrics.counter(
            "router_directory_hits_total").value >= 1
    finally:
        if router is not None:
            router.stop(stop_replicas=False)
        a.stop()
        b.stop()


# ---------------------------------------------------------------------------
# the real fleet: port replica subprocesses on the CPU
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def fleet(tmp_path_factory):
    wd = str(tmp_path_factory.mktemp("fleet"))
    reps = [ReplicaProcess(_replica_argv(), name=f"r{i}", workdir=wd)
            for i in range(2)]
    sup = ReplicaSupervisor(reps, poll_interval_s=0.2,
                            backoff_base_s=0.05, backoff_max_s=1.0,
                            metrics=TMetrics())
    sup.start()
    yield wd, sup
    sup.stop()


def _await_replicas(sup, n, deadline_s=180):
    deadline = time.monotonic() + deadline_s
    while time.monotonic() < deadline:
        if sup.ready_count() >= n:
            return
        time.sleep(0.1)
    raise AssertionError(f"fleet never reached {n} ready replicas: "
                         f"{sup.states()}")


@pytest.fixture(scope="module")
def reference(fleet):
    """The no-fault run through a throwaway router: the token-identity
    baseline and the affinity map."""
    wd, sup = fleet
    _await_replicas(sup, 2)
    router = FleetRouter(supervisor=sup, quorum=2, kv_block=KV_BLOCK,
                         journal_path=os.path.join(wd, "ref.journal"),
                         scrape_interval_s=0.2).start()
    try:
        prompts = _mk_prompts()
        outs = _drive(router.port, prompts)
        return (prompts, [o["tokens"] for o in outs],
                [o["router"]["replica"] for o in outs])
    finally:
        router.stop(stop_replicas=False)


def test_replica_child_environment(tmp_path):
    """A CPU replica's child gets the repository on PYTHONPATH, one torch
    thread, and DL4J_FAILPOINTS only when it was spawned with seams."""
    os.environ["DL4J_FAILPOINTS"] = "dispatch.decode=crash"
    try:
        env = ReplicaProcess(_replica_argv(), workdir=str(tmp_path)) \
            .child_env()
        armed = ReplicaProcess(_replica_argv(), workdir=str(tmp_path),
                               failpoints={"pool.alloc": "oom@n:2"}) \
            .child_env()
        cuda = ReplicaProcess(["--model", "m.zip"], workdir=str(tmp_path),
                              env={"OMP_NUM_THREADS": "4"}).child_env()
    finally:
        del os.environ["DL4J_FAILPOINTS"]
    assert env["PYTHONPATH"].split(os.pathsep)[0] == REPO
    assert "DL4J_FAILPOINTS" not in env
    assert env["OMP_NUM_THREADS"] == "1" or "OMP_NUM_THREADS" in os.environ
    assert armed["DL4J_FAILPOINTS"] == "pool.alloc=oom@n:2"
    assert cuda["OMP_NUM_THREADS"] == "4"


def test_fleet_token_identical_and_affine(fleet, reference):
    wd, sup = fleet
    prompts, expected, _replicas0 = reference
    _await_replicas(sup, 2)
    router = FleetRouter(supervisor=sup, quorum=2, kv_block=KV_BLOCK,
                         journal_path=os.path.join(wd, "clean.journal"),
                         scrape_interval_s=0.2).start()
    try:
        outs = _drive(router.port, prompts)
        assert [o["tokens"] for o in outs] == expected
        by_prompt = {}
        for p, o in zip(prompts, outs):
            by_prompt.setdefault(tuple(p), set()).add(
                o["router"]["replica"])
        assert all(len(s) == 1 for s in by_prompt.values()), by_prompt
        assert len({next(iter(s)) for s in by_prompt.values()}) == 2
        accepts, finishes, fails = _journal_audit(
            os.path.join(wd, "clean.journal"))
        assert len(accepts) == len(prompts) and not fails
        assert all(finishes.get(r, 0) == 1 for r in accepts)
        # the prefix caches engaged where the repeats landed
        hits = 0
        for _n, url in sup.ready_replicas():
            snap = json.loads(urllib.request.urlopen(
                url + "/metrics", timeout=10).read())
            hits += snap["counters"].get("prefix_cache_hits_total", 0)
        assert hits >= 1
    finally:
        router.stop(stop_replicas=False)


def test_replica_sigkill_mid_decode_zero_lost_token_identical(
        fleet, reference):
    """SIGKILL one replica while requests are mid-decode: failover to the
    survivor, the supervisor respawns the corpse, no request lost, none
    double-finished, every completion the no-fault tokens."""
    wd, sup = fleet
    prompts, expected, _replicas0 = reference
    _await_replicas(sup, 2)
    jpath = os.path.join(wd, "chaos-replica.journal")
    router = FleetRouter(supervisor=sup, quorum=1, kv_block=KV_BLOCK,
                         journal_path=jpath, scrape_interval_s=0.2).start()
    restarts0 = sup.restarts
    try:
        victim = sup.replicas[0]
        outs = [None] * len(prompts)
        errors = []

        def client(k):
            for i in range(k, len(prompts), N_CLIENTS):
                body = json.dumps({"prompt": prompts[i],
                                   "max_new_tokens": NEW_TOKENS}).encode()
                try:
                    outs[i] = _post_retry(router.port, "/generate", body)
                except Exception as e:  # noqa: BLE001
                    errors.append((i, repr(e)))

        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(N_CLIENTS)]
        for t in threads:
            t.start()
        time.sleep(0.15)
        victim.kill()
        for t in threads:
            t.join()
        assert not errors, f"requests lost under replica kill: {errors}"
        assert [o["tokens"] for o in outs] == expected
        accepts, finishes, fails = _journal_audit(jpath)
        assert len(accepts) == len(prompts) and not fails
        assert not {r: n for r, n in finishes.items() if n > 1}
        assert all(finishes.get(r) == 1 for r in accepts)
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline and sup.restarts <= restarts0:
            time.sleep(0.1)
        assert sup.restarts > restarts0, sup.states()
        _await_replicas(sup, 2)
        audited = 0
        for _name, url in sup.ready_replicas():
            dups = {r: n for r, n in _replica_finish_counts(url).items()
                    if n > 1}
            assert not dups, f"replica {url} double-finished: {dups}"
            audited += 1
        assert audited == 2
    finally:
        router.stop(stop_replicas=False)


def _spawn_router_proc(wd, urls, jpath, tag, failpoints=None):
    announce = os.path.join(wd, f"router.{tag}.json")
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    if failpoints:
        env["DL4J_FAILPOINTS"] = ";".join(
            f"{k}={v}" for k, v in failpoints.items())
    else:
        env.pop("DL4J_FAILPOINTS", None)
    log = open(os.path.join(wd, f"router.{tag}.log"), "ab")
    try:
        proc = subprocess.Popen(
            [sys.executable, "-m", "deeplearning4j_tpu_torch.serving.router",
             "--replicas", ",".join(urls), "--journal", jpath,
             "--announce", announce, "--kv-block", str(KV_BLOCK),
             "--quorum", "1", "--scrape-interval", "0.2"],
            stdout=log, stderr=log, env=env)
    finally:
        log.close()
    deadline = time.monotonic() + 120
    port = None
    while port is None:
        assert proc.poll() is None, \
            f"router died: {open(log.name, 'rb').read()[-2000:]}"
        try:
            with open(announce) as fh:
                port = int(json.load(fh)["port"])
        except (OSError, ValueError, KeyError):
            assert time.monotonic() < deadline
            time.sleep(0.05)
    return proc, port


def test_router_sigkill_mid_journal_replays_exactly_once(fleet, reference):
    """A router process SIGKILLed while a request sits between its
    journal append and its dispatch (``router.dispatch`` hang armed
    through DL4J_FAILPOINTS) loses nothing: the restarted router replays
    exactly that request, once, token-identically."""
    wd, sup = fleet
    prompts, expected, _r = reference
    _await_replicas(sup, 2)
    urls = [u for _n, u in sup.ready_replicas()]
    jpath = os.path.join(wd, "chaos-router.journal")
    proc, port = _spawn_router_proc(
        wd, urls, jpath, "a",
        failpoints={"router.dispatch": "hang:30000@n:4"})
    hung_idx = 3
    try:
        for i in range(3):
            body = json.dumps({"prompt": prompts[i],
                               "max_new_tokens": NEW_TOKENS}).encode()
            assert _post_retry(port, "/generate", body)["tokens"] == \
                expected[i]
        hung_err = []

        def hung_client():
            body = json.dumps({"prompt": prompts[hung_idx],
                               "max_new_tokens": NEW_TOKENS}).encode()
            try:
                _post_retry(port, "/generate", body, timeout=60,
                            max_retries=0)
            except Exception as e:  # noqa: BLE001 - expected: router dies
                hung_err.append(repr(e))

        th = threading.Thread(target=hung_client)
        th.start()
        deadline = time.monotonic() + 30
        while True:
            accepts, finishes, _f = _journal_audit(jpath)
            if len(accepts) >= 4:
                break
            assert time.monotonic() < deadline, accepts
            time.sleep(0.05)
        assert sum(finishes.values()) == 3
        hung_rid = accepts[3]
        os.kill(proc.pid, signal.SIGKILL)
        proc.wait(timeout=30)
        th.join(timeout=30)
        assert hung_err, "the hung client should have seen the crash"
    finally:
        if proc.poll() is None:
            proc.kill()
    proc2, port2 = _spawn_router_proc(wd, urls, jpath, "b")
    try:
        deadline = time.monotonic() + 60
        while True:
            accepts, finishes, fails = _journal_audit(jpath)
            if finishes.get(hung_rid):
                break
            assert time.monotonic() < deadline, (finishes, fails)
            time.sleep(0.1)
        assert all(finishes.get(r, 0) == 1 for r in accepts), finishes
        assert not fails
        replayed = [r for r in _journal_records(jpath)
                    if r["t"] == "finish" and r["rid"] == hung_rid]
        assert len(replayed) == 1 and replayed[0]["replay"] is True
        assert replayed[0]["tokens"] == expected[hung_idx]
        stats = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{port2}/router/journal", timeout=10).read())
        assert stats["replayed_total"] == 1
        assert stats["replay_abandoned_total"] == 0
    finally:
        proc2.terminate()
        assert proc2.wait(timeout=30) == 0


def test_failpoints_env_arms_inside_replica_subprocess(fleet, reference):
    """DL4J_FAILPOINTS arms seams INSIDE a replica subprocess: the
    announce file reports them, the replica's supervisor recovers the
    injected crash token-identically, and /metrics counts it."""
    wd, sup = fleet
    prompts, expected, _r = reference
    rep = ReplicaProcess(_replica_argv(), name="armed", workdir=wd,
                         failpoints={"dispatch.decode": "crash@once"})
    rep.spawn()
    try:
        url = rep.await_ready()
        with open(rep._announce_path()) as fh:
            assert json.load(fh)["failpoints_armed"] == ["dispatch.decode"]
        body = json.dumps({"prompt": prompts[0],
                           "max_new_tokens": NEW_TOKENS}).encode()
        out = _post_retry(rep.port, "/generate", body)
        assert out["tokens"] == expected[0]
        metrics = json.loads(urllib.request.urlopen(
            url + "/metrics", timeout=10).read())
        assert metrics["counters"]["failpoint_triggers_total"] >= 1
        assert metrics["counters"]["engine_restarts_total"] >= 1
    finally:
        rep.terminate()


def test_rolling_drain_keeps_quorum(fleet):
    """POST /admin/drain walks the replicas one at a time: the router
    keeps quorum throughout, a second POST starts nothing, every replica
    ran its own draining restart, and the fleet ends fully ready. (A CPU
    replica's drain swaps its engine in milliseconds, faster than the
    probe cadence, so the drain is read from each replica's recorder
    rather than from a probe that caught it.)"""
    wd, sup = fleet
    _await_replicas(sup, 2)
    router = FleetRouter(supervisor=sup, quorum=1, kv_block=KV_BLOCK,
                         journal_path=os.path.join(wd, "drain.journal"),
                         scrape_interval_s=0.2).start()
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{router.port}/admin/drain", data=b"{}")
        with urllib.request.urlopen(req, timeout=10) as resp:
            assert resp.status == 202
            assert json.loads(resp.read())["status"] == "draining"
        with urllib.request.urlopen(req, timeout=10) as resp:
            assert json.loads(resp.read())["status"] == "already_draining"
        assert router.ready()[1]["draining"] is True
        deadline = time.monotonic() + 120
        while True:
            ok, body = router.ready()
            assert ok, f"router lost quorum during rolling drain: {body}"
            if not body["draining"]:
                break
            assert time.monotonic() < deadline, "the drain never ended"
            time.sleep(0.05)
        _await_replicas(sup, 2)
        for _name, url in sup.ready_replicas():
            snap = json.loads(urllib.request.urlopen(
                url + "/trace", timeout=10).read())
            assert any(e["name"] == "drain_begin"
                       for e in snap["events"]), url
    finally:
        router.stop(stop_replicas=False)


def test_race_checker_router_state_zero_violations(fleet, reference):
    """The JAX package's happens-before checker over the port router's
    shared state through concurrent HTTP load: zero violations."""
    from deeplearning4j_tpu.analysis.races import race_audit

    wd, sup = fleet
    prompts, expected, _r = reference
    _await_replicas(sup, 2)
    with race_audit() as det:
        router = FleetRouter(supervisor=sup, quorum=2, kv_block=KV_BLOCK,
                             journal_path=os.path.join(wd, "race.journal"),
                             scrape_interval_s=0.05).start()
        det.watch(router, ["_admission", "_rr", "_draining",
                           "_scrape_error"], label="router")
        det.watch(router.journal,
                  ["accepted_total", "finished_total", "failed_total"],
                  label="journal")
        try:
            outs = _drive(router.port, prompts[:8])
            assert [o["tokens"] for o in outs] == expected[:8]
        finally:
            router.stop(stop_replicas=False)
    assert det.violations == [], det.format_violations()
    assert det.tracking


# ---------------------------------------------------------------------------
# the CLI, and the port's rules
# ---------------------------------------------------------------------------

def test_cli_router_attaches_and_refuses_cuda_without_a_card(fleet,
                                                             tmp_path):
    """``router --replicas`` wires through the CLI (checked here by
    parsing; the router's main loop is the module's, driven above), and
    ``router --spawn`` with cuda replicas fails before spawning anything
    on a machine without a card."""
    from deeplearning4j_tpu_torch.cli.main import build_parser
    args = build_parser().parse_args(
        ["router", "--spawn", "2", "--model", "m.zip",
         "--replica-arg=--kv-pool-mb", "--replica-arg=129",
         "--paged-kernel", "on", "--journal", str(tmp_path / "j.log")])
    assert args.device == "cuda" and args.paged_kernel == "on"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            args.fn(args)
    with pytest.raises(SystemExit):
        build_parser().parse_args(["router", "--paged-kernel", "auto"])
    with pytest.raises(SystemExit):
        trouter.main(["--journal", str(tmp_path / "x.log")])


def test_replica_entry_point_refuses_cuda_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        treplica.main(["--announce", str(tmp_path / "a.json")])
    assert not (tmp_path / "a.json").exists()


NEW_MODULES = ["deeplearning4j_tpu_torch.serving",
               "deeplearning4j_tpu_torch.serving.durable",
               "deeplearning4j_tpu_torch.serving.streaming",
               "deeplearning4j_tpu_torch.serving.telemetry",
               "deeplearning4j_tpu_torch.serving.replica",
               "deeplearning4j_tpu_torch.serving.router",
               "deeplearning4j_tpu_torch.serving.server",
               "deeplearning4j_tpu_torch.analysis.runtime",
               "deeplearning4j_tpu_torch.inference.failpoints",
               "deeplearning4j_tpu_torch.cli.main"]


def test_new_modules_import_neither_jax_nor_the_jax_package():
    """Each module of this slice imports in a fresh interpreter where
    jax and deeplearning4j_tpu are blocked: an import of either fails."""
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'deeplearning4j_tpu'):\n"
        "    sys.modules[name] = None\n"
        "import importlib\n"
        f"for m in {NEW_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = [k for k in sys.modules if k.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'deeplearning4j_tpu')\n"
        "       and sys.modules[k] is not None]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120,
                       env=dict(os.environ, PYTHONPATH=REPO))
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr[-2000:]


def test_journal_record_crc_frames_are_the_durable_format(tmp_path):
    """The journal's records are plain durable frames: the header is
    (magic, length, CRC32) and the payload the JSON record."""
    jpath = str(tmp_path / "j.log")
    j = trouter.RequestJournal(jpath)
    j.accept("rid-x", {"prompt": [1], "max_new_tokens": 1})
    j.close()
    raw = open(jpath, "rb").read()
    import struct
    magic, ln, crc = struct.unpack_from("<HII", raw, 0)
    payload = raw[10:10 + ln]
    assert magic == 0xD14A and zlib.crc32(payload) == crc
    assert json.loads(payload)["rid"] == "rid-x"
