"""Port: failpoints, TokenStream and the engine supervisor.

- The failpoint cases of tests/test_supervisor.py (:245-306) and the
  TokenStream cases of tests/test_logitproc.py (:274-320), parametrised
  over the JAX modules and the port's host-only copies.
- The supervisor cases of tests/test_supervisor.py (:122-244) on the
  port's `EngineSupervisor`, on a frozen fake clock with no real sleeps,
  against stub engines; and (:307-464) against the port's real engine
  and server on the CPU: drain, the retry budget's structured 503, and
  stop() racing an in-flight POST.
- The port's own contract: a rebuilt engine keeps the device, the kernel
  mode and the graph mode; the fenced engine's device state is dropped;
  an unsupervised crash fails its handles fast; the ladder's shedding on
  a real engine.
"""
import json
import threading
import time
import urllib.error
import urllib.request

import pytest
import torch

from deeplearning4j_tpu.inference import failpoints as jfailpoints
from deeplearning4j_tpu.inference.logitproc import TokenStream as JTokenStream
from deeplearning4j_tpu_torch.inference import failpoints as tfailpoints
from deeplearning4j_tpu_torch.inference.engine import (DecodeHandle,
                                                       DecodeScheduler,
                                                       EngineCrashedError,
                                                       LoadSheddedError)
from deeplearning4j_tpu_torch.inference.logitproc import TokenStream
from deeplearning4j_tpu_torch.inference.metrics import MetricsRegistry
from deeplearning4j_tpu_torch.inference.supervisor import (
    AdmissionRejectedError, EngineSupervisor, RetryBudgetExceededError)
from deeplearning4j_tpu_torch.inference.trace import FlightRecorder
from deeplearning4j_tpu_torch.models.zoo import transformer_lm
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.serving.server import InferenceServer

V = 13
FAILPOINTS = {"jax": jfailpoints, "port": tfailpoints}
STREAMS = {"jax": JTokenStream, "port": TokenStream}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tier-1 runs several test files at once on a few cores; one torch
    intra-op thread keeps this file from starving the others' timings."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _disarmed():
    yield
    tfailpoints.disarm()
    jfailpoints.disarm()


def _lm(cache=96):
    conf = transformer_lm(vocab_size=V, d_model=16, n_heads=2, n_blocks=2,
                          rope=True)
    for vert in conf.vertices.values():
        layer = getattr(vert, "layer", None)
        if layer is not None and hasattr(layer, "max_cache_len"):
            layer.max_cache_len = cache
    return ComputationGraph(conf, device="cpu").init()


class FakeClock:
    """Frozen time: advances only when told (or when fake-sleeping)."""

    def __init__(self):
        self.now = 1000.0

    def __call__(self):
        return self.now

    def sleep(self, s):
        self.now += s


class StubEngine:
    """The narrow surface EngineSupervisor drives, with settable vitals:
    no threads, no device, no sleeps."""

    def __init__(self, clock):
        self._clock = clock
        self.heartbeat = clock()
        self.iterations = 1  # past warm-up by default
        self.crashed = None
        self.fenced = False
        self.stopped = False
        self.prefill_chunk = 64
        self.chunk_cap = None
        self.max_queue = 64
        self._queue_depth = 0
        self.shed_calls = []
        self._thread = None
        self._on_crash = None
        self.submitted = []

    def fence(self):
        self.fenced = True

    def stop(self):
        self.stopped = True

    def start(self):
        return self

    def inflight(self):
        return self._queue_depth

    def queue_depth(self):
        return self._queue_depth

    def shed_queued(self, target):
        self.shed_calls.append(target)
        return 0

    def submit(self, prompt, max_new_tokens, **kw):
        self.submitted.append((list(prompt), max_new_tokens, kw))
        handle = kw.get("_handle")
        if handle is None:
            handle = DecodeHandle(len(prompt), max_new_tokens)
        return handle


def _stub_supervisor(clock, **kw):
    spawned = []

    def factory():
        eng = StubEngine(clock)
        spawned.append(eng)
        return eng

    sup = EngineSupervisor(factory, clock=clock, sleep_fn=clock.sleep,
                           watchdog=False, warm_on_build=False,
                           metrics=MetricsRegistry(),
                           tracer=FlightRecorder(1024), **kw)
    return sup, spawned


# ------------------------------------------------- failpoint determinism --
@pytest.mark.parametrize("pkg", list(FAILPOINTS))
def test_failpoint_probability_is_seed_deterministic(pkg):
    fp = FAILPOINTS[pkg]

    def sequence(seed, n=200):
        fp.arm("dispatch.decode", f"crash@p:0.3:{seed}")
        out = []
        for _ in range(n):
            try:
                fp.fire("dispatch.decode")
                out.append(0)
            except fp.InjectedCrash:
                out.append(1)
        fp.disarm("dispatch.decode")
        return out

    a, b, c = sequence(7), sequence(7), sequence(8)
    assert a == b, "same seed must replay the same trigger sequence"
    assert a != c, "different seeds must diverge"
    assert 0 < sum(a) < len(a)
    if pkg == "port":  # the same seed gives the same sequence in both
        jfailpoints.arm("dispatch.decode", "crash@p:0.3:7")
        ref = []
        for _ in range(200):
            try:
                jfailpoints.fire("dispatch.decode")
                ref.append(0)
            except jfailpoints.InjectedCrash:
                ref.append(1)
        assert ref == a


@pytest.mark.parametrize("pkg", list(FAILPOINTS))
def test_failpoint_triggers_nth_hit_and_once(pkg):
    fp = FAILPOINTS[pkg]
    fp.arm("dispatch.prefill", "oom@n:3")
    hits = []
    for _ in range(5):
        try:
            fp.fire("dispatch.prefill")
            hits.append(0)
        except fp.InjectedOOM:
            hits.append(1)
    fp.disarm()
    assert hits == [0, 0, 1, 0, 0]
    fp.arm("http.handler", "crash")  # default trigger: once
    with pytest.raises(fp.InjectedCrash):
        fp.fire("http.handler")
    fp.fire("http.handler")  # second hit: already spent
    fp.disarm()


@pytest.mark.parametrize("pkg", list(FAILPOINTS))
def test_failpoint_spec_errors_fail_arming_loudly(pkg):
    fp = FAILPOINTS[pkg]
    for bad in ("explode", "hang", "hang:", "crash@n:0", "crash@p:1.5",
                "crash@sometimes"):
        with pytest.raises(ValueError):
            fp.parse_spec(bad)
    with pytest.raises(ValueError):
        fp.arm("no.such.seam", "crash")
    assert fp.snapshot() == {}


@pytest.mark.parametrize("pkg", list(FAILPOINTS))
def test_disarmed_fire_is_free_and_silent(pkg):
    fp = FAILPOINTS[pkg]
    for seam in fp.SEAMS:
        fp.fire(seam)


@pytest.mark.parametrize("pkg", list(FAILPOINTS))
def test_failpoints_arm_from_env_and_hang_then_raise(pkg):
    fp = FAILPOINTS[pkg]
    assert fp.arm_from_env({"DL4J_FAILPOINTS":
                            "dispatch.decode=hang:20@once; pool.alloc=oom"}) \
        == ["dispatch.decode", "pool.alloc"]
    assert set(fp.snapshot()) == {"dispatch.decode", "pool.alloc"}
    t0 = time.monotonic()
    with pytest.raises(fp.InjectedHang):
        fp.fire("dispatch.decode")
    assert time.monotonic() - t0 >= 0.015
    with pytest.raises(MemoryError):
        fp.fire("pool.alloc")
    with pytest.raises(ValueError):
        fp.arm_from_env({"DL4J_FAILPOINTS": "dispatch.decode"})


# ------------------------------------------------------------ TokenStream --
class _H:
    def __init__(self, rid, tokens, reason):
        self.request_id = rid
        self.tokens = tokens
        self.finish_reason = reason

    def timings(self):
        return {"total_ms": 1.0}


@pytest.mark.parametrize("pkg", list(STREAMS))
def test_token_stream_dedupes_reemission_by_index(pkg):
    ts = STREAMS[pkg]()
    ts.push(0, 7)
    ts.push(1, 8)
    # crash-recovery re-decode re-emits from index 0 (token-identical)
    ts.push(0, 7)
    ts.push(1, 8)
    ts.push(2, 9)
    ts.close(_H("r1", [7, 8, 9], "length"))
    evts = list(ts.events())
    toks = [e["token"] for e in evts if not e.get("done")]
    assert toks == [7, 8, 9]  # each exactly once
    assert evts[-1]["tokens"] == [7, 8, 9]
    assert evts[-1]["finish_reason"] == "length"


@pytest.mark.parametrize("pkg", list(STREAMS))
def test_token_stream_close_flushes_withheld_tokens(pkg):
    ts = STREAMS[pkg]()
    ts.push(0, 1)  # 2, 3, 4 not pushed yet
    ts.close(_H("r2", [1, 2, 3, 4], None))
    toks = [e["token"] for e in ts.events() if not e.get("done")]
    assert toks == [1, 2, 3, 4]


@pytest.mark.parametrize("pkg", list(STREAMS))
def test_token_stream_deadline_raises(pkg):
    ts = STREAMS[pkg]()
    with pytest.raises(TimeoutError):
        list(ts.events(deadline=time.monotonic() + 0.01))


# ------------------------------------------------- watchdog, frozen clock --
def test_watchdog_hang_detection_timing_no_real_sleeps():
    clock = FakeClock()
    sup, spawned = _stub_supervisor(clock, hang_timeout_s=5.0,
                                    backoff_base_s=0.0)
    eng = sup.engine
    eng.heartbeat = clock()
    clock.now += 4.9  # under threshold: no restart
    sup.check()
    assert sup.restarts == 0 and sup.engine is eng and sup.ready
    clock.now += 0.2  # age 5.1 > 5.0: hang declared
    sup.check()
    assert sup.restarts == 1
    assert eng.fenced, "the dead engine must be fenced before reuse"
    assert sup.engine is not eng and len(spawned) == 2
    assert sup.ready  # fresh engine, fresh heartbeat
    assert sup.recovery_seconds == [0.0]  # a frozen clock: no time passed
    sup.stop()


def test_watchdog_warmup_grace_for_fresh_engines():
    clock = FakeClock()
    sup, _ = _stub_supervisor(clock, hang_timeout_s=1.0,
                              warmup_timeout_s=30.0, backoff_base_s=0.0)
    eng = sup.engine
    eng.iterations = 0  # never completed an iteration: warming
    eng.heartbeat = clock()
    clock.now += 10.0  # way past hang_timeout, inside the warmup budget
    sup.check()
    assert sup.restarts == 0 and sup.engine is eng
    clock.now += 25.0  # past even the warmup budget: genuinely stuck
    sup.check()
    assert sup.restarts == 1
    sup.stop()


def test_watchdog_leaves_a_process_stall_out_of_the_heartbeat_age():
    """A stall of the whole process (a full garbage collection holding the
    GIL, the host's cores taken) stops the engine's loop and the watchdog
    alike: the watchdog wakes late, and that time is no sign of a hang. A
    loop that stays stuck after it is still declared hung, after
    hang_timeout_s of time the watchdog saw."""
    clock = FakeClock()
    sup, spawned = _stub_supervisor(clock, hang_timeout_s=1.0,
                                    poll_interval_s=0.05, backoff_base_s=0.0)
    eng = sup.engine
    eng.heartbeat = clock()

    def poll(dt):
        due = clock() + sup.poll_interval_s
        clock.now += dt
        sup.note_wake(due)
        sup.check()

    poll(0.05)
    poll(3.0)  # the process stood still for 3 s, the watchdog with it
    assert sup.restarts == 0 and sup.engine is eng and sup.restart_log == []
    for _ in range(17):  # 0.1 s before the stall, 0.85 s after: not yet
        poll(0.05)
    assert sup.restarts == 0 and sup.engine is eng
    poll(0.05)
    poll(0.05)  # 1.05 s seen stuck: a hang
    assert sup.restarts == 1 and sup.engine is spawned[1]
    assert [c["reason"] for c in sup.restart_log] == ["hang"]
    assert sup.restart_log[0]["heartbeat_age_s"] == pytest.approx(4.0)
    sup.stop()


def test_crash_recovery_resubmits_with_backoff_and_budget():
    clock = FakeClock()
    sup, spawned = _stub_supervisor(clock, hang_timeout_s=5.0,
                                    retry_budget=3, backoff_base_s=0.1,
                                    backoff_max_s=10.0, backoff_jitter=0.0)
    h = sup.submit([1, 2, 3], 4, seed=7)
    for expected_attempts in (2, 3):
        sup.engine.crashed = RuntimeError("boom")
        t_before = clock()
        sup.check()
        assert sup.restarts == expected_attempts - 1
        new_eng = sup.engine
        assert new_eng.submitted, "request must be resubmitted"
        prompt, mnt, kw = new_eng.submitted[-1]
        assert (prompt, mnt) == ([1, 2, 3], 4)
        assert kw.get("_handle") is h and kw.get("_front") is True
        assert kw.get("seed") == 7, "same seed = token-identical re-run"
        assert h.retries == expected_attempts - 1
        # exponential backoff: 0.1 * 2^streak fake-slept on the clock
        assert clock() - t_before == pytest.approx(
            0.1 * 2 ** (expected_attempts - 2))
    # third crash: attempts (3) >= budget (3) -> abandoned, structured
    sup.engine.crashed = RuntimeError("boom")
    sup.check()
    with pytest.raises(RetryBudgetExceededError) as ei:
        h.result(0)
    assert ei.value.request_id == h.request_id
    assert sup.metrics.counter("requests_abandoned_total").value == 1
    sup.stop()


def test_failed_rebuild_counts_against_the_budget():
    """A rebuild that keeps failing (a sticky CUDA error) is not retried
    in a loop that hides it: every failed pass costs each stranded
    request an attempt, so the budget ends in the structured error."""
    clock = FakeClock()
    sup, spawned = _stub_supervisor(clock, retry_budget=3,
                                    backoff_base_s=0.0)
    h = sup.submit([1, 2], 3)
    sup._factory = lambda: (_ for _ in ()).throw(RuntimeError("sticky"))
    sup.engine.crashed = RuntimeError("illegal address")
    for _ in range(2):
        with pytest.raises(RuntimeError, match="sticky"):
            sup.check()
        assert not sup.ready
    with pytest.raises(RetryBudgetExceededError):
        h.result(0)
    assert sup.metrics.counter("requests_abandoned_total").value == 1
    sup.stop()


def test_degradation_ladder_escalates_and_recovers():
    clock = FakeClock()
    sup, _ = _stub_supervisor(clock, hang_timeout_s=1e9,
                              ladder_patience=2)
    eng = sup.engine
    eng._queue_depth = 60  # 60/64 > 0.75: pressure
    for level in (1, 2, 3):
        sup.check()
        sup.check()
        assert sup.degradation_level == level
    assert sup.metrics.gauge("degradation_level").value == 3
    # L1+: queued load above half the queue is shed
    assert eng.shed_calls and eng.shed_calls[-1] == eng.max_queue // 2
    # L2+: prefill chunk cap halved (the smaller buckets exist already)
    assert eng.chunk_cap == eng.prefill_chunk // 2
    # L3: admission refused with a Retry-After hint
    with pytest.raises(AdmissionRejectedError) as ei:
        sup.submit([1], 1)
    assert ei.value.retry_after_s > 0
    # calm walks back down to 0 and the chunk cap lifts
    eng._queue_depth = 2
    for level in (2, 1, 0):
        sup.check()
        sup.check()
        assert sup.degradation_level == level
    assert eng.chunk_cap is None
    sup.stop()


def test_degradation_level_survives_engine_restart():
    clock = FakeClock()
    sup, _ = _stub_supervisor(clock, hang_timeout_s=1e9,
                              ladder_patience=1, backoff_base_s=0.0)
    sup.engine._queue_depth = 60
    sup.check()
    sup.check()
    assert sup.degradation_level == 2
    sup.engine.crashed = RuntimeError("boom")
    sup.check()
    assert sup.engine.chunk_cap == sup.engine.prefill_chunk // 2, \
        "a restart under pressure must come up degraded, not amnesiac"
    sup.stop()


# ----------------------------------------------- real engine: drain, 503s --
@pytest.fixture(scope="module")
def lm_net():
    return _lm()


def _engine_factory(net, **kw):
    return lambda: DecodeScheduler(net, V, n_slots=2, prefill_chunk=16,
                                   metrics=MetricsRegistry(),
                                   tracer=FlightRecorder(0), device="cpu",
                                   **kw)


def test_drain_completes_inflight_then_flips_ready(lm_net):
    sup = EngineSupervisor(_engine_factory(lm_net), hang_timeout_s=30.0,
                           poll_interval_s=0.02, metrics=MetricsRegistry(),
                           tracer=FlightRecorder(2048))
    try:
        old = sup.engine
        h = sup.submit(list(range(1, 9)), 12, seed=1)
        seen_unready = []

        def watch():
            while sup._draining:
                seen_unready.append(sup.ready)
                time.sleep(0.005)

        watcher = threading.Thread(target=watch)
        drainer = threading.Thread(target=lambda: sup.drain(timeout=120))
        drainer.start()
        watcher.start()
        drainer.join(timeout=120)
        watcher.join(timeout=5)
        assert not drainer.is_alive() and not watcher.is_alive()
        assert len(h.result(5)) == 12, "in-flight work completed in full"
        assert sup.engine is not old, "engine swapped"
        assert old.inflight() == 0
        assert all(r is False for r in seen_unready), \
            "ready must be False for the whole drain window"
        deadline = time.monotonic() + 30
        while not sup.ready and time.monotonic() < deadline:
            time.sleep(0.02)
        assert sup.ready, "ready flips back after the swap"
        # the drained-in engine was warmed: every runner built before it
        # took traffic, so serving builds none (the capture budget)
        new = sup.engine
        assert new._warmed and new.decode_captures == 1
        assert new.prefill_captures == len(new.prefill_buckets)
    finally:
        sup.stop()


@pytest.mark.parametrize("mode", [
    dict(kv_pool_mb=0.25, kv_block=8, paged_kernel="off",
         decode_graphs="on"),
    dict(decode_graphs="off")])
def test_rebuilt_engine_keeps_device_and_modes(lm_net, mode):
    """The factory passes the modes through: a restart never comes back
    eager, on another device, or with the other kernel choice; the dead
    engine is fenced and its device state dropped."""
    sup = EngineSupervisor(_engine_factory(lm_net, **mode),
                           hang_timeout_s=30.0, poll_interval_s=0.02,
                           backoff_base_s=0.0, metrics=MetricsRegistry(),
                           tracer=FlightRecorder(2048))
    try:
        old = sup.engine
        prompt = [t % V for t in range(1, 20)]
        want = sup.engine.generate(prompt, 6, timeout=60)
        tfailpoints.arm("dispatch.decode", "crash@n:2")
        h = sup.submit(prompt, 6)
        assert h.result(60) == want and h.retries == 1
        new = sup.engine
        assert new is not old and sup.restarts == 1
        assert (new.device, new.paged, new.paged_kernel,
                new.decode_graphs) == (old.device, old.paged,
                                       old.paged_kernel, old.decode_graphs)
        assert old._fenced and old._states == {} and old._runners == {}
        assert old._chunk_runners == {} and old.pool is None
        assert sup.recovery_seconds and sup.recovery_seconds[0] > 0
    finally:
        sup.stop()


def test_unsupervised_crash_fails_handles_fast(lm_net):
    eng = _engine_factory(lm_net)().start()
    try:
        tfailpoints.arm("dispatch.prefill", "crash@once")
        h = eng.submit([t % V for t in range(1, 30)], 4)
        with pytest.raises(EngineCrashedError):
            h.result(60)
        assert isinstance(eng.crashed, tfailpoints.InjectedCrash)
        assert eng.iterations >= 0 and not eng._running
    finally:
        eng.stop()


def test_shed_queued_drops_lowest_priority_newest_first(lm_net):
    eng = _engine_factory(lm_net)()
    with eng._cond:
        eng._running = True  # accept submissions without a loop thread
    hs = [eng.submit([1, 2, 3], 2, priority=p) for p in (0, 1, 0, 1)]
    assert eng.queue_depth() == 4 and eng.inflight() == 4
    assert eng.shed_queued(2) == 2
    # lowest priority first, newest first within it: hs[2] then hs[0]
    for h in (hs[0], hs[2]):
        with pytest.raises(LoadSheddedError):
            h.result(0)
    assert not hs[1].done() and not hs[3].done()
    eng.stop()


def _post_generate(port, body, results, timeout=120):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/generate", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    try:
        urllib.request.urlopen(req, timeout=timeout)
        results.append(("ok", None))
    except urllib.error.HTTPError as e:
        results.append((e.code, json.loads(e.read())))
    except Exception as e:  # noqa: BLE001 - recorded for the assert
        results.append(("neterr", repr(e)))


def test_retry_budget_exhaustion_is_http_503_not_silence(lm_net):
    srv = InferenceServer(net=lm_net, decode_slots=2, prefill_chunk=16,
                          hang_timeout_s=30.0, retry_budget=2,
                          device="cpu").start()
    srv.supervisor.poll_interval_s = 0.02
    srv.supervisor.backoff_base_s = 0.01
    srv.supervisor.backoff_max_s = 0.05
    results = []
    th = threading.Thread(target=_post_generate, args=(
        srv.port, {"prompt": list(range(1, 7)), "max_new_tokens": 80},
        results))
    th.start()
    try:
        deadline = time.monotonic() + 60
        while srv.supervisor.engine.inflight() == 0 \
                and time.monotonic() < deadline:
            time.sleep(0.005)
        tfailpoints.arm("scheduler.iteration", "crash@always")
        th.join(timeout=120)
        assert not th.is_alive(), "exhaustion must ANSWER, not hang"
    finally:
        tfailpoints.disarm()
        srv.stop()
        th.join(timeout=10)
    code, payload = results[0]
    assert code == 503, (code, payload)
    assert payload["error"] == "retry_budget_exhausted"
    assert payload["request_id"]
    assert srv.metrics.counter("requests_abandoned_total").value >= 1


def test_stop_racing_inflight_post_fails_fast_with_503(lm_net):
    srv = InferenceServer(net=lm_net, decode_slots=1, prefill_chunk=16,
                          hang_timeout_s=30.0, device="cpu").start()
    # wedge the decode mid-request so it cannot finish before teardown
    tfailpoints.arm("dispatch.decode", "hang:2500@n:5")
    results = []
    th = threading.Thread(target=_post_generate, args=(
        srv.port, {"prompt": list(range(1, 7)), "max_new_tokens": 60},
        results))
    th.start()
    try:
        deadline = time.monotonic() + 60
        while srv.supervisor.engine.inflight() == 0 \
                and time.monotonic() < deadline:
            time.sleep(0.01)
        t0 = time.monotonic()
        srv.stop()
        th.join(timeout=30)
        elapsed = time.monotonic() - t0
    finally:
        tfailpoints.disarm()
    assert not th.is_alive(), "handler thread must not hang"
    assert elapsed < 20, f"teardown answered too slowly ({elapsed:.1f}s)"
    code, payload = results[0]
    assert code == 503, (code, payload)
    assert payload["error"] == "shutting_down"
    assert payload["request_id"]


def test_shutting_down_flag_rejects_new_posts(lm_net):
    srv = InferenceServer(net=lm_net, decode_vocab=0, device="cpu").start()
    port = srv.port
    srv._shutting_down = True  # the first thing stop() sets
    try:
        body = json.dumps({"data": [[0.0] * V]}).encode()
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/predict", data=body,
            headers={"Content-Type": "application/json"})
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(req, timeout=30)
        assert ei.value.code == 503
        assert json.loads(ei.value.read())["error"] == "shutting_down"
    finally:
        srv.stop()
