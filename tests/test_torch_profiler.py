"""Port parity: the step-phase profiler, cost attribution, the SLO
monitor, the supervisor's latency input and ``GET /debug/engine``.

The cases of tests/test_profiler.py (:112-487, :529-764), run on the
port's `inference/profiler.py`, its `EngineSupervisor(slo=...)`, its
`DecodeScheduler` and its server, and held against the JAX package where
both compute the same numbers: the SLO monitor's percentiles and burn
rates on a frozen clock, `burn_verdict`, the step-phase profiler's
tallies, the keys of ``debug_snapshot``. The port's cost table is
analytic: its matmul FLOPs must equal `torch.utils.flop_counter`'s count
of one eager run of the same runner, and lie within [0.5, 2] of the JAX
package's XLA cost model (which also counts the elementwise work: norms,
activations, softmax, RoPE).
"""
import json
import os
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from deeplearning4j_tpu.inference import DecodeScheduler as JEngine
from deeplearning4j_tpu.inference import MetricsRegistry as JMetrics
from deeplearning4j_tpu.inference import profiler as jprof
from deeplearning4j_tpu.inference.trace import FlightRecorder as JRecorder
from deeplearning4j_tpu.models.zoo import transformer_lm as jlm
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu_torch.inference import profiler as tprof
from deeplearning4j_tpu_torch.inference.engine import (DecodeHandle,
                                                       DecodeScheduler)
from deeplearning4j_tpu_torch.inference.kvpool import SCRATCH_BLOCK
from deeplearning4j_tpu_torch.inference.metrics import MetricsRegistry
from deeplearning4j_tpu_torch.inference.supervisor import EngineSupervisor
from deeplearning4j_tpu_torch.inference.trace import FlightRecorder
from deeplearning4j_tpu_torch.models.zoo import mlp_iris
from deeplearning4j_tpu_torch.nn.conf.graph import \
    ComputationGraphConfiguration as TConf
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph as TGraph
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.serving.server import InferenceServer
from deeplearning4j_tpu_torch.util.model_serializer import (params_from_jax,
                                                            write_model)

V = 13
PKGS = {"jax": (jprof, JMetrics), "port": (tprof, MetricsRegistry)}


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
    jnet = JGraph(jlm(vocab_size=V, d_model=16, n_heads=2, n_blocks=2,
                      rope=True)).init()
    tnet = TGraph(TConf.from_json(jnet.conf.to_json()), device="cpu").init()
    tnet.set_params(params_from_jax(
        {k: {n: np.asarray(a) for n, a in lp.items()}
         for k, lp in jnet.params.items()}))
    return jnet, tnet


class FakeClock:
    def __init__(self):
        self.now = 1000.0

    def __call__(self):
        return self.now

    def sleep(self, s):
        self.now += s


class StubEngine:
    """The EngineSupervisor-facing surface with settable vitals."""

    def __init__(self, clock):
        self._clock = clock
        self.heartbeat = clock()
        self.iterations = 1
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
        return kw.get("_handle") or DecodeHandle(len(prompt), max_new_tokens)


def _sup(clock, slo=None, **kw):
    spawned = []

    def factory():
        eng = StubEngine(clock)
        spawned.append(eng)
        return eng

    sup = EngineSupervisor(factory, clock=clock, sleep_fn=clock.sleep,
                           watchdog=False, warm_on_build=False, slo=slo,
                           metrics=MetricsRegistry(),
                           tracer=FlightRecorder(1024), **kw)
    return sup, spawned


def _tick(sup, eng, clock, n):
    for _ in range(n):
        clock.now += 0.1
        eng.heartbeat = clock()
        sup.check()


def _slo(pkg, clock, **kw):
    mod, reg = PKGS[pkg]
    return mod.SLOMonitor(metrics=reg(), clock=clock, **kw)


# ------------------------------------------------------- SLOMonitor unit --
def test_slo_percentiles_and_burn_rates_equal_jax_frozen_clock():
    out = {}
    for pkg in PKGS:
        clock = FakeClock()
        slo = _slo(pkg, clock, objective_p99_s=0.1)
        rows = []
        for i in range(100):
            slo.observe("/generate", 0.01 + 0.0001 * i, request_id=f"r{i}")
        rows.append((slo.percentiles("/generate"), slo.burn_rates(),
                     slo.burning(), slo.calm()))
        for i in range(100):
            clock.now += 0.5
            slo.observe("/generate", 0.5 if i % 3 else 0.05,
                        request_id=f"b{i}")
        rows.append((slo.percentiles("/generate"), slo.burn_rates(),
                     slo.burning(), slo.calm(), slo.brief(),
                     slo.snapshot()))
        out[pkg] = rows
    assert out["port"] == out["jax"]
    p, (fast, slow), burning, calm = out["port"][0]
    assert p["n"] == 100 and 0.01 <= p["p50"] <= p["p99"] <= 0.02
    assert fast == slow == 0.0 and not burning and calm
    _, (fast, slow), burning, calm, *_ = out["port"][1]
    assert fast > 6.0 and slow > 3.0 and burning and not calm


def test_slo_fast_window_recovers_before_slow():
    clock = FakeClock()
    slo = _slo("port", clock, objective_p99_s=0.1, fast_window_s=60,
               slow_window_s=600)
    for _ in range(50):
        slo.observe("/generate", 1.0)
    assert slo.burning()
    clock.now += 120
    for _ in range(50):
        slo.observe("/generate", 0.01)
    fast, slow = slo.burn_rates()
    assert fast == 0.0 and slow == pytest.approx(50.0)
    assert not slo.burning() and slo.calm()


def test_slo_without_objective_never_burns_and_pruning_bounds_memory():
    clock = FakeClock()
    slo = _slo("port", clock)
    for _ in range(64):
        slo.observe("/predict", 99.0)
    assert slo.burn_rates() == (0.0, 0.0)
    assert not slo.burning() and slo.calm()
    assert slo.percentiles("/predict")["n"] == 64
    slo = _slo("port", clock, objective_p99_s=0.1, slow_window_s=100,
               max_samples=64)
    for _ in range(500):
        clock.now += 1.0
        slo.observe("/generate", 0.01)
    with slo._lock:
        assert len(slo._samples["/generate"]) <= 64


def test_single_slow_request_cannot_burn_on_low_traffic():
    clock = FakeClock()
    slo = _slo("port", clock, objective_p99_s=0.25)
    slo.observe("/generate", 0.3)
    assert slo.burn_rates() == (0.0, 0.0)
    assert not slo.burning() and slo.calm()
    for _ in range(slo.min_samples):
        slo.observe("/generate", 0.3)
    assert slo.burning()


def test_burn_verdict_equals_jax():
    for fast in (0.0, 0.5, 1.0, 3.0, 6.0, 9.0):
        for slow in (0.0, 2.9, 3.0, 10.0):
            assert tprof.burn_verdict(fast, slow) == \
                jprof.burn_verdict(fast, slow)
            assert tprof.burn_verdict(fast, slow, 2.0, 1.0) == \
                jprof.burn_verdict(fast, slow, 2.0, 1.0)


# --------------------------------------------------- SLO -> ladder path --
def test_latency_burn_escalates_ladder_with_queue_untouched():
    clock = FakeClock()
    slo = _slo("port", clock, objective_p99_s=0.1)
    sup, spawned = _sup(clock, slo=slo, ladder_patience=2)
    try:
        eng = spawned[0]
        for _ in range(40):
            slo.observe("/generate", 2.0)
        _tick(sup, eng, clock, 4)
        assert sup.degradation_level >= 1
        assert eng.queue_depth() == 0 and eng.shed_calls
        degrades = [e for e in sup.tracer.events() if e["name"] == "degrade"]
        assert degrades and degrades[0]["args"]["input"] == "latency"
    finally:
        sup.stop()


def test_ladder_deescalates_when_latency_calms():
    clock = FakeClock()
    slo = _slo("port", clock, objective_p99_s=0.1, fast_window_s=60,
               slow_window_s=120)
    sup, spawned = _sup(clock, slo=slo, ladder_patience=2)
    try:
        eng = spawned[0]
        for _ in range(40):
            slo.observe("/generate", 2.0)
        _tick(sup, eng, clock, 4)
        assert sup.degradation_level >= 1
        clock.now += 200
        for _ in range(20):
            slo.observe("/generate", 0.01)
        _tick(sup, eng, clock, 2 * sup.degradation_level + 2)
        assert sup.degradation_level == 0
    finally:
        sup.stop()


def test_degradation_level_survives_restart_with_latency_input():
    clock = FakeClock()
    slo = _slo("port", clock, objective_p99_s=0.1)
    sup, spawned = _sup(clock, slo=slo, ladder_patience=1)
    try:
        eng = spawned[0]
        for _ in range(40):
            slo.observe("/generate", 2.0)
        _tick(sup, eng, clock, 4)
        assert sup.degradation_level >= 2
        level = sup.degradation_level
        eng.crashed = RuntimeError("boom")
        sup.check()
        assert len(spawned) == 2 and sup.degradation_level == level
        assert spawned[1].chunk_cap == spawned[1].prefill_chunk // 2
    finally:
        sup.stop()


def test_queue_and_latency_inputs_compose_without_flapping():
    clock = FakeClock()
    slo = _slo("port", clock, objective_p99_s=0.1, fast_window_s=60,
               slow_window_s=120)
    sup, spawned = _sup(clock, slo=slo, ladder_patience=2)
    try:
        eng = spawned[0]
        for _ in range(40):
            slo.observe("/generate", 2.0)
        _tick(sup, eng, clock, 4)
        level = sup.degradation_level
        assert level >= 1
        for _ in range(10):  # queue calm, latency still burning
            slo.observe("/generate", 2.0)
            _tick(sup, eng, clock, 1)
        assert sup.degradation_level >= level
        clock.now += 200  # latency calm, the queue loaded
        for _ in range(20):
            slo.observe("/generate", 0.01)
        eng._queue_depth = eng.max_queue
        lvl = sup.degradation_level
        _tick(sup, eng, clock, 3)
        assert sup.degradation_level >= lvl
        eng._queue_depth = 0  # both calm
        _tick(sup, eng, clock, 4 * sup.degradation_level + 4)
        assert sup.degradation_level == 0
    finally:
        sup.stop()


def test_supervisor_status_carries_slo_brief():
    clock = FakeClock()
    slo = _slo("port", clock, objective_p99_s=0.25)
    sup, _ = _sup(clock, slo=slo)
    try:
        slo.observe("/generate", 0.01, request_id="r1")
        st = sup.status()
        assert st["slo"]["objective_p99_ms"] == 250.0
        assert "burn_rate_fast" in st["slo"] and "routes" not in st["slo"]
        assert "/generate" in slo.snapshot()["routes"]
    finally:
        sup.stop()
    plain, _ = _sup(FakeClock())
    try:
        assert "slo" not in plain.status()
    finally:
        plain.stop()


# ----------------------------------------- step-phase profiler + costs ----
def _drive(prof):
    prof.ingest_costs({("decode", 0): {"flops": 100.0, "bytes": 10.0},
                       ("prefill", 16): {"flops": 1000.0, "bytes": 50.0}})
    for _ in range(4):
        prof.iter_begin()
        prof.lap("admit")
        prof.count("prefill", 16)
        prof.lap("prefill")
        prof.count("decode", 0)
        prof.lap("decode")
        prof.iter_end(tokens=2)


def test_step_phase_profiler_unit_equals_jax():
    tallies = {}
    for pkg, (mod, reg) in PKGS.items():
        m = reg()
        prof = mod.StepPhaseProfiler(m, gauge_every=1, peak_flops=1e9)
        _drive(prof)
        dec = prof.decomposition()
        assert set(dec) == set(mod.PHASES)
        assert abs(sum(p["share"] for p in dec.values()) - 1.0) < 0.01
        snap = prof.cost_snapshot()
        assert m.snapshot()["gauges"]["decode_tokens_per_sec"]["value"] > 0
        tallies[pkg] = (prof.family_dispatches, prof.flops_total,
                        prof.bytes_total, prof.tokens_total,
                        snap["family_flops_share"], snap["per_invocation"],
                        snap["dispatches"], tuple(mod.PHASES))
    assert tallies["port"] == tallies["jax"]
    assert tallies["port"][0] == {"decode": 4, "prefill": 4}
    assert tallies["port"][1] == pytest.approx(4 * 1100.0)


def test_disabled_profiler_is_inert():
    m = MetricsRegistry()
    prof = tprof.StepPhaseProfiler(m, enabled=False)
    prof.iter_begin()
    prof.lap("decode")
    prof.count("decode", 0)
    prof.iter_end(tokens=5)
    assert prof.iterations == 0 and prof.tokens_total == 0
    assert "decode_tokens_per_sec" not in m.snapshot()["gauges"]


def test_idle_tick_decays_rate_gauges():
    m = MetricsRegistry()
    prof = tprof.StepPhaseProfiler(m, gauge_every=1)
    for _ in range(3):
        prof.iter_begin()
        prof.lap("decode")
        prof.iter_end(tokens=100)
    busy = m.snapshot()["gauges"]["decode_tokens_per_sec"]["value"]
    assert busy > 0
    prof._t_gauges = 0.0  # past the 1 Hz throttle
    time.sleep(0.05)
    prof.idle_tick()
    assert m.snapshot()["gauges"]["decode_tokens_per_sec"]["value"] < busy


def test_device_peak_flops_table_and_override(monkeypatch):
    assert tprof.device_peak_flops("cpu") == 1e11
    assert tprof.DEVICE_PEAK_FLOPS["H100"][torch.float32] == 67e12
    assert tprof.DEVICE_PEAK_FLOPS["H100"][torch.bfloat16] == 989e12
    monkeypatch.setenv("DL4J_PEAK_FLOPS", "5e12")
    assert tprof.device_peak_flops("cpu") == 5e12
    assert DecodeScheduler  # the engine reads it at construction


def _engine(tnet, **kw):
    return DecodeScheduler(tnet, V, n_slots=2, prefill_chunk=16,
                           metrics=MetricsRegistry(),
                           tracer=FlightRecorder(2048), device="cpu", **kw)


# the JAX engine's debug_snapshot keys the port's lacks or adds: none —
# the differences are inside blocks (paged_kernel has no "autotune": the
# port does not autotune; compile_cache counts captured runners, not jit
# cache entries)
@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_engine_cost_attribution_and_debug_snapshot(nets, paged):
    jnet, tnet = nets
    kw = dict(kv_pool_mb=1.0, kv_block=8) if paged else {}
    eng = _engine(tnet, **kw).start()
    try:
        eng.attribute_costs()
        assert eng.profiler.costs
        for key, c in eng.profiler.costs.items():
            assert c["flops"] > 0 and c["bytes"] > 0, key
        eng.generate(list(range(1, 11)) * 2, 6, timeout=120)
        snap = eng.debug_snapshot()
    finally:
        eng.stop()
    costs = snap["costs"]
    assert costs["per_invocation"]["decode"]
    assert costs["tokens_per_sec"] > 0 and costs["mfu_estimate"] > 0
    assert costs["peak_flops_per_device"] > 0
    assert costs["dispatches"]["decode"] >= 1
    assert costs["dispatches"]["prefill"] >= 1
    assert snap["phases"]["decode"]["seconds"] > 0
    assert snap["mesh"]["tp"] == 1 and snap["slots"][0] is None
    assert snap["compile_cache"]["decode"] >= 0
    hists = eng.metrics.snapshot()["histograms"]
    assert hists['decode_step_phase_seconds{phase="decode"}']["count"] > 0
    jeng = JEngine(jnet, V, n_slots=2, prefill_chunk=16, metrics=JMetrics(),
                   tracer=JRecorder(2048),
                   **(dict(kw, paged_kernel="off") if paged else {}))
    jsnap = jeng.debug_snapshot()
    assert set(snap) == set(jsnap)
    assert set(snap["costs"]) == set(jsnap["costs"])
    assert set(snap["phases"]) == set(jsnap["phases"])
    if paged:
        assert set(jsnap["paged_kernel"]) - set(snap["paged_kernel"]) == \
            {"autotune"}
        # on CPU tensors the layer's gather body runs: no bucket fused
        assert snap["paged_kernel"]["engaged"] is False
        assert all(c["fused"] == 0.0 for c in
                   snap["costs"]["per_invocation"]["decode"].values())
    # a rebuilt engine over the same net takes the cached table at warmup
    eng2 = _engine(tnet, **kw)
    assert not eng2.profiler.costs
    eng2.warmup()
    assert eng2.profiler.costs == eng.profiler.costs


def test_program_costs_cover_every_bucket_and_stay_near_jax(nets):
    """The keys are JAX's: decode per table bucket, prefill per chunk
    bucket (and the speculative families); each FLOPs entry lies within
    [0.5, 2] of JAX's XLA count (which adds the elementwise work)."""
    jnet, tnet = nets
    for kw in (dict(kv_pool_mb=1.0, kv_block=8), {}):
        for spec in (0, 2):
            eng = _engine(tnet, speculate=spec, **kw)
            jeng = JEngine(jnet, V, n_slots=2, prefill_chunk=16,
                           speculate=spec, metrics=JMetrics(),
                           tracer=JRecorder(256),
                           **(dict(kw, paged_kernel="off") if kw else {}))
            tc, jc = tprof.program_costs(eng), jprof.program_costs(jeng)
            assert set(tc) == set(jc)
            if eng.paged:
                assert sorted(b for f, b in tc if f == "decode") == \
                    sorted(eng.table_buckets)
            assert sorted(b for f, b in tc if f == "prefill") == \
                sorted(eng.prefill_buckets)
            ratios = {k: tc[k]["flops"] / jc[k]["flops"] for k in tc}
            print("paged" if kw else "contiguous", f"speculate={spec}",
                  {f"{f}/{b}": round(r, 3) for (f, b), r in ratios.items()})
            assert all(0.5 <= r <= 2.0 for r in ratios.values()), ratios


def _counted(eng, family, key, fill):
    """FlopCounterMode's total over one eager run of ``family``'s runner
    at ``key``, built the way the engine builds it."""
    if family == "decode":
        r = eng._new_runner(key)
    elif family == "prefill":
        r = eng._new_chunk_runner(*key)
    else:
        r = eng._new_spec_runner(family, key)
    fill(r)
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        eng._body(r)
    return fc.get_total_flops()


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_cost_table_matmul_flops_equal_flop_counter(nets, paged):
    """Each family's table entry equals torch's count of the runner's
    matmuls and attention contractions, run eagerly on the plain path."""
    _, tnet = nets
    kw = dict(kv_pool_mb=1.0, kv_block=8) if paged else {}
    eng = _engine(tnet, speculate=2, **kw)
    costs = tprof.program_costs(eng)
    s, w = eng.n_slots, eng.speculate + 1
    zeros = np.zeros((s,), np.int32)
    checked = 0
    for nb in (eng.table_buckets if paged else [None]):
        table = np.full((s, nb), SCRATCH_BLOCK, np.int32) if nb else None
        got = _counted(eng, "decode", nb,
                       lambda r: r.fill(zeros, zeros, zeros, table))
        assert got == costs[("decode", nb or 0)]["flops"], nb
        got = _counted(eng, "verify", nb, lambda r: r.fill(
            np.zeros((s, w), np.int32), zeros, zeros, table))
        assert got == costs[("verify", nb or 0)]["flops"], nb
        checked += 2
    for b in eng.prefill_buckets:
        from deeplearning4j_tpu_torch.inference.batcher import bucket_for
        from deeplearning4j_tpu_torch.inference.kvpool import blocks_for
        nb = bucket_for(blocks_for(b, eng.kv_block), eng.table_buckets) \
            if paged else None
        got = _counted(eng, "prefill", (b, nb), lambda r: r.fill(
            np.zeros((b,), np.int32), 1, 0, 0,
            np.full((nb,), SCRATCH_BLOCK, np.int32) if nb else None))
        assert got == costs[("prefill", b)]["flops"], b
        got = _counted(eng, "draft_prefill", (b, None), lambda r: r.fill(
            np.zeros((b,), np.int32), 1, 0, 0, None))
        assert got == costs[("draft_prefill", b)]["flops"], b
        checked += 2
    got = _counted(eng, "draft", None,
                   lambda r: r.fill(zeros, zeros, zeros, None))
    assert got == costs[("draft", 0)]["flops"]
    assert checked + 1 == len(costs)


# ------------------------------------------------------------ HTTP layer --
def _post(base, path, payload):
    req = urllib.request.Request(
        base + path, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def _get(base, path, headers=None):
    req = urllib.request.Request(base + path, headers=headers or {})
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.read()


def test_http_debug_engine_info_slo_and_exemplars(nets):
    _, tnet = nets
    srv = InferenceServer(net=tnet, decode_vocab=V, decode_slots=2,
                          prefill_chunk=16, kv_pool_mb=1.0, kv_block=8,
                          host_cache_mb=1.0, slo_p99_ms=30000.0,
                          device="cpu").start()
    try:
        base = f"http://127.0.0.1:{srv.port}"
        out = _post(base, "/generate", {"prompt": list(range(1, 9)),
                                        "max_new_tokens": 3})
        rid = out["request_id"]
        prom = _get(base, "/metrics?format=prometheus").decode()
        assert "# TYPE http_route_latency_seconds histogram" in prom
        assert 'http_route_latency_seconds_bucket{route="/generate"' in prom
        assert f'request_id="{rid}"' in prom
        dbg = json.loads(_get(base, "/debug/engine"))
        assert dbg["n_slots"] == 2 and len(dbg["slots"]) == 2
        assert dbg["paged"] and dbg["pool"]["capacity_blocks"] > 0
        assert dbg["costs"]["per_invocation"]["decode"]
        assert dbg["costs"]["tokens_per_sec"] >= 0
        assert "mfu_estimate" in dbg["costs"] and dbg["phases"]
        assert set(dbg["paged_kernel"]) == {"mode", "engaged", "buckets"}
        assert dbg["tier"]["host"]["budget_bytes"] == 1 << 20
        assert dbg["supervisor"]["slo"]["objective_p99_ms"] == 30000.0
        assert "/generate" in dbg["slo"]["routes"]
        info = json.loads(_get(base, "/info"))
        assert info["slo"]["objective_p99_ms"] == 30000.0
        assert "tokens_per_sec" in info["profiler"]
        ready = json.loads(_get(base, "/readyz"))
        assert ready["slo"]["burning"] is False
    finally:
        srv.stop()


def test_http_debug_engine_404_without_decoder():
    net = MultiLayerNetwork(mlp_iris(), device="cpu").init()
    srv = InferenceServer(net=net, device="cpu").start()
    try:
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(f"http://127.0.0.1:{srv.port}", "/debug/engine")
        assert e.value.code == 404
    finally:
        srv.stop()


def test_cli_serve_tier_and_slo_flags(nets, tmp_path, capsys):
    from deeplearning4j_tpu_torch.cli.main import main
    _, tnet = nets
    path = tmp_path / "lm.zip"
    write_model(tnet, path)
    tdir = tmp_path / "tiers"
    assert main(["serve", "--model", str(path), "--generate",
                 "--kv-pool-mb", "0.05", "--kv-block", "8",
                 "--host-cache-mb", "4", "--disk-cache-mb", "16",
                 "--tier-dir", str(tdir), "--slo-p99-ms", "250",
                 "--device", "cpu", "--once"]) == 0
    banner = capsys.readouterr().out
    assert "host tier 4.0MB + disk 16.0MB" in banner
    assert "/debug/engine, /prefix/directory" in banner
    assert os.path.isdir(tdir)
