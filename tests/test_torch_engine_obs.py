"""Port: the decode engine's trace, metrics, warmup() and captured step.

  - the request span tree and `timings()` summing (the analogues of
    tests/test_trace.py:152, :199, :242), the Chrome export valid;
  - `warmup()` changes nothing observable: the registry snapshot, the
    recorder's events, the pool's `stats()` and the later tokens;
  - the capture budget: one decode runner per table bucket however many
    steps run (one in contiguous mode), none built after `warmup()`;
  - the static-buffer step (``decode_graphs="on"``, eager on the CPU)
    gives the tokens of the eager step (``"off"``), paged and contiguous;
  - the RoPE repair (the base filled on the device, so the step can be
    captured): the rotation bitwise that of the host-copy formula and
    within 1e-6 of the JAX `_rope`.
"""
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn.conf import serde as jserde
from deeplearning4j_tpu.nn.conf.layers import SelfAttentionLayer
from deeplearning4j_tpu.nn.layers.base import impl_for as jimpl_for
from deeplearning4j_tpu_torch.inference.engine import DecodeScheduler
from deeplearning4j_tpu_torch.inference.metrics import MetricsRegistry
from deeplearning4j_tpu_torch.inference.trace import FlightRecorder
from deeplearning4j_tpu_torch.models.sampling import generate_transformer
from deeplearning4j_tpu_torch.models.zoo import transformer_lm
from deeplearning4j_tpu_torch.nn.conf import serde as tserde
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.layers.base import impl_for as timpl_for

from test_torch_metrics_trace import _validate_chrome

V = 13
SAMPLED = dict(temperature=0.8, top_k=5, seed=3)


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


def _prompt(seed, n):
    return [int(t) for t in np.random.default_rng(seed).integers(0, V, n)]


def _pool_mb(blocks, block):
    """MiB buying ``blocks`` usable paged blocks (+1 scratch): 2 layers x
    (k, v) x ``block`` positions x Hkv=2 x Dh=8 x 4 bytes."""
    return (blocks + 1) * 2 * 2 * block * 2 * 8 * 4 / float(1 << 20)


MODES = {"contiguous": dict(prefix_cache_mb=2.0, kv_block=8),
         "paged": dict(kv_pool_mb=_pool_mb(24, 8), kv_block=8)}


def _engine(mode, cache=96, **kw):
    return DecodeScheduler(_lm(cache), V, device="cpu",
                           **dict(MODES[mode], **kw))


# ------------------------------------------------------------- span trees --
def test_engine_span_tree_and_timings_sum():
    """test_trace.py:152: one request's queued -> prefix_restore -> prefill
    (3 chunk spans of bucket 16 on its slot track) -> decode -> finish
    tree, admit/free and capture instants, a valid Chrome export, and
    timings() phases summing to the end-to-end latency."""
    rec = FlightRecorder(4096)
    eng = DecodeScheduler(_lm(), V, n_slots=2, prefill_chunk=16,
                          metrics=MetricsRegistry(), tracer=rec,
                          device="cpu").start()
    try:
        h = eng.submit(_prompt(0, 37), 5)
        tokens = h.result(120)
    finally:
        eng.stop()
    assert len(tokens) == 5
    rid = h.request_id
    names = [(e["ph"], e["name"]) for e in rec.events()
             if e["track"] == f"request {rid}"]
    for pair in (("B", "queued"), ("E", "queued"), ("B", "prefix_restore"),
                 ("E", "prefix_restore"), ("B", "prefill"), ("E", "prefill"),
                 ("B", "decode"), ("E", "decode"), ("i", "first_token"),
                 ("i", "finish")):
        assert pair in names, (pair, names)
    evs = rec.events()
    chunks = [e for e in evs if e["name"] == "prefill_chunk"
              and e["ph"] == "B" and e["args"]["request"] == rid]
    assert len(chunks) == 3 and {e["args"]["bucket"] for e in chunks} == {16}
    assert {"admit", "free", "capture"} <= {e["name"] for e in evs}
    _validate_chrome(rec.chrome_trace())
    summaries = rec.request_summaries()
    assert summaries and summaries[-1]["request_id"] == rid
    t = h.timings()
    phases = t["queue_ms"] + t["restore_ms"] + t["prefill_ms"] \
        + t["decode_ms"]
    assert phases == pytest.approx(t["total_ms"], abs=0.05)
    assert t["total_ms"] == pytest.approx((h.t_done - h.t_submit) * 1e3,
                                          abs=0.05)
    assert h.steps_to_first_token == 3


def test_cancelled_mid_prefill_span_tree_is_closed():
    """test_trace.py:199: a request cancelled mid-prefill leaves its
    prefill span closed, a cancel instant with timings, its slot freed."""
    rec = FlightRecorder(8192)
    reg = MetricsRegistry()
    eng = DecodeScheduler(_lm(600), V, n_slots=1, prefill_chunk=16,
                          metrics=reg, tracer=rec, device="cpu").start()
    try:
        h = eng.submit(_prompt(1, 512), 4)
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline and not any(
                e["name"] == "prefill_chunk" for e in rec.events()):
            time.sleep(0.002)
        h.cancel()
        while not h.done() and time.monotonic() < deadline:
            time.sleep(0.005)
        assert h.done() and not h.tokens and h.finish_reason == "cancelled"
    finally:
        eng.stop()
    evs = rec.events()
    names = [(e["ph"], e["name"]) for e in evs
             if e["track"] == f"request {h.request_id}"]
    assert ("B", "prefill") in names and ("E", "prefill") in names
    assert ("i", "cancel") in names and ("B", "decode") not in names
    cancel = [e for e in evs if e["name"] == "cancel"][0]
    assert cancel["args"]["tokens"] == 0 and cancel["args"]["total_ms"] > 0
    assert any(e["name"] == "free" for e in evs)
    assert reg.counter("decode_cancelled_total").value == 1
    _validate_chrome(rec.chrome_trace())


def test_preempted_request_waterfall_shows_the_swap_gap():
    """test_trace.py:242: 7 usable 4-position blocks, two requests that
    each grow to 4: a preemption, a ``preempted`` span bridging preempt
    -> resume on the victim's track, a second prefill, and a finish."""
    rec = FlightRecorder(8192)
    reg = MetricsRegistry()
    p1, p2 = _prompt(2, 6), _prompt(3, 6)
    eng = DecodeScheduler(_lm(), V, n_slots=2, prefill_chunk=16,
                          kv_pool_mb=8 * 1024 / float(1 << 20), kv_block=4,
                          metrics=reg, tracer=rec, device="cpu").start()
    try:
        got = [h.result(120) for h in [eng.submit(p1, 10),
                                       eng.submit(p2, 10)]]
    finally:
        eng.stop()
    assert got == [generate_transformer(_lm(), p, 10, V) for p in (p1, p2)]
    assert reg.counter("decode_preempted_total").value >= 1
    evs = rec.events()
    names = [e["name"] for e in evs]
    assert {"block_alloc", "preempt", "resume"} <= set(names)
    pre = [e for e in evs if e["name"] == "preempt"][0]
    assert pre["args"]["blocks_released"] >= 1
    rnames = [(e["ph"], e["name"]) for e in evs
              if e["track"] == f"request {pre['args']['request']}"]
    assert rnames.index(("B", "preempted")) < rnames.index(("E", "preempted"))
    assert rnames.count(("B", "prefill")) >= 2
    assert [n for n in rnames if n[0] == "i"][-1] == ("i", "finish")
    _validate_chrome(rec.chrome_trace())


# ---------------------------------------------------------------- warmup --
def _observable(eng, reg, rec):
    snap = reg.snapshot()
    snap.pop("uptime_sec")
    return snap, rec.events(), eng.pool.stats(), list(eng._slots), \
        list(eng._queue), eng.decode_steps, eng.prefill_chunks


@pytest.mark.parametrize("mode", list(MODES))
def test_warmup_changes_nothing_observable(mode):
    """JAX engine.py:3496's contract: warmup() leaves the registry, the
    recorder, the pool and the slots as they were, and the tokens served
    after it are those of an engine never warmed."""
    prompts = [_prompt(4, 37), _prompt(4, 37)[:24] + _prompt(5, 9),
               _prompt(6, 3)]
    kw = [{}, SAMPLED, {}]
    out = []
    for warm in (True, False):
        reg, rec = MetricsRegistry(), FlightRecorder(4096)
        eng = _engine(mode, n_slots=2, prefill_chunk=16, metrics=reg,
                      tracer=rec)
        if warm:
            before = _observable(eng, reg, rec)
            eng.warmup()
            assert _observable(eng, reg, rec) == before
            assert eng.decode_captures == (
                len(eng.table_buckets) if eng.paged else 1)
        eng.start()
        try:
            out.append([eng.generate(p, 5, timeout=120, **k)
                        for p, k in zip(prompts, kw)])
        finally:
            eng.stop()
    assert out[0] == out[1]


# -------------------------------------------------------- capture budget --
@pytest.mark.parametrize("mode", list(MODES))
def test_capture_budget_one_runner_per_bucket(mode):
    """The counterpart of the JAX CompileCounter budget
    (test_decode_prefill.py:178): a workload of many lengths builds at
    most one decode runner per table bucket (one in contiguous mode),
    and an engine warmed first builds none under traffic."""
    rng = np.random.default_rng(7)
    lengths = [1, 3, 7, 15, 16, 17, 30, 33, 64, 70]
    prompts = [list(rng.integers(0, V, n)) for n in lengths]
    for warm in (False, True):
        eng = _engine(mode, n_slots=3, prefill_chunk=32,
                      metrics=MetricsRegistry(), tracer=FlightRecorder(0))
        if warm:
            eng.warmup()
        warmed = eng.decode_captures
        eng.start()
        try:
            for h in [eng.submit(p, 3) for p in prompts]:
                h.result(120)
        finally:
            eng.stop()
        budget = len(eng.table_buckets) if eng.paged else 1
        assert eng.decode_captures == len(eng._runners) <= budget
        assert eng.decode_steps > budget
        if warm:
            assert warmed == budget and eng.decode_captures == warmed
            with pytest.raises(RuntimeError, match="capture budget"):
                eng._new_runner(eng.table_buckets[0] if eng.paged else None)


@pytest.mark.parametrize("mode", list(MODES))
def test_static_buffer_step_gives_the_eager_step_tokens(mode):
    """decode_graphs "on" runs the step on the runners' static buffers
    (eagerly, on the CPU); "off" is the eager step with tensors made per
    dispatch. Greedy and sampled, token by token (prefill_chunk 1) and
    chunked, the tokens are the same."""
    prompts = [_prompt(8, 21), _prompt(9, 5), _prompt(10, 40)]
    kw = [{}, SAMPLED, dict(SAMPLED, seed=4)]
    for chunk in (1, 16):
        out = []
        for graphs in ("on", "off"):
            eng = _engine(mode, n_slots=2, prefill_chunk=chunk,
                          decode_graphs=graphs, metrics=MetricsRegistry(),
                          tracer=FlightRecorder(0)).start()
            try:
                out.append([h.result(120) for h in
                            [eng.submit(p, 6, **k)
                             for p, k in zip(prompts, kw)]])
            finally:
                eng.stop()
            assert (eng.decode_captures > 0) == (graphs == "on")
        assert out[0] == out[1]


def test_engine_metrics_series():
    """The engine's series under the JAX names, for the features the port
    has, after a paged run with a prefix hit."""
    reg = MetricsRegistry()
    prompt = _prompt(11, 40)
    eng = _engine("paged", n_slots=2, prefill_chunk=16, metrics=reg,
                  tracer=FlightRecorder(0)).start()
    try:
        for _ in range(2):
            eng.generate(prompt, 4, timeout=120)
    finally:
        eng.stop()
    snap = reg.snapshot()
    c, g, hs = snap["counters"], snap["gauges"], snap["histograms"]
    assert c["decode_tokens_total"] == 8 and c["decode_sequences_total"] == 2
    assert c["prefix_cache_hits_total"] == 1
    assert c["prefix_cache_hit_tokens_total"] == 39
    assert c["prefill_tokens_total"] == 41  # the cold 40, the refeed's 1
    assert c["decode_preempted_total"] == 0
    assert g["paged_kernel_engaged"]["value"] == 1.0
    assert g["kv_pool_blocks_capacity"]["value"] == 24
    for name in ("decode_step_time_sec", "decode_seq_latency_sec",
                 "decode_time_to_first_token_sec",
                 "generate_first_token_seconds", "decode_slot_occupancy",
                 "prefill_chunk_size"):
        assert hs[name]["count"] > 0, name
    assert "prefix_cache_hit_rate" in snap["ratios"]
    assert "decode_step_time_sec" in reg.render_text()


# ------------------------------------------------------------------ RoPE --
@pytest.mark.parametrize("pos", [[0, 5, 1023], [7]])
def test_rope_repair_is_bitwise_and_matches_jax(pos):
    """The rotation with the base filled on the device is bitwise the one
    of the host-copy formula it replaced, and within 1e-6 of the JAX
    `_rope` at the flagship's rope_base, for per-row positions."""
    conf = SelfAttentionLayer(n_in=512, n_out=512, n_heads=8, causal=True,
                              rope=True, activation="identity")
    jl = jimpl_for(conf)
    tl = timpl_for(tserde.from_json(jserde.to_json(conf)))
    assert tl.conf.rope_base == conf.rope_base == 10000.0
    rng = np.random.default_rng(0)
    a = rng.normal(size=(len(pos), 3, 8, 64)).astype(np.float32)
    p = np.asarray(pos, np.int32)
    got = tl._rope(torch.tensor(a), torch.tensor(p))

    def host_copy_formula(x, pos0):
        half = x.shape[-1] // 2
        freq = torch.tensor(tl.conf.rope_base, dtype=torch.float32) ** (
            -torch.arange(half, dtype=torch.float32) / half)
        t = torch.arange(x.shape[1], dtype=torch.float32)
        ang = (pos0.to(torch.float32)[:, None] + t[None, :])[:, :, None] \
            * freq[None, None]
        cos = torch.cos(ang)[:, :, None, :]
        sin = torch.sin(ang)[:, :, None, :]
        a1, a2 = x[..., :half], x[..., half:]
        return torch.cat([a1 * cos - a2 * sin, a1 * sin + a2 * cos], dim=-1)

    assert torch.equal(got, host_copy_formula(torch.tensor(a),
                                              torch.tensor(p)))
    want = np.asarray(jl._rope(jnp.asarray(a), jnp.asarray(p)))
    assert np.abs(got.numpy() - want).max() <= 1e-6 * max(
        1.0, float(np.abs(want).max()))


# -------------------------------------------------------- entry points --
def test_default_server_and_cli_serve_contiguous(tmp_path, capsys):
    """`InferenceServer(net)` and `serve --generate` with default arguments
    serve in contiguous mode, as in JAX; the server warms the engine up
    before it answers (its one decode step built, none under traffic)."""
    import json
    import urllib.request
    from deeplearning4j_tpu_torch.cli.main import main
    from deeplearning4j_tpu_torch.serving.server import InferenceServer
    from deeplearning4j_tpu_torch.util.model_serializer import write_model
    net = _lm()
    prompt = _prompt(12, 20)
    srv = InferenceServer(net=net, device="cpu").start()
    try:
        base = f"http://127.0.0.1:{srv.port}"
        with urllib.request.urlopen(base + "/info", timeout=30) as r:
            info = json.loads(r.read())["decode"]
        req = urllib.request.Request(
            base + "/generate", headers={"Content-Type": "application/json"},
            data=json.dumps({"prompt": prompt, "max_new_tokens": 4}).encode())
        with urllib.request.urlopen(req, timeout=120) as r:
            body = json.loads(r.read())
    finally:
        srv.stop()
    assert info["kv_mode"] == "contiguous" and info["pool"] is None
    assert info["decode_graphs"] == "on" and info["decode_captures"] == 1
    assert srv.decoder.decode_captures == 1
    assert body["tokens"] == generate_transformer(net, prompt, 4, V)
    t = body["timings"]
    assert set(t) == {"queue_ms", "restore_ms", "prefill_ms", "decode_ms",
                      "total_ms"}
    snap = srv.metrics.snapshot()
    assert snap["counters"]["decode_tokens_total"] == 4
    assert any(e["name"] == "finish" for e in srv.tracer.events())
    path = tmp_path / "lm.zip"
    write_model(net, path)
    assert main(["serve", "--model", str(path), "--generate",
                 "--prefix-cache-mb", "1", "--kv-block", "8",
                 "--trace-buffer", "0", "--device", "cpu", "--once"]) == 0
    banner = capsys.readouterr().out
    assert "contiguous KV (96 positions a slot, prefix pool 1.0MB" in banner
    assert "decode graphs on (1 captured)" in banner
