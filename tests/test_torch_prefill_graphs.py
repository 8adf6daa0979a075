"""Port: the decode engine's captured prefill chunks, their one host read,
and the transfer guard's surface.

The port's `DecodeScheduler(device="cpu")` serves the same requests with
``decode_graphs="on"`` (prefill chunks on static-buffer runners, one per
(chunk bucket, table bucket) pair, or per chunk bucket in contiguous
mode with the slot as a device index — eager here, captured into CUDA
graphs on the card) and ``"off"`` (the eager chunk), and the JAX
`DecodeScheduler` serves them with the same net (the JAX params carried
over): paged fp32 and int8 pages, contiguous with and without a side
prefix pool, at prefill chunk 16 and 8, greedy and seeded-sampled.
Tokens must be identical across all three. Every chunk runner is made in
`warmup()` and none after; a non-final chunk copies nothing to the host
(every host read is a decode step's probs or a final chunk's row).
"""
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.inference import DecodeScheduler as JEngine
from deeplearning4j_tpu.inference import MetricsRegistry as JRegistry
from deeplearning4j_tpu.models.zoo import transformer_lm as jlm
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu_torch.inference.engine import DecodeScheduler
from deeplearning4j_tpu_torch.inference.metrics import MetricsRegistry
from deeplearning4j_tpu_torch.inference.trace import FlightRecorder
from deeplearning4j_tpu_torch.nn.conf.graph import \
    ComputationGraphConfiguration as TConf
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph as TGraph
from deeplearning4j_tpu_torch.util.model_serializer import params_from_jax

V = 13
BLOCK = 8
NEW = 5
SAMPLED = dict(temperature=0.8, top_k=5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tier-1 runs several test files at once on a few cores; one torch
    intra-op thread keeps this file from starving the others' timings."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pool_mb(blocks, kv_dtype):
    # 2 layers x (k, v) x BLOCK positions x Hkv=2 x Dh=8
    row = 2 * 8 + 2 * 4 if kv_dtype == "int8" else 4 * 2 * 8
    return (blocks + 1) * 2 * 2 * BLOCK * row / float(1 << 20)


# name -> engine kwargs shared by both packages
CONFIGS = {
    "paged_fp32": dict(kv_pool_mb=_pool_mb(16, None), kv_block=BLOCK),
    "paged_int8": dict(kv_pool_mb=_pool_mb(16, "int8"), kv_block=BLOCK,
                       kv_dtype="int8"),
    "contiguous": dict(kv_block=BLOCK),
    "contiguous_pool": dict(prefix_cache_mb=2.0, kv_block=BLOCK),
}
CASES = [(name, chunk) for name in CONFIGS for chunk in (16, 8)]


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


def _requests():
    """Prompts of 7, 23 and 40 tokens and one sharing the 40-token
    prompt's first 32 (a prefix hit where a pool is on), greedy, then
    seeded sampling."""
    rng = np.random.default_rng(0)
    ps = [[int(t) for t in rng.integers(0, V, n)] for n in (7, 23, 40)]
    ps.append(ps[2][:32] + [int(t) for t in rng.integers(0, V, 5)])
    return ([(p, {}) for p in ps]
            + [(p, dict(SAMPLED, seed=11 + i)) for i, p in enumerate(ps)])


def _serve(engine, reqs):
    engine.start()
    try:
        handles = [engine.submit(p, NEW, **kw) for p, kw in reqs]
        return [h.result(timeout=300) for h in handles]
    finally:
        engine.stop()


class _CountingReads:
    """Counts the engine's declared device->host reads by kind."""

    def __init__(self, eng):
        self.calls = []
        inner = eng._host_read

        def wrapped(t):
            self.calls.append(tuple(t.shape))
            return inner(t)
        eng._host_read = wrapped


def _port(tnet, name, chunk, graphs, **kw):
    return DecodeScheduler(tnet, V, n_slots=2, prefill_chunk=chunk,
                           decode_graphs=graphs, metrics=MetricsRegistry(),
                           tracer=FlightRecorder(0), device="cpu",
                           **CONFIGS[name], **kw)


@pytest.fixture(scope="module")
def runs(nets):
    """{(config, chunk): {"jax", "on", "off": tokens, "on_engine"}}."""
    jnet, tnet = nets
    reqs = _requests()
    out = {}
    for name, chunk in CASES:
        cfg = dict(CONFIGS[name])
        jeng = JEngine(jnet, V, n_slots=2, prefill_chunk=chunk,
                       paged_kernel="off", metrics=JRegistry(), **cfg)
        on = _port(tnet, name, chunk, "on")
        on.warmup()
        warm = (on.prefill_captures, dict(on._chunk_runners),
                on.decode_captures)
        reads = _CountingReads(on)
        res = {"jax": _serve(jeng, reqs), "on": _serve(on, reqs),
               "off": _serve(_port(tnet, name, chunk, "off"), reqs),
               "on_engine": on, "warm": warm, "reads": reads.calls}
        out[(name, chunk)] = res
    return out


@pytest.mark.parametrize("name,chunk", CASES)
def test_captured_chunks_match_eager_chunks_and_jax(runs, name, chunk):
    r = runs[(name, chunk)]
    assert all(len(t) == NEW for t in r["on"])
    assert r["on"] == r["off"]
    assert r["on"] == r["jax"]


@pytest.mark.parametrize("name,chunk", CASES)
def test_one_chunk_runner_per_pair_all_in_warmup(runs, name, chunk):
    r = runs[(name, chunk)]
    eng = r["on_engine"]
    captures, runners, decode = r["warm"]
    tables = eng.table_buckets if eng.paged else [None]
    pairs = {(b, nb) for b in eng.prefill_buckets for nb in tables}
    assert set(runners) == pairs and captures == len(pairs)
    assert decode == len(tables)
    # none under traffic: the same runners, the same counts
    assert eng._chunk_runners == runners
    assert eng.prefill_captures == captures
    assert eng.decode_captures == decode
    assert eng.prefill_chunks > 0
    with pytest.raises(RuntimeError, match="capture budget"):
        eng._new_chunk_runner(eng.prefill_buckets[0], tables[0])


@pytest.mark.parametrize("name,chunk", CASES)
def test_non_final_chunks_copy_nothing_to_the_host(runs, name, chunk):
    """Every declared host read is a decode step's probs [n_slots, V] or
    one final chunk's row [V]: the chunks before a prompt's last one read
    nothing back (JAX reads only under ``if seq.sampling``)."""
    r = runs[(name, chunk)]
    eng = r["on_engine"]
    rows = [s for s in r["reads"] if s == (V,)]
    steps = [s for s in r["reads"] if s == (eng.n_slots, V)]
    assert len(rows) + len(steps) == len(r["reads"])
    assert len(rows) == eng.chunk_row_reads == eng.final_chunks
    assert len(steps) == eng.decode_steps
    assert eng.prefill_chunks > eng.final_chunks > 0


def test_degraded_chunk_cap_uses_the_captured_smaller_buckets(nets):
    """Degradation level 2 halves the chunk cap: the chunks then take the
    smaller bucket's runners, made in warmup — nothing is built under
    traffic — and the tokens do not change."""
    _, tnet = nets
    reqs = _requests()
    want = _serve(_port(tnet, "paged_fp32", 32, "off"), reqs)
    eng = _port(tnet, "paged_fp32", 32, "on")
    eng.warmup()
    runners = dict(eng._chunk_runners)
    eng.chunk_cap = 16
    assert _serve(eng, reqs) == want
    assert eng._chunk_runners == runners
    assert max(eng.prefill_buckets) == 32


def test_transfer_guard_surface(nets):
    """The guard names JAX's levels, needs the static-buffer path, and on
    CPU tensors changes nothing (torch's sync debug mode is CUDA's)."""
    _, tnet = nets
    reqs = _requests()[:2]
    with pytest.raises(ValueError, match="decode_graphs"):
        _port(tnet, "contiguous", 16, "off", transfer_guard="disallow")
    with pytest.raises(ValueError, match="transfer_guard"):
        _port(tnet, "contiguous", 16, "on", transfer_guard="error")
    plain = _serve(_port(tnet, "contiguous", 16, "on"), reqs)
    guarded = _port(tnet, "contiguous", 16, "on", transfer_guard="disallow")
    assert guarded._guard_mode is None  # CPU tensors: nothing to guard
    assert _serve(guarded, reqs) == plain
