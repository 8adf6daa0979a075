"""Port parity: the contiguous decode engine (per-slot stripes, the side
prefix pool).

The cases of tests/test_decode_prefill.py (:45, :94, :138, :155) and
tests/test_kvpool.py (:122, :154, :181, :215, :249, :269, :301), run on
the port's `DecodeScheduler(device="cpu")` with its default
``kv_pool_mb=0`` and on the JAX `DecodeScheduler(kv_pool_mb=0)` with the
same net (the JAX params carried over by `params_from_jax`) and the same
requests. Tokens must be identical, greedy and seeded-sampled, and equal
to the port's solo `generate_transformer(use_cache=True)`; the two
packages' prefix counters (lookups, hits, their tokens, evictions) and
prefill token counts must agree on the same traffic, as must the engine
steps to each first token.
"""
import time

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.inference import DecodeScheduler as JEngine
from deeplearning4j_tpu.inference import MetricsRegistry as JRegistry
from deeplearning4j_tpu.models.zoo import transformer_lm as jlm
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu_torch.inference.engine import (DecodeHandle,
                                                       DecodeScheduler,
                                                       PromptTooLongError,
                                                       _ActiveSeq)
from deeplearning4j_tpu_torch.inference.metrics import MetricsRegistry
from deeplearning4j_tpu_torch.models.sampling import generate_transformer
from deeplearning4j_tpu_torch.nn.conf.graph import \
    ComputationGraphConfiguration as TConf
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph as TGraph
from deeplearning4j_tpu_torch.util.model_serializer import params_from_jax

V = 13
COUNTERS = ("prefix_cache_lookups_total", "prefix_cache_hits_total",
            "prefix_cache_lookup_tokens_total",
            "prefix_cache_hit_tokens_total",
            "prefix_cache_evicted_blocks_total", "prefill_tokens_total")
SAMPLED = dict(temperature=0.8, top_k=5, top_p=0.9)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tier-1 runs several test files at once on a few cores; one torch
    intra-op thread keeps this file from starving the others' timings."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_NETS = {}


def _nets(cache):
    """(JAX net, port net) of the test LM at ``max_cache_len=cache``."""
    if cache not in _NETS:
        conf = jlm(vocab_size=V, d_model=16, n_heads=2, n_blocks=2,
                   rope=True)
        for vert in conf.vertices.values():
            layer = getattr(vert, "layer", None)
            if layer is not None and hasattr(layer, "max_cache_len"):
                layer.max_cache_len = cache
        jnet = JGraph(conf).init()
        tnet = TGraph(TConf.from_json(jnet.conf.to_json()),
                      device="cpu").init()
        tnet.set_params(params_from_jax(
            {k: {n: np.asarray(a) for n, a in lp.items()}
             for k, lp in jnet.params.items()}))
        _NETS[cache] = (jnet, tnet)
    return _NETS[cache]


def _both(cache, fn, **kw):
    """``fn(engine)`` on a started JAX engine and on a started port engine
    (contiguous: no kv_pool_mb), both built with ``kw``; each engine is
    stopped afterwards. Returns [(result, engine, registry)] JAX first."""
    jnet, tnet = _nets(cache)
    out = []
    for make, reg in ((lambda r: JEngine(jnet, V, metrics=r, **kw),
                       JRegistry()),
                      (lambda r: DecodeScheduler(tnet, V, metrics=r,
                                                 device="cpu", **kw),
                       MetricsRegistry())):
        eng = make(reg).start()
        try:
            out.append((fn(eng), eng, reg))
        finally:
            eng.stop()
    assert not out[1][1].paged
    return out


def _counters(reg):
    snap = reg.snapshot()["counters"]
    return {k: snap.get(k) for k in COUNTERS}


def _solo(cache, prompt, n, **kw):
    return generate_transformer(_nets(cache)[1], prompt, n, V,
                                use_cache=True, **kw)


def _prompt(seed, n):
    return [int(t) for t in np.random.default_rng(seed).integers(0, V, n)]


def _submit_all(reqs):
    return lambda e: [(h.result(120), h.steps_to_first_token)
                      for h in [e.submit(p, n, **kw) for p, n, kw in reqs]]


# ---------------------------------------------------------- chunked prefill --
@pytest.mark.parametrize("chunk", [16, 1])
def test_chunked_prefill_matches_token_by_token_and_solo_greedy(chunk):
    """test_decode_prefill.py:45: prompts whose last chunk is full, partial
    and sub-bucket; first tokens in ceil(len / 16) engine steps chunked,
    len steps token by token (no prefill tokens then)."""
    rng = np.random.default_rng(0)
    prompts = [list(rng.integers(0, V, 37)), [5], list(rng.integers(0, V, 32)),
               list(rng.integers(0, V, 20))]
    reqs = [(p, n, {}) for p, n in zip(prompts, [6, 4, 5, 3])]
    (want, _, jreg), (got, _, treg) = _both(96, _submit_all(reqs), n_slots=2,
                                            prefill_chunk=chunk)
    assert got == want
    assert [t for t, _ in got] == [_solo(96, p, n) for p, n, _ in reqs]
    if chunk == 16:
        assert [s for _, s in got] == [3, 1, 2, 2]
        assert _counters(treg)["prefill_tokens_total"] == 90
    else:
        assert got[0][1] == 37
        assert _counters(treg)["prefill_tokens_total"] == 0
    assert _counters(treg) == _counters(jreg)


def test_chunked_prefill_seeded_sampling_matches_solo():
    """test_decode_prefill.py:94: chunk 8, two sampled requests."""
    rng = np.random.default_rng(1)
    prompts = [list(rng.integers(0, V, 21)), list(rng.integers(0, V, 9))]
    reqs = [(p, 7, dict(SAMPLED, seed=42 + i)) for i, p in enumerate(prompts)]
    (want, _, _), (got, _, _) = _both(96, _submit_all(reqs), n_slots=2,
                                      prefill_chunk=8)
    assert got == want
    assert [t for t, _ in got] == [_solo(96, p, n, **kw) for p, n, kw in reqs]


def test_partial_chunk_then_continued_decode_reads_clean_cache():
    """test_decode_prefill.py:138: a 16 + 3 prompt whose padding rows the
    decode later overwrites, 25 tokens on a 64-position stripe."""
    prompt = _prompt(3, 19)
    (want, _, _), (got, _, _) = _both(
        64, lambda e: e.submit(prompt, 25).result(120), n_slots=1,
        prefill_chunk=16)
    assert got == want == _solo(64, prompt, 25)


def test_tail_without_bucket_headroom_falls_back_token_by_token():
    """test_decode_prefill.py:155: a 20-position stripe fits one 16-chunk;
    the 2-token tail goes token by token through the decode step."""
    prompt = _prompt(6, 18)
    (want, _, jreg), (got, _, treg) = _both(
        20, lambda e: _submit_all([(prompt, 3, {})])(e), n_slots=1,
        prefill_chunk=16)
    assert got == want == [(_solo(20, prompt, 3), 3)]
    assert _counters(treg)["prefill_tokens_total"] == 16
    assert _counters(treg) == _counters(jreg)


def test_prompt_too_long_for_the_stripe_is_refused_at_submit():
    """JAX engine.py:140: len(prompt) + max_new_tokens - 1 > max_cache_len
    is refused before it is queued, and counted."""
    _, tnet = _nets(20)
    reg = MetricsRegistry()
    eng = DecodeScheduler(tnet, V, n_slots=1, metrics=reg, device="cpu")
    with pytest.raises(PromptTooLongError, match="max_cache_len=20"):
        eng.submit([1] * 18, 4)
    assert reg.counter("decode_rejected_total").value == 1
    with pytest.warns(RuntimeWarning, match="paged KV pool did not engage"):
        eng = DecodeScheduler(tnet, V, kv_dtype="int8", device="cpu")
    assert eng.kv_dtype is None and not eng.paged


# -------------------------------------------------------------- prefix pool --
def test_full_prefix_hit_is_token_identical_and_quarter_ttft_steps():
    """test_kvpool.py:122: the repeat of a 64-token prompt restores 48
    tokens (capped one token short of the prompt) and prefills one cold
    chunk: 1 engine step to its first token against 4 cold."""
    prompt = _prompt(0, 64)
    run = _submit_all([(prompt, 6, {})])
    (want, jeng, jreg), (got, teng, treg) = _both(
        96, lambda e: run(e) + run(e), n_slots=2, prefill_chunk=16,
        prefix_cache_mb=2.0, kv_block=16)
    solo = _solo(96, prompt, 6)
    assert got == want == [(solo, 4), (solo, 1)]
    c = _counters(treg)
    assert c["prefix_cache_hit_tokens_total"] == 48
    assert c["prefix_cache_hits_total"] == 1
    assert c["prefix_cache_lookups_total"] == 2
    assert c == _counters(jreg)
    assert treg.snapshot()["ratios"]["prefix_cache_hit_rate"] > 0.3
    assert teng.pool.outstanding_refs() == 0
    assert teng.restored_tokens == 48


def test_partial_hit_cold_suffix_crossing_chunk_bucket_boundary():
    """test_kvpool.py:154: 24 shared tokens restored, a 21-token cold
    suffix in two chunks."""
    rng = np.random.default_rng(1)
    base = list(rng.integers(0, V, 32))
    other = base[:24] + list(rng.integers(0, V, 21))
    reqs = [(base, 5, {}), (other, 5, {})]

    def run(e):
        return [_submit_all([r])(e)[0] for r in reqs]
    (want, _, jreg), (got, _, treg) = _both(96, run, n_slots=2,
                                            prefill_chunk=16,
                                            prefix_cache_mb=2.0, kv_block=8)
    assert got == want
    assert [t for t, _ in got] == [_solo(96, p, 5) for p, _, _ in reqs]
    assert got[1][1] == 2
    assert _counters(treg)["prefix_cache_hit_tokens_total"] == 24
    assert _counters(treg) == _counters(jreg)


def test_concurrent_slots_share_prefix_blocks_without_aliasing():
    """test_kvpool.py:181: two live slots restored from the same blocks,
    each writing only its own stripe, 64 tokens each."""
    rng = np.random.default_rng(2)
    prefix = list(rng.integers(0, V, 32))
    p1 = prefix + list(rng.integers(0, V, 8))
    p2 = prefix + list(rng.integers(0, V, 11))
    pins = []

    def run(e):
        e.submit(prefix + [1], 2).result(120)  # publish the prefix
        hs = [e.submit(p1, 64), e.submit(p2, 64)]
        deadline = time.monotonic() + 60
        while e.pool.outstanding_refs() < 2 and not all(h.done() for h in hs):
            assert time.monotonic() < deadline
            time.sleep(0.002)
        pins.append(max(e.pool.refcounts().values(), default=0))
        return [h.result(120) for h in hs]
    (want, jeng, jreg), (got, teng, treg) = _both(
        160, run, n_slots=2, prefill_chunk=16, prefix_cache_mb=2.0,
        kv_block=8)
    assert got == want == [_solo(160, p, 64) for p in (p1, p2)]
    assert pins[1] == 2  # both slots pin the same deepest node
    assert teng.pool.outstanding_refs() == 0
    assert _counters(treg) == _counters(jreg)


def test_eviction_under_tiny_budget_mid_stream_stays_correct():
    """test_kvpool.py:215: a 4-block pool serving 4-block prompts twice
    evicts (counted), never passes its budget, and never corrupts."""
    rng = np.random.default_rng(3)
    prompts = [list(rng.integers(0, V, 32)) for _ in range(4)]
    budget = 5 * 2048  # scratch + 4 blocks of 2 x 2 x 8 x 2 x 8 x 4 bytes
    used = []

    def run(e):
        out = []
        for _ in range(2):
            for p in prompts:
                out.append(e.generate(p, 4, timeout=120))
                used.append(e.pool.used_blocks)
        return out
    (want, _, jreg), (got, teng, treg) = _both(
        96, run, n_slots=1, prefill_chunk=16,
        prefix_cache_mb=budget / float(1 << 20), kv_block=8)
    assert teng.pool.capacity_blocks == 4
    assert got == want == [_solo(96, p, 4) for p in prompts] * 2
    assert max(used) <= 4
    assert _counters(treg)["prefix_cache_evicted_blocks_total"] >= 4
    assert _counters(treg) == _counters(jreg)
    assert treg.gauge("prefix_cache_used_bytes").max <= budget
    assert treg.gauge("prefix_cache_capacity_bytes").value <= budget


def test_seeded_sampling_matches_solo_through_a_prefix_hit():
    """test_kvpool.py:249: the first draw still comes from the last real
    prompt token's distribution after a restore."""
    prompt = _prompt(4, 40)
    kw = dict(SAMPLED, seed=11)
    (want, _, jreg), (got, _, treg) = _both(
        96, lambda e: [e.generate(prompt, 6, timeout=120, **kw)
                       for _ in range(2)],
        n_slots=2, prefill_chunk=16, prefix_cache_mb=2.0, kv_block=8)
    assert got == want == [_solo(96, prompt, 6, **kw)] * 2
    assert _counters(treg)["prefix_cache_hits_total"] == 1
    assert _counters(treg) == _counters(jreg)


def test_cancel_mid_prefill_releases_pool_references():
    """test_kvpool.py:269, on both engines' internals: admit and restore a
    sequence by hand, cancel it before its prefill ends, and the sweep
    returns every pin, publishes nothing and counts the cancel."""
    prompt = _prompt(5, 48)
    jnet, tnet = _nets(96)
    seen = []
    for make, reg, handle_cls, seq_cls in (
            (lambda r: JEngine(jnet, V, n_slots=1, prefill_chunk=16,
                               prefix_cache_mb=2.0, kv_block=8, metrics=r),
             JRegistry(), None, None),
            (lambda r: DecodeScheduler(tnet, V, n_slots=1, prefill_chunk=16,
                                       prefix_cache_mb=2.0, kv_block=8,
                                       metrics=r, device="cpu"),
             MetricsRegistry(), DecodeHandle, _ActiveSeq)):
        eng = make(reg).start()
        eng.generate(prompt, 2, timeout=120)  # publish the prefix
        eng.stop()
        if handle_cls is None:
            from deeplearning4j_tpu.inference import DecodeHandle as JHandle
            from deeplearning4j_tpu.inference.engine import _ActiveSeq as JSeq
            handle_cls, seq_cls = JHandle, JSeq
        used = eng.pool.used_blocks
        seq = seq_cls(handle_cls(len(prompt), 4), prompt, 0.0, None, None,
                      0, None)
        eng._reset_slot_state(0)
        eng._slots[0] = seq
        eng._try_restore(0, seq)
        assert 0 < seq.fed < len(prompt)
        assert eng.pool.outstanding_refs() == 1
        seq.handle.cancel()
        eng._evict_cancelled()
        assert eng.pool.outstanding_refs() == 0 and eng.pool.refcounts() == {}
        assert eng._slots[0] is None and seq.handle.done()
        assert eng.pool.used_blocks == used
        assert reg.counter("decode_cancelled_total").value == 1
        seen.append((seq.fed, used, _counters(reg)))
    assert seen[0] == seen[1]


def test_cancel_end_to_end_frees_references_and_pool_keeps_working():
    """test_kvpool.py:301: a request cancelled during its 50-chunk cold
    suffix leaves no pin, and the pool still serves hits after it."""
    rng = np.random.default_rng(6)
    prefix = list(rng.integers(0, V, 16))
    long = prefix + list(rng.integers(0, V, 200))

    def run(e):
        e.generate(prefix + [1], 2, timeout=120)
        h = e.submit(long, 8)
        deadline = time.monotonic() + 60
        while e.pool.outstanding_refs() == 0:
            assert time.monotonic() < deadline, "restore never pinned"
            time.sleep(0.001)
        h.cancel()
        while e.pool.outstanding_refs() != 0:
            assert time.monotonic() < deadline, "cancel leaked a pin"
            time.sleep(0.002)
        return e.generate(prefix + [2], 3, timeout=120)
    (want, _, _), (got, teng, treg) = _both(
        256, run, n_slots=1, prefill_chunk=4, prefix_cache_mb=2.0,
        kv_block=8)
    assert got == want == _solo(256, prefix + [2], 3)
    assert teng.pool.outstanding_refs() == 0
    assert treg.counter("decode_cancelled_total").value == 1
