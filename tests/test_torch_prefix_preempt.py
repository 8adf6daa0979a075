"""Port parity: prefix restore, copy-on-write, publish and preempt-and-resume
of the paged decode engine.

The cases of tests/test_paged_decode.py, run on the port's
`DecodeScheduler(device="cpu")` and on the JAX `DecodeScheduler` (paged,
``paged_kernel="off"``: its gather body) with the same net (the JAX params
carried over by `params_from_jax`), the same pools and the same requests.
Tokens must be identical, greedy and seeded-sampled, over fp32 and int8
pages (sampling draws from a per-request numpy RNG in both packages); with
fp32 pages they must also equal the port's solo `generate_transformer`.
The port's own counters (prefix hits, COW copies, preemptions) and pool
state are checked as the JAX suite checks its metrics.
"""
import time

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.inference import DecodeScheduler as JEngine
from deeplearning4j_tpu.inference import MetricsRegistry
from deeplearning4j_tpu.models.zoo import transformer_lm as jlm
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu_torch.inference.engine import (DecodeScheduler,
                                                       PromptTooLongError)
from deeplearning4j_tpu_torch.inference.kvpool import SCRATCH_BLOCK
from deeplearning4j_tpu_torch.models.sampling import generate_transformer
from deeplearning4j_tpu_torch.nn.conf.graph import \
    ComputationGraphConfiguration as TConf
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph as TGraph
from deeplearning4j_tpu_torch.util.model_serializer import params_from_jax

V = 13
KV = [None, "int8"]


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


def _pool_mb(blocks, block, kv):
    """MiB buying exactly ``blocks`` usable blocks (+1 scratch): 2 layers
    x (k, v) x ``block`` positions x Hkv=2 x Dh=8."""
    row = 2 * 8 + 2 * 4 if kv == "int8" else 4 * 2 * 8
    return (blocks + 1) * 2 * 2 * block * row / float(1 << 20)


def _engines(nets, *, blocks, block, kv=None, **kw):
    """(JAX engine, port engine), both started, on the same pool."""
    jnet, tnet = nets
    mb = _pool_mb(blocks, block, kv)
    jeng = JEngine(jnet, V, kv_block=block, kv_pool_mb=mb, kv_dtype=kv,
                   paged_kernel="off", metrics=MetricsRegistry(), **kw)
    teng = DecodeScheduler(tnet, V, kv_block=block, kv_pool_mb=mb,
                           kv_dtype=kv, device="cpu", **kw)
    assert teng.pool.capacity_blocks == jeng.pool.capacity_blocks == blocks
    return jeng.start(), teng.start()


def _both(engines, fn):
    """``fn(engine)`` on the JAX engine, then on the port's; each engine
    is stopped afterwards. Returns (JAX result, port result)."""
    out = []
    for eng in engines:
        try:
            out.append(fn(eng))
        finally:
            eng.stop()
    return out


def _prompt(seed, n):
    return [int(t) for t in np.random.default_rng(seed).integers(0, V, n)]


def _solo(nets, prompt, n, **kw):
    return generate_transformer(nets[1], prompt, n, V, **kw)


@pytest.mark.parametrize("kv", KV)
def test_seeded_sampling_through_a_prefix_hit(nets, kv):
    """test_paged_decode.py:86: the second request maps all 5 blocks of its
    40 tokens (39 positions restored, the last re-fed) and samples the
    same tokens."""
    prompt = _prompt(1, 40)
    kw = dict(temperature=0.8, top_k=5, top_p=0.9, seed=11)
    jeng, teng = _engines(nets, blocks=32, block=8, kv=kv, n_slots=2,
                          prefill_chunk=16)
    want, got = _both((jeng, teng), lambda e: [e.generate(prompt, 6, **kw)
                                               for _ in range(2)])
    assert got == want
    if kv is None:
        assert got[0] == got[1] == _solo(nets, prompt, 6, **kw)
    assert teng.pool.stats()["prefix"]["hits"] == 1
    assert teng.restored_tokens == 39 and teng.cow_copies == 1
    assert teng.pool.outstanding_refs() == 0


@pytest.mark.parametrize("kv", KV)
def test_full_block_hit_is_zero_copy_remap_with_cow_refeed(nets, kv):
    """test_paged_decode.py:126: a prompt of exactly 4 blocks, three times.
    Each repeat maps all 4 cached blocks into its table (31 positions
    restored, the last token re-fed), and the refeed's write copies the
    shared tail block first, so the cached original serves the third
    request intact. Publishing adopts pages: the repeats add none."""
    prompt = _prompt(2, 32)
    jeng, teng = _engines(nets, blocks=32, block=8, kv=kv, n_slots=2,
                          prefill_chunk=16)
    want, got = _both((jeng, teng), lambda e: [e.submit(prompt, 5).result(120)
                                               for _ in range(3)])
    assert got == want
    if kv is None:
        assert got == [_solo(nets, prompt, 5)] * 3
    assert teng.restored_tokens == 62
    assert teng.cow_copies == 2  # one per warm repeat
    prefix = teng.pool.stats()["prefix"]
    assert prefix["hits"] == 2 and prefix["hit_blocks"] == 8
    assert prefix["published_blocks"] == 4  # the cold run's, in place
    assert teng.pool.outstanding_refs() == 0


def test_publish_is_ownership_transfer_not_copy(nets):
    """test_paged_decode.py:159: at finish only the adopted prompt blocks
    stay live, and they are the very pages the JAX engine's trie holds
    (the same allocation order on both sides)."""
    prompt = _prompt(3, 24)  # 3 blocks
    jeng, teng = _engines(nets, blocks=16, block=8, n_slots=1,
                          prefill_chunk=16)
    want, got = _both((jeng, teng), lambda e: e.generate(prompt, 3))
    assert got == want == _solo(nets, prompt, 3)
    assert teng.pool.used_blocks == 3
    n, ids, node = teng.pool.match(prompt, 3)
    jn, jids, jnode = jeng.pool.match(prompt, 3)
    assert n == jn == 3 and ids == jids
    assert SCRATCH_BLOCK not in ids
    teng.pool.release(node)
    jeng.pool.release(jnode)
    assert teng.pool.outstanding_refs() == 0


@pytest.mark.parametrize("kv", KV)
@pytest.mark.parametrize("sampled", [False, True])
def test_preempt_and_resume_mid_decode(nets, kv, sampled):
    """test_paged_decode.py:183 and :223: each sequence needs 4 blocks of
    4 and the pool has 7, so the later one is swapped out mid-decode and
    resumed after the first finishes: its re-prefill recomputes its K/V
    and its host RNG is untouched, so the tokens are those of an
    unpreempted run."""
    rng = np.random.default_rng(4)
    p1, p2 = [[int(t) for t in rng.integers(0, V, 6)] for _ in range(2)]
    kw2 = dict(temperature=0.9, top_k=6, seed=7) if sampled else {}
    jeng, teng = _engines(nets, blocks=7, block=4, kv=kv, n_slots=2,
                          prefill_chunk=16)

    def run(e):
        h1 = e.submit(p1, 10)
        h2 = e.submit(p2, 10, **kw2)  # submitted second: the victim
        return [h1.result(120), h2.result(120)]
    want, got = _both((jeng, teng), run)
    assert got == want
    if kv is None:
        assert got == [_solo(nets, p1, 10), _solo(nets, p2, 10, **kw2)]
    assert teng.preemptions >= 1
    assert teng.pool.outstanding_refs() == 0


def test_admission_is_pool_bytes(nets):
    """test_paged_decode.py:247: a 48-token prompt decodes in an 8-block
    pool; one whose prompt plus new tokens exceeds the whole pool raises
    the typed error with the block math."""
    prompt = _prompt(6, 48)
    jeng, teng = _engines(nets, blocks=8, block=8, n_slots=1,
                          prefill_chunk=16)
    big = _prompt(7, 70)

    def run(e):
        toks = e.generate(prompt, 4)
        with pytest.raises(Exception) as ei:
            e.submit(big, 4)
        return toks, ei.value
    (want, jerr), (got, err) = _both((jeng, teng), run)
    assert got == want == _solo(nets, prompt, 4)
    assert isinstance(err, PromptTooLongError)
    assert (err.blocks_needed, err.blocks_available) == (10, 8) \
        == (jerr.blocks_needed, jerr.blocks_available)


@pytest.mark.parametrize("kv", KV)
def test_tiny_pool_admission_eviction_interleaving(nets, kv):
    """test_paged_decode.py:301: distinct prompts through a pool barely
    bigger than one sequence, twice: publishes evict earlier prefixes,
    admission gates on reclaimable blocks, slots swap."""
    rng = np.random.default_rng(8)
    prompts = [[int(t) for t in rng.integers(0, V, n)] for n in (20, 9, 26, 14)]
    jeng, teng = _engines(nets, blocks=9, block=4, kv=kv, n_slots=2,
                          prefill_chunk=16)

    def run(e):
        out = []
        for _ in range(2):
            hs = [e.submit(p, 4) for p in prompts]
            out.append([h.result(120) for h in hs])
            assert e.pool.used_blocks <= e.pool.capacity_blocks
        return out
    want, got = _both((jeng, teng), run)
    assert got == want
    if kv is None:
        assert got == [[_solo(nets, p, 4) for p in prompts]] * 2
    assert teng.pool.outstanding_refs() == 0
    assert teng.pool.stats()["prefix"]["evicted_blocks"] >= 1


def test_slot_release_returns_every_block(nets):
    """test_paged_decode.py:359: a request cancelled mid-prefill, while it
    pins a restored prefix, gives back its pin and every block it owns."""
    prompt = _prompt(10, 24)
    eng = DecodeScheduler(nets[1], V, n_slots=1, prefill_chunk=4, kv_block=8,
                          kv_pool_mb=_pool_mb(16, 8, None),
                          device="cpu").start()
    try:
        assert eng.generate(prompt, 2) == _solo(nets, prompt, 2)  # publish 3
        live_after_publish = eng.pool.used_blocks
        assert live_after_publish == 3
        h = eng.submit(prompt + _prompt(11, 80), 8)
        deadline = time.monotonic() + 30
        while eng.pool.outstanding_refs() == 0:
            assert time.monotonic() < deadline, "restore never pinned"
            time.sleep(0.002)
        h.cancel()
        while eng.pool.outstanding_refs() != 0 \
                or eng.pool.used_blocks != live_after_publish:
            assert time.monotonic() < deadline, "cancel leaked"
            time.sleep(0.005)
    finally:
        eng.stop()
    assert h.finish_reason == "cancelled"
    assert eng.pool.outstanding_refs() == 0
    assert (eng._table == SCRATCH_BLOCK).all()


@pytest.mark.parametrize("kv", KV)
def test_full_pool_full_prompt_hit_converges(nets, kv):
    """test_paged_decode.py:434: a 4-block prompt whose published blocks
    fill the whole 4-block pool, resubmitted: the full hit's refeed needs a
    COW page that cannot exist. The starved attempt is preempted once and
    resumes with a hit one block short, instead of spinning."""
    prompt = _prompt(13, 32)
    jeng, teng = _engines(nets, blocks=4, block=8, kv=kv, n_slots=1,
                          prefill_chunk=8)

    def run(e):
        first = e.generate(prompt, 1)
        assert e.pool.free_blocks == 0
        return [first, e.generate(prompt, 1)]
    want, got = _both((jeng, teng), run)
    assert got == want
    if kv is None:
        assert got == [_solo(nets, prompt, 1)] * 2
    assert teng.preemptions == 1
    assert teng.pool.outstanding_refs() == 0
