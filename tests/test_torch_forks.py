"""Port parity: best-of-n fork groups — `DecodeScheduler.generate_many`,
`speculative.ForkGroup` and ``/generate`` with ``n > 1``.

The cases of tests/test_speculative.py:281-372 on the port's
`DecodeScheduler(device="cpu")`: in paged mode n candidates share the
primary's prompt blocks (the followers wait in the queue until the
primary's prefill publishes them, then restore them as table remaps);
candidate 0 is the n = 1 output, and candidate i the output of seed + i;
every exit path (finish, cancel, preempt) returns every trie reference.
The candidates' tokens are also held against the JAX package's
`generate_many` on the same params.
"""
import json
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.inference import DecodeScheduler as JEngine
from deeplearning4j_tpu.models.zoo import transformer_lm as jlm
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu_torch.inference.engine import DecodeScheduler
from deeplearning4j_tpu_torch.inference.metrics import MetricsRegistry
from deeplearning4j_tpu_torch.inference.speculative import (
    ForkGroup, await_fork_group, submit_fork_group)
from deeplearning4j_tpu_torch.models.sampling import generate_transformer
from deeplearning4j_tpu_torch.nn.conf.graph import \
    ComputationGraphConfiguration as TConf
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph as TGraph
from deeplearning4j_tpu_torch.serving.server import InferenceServer
from deeplearning4j_tpu_torch.util.model_serializer import params_from_jax

V = 29


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tier-1 runs several test files at once on a few cores; one torch
    intra-op thread keeps this file from starving the others' timings."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_NETS = []


def _nets():
    """(JAX LM, port LM) on the JAX params: the JAX suite's `_lm` (V 29,
    d 32, 2 heads, 2 blocks, RoPE, max_cache_len 128)."""
    if not _NETS:
        conf = jlm(vocab_size=V, d_model=32, n_heads=2, n_blocks=2,
                   rope=True, seed=7)
        for vert in conf.vertices.values():
            layer = getattr(vert, "layer", None)
            if layer is not None and hasattr(layer, "max_cache_len"):
                layer.max_cache_len = 128
        jnet = JGraph(conf).init()
        tnet = TGraph(TConf.from_json(jnet.conf.to_json()),
                      device="cpu").init()
        tnet.set_params(params_from_jax(
            {k: {n: np.asarray(a) for n, a in lp.items()}
             for k, lp in jnet.params.items()}))
        _NETS.append((jnet, tnet))
    return _NETS[0]


def _fork_engine(n_slots=4, pool_mb=4.0, **kw):
    m = MetricsRegistry()
    eng = DecodeScheduler(_nets()[1], V, n_slots=n_slots, prefill_chunk=16,
                          kv_pool_mb=pool_mb, kv_block=4, metrics=m,
                          device="cpu", **kw).start()
    return eng, m


def test_fork_candidates_share_prompt_blocks():
    """n = 4 forked candidates hold far fewer live blocks than 4
    independent submissions of the same prompt; candidate 0 reproduces
    the n = 1 output, and every candidate the JAX engine's."""
    p = [int(t) for t in np.random.default_rng(9).integers(0, V, 32)]
    eng, m = _fork_engine()
    try:
        handles = eng.generate_many(p, 4, 6, timeout=600, temperature=0.8,
                                    seed=40)
        forked_peak = m.gauge("kv_pool_blocks_live").max
        assert m.counter("decode_forks_total").value >= 3
        assert eng.forks >= 3
        solo_c0 = eng.generate(p, 6, timeout=600, temperature=0.8, seed=40)
        assert handles[0].tokens == solo_c0
    finally:
        eng.stop()
    assert eng.pool.outstanding_refs() == 0
    eng2, m2 = _fork_engine()
    try:
        hs = [eng2.submit(p, 6, temperature=0.8, seed=40 + i)
              for i in range(4)]
        indep = [h.result(600) for h in hs]
        indep_peak = m2.gauge("kv_pool_blocks_live").max
    finally:
        eng2.stop()
    assert [h.tokens for h in handles] == indep
    assert forked_peak <= 0.6 * indep_peak, (forked_peak, indep_peak)
    jeng = JEngine(_nets()[0], V, n_slots=4, prefill_chunk=16,
                   kv_pool_mb=4.0, kv_block=4).start()
    try:
        jh = jeng.generate_many(p, 4, 6, timeout=600, temperature=0.8,
                                seed=40)
    finally:
        jeng.stop()
    assert [h.tokens for h in handles] == [h.tokens for h in jh]


def test_fork_candidate_zero_is_solo_generate():
    p = [int(t) for t in np.random.default_rng(11).integers(0, V, 21)]
    eng, _ = _fork_engine(n_slots=2)
    try:
        hs = eng.generate_many(p, 3, 8, timeout=600)
    finally:
        eng.stop()
    solo = generate_transformer(_nets()[1], p, 8, V, use_cache=True)
    assert all(h.tokens == solo for h in hs)  # greedy: all equal
    assert eng.pool.outstanding_refs() == 0


def test_fork_refcount_release_on_cancel_finish_preempt():
    """Every exit path of a forked candidate — finish, cancel, preempt —
    releases its trie pin and owned blocks."""
    p = [int(t) for t in np.random.default_rng(10).integers(0, V, 16)]
    eng, m = _fork_engine()
    try:
        group = ForkGroup(3)
        hs = [eng.submit(p, 12, temperature=0.7, seed=60 + i, fork=group)
              for i in range(3)]
        while hs[0].t_first_token is None and not hs[0].done():
            time.sleep(0.005)
        hs[2].cancel()
        for h in hs[:2]:
            h.result(600)
        deadline = time.monotonic() + 10
        while not hs[2].done() and time.monotonic() < deadline:
            time.sleep(0.01)
        assert hs[2].done()
    finally:
        eng.stop()
    assert eng.pool.outstanding_refs() == 0
    # preempt: a pool small enough that decode growth preempts forked
    # candidates, which resume and finish token-identically
    want = [generate_transformer(_nets()[1], p, 10, V, temperature=0.7,
                                 seed=70 + i) for i in range(3)]
    bpb = DecodeScheduler(_nets()[1], V, kv_pool_mb=1.0, kv_block=4,
                          device="cpu").pool.bytes_per_block
    # 10 usable blocks of 4: three candidates of 16 + 10 positions need
    # 7 each, and share the 4 prompt blocks
    eng3, _ = _fork_engine(pool_mb=11 * bpb / (1 << 20))
    try:
        hs = eng3.generate_many(p, 3, 10, timeout=600, temperature=0.7,
                                seed=70)
        assert [h.tokens for h in hs] == want
        assert eng3.preemptions > 0
    finally:
        eng3.stop()
    assert eng3.pool.outstanding_refs() == 0


def test_follower_waits_for_primary_publish_then_remaps():
    """Paged: a follower is held in the queue while its primary
    prefills; once the primary publishes, the follower restores the
    prompt's full blocks and feeds only its last token."""
    p = [int(t) for t in np.random.default_rng(13).integers(0, V, 40)]
    eng, m = _fork_engine(n_slots=4)
    try:
        eng.reset_counters()
        hs = eng.generate_many(p, 2, 4, timeout=600)
        # the primary ran the prompt (3 chunks of <= 16); the follower
        # restored 40 // 4 = 10 blocks and fed only the last token (a
        # one-token chunk, whose write copies the last shared block)
        assert eng.prefill_chunks == 4
        assert eng.restored_tokens == 39
        assert eng.cow_copies == 1
        assert hs[0].tokens == hs[1].tokens
    finally:
        eng.stop()


def test_submit_fork_group_cancels_on_partial_failure():
    class Boom(Exception):
        pass

    made = []

    class H:
        def __init__(self):
            self.cancelled = False

        def cancel(self):
            self.cancelled = True

    def submit(prompt, n, **kw):
        if len(made) == 2:
            raise Boom()
        made.append((H(), kw))
        return made[-1][0]

    with pytest.raises(Boom):
        submit_fork_group(submit, [1, 2], 4, 3, seed=7, request_id="x")
    assert [kw["seed"] for _, kw in made] == [7, 8]
    assert [kw["request_id"] for _, kw in made] == ["x.c0", "x.c1"]
    assert all(h.cancelled for h, _ in made)


def test_await_fork_group_timeout_cancels_unfinished():
    class H:
        def __init__(self, done):
            self._d = done
            self.cancelled = False

        def result(self, timeout):
            if not self._d:
                raise TimeoutError()

        def done(self):
            return self._d

        def cancel(self):
            self.cancelled = True

    hs = [H(True), H(False), H(False)]
    with pytest.raises(TimeoutError):
        await_fork_group(hs, 0.01)
    assert [h.cancelled for h in hs] == [False, True, True]


def test_fork_group_under_speculation_gives_the_same_candidates():
    """Best-of-n on a speculating paged engine: the followers still attach
    to the primary's published blocks, and every candidate's tokens are
    the unspeculated engine's (the unarmed fallbacks are held in
    tests/test_torch_speculative.py)."""
    p = [int(t) for t in np.random.default_rng(13).integers(0, V, 24)]
    out = []
    for spec in (0, 2):
        eng, _ = _fork_engine(speculate=spec)
        try:
            hs = eng.generate_many(p, 3, 8, timeout=600, temperature=0.8,
                                   seed=20)
        finally:
            eng.stop()
        assert eng.speculate == spec and eng.forks >= 2
        assert eng.pool.outstanding_refs() == 0
        out.append([h.tokens for h in hs])
    assert out[0] == out[1]


@pytest.mark.parametrize("paged", [False, True])
def test_generate_n_over_http(paged):
    """/generate with n > 1: candidates in the response, the n = 1
    ``tokens`` surface, candidate 0 the n = 1 output, supervised
    tracking released afterwards; over the cap -> 400."""
    srv = InferenceServer(net=_nets()[1], decode_vocab=V, decode_slots=4,
                          prefill_chunk=16, kv_block=4,
                          kv_pool_mb=4.0 if paged else 0.0,
                          device="cpu").start()
    try:
        p = [int(t) for t in np.random.default_rng(12).integers(0, V, 20)]

        def post(body):
            req = urllib.request.Request(
                f"http://127.0.0.1:{srv.port}/generate",
                data=json.dumps(body).encode(),
                headers={"Content-Type": "application/json"})
            return json.loads(urllib.request.urlopen(req,
                                                      timeout=120).read())
        out = post({"prompt": p, "max_new_tokens": 6, "n": 3,
                    "temperature": 0.8, "seed": 5})
        assert out["n"] == 3 and len(out["candidates"]) == 3
        assert out["tokens"] == out["candidates"][0]["tokens"]
        assert all(len(c["tokens"]) == 6 for c in out["candidates"])
        assert len({c["request_id"] for c in out["candidates"]}) == 3
        assert not srv.supervisor._tracked
        one = post({"prompt": p, "max_new_tokens": 6, "temperature": 0.8,
                    "seed": 5})
        assert one["tokens"] == out["tokens"]
        for i, c in enumerate(out["candidates"]):
            assert c["tokens"] == generate_transformer(
                _nets()[1], p, 6, V, temperature=0.8, seed=5 + i)
        if paged:
            assert srv.decoder.forks >= 2
            assert srv.decoder.pool.outstanding_refs() == 0
        with pytest.raises(urllib.error.HTTPError) as ei:
            post({"prompt": p, "max_new_tokens": 2, "n": 17})
        assert ei.value.code == 400
        assert "candidate cap" in json.loads(ei.value.read())["error"]
    finally:
        srv.stop()
