"""Port parity: the KV tiers under tensor parallelism (ROADMAP A7.2.2).

The round trip of tests/test_kvtier.py:252 (`test_tier_roundtrip_token_
identical_tp2`) on the port's `DecodeScheduler(mesh=..., host_cache_mb=
...)`: the driver (this process, rank 0) and a spawned follower on
``devices=["cpu"] * 2`` over gloo, one torch thread a rank, with the JAX
file's widths (V 13, d 32, 4 heads, 2 blocks, RoPE, kv_block 8).

The `TierManager`, its directory and ``/prefix/*`` stay on the driver and
hold whole blocks (every head), as the JAX host tier does after its
snapshot gathers the sharded pool: a spill is one command whose head
slices reach the driver through one all-gather a page group, and a
promotion one command whose rows reach every rank in one data broadcast,
each rank copying its head slice in place. So a block spilled at tp = 2
is encoded (`encode_block`) with the full head count, in the tp = 1
layout, and a tp = 1 engine serves from it. The per-token step keeps its
budget: the collectives run on the tier's path only.

Cases: fp32 and int8 pages (solo's tokens through a spill/promote round
trip, promotions > 0), a disk tier behind a small host ring, the
``tier.spill`` crash failpoint (a lost spill, never a lost token), and a
block fetched from the tp = 2 engine inserted into a tp = 1 engine and
served token-identically, and a tp = 2 server's ``/prefix/*`` endpoints
and `serve --tp 2 --host-cache-mb`. Every collective carries a 60 s timeout and
every wait a deadline; the fixture kills the follower at teardown.
"""
import time

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models.zoo import transformer_lm as jlm
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu_torch.inference import failpoints
from deeplearning4j_tpu_torch.inference import kvtier as tkv
from deeplearning4j_tpu_torch.inference import sharding as shd
from deeplearning4j_tpu_torch.inference.engine import DecodeScheduler
from deeplearning4j_tpu_torch.inference.metrics import MetricsRegistry
from deeplearning4j_tpu_torch.models.sampling import generate_transformer
from deeplearning4j_tpu_torch.nn.conf.graph import \
    ComputationGraphConfiguration as TConf
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph as TGraph
from deeplearning4j_tpu_torch.util.model_serializer import params_from_jax

V = 13
B = 8
N_BLOCKS = 2
TIMEOUT = 60.0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _disarm():
    yield
    failpoints.disarm()


@pytest.fixture(scope="module")
def tnet():
    conf = jlm(vocab_size=V, d_model=32, n_heads=4, n_blocks=N_BLOCKS,
               rope=True)
    for vert in conf.vertices.values():
        layer = getattr(vert, "layer", None)
        if layer is not None and hasattr(layer, "max_cache_len"):
            layer.max_cache_len = 96
    jnet = JGraph(conf).init()
    net = TGraph(TConf.from_json(jnet.conf.to_json()), device="cpu").init()
    net.set_params(params_from_jax(
        {k: {n: np.asarray(a) for n, a in lp.items()}
         for k, lp in jnet.params.items()}))
    return net


@pytest.fixture(scope="module")
def mesh2():
    m = shd.decode_mesh(2, ["cpu"] * 2, timeout=TIMEOUT).start()
    yield m
    m.kill()


@pytest.fixture(scope="module")
def waves(tnet):
    rng = np.random.default_rng(7)
    prompts = [[int(x) for x in rng.integers(0, V, 41)] for _ in range(3)]
    return prompts, [generate_transformer(tnet, p, 6, V, use_cache=True)
                     for p in prompts]


def _position_bytes(kv):
    """Bytes a position over every rank: 2 layers x (K, V) x 4 heads x
    (Dh 8 x f32, or Dh 8 x int8 + one f32 scale)."""
    return 2 * 2 * 4 * (8 + 4 if kv == "int8" else 8 * 4)


def _pool_mb(blocks, tp, kv=None):
    return (blocks + 1) * B * _position_bytes(kv) / tp / float(1 << 20)


def _engine(tnet, mesh, kv=None, blocks=12, **kw):
    tp = 1 if mesh is None else mesh.size
    kw.setdefault("host_cache_mb", 4.0)
    return DecodeScheduler(tnet, V, n_slots=2, prefill_chunk=16, kv_block=B,
                           kv_pool_mb=_pool_mb(blocks, tp, kv), kv_dtype=kv,
                           mesh=mesh, decode_graphs="off", device="cpu",
                           metrics=MetricsRegistry(), **kw)


def _settle(eng, timeout=20.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        st = eng.tier.stats()
        if not any(st["queues"].values()):
            return st
        time.sleep(0.01)
    raise AssertionError(f"tier never drained: {eng.tier.stats()}")


def _round_trip(eng, prompts):
    """All prompts at once (the pool evicts), then each alone, the tier
    settled between (JAX :252)."""
    out = [h.result(TIMEOUT) for h in [eng.submit(p, 6) for p in prompts]]
    _settle(eng)
    for p in prompts:
        out.append(eng.submit(p, 6).result(TIMEOUT))
        _settle(eng)
    return out


def _counter(eng, name):
    return eng.metrics.counter(name).value


@pytest.mark.parametrize("kv", [None, "int8"], ids=["fp32", "int8"])
def test_tier_roundtrip_token_identical_tp2(tnet, mesh2, waves, kv):
    """Spill and promote at tp 2: the tp = 1 tiered engine's tokens (and
    solo's, fp32), promotions > 0; the tier holds whole-head blocks; the
    decode step's budget is untouched."""
    prompts, solo = waves
    outs = {}
    for tp, mesh in ((1, None), (2, mesh2)):
        eng = _engine(tnet, mesh, kv)
        assert eng.tp == tp and eng.tier is not None
        if tp > 1:
            counts = shd.collective_counts(eng)
            shd.assert_hot_path_collectives(counts, N_BLOCKS)
            assert all(c["all_gather"] == 0 for c in counts)
        eng.start()
        try:
            outs[tp] = _round_trip(eng, prompts)
            assert _counter(eng, "kv_tier_promoted_blocks_total") > 0
            st = eng.tier.stats()
            assert st["host"]["blocks"] > 0
            # whole blocks: a block's bytes are every rank's pages
            assert st["host"]["bytes"] == st["host"]["blocks"] * B \
                * _position_bytes(kv)
        finally:
            eng.stop()
    assert outs[2] == outs[1]
    if kv is None:
        assert outs[2] == solo + solo


def test_tier_with_disk_at_tp2(tnet, mesh2, waves, tmp_path):
    """A host ring of a few blocks demotes to the disk tier; the round
    trip through the disk files at tp 2 gives solo's tokens."""
    prompts, solo = waves
    eng = _engine(tnet, mesh2, host_cache_mb=4 * B * _position_bytes(None)
                  / float(1 << 20), disk_cache_mb=1.0,
                  tier_dir=str(tmp_path / "tier")).start()
    try:
        assert _round_trip(eng, prompts) == solo + solo
        st = eng.tier.stats()
        assert st["disk"]["blocks"] > 0
        assert _counter(eng, "kv_tier_promoted_blocks_total") > 0
    finally:
        eng.stop()
    assert list((tmp_path / "tier").glob("*" + tkv.BLOCK_SUFFIX))


def test_spill_fault_under_tp_loses_the_spill_not_a_token(tnet, mesh2,
                                                          waves):
    """``tier.spill`` armed to crash at tp 2: every eviction drops its
    block (counted), no command is sent for it, and the repeats prefill
    cold with solo's tokens (JAX test_kvtier.py:283)."""
    prompts, solo = waves
    eng = _engine(tnet, mesh2)
    failpoints.arm("tier.spill", "crash@always")
    eng.start()
    try:
        assert _round_trip(eng, prompts) == solo + solo
        assert _counter(eng, "kv_tier_spill_dropped_total") > 0
        assert _counter(eng, "kv_tier_promoted_blocks_total") == 0
        assert eng.tier.stats()["host"]["blocks"] == 0
    finally:
        failpoints.disarm()
        eng.stop()


def test_tp2_block_served_by_a_tp1_engine(tnet, mesh2, waves):
    """A prompt's blocks, fetched from the tp = 2 engine's tier (spilled
    ones from the host ring, resident ones through a copydown, each one
    all-gather), decode to the full head count and, inserted into a tp = 1
    engine's tier and promoted there, serve solo's tokens."""
    prompts, solo = waves
    prompt = prompts[0]
    chain = tkv.prompt_chain(prompt, B)
    src = _engine(tnet, mesh2).start()
    try:
        assert src.submit(prompt, 6).result(TIMEOUT) == solo[0]
        _settle(src)
        payloads = [src.tier.get_block_payload(h, timeout=TIMEOUT)
                    for h in chain]
    finally:
        src.stop()
    assert all(p is not None for p in payloads)
    for p in payloads:
        meta, pages = tkv.decode_block(p)
        for lk, pks in pages.items():
            assert tuple(pks["k_pages"].shape) == (B, 4, 8), lk
    dst = _engine(tnet, None).start()
    try:
        assert [dst.tier.insert_fetched(p) for p in payloads] == chain
        dst.tier.request_restore(chain)
        deadline = time.monotonic() + TIMEOUT
        while _counter(dst, "kv_tier_promoted_blocks_total") < len(chain):
            assert time.monotonic() < deadline, dst.tier.stats()
            time.sleep(0.01)
        pre = _counter(dst, "prefill_tokens_total")
        assert dst.submit(prompt, 6).result(TIMEOUT) == solo[0]
        assert _counter(dst, "prefill_tokens_total") - pre \
            <= len(prompt) - len(chain) * B + 1
    finally:
        dst.stop()


def test_prefix_endpoints_of_a_tp2_server(tnet, waves, tmp_path, capsys):
    """A tp = 2 server with a host tier answers `/prefix/directory` and
    `/prefix/block` from the driver: the chain of a served prompt, each
    block with every head; `serve --tp 2 --decode-graphs off
    --host-cache-mb` is accepted and names the tier and the mesh."""
    import json
    import urllib.request
    from deeplearning4j_tpu_torch.cli import main as tcli
    from deeplearning4j_tpu_torch.serving.server import InferenceServer
    from deeplearning4j_tpu_torch.util.model_serializer import write_model
    prompts, solo = waves

    def get(port, path):
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=TIMEOUT) as r:
            return r.read()

    srv = InferenceServer(net=tnet, decode_vocab=V, decode_slots=2,
                          prefill_chunk=16, kv_block=B,
                          kv_pool_mb=_pool_mb(12, 2), host_cache_mb=4.0,
                          decode_tp=2, decode_graphs="off", supervise=False,
                          device="cpu").start()
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.port}/generate",
            data=json.dumps({"prompt": prompts[0],
                             "max_new_tokens": 6}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
            assert json.loads(r.read())["tokens"] == solo[0]
        assert srv.decoder.tp == 2
        feed = json.loads(get(srv.port, "/prefix/directory?since=0"))
        hashes = {e["hash"] for e in feed["events"]}
        chain = tkv.prompt_chain(prompts[0], B)
        assert set(chain) <= hashes
        meta, pages = tkv.decode_block(
            get(srv.port, f"/prefix/block?hash={chain[-1]}"))
        assert meta["hash"] == chain[-1]
        assert {tuple(pks["k_pages"].shape) for pks in pages.values()} == {
            (B, 4, 8)}
    finally:
        srv.stop()
    zp = str(tmp_path / "lm.zip")
    write_model(tnet, zp)
    rc = tcli.main(["serve", "--model", zp, "--generate", "--device", "cpu",
                    "--kv-pool-mb", "0.2", "--kv-block", "8", "--once",
                    "--no-supervise", "--tp", "2", "--decode-graphs", "off",
                    "--host-cache-mb", "4"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "host tier 4" in out and "tensor-parallel over 2 ranks" in out
