"""Port parity: the paged decode engine and the HTTP server.

The port's `DecodeScheduler(device="cpu")` and the JAX `DecodeScheduler`
(paged, ``paged_kernel="off"``: its gather body) serve the same net (the
JAX params carried over) on 3 prompts of 7, 23 and 40 tokens, 6 new
tokens each, greedy and seeded-sampled (temperature 0.8, top-k 5), with
fp32 and int8 KV pages. Tokens must be identical — sampling draws from a
per-request numpy RNG in both packages, so they agree wherever the
probabilities do. The port's engine is also held against its own solo
`generate_transformer`, and the server against the engine.
"""
import json
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.inference import DecodeScheduler as JEngine
from deeplearning4j_tpu.inference import MetricsRegistry
from deeplearning4j_tpu.models.zoo import transformer_lm as jlm
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu_torch.inference.engine import (DecodeScheduler,
                                                       PromptTooLongError)
from deeplearning4j_tpu_torch.models.sampling import generate_transformer
from deeplearning4j_tpu_torch.nn.conf.graph import \
    ComputationGraphConfiguration as TConf
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph as TGraph
from deeplearning4j_tpu_torch.ops import cuda_kernels as ck
from deeplearning4j_tpu_torch.serving.server import InferenceServer
from deeplearning4j_tpu_torch.util.model_serializer import params_from_jax

V = 13
BLOCK = 8
NEW = 6
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


@pytest.fixture(scope="module")
def nets():
    jnet = JGraph(jlm(vocab_size=V, d_model=16, n_heads=2, n_blocks=2,
                      rope=True)).init()
    tnet = TGraph(TConf.from_json(jnet.conf.to_json()), device="cpu").init()
    tnet.set_params(params_from_jax(
        {k: {n: np.asarray(a) for n, a in lp.items()}
         for k, lp in jnet.params.items()}))
    return jnet, tnet


@pytest.fixture(scope="module")
def prompts():
    rng = np.random.default_rng(0)
    return [[int(t) for t in rng.integers(0, V, n)] for n in (7, 23, 40)]


def _requests(prompts):
    """(prompt, kwargs) for every case: greedy, then seeded sampling."""
    return ([(p, {}) for p in prompts]
            + [(p, dict(SAMPLED, seed=11 + i)) for i, p in enumerate(prompts)])


def _serve(engine, prompts):
    engine.start()
    try:
        handles = [engine.submit(p, NEW, **kw) for p, kw in _requests(prompts)]
        return [h.result(timeout=300) for h in handles]
    finally:
        engine.stop()


def _run_pair(nets, prompts, kv):
    """Tokens of the JAX engine and the port engine for every request."""
    jnet, tnet = nets
    jeng = JEngine(jnet, V, n_slots=2, prefill_chunk=16, kv_block=BLOCK,
                   kv_pool_mb=_pool_mb(16, kv), kv_dtype=kv,
                   paged_kernel="off", metrics=MetricsRegistry())
    teng = DecodeScheduler(tnet, V, n_slots=2, prefill_chunk=16,
                           kv_block=BLOCK, kv_pool_mb=_pool_mb(16, kv),
                           kv_dtype=kv, device="cpu")
    assert teng.pool.capacity_blocks == jeng.pool.capacity_blocks == 16
    ck.reset_launches()
    got = _serve(teng, prompts)
    assert ck.LAUNCHES["paged_decode_attention"] == 0  # CPU: plain version
    assert teng.decode_steps > 0 and teng.prefill_chunks > 0
    assert teng.decode_seconds > 0 and teng.prefill_seconds > 0
    return _serve(jeng, prompts), got


@pytest.fixture(scope="module")
def fp32_outputs(nets, prompts):
    return _run_pair(nets, prompts, None)


@pytest.fixture(scope="module")
def int8_outputs(nets, prompts):
    return _run_pair(nets, prompts, "int8")


@pytest.mark.parametrize("kv", ["fp32", "int8"])
def test_engine_tokens_identical_to_jax(request, kv):
    want, got = request.getfixturevalue(f"{kv}_outputs")
    assert all(len(t) == NEW for t in got)
    assert got == want


def test_engine_tokens_identical_to_solo(nets, prompts, fp32_outputs):
    """fp32 KV only: int8 pages are lossy, in both packages."""
    _, tnet = nets
    _, got = fp32_outputs
    solo = [generate_transformer(tnet, p, NEW, V, **kw)
            for p, kw in _requests(prompts)]
    assert got[:3] == solo[:3]  # greedy
    assert got[3:] == solo[3:]  # seeded sampling


def test_engine_kernel_off_matches_on(nets, prompts):
    _, tnet = nets
    runs = [_serve(DecodeScheduler(tnet, V, n_slots=3, prefill_chunk=1,
                                   kv_block=BLOCK, kv_pool_mb=_pool_mb(24, None),
                                   paged_kernel=mode, device="cpu"), prompts)
            for mode in ("on", "off")]
    assert runs[0] == runs[1]


def test_engine_admission(nets):
    _, tnet = nets
    eng = DecodeScheduler(tnet, V, n_slots=2, kv_block=BLOCK,
                          kv_pool_mb=_pool_mb(4, None), device="cpu")
    with pytest.raises(PromptTooLongError) as e:
        eng.submit([1] * 30, 4)  # 33 positions > 4 blocks of 8
    assert e.value.blocks_needed == 5 and e.value.blocks_available == 4
    with pytest.raises(ValueError, match="out of range"):
        eng.submit([V], 1)
    # kv_pool_mb=0 is contiguous mode (per-slot stripes), as in JAX
    contiguous = DecodeScheduler(tnet, V, kv_pool_mb=0, device="cpu")
    assert not contiguous.paged and contiguous.pool is None
    # two requests of 3 blocks each cannot both hold the 4-block pool:
    # the second waits for the first instead of failing
    eng.start()
    try:
        hs = [eng.submit([1, 2, 3] * 6, 5), eng.submit([4, 5] * 9, 5)]
        assert [len(h.result(timeout=120)) for h in hs] == [5, 5]
        # the finished prompts' full blocks stay cached in the trie: no
        # pin is left, and every block is free or evictable
        pool = eng.pool
        assert pool.outstanding_refs() == 0
        assert pool.reclaimable_blocks() == pool.capacity_blocks
        assert pool.free_blocks + pool.stats()["trie"]["nodes"] \
            == pool.capacity_blocks
    finally:
        eng.stop()


def _post(port, path, body):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_server_generate(nets, prompts, fp32_outputs):
    _, tnet = nets
    _, got = fp32_outputs
    srv = InferenceServer(net=tnet, decode_slots=2, prefill_chunk=16,
                          kv_block=BLOCK, kv_pool_mb=_pool_mb(16, None),
                          device="cpu").start()
    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{srv.port}/healthz", timeout=30) as r:
            assert r.status == 200
        with urllib.request.urlopen(
                f"http://127.0.0.1:{srv.port}/info", timeout=30) as r:
            info = json.loads(r.read())
        assert info["device"]["type"] == "cpu"
        assert info["decode"]["pool"]["capacity_blocks"] == 16
        code, body = _post(srv.port, "/generate",
                           {"prompt": prompts[2], "max_new_tokens": NEW,
                            **SAMPLED, "seed": 13})
        assert code == 200 and body["finish_reason"] == "length"
        code2, body2 = _post(srv.port, "/generate",
                             {"prompt": prompts[0], "max_new_tokens": NEW})
        assert code2 == 200
        assert _post(srv.port, "/generate", {"prompt": [1] * 200})[0] == 413
        assert _post(srv.port, "/generate", {"max_new_tokens": 2})[0] == 400
    finally:
        srv.stop()
    assert body2["tokens"] == got[0]
    assert body["tokens"] == got[5]


def test_cli_serve_starts_on_a_jax_written_zip(nets, tmp_path, capsys):
    from deeplearning4j_tpu.util.model_serializer import write_model
    from deeplearning4j_tpu_torch.cli.main import main
    jnet, _ = nets
    path = tmp_path / "lm.zip"
    write_model(jnet, path)
    assert main(["serve", "--model", str(path), "--generate", "--kv-pool-mb",
                 str(_pool_mb(16, "int8")), "--kv-block", str(BLOCK),
                 "--kv-dtype", "int8", "--decode-slots", "2",
                 "--device", "cpu", "--once"]) == 0
    banner = capsys.readouterr().out
    assert "device cpu" in banner and "16 blocks of 8, int8 KV" in banner
    # without --generate the zip is served on /predict alone
    assert main(["serve", "--model", str(path), "--kv-pool-mb", "1",
                 "--device", "cpu", "--once"]) == 0
    banner = capsys.readouterr().out
    assert "POST /predict" in banner and "/generate" not in banner
