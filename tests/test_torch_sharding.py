"""Port parity: tensor-parallel decode over process-group meshes.

The cases of tests/test_sharded_decode.py (:68, :94, :118, :136, :159,
:235, :253, :282, :298, :309, :321, :345, :377) and the spec plan of
tests/test_tensor_parallel.py (:40), on the port's `DecodeScheduler(
mesh=...)`: the driver (this process, rank 0) and spawned follower ranks
on ``devices=["cpu"] * n`` over gloo, one torch thread a rank. Tokens at
tp = 2 and 4 must equal the port's tp = 1 engine, solo
`generate_transformer(use_cache=True)` and, at tp = 2, the JAX
`DecodeScheduler(mesh=2)` on the same weights (`params_from_jax`), with
the JAX file's widths (V 13, d 32, 4 heads, 2 blocks, RoPE). Greedy
ties would be broken by the summation order of the row-split partial
products (each rank's share, then the all-reduce): the logits of the two
orders agree to float32 rounding (about 1e-6 relative), and no case here
sits on a tie.

Two meshes serve the whole module (module-scoped fixtures); every
collective carries the meshes' 60 s timeout and every wait a deadline, so
a hung rank fails a test instead of the run, and the fixtures kill the
followers at teardown.
"""
import json
import os
import signal
import subprocess
import sys
import time
import urllib.request

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.inference import DecodeScheduler as JEngine
from deeplearning4j_tpu.inference import MetricsRegistry as JRegistry
from deeplearning4j_tpu.inference import sharding as jshd
from deeplearning4j_tpu.models.zoo import transformer_lm as jlm
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.parallel.tensor_parallel import \
    _tp_specs_for_graph as j_tp_specs
from deeplearning4j_tpu_torch.inference import logitproc as tlp
from deeplearning4j_tpu_torch.inference import sharding as shd
from deeplearning4j_tpu_torch.inference.engine import DecodeScheduler
from deeplearning4j_tpu_torch.inference.metrics import MetricsRegistry
from deeplearning4j_tpu_torch.models.sampling import generate_transformer
from deeplearning4j_tpu_torch.nn.conf.graph import \
    ComputationGraphConfiguration as TConf
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph as TGraph
from deeplearning4j_tpu_torch.parallel import mesh as tmesh
from deeplearning4j_tpu_torch.parallel.tensor_parallel import \
    _tp_specs_for_graph as t_tp_specs
from deeplearning4j_tpu_torch.util.model_serializer import params_from_jax

V = 13
N_BLOCKS = 2
TIMEOUT = 60.0
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jconf(n_heads=4, n_kv_heads=None, cache=96):
    conf = jlm(vocab_size=V, d_model=32, n_heads=n_heads, n_blocks=N_BLOCKS,
               rope=True, n_kv_heads=n_kv_heads)
    for vert in conf.vertices.values():
        layer = getattr(vert, "layer", None)
        if layer is not None and hasattr(layer, "max_cache_len"):
            layer.max_cache_len = cache
    return conf


_NETS = {}


def _nets(n_heads=4, n_kv_heads=None):
    """(JAX net, port net on the CPU with the JAX weights)."""
    key = (n_heads, n_kv_heads)
    if key not in _NETS:
        jnet = JGraph(_jconf(n_heads, n_kv_heads)).init()
        tnet = TGraph(TConf.from_json(jnet.conf.to_json()),
                      device="cpu").init()
        tnet.set_params(params_from_jax(
            {k: {n: np.asarray(a) for n, a in lp.items()}
             for k, lp in jnet.params.items()}))
        _NETS[key] = (jnet, tnet)
    return _NETS[key]


def _pool_mb(blocks, block, tp=1):
    """PER-RANK MiB buying exactly ``blocks`` usable blocks (+1 scratch)
    on a ``tp``-rank mesh: 2 layers x (k+v) x Hkv 4 x Dh 8 x f32 = 512
    bytes a position in all, 512/tp on each rank."""
    return (blocks + 1) * block * 512 / tp / float(1 << 20)


@pytest.fixture(scope="module")
def mesh2():
    m = shd.decode_mesh(2, ["cpu"] * 2, timeout=TIMEOUT).start()
    yield m
    m.kill()


@pytest.fixture(scope="module")
def mesh4():
    m = shd.decode_mesh(4, ["cpu"] * 4, timeout=TIMEOUT).start()
    yield m
    m.kill()


@pytest.fixture(scope="module")
def solo():
    _, tnet = _nets()
    rng = np.random.default_rng(0)
    prompts = [[int(t) for t in rng.integers(0, V, n)]
               for n in (7, 23, 40, 61)]
    outs = [generate_transformer(tnet, p, 6, V, use_cache=True)
            for p in prompts]
    return prompts, outs


def _engine(tnet, mesh, **kw):
    kw.setdefault("n_slots", 4)
    kw.setdefault("prefill_chunk", 16)
    kw.setdefault("kv_block", 8)
    kw.setdefault("metrics", MetricsRegistry())
    return DecodeScheduler(tnet, V, mesh=mesh, decode_graphs="off",
                           device="cpu", **kw)


def _serve(eng, prompts, n, **kw):
    eng.start()
    try:
        return [h.result(TIMEOUT) for h in
                [eng.submit(p, n, **kw) for p in prompts]]
    finally:
        eng.stop()


# ------------------------------------------------------------ the plan --
@pytest.mark.parametrize("kv", [None, 2], ids=["mha", "gqa"])
def test_spec_plan_equals_jax(kv):
    """`_tp_specs_for_graph` and `decode_param_specs` equal JAX's
    PartitionSpecs entry by entry (the training plan column-splits the
    activated Dense layers, decode keeps the output head replicated)."""
    jconf = _jconf(n_kv_heads=kv)
    tconf = TConf.from_json(jconf.to_json())
    for jfn, tfn in ((j_tp_specs, t_tp_specs),
                     (jshd.decode_param_specs, shd.decode_param_specs)):
        js = jfn(jconf, "tp")
        ts = tfn(tconf, "tp")
        assert set(js) == set(ts)
        for name, vs in js.items():
            assert set(vs) == set(ts[name]), name
            for pname, spec in vs.items():
                assert tuple(spec) == ts[name][pname], (name, pname)
    ts = shd.decode_param_specs(tconf)
    assert ts["attn0"]["Wq"] == (None, "tp") and ts["attn0"]["Wo"] == \
        ("tp", None)
    assert ts["ff0"] == {"W": (None, "tp"), "b": ("tp",)}
    assert ts["ff0o"] == {"W": ("tp", None), "b": ()}
    assert ts["embed"] == {} and ts["out"] == {}


@pytest.mark.parametrize("kv", [None, 2], ids=["mha", "gqa"])
def test_shards_concatenate_to_the_params_and_leave_the_net(kv):
    """Every rank's slices, concatenated along the split dim, give back
    the full parameters; replicated ones are whole on every rank; the net
    is untouched (JAX :321: GQA's heads shard too)."""
    _, tnet = _nets(n_kv_heads=kv)
    before = {n: {k: v.clone() for k, v in lp.items()}
              for n, lp in tnet.params.items()}
    specs = shd.decode_param_specs(tnet.conf)
    shards = [shd.shard_decode_params(tnet, 2, r)[0] for r in range(2)]
    for name, lp in tnet.params.items():
        for pname, full in lp.items():
            spec = specs.get(name, {}).get(pname, ())
            parts = [s[name][pname] for s in shards]
            dims = [d for d, ax in enumerate(spec) if ax is not None]
            if dims:
                assert parts[0].shape[dims[0]] * 2 == full.shape[dims[0]]
                torch.testing.assert_close(torch.cat(parts, dims[0]), full,
                                           rtol=0, atol=0)
            else:
                for p in parts:
                    torch.testing.assert_close(p, full, rtol=0, atol=0)
            assert parts[0].data_ptr() != full.data_ptr()
            torch.testing.assert_close(full, before[name][pname], rtol=0,
                                       atol=0)
    if kv == 2:
        assert shards[0]["attn0"]["Wk"].shape == (32, 8)  # 1 kv head


def test_indivisible_dim_warns_and_replicates():
    """tp = 3 divides no split dim of the d 32 net: each warns and
    replicates (JAX :101-112)."""
    _, tnet = _nets()
    with pytest.warns(UserWarning, match="not divisible by mesh axis"):
        params, _ = shd.shard_decode_params(tnet, 3, 1)
    assert params["attn0"]["Wq"].shape == tnet.params["attn0"]["Wq"].shape


def test_backend_rule_and_device_refusal():
    assert tmesh.backend_for(["cpu", "cpu"]) == "gloo"
    assert tmesh.backend_for(["cuda:0", "cuda:0"]) == "gloo"
    assert tmesh.backend_for(["cuda:0", "cuda:1"]) == "nccl"
    assert tmesh.backend_for(["cuda:0", "cpu"]) == "gloo"
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(ValueError, match="CUDA card"):
        shd.decode_mesh(cards + 1)
    with pytest.raises(ValueError, match="CUDA card"):
        tmesh.ProcessMesh(2, [f"cuda:{cards}"] * 2)
    with pytest.raises(ValueError, match="2 devices"):
        tmesh.ProcessMesh(2, ["cpu"])


def test_state_specs_split_the_head_axis():
    st = {"attn0": {"k_pages": 0, "v_pages": 0, "k_scales": 0,
                    "v_scales": 0},
          "lstm": {"h": 0, "c": 0}}
    specs = shd.state_shardings(st)
    assert specs["attn0"]["k_scales"] == (None, None, "tp")
    assert specs["lstm"] == {"h": (), "c": ()}
    assert shd.storage_shardings({"a": {"k": 0, "v": 0}}) == {
        "a": {"k": (None, None, "tp"), "v": (None, None, "tp")}}
    assert shd.kv_heads_shardable({"a": 4, "b": 2}, 2)
    assert not shd.kv_heads_shardable({"a": 4, "b": 2}, 4)


# ------------------------------------------------------ token identity --
def test_paged_greedy_identical_across_mesh_sizes(solo, mesh2, mesh4):
    """Paged greedy, mixed prompt lengths: tp = 1, 2 and 4 give solo's
    tokens; at a fixed per-rank budget the capacity is rank-invariant;
    tp = 2 equals JAX's DecodeScheduler(mesh=2) too (JAX :68)."""
    prompts, expect = solo
    jnet, tnet = _nets()
    for tp, mesh in ((1, None), (2, mesh2), (4, mesh4)):
        eng = _engine(tnet, mesh, kv_pool_mb=_pool_mb(32, 8, tp))
        assert eng.tp == tp and eng.paged
        assert eng.pool.capacity_blocks == 32
        assert _serve(eng, prompts, 6) == expect, f"tp={tp}"
        assert eng.pool.outstanding_refs() == 0
    jeng = JEngine(jnet, V, n_slots=4, prefill_chunk=16,
                   kv_pool_mb=_pool_mb(32, 8, 2), kv_block=8, mesh=2,
                   metrics=JRegistry()).start()
    try:
        jouts = [h.result(120) for h in
                 [jeng.submit(p, 6) for p in prompts]]
    finally:
        jeng.stop()
    assert jeng.tp == 2
    assert jouts == expect


def test_seeded_sampling_prefix_restore_and_cow(mesh2):
    """Seeded sampling at tp = 2 through a cold run, a prefix-restored
    repeat and a full-prompt hit whose refeed copies the shared block
    (COW, mirrored on every rank): solo's tokens each time (JAX :94)."""
    _, tnet = _nets()
    rng = np.random.default_rng(1)
    prompt = [int(t) for t in rng.integers(0, V, 40)]  # 5 full blocks
    kw = dict(temperature=0.8, top_k=5, top_p=0.9, seed=11)
    ref = generate_transformer(tnet, prompt, 6, V, use_cache=True, **kw)
    m = MetricsRegistry()
    eng = _engine(tnet, mesh2, n_slots=2, kv_pool_mb=_pool_mb(32, 8, 2),
                  metrics=m).start()
    try:
        assert eng.generate(prompt, 6, timeout=TIMEOUT, **kw) == ref
        assert eng.generate(prompt, 6, timeout=TIMEOUT, **kw) == ref
        assert m.counter("prefix_cache_hits_total").value >= 1
        assert eng.cow_copies >= 1
    finally:
        eng.stop()


def test_contiguous_with_side_prefix_pool(solo, mesh2):
    """Contiguous stripes and the side pool split by head: a cold run and
    a gather-restored repeat (restore and publish mirrored) give solo's
    tokens (JAX :118)."""
    prompts, expect = solo
    _, tnet = _nets()
    m = MetricsRegistry()
    eng = _engine(tnet, mesh2, n_slots=2,
                  prefix_cache_mb=_pool_mb(32, 8, 2), metrics=m)
    assert eng.tp == 2 and not eng.paged and eng.pool is not None
    assert eng.pool.storage["attn0"]["k"].shape[2] == 2  # 2 of 4 heads
    eng.start()
    try:
        assert eng.generate(prompts[2], 6, timeout=TIMEOUT) == expect[2]
        assert eng.generate(prompts[2], 6, timeout=TIMEOUT) == expect[2]
        assert m.counter("prefix_cache_hits_total").value >= 1
    finally:
        eng.stop()


def test_preemption_under_pool_pressure(mesh2):
    """A tp = 2 pool that decode growth overflows preempts and resumes
    token-identically (JAX :136)."""
    _, tnet = _nets()
    rng = np.random.default_rng(3)
    prompts = [[int(t) for t in rng.integers(0, V, 6)] for _ in range(2)]
    expect = [generate_transformer(tnet, p, 20, V, use_cache=True)
              for p in prompts]
    m = MetricsRegistry()
    eng = _engine(tnet, mesh2, n_slots=2, kv_pool_mb=_pool_mb(6, 8, 2),
                  metrics=m)
    assert _serve(eng, prompts, 20) == expect
    assert m.counter("decode_preempted_total").value >= 1


def test_admission_gate_reserves_resident_prefill_claims(mesh2):
    """The paged admission gate at tp = 2: a mix whose joint block need
    overflows the pool serializes through admission with no preemption
    (JAX :159)."""
    _, tnet = _nets()
    rng = np.random.default_rng(7)
    prompts = [[int(t) for t in rng.integers(0, V, 64)] for _ in range(8)]
    expect = [generate_transformer(tnet, p, 4, V, use_cache=True)
              for p in prompts]
    m = MetricsRegistry()
    eng = _engine(tnet, mesh2, n_slots=8, kv_pool_mb=_pool_mb(19, 8, 2),
                  metrics=m)
    assert _serve(eng, prompts, 4) == expect
    assert m.counter("decode_preempted_total").value == 0
    assert m.gauge("decode_active_slots").max <= 3


def test_int8_pages_identical_to_one_rank(solo, mesh2):
    """int8 pages with their scale pages split by head: tp = 2 gives the
    tp = 1 int8 engine's tokens (the per-(position, head) scales do not
    cross heads)."""
    prompts, _ = solo
    _, tnet = _nets()
    outs = {}
    for tp, mesh in ((1, None), (2, mesh2)):
        eng = _engine(tnet, mesh, kv_pool_mb=_pool_mb(32, 8, tp),
                      kv_dtype="int8")
        assert eng.kv_dtype == "int8"
        outs[tp] = _serve(eng, prompts, 6)
    assert outs[2] == outs[1]


def test_grammar_masked_request(solo, mesh2):
    """A trie grammar (its rows uploaded into every rank's mask table, the
    masked step's variant) at tp = 2: the tp = 1 engine's tokens and
    finish reason."""
    prompts, _ = solo
    _, tnet = _nets()
    trie = tlp.compile_trie([[3, 1, 4], [3, 1, 5, 9]], V)
    res = {}
    for tp, mesh in ((1, None), (2, mesh2)):
        eng = _engine(tnet, mesh, kv_pool_mb=_pool_mb(32, 8, tp)).start()
        try:
            h = eng.submit(prompts[1], 6, grammar=trie)
            res[tp] = (h.result(TIMEOUT), h.finish_reason,
                       eng.masked_steps > 0)
        finally:
            eng.stop()
    assert res[2] == res[1]
    assert res[2][1] == "grammar" and res[2][2]


# -------------------------------------------------- collective budget --
def test_decode_step_collective_budget(mesh2, mesh4):
    """One decode step (paged kernel on) calls exactly 2 all-reduces a
    transformer block on every rank, one command broadcast and nothing
    else (JAX :235)."""
    _, tnet = _nets()
    for mesh in (mesh2, mesh4):
        tp = mesh.size
        eng = _engine(tnet, mesh, kv_pool_mb=_pool_mb(32, 8, tp))
        try:
            counts = shd.collective_counts(eng)
        finally:
            eng.stop()
        assert len(counts) == tp
        for c in counts:
            assert c == {"all_reduce": 2 * N_BLOCKS, "all_gather": 0,
                         "broadcast_command": 1, "broadcast_data": 0}, c
        shd.assert_hot_path_collectives(counts, N_BLOCKS)
    one = _engine(tnet, None, kv_pool_mb=_pool_mb(32, 8))
    assert shd.collective_counts(one) == [
        dict.fromkeys(tmesh.COLLECTIVE_KINDS, 0)]


def test_wrong_plan_trips_the_audit(solo, mesh2, monkeypatch):
    """A plan made wrong on purpose — the embedding split by column, its
    consumers (a LayerNorm, a residual add) not row-split — gathers its
    output back every step: the audit raises on the all-gather (JAX
    :253). The tokens stay right (the gather is exact)."""
    prompts, expect = solo
    _, tnet = _nets()
    good = shd.decode_param_specs

    def bad(conf, axis=shd.TP_AXIS):
        specs = good(conf, axis)
        specs["embed"] = {"W": (None, axis), "b": (axis,)}
        return specs
    monkeypatch.setattr(shd, "decode_param_specs", bad)
    eng = _engine(tnet, mesh2, kv_pool_mb=_pool_mb(32, 8, 2))
    counts = shd.collective_counts(eng)
    assert all(c["all_gather"] == 1 for c in counts), counts
    with pytest.raises(AssertionError, match="resharding"):
        shd.assert_hot_path_collectives(counts, N_BLOCKS)
    assert _serve(eng, prompts[:2], 6) == expect[:2]
    with pytest.raises(AssertionError, match="all-reduces"):
        shd.assert_hot_path_collectives({"all_reduce": 5}, N_BLOCKS)
    with pytest.raises(AssertionError, match="command broadcasts"):
        shd.assert_hot_path_collectives({"broadcast_command": 2}, N_BLOCKS)


# ------------------------------------------------------ disable rules --
def test_disabled_when_heads_do_not_divide():
    """tp = 3 cannot split 4 KV heads: a warning, tp 1, solo's tokens, no
    follower started (JAX :282)."""
    _, tnet = _nets()
    ref = generate_transformer(tnet, [1, 2, 3, 4, 5], 4, V, use_cache=True)
    with pytest.warns(RuntimeWarning, match="not divisible by the tp"):
        eng = _engine(tnet, 3, n_slots=2)
    assert eng.tp == 1 and eng.mesh is None
    assert _serve(eng, [[1, 2, 3, 4, 5]], 4) == [ref]


def test_disabled_for_recurrent_nets():
    from deeplearning4j_tpu_torch.models.zoo import char_rnn_lstm
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    rnn = MultiLayerNetwork(char_rnn_lstm(vocab_size=V, hidden=8),
                            device="cpu").init()
    with pytest.warns(RuntimeWarning,
                      match="tensor-parallel decode is DISABLED"):
        eng = DecodeScheduler(rnn, V, n_slots=1, prefill_chunk=8, mesh=2,
                              decode_graphs="off", device="cpu",
                              metrics=MetricsRegistry())
    assert eng.tp == 1 and eng.mesh is None


def test_mesh_without_tp_axis_warns_and_disables():
    _, tnet = _nets()
    m = tmesh.default_mesh(2, ["cpu"] * 2)
    with pytest.warns(RuntimeWarning, match="no 'tp' axis"):
        eng = _engine(tnet, m, n_slots=1)
    assert eng.tp == 1 and eng.mesh is None and not m.alive()


def test_refusals_under_tp():
    """Captured steps raise under tp = 2, naming ROADMAP A7, before any
    follower starts. Speculation and the KV tiers are served under tp
    (tests/test_torch_tp_speculative.py, tests/test_torch_tp_kvtier.py):
    their engines build, armed, with no follower started yet."""
    _, tnet = _nets()
    base = dict(n_slots=2, prefill_chunk=16, kv_block=8, mesh=2,
                device="cpu", metrics=MetricsRegistry(),
                kv_pool_mb=_pool_mb(32, 8, 2))
    with pytest.raises(ValueError, match="decode_graphs='off'.*A7"):
        DecodeScheduler(tnet, V, **base)
    mesh = shd.decode_mesh(2, ["cpu"] * 2, timeout=TIMEOUT)
    try:
        for kw in (dict(speculate=2), dict(host_cache_mb=1.0)):
            eng = DecodeScheduler(tnet, V, decode_graphs="off",
                                  **dict(base, mesh=mesh), **kw)
            assert eng.tp == 2
            assert eng.speculate == 2 if "speculate" in kw \
                else eng.tier is not None
            eng.stop()
    finally:
        mesh.kill()


# ------------------------------------------------ pool and topology --
def test_per_rank_pool_budget_and_gauges(mesh4):
    """At a fixed per-rank budget a tp = 4 pool holds 4x the blocks of
    tp = 1, and the mesh size and per-rank pool bytes are gauges (JAX
    :345)."""
    _, tnet = _nets()
    per_rank_mb = _pool_mb(16, 8, 1)
    caps = {}
    for tp, mesh in ((1, None), (4, mesh4)):
        m = MetricsRegistry()
        eng = _engine(tnet, mesh, n_slots=2, kv_pool_mb=per_rank_mb,
                      metrics=m)
        caps[tp] = eng.pool.capacity_blocks
        if tp > 1:
            snap = m.snapshot()
            assert snap["gauges"]["decode_mesh_devices"]["value"] == tp
            assert snap["gauges"]["kv_pool_device_bytes"]["value"] <= \
                per_rank_mb * (1 << 20)
            topo = eng.debug_snapshot()["mesh"]
            assert topo["tp"] == 4 and topo["device_list"] == ["cpu"] * 4
            assert topo["backend"] == "gloo"
        eng.stop()
    assert caps[4] >= 4 * caps[1] - 4, caps


def _get(port, path):
    return json.loads(urllib.request.urlopen(
        f"http://127.0.0.1:{port}{path}", timeout=TIMEOUT).read())


def test_server_reports_the_mesh():
    """InferenceServer(decode_tp=2) on CPU ranks: /generate serves
    split, /metrics carries the mesh gauge, /info the topology (JAX
    :377)."""
    from deeplearning4j_tpu_torch.serving.server import InferenceServer
    _, tnet = _nets()
    srv = InferenceServer(net=tnet, decode_vocab=V, decode_slots=2,
                          prefill_chunk=16, kv_pool_mb=_pool_mb(32, 8, 2),
                          kv_block=8, decode_tp=2, decode_graphs="off",
                          supervise=False, device="cpu").start()
    try:
        ref = generate_transformer(tnet, [1, 2, 3, 4, 5], 4, V,
                                   use_cache=True)
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.port}/generate",
            data=json.dumps({"prompt": [1, 2, 3, 4, 5],
                             "max_new_tokens": 4}).encode(),
            headers={"Content-Type": "application/json"})
        out = json.loads(urllib.request.urlopen(req, timeout=TIMEOUT).read())
        assert out["tokens"] == ref
        metrics = _get(srv.port, "/metrics")
        assert metrics["gauges"]["decode_mesh_devices"]["value"] == 2
        assert "kv_pool_device_bytes" in metrics["gauges"]
        info = _get(srv.port, "/info")
        assert info["mesh"]["tp"] == 2 and info["mesh"]["devices"] >= 2
        assert _get(srv.port, "/debug/engine")["mesh"]["tp"] == 2
    finally:
        srv.stop()


def test_cli_serve_tp_banner(tmp_path, capsys):
    """`serve --tp 2 --decode-graphs off` prints the mesh in force; `--tp
    2` with captured steps is refused with the reason."""
    from deeplearning4j_tpu_torch.cli import main as tcli
    from deeplearning4j_tpu_torch.util.model_serializer import write_model
    _, tnet = _nets()
    zp = str(tmp_path / "lm.zip")
    write_model(tnet, zp)
    base = ["serve", "--model", zp, "--generate", "--device", "cpu",
            "--kv-pool-mb", "0.2", "--kv-block", "8", "--once",
            "--no-supervise", "--tp", "2"]
    assert tcli.main(base) == 2
    assert "--decode-graphs off" in capsys.readouterr().err
    assert tcli.main(base + ["--decode-graphs", "off"]) == 0
    out = capsys.readouterr().out
    assert "tensor-parallel over 2 ranks (cpu,cpu; gloo" in out


def test_sigkilled_follower_is_rebuilt_not_hung():
    """SIGKILL of rank 1 mid-decode in a supervised server: the engine's
    next collective fails, the supervisor rebuilds it with new followers,
    and the request completes with its tokens (or ends in the structured
    503) — never a hang."""
    from deeplearning4j_tpu_torch.inference.supervisor import \
        RetryBudgetExceededError
    from deeplearning4j_tpu_torch.serving.server import InferenceServer
    _, tnet = _nets()
    prompt = [1, 2, 3, 4, 5, 6, 7]
    ref = generate_transformer(tnet, prompt, 48, V, use_cache=True)
    srv = InferenceServer(net=tnet, decode_vocab=V, decode_slots=2,
                          prefill_chunk=16, kv_pool_mb=_pool_mb(32, 8, 2),
                          kv_block=8, decode_tp=2, decode_graphs="off",
                          hang_timeout_s=10.0, device="cpu").start()
    try:
        sup = srv.supervisor
        dead = sup.engine
        h = sup.submit(prompt, 48)
        t0 = time.monotonic()
        while not h.tokens and time.monotonic() - t0 < TIMEOUT:
            time.sleep(0.005)
        os.kill(dead.mesh._procs[0].pid, signal.SIGKILL)
        try:
            assert h.result(TIMEOUT) == ref
            assert h.retries >= 1
            assert sup.restarts >= 1 and sup.engine is not dead
            assert sup.engine.tp == 2 and sup.engine.mesh.alive()
        except RetryBudgetExceededError:
            pass  # the structured 503 path
        assert not dead.mesh.alive()
    finally:
        srv.stop()


def test_new_modules_import_without_jax():
    """The slice's modules import in a process where importing jax
    fails."""
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['deeplearning4j_tpu'] = None; "
            "import deeplearning4j_tpu_torch.parallel as p; "
            "import deeplearning4j_tpu_torch.parallel.mesh, "
            "deeplearning4j_tpu_torch.parallel.tensor_parallel, "
            "deeplearning4j_tpu_torch.parallel.trainer, "
            "deeplearning4j_tpu_torch.parallel.evaluation, "
            "deeplearning4j_tpu_torch.parallel.spark_api, "
            "deeplearning4j_tpu_torch.parallel.stats, "
            "deeplearning4j_tpu_torch.inference.sharding, "
            "deeplearning4j_tpu_torch.inference.engine; print('ok')")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
