"""Port parity: speculative decoding under tensor parallelism (ROADMAP
A7.2.1).

The case of tests/test_speculative.py:220 (`test_spec_token_identity_
sharded`) on the port's `DecodeScheduler(mesh=..., speculate=3)`: the
driver (this process, rank 0) and spawned follower ranks on
``devices=["cpu"] * n`` over gloo, one torch thread a rank, with the JAX
file's widths (V 13, d 32, 4 heads, 2 blocks, RoPE). The draft joins the
mesh: a shallow exit of 1 block takes the target's Megatron specs and
each rank's shard tensors by reference; an explicit ``draft_net`` is
sliced on each rank from the params the attach ships. The verify, the
draft step and the draft chunk are each one command; rollback stays the
driver's bookkeeping.

Tokens at tp 2 and 4 (paged and contiguous, GQA with Hkv 2 at tp 2, an
explicit draft, a rollback across a block boundary) equal solo
`generate_transformer(use_cache=True)`, the port's tp = 1 speculating
engine and the JAX `DecodeScheduler(mesh=tp, speculate=3)` on the same
weights (`params_from_jax`). The verify and the draft pass the collective
budget on every rank (`sharding.verify_collective_counts`,
`draft_collective_counts`: two all-reduces a block, one command, no
resharding), the port's counterpart of JAX `verify_program_hlo` :241 and
`draft_program_hlo` :264.

Two meshes serve the module; every collective carries a 60 s timeout and
every wait a deadline, and the fixtures kill the followers at teardown.
"""
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.inference import DecodeScheduler as JEngine
from deeplearning4j_tpu.inference import MetricsRegistry as JRegistry
from deeplearning4j_tpu.models.zoo import transformer_lm as jlm
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu_torch.inference import sharding as shd
from deeplearning4j_tpu_torch.inference.engine import DecodeScheduler
from deeplearning4j_tpu_torch.inference.metrics import MetricsRegistry
from deeplearning4j_tpu_torch.inference.trace import FlightRecorder
from deeplearning4j_tpu_torch.models.sampling import generate_transformer
from deeplearning4j_tpu_torch.nn.conf.graph import \
    ComputationGraphConfiguration as TConf
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph as TGraph
from deeplearning4j_tpu_torch.util.model_serializer import params_from_jax

V = 13
N_BLOCKS = 2
TIMEOUT = 60.0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _conf(n_kv_heads=None, n_blocks=N_BLOCKS, seed=None):
    kw = {} if seed is None else {"seed": seed}
    conf = jlm(vocab_size=V, d_model=32, n_heads=4, n_blocks=n_blocks,
               rope=True, n_kv_heads=n_kv_heads, **kw)
    for vert in conf.vertices.values():
        layer = getattr(vert, "layer", None)
        if layer is not None and hasattr(layer, "max_cache_len"):
            layer.max_cache_len = 96
    return conf


_NETS = {}


def _nets(n_kv_heads=None, n_blocks=N_BLOCKS, seed=None):
    """(JAX net, port net on the CPU with the JAX weights)."""
    key = (n_kv_heads, n_blocks, seed)
    if key not in _NETS:
        jnet = JGraph(_conf(n_kv_heads, n_blocks, seed)).init()
        tnet = TGraph(TConf.from_json(jnet.conf.to_json()),
                      device="cpu").init()
        tnet.set_params(params_from_jax(
            {k: {n: np.asarray(a) for n, a in lp.items()}
             for k, lp in jnet.params.items()}))
        _NETS[key] = (jnet, tnet)
    return _NETS[key]


def _pool_mb(blocks, block, tp, n_kv=4):
    """PER-RANK MiB buying ``blocks`` usable blocks (+1 scratch): 2 layers
    x (k+v) x Hkv x Dh 8 x f32 a position in all, split over tp."""
    return (blocks + 1) * block * 2 * 2 * n_kv * 8 * 4 / tp / float(1 << 20)


@pytest.fixture(scope="module")
def meshes():
    ms = {tp: shd.decode_mesh(tp, ["cpu"] * tp, timeout=TIMEOUT).start()
          for tp in (2, 4)}
    yield ms
    for m in ms.values():
        m.kill()


@pytest.fixture(scope="module")
def prompts():
    rng = np.random.default_rng(0)
    return [[int(t) for t in rng.integers(0, V, n)] for n in (23, 9)]


def _engine(tnet, mesh, paged=True, n_kv=4, **kw):
    kw.setdefault("n_slots", 2)
    kw.setdefault("speculate", 3)
    if paged:
        kw.setdefault("kv_pool_mb", _pool_mb(40, 8, 1 if mesh is None
                                             else mesh.size, n_kv))
    return DecodeScheduler(tnet, V, prefill_chunk=16, kv_block=8,
                           mesh=mesh, decode_graphs="off", device="cpu",
                           metrics=MetricsRegistry(), **kw)


def _serve(eng, prompts, n):
    eng.start()
    try:
        return [h.result(TIMEOUT) for h in
                [eng.submit(p, n) for p in prompts]]
    finally:
        eng.stop()


def _audit(eng, n_draft_blocks):
    """The verify's and the draft's counts on every rank, within the
    budget: 2 all-reduces a block (the draft's blocks for the draft),
    one command, no all-gather or data broadcast."""
    v = shd.verify_collective_counts(eng)
    d = shd.draft_collective_counts(eng)
    assert len(v) == len(d) == eng.tp
    for c in v:
        assert c == {"all_reduce": 2 * N_BLOCKS, "all_gather": 0,
                     "broadcast_command": 1, "broadcast_data": 0}, c
    for c in d:
        assert c == {"all_reduce": 2 * n_draft_blocks, "all_gather": 0,
                     "broadcast_command": 1, "broadcast_data": 0}, c
    shd.assert_hot_path_collectives(v, N_BLOCKS)
    shd.assert_hot_path_collectives(d, n_draft_blocks)


@pytest.mark.parametrize("tp", [2, 4])
def test_spec_token_identity_sharded(tp, meshes, prompts):
    """Paged and contiguous speculation at tp: solo's tokens, the tp = 1
    speculating engine's, and the JAX engine's at the same tp (JAX :220);
    the audit on every rank."""
    jnet, tnet = _nets()
    solo = [generate_transformer(tnet, p, 12, V, use_cache=True)
            for p in prompts]
    one = _serve(_engine(tnet, None), prompts, 12)
    assert one == solo
    for paged in (True, False):
        eng = _engine(tnet, meshes[tp], paged=paged)
        assert eng.tp == tp and eng.speculate == 3 and eng.paged == paged
        assert eng.draft_blocks == 1
        _audit(eng, 1)
        assert _serve(eng, prompts, 12) == solo, f"tp={tp} paged={paged}"
        assert eng.spec_rounds > 0 and eng.draft_steps > 0
    jeng = JEngine(jnet, V, n_slots=2, prefill_chunk=16,
                   kv_pool_mb=_pool_mb(40, 8, tp), kv_block=8,
                   speculate=3, mesh=tp, metrics=JRegistry()).start()
    try:
        assert jeng.tp == tp and jeng.speculate == 3
        jouts = [jeng.generate(p, 12, timeout=300) for p in prompts]
    finally:
        jeng.stop()
    assert jouts == solo


def test_spec_gqa_at_tp2(meshes, prompts):
    """GQA with Hkv 2 at tp 2: one KV head a rank in the pages and the
    draft's stripes; the tp = 1 speculating engine's tokens."""
    _, tnet = _nets(n_kv_heads=2)
    one = _serve(_engine(tnet, None, n_kv=2), prompts, 10)
    eng = _engine(tnet, meshes[2], n_kv=2)
    assert eng.tp == 2
    st = next(iter(eng._draft_states.values()))
    assert st["k"].shape[2] == 1  # 1 of 2 KV heads on this rank
    _audit(eng, 1)
    assert _serve(eng, prompts, 10) == one
    assert one == [generate_transformer(tnet, p, 10, V, use_cache=True)
                   for p in prompts]


def test_spec_explicit_draft_net_at_tp2(meshes, prompts):
    """An explicit 1-block draft net, sliced on each rank: the tp = 1
    engine's tokens with the same draft, and its proposal counts."""
    _, tnet = _nets()
    _, draft = _nets(n_blocks=1, seed=99)
    res = {}
    for tp, mesh in ((1, None), (2, meshes[2])):
        eng = _engine(tnet, mesh, draft_net=draft)
        assert eng.draft_blocks == 0 and eng.draft is draft
        if tp > 1:
            _audit(eng, 1)
        res[tp] = (_serve(eng, prompts, 12), eng.spec_proposed,
                   eng.spec_accepted)
    assert res[2] == res[1]
    assert res[1][0] == [generate_transformer(tnet, p, 12, V, use_cache=True)
                         for p in prompts]


def test_spec_target_as_draft_accepts_everything_at_tp2(meshes, prompts):
    """The target as its own draft: every proposal accepted at tp 2, as
    at tp 1 (the sharded draft computes the target's distributions)."""
    _, tnet = _nets()
    eng = _engine(tnet, meshes[2], draft_net=tnet)
    out = _serve(eng, prompts[:1], 12)
    assert out == [generate_transformer(tnet, prompts[0], 12, V,
                                        use_cache=True)]
    assert eng.spec_proposed > 0
    assert eng.spec_accepted == eng.spec_proposed


def test_spec_rollback_across_block_boundary_at_tp2(meshes):
    """kv_block 4 < G + 1: verifies allocate pages past the frontier and
    rollbacks return them, on the driver's books; every rank's pages stay
    consistent, so the tokens are solo's, and every page comes back."""
    _, tnet = _nets()
    prompt = [int(t) for t in np.random.default_rng(4).integers(0, V, 30)]
    solo = generate_transformer(tnet, prompt, 16, V, use_cache=True)
    tracer = FlightRecorder(4096)
    eng = DecodeScheduler(tnet, V, n_slots=2, prefill_chunk=16, kv_block=4,
                          kv_pool_mb=_pool_mb(40, 4, 2), speculate=3,
                          mesh=meshes[2], decode_graphs="off",
                          device="cpu", tracer=tracer,
                          metrics=MetricsRegistry())
    assert _serve(eng, [prompt], 16) == [solo]
    rollbacks = [ev for ev in tracer.events() if ev["name"] == "rollback"]
    assert any(ev["args"].get("blocks_freed", 0) > 0 for ev in rollbacks)
    assert eng.pool.outstanding_refs() == 0


def test_serve_tp_speculate_cli(tmp_path, capsys):
    """`serve --tp 2 --speculate 3 --decode-graphs off` is accepted and
    names the draft and the mesh in its banner."""
    from deeplearning4j_tpu_torch.cli import main as tcli
    from deeplearning4j_tpu_torch.util.model_serializer import write_model
    _, tnet = _nets()
    zp = str(tmp_path / "lm.zip")
    write_model(tnet, zp)
    rc = tcli.main(["serve", "--model", zp, "--generate", "--device", "cpu",
                    "--kv-pool-mb", "0.2", "--kv-block", "8", "--once",
                    "--no-supervise", "--tp", "2", "--decode-graphs", "off",
                    "--speculate", "3"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "tensor-parallel over 2 ranks" in out
    assert "speculat" in out
