"""Port parity: speculative decoding on the port's `DecodeScheduler`.

The cases of tests/test_speculative.py on `DecodeScheduler(device="cpu")`
over the JAX suite's LM (V 29, d 32, 2 heads, 2 blocks, RoPE, max_cache_len
128) with the JAX params (`params_from_jax`):

  - `accept_tokens`: the four pure cases, run against both copies;
  - the shallow-exit draft: `shallow_draft_conf` keeps the JAX surgery's
    vertices and wiring, the draft shares the target's tensors, and its
    output rows match the JAX draft's within 1e-5;
  - token identity: speculation gives the tokens of the JAX
    `DecodeScheduler(speculate=...)` and of the port's engine without
    speculation, greedy and seeded-sampled, contiguous, paged and int8
    pages, and under grammars, stop sequences and penalties;
  - paged rollback across block boundaries (kv_block 4 < G + 1): the
    pages past the frontier return to the pool, no reference leaks;
  - the runner budget: warmup() builds every speculative runner, and
    traffic builds none;
  - a ``dispatch.verify`` crash recovered by the supervisor, token for
    token, on a rebuilt engine that speculates again;
  - prefix restores and preemption under speculation (the draft's
    catch-up);
  - the unarmed fallbacks (a recurrent net, a graph the surgery cannot
    cut) and the CLI's ``--speculate``, ``--draft-blocks`` and
    ``--mask-rows``.

The JAX engines run once per module (`jax_ref`).
"""
import json
import urllib.request

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.inference import DecodeScheduler as JEngine
from deeplearning4j_tpu.inference import speculative as jspec
from deeplearning4j_tpu.inference import logitproc as jlp
from deeplearning4j_tpu.models.zoo import transformer_lm as jlm
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu_torch.inference import failpoints
from deeplearning4j_tpu_torch.inference import logitproc as tlp
from deeplearning4j_tpu_torch.inference import speculative as tspec
from deeplearning4j_tpu_torch.inference.engine import DecodeScheduler
from deeplearning4j_tpu_torch.inference.metrics import MetricsRegistry
from deeplearning4j_tpu_torch.inference.trace import FlightRecorder
from deeplearning4j_tpu_torch.models.sampling import generate_transformer
from deeplearning4j_tpu_torch.nn.conf.graph import \
    ComputationGraphConfiguration as TConf
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph as TGraph
from deeplearning4j_tpu_torch.serving.server import InferenceServer
from deeplearning4j_tpu_torch.util.model_serializer import params_from_jax

V = 29
SAMPLED = {"temperature": 0.9, "top_k": 6, "seed": 123}
COPIES = {"jax": jspec, "torch": tspec}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tier-1 runs several test files at once on a few cores; one torch
    intra-op thread keeps this file from starving the others' timings."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(n_blocks=2, seed=7):
    conf = jlm(vocab_size=V, d_model=32, n_heads=2, n_blocks=n_blocks,
               rope=True, seed=seed)
    for vert in conf.vertices.values():
        layer = getattr(vert, "layer", None)
        if layer is not None and hasattr(layer, "max_cache_len"):
            layer.max_cache_len = 128
    jnet = JGraph(conf).init()
    tnet = TGraph(TConf.from_json(jnet.conf.to_json()), device="cpu").init()
    tnet.set_params(params_from_jax(
        {k: {n: np.asarray(a) for n, a in lp.items()}
         for k, lp in jnet.params.items()}))
    return jnet, tnet


_NETS = []


def _nets():
    if not _NETS:
        _NETS.append(_pair())
    return _NETS[0]


@pytest.fixture(scope="module")
def prompt():
    return [int(t) for t in np.random.default_rng(3).integers(0, V, 24)]


@pytest.fixture(scope="module")
def jax_ref(prompt):
    """The JAX engines' tokens with speculation, once: (layout, regime) ->
    tokens, for contiguous and int8 pages, greedy and sampled."""
    jnet, _ = _nets()
    out = {}
    for layout, kw in (("contiguous", {}),
                       ("int8", {"kv_pool_mb": 1.0, "kv_block": 4,
                                 "kv_dtype": "int8"})):
        eng = JEngine(jnet, V, n_slots=2, prefill_chunk=16, speculate=3,
                      **kw).start()
        try:
            out[layout, "greedy"] = eng.generate(prompt, 16, timeout=600)
            out[layout, "sampled"] = eng.generate(prompt, 16, timeout=600,
                                                  **SAMPLED)
        finally:
            eng.stop()
    return out


def _engine(engine_kw=None, warm=True, net=None, **kw):
    m = MetricsRegistry()
    eng = DecodeScheduler(net or _nets()[1], V, n_slots=2, prefill_chunk=16,
                          metrics=m, device="cpu", **(engine_kw or {}), **kw)
    if warm:
        eng.warmup()
    return eng.start(), m


def _gen(eng, prompt, *reqs, n=16):
    try:
        return [eng.generate_handle(prompt, n, timeout=600, **kw)
                for kw in reqs]
    finally:
        eng.stop()


# -- acceptance rule (pure), against both copies ------------------------------
def _dist(winner):
    row = np.full((V,), 1e-6)
    row[winner] = 1.0
    return row / row.sum()


def _full_acceptance_plus_bonus(sp):
    rows = np.stack([_dist(t) for t in (4, 5, 6, 7)])
    emitted, matched = sp.accept_tokens(rows, [4, 5, 6], 0.0, None, None,
                                        np.random.default_rng(0), 99, None)
    assert (emitted, matched) == ([4, 5, 6, 7], 3)


def _stops_at_first_mismatch(sp):
    rows = np.stack([_dist(t) for t in (4, 9, 6, 7)])
    emitted, matched = sp.accept_tokens(rows, [4, 5, 6], 0.0, None, None,
                                        np.random.default_rng(0), 99, None)
    assert (emitted, matched) == ([4, 9], 1)


def _eos_and_budget_cut(sp):
    rows = np.stack([_dist(t) for t in (4, 5, 6, 7)])
    emitted, matched = sp.accept_tokens(rows, [4, 5, 6], 0.0, None, None,
                                        np.random.default_rng(0), 99, 5)
    assert (emitted, matched) == ([4, 5], 2)
    emitted, _ = sp.accept_tokens(rows, [4, 5, 6], 0.0, None, None,
                                  np.random.default_rng(0), 2, None)
    assert emitted == [4, 5]


def _rng_lockstep_with_solo(sp):
    from deeplearning4j_tpu_torch.models.sampling import sample_logits
    rng_a = np.random.default_rng(11)
    rng_b = np.random.default_rng(11)
    rows = np.stack([np.random.default_rng(50 + i).dirichlet(np.ones(V))
                     for i in range(4)])
    emitted, _ = sp.accept_tokens(rows, [1, 2, 3], 0.8, None, None, rng_a,
                                  99, None)
    for j, tok in enumerate(emitted):
        assert tok == sample_logits(rows[j], 0.8, None, rng_b, None)
    assert rng_a.integers(1 << 30) == rng_b.integers(1 << 30)


@pytest.mark.parametrize("copy", list(COPIES))
@pytest.mark.parametrize("case", [
    _full_acceptance_plus_bonus, _stops_at_first_mismatch,
    _eos_and_budget_cut, _rng_lockstep_with_solo],
    ids=lambda c: getattr(c, "__name__", str(c)).strip("_"))
def test_accept_tokens_case(case, copy):
    case(COPIES[copy])


def test_accept_tokens_copies_agree_on_random_chains():
    """Both copies walk sampled chains with a grammar and penalties to the
    same tokens, match counts and RNG positions."""
    rng = np.random.default_rng(5)
    for trial in range(20):
        rows = np.stack([rng.dirichlet(np.ones(V)) for _ in range(4)])
        props = [int(t) for t in rng.integers(0, V, 3)]
        out = []
        for lp, sp in ((jlp, jspec), (tlp, tspec)):
            g = lp.compile_trie([[1, 2, 3], [1, 4]], V)
            proc = lp.LogitState(V, grammar=g if trial % 2 else None,
                                 repetition_penalty=1.2)
            r = np.random.default_rng(trial)
            out.append((sp.accept_tokens(rows, props, 0.7, 5, 0.9, r, 3,
                                         None, proc=proc),
                        r.integers(1 << 30)))
        assert out[0] == out[1]


# -- shallow-exit draft surgery ----------------------------------------------
def test_shallow_draft_conf_keeps_the_jax_surgery():
    jnet, tnet = _nets()
    d = tspec.shallow_draft_conf(tnet.conf, 1)
    jd = jspec.shallow_draft_conf(jnet.conf, 1)
    assert set(d.vertices) == set(jd.vertices)
    assert d.vertex_inputs == jd.vertex_inputs
    assert "attn0" in d.vertices and "attn1" not in d.vertices
    assert d.vertex_inputs["ln_f"] == ["res0b"]
    assert d.network_outputs == tnet.conf.network_outputs
    assert json.loads(d.to_json()) == json.loads(jd.to_json())
    for bad in (0, 2):
        with pytest.raises(ValueError):
            tspec.shallow_draft_conf(tnet.conf, bad)


def test_shallow_draft_shares_params_and_matches_jax_draft():
    """The draft holds the target's tensors by reference, its rows match
    the JAX draft's; with the deep blocks' output projections zeroed the
    target IS its shallow exit (bitwise)."""
    jnet, tnet = _pair(n_blocks=3, seed=5)
    x = np.zeros((1, 4, V), np.float32)
    x[0, np.arange(4), [1, 2, 3, 4]] = 1.0
    draft = tspec.build_shallow_draft(tnet, 1)
    assert all(draft.params[n] is tnet.params[n] for n in draft.params)
    jdraft = jspec.build_shallow_draft(jnet, 1)
    got = draft.output(x)[0].numpy()
    want = np.asarray(jdraft.output(x)[0])
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    for name, wkey in (("attn1", "Wo"), ("attn2", "Wo"), ("ff1o", "W"),
                       ("ff2o", "W")):
        tnet.params[name][wkey].zero_()
        tnet.params[name]["b"].zero_()
    np.testing.assert_array_equal(tnet.output(x)[0].numpy(),
                                  draft.output(x)[0].numpy())


# -- token identity -----------------------------------------------------------
LAYOUTS = {"contiguous": {}, "paged": {"kv_pool_mb": 1.0, "kv_block": 4},
           "int8": {"kv_pool_mb": 1.0, "kv_block": 4, "kv_dtype": "int8"}}


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_spec_token_identity_greedy_and_sampled(prompt, jax_ref, layout):
    """Speculation gives the JAX speculating engine's tokens and the
    port's own unspeculated ones, greedy and seeded-sampled; the metrics
    carry the proposals and the acceptance ratio."""
    kw = LAYOUTS[layout]
    base = _gen(_engine(kw, warm=False)[0], prompt, {}, SAMPLED)
    eng, m = _engine(dict(kw, speculate=3))
    spec = _gen(eng, prompt, {}, SAMPLED)
    assert [h.tokens for h in spec] == [h.tokens for h in base]
    ref = "int8" if layout == "int8" else "contiguous"
    assert [h.tokens for h in spec] == [jax_ref[ref, "greedy"],
                                        jax_ref[ref, "sampled"]]
    if layout != "int8":
        assert spec[0].tokens == generate_transformer(
            _nets()[1], prompt, 16, V, use_cache=True)
    snap = m.snapshot()
    assert snap["counters"]["spec_tokens_proposed_total"] > 0
    assert "spec_tokens_accepted_total" in snap["counters"]
    assert 0.0 <= snap["ratios"]["spec_acceptance_rate"] <= 1.0
    assert eng.speculate == 3 and eng.draft_blocks == 1
    assert eng.spec_rounds > 0 and eng.draft_steps == 3 * eng.spec_rounds
    if eng.pool is not None:
        assert eng.pool.outstanding_refs() == 0


def test_spec_paged_rollback_across_block_boundary(prompt):
    """kv_block 4 < G + 1: every verify spans a block boundary, and the
    rejections of a random net truncate freshly allocated pages."""
    _, tnet = _nets()
    solo = generate_transformer(tnet, prompt, 16, V, use_cache=True)
    tracer = FlightRecorder(4096)
    eng, _ = _engine({"kv_pool_mb": 4.0, "kv_block": 4, "speculate": 4},
                     tracer=tracer)
    try:
        assert eng.generate(prompt, 16, timeout=600) == solo
        free_mid = eng.pool.free_blocks
    finally:
        eng.stop()
    assert eng.pool.outstanding_refs() == 0
    names = {ev["name"] for ev in tracer.events()}
    assert {"draft", "verify", "rollback"} <= names
    rollbacks = [ev for ev in tracer.events() if ev["name"] == "rollback"]
    assert any(ev["args"].get("blocks_freed", 0) > 0 for ev in rollbacks)
    assert free_mid >= eng.pool.capacity_blocks - 2 * (len(prompt) + 16) // 4


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_spec_under_grammar_stop_and_penalties(prompt, layout):
    """Grammars (admit-all, trie, JSON schema), a stop sequence and the
    penalties compose with speculation: the tokens and finish reasons of
    the unspeculated engine. The admit-all and JSON requests run the
    masked draft and verify, captured on first use."""
    kw = LAYOUTS[layout]
    schema = tlp.compile_json_schema(
        {"type": "object", "properties": {
            "a": {"type": "integer", "maxDigits": 2},
            "b": {"type": "string", "maxLength": 3, "charset": "abc"}}},
        ('"{}:,[]-' + "0123456789" + "abcdefghijk")[:V])
    reqs = [{"grammar": tlp.admit_all(V)},
            {"grammar": tlp.admit_all(V), **SAMPLED},
            {"grammar": tlp.compile_trie([[3, 1, 4, 1, 5, 9, 2, 6]], V)},
            {"grammar": schema, "temperature": 1.0, "seed": 2},
            {"repetition_penalty": 1.3, "frequency_penalty": 0.2},
            {"presence_penalty": 0.5, **SAMPLED}]
    base = _gen(_engine(kw, warm=False)[0], prompt, *reqs)
    stop = [base[0].tokens[3:5]]
    base += _gen(_engine(kw, warm=False)[0], prompt, {"stop": stop})
    eng, _ = _engine(dict(kw, speculate=3))
    spec = _gen(eng, prompt, *reqs, {"stop": stop})
    assert [(h.tokens, h.finish_reason) for h in spec] == \
        [(h.tokens, h.finish_reason) for h in base]
    assert spec[2].finish_reason == "grammar"
    assert spec[-1].finish_reason == "stop"
    nb = len(eng.table_buckets) or 1
    assert 1 <= eng.spec_captures["masked_verify"] <= nb
    assert eng.spec_captures["masked_draft"] == 1


def test_spec_warmup_builds_every_runner_and_traffic_none(prompt):
    """warmup() builds the verify per table bucket, the draft step and a
    draft chunk per chunk bucket (and their masked variants with
    masks=True); serving traffic builds nothing after it."""
    for kw in ({}, {"kv_pool_mb": 1.0, "kv_block": 4}):
        eng = DecodeScheduler(_nets()[1], V, n_slots=2, prefill_chunk=32,
                              speculate=3, metrics=MetricsRegistry(),
                              device="cpu", **kw)
        eng.warmup(masks=True)
        nb = len(eng.table_buckets) or 1
        warmed = dict(eng.spec_captures)
        assert warmed == {"verify": nb, "draft": 1, "masked_verify": nb,
                          "masked_draft": 1,
                          "draft_prefill": len(eng.prefill_buckets)}
        counts = (eng.decode_captures, eng.prefill_captures,
                  eng.masked_captures)
        eng.start()
        _gen(eng, prompt, {}, {"grammar": tlp.admit_all(V)}, n=12)
        assert eng.spec_captures == warmed
        assert (eng.decode_captures, eng.prefill_captures,
                eng.masked_captures) == counts
        with pytest.raises(RuntimeError, match="capture budget"):
            eng._new_spec_runner("verify", eng.table_buckets[0]
                                 if eng.paged else None)


def test_spec_catches_up_after_prefix_restore_and_preempt(prompt):
    """A prefix restore jumps the main cache past tokens the draft never
    saw (contiguous side pool, paged trie), and a tight pool preempts
    and resumes: the draft catches up through its chunk, and the tokens
    stay solo's."""
    _, tnet = _nets()
    long_p = prompt + prompt[:20]
    solo = generate_transformer(tnet, long_p, 16, V, use_cache=True)
    for kw in ({"prefix_cache_mb": 1.0, "kv_block": 4},
               {"kv_pool_mb": 1.0, "kv_block": 4}):
        eng, _ = _engine(dict(kw, speculate=2))
        hs = _gen(eng, long_p, {}, {})
        assert [h.tokens for h in hs] == [solo, solo]
        assert eng.restored_tokens > 0
        assert eng.draft_chunks > eng.prefill_chunks
    # a pool that holds both prompts but not both decodes: one preempts
    eng0 = DecodeScheduler(tnet, V, kv_pool_mb=1.0, kv_block=4,
                           device="cpu")
    bpb = eng0.pool.bytes_per_block
    blocks = 2 * -(-len(long_p) // 4) + 2
    eng, _ = _engine({"kv_pool_mb": (blocks + 1) * bpb / (1 << 20),
                      "kv_block": 4, "speculate": 2})
    try:
        hs = [eng.submit(long_p, 16, **kw) for kw in ({}, SAMPLED)]
        got = [h.result(600) for h in hs]
    finally:
        eng.stop()
    assert got == [solo, generate_transformer(tnet, long_p, 16, V,
                                              use_cache=True, **SAMPLED)]
    assert eng.preemptions > 0
    assert eng.pool.outstanding_refs() == 0


def test_spec_verify_crash_recovered_token_identical():
    """A ``dispatch.verify`` crash mid-speculation: the supervisor fences,
    rebuilds (speculation re-armed by the factory), warms and replays;
    the tokens are the unchaosed run's and nothing is captured outside
    the rebuilt engine's warmup()."""
    srv = InferenceServer(net=_nets()[1], decode_vocab=V, decode_slots=2,
                          prefill_chunk=16, kv_pool_mb=1.0, kv_block=4,
                          speculate=2, hang_timeout_s=30.0, retry_budget=6,
                          device="cpu").start()
    srv.supervisor.backoff_base_s = 0.01
    srv.supervisor.backoff_max_s = 0.1
    try:
        assert srv.supervisor.engine.speculate == 2
        p = [int(t) for t in np.random.default_rng(8).integers(0, V, 20)]

        def gen():
            body = json.dumps({"prompt": p, "max_new_tokens": 10}).encode()
            req = urllib.request.Request(
                f"http://127.0.0.1:{srv.port}/generate", data=body,
                headers={"Content-Type": "application/json"})
            return json.loads(urllib.request.urlopen(req, timeout=120)
                              .read())
        expected = gen()["tokens"]
        failpoints.arm("dispatch.verify", "crash@once")
        try:
            out = gen()
        finally:
            failpoints.disarm()
        assert out["tokens"] == expected
        assert out.get("retries")
        eng = srv.supervisor.engine
        assert eng.speculate == 2 and srv.supervisor.restarts >= 1
        warmed = dict(eng.spec_captures)
        assert gen()["tokens"] == expected
        assert eng.spec_captures == warmed
        info = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{srv.port}/info", timeout=60).read())
        assert info["decode"]["speculate"] == 2
    finally:
        failpoints.disarm()
        srv.stop()


# -- the unarmed fallbacks and the CLI ----------------------------------------
def test_spec_unarmed_fallbacks_warn():
    """A recurrent net and a graph the surgery cannot cut warn and run
    unarmed (speculate == 0), as the JAX engine does; an explicit
    draft_net arms the second."""
    from deeplearning4j_tpu_torch.models.zoo import char_rnn_lstm
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    rnn = MultiLayerNetwork(char_rnn_lstm(vocab_size=V, hidden=8),
                            device="cpu").init()
    with pytest.warns(RuntimeWarning, match="speculative decoding is "
                                            "DISABLED"):
        eng = DecodeScheduler(rnn, V, n_slots=2, speculate=2, device="cpu")
    assert eng.speculate == 0 and eng.draft is None
    toks = _gen(eng.start(), [1, 2, 3], {}, n=4)[0].tokens
    assert len(toks) == 4
    one = _pair(n_blocks=1)[1]
    with pytest.warns(RuntimeWarning, match="no self-speculative draft"):
        eng = DecodeScheduler(one, V, speculate=2, device="cpu")
    assert eng.speculate == 0
    with pytest.warns(RuntimeWarning, match="chunked prefill"):
        eng = DecodeScheduler(_nets()[1], V, prefill_chunk=1, speculate=2,
                              device="cpu")
    assert eng.speculate == 0
    eng = DecodeScheduler(one, V, speculate=2, draft_net=one, device="cpu")
    assert eng.speculate == 2 and eng.draft_blocks == 0


def test_spec_full_acceptance_with_target_as_draft(prompt):
    """draft_net = the target: every greedy proposal is accepted (the
    full-accept, bonus-token and lag-2 paths), the tokens unchanged."""
    _, tnet = _nets()
    solo = generate_transformer(tnet, prompt, 16, V, use_cache=True)
    for kw in ({}, {"kv_pool_mb": 1.0, "kv_block": 4}):
        eng, _ = _engine(dict(kw, speculate=3), draft_net=tnet)
        assert _gen(eng, prompt, {})[0].tokens == solo
        assert eng.spec_accepted == eng.spec_proposed > 0


def test_cli_serve_speculate_and_mask_rows(tmp_path, capsys):
    from deeplearning4j_tpu_torch.cli.main import main as cli_main
    from deeplearning4j_tpu_torch.util.model_serializer import write_model
    path = tmp_path / "lm.zip"
    write_model(_nets()[1], path)
    rc = cli_main(["serve", "--model", str(path), "--generate",
                   "--decode-slots", "2", "--prefill-chunk", "16",
                   "--speculate", "2", "--draft-blocks", "1",
                   "--mask-rows", "8", "--device", "cpu", "--once"])
    assert rc == 0
    assert "speculative x2 (shallow-exit draft, 1 blocks)" in \
        capsys.readouterr().out
    rc = cli_main(["serve", "--model", str(path), "--int8", "--device",
                   "cpu", "--once"])
    assert rc == 2  # not a quantized artifact
