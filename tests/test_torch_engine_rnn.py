"""Port parity: the decode engine's recurrent path — the GravesLSTM
char-RNN (`char_rnn_lstm(vocab_size=11, hidden=16)`) served by the port's
`DecodeScheduler(device="cpu")` from its own [n_slots, hidden] h/c rows.

The JAX case (tests/test_inference_engine.py:470) at prefill chunks 1, 8
and 16, greedy and seeded top-k, with more requests than slots (mid-
prefill slots are masked out of the decode step's state write): the port
engine's tokens must equal the port's solo `generate_rnn` and the JAX
`DecodeScheduler`'s on the same params (the JAX params carried over with
`params_from_jax`). Tokens are compared exactly: both packages compute
the same f32 rows up to rounding, and seeded sampling draws from the same
numpy RNG stream.
"""
import warnings

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.inference import DecodeScheduler as JEngine
from deeplearning4j_tpu.models import zoo as jzoo
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu_torch.inference.engine import DecodeScheduler
from deeplearning4j_tpu_torch.models import zoo as tzoo
from deeplearning4j_tpu_torch.models.sampling import (generate_rnn,
                                                      generate_transformer)
from deeplearning4j_tpu_torch.nn.conf.config import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph as TGraph
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork as TNet
from deeplearning4j_tpu_torch.util.model_serializer import params_from_jax

V, H, NEW = 11, 16, 6
PROMPTS = [[1, 2], [3], [4, 5, 6]]
# longer prompts, so that chunks of 8 leave slots mid-prefill
LONG = [[1, 2], [3, 4, 5, 6, 7, 8, 9, 10, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 2],
        [4, 5, 6], [9] * 11, [2, 7, 3, 8, 4, 9, 5, 10, 6, 1]]
SAMPLING = {"greedy": {}, "topk": dict(temperature=0.9, top_k=4, seed=3)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tier-1 runs several test files at once on a few cores; one torch
    intra-op thread keeps this file from starving the others' timings."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_PAIR = []


def _pair():
    """(JAX char-RNN, port char-RNN on the CPU) on the JAX params."""
    if not _PAIR:
        jconf = jzoo.char_rnn_lstm(vocab_size=V, hidden=H)
        jnet = JNet(jconf).init()
        tnet = TNet(MultiLayerConfiguration.from_json(jconf.to_json()),
                    device="cpu").init()
        tnet.set_params(params_from_jax(
            [{k: np.asarray(a) for k, a in lp.items()}
             for lp in jnet.params]))
        _PAIR.append((jnet, tnet))
    return _PAIR[0]


def _serve(eng, prompts, n_new=NEW, **kw):
    eng.start()
    try:
        return [h.result(120) for h in
                [eng.submit(p, n_new, **kw) for p in prompts]]
    finally:
        eng.stop()


_JAX_TOKENS = {}


def _jax_tokens(chunk, mode, prompts):
    key = (chunk, mode, id(prompts))
    if key not in _JAX_TOKENS:
        jnet, _ = _pair()
        _JAX_TOKENS[key] = _serve(JEngine(jnet, V, n_slots=2,
                                          prefill_chunk=chunk),
                                  prompts, **SAMPLING[mode])
    return _JAX_TOKENS[key]


@pytest.mark.parametrize("mode", sorted(SAMPLING))
@pytest.mark.parametrize("chunk", [1, 8, 16])
def test_char_rnn_engine_matches_generate_rnn_and_jax(chunk, mode):
    """More requests than slots: queued requests wait, and every decode
    step masks the mid-prefill and idle rows out of the state write."""
    _, tnet = _pair()
    kw = SAMPLING[mode]
    for prompts in (PROMPTS, LONG):
        eng = DecodeScheduler(tnet, V, n_slots=2, prefill_chunk=chunk,
                              device="cpu")
        eng.warmup()
        tnet.rnn_clear_previous_state()
        got = _serve(eng, prompts, **kw)
        # the engine's own rows: the net's streaming state is untouched
        assert tnet._rnn_state == {}
        solo = [generate_rnn(tnet, p, NEW, V, **kw) for p in prompts]
        assert got == solo
        assert got == _jax_tokens(chunk, mode, prompts)
        assert eng.recurrent and eng.pool is None and not eng.paged
        if chunk > 1:
            assert eng.prefill_chunks > 0 and eng.final_chunks > 0


def test_char_rnn_eager_step_equals_captured_body():
    _, tnet = _pair()
    kw = SAMPLING["topk"]
    outs = []
    for graphs in ("on", "off"):
        eng = DecodeScheduler(tnet, V, n_slots=2, prefill_chunk=8,
                              decode_graphs=graphs, device="cpu")
        eng.warmup()
        outs.append(_serve(eng, LONG, **kw))
        assert eng.decode_captures == (1 if graphs == "on" else 0)
        assert eng.prefill_captures == (len(eng.prefill_buckets)
                                        if graphs == "on" else 0)
    assert outs[0] == outs[1]


def test_char_rnn_slot_reuse_is_clean():
    """Admission zeroes the slot's h/c rows: a slot that served a long
    sequence leaks nothing into its next occupant."""
    _, tnet = _pair()
    solo = generate_rnn(tnet, [2, 4], NEW, V)
    for chunk in (1, 16):
        eng = DecodeScheduler(tnet, V, n_slots=1, prefill_chunk=chunk,
                              device="cpu").start()
        try:
            eng.submit([7, 8, 9, 10, 2, 6, 1], 12).result(120)
            assert eng.submit([2, 4], NEW).result(120) == solo
        finally:
            eng.stop()


def test_char_rnn_pool_options_warn_and_run_contiguous():
    """JAX :398, :406: a recurrent net has no position-addressed rows to
    page or share; the pool options warn and are ignored."""
    _, tnet = _pair()
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        eng = DecodeScheduler(tnet, V, n_slots=2, kv_pool_mb=1.0,
                              prefix_cache_mb=1.0, kv_dtype="int8",
                              device="cpu")
    msgs = " ".join(str(x.message) for x in w)
    assert "paged KV decode is DISABLED" in msgs
    assert "prefix KV pool is DISABLED" in msgs
    assert "kv_dtype='int8'" in msgs
    assert not eng.paged and eng.pool is None and eng.kv_dtype is None
    got = _serve(eng, PROMPTS)
    assert got == [generate_rnn(tnet, p, NEW, V) for p in PROMPTS]


def test_char_rnn_no_length_limit_and_state_shapes():
    """No positions: a prompt plus tokens far past any cache is served;
    the state is [n_slots, hidden] rows per recurrent layer at the
    compute dtype."""
    _, tnet = _pair()
    eng = DecodeScheduler(tnet, V, n_slots=3, device="cpu")
    assert sorted(eng._states) == [0, 1]
    for st in eng._states.values():
        assert {k: tuple(v.shape) for k, v in st.items()} == \
            {"h": (3, H), "c": (3, H)}
        assert all(v.dtype == torch.float32 for v in st.values())
    prompt = [int(t) for t in np.random.default_rng(0).integers(0, V, 150)]
    got = _serve(eng, [prompt], n_new=40)
    assert got == [generate_rnn(tnet, prompt, 40, V)]


def test_engine_refusals():
    _, tnet = _pair()
    # speculation needs an attention cache to verify against: a recurrent
    # net warns and runs unarmed, as the JAX engine does (:949-952)
    with pytest.warns(RuntimeWarning, match="speculative decoding is "
                                            "DISABLED"):
        eng = DecodeScheduler(tnet, V, speculate=2, device="cpu")
    assert eng.speculate == 0
    mlp = TNet(tzoo.mlp_iris(), device="cpu").init()
    with pytest.raises(ValueError, match="stateful"):
        DecodeScheduler(mlp, 3, device="cpu")


def test_transformer_engine_unchanged_by_recurrent_path():
    """The attention path is untouched: a graph LM still matches its solo
    cached decode."""
    net = TGraph(tzoo.transformer_lm(vocab_size=13, d_model=16, n_heads=2,
                                     n_blocks=2, rope=True),
                 device="cpu").init()
    prompts = [[1, 2, 3, 4], [5], [7, 8]]
    solo = [generate_transformer(net, p, 5, 13, use_cache=True)
            for p in prompts]
    eng = DecodeScheduler(net, 13, n_slots=2, device="cpu")
    assert not eng.recurrent
    assert _serve(eng, prompts, n_new=5) == solo


def test_char_rnn_served_over_http_and_by_the_cli(tmp_path, capsys):
    """A recurrent MultiLayerNetwork is served when decode_vocab is given
    (the JAX server's rule); without it a MultiLayerNetwork serves
    /predict alone. The CLI's serve --generate takes the vocabulary from
    the last layer's width."""
    import json
    import urllib.request
    from deeplearning4j_tpu_torch.cli.main import main as cli_main
    from deeplearning4j_tpu_torch.serving.server import InferenceServer
    from deeplearning4j_tpu_torch.util.model_serializer import write_model
    _, tnet = _pair()
    assert InferenceServer(net=tnet, device="cpu").decode_vocab == 0
    srv = InferenceServer(net=tnet, decode_vocab=V, decode_slots=2,
                          prefill_chunk=8, device="cpu").start()
    try:
        for body in ({"prompt": LONG[1], "max_new_tokens": NEW},
                     {"prompt": LONG[3], "max_new_tokens": NEW,
                      **SAMPLING["topk"]}):
            req = urllib.request.Request(
                f"http://127.0.0.1:{srv.port}/generate",
                data=json.dumps(body).encode(),
                headers={"Content-Type": "application/json"})
            out = json.loads(urllib.request.urlopen(req, timeout=120).read())
            kw = {k: body[k] for k in SAMPLING["topk"] if k in body}
            assert out["tokens"] == generate_rnn(tnet, body["prompt"], NEW,
                                                 V, **kw)
        assert srv.info()["decode"]["kv_mode"] == "recurrent"
    finally:
        srv.stop()
    path = tmp_path / "rnn.zip"
    write_model(tnet, path)
    assert cli_main(["serve", "--model", str(path), "--generate",
                     "--decode-slots", "2", "--prefill-chunk", "8",
                     "--device", "cpu", "--once"]) == 0
    banner = capsys.readouterr().out
    assert "recurrent h/c rows" in banner and "/generate" in banner


def test_server_takes_many_connections_at_once():
    """32 clients connecting at once are all accepted and answered: the
    server listens with a backlog of 128, not the stdlib's 5, past which
    connections were reset or waited for a SYN retransmit (1 s)."""
    import json
    import urllib.request
    from concurrent.futures import ThreadPoolExecutor
    from deeplearning4j_tpu_torch.serving.server import InferenceServer
    _, tnet = _pair()
    srv = InferenceServer(net=tnet, decode_vocab=V, decode_slots=4,
                          prefill_chunk=8, device="cpu").start()
    try:
        assert srv._httpd.request_queue_size >= 128

        def post(i):
            req = urllib.request.Request(
                f"http://127.0.0.1:{srv.port}/generate",
                data=json.dumps({"prompt": PROMPTS[i % 3],
                                 "max_new_tokens": 2}).encode(),
                headers={"Content-Type": "application/json"})
            return json.loads(urllib.request.urlopen(req, timeout=120)
                              .read())["tokens"]
        with ThreadPoolExecutor(32) as ex:
            outs = list(ex.map(post, range(32)))
    finally:
        srv.stop()
    assert outs == [generate_rnn(tnet, PROMPTS[i % 3], 2, V)
                    for i in range(32)]


def test_bidirectional_lstm_is_refused():
    """A bidirectional LSTM reads the whole sequence, so it cannot be
    stepped a token at a time: the engine refuses it by its impl class."""
    from deeplearning4j_tpu_torch.nn.conf.config import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.conf.layers import (
        GravesBidirectionalLSTM, RnnOutputLayer)
    conf = (NeuralNetConfiguration.builder().seed(1).list()
            .layer(GravesBidirectionalLSTM(n_in=V, n_out=8,
                                           activation="tanh"))
            .layer(RnnOutputLayer(n_in=8, n_out=V, activation="softmax",
                                  loss="mcxent"))
            .build())
    net = TNet(conf, device="cpu").init()
    with pytest.raises(ValueError, match="bidirectional"):
        DecodeScheduler(net, V, n_slots=2, device="cpu")
