"""Port parity: post-training int8 quantization (`nn/quantization.py`).

The cases of tests/test_quantization.py, each on the JAX package's net
carried into the port through the model zip (config, params, BN
variables), so both sides quantize the same trained weights with the
same calibration data. The int8 weights and their scales are equal bit
for bit (numpy in float64 on both sides), the activation scales agree to
f32 rounding, and the int8 accumulator is exact on both sides, so the
quantized outputs agree within 1e-5 of max |output| unless a calibration
rounding moves one input's int8 level (a few 1e-3 at these widths, the
looser bound where a case says so). The JAX DAG case's
`distributed_evaluate` leg is left out: the port has no `parallel/`
(ROADMAP A7).

Then the int8 graph clone through the decode engine: its greedy tokens
against JAX's `quantize_graph` clone served by the JAX `DecodeScheduler`
(V 29), and `save_quantized_graph` / `save_quantized` artifacts read in
both directions, one of them served with ``serve --int8 --generate
--once``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.datasets.iterators import \
    ListDataSetIterator as JListIt
from deeplearning4j_tpu.inference import DecodeScheduler as JEngine
from deeplearning4j_tpu.models.sampling import \
    generate_transformer as jgenerate
from deeplearning4j_tpu.models.zoo import transformer_lm as jlm
from deeplearning4j_tpu.nn import quantization as jq
from deeplearning4j_tpu.nn.conf.config import NeuralNetConfiguration
from deeplearning4j_tpu.nn.conf.inputs import InputType
from deeplearning4j_tpu.nn.conf.layers import (BatchNormalization,
                                               ConvolutionLayer, DenseLayer,
                                               GravesLSTM, OutputLayer,
                                               RnnOutputLayer,
                                               SubsamplingLayer)
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu.nn.updater.updaters import Sgd
from deeplearning4j_tpu.util import model_serializer as jms
from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.datasets.iterators import ListDataSetIterator
from deeplearning4j_tpu_torch.inference.engine import DecodeScheduler
from deeplearning4j_tpu_torch.models.sampling import generate_transformer
from deeplearning4j_tpu_torch.nn import quantization as tq
from deeplearning4j_tpu_torch.nn.conf.preprocessors import \
    FeedForwardToRnnPreProcessor
from deeplearning4j_tpu_torch.util import model_serializer as tms

V = 29


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tier-1 runs several test files at once on a few cores; one torch
    intra-op thread keeps this file from starving the others' timings."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mlp_net(seed=7):
    conf = (NeuralNetConfiguration.builder()
            .seed(seed).learning_rate(0.1).updater(Sgd())
            .list()
            .layer(DenseLayer(n_in=8, n_out=32, activation="relu"))
            .layer(DenseLayer(n_in=32, n_out=32, activation="tanh"))
            .layer(OutputLayer(n_in=32, n_out=4, activation="softmax",
                               loss="negativeloglikelihood"))
            .build())
    return JNet(conf).init()


def _conv_bn_net(seed=3):
    conf = (NeuralNetConfiguration.builder()
            .seed(seed).learning_rate(0.05).updater(Sgd())
            .list()
            .layer(ConvolutionLayer(n_out=8, kernel_size=(3, 3),
                                    stride=(1, 1), padding=(1, 1),
                                    activation="identity"))
            .layer(BatchNormalization(activation="relu"))
            .layer(SubsamplingLayer(pooling_type="max", kernel_size=(2, 2),
                                    stride=(2, 2)))
            .layer(DenseLayer(n_out=24, activation="relu"))
            .layer(OutputLayer(n_out=3, activation="softmax",
                               loss="negativeloglikelihood"))
            .set_input_type(InputType.convolutional(8, 8, 2))
            .build())
    return JNet(conf).init()


def _clsdata(rng, n, shape, k):
    """Class-structured data: per-class mean offsets, learnable quickly."""
    y = rng.integers(0, k, n)
    x = rng.standard_normal((n,) + shape).astype(np.float32) * 0.5
    x += y.reshape((-1,) + (1,) * len(shape)).astype(np.float32)
    return x, np.eye(k, dtype=np.float32)[y]


def _train(jnet, x, y, steps):
    for _ in range(steps):
        jnet._fit_one(jnp.asarray(x), jnp.asarray(y), None, None)


def _port(jnet, tmp_path, name="net.zip"):
    """The JAX net carried into the port by its model zip."""
    path = tmp_path / name
    jms.write_model(jnet, path)
    return tms.restore_model(path, device="cpu")


def _close(got, want, tol=1e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= tol * max(1.0, np.abs(want).max()), err


def _same_plan(tnet_q, jnet_q):
    """Equal steps, int8 weights, weight scales and (to f32 rounding)
    activation scales."""
    assert [(s.kind, s.index, s.consumed) for s in tnet_q._steps] == \
        [(s.kind, s.index, s.consumed) for s in jnet_q._steps]
    assert set(tnet_q._consts) == set(jnet_q._consts)
    for si, (Wq, sw, b, sx) in tnet_q._consts.items():
        jW, jsw, jb, jsx = (np.asarray(a) for a in jnet_q._consts[si])
        assert Wq.dtype == torch.int8
        np.testing.assert_array_equal(Wq.numpy(), jW)
        np.testing.assert_array_equal(sw.numpy(), jsw)
        np.testing.assert_array_equal(b.numpy(), jb)
        np.testing.assert_allclose(float(sx), float(jsx), rtol=1e-6)


def test_fold_batchnorm_is_float_exact(tmp_path):
    """The port's fold equals JAX's bit for bit (float64 on the host), and
    BN(conv(x)) == conv'(x) to float precision in the port."""
    rng = np.random.default_rng(0)
    jnet = _conv_bn_net()
    x, y = _clsdata(rng, 32, (8, 8, 2), 3)
    _train(jnet, x, y, 4)
    tnet = _port(jnet, tmp_path)
    scale, shift = tq._bn_scale_shift(tnet._impls[1], tnet.params[1],
                                      tnet.variables[1])
    jscale, jshift = jq._bn_scale_shift(jnet._impls[1], jnet.params[1],
                                        jnet.variables[1])
    np.testing.assert_array_equal(scale, jscale)
    np.testing.assert_array_equal(shift, jshift)
    Wf, bf = tq.fold_batchnorm(tnet.params[0]["W"], tnet.params[0]["b"],
                               scale, shift)
    jWf, jbf = jq.fold_batchnorm(jnet.params[0]["W"], jnet.params[0]["b"],
                                 jscale, jshift)
    np.testing.assert_array_equal(Wf, jWf)
    np.testing.assert_array_equal(bf, jbf)
    from deeplearning4j_tpu_torch.ops.cuda_kernels import conv2d_ref
    xb = torch.from_numpy(x[:8])
    raw = conv2d_ref(xb, tnet.params[0]["W"], padding=((1, 1), (1, 1))) \
        + tnet.params[0]["b"]
    want = torch.from_numpy(scale.astype(np.float32)) * raw \
        + torch.from_numpy(shift.astype(np.float32))
    got = conv2d_ref(xb, torch.from_numpy(Wf.astype(np.float32)),
                     padding=((1, 1), (1, 1))) \
        + torch.from_numpy(bf.astype(np.float32))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_build_steps_folds_conv_bn_pair(tmp_path):
    jnet = _conv_bn_net()
    tnet = _port(jnet, tmp_path)
    for fold, kinds in ((True, ["conv", "float", "dense", "dense"]),
                        (False, ["conv", "float", "float", "dense",
                                 "dense"])):
        steps = tq._build_steps(tnet, fold_bn=fold)
        assert [s.kind for s in steps] == kinds
        assert [(s.kind, s.consumed) for s in steps] == \
            [(s.kind, s.consumed) for s in jq._build_steps(jnet, fold)]
    assert tq._build_steps(tnet, fold_bn=True)[0].consumed == 2


def test_dense_bn_pair_folds_too(tmp_path):
    conf = (NeuralNetConfiguration.builder()
            .seed(11).learning_rate(0.1).updater(Sgd())
            .list()
            .layer(DenseLayer(n_in=8, n_out=16, activation="identity"))
            .layer(BatchNormalization(n_in=16, n_out=16, activation="relu"))
            .layer(OutputLayer(n_in=16, n_out=4, activation="softmax",
                               loss="negativeloglikelihood"))
            .build())
    jnet = JNet(conf).init()
    rng = np.random.default_rng(4)
    x, y = _clsdata(rng, 128, (8,), 4)
    _train(jnet, x, y, 10)
    tnet = _port(jnet, tmp_path)
    steps = tq._build_steps(tnet, fold_bn=True)
    assert [s.kind for s in steps] == ["dense", "dense"]
    assert steps[0].consumed == 2
    qt = tq.quantize(tnet, [x[:32]])
    qj = jq.quantize(jnet, [x[:32]])
    _same_plan(qt, qj)
    got = qt.output(x).numpy()
    _close(got, np.asarray(qj.output(x)))
    assert np.abs(got - tnet.output(x).numpy()).max() < 0.08


def test_no_fold_across_preprocessor_at_bn_index(tmp_path):
    tnet = _port(_conv_bn_net(), tmp_path)
    tnet.conf.input_preprocessors["1"] = FeedForwardToRnnPreProcessor()
    steps = tq._build_steps(tnet, fold_bn=True)
    assert steps[0].kind == "conv" and steps[0].consumed == 1
    assert steps[1].kind == "float"


def test_int8_mlp_tracks_float_net(tmp_path):
    rng = np.random.default_rng(1)
    jnet = _mlp_net()
    x, y = _clsdata(rng, 256, (8,), 4)
    _train(jnet, x[:128], y[:128], 30)
    tnet = _port(jnet, tmp_path)
    qt = tq.quantize(tnet, [DataSet(x[:64], y[:64])])
    qj = jq.quantize(jnet, [JDataSet(x[:64], y[:64])])
    _same_plan(qt, qj)
    xt = x[128:]
    ref = tnet.output(xt).numpy()
    got = qt.output(xt).numpy()
    _close(got, np.asarray(qj.output(xt)))
    assert np.max(np.abs(got - ref)) < 0.08
    assert np.mean(np.argmax(got, -1) == np.argmax(ref, -1)) >= 0.97


def test_int8_conv_bn_net_accuracy_close_to_float(tmp_path):
    """The folded conv goes through the im2col int8 product; accuracy
    matches JAX's int8 net and stays near the float net's."""
    rng = np.random.default_rng(2)
    jnet = _conv_bn_net()
    x, y = _clsdata(rng, 512, (8, 8, 2), 3)
    _train(jnet, x[:256], y[:256], 25)
    tnet = _port(jnet, tmp_path)
    test_it = ListDataSetIterator(DataSet(x[256:], y[256:]), batch=64)
    facc = tnet.evaluate(test_it).accuracy()
    assert facc > 0.7, f"float net failed to learn ({facc})"
    qt = tq.quantize(tnet, [DataSet(x[:64], y[:64])])
    qj = jq.quantize(jnet, [JDataSet(x[:64], y[:64])])
    _same_plan(qt, qj)
    test_it.reset()
    qacc = qt.evaluate(test_it).accuracy()
    jit = JListIt(JDataSet(x[256:], y[256:]), batch=64)
    assert qacc == qj.evaluate(jit).accuracy()
    assert abs(facc - qacc) <= 0.05
    _close(qt.output(x[256:]).numpy(), np.asarray(qj.output(x[256:])))
    conv = [s for s in qt._steps if s.kind == "conv"]
    assert len(conv) == 1 and conv[0].Wq.dtype == np.int8


def test_param_bytes_shrink(tmp_path):
    jnet = _mlp_net()
    tnet = _port(jnet, tmp_path)
    qt = tq.quantize(tnet, [np.zeros((4, 8), np.float32)])
    qj = jq.quantize(jnet, [np.zeros((4, 8), np.float32)])
    assert qt.param_bytes() == qj.param_bytes()
    assert qt.float_param_bytes() == qj.float_param_bytes()
    assert qt.param_bytes() < 0.35 * qt.float_param_bytes()


def test_unquantizable_net_falls_back_to_float_exactly(tmp_path):
    conf = (NeuralNetConfiguration.builder()
            .seed(5).learning_rate(0.1).updater(Sgd())
            .list()
            .layer(GravesLSTM(n_in=6, n_out=12, activation="tanh"))
            .layer(RnnOutputLayer(n_in=12, n_out=4, activation="softmax",
                                  loss="mcxent"))
            .build())
    jnet = JNet(conf).init()
    tnet = _port(jnet, tmp_path)
    x = np.random.default_rng(3).standard_normal((4, 10, 6)).astype(
        np.float32)
    qt = tq.quantize(tnet, [x])
    assert all(s.kind == "float" for s in qt._steps if s.index == 0)
    np.testing.assert_allclose(qt.output(x).numpy(), tnet.output(x).numpy(),
                               rtol=2e-5, atol=2e-5)
    _close(qt.output(x).numpy(), np.asarray(jq.quantize(jnet, [x]).output(x)))


def test_bf16_net_stays_bf16_through_fallback_layers(tmp_path):
    conf = (NeuralNetConfiguration.builder()
            .seed(9).learning_rate(0.05).updater(Sgd())
            .compute_dtype("bfloat16")
            .list()
            .layer(ConvolutionLayer(n_out=8, kernel_size=(3, 3),
                                    stride=(1, 1), padding=(1, 1),
                                    activation="relu"))
            .layer(BatchNormalization(activation="identity"))
            .layer(DenseLayer(n_out=16, activation="relu"))
            .layer(OutputLayer(n_out=3, activation="softmax",
                               loss="negativeloglikelihood"))
            .set_input_type(InputType.convolutional(8, 8, 2))
            .build())
    jnet = JNet(conf).init()
    tnet = _port(jnet, tmp_path)
    x = np.random.default_rng(6).standard_normal((8, 8, 8, 2)).astype(
        np.float32)
    qt = tq.quantize(tnet, [x])
    assert any(s.kind == "float" for s in qt._steps)
    out = qt.output(x)
    assert out.dtype == torch.bfloat16
    assert tnet.output(x).dtype == torch.bfloat16
    # bf16 activations between the steps: within a bf16 rounding or two
    _close(out.float().numpy(),
           np.asarray(jq.quantize(jnet, [x]).output(x), np.float32), 2e-2)


def test_calibration_required(tmp_path):
    tnet = _port(_mlp_net(), tmp_path)
    with pytest.raises(ValueError):
        tq.quantize(tnet, [])


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_save_load_quantized_round_trip(tmp_path, writer):
    """A `save_quantized` artifact written by either package loads in both
    to the same int8 program (weights and scales bit for bit), and stays
    a float checkpoint."""
    rng = np.random.default_rng(12)
    jnet = _conv_bn_net(seed=13)
    x, y = _clsdata(rng, 128, (8, 8, 2), 3)
    _train(jnet, x, y, 6)
    p = tmp_path / "qmodel.zip"
    if writer == "jax":
        jq.save_quantized(jq.quantize(jnet, [x[:32]]), p)
    else:
        tq.save_quantized(tq.quantize(_port(jnet, tmp_path), [x[:32]]), p)
    qt = tq.load_quantized(p, device="cpu")
    qj = jq.load_quantized(p)
    _same_plan(qt, qj)
    for si in qt._consts:
        assert float(qt._consts[si][3]) == float(qj._consts[si][3])
    _close(qt.output(x).numpy(), np.asarray(qj.output(x)))
    qt2 = tq.load_quantized(p, device="cpu")
    np.testing.assert_array_equal(qt.output(x).numpy(),
                                  qt2.output(x).numpy())
    fnet = tms.restore_multi_layer_network(p, device="cpu")
    np.testing.assert_allclose(fnet.output(x[:8]).numpy(),
                               np.asarray(jnet.output(x[:8])), rtol=1e-5,
                               atol=1e-5)
    assert isinstance(tms.restore_model(p, device="cpu"), tq.QuantizedNetwork)


# ---------------------------------------------------------- graph facade --

def _jgraph(V_, T, B, seed, steps, n_blocks=1):
    rng = np.random.default_rng(seed)
    jnet = JGraph(jlm(vocab_size=V_, d_model=32, n_heads=2,
                      n_blocks=n_blocks)).init()
    x = np.eye(V_, dtype=np.float32)[rng.integers(0, V_, (B, T))]
    y = np.eye(V_, dtype=np.float32)[rng.integers(0, V_, (B, T))]
    for _ in range(steps):
        jnet.fit(x, y)
    return jnet, x


def test_quantize_graph_transformer_tracks_float(tmp_path):
    jnet, x = _jgraph(13, 12, 8, 7, 10)
    tnet = _port(jnet, tmp_path)
    qt = tq.quantize_graph(tnet, [x])
    qj = jq.quantize_graph(jnet, [x])
    assert qt._quantized_vertices == qj._quantized_vertices
    assert "ff0" in qt._quantized_vertices and "embed" in \
        qt._quantized_vertices
    assert "attn0" not in qt._quantized_vertices
    assert "out" not in qt._quantized_vertices
    for name in qt._quantized_vertices:
        np.testing.assert_array_equal(qt._impls[name].Wq.numpy(),
                                      np.asarray(qj._impls[name].Wq))
        np.testing.assert_allclose(float(qt._impls[name].x_scale),
                                   float(qj._impls[name].x_scale), rtol=1e-6)
    ref = tnet.output(x)[0].numpy()
    got = qt.output(x)[0].numpy()
    _close(got, np.asarray(qj.output_single(x)))
    assert np.max(np.abs(got - ref)) < 0.1
    assert np.mean(np.argmax(got, -1) == np.argmax(ref, -1)) >= 0.9
    np.testing.assert_array_equal(tnet.output(x)[0].numpy(), ref)


def test_quantized_graph_kv_cache_decode_matches_full(tmp_path):
    jnet, x = _jgraph(11, 8, 4, 9, 5)
    tnet = _port(jnet, tmp_path)
    qt = tq.quantize_graph(tnet, [x])
    full = qt.output(x)[0].numpy()
    cached = np.stack([qt.rnn_time_step(x[:, t])[0].numpy()[:, 0]
                       for t in range(x.shape[1])], axis=1)
    np.testing.assert_allclose(cached, full, rtol=2e-4, atol=2e-4)
    assert qt._rnn_state and not tnet._rnn_state


def test_quantize_graph_dense_dag(tmp_path):
    from deeplearning4j_tpu.nn.conf.graph import MergeVertex
    gb = (NeuralNetConfiguration.builder()
          .seed(3).learning_rate(0.1).updater(Sgd())
          .graph_builder()
          .add_inputs("in")
          .add_layer("a", DenseLayer(n_in=8, n_out=16, activation="relu"),
                     "in")
          .add_layer("b", DenseLayer(n_in=8, n_out=16, activation="tanh"),
                     "in")
          .add_vertex("m", MergeVertex(), "a", "b")
          .add_layer("out", OutputLayer(n_in=32, n_out=4,
                                        activation="softmax",
                                        loss="negativeloglikelihood"), "m"))
    gb.set_outputs("out")
    jnet = JGraph(gb.build()).init()
    rng = np.random.default_rng(8)
    x, y = _clsdata(rng, 256, (8,), 4)
    for _ in range(25):
        jnet.fit(x, y)
    tnet = _port(jnet, tmp_path)
    qt = tq.quantize_graph(tnet, [x[:64]])
    qj = jq.quantize_graph(jnet, [x[:64]])
    assert set(qt._quantized_vertices) == {"a", "b", "out"}
    ref = tnet.output(x)[0].numpy()
    got = qt.output(x)[0].numpy()
    _close(got, np.asarray(qj.output_single(x)))
    assert np.max(np.abs(got - ref)) < 0.08
    assert np.mean(np.argmax(got, -1) == np.argmax(ref, -1)) >= 0.97
    assert np.isfinite(qt.score(inputs=[x[:32]], labels=[y[:32]]))
    with pytest.raises(RuntimeError, match="inference-only"):
        qt.fit(x[:32], y[:32])
    it = ListDataSetIterator(DataSet(x, y), batch=64)
    jit = JListIt(JDataSet(x, y), batch=64)
    assert qt.evaluate(it).accuracy() == qj.evaluate(jit).accuracy()


# ------------------------------------------- int8 graph decode, artifacts --

def _lm_pair(tmp_path):
    """The JAX suite's `_lm` (V 29, d 32, 2 blocks, RoPE, cache 128) and
    its port copy."""
    conf = jlm(vocab_size=V, d_model=32, n_heads=2, n_blocks=2, rope=True,
               seed=7)
    for vert in conf.vertices.values():
        layer = getattr(vert, "layer", None)
        if layer is not None and hasattr(layer, "max_cache_len"):
            layer.max_cache_len = 128
    jnet = JGraph(conf).init()
    return jnet, _port(jnet, tmp_path, "lm.zip")


def _onehots(prompt):
    x = np.zeros((1, len(prompt), V), np.float32)
    x[0, np.arange(len(prompt)), prompt] = 1.0
    return x


def test_int8_graph_decode_matches_jax_clone(tmp_path):
    """The port's int8 clone through its decode engine gives the greedy
    tokens of JAX's clone through the JAX engine and of its own solo
    cached decode, contiguous and paged, with and without speculation;
    the clone's probability rows match JAX's clone's."""
    jnet, tnet = _lm_pair(tmp_path)
    prompt = [int(t) for t in np.random.default_rng(3).integers(0, V, 24)]
    x = _onehots(prompt)
    path = tmp_path / "qlm.zip"
    jq.save_quantized_graph(jq.quantize_graph(jnet, [x]), path)
    qj = jq.load_quantized(path)
    qt = tq.load_quantized(path, device="cpu")
    _close(qt.output(x)[0].numpy(), np.asarray(qj.output_single(x)))
    jeng = JEngine(qj, V, n_slots=2, prefill_chunk=16).start()
    try:
        want = jeng.generate(prompt, 12, timeout=600)
    finally:
        jeng.stop()
    assert want == jgenerate(qj, prompt, 12, V, use_cache=True)
    assert generate_transformer(qt, prompt, 12, V, use_cache=True) == want
    for kw in ({}, {"kv_pool_mb": 1.0, "kv_block": 8},
               {"speculate": 2}, {"kv_pool_mb": 1.0, "kv_block": 8,
                                  "speculate": 2}):
        eng = DecodeScheduler(qt, V, n_slots=2, prefill_chunk=16,
                              device="cpu", **kw)
        eng.warmup()
        eng.start()
        try:
            assert eng.generate(prompt, 12, timeout=600) == want, kw
        finally:
            eng.stop()
        if kw.get("speculate"):
            assert eng.speculate == 2 and eng.spec_proposed > 0
    assert not tnet._rnn_state and not qt._rnn_state


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_int8_graph_artifact_both_ways_and_cli_serve(tmp_path, writer):
    """A `save_quantized_graph` artifact written by either package reloads
    in both to the same plan and tokens; the port's CLI serves it with
    ``serve --int8 --generate --once``."""
    from deeplearning4j_tpu_torch.cli.main import main as cli_main
    conf = jlm(vocab_size=V, d_model=32, n_heads=2, n_blocks=2, rope=True,
               seed=21)
    jnet = JGraph(conf).init()
    p = [int(t) for t in np.random.default_rng(2).integers(0, V, 12)]
    x = _onehots(p)
    path = tmp_path / "qlm.zip"
    if writer == "jax":
        jq.save_quantized_graph(jq.quantize_graph(jnet, [x]), path)
    else:
        tq.save_quantized_graph(
            tq.quantize_graph(_port(jnet, tmp_path), [x]), path)
    qt = tq.load_quantized(path, device="cpu")
    qj = jq.load_quantized(path)
    assert qt._quantized_vertices == qj._quantized_vertices
    for name in qt._quantized_vertices:
        assert float(qt._impls[name].x_scale) == float(
            np.float32(qj._impls[name].x_scale))
    assert generate_transformer(qt, p, 8, V, use_cache=True) == \
        jgenerate(qj, p, 8, V, use_cache=True)
    rc = cli_main(["serve", "--model", str(path), "--int8", "--generate",
                   "--decode-slots", "2", "--prefill-chunk", "16",
                   "--device", "cpu", "--once"])
    assert rc == 0


def test_int8_matmul_is_exact():
    """The s8 x s8 -> s32 product against int64 sums, at K and N that are
    not multiples of 8 and a single row (the shapes the card pads)."""
    rng = np.random.default_rng(0)
    for M, K, N in ((1, 13, 5), (3, 32, 29), (40, 64, 128)):
        a = rng.integers(-127, 128, (M, K)).astype(np.int8)
        w = rng.integers(-127, 128, (K, N)).astype(np.int8)
        got = tq.int8_matmul(torch.from_numpy(a),
                             tq._product_weight(w, torch.device("cpu")), N)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(
            got.numpy(), a.astype(np.int64) @ w.astype(np.int64))


def test_im2col_conv_equals_lax_conv():
    """The int8 conv's im2col walk (SAME, explicit, strided, dilated) gives
    the JAX conv's integer sums exactly."""
    rng = np.random.default_rng(1)
    x = rng.integers(-20, 21, (2, 9, 7, 3)).astype(np.int8)
    w = rng.integers(-20, 21, (3, 2, 3, 5)).astype(np.int8)
    for stride, padding, dil in (((1, 1), "SAME", (1, 1)),
                                 ((2, 1), ((1, 2), (0, 1)), (1, 1)),
                                 ((1, 2), "SAME", (2, 1))):
        cols = tq._im2col(torch.from_numpy(x), 3, 2, stride, padding, dil)
        got = tq.int8_matmul(cols.reshape(-1, cols.shape[-1]),
                             tq._product_weight(w, torch.device("cpu")), 5)
        want = lax.conv_general_dilated(
            jnp.asarray(x, jnp.float32), jnp.asarray(w, jnp.float32),
            window_strides=stride, padding=padding, rhs_dilation=dil,
            dimension_numbers=("NHWC", "HWIO", "NHWC"))
        np.testing.assert_array_equal(
            got.numpy().reshape(want.shape), np.asarray(want).astype(
                np.int32))
