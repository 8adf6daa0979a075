"""Port parity: numerical gradient checks (util/gradientcheck.py).

The sweeps of the JAX package's tests/test_gradientcheck.py, each
parametrised case kept as a case, run on the port at float64 on the CPU
with the JAX (and reference) tolerances: central differences with eps
1e-6 against `torch.autograd.grad`, max relative error 1e-3, min
absolute error 1e-9. Then the port's analytic gradient against JAX's
`jax.grad` of the same loss on the same float64 params and inputs, for a
conv + BatchNorm + dense net and a masked GravesLSTM net: max |diff| <=
1e-9 x max |JAX gradient| (float64 sums in another order).
"""
import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.nn.conf.config import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import (
    ActivationLayer, BatchNormalization, ConvolutionLayer, DenseLayer,
    EmbeddingLayer, GlobalPoolingLayer, GravesBidirectionalLSTM, GravesLSTM,
    GRU, LSTM, LayerNormalization, LocalResponseNormalization, OutputLayer,
    RnnOutputLayer, SelfAttentionLayer, SubsamplingLayer)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.updater.updaters import Sgd
from deeplearning4j_tpu_torch.util import check_gradients
from deeplearning4j_tpu_torch.util.gradientcheck import analytic_gradient

EPS = 1e-6
MAX_REL = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tier-1 runs several test files at once on a few cores; one torch
    intra-op thread keeps this file from starving the others' timings."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _net(*layers, input_type=None, l1=0.0, l2=0.0, seed=42):
    b = (NeuralNetConfiguration.builder().seed(seed).dtype("float64")
         .updater(Sgd()).regularization(l1 > 0 or l2 > 0).l1(l1).l2(l2)
         .list())
    for layer in layers:
        b.layer(layer)
    if input_type is not None:
        b.set_input_type(input_type)
    return MultiLayerNetwork(b.build(), device="cpu").init()


def _rand(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape)


def _onehot(n, c, seed=1):
    rng = np.random.default_rng(seed)
    y = np.zeros((n, c))
    y[np.arange(n), rng.integers(0, c, n)] = 1.0
    return y


@pytest.mark.parametrize("act,loss,out_act", [
    ("tanh", "mse", "identity"),
    ("relu", "negativeloglikelihood", "softmax"),
    ("sigmoid", "xent", "sigmoid"),
    ("elu", "mcxent", "softmax"),
])
def test_mlp_gradients(act, loss, out_act):
    net = _net(DenseLayer(n_in=4, n_out=5, activation=act),
               OutputLayer(n_in=5, n_out=3, activation=out_act, loss=loss))
    x = _rand((6, 4))
    y = (_onehot(6, 3) if out_act == "softmax"
         else np.abs(_rand((6, 3), 2)) % 1.0 if out_act == "sigmoid"
         else _rand((6, 3), 2))
    assert check_gradients(net, x, y, EPS, MAX_REL)


def test_mlp_l1_l2_gradients():
    net = _net(DenseLayer(n_in=4, n_out=5, activation="tanh"),
               OutputLayer(n_in=5, n_out=3, activation="softmax",
                           loss="negativeloglikelihood"),
               l1=0.01, l2=0.02)
    assert check_gradients(net, _rand((5, 4)), _onehot(5, 3), EPS, MAX_REL)


def test_cnn_gradients():
    net = _net(ConvolutionLayer(n_out=3, kernel_size=(2, 2), stride=(1, 1),
                                activation="tanh"),
               SubsamplingLayer(pooling_type="max", kernel_size=(2, 2),
                                stride=(2, 2)),
               OutputLayer(n_out=2, activation="softmax",
                           loss="negativeloglikelihood"),
               input_type=InputType.convolutional(6, 6, 2))
    assert check_gradients(net, _rand((4, 6, 6, 2)), _onehot(4, 2), EPS,
                           MAX_REL)


def test_cnn_avgpool_gradients():
    net = _net(ConvolutionLayer(n_out=2, kernel_size=(3, 3), padding=(1, 1),
                                activation="sigmoid"),
               SubsamplingLayer(pooling_type="avg", kernel_size=(2, 2),
                                stride=(2, 2)),
               OutputLayer(n_out=3, activation="softmax", loss="mcxent"),
               input_type=InputType.convolutional(4, 4, 1))
    assert check_gradients(net, _rand((3, 4, 4, 1)), _onehot(3, 3), EPS,
                           MAX_REL)


def test_batchnorm_gradients():
    net = _net(DenseLayer(n_in=4, n_out=6, activation="identity"),
               BatchNormalization(),
               ActivationLayer(activation="relu"),
               OutputLayer(n_in=6, n_out=3, activation="softmax",
                           loss="negativeloglikelihood"))
    assert check_gradients(net, _rand((8, 4)), _onehot(8, 3), EPS, MAX_REL)


def test_lrn_gradients():
    net = _net(ConvolutionLayer(n_out=4, kernel_size=(2, 2),
                                activation="relu"),
               LocalResponseNormalization(),
               OutputLayer(n_out=2, activation="softmax", loss="mcxent"),
               input_type=InputType.convolutional(5, 5, 1))
    assert check_gradients(net, np.abs(_rand((3, 5, 5, 1))), _onehot(3, 2),
                           EPS, MAX_REL)


@pytest.mark.parametrize("rnn_layer", [
    lambda: GravesLSTM(n_in=3, n_out=4, activation="tanh"),
    lambda: LSTM(n_in=3, n_out=4, activation="tanh"),
    lambda: GRU(n_in=3, n_out=4, activation="tanh"),
    lambda: GravesBidirectionalLSTM(n_in=3, n_out=4, activation="tanh"),
], ids=["graves_lstm", "lstm", "gru", "graves_bidirectional"])
def test_rnn_gradients(rnn_layer):
    net = _net(rnn_layer(),
               RnnOutputLayer(n_in=4, n_out=2, activation="softmax",
                              loss="mcxent"))
    B, T = 3, 5
    y = np.zeros((B, T, 2))
    rng = np.random.default_rng(3)
    y[np.arange(B)[:, None], np.arange(T)[None, :],
      rng.integers(0, 2, (B, T))] = 1.0
    assert check_gradients(net, _rand((B, T, 3)), y, EPS, MAX_REL)


def _masked_lstm():
    net = _net(GravesLSTM(n_in=3, n_out=4, activation="tanh"),
               RnnOutputLayer(n_in=4, n_out=2, activation="softmax",
                              loss="mcxent"))
    B, T = 3, 5
    y = np.zeros((B, T, 2))
    y[:, :, 0] = 1.0
    mask = np.ones((B, T))
    mask[0, 3:] = 0
    mask[1, 1:] = 0
    return net, _rand((B, T, 3)), y, dict(fmask=mask, lmask=mask)


def test_rnn_masking_gradients():
    net, x, y, masks = _masked_lstm()
    assert check_gradients(net, x, y, EPS, MAX_REL, **masks)


def test_embedding_gradients():
    net = _net(EmbeddingLayer(n_in=7, n_out=4, activation="identity"),
               OutputLayer(n_in=4, n_out=3, activation="softmax",
                           loss="negativeloglikelihood"))
    x = np.random.default_rng(5).integers(0, 7, (6, 1))
    assert check_gradients(net, x, _onehot(6, 3), EPS, MAX_REL)


def test_global_pooling_gradients():
    net = _net(GravesLSTM(n_in=3, n_out=4, activation="tanh"),
               GlobalPoolingLayer(pooling_type="avg"),
               OutputLayer(n_in=4, n_out=2, activation="softmax",
                           loss="mcxent"))
    assert check_gradients(net, _rand((3, 4, 3)), _onehot(3, 2), EPS,
                           MAX_REL)


def test_self_attention_gradients():
    """The attention seam's kernels (and their plain versions on the CPU)
    take f32 and bf16 only, and raise on float64 as on any other dtype;
    the seam's default, the JAX package's dense path, is registered for
    this case, as a float64 caller does."""
    from deeplearning4j_tpu_torch.ops import helpers
    helpers.register_helper("attention", helpers._attention_default)
    try:
        _self_attention_case()
    finally:
        helpers.register_helper("attention", None)


def _self_attention_case():
    net = _net(SelfAttentionLayer(n_in=4, n_out=8, n_heads=2, causal=True,
                                  activation="identity"),
               GlobalPoolingLayer(pooling_type="avg"),
               OutputLayer(n_in=8, n_out=3, activation="softmax",
                           loss="negativeloglikelihood"))
    assert check_gradients(net, _rand((3, 5, 4)), _onehot(3, 3),
                           epsilon=EPS, max_rel_error=MAX_REL)


def test_layer_norm_gradients():
    net = _net(DenseLayer(n_in=4, n_out=6, activation="identity"),
               LayerNormalization(n_in=6, n_out=6, activation="tanh"),
               OutputLayer(n_in=6, n_out=3, activation="softmax",
                           loss="mcxent"))
    assert check_gradients(net, _rand((8, 4)), _onehot(8, 3),
                           epsilon=EPS, max_rel_error=MAX_REL)


def _conv_bn_dense():
    net = _net(ConvolutionLayer(n_out=3, kernel_size=(2, 2),
                                activation="identity"),
               BatchNormalization(activation="relu"),
               DenseLayer(n_out=5, activation="tanh"),
               OutputLayer(n_out=2, activation="softmax",
                           loss="negativeloglikelihood"),
               input_type=InputType.convolutional(6, 6, 2), l2=0.01)
    return net, _rand((4, 6, 6, 2)), _onehot(4, 2), {}


def test_conv_bn_dense_gradients():
    """The conv + BN + dense net of chip_smoke.py phase 30d."""
    net, x, y, masks = _conv_bn_dense()
    assert check_gradients(net, x, y, EPS, MAX_REL, **masks)


def test_a_wrong_gradient_fails():
    """The check is not vacuous: a scaled analytic gradient fails it."""
    from deeplearning4j_tpu_torch.util import gradientcheck as gc
    net = _net(DenseLayer(n_in=4, n_out=5, activation="tanh"),
               OutputLayer(n_in=5, n_out=3, activation="softmax",
                           loss="mcxent"))
    real = gc.analytic_gradient
    gc.analytic_gradient = lambda *a, **k: 1.01 * real(*a, **k)
    try:
        assert not check_gradients(net, _rand((6, 4)), _onehot(6, 3), EPS,
                                   MAX_REL)
    finally:
        gc.analytic_gradient = real


@pytest.mark.parametrize("make", [_conv_bn_dense, _masked_lstm],
                         ids=["conv_bn_dense", "masked_graves_lstm"])
def test_analytic_gradient_equals_jax_grad(make):
    from deeplearning4j_tpu.nn.conf.config import MultiLayerConfiguration
    from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
    import jax.numpy as jnp
    tnet, x, y, masks = make()
    jax.config.update("jax_enable_x64", True)
    try:
        jnet = JMLN(MultiLayerConfiguration.from_json(
            tnet.conf.to_json())).init()
        tnet.set_params([{k: np.asarray(a) for k, a in lp.items()}
                         for lp in jnet.params])
        fm = masks.get("fmask")
        lm = masks.get("lmask")
        fm = None if fm is None else jnp.asarray(fm)
        lm = None if lm is None else jnp.asarray(lm)

        def loss(params):
            acts = jnet._forward_impl(params, jnet.variables, jnp.asarray(x),
                                      train=False, rng=None, fmask=fm)[0]
            out = jnet._loss_from_output(acts[-1], jnp.asarray(y), lm)
            for impl, p in zip(jnet._impls, params):
                out = out + impl.reg_loss(p)
            return out
        g = jax.grad(loss)(jnet.params)
        want = np.concatenate([np.asarray(lp[k], np.float64).reshape(-1)
                               for lp in g for k in sorted(lp)])
    finally:
        jax.config.update("jax_enable_x64", False)
    got = analytic_gradient(tnet, x, y, **masks)
    assert got.dtype == np.float64 and got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-9 * np.abs(want).max()
