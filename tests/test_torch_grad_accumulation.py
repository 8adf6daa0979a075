"""Port parity: gradient accumulation (fit_batch_accumulated) on both
facades — the cases of JAX tests/test_grad_accumulation.py on the port,
and the port's accumulated step against JAX's on the same params and
numpy data.

Tolerances (f32): the accumulated update against the full batch with
JAX's own (rtol 2e-5, atol 2e-6 over 5 Adam steps; K = 1: rtol 1e-6);
against JAX's accumulated step within 1e-6 of the largest |param|.
"""
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models import zoo as jzoo
from deeplearning4j_tpu.nn.conf import config as jconfig
from deeplearning4j_tpu.nn.conf import layers as jlayers
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu.nn.updater import updaters as jupd
from deeplearning4j_tpu_torch.models import zoo as tzoo
from deeplearning4j_tpu_torch.nn.conf import config as tconfig
from deeplearning4j_tpu_torch.nn.conf import layers as tlayers
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph as TGraph
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork as TNet
from deeplearning4j_tpu_torch.nn.updater import updaters as tupd
from deeplearning4j_tpu_torch.util import model_serializer as tms


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _conf(config, layers, upd, seed=3, algo=None):
    b = (config.NeuralNetConfiguration.builder()
         .seed(seed).learning_rate(1e-2).updater(upd.Adam())
         .regularization(True).l2(1e-4))
    if algo:
        b = b.optimization_algo(algo)
    return (b.list()
            .layer(layers.DenseLayer(n_in=6, n_out=24, activation="relu"))
            .layer(layers.DenseLayer(n_in=24, n_out=24, activation="tanh"))
            .layer(layers.OutputLayer(n_in=24, n_out=4, activation="softmax",
                                      loss="negativeloglikelihood"))
            .build())


def _net(seed=3, algo=None):
    return TNet(_conf(tconfig, tlayers, tupd, seed, algo),
                device="cpu").init()


def _data(n=64):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((n, 6)).astype(np.float32)
    y = np.eye(4, dtype=np.float32)[rng.integers(0, 4, n)]
    return x, y


def _close(a, b, what, rel=1e-6):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = max(float(np.abs(b).max(initial=0.0)), 1e-30)
    gap = float(np.abs(a - b).max(initial=0.0))
    assert gap <= rel * scale, f"{what}: max |diff| {gap} > {rel} x {scale}"


# -- JAX tests/test_grad_accumulation.py, on the port -------------------------

def test_accumulated_update_equals_full_batch():
    x, y = _data(64)
    a, b = _net(), _net()
    for _ in range(5):
        a.fit_batch(x, y)
        b.fit_batch_accumulated(x, y, accumulation_steps=4)
    np.testing.assert_allclose(a.params_flat(), b.params_flat(),
                               rtol=2e-5, atol=2e-6)
    np.testing.assert_allclose(a.updater_state_flat(),
                               b.updater_state_flat(), rtol=2e-5, atol=2e-6)
    assert a.step == b.step == 5
    assert abs(float(a.score_) - float(b.score_)) < 1e-4


def test_accumulated_k1_equals_fit_batch():
    x, y = _data(32)
    a, b = _net(7), _net(7)
    a.fit_batch(x, y)
    b.fit_batch_accumulated(x, y, accumulation_steps=1)
    np.testing.assert_allclose(a.params_flat(), b.params_flat(),
                               rtol=1e-6, atol=1e-7)


def test_accumulation_rejects_indivisible_batch():
    x, y = _data(30)
    net = _net()
    with pytest.raises(ValueError, match="not divisible"):
        net.fit_batch_accumulated(x, y, accumulation_steps=4)
    with pytest.raises(ValueError, match="must be >= 1"):
        net.fit_batch_accumulated(x, y, accumulation_steps=0)


@pytest.mark.parametrize("kind", ["solver", "iterations"])
def test_accumulation_rejects_solver_configs(kind):
    net = _net(1, algo="lbfgs" if kind == "solver" else None)
    if kind == "iterations":
        net.conf.conf.iterations = 2
    x, y = _data(16)
    with pytest.raises(ValueError, match="SGD-family"):
        net.fit_batch_accumulated(x, y, accumulation_steps=2)
    g = TGraph(tzoo.transformer_lm(vocab_size=5, d_model=8, n_heads=2,
                                   n_blocks=1), device="cpu").init()
    g.conf.conf.iterations = 2
    with pytest.raises(ValueError, match="SGD-family"):
        g.fit_batch_accumulated(np.zeros((4, 3, 5), np.float32),
                                np.zeros((4, 3, 5), np.float32), 2)


def _lm_pair(V=11):
    kw = dict(vocab_size=V, d_model=16, n_heads=2, n_blocks=1)
    jg = JGraph(jzoo.transformer_lm(**kw)).init()
    tg = TGraph(tzoo.transformer_lm(**kw), device="cpu").init()
    tg.set_params(tms.params_from_jax(
        {n: {k: np.asarray(v) for k, v in lp.items()}
         for n, lp in jg.params.items()}))
    return jg, tg


def test_graph_accumulated_equals_full_batch():
    rng = np.random.default_rng(4)
    V, T, B = 11, 8, 16
    x = np.eye(V, dtype=np.float32)[rng.integers(0, V, (B, T))]
    y = np.eye(V, dtype=np.float32)[rng.integers(0, V, (B, T))]
    kw = dict(vocab_size=V, d_model=16, n_heads=2, n_blocks=1)
    a = TGraph(tzoo.transformer_lm(**kw), device="cpu").init()
    b = TGraph(tzoo.transformer_lm(**kw), device="cpu").init()
    for _ in range(3):
        a.fit(x, y)
        b.fit_batch_accumulated(x, y, accumulation_steps=4)
    np.testing.assert_allclose(a.params_flat(), b.params_flat(),
                               rtol=3e-5, atol=3e-6)
    assert a.step == b.step == 3


def test_accumulation_trains_to_accuracy():
    rng = np.random.default_rng(2)
    yid = rng.integers(0, 4, 256)
    x = rng.standard_normal((256, 6)).astype(np.float32) * 0.5
    x += yid[:, None].astype(np.float32)
    y = np.eye(4, dtype=np.float32)[yid]
    net = _net(11)
    for _ in range(60):
        net.fit_batch_accumulated(x, y, accumulation_steps=8)
    assert (net.predict(x) == yid).mean() > 0.9


# -- against JAX's accumulated step -------------------------------------------

def test_accumulated_step_matches_jax():
    x, y = _data(48)
    jnet = JNet(_conf(jconfig, jlayers, jupd)).init()
    tnet = _net()
    tnet.set_params(tms.params_from_jax(
        [{k: np.asarray(v) for k, v in lp.items()} for lp in jnet.params]))
    for _ in range(3):
        jl = jnet.fit_batch_accumulated(x, y, accumulation_steps=3)
        tl = tnet.fit_batch_accumulated(x, y, accumulation_steps=3)
        _close([float(tl)], [float(jl)], "mean loss")
    _close(tnet.params_flat(), jnet.params_flat(), "params")
    _close(tnet.updater_state_flat(), jnet.updater_state_flat(),
           "updater state")


def test_accumulated_batchnorm_statistics_per_microbatch():
    """BatchNorm takes each microbatch's statistics and carries its
    running averages from one microbatch to the next, as JAX's scan."""
    def conf(config, layers, upd):
        return (config.NeuralNetConfiguration.builder().seed(2)
                .learning_rate(0.05).updater(upd.Sgd()).list()
                .layer(layers.DenseLayer(n_in=6, n_out=8,
                                         activation="identity"))
                .layer(layers.BatchNormalization(n_out=8, activation="relu"))
                .layer(layers.OutputLayer(n_in=8, n_out=4,
                                          activation="softmax",
                                          loss="negativeloglikelihood"))
                .build())
    x, y = _data(32)
    jnet = JNet(conf(jconfig, jlayers, jupd)).init()
    tnet = TNet(conf(tconfig, tlayers, tupd), device="cpu").init()
    tnet.set_params(tms.params_from_jax(
        [{k: np.asarray(v) for k, v in lp.items()} for lp in jnet.params]))
    for _ in range(2):
        jnet.fit_batch_accumulated(x, y, accumulation_steps=4)
        tnet.fit_batch_accumulated(x, y, accumulation_steps=4)
    _close(tnet.params_flat(), jnet.params_flat(), "params")
    for k in ("mean", "var"):
        _close(tnet.variables[1][k].numpy(), jnet.variables[1][k],
               f"running {k}")


def test_graph_accumulated_step_matches_jax():
    rng = np.random.default_rng(6)
    x = np.eye(11, dtype=np.float32)[rng.integers(0, 11, (8, 6))]
    y = np.eye(11, dtype=np.float32)[rng.integers(0, 11, (8, 6))]
    jg, tg = _lm_pair()
    for _ in range(2):
        jl = jg.fit_batch_accumulated(x, y, accumulation_steps=2)
        tl = tg.fit_batch_accumulated(x, y, accumulation_steps=2)
        _close([float(tl)], [float(jl)], "mean loss")
    _close(tg.params_flat(), jg.params_flat(), "params")
