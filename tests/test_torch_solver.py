"""Port parity: the line-search solvers (optimize/solver.py) and their
wiring into both facades — the cases of JAX tests/test_solver_wiring.py
on the port, and each solver's first iterate against JAX's on the same
objective, start and data.

Tolerances (f32): a solver's first iterate on Rosenbrock and on an MLP's
loss within 1e-5 of the largest |value| (the line search compares
losses that the two sides sum in other orders; a flip of one Armijo test
would show as a factor of 2 in the step, far outside it).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets.fetchers import load_iris_dataset
from deeplearning4j_tpu.nn.conf import config as jconfig
from deeplearning4j_tpu.nn.conf import layers as jlayers
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu.nn.updater import updaters as jupd
from deeplearning4j_tpu.optimize import solver as jsolver
from deeplearning4j_tpu_torch.datasets.fetchers import \
    load_iris_dataset as tload_iris
from deeplearning4j_tpu_torch.nn.conf import config as tconfig
from deeplearning4j_tpu_torch.nn.conf import layers as tlayers
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph as TGraph
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork as TNet
from deeplearning4j_tpu_torch.nn.updater import updaters as tupd
from deeplearning4j_tpu_torch.optimize import solver as tsolver
from deeplearning4j_tpu_torch.util import model_serializer as tms

ALGOS = ["conjugate_gradient", "lbfgs", "line_gradient_descent",
         "stochastic_gradient_descent"]
REL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(a, b, what, rel=REL):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = max(float(np.abs(b).max(initial=0.0)), 1e-30)
    gap = float(np.abs(a - b).max(initial=0.0))
    assert gap <= rel * scale, f"{what}: max |diff| {gap} > {rel} x {scale}"


def _conf(config, layers, upd, algo, iterations, graph=False):
    b = (config.NeuralNetConfiguration.builder()
         .seed(7).learning_rate(0.1).updater(upd.Sgd())
         .optimization_algo(algo).iterations(iterations)
         .weight_init("xavier"))
    if graph:
        return (b.graph_builder().add_inputs("in")
                .add_layer("d", layers.DenseLayer(n_in=4, n_out=16,
                                                  activation="tanh"), "in")
                .add_layer("out", layers.OutputLayer(
                    n_in=16, n_out=3, activation="softmax",
                    loss="negativeloglikelihood"), "d")
                .set_outputs("out").build())
    return (b.list()
            .layer(layers.DenseLayer(n_in=4, n_out=16, activation="tanh"))
            .layer(layers.OutputLayer(n_in=16, n_out=3, activation="softmax",
                                      loss="negativeloglikelihood"))
            .build())


def _iris_net(algo, iterations):
    return TNet(_conf(tconfig, tlayers, tupd, algo, iterations),
                device="cpu").init()


# -- JAX tests/test_solver_wiring.py, on the port -----------------------------

@pytest.mark.parametrize("algo", ["conjugate_gradient", "lbfgs",
                                  "line_gradient_descent"])
def test_mlp_iris_trains_under_classic_optimizers(algo):
    ds = tload_iris()
    net = _iris_net(algo, iterations=25)
    initial = net.score(x=ds.features, y=ds.labels)
    net.fit(ds.features, ds.labels)
    final = net.score(x=ds.features, y=ds.labels)
    assert np.isfinite(final)
    assert final < initial * 0.7, f"{algo}: score {initial} -> {final}"
    assert net.step == 1


def test_unknown_algo_raises():
    ds = tload_iris()
    net = _iris_net("quantum_annealing", iterations=1)
    with pytest.raises(ValueError, match="optimization_algo"):
        net.fit(ds.features, ds.labels)


def test_tbptt_with_classic_optimizer_raises():
    conf = (tconfig.NeuralNetConfiguration.builder()
            .seed(7).learning_rate(0.05).optimization_algo("lbfgs")
            .list()
            .layer(tlayers.GravesLSTM(n_in=3, n_out=8))
            .layer(tlayers.RnnOutputLayer(n_in=8, n_out=3,
                                          activation="softmax",
                                          loss="negativeloglikelihood"))
            .backprop_type("truncated_bptt")
            .t_bptt_forward_length(5).t_bptt_backward_length(5)
            .build())
    net = TNet(conf, device="cpu").init()
    x = np.random.default_rng(0).normal(size=(4, 10, 3)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[
        np.random.default_rng(1).integers(0, 3, (4, 10))]
    with pytest.raises(NotImplementedError):
        net.fit(x, y)


def test_graph_trains_under_lbfgs():
    ds = tload_iris()
    net = TGraph(_conf(tconfig, tlayers, tupd, "lbfgs", 25, graph=True),
                 device="cpu").init()
    initial = net.score(inputs=[ds.features], labels=[ds.labels])
    net.fit(ds.features, ds.labels)
    final = net.score(inputs=[ds.features], labels=[ds.labels])
    assert np.isfinite(final)
    assert final < initial * 0.7, f"lbfgs graph: {initial} -> {final}"


# -- against JAX --------------------------------------------------------------

def _rosen_jax(p):
    return jnp.sum(100.0 * (p[1:] - p[:-1] ** 2) ** 2 + (1.0 - p[:-1]) ** 2)


def _rosen_torch(p):
    return torch.sum(100.0 * (p[1:] - p[:-1] ** 2) ** 2 + (1.0 - p[:-1]) ** 2)


@pytest.mark.parametrize("algo", ALGOS)
@pytest.mark.parametrize("iterations", [1, 3])
def test_solver_iterates_match_jax_on_rosenbrock(algo, iterations):
    x0 = np.random.default_rng(3).uniform(-1.2, 1.2, 6).astype(np.float32)
    jopt = jsolver.OPTIMIZERS[algo](_rosen_jax, max_iterations=iterations,
                                    learning_rate=1e-3)
    topt = tsolver.OPTIMIZERS[algo](_rosen_torch, max_iterations=iterations,
                                    learning_rate=1e-3)
    jp = jopt.optimize(jnp.asarray(x0))
    tp = topt.optimize(torch.from_numpy(x0))
    _close(tp.numpy(), jp, f"{algo} iterate")
    _close([topt.score_], [jopt.score_], f"{algo} score")


def test_terminations_and_line_search_match_jax():
    d = np.array([0.0, -1e-9, 2.0], np.float32)
    for tc, jc in ((tsolver.EpsTermination(), jsolver.EpsTermination()),
                   (tsolver.Norm2Termination(1.0),
                    jsolver.Norm2Termination(1.0)),
                   (tsolver.ZeroDirection(), jsolver.ZeroDirection())):
        for cost, old in ((1.0, 1.0 + 1e-7), (1.0, 2.0)):
            assert tc.terminate(cost, old, torch.from_numpy(d)) == \
                jc.terminate(cost, old, d)
    x0 = np.array([-1.0, 1.5, 0.3], np.float32)
    g = np.asarray(jsolver.jax.grad(_rosen_jax)(jnp.asarray(x0)))
    for direction in (-g, g):
        js = jsolver.BackTrackLineSearch(_rosen_jax).optimize(
            jnp.asarray(x0), jnp.asarray(g), jnp.asarray(direction))
        ts = tsolver.BackTrackLineSearch(_rosen_torch).optimize(
            torch.from_numpy(x0), torch.from_numpy(g),
            torch.from_numpy(direction))
        assert ts == js


def test_solver_builder():
    opt = (tsolver.Solver().objective(_rosen_torch)
           .optimization_algo("LBFGS").max_iterations(4).learning_rate(0.01)
           .build())
    assert isinstance(opt, tsolver.LBFGS) and opt.max_iterations == 4
    with pytest.raises(ValueError, match="Unknown algorithm"):
        tsolver.Solver().objective(_rosen_torch).optimization_algo(
            "nope").build()
    with pytest.raises(ValueError, match="objective"):
        tsolver.Solver().build()


@pytest.mark.parametrize("algo", ALGOS[:3])
def test_first_iterate_on_a_net_matches_jax(algo):
    """One solver iteration over the whole MLP's flat params (the loss
    plus l2 of the minibatch) from JAX's params: the port's params after
    fit equal JAX's, and so does the score."""
    ds = load_iris_dataset()
    x, y = np.asarray(ds.features), np.asarray(ds.labels)
    jnet = JNet(_conf(jconfig, jlayers, jupd, algo, 1)).init()
    tnet = _iris_net(algo, 1)
    tnet.set_params(tms.params_from_jax(
        [{k: np.asarray(v) for k, v in lp.items()} for lp in jnet.params]))
    jnet.fit(x, y)
    tnet.fit(x, y)
    _close(tnet.params_flat(), jnet.params_flat(), f"{algo} params")
    _close([tnet.score_], [float(jnet.score_)], f"{algo} score")


def test_graph_first_iterate_matches_jax():
    ds = load_iris_dataset()
    x, y = np.asarray(ds.features), np.asarray(ds.labels)
    jg = JGraph(_conf(jconfig, jlayers, jupd, "lbfgs", 1, graph=True)).init()
    tg = TGraph(_conf(tconfig, tlayers, tupd, "lbfgs", 1, graph=True),
                device="cpu").init()
    tg.set_params(tms.params_from_jax(
        {n: {k: np.asarray(v) for k, v in lp.items()}
         for n, lp in jg.params.items()}))
    jg.fit(x, y)
    tg.fit(x, y)
    _close(tg.params_flat(), jg.params_flat(), "params")
    assert tg.step == jg.step == 1
