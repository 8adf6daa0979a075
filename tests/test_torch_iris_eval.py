"""Port parity: MLP-Iris and evaluation — the port's Iris loader against
the JAX package's (which reads scikit-learn's copy of the same CSV),
`Evaluation` / `RegressionEvaluation` against the JAX copies on the same
arrays, MLP-Iris trained in both packages from the same params, the
CLI's ``test`` against JAX's ``cmd_test`` on the same zip and CSV,
`evaluate` on a ComputationGraph, and the cases of the JAX package's
tests/test_mlp_iris.py run on the port.

Tolerances: the Iris arrays, the metrics, ``stats()`` and the CLI's
output are exact (the same numpy code on the same arrays); MLP-Iris
after 60 Adam epochs (180 steps at lr 0.01): the same confusion matrix,
and params within 1e-5 (Adam moves each param by about lr a step
whatever the gradient's size, so the f32 differences of 180 steps of
sums taken in other orders add up; measured 3.3e-7).
"""
import contextlib
import io

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.cli import main as jcli
from deeplearning4j_tpu.datasets import fetchers as jfetch
from deeplearning4j_tpu.datasets.iterators import (
    ListDataSetIterator as JListIt, MultipleEpochsIterator as JEpochs)
from deeplearning4j_tpu.evaluation import evaluation as jev
from deeplearning4j_tpu.nn.conf import config as jconfig
from deeplearning4j_tpu.nn.conf import layers as jl
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu.nn.updater import updaters as jupd
from deeplearning4j_tpu_torch.cli import main as tcli
from deeplearning4j_tpu_torch.datasets import fetchers as tfetch
from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.datasets.iterators import (
    ListDataSetIterator, MultipleEpochsIterator)
from deeplearning4j_tpu_torch.evaluation import evaluation as tev
from deeplearning4j_tpu_torch.models import zoo as tzoo
from deeplearning4j_tpu_torch.nn.conf import config as tconfig
from deeplearning4j_tpu_torch.nn.conf import layers as tl
from deeplearning4j_tpu_torch.nn.conf.config import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.conf.graph import \
    ComputationGraphConfiguration
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph as TGraph
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork as TNet
from deeplearning4j_tpu_torch.nn.updater import updaters as tupd
from deeplearning4j_tpu_torch.util import model_serializer as tms


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tier-1 runs several test files at once on a few cores; one torch
    intra-op thread keeps this file from starving the others' timings."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- Iris ----------------------------------------------------------------------

@pytest.mark.parametrize("seed", [12345, None, 7])
def test_load_iris_dataset_equals_jax_bit_for_bit(seed):
    want = jfetch.load_iris_dataset(seed)
    got = tfetch.load_iris_dataset(seed)
    assert got.features.dtype == want.features.dtype == np.float32
    assert got.labels.dtype == want.labels.dtype
    np.testing.assert_array_equal(got.features, want.features)
    np.testing.assert_array_equal(got.labels, want.labels)
    assert got.features.shape == (150, 4) and got.labels.shape == (150, 3)


def test_iris_iterator_and_one_hot_equal_jax():
    want = [(d.features, d.labels)
            for d in jfetch.IrisDataSetIterator(batch=40, num_examples=110)]
    got = [(d.features, d.labels)
           for d in tfetch.IrisDataSetIterator(batch=40, num_examples=110)]
    assert [a.shape for a, _ in got] == [(40, 4), (40, 4), (30, 4)]
    for (gf, gl), (wf, wl) in zip(got, want):
        np.testing.assert_array_equal(gf, wf)
        np.testing.assert_array_equal(gl, wl)
    lab = np.array([2, 0, 1, 1])
    np.testing.assert_array_equal(tfetch.one_hot(lab, 4),
                                  jfetch.one_hot(lab, 4))


def test_iris_csv_is_packaged():
    assert tfetch.IRIS_CSV.is_file()
    assert tfetch.IRIS_CSV.read_text().splitlines()[0].startswith("150,4,")


# -- Evaluation ----------------------------------------------------------------

def _cls_arrays(seed, shape, c=4):
    rng = np.random.default_rng(seed)
    labels = np.eye(c, dtype=np.float32)[rng.integers(0, c, shape)]
    preds = rng.random(shape + (c,)).astype(np.float32)
    return labels, preds


EVAL_CASES = {
    "plain": dict(shape=(40,), mask=False, top_n=1),
    "top_3": dict(shape=(40,), mask=False, top_n=3),
    "row_mask": dict(shape=(40,), mask=True, top_n=2),
    "time_series_mask": dict(shape=(5, 8), mask=True, top_n=1),
    "time_series": dict(shape=(5, 8), mask=False, top_n=3),
}


@pytest.mark.parametrize("case", list(EVAL_CASES))
def test_evaluation_equals_jax(case):
    c = EVAL_CASES[case]
    evs = (jev.Evaluation(top_n=c["top_n"]), tev.Evaluation(top_n=c["top_n"]))
    for seed in (1, 2):  # two batches: the matrix accumulates
        labels, preds = _cls_arrays(seed, c["shape"])
        mask = None
        if c["mask"]:
            mask = (np.random.default_rng(seed + 10).random(c["shape"])
                    > 0.3).astype(np.float32)
        for ev in evs:
            ev.eval(labels, preds, mask=mask)
    want, got = evs
    np.testing.assert_array_equal(got.confusion.matrix,
                                  want.confusion.matrix)
    assert got.stats() == want.stats()
    for name in ("accuracy", "top_n_accuracy", "precision", "recall", "f1"):
        assert getattr(got, name)() == getattr(want, name)(), name
    for k in range(4):
        for name in ("precision", "recall", "f1", "false_positive_rate"):
            assert getattr(got, name)(k) == getattr(want, name)(k), (name, k)


@pytest.mark.parametrize("mask", [False, True])
def test_regression_evaluation_equals_jax(mask):
    evs = (jev.RegressionEvaluation(), tev.RegressionEvaluation())
    for seed in (3, 4):
        rng = np.random.default_rng(seed)
        labels = rng.normal(size=(30, 3)).astype(np.float32)
        preds = (labels + 0.3 * rng.normal(size=(30, 3))).astype(np.float32)
        m = (rng.random(30) > 0.4).astype(np.float32) if mask else None
        for ev in evs:
            ev.eval(labels, preds, mask=m)
    want, got = evs
    assert got.stats() == want.stats()
    for col in range(3):
        for name in ("mean_squared_error", "mean_absolute_error",
                     "root_mean_squared_error", "r_squared",
                     "pearson_correlation"):
            assert getattr(got, name)(col) == getattr(want, name)(col)


# -- MLP-Iris --------------------------------------------------------------------

def _iris_conf(ns, updater, lr=0.1, seed=12345):
    """JAX tests/test_mlp_iris.py `build_iris_net`'s config."""
    return (ns.config.NeuralNetConfiguration.builder()
            .seed(seed).learning_rate(lr).updater(updater)
            .weight_init("xavier")
            .list()
            .layer(ns.layers.DenseLayer(n_in=4, n_out=16, activation="tanh"))
            .layer(ns.layers.DenseLayer(n_out=16, n_in=16, activation="relu"))
            .layer(ns.layers.OutputLayer(n_in=16, n_out=3,
                                         activation="softmax",
                                         loss="negativeloglikelihood"))
            .build())


class _NS:
    def __init__(self, config, layers):
        self.config, self.layers = config, layers


JNS, TNS = _NS(jconfig, jl), _NS(tconfig, tl)


def test_mlp_iris_accuracy_and_confusion_match_jax():
    """test_iris_accuracy's recipe (Adam, lr 0.01, 60 epochs of batch 50)
    in both packages from the same params."""
    jnet = JNet(_iris_conf(JNS, jupd.Adam(), lr=0.01)).init()
    tnet = TNet(MultiLayerConfiguration.from_json(jnet.conf.to_json()),
                device="cpu").init()
    tnet.set_params(tms.params_from_jax(
        [{k: np.asarray(v) for k, v in lp.items()} for lp in jnet.params]))
    jnet.fit(JEpochs(60, jfetch.IrisDataSetIterator(batch=50)))
    tnet.fit(MultipleEpochsIterator(60, tfetch.IrisDataSetIterator(batch=50)))
    assert tnet.step == jnet.step == 180
    np.testing.assert_allclose(tnet.params_flat(),
                               np.asarray(jnet.params_flat()), rtol=0,
                               atol=1e-5)
    jev_ = jnet.evaluate(jfetch.IrisDataSetIterator(batch=150))
    tev_ = tnet.evaluate(tfetch.IrisDataSetIterator(batch=150))
    assert tev_.accuracy() > 0.9, tev_.stats()
    np.testing.assert_array_equal(tev_.confusion.matrix,
                                  jev_.confusion.matrix)
    assert tev_.stats() == jev_.stats()
    top2 = tnet.evaluate(tfetch.IrisDataSetIterator(batch=50), top_n=2)
    assert top2.top_n_accuracy() >= tev_.accuracy()


def test_zoo_mlp_iris_trains_on_iris():
    net = TNet(tzoo.mlp_iris(), device="cpu").init()
    net.fit(MultipleEpochsIterator(40, tfetch.IrisDataSetIterator(batch=50)))
    assert net.evaluate(tfetch.IrisDataSetIterator()).accuracy() > 0.9


def test_evaluate_regression_matches_jax():
    conf = (jconfig.NeuralNetConfiguration.builder().seed(3)
            .learning_rate(0.05).updater(jupd.Sgd()).list()
            .layer(jl.DenseLayer(n_in=4, n_out=8, activation="tanh"))
            .layer(jl.OutputLayer(n_in=8, n_out=2, activation="identity",
                                  loss="mse")).build())
    jnet = JNet(conf).init()
    tnet = TNet(MultiLayerConfiguration.from_json(conf.to_json()),
                device="cpu").init()
    tnet.set_params(tms.params_from_jax(
        [{k: np.asarray(v) for k, v in lp.items()} for lp in jnet.params]))
    rng = np.random.default_rng(5)
    x = rng.normal(size=(24, 4)).astype(np.float32)
    y = rng.normal(size=(24, 2)).astype(np.float32)
    from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
    want = jnet.evaluate_regression(JListIt(JDataSet(x, y), batch=10))
    got = tnet.evaluate_regression(ListDataSetIterator(DataSet(x, y),
                                                       batch=10))
    for col in range(2):
        assert got.mean_squared_error(col) == pytest.approx(
            want.mean_squared_error(col), rel=1e-5)
        assert got.r_squared(col) == pytest.approx(want.r_squared(col),
                                                   rel=1e-4, abs=1e-6)


def test_graph_evaluate_matches_multilayer():
    """A graph in -> dense -> out on the same params as the MLP gives the
    same Evaluation."""
    mnet = TNet(tzoo.mlp_iris(), device="cpu").init()
    gconf = (tconfig.NeuralNetConfiguration.builder().seed(1)
             .learning_rate(0.1).updater(tupd.Sgd()).graph_builder()
             .add_inputs("in")
             .add_layer("d", tl.DenseLayer(n_in=4, n_out=16,
                                           activation="tanh"), "in")
             .add_layer("out", tl.OutputLayer(n_in=16, n_out=3,
                                              activation="softmax",
                                              loss="negativeloglikelihood"),
                        "d")
             .set_outputs("out").build())
    gnet = TGraph(ComputationGraphConfiguration.from_json(gconf.to_json()),
                  device="cpu").init()
    gnet.set_params({"d": mnet.params[0], "out": mnet.params[1]})
    a = mnet.evaluate(tfetch.IrisDataSetIterator(batch=40))
    b = gnet.evaluate(tfetch.IrisDataSetIterator(batch=40))
    np.testing.assert_array_equal(a.confusion.matrix, b.confusion.matrix)
    r = gnet.evaluate_regression(tfetch.IrisDataSetIterator(batch=40))
    assert r.n_columns == 3 and np.isfinite(r.mean_squared_error(0))


# -- the CLI's test command ------------------------------------------------------

def _run(fn, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert fn(argv) == 0
    return buf.getvalue()


def test_cli_test_prints_the_stats_of_jax_cmd_test(tmp_path):
    ds = tfetch.load_iris_dataset()
    csv = tmp_path / "iris.csv"
    rows = np.concatenate([ds.features, ds.labels.argmax(1)[:, None]], 1)
    csv.write_text("\n".join(",".join(repr(float(v)) if i < 4 else
                                      str(int(v)) for i, v in enumerate(r))
                             for r in rows) + "\n")
    net = TNet(tzoo.mlp_iris(), device="cpu").init()
    net.fit(MultipleEpochsIterator(10, tfetch.IrisDataSetIterator(batch=50)))
    zpath = tmp_path / "mlp.zip"
    tms.write_model(net, zpath)
    args = ["test", "--model", str(zpath), "--input", str(csv),
            "--num-classes", "3", "--batch", "40"]
    want = _run(jcli.main, args)
    got = _run(tcli.main, args + ["--device", "cpu"])
    assert got == want
    assert "Accuracy" in got and "Confusion matrix" in got


# -- the cases of the JAX package's tests/test_mlp_iris.py, on the port ----------

def _build_iris_net(updater=None, lr=0.1, seed=12345):
    return TNet(_iris_conf(TNS, updater or tupd.Sgd(), lr=lr, seed=seed),
                device="cpu").init()


def _case_score_decreases():
    net = _build_iris_net(lr=0.1)
    ds = tfetch.load_iris_dataset()
    initial = net.score(x=ds.features, y=ds.labels)
    net.fit(MultipleEpochsIterator(30, ListDataSetIterator(ds, batch=50)))
    final = net.score(x=ds.features, y=ds.labels)
    assert final < initial * 0.5, (initial, final)


def _case_iris_accuracy():
    net = _build_iris_net(updater=tupd.Adam(), lr=0.01)
    net.fit(MultipleEpochsIterator(60, tfetch.IrisDataSetIterator(batch=50)))
    ev = net.evaluate(tfetch.IrisDataSetIterator(batch=150))
    assert ev.accuracy() > 0.9, ev.stats()
    assert 0.0 < ev.f1() <= 1.0


def _case_output_shapes_and_predict():
    net = _build_iris_net()
    x = np.random.default_rng(0).normal(size=(7, 4)).astype(np.float32)
    out = net.output(x)
    assert tuple(out.shape) == (7, 3)
    np.testing.assert_allclose(out.numpy().sum(axis=1), 1.0, rtol=1e-4)
    assert net.predict(x).shape == (7,)
    acts = net.feed_forward(x)
    assert len(acts) == 4 and tuple(acts[1].shape) == (7, 16)


def _case_deterministic_init_with_seed():
    a = _build_iris_net(seed=99).params_flat()
    b = _build_iris_net(seed=99).params_flat()
    c = _build_iris_net(seed=100).params_flat()
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)


def _case_fit_xy_arrays_and_score():
    net = _build_iris_net(lr=0.5)
    ds = tfetch.load_iris_dataset()
    s0 = net.score(x=ds.features, y=ds.labels)
    for _ in range(20):
        net.fit(ds.features, ds.labels)
    assert net.score_ < s0
    assert net.num_params() == 4 * 16 + 16 + 16 * 16 + 16 + 16 * 3 + 3


def _case_params_flat_roundtrip():
    net = _build_iris_net()
    flat = net.params_flat()
    net2 = _build_iris_net(seed=777)
    net2.set_params_flat(flat)
    np.testing.assert_array_equal(net2.params_flat(), flat)
    x = np.ones((3, 4), np.float32)
    np.testing.assert_allclose(net.output(x).numpy(), net2.output(x).numpy(),
                               rtol=1e-6)


JAX_IRIS_CASES = {
    "score_decreases": _case_score_decreases,
    "iris_accuracy": _case_iris_accuracy,
    "output_shapes_and_predict": _case_output_shapes_and_predict,
    "deterministic_init_with_seed": _case_deterministic_init_with_seed,
    "fit_xy_arrays_and_score": _case_fit_xy_arrays_and_score,
    "params_flat_roundtrip": _case_params_flat_roundtrip,
}


@pytest.mark.parametrize("case", list(JAX_IRIS_CASES))
def test_jax_mlp_iris_suite_case_on_the_port(case):
    JAX_IRIS_CASES[case]()
