"""Port parity: early stopping (earlystopping/earlystopping.py) and the
iteration listeners (optimize/listeners.py).

The five cases of the JAX package's tests/test_earlystopping_listeners.py
run on the port, each beside the JAX trainer on the same Iris split, the
same initial params (the JAX net's, carried with `params_from_jax`) and
the same minibatches: the same termination reason, epochs and best
epoch, each epoch's held-out score within 1e-5 (relative; f32 sums in
another order over up to 24 Adam steps), and the saved best params
within 1e-5. The listeners: the JAX
cases of tests/test_sampling_eval_extras.py:80-150 for
`PolyakAveragingListener` (the EMA against a hand-computed one, rtol
1e-6), its EMA under `fit_scan` against the JAX listener's (one update
per chunk on both sides, within 1e-6), and the other three listeners'
output. Then a ComputationGraph under `LocalFileModelSaver`: the best
model restores as a graph with the saved params bit for bit, where the
JAX saver reads every zip as a MultiLayerNetwork.
"""
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets.fetchers import \
    load_iris_dataset as jload_iris
from deeplearning4j_tpu.datasets.iterators import ListDataSetIterator as JIt
from deeplearning4j_tpu.earlystopping import earlystopping as jes
from deeplearning4j_tpu.nn.conf.config import MultiLayerConfiguration as JMLC
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.optimize import listeners as jlis
from deeplearning4j_tpu_torch.datasets.fetchers import load_iris_dataset
from deeplearning4j_tpu_torch.datasets.iterators import ListDataSetIterator
from deeplearning4j_tpu_torch.earlystopping import earlystopping as tes
from deeplearning4j_tpu_torch.nn.conf.config import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.layers import DenseLayer, OutputLayer
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.updater.updaters import Adam
from deeplearning4j_tpu_torch.optimize import listeners as tlis
from deeplearning4j_tpu_torch.util import model_serializer as tms


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tier-1 runs several test files at once on a few cores; one torch
    intra-op thread keeps this file from starving the others' timings."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _conf(lr=0.05):
    return (NeuralNetConfiguration.builder()
            .seed(1).learning_rate(lr).updater(Adam())
            .list()
            .layer(DenseLayer(n_in=4, n_out=12, activation="tanh"))
            .layer(OutputLayer(n_in=12, n_out=3, activation="softmax",
                               loss="negativeloglikelihood"))
            .build())


def _pair(lr=0.05):
    """(JAX net, port net on the CPU with the JAX net's params)."""
    conf = _conf(lr)
    jnet = JMLN(JMLC.from_json(conf.to_json())).init()
    tnet = MultiLayerNetwork(conf, device="cpu").init()
    tnet.set_params(tms.params_from_jax(
        [{k: np.asarray(a) for k, a in lp.items()} for lp in jnet.params]))
    return jnet, tnet


def _both(make_config, train_split=None, batch=40, score_batch=30):
    """Run the JAX and the port trainer on the same data: the results."""
    out = []
    for es, load, It in ((jes, jload_iris, JIt),
                         (tes, load_iris_dataset, ListDataSetIterator)):
        ds = load()
        if train_split:
            train, test = ds.split_test_and_train(train_split)
        else:
            train = test = ds
        out.append((es, It(train, batch), It(test, score_batch)))
    jnet, tnet = _pair()
    results = []
    for (es, train_it, test_it), net in zip(out, (jnet, tnet)):
        cfg = make_config(es, test_it)
        results.append(es.EarlyStoppingTrainer(cfg, net, train_it).fit())
    return results


def _same(jr, tr):
    assert tr.termination_reason == jr.termination_reason
    assert tr.termination_details == jr.termination_details
    assert tr.total_epochs == jr.total_epochs
    assert tr.best_model_epoch == jr.best_model_epoch
    assert sorted(tr.score_vs_epoch) == sorted(jr.score_vs_epoch)
    for e, s in jr.score_vs_epoch.items():
        assert abs(tr.score_vs_epoch[e] - s) <= 1e-5 * max(1.0, abs(s)), e


def test_early_stopping_max_epochs():
    def cfg(es, test_it):
        return es.EarlyStoppingConfiguration(
            score_calculator=es.DataSetLossCalculator(test_it),
            model_saver=es.InMemoryModelSaver(),
            epoch_termination_conditions=[
                es.MaxEpochsTerminationCondition(8)])
    jr, tr = _both(cfg, train_split=120)
    _same(jr, tr)
    assert tr.termination_reason == "EpochTerminationCondition"
    assert tr.total_epochs == 8
    assert tr.best_model is not None and tr.best_model_score < 1.5
    test = load_iris_dataset().split_test_and_train(120)[1]
    ev = tr.best_model.evaluate(ListDataSetIterator(test, 30))
    assert ev.accuracy() > 0.5
    # the best model is a clone: its score is the best epoch's
    assert abs(tr.best_model.score(test) - tr.best_model_score) <= 1e-6


def test_early_stopping_patience():
    def cfg(es, test_it):
        return es.EarlyStoppingConfiguration(
            score_calculator=es.DataSetLossCalculator(test_it),
            epoch_termination_conditions=[
                es.MaxEpochsTerminationCondition(100),
                es.ScoreImprovementEpochTerminationCondition(
                    2, min_improvement=1e9)])
    jr, tr = _both(cfg, train_split=120)
    _same(jr, tr)
    assert tr.total_epochs <= 5


def test_early_stopping_score_explosion():
    def cfg(es, test_it):
        return es.EarlyStoppingConfiguration(
            score_calculator=es.DataSetLossCalculator(test_it),
            epoch_termination_conditions=[
                es.MaxEpochsTerminationCondition(50)],
            iteration_termination_conditions=[
                es.MaxScoreIterationTerminationCondition(1e-12)])
    jr, tr = _both(cfg, batch=50, score_batch=50)
    _same(jr, tr)
    assert tr.termination_reason == "IterationTerminationCondition"


def test_local_file_saver_roundtrip(tmp_path):
    def cfg(es, test_it):
        d = tmp_path / ("jax" if es is jes else "port")
        return es.EarlyStoppingConfiguration(
            score_calculator=es.DataSetLossCalculator(test_it),
            model_saver=es.LocalFileModelSaver(str(d)),
            epoch_termination_conditions=[
                es.MaxEpochsTerminationCondition(3)])
    jr, tr = _both(cfg, batch=50, score_batch=50)
    _same(jr, tr)
    assert (tmp_path / "port" / "bestModel.zip").exists()
    best = tr.best_model
    assert isinstance(best, MultiLayerNetwork)
    assert best.num_params() == 4 * 12 + 12 + 12 * 3 + 3
    assert np.abs(best.params_flat()
                  - jr.best_model.params_flat()).max() <= 1e-5


def test_listeners_fire():
    ds = load_iris_dataset()
    _, net = _pair()
    collect = tlis.CollectScoresIterationListener()
    timer = tlis.TimeIterationListener()
    seen, stats = [], []
    score_listener = tlis.ScoreIterationListener(
        print_iterations=2, log_fn=seen.append)
    pg = tlis.ParamAndGradientIterationListener(iterations=3,
                                                log_fn=stats.append)
    net.set_listeners(tlis.ComposableIterationListener(collect, timer, pg),
                      score_listener)
    for _ in range(6):
        net.fit(ds.features[:50], ds.labels[:50])
    assert len(collect.scores) == 6
    assert len(timer.times) == 6 and timer.mean_iteration_seconds() > 0
    assert sum("Score at iteration" in m for m in seen) == 3
    assert len(stats) == 2 and "L0.W: mean=" in stats[0]
    scores = [s for _, s in collect.scores]
    assert scores[-1] < scores[0]
    # the JAX listener logs the same lines for the same params
    jnet, _ = _pair()
    jnet.params = [{k: np.asarray(v) for k, v in lp.items()}
                   for lp in [{k: t.numpy() for k, t in lp.items()}
                              for lp in net.params]]
    jnet.score_ = net.score_
    jlines = []
    jlis.ParamAndGradientIterationListener(
        iterations=1, log_fn=jlines.append).iteration_done(jnet, 6)
    tlines = []
    tlis.ParamAndGradientIterationListener(
        iterations=1, log_fn=tlines.append).iteration_done(net, 6)
    assert tlines[0].splitlines()[1:] == jlines[0].splitlines()[1:]


# -- Polyak / EMA weights ----------------------------------------------------

def _iris_mlp(seed=4, n=32):
    from deeplearning4j_tpu_torch.models.zoo import mlp_iris
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 4)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, n)]
    return MultiLayerNetwork(mlp_iris(), device="cpu").init(), x, y


def test_ema_listener_exact_math_and_swap():
    net, x, y = _iris_mlp()
    ema = tlis.PolyakAveragingListener(decay=0.5)
    net.set_listeners(ema)
    manual = None
    for _ in range(4):
        net.fit_batch(x, y)
        p = net.params_flat()
        manual = p if manual is None else 0.5 * manual + 0.5 * p
    trained = net.params_flat()
    ptrs = [t.data_ptr() for lp in net.params for t in lp.values()]
    with ema.swapped_in(net):
        np.testing.assert_allclose(net.params_flat(), manual, rtol=1e-6,
                                   atol=1e-7)
        assert not np.allclose(net.params_flat(), trained)
        assert np.all(np.isfinite(net.output(x).numpy()))
    np.testing.assert_array_equal(net.params_flat(), trained)
    # copied into the net's own tensors: captured steps stay valid
    assert ptrs == [t.data_ptr() for lp in net.params for t in lp.values()]


def test_ema_listener_validation():
    with pytest.raises(ValueError):
        tlis.PolyakAveragingListener(decay=1.5)
    with pytest.raises(ValueError):
        tlis.PolyakAveragingListener(decay=0.9).ema_params()


def test_ema_dedupes_identical_snapshots():
    """Calls that see the same snapshot (the same step) count once."""
    net, _, _ = _iris_mlp()
    ema = tlis.PolyakAveragingListener(decay=0.5)
    ema.iteration_done(net, 0)
    seeded = ema.ema_params()[0]["W"].clone()
    for i in range(5):
        ema.iteration_done(net, i + 1)
    assert torch.equal(ema.ema_params()[0]["W"], seeded)


def test_ema_survives_training_while_swapped_in():
    net, x, y = _iris_mlp(7, 16)
    ema = tlis.PolyakAveragingListener(decay=0.9)
    net.fit_batch(x, y)
    ema.iteration_done(net, 0)
    before = [t.clone() for t in ema.ema_params()[0].values()]
    with ema.swapped_in(net):
        net.fit_batch(x, y)
    for a, b in zip(ema.ema_params()[0].values(), before):
        assert torch.equal(a, b)


def test_ema_under_fit_scan_matches_jax():
    """fit_scan calls iteration_done K times after a chunk with the
    chunk's final params: one EMA update per chunk on both sides (JAX by
    the params' identity, the port by the net's step), against JAX's
    listener on the same params and batches."""
    jnet, tnet = _pair(lr=0.02)
    rng = np.random.default_rng(11)
    xs = rng.standard_normal((3, 4, 16, 4)).astype(np.float32)
    ys = np.eye(3, dtype=np.float32)[rng.integers(0, 3, (3, 4, 16))]
    jema = jlis.PolyakAveragingListener(decay=0.6)
    tema = tlis.PolyakAveragingListener(decay=0.6)
    jnet.set_listeners(jema)
    tnet.set_listeners(tema)
    seen = []
    probe = tlis.CollectScoresIterationListener()
    tnet.listeners.append(probe)
    for c in range(3):
        jnet.fit_scan(xs[c], ys[c])
        tnet.fit_scan(xs[c], ys[c])
        seen.append(len(probe.scores))
    assert seen == [4, 8, 12]  # K calls per chunk ...
    manual = None
    jnet2, tnet2 = _pair(lr=0.02)
    for c in range(3):
        tnet2.fit_scan(xs[c], ys[c])
        p = tnet2.params_flat()
        manual = p if manual is None else 0.6 * manual + 0.4 * p
    flat = np.concatenate([t.numpy().reshape(-1) for lp in tema.ema_params()
                           for t in (lp[k] for k in sorted(lp))])
    np.testing.assert_allclose(flat, manual, rtol=1e-6, atol=1e-7)  # ... one update
    jflat = np.concatenate([np.asarray(lp[k]).reshape(-1)
                            for lp in jema.ema_params() for k in sorted(lp)])
    np.testing.assert_allclose(flat, jflat, rtol=1e-6, atol=1e-6)


# -- a ComputationGraph under LocalFileModelSaver --------------------------------

def test_graph_best_model_under_local_file_saver(tmp_path):
    """The port's saver restores a graph's zip through `restore_model`,
    as a ComputationGraph; the JAX saver's `restore_multi_layer_network`
    cannot read it (the difference ROADMAP C records)."""
    gb = (NeuralNetConfiguration.builder().seed(2).learning_rate(0.05)
          .updater(Adam()).graph_builder().add_inputs("in")
          .add_layer("h", DenseLayer(n_in=4, n_out=8, activation="tanh"),
                     "in")
          .add_layer("out", OutputLayer(n_in=8, n_out=3,
                                        activation="softmax",
                                        loss="mcxent"), "h"))
    gb.set_outputs("out")
    net = ComputationGraph(gb.build(), device="cpu").init()
    ds = load_iris_dataset()
    train, test = ds.split_test_and_train(120)
    saver = tes.LocalFileModelSaver(str(tmp_path))
    cfg = tes.EarlyStoppingConfiguration(
        score_calculator=tes.DataSetLossCalculator(
            ListDataSetIterator(test, 30)),
        model_saver=saver, save_last_model=True,
        epoch_termination_conditions=[tes.MaxEpochsTerminationCondition(3)])
    result = tes.EarlyStoppingTrainer(cfg, net,
                                      ListDataSetIterator(train, 40)).fit()
    best = result.best_model
    assert isinstance(best, ComputationGraph)
    assert result.total_epochs == 3
    latest = saver.get_latest_model()
    np.testing.assert_array_equal(latest.params_flat(), net.params_flat())
    assert abs(best.score(test) - result.best_model_score) <= 1e-6
    with pytest.raises(Exception):
        jes.LocalFileModelSaver(str(tmp_path)).get_best_model()
