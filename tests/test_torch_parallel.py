"""Port parity: the data-parallel training masters, distributed
evaluation and the Spark facades over process-group meshes.

The cases of tests/test_parallel.py (:43, :63, :98, :115, :126, :141,
:154) and tests/test_parallel_graph.py (:41-94) on the port's masters:
rank 0 is this process, the followers are spawned ranks on
``devices=["cpu"] * n`` over gloo, one torch thread a rank. Against the
JAX masters (on the JAX package's virtual CPU devices) on the same
weights (`params_from_jax`) and data: parameters, updater state and
BatchNorm statistics within 1e-5 of the largest |value| of their kind
(each rank sums its shard, the all-reduce sums the ranks: another order
of the same f32 sums than one program over the global batch).

A CNN with BatchNorm (a fused BN+act+pool pair) covers the statistics: under
`IciDataParallelTrainingMaster` the batch statistics (and the backward's
per-channel sums) are global, so two ranks equal one process on the
whole batch; under `ParameterAveragingTrainingMaster` they stay local, so
the result is the average of the ranks' own fits. The nets carry no
dropout (each rank draws its own masks).

Two meshes serve the module; every collective carries a 60 s timeout
and the fixtures kill the followers at teardown.
"""
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.datasets.dataset import MultiDataSet as JMulti
from deeplearning4j_tpu.nn.conf import config as jconfig
from deeplearning4j_tpu.nn.conf import inputs as jinputs
from deeplearning4j_tpu.nn.conf import layers as jlayers
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu.parallel import trainer as jtrainer
from deeplearning4j_tpu.parallel.mesh import default_mesh as jmesh
from deeplearning4j_tpu_torch.datasets.dataset import DataSet, MultiDataSet
from deeplearning4j_tpu_torch.datasets.fetchers import load_iris_dataset
from deeplearning4j_tpu_torch.datasets.iterators import ListDataSetIterator
from deeplearning4j_tpu_torch.nn.conf.config import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.conf.graph import \
    ComputationGraphConfiguration as TGConf
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph as TGraph
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork as TNet
from deeplearning4j_tpu_torch.parallel import mesh as tmesh
from deeplearning4j_tpu_torch.parallel import trainer as ttrainer
from deeplearning4j_tpu_torch.parallel.evaluation import (
    DistributedDataSetLossCalculator, DistributedEarlyStoppingTrainer,
    distributed_evaluate, distributed_score)
from deeplearning4j_tpu_torch.parallel.stats import device_trace
from deeplearning4j_tpu_torch.util.model_serializer import params_from_jax

TIMEOUT = 60.0
REL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def mesh2():
    m = tmesh.default_mesh(2, ["cpu"] * 2, timeout=TIMEOUT).start()
    yield m
    m.kill()


@pytest.fixture(scope="module")
def mesh4():
    m = tmesh.default_mesh(4, ["cpu"] * 4, timeout=TIMEOUT).start()
    yield m
    m.kill()


def _close(a, b, what, rel=REL):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = max(float(np.abs(b).max(initial=0.0)), 1e-30)
    gap = float(np.abs(a - b).max(initial=0.0))
    assert gap <= rel * scale, f"{what}: max|diff| {gap} > {rel} x {scale}"


# -- nets: the JAX conf, carried over by JSON, the JAX weights -------------
def _mlp_conf(seed=12345, lr=0.1, l2=None):
    b = (jconfig.NeuralNetConfiguration.builder().seed(seed)
         .learning_rate(lr).updater(jtrainer_sgd()))
    if l2:
        b = b.regularization(True).l2(l2)
    return (b.list()
            .layer(jlayers.DenseLayer(n_in=4, n_out=10, activation="tanh"))
            .layer(jlayers.OutputLayer(n_in=10, n_out=3,
                                       activation="softmax",
                                       loss="negativeloglikelihood"))
            .build())


def jtrainer_sgd():
    from deeplearning4j_tpu.nn.updater.updaters import Sgd
    return Sgd()


def _cnn_conf():
    """Conv 3x3 (8 channels) -> BatchNorm relu -> 2x2 max pool (the fused
    BN+act+pool pair) -> Dense 16 -> softmax, on 8x8x3, l2."""
    return (jconfig.NeuralNetConfiguration.builder().seed(3)
            .learning_rate(0.05).updater(jtrainer_sgd())
            .regularization(True).l2(1e-3)
            .list()
            .layer(jlayers.ConvolutionLayer(n_out=8, kernel_size=(3, 3),
                                            padding=(1, 1),
                                            activation="identity"))
            .layer(jlayers.BatchNormalization(activation="relu"))
            .layer(jlayers.SubsamplingLayer(pooling_type="max",
                                            kernel_size=(2, 2),
                                            stride=(2, 2)))
            .layer(jlayers.DenseLayer(n_out=16, activation="relu"))
            .layer(jlayers.OutputLayer(n_out=3, activation="softmax",
                                       loss="negativeloglikelihood"))
            .set_input_type(jinputs.InputType.convolutional(8, 8, 3))
            .build())


def _graph_conf(seed=12345, lr=0.1, bn=False):
    gb = (jconfig.NeuralNetConfiguration.builder().seed(seed)
          .learning_rate(lr).updater(jtrainer_sgd())
          .graph_builder().add_inputs("in")
          .add_layer("dense", jlayers.DenseLayer(n_in=4, n_out=10,
                                                 activation="tanh"), "in"))
    prev = "dense"
    if bn:
        gb.add_layer("bn", jlayers.BatchNormalization(n_in=10, n_out=10,
                                                      activation="relu"),
                     "dense")
        prev = "bn"
    return (gb.add_layer("out", jlayers.OutputLayer(
                n_in=10, n_out=3, activation="softmax",
                loss="negativeloglikelihood"), prev)
            .set_outputs("out").build())


def _pair(jconf):
    """(JAX net, port net with the JAX weights and variables)."""
    if hasattr(jconf, "vertices"):
        jnet = JGraph(jconf).init()
        tnet = TGraph(TGConf.from_json(jconf.to_json()), device="cpu").init()
        tnet.set_params(params_from_jax(
            {k: {n: np.asarray(a) for n, a in lp.items()}
             for k, lp in jnet.params.items()}))
        return jnet, tnet
    jnet = JNet(jconf).init()
    tnet = TNet(MultiLayerConfiguration.from_json(jconf.to_json()),
                device="cpu").init()
    tnet.set_params(params_from_jax(
        [{k: np.asarray(v) for k, v in lp.items()} for lp in jnet.params]))
    return jnet, tnet


def _port(jconf):
    return _pair(jconf)[1]


def _data(n=128, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 4)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, n)]
    return x, y


def _images(n=16, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 8, 8, 3)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, n)]
    return x, y


def _jvariables(net):
    vs = net.variables
    items = [vs[k] for k in sorted(vs)] if isinstance(vs, dict) else vs
    return np.concatenate([np.asarray(a).reshape(-1) for lv in items
                           for _, a in sorted(lv.items())] or [np.zeros(0)])


def _tvariables(net):
    vs = net.variables
    items = [vs[k] for k in sorted(vs)] if isinstance(vs, dict) else vs
    return np.concatenate([np.asarray(t.detach().cpu()).reshape(-1)
                           for lv in items for _, t in sorted(lv.items())]
                          or [np.zeros(0)])


# -------------------------------------------------- parameter averaging --
@pytest.mark.parametrize("kind", ["multilayer", "graph"])
def test_one_worker_equals_local_fit(kind):
    """THE golden test (TestCompareParameterAveragingSparkVsSingleMachine;
    JAX :43, graph :41): one worker, four local steps, equals a local
    fit, params and updater state."""
    conf = _mlp_conf() if kind == "multilayer" else _graph_conf()
    x, y = _data(64)
    local = _port(conf)
    for i in range(4):
        local.fit(x[16 * i:16 * (i + 1)], y[16 * i:16 * (i + 1)])
    dist = _port(conf)
    master = ttrainer.ParameterAveragingTrainingMaster(
        batch_size_per_worker=16, averaging_frequency=4,
        mesh=tmesh.default_mesh(1, ["cpu"]))
    master.execute_training(dist, ListDataSetIterator(DataSet(x, y), 64))
    _close(dist.params_flat(), local.params_flat(), "params")
    _close(dist.updater_state_flat(), local.updater_state_flat(), "updater")
    assert dist.step == 4


@pytest.mark.parametrize("kind", ["multilayer", "graph"])
def test_multi_worker_average_matches_manual(kind, mesh4):
    """Four workers, one round: the averaged params equal the mean of
    four independent fits (JAX :63, graph :60) and JAX's master."""
    conf = _mlp_conf() if kind == "multilayer" else _graph_conf()
    x, y = _data(64, seed=3)
    manual = []
    for w in range(4):
        net_w = _port(conf)
        net_w.fit(x[16 * w:16 * (w + 1)], y[16 * w:16 * (w + 1)])
        manual.append(net_w.params_flat())
    jnet, dist = _pair(conf)
    master = ttrainer.ParameterAveragingTrainingMaster(
        batch_size_per_worker=16, averaging_frequency=1, mesh=mesh4)
    master.execute_training(dist, ListDataSetIterator(DataSet(x, y), 64))
    master.close()
    assert mesh4.alive()  # the master did not start it: left running
    _close(dist.params_flat(), np.mean(manual, axis=0), "vs manual")
    jtrainer.ParameterAveragingTrainingMaster(
        batch_size_per_worker=16, averaging_frequency=1,
        mesh=jmesh(4)).execute_training(jnet, [JDataSet(x, y)])
    _close(dist.params_flat(), jnet.params_flat(), "vs JAX")


def test_pa_remainder_carries_over(mesh2):
    """48 examples, 2 workers x 8 x frequency 2 = 32 a round: the
    remainder trains in a second, partly filled round (JAX :141)."""
    x, y = _data(48, seed=9)
    net = _port(_mlp_conf())
    master = ttrainer.ParameterAveragingTrainingMaster(
        batch_size_per_worker=8, averaging_frequency=2, mesh=mesh2)
    master.execute_training(net, ListDataSetIterator(DataSet(x, y), 48))
    assert net.step == 4


def test_stats_collection(mesh4):
    """The phase stats of a parameter-averaging run (JAX :126)."""
    x, y = _data(128)
    net = _port(_mlp_conf())
    master = ttrainer.ParameterAveragingTrainingMaster(
        batch_size_per_worker=16, averaging_frequency=2, mesh=mesh4,
        collect_stats=True)
    master.execute_training(net, ListDataSetIterator(DataSet(x, y), 64))
    stats = master.get_training_stats()
    assert stats.count("aggregate_round") >= 1
    assert stats.total_millis("total_training") > 0
    assert "data_fetch" in stats.keys()
    assert "count" in stats.stats_as_string()
    assert stats.export_json()


# ------------------------------------------------------------ ICI master --
@pytest.mark.parametrize("kind", ["multilayer", "graph"])
def test_ici_equals_single_process_sgd_and_jax(kind, mesh2):
    """Two ranks' per-step gradient all-reduce equals one process's step
    on the global batch (JAX :98, graph :75) and JAX's master on a
    2-device mesh."""
    conf = _mlp_conf() if kind == "multilayer" else _graph_conf()
    x, y = _data(64, seed=5)
    single = _port(conf)
    for _ in range(5):
        single.fit(x, y)
    jnet, dist = _pair(conf)
    master = ttrainer.IciDataParallelTrainingMaster(mesh=mesh2)
    for _ in range(5):
        master.execute_training(dist, ListDataSetIterator(DataSet(x, y), 64))
    _close(dist.params_flat(), single.params_flat(), "vs single")
    jm = jtrainer.IciDataParallelTrainingMaster(mesh=jmesh(2))
    for _ in range(5):
        jm.execute_training(jnet, [JDataSet(x, y)])
    _close(dist.params_flat(), jnet.params_flat(), "vs JAX")
    assert dist.step == 5 and np.isfinite(dist.score_)


def test_ici_ragged_remainder_with_l2(mesh4):
    """50 examples over 4 ranks: 2 fill rows of weight 0, the l2 term
    once — equal to one process's fit on the 50 and to JAX's master."""
    conf = _mlp_conf(l2=1e-2)
    x, y = _data(50, seed=11)
    single = _port(conf)
    for _ in range(3):
        single.fit(x, y)
    jnet, dist = _pair(conf)
    master = ttrainer.IciDataParallelTrainingMaster(mesh=mesh4)
    jm = jtrainer.IciDataParallelTrainingMaster(mesh=jmesh(4))
    for _ in range(3):
        master.execute_training(dist, [DataSet(x, y)])
        jm.execute_training(jnet, [JDataSet(x, y)])
    _close(dist.params_flat(), single.params_flat(), "vs single")
    _close(dist.params_flat(), jnet.params_flat(), "vs JAX")
    _close(dist.score_, single.score_, "score")


def test_ici_converges_on_iris(mesh4):
    iris = load_iris_dataset()
    net = _port(_mlp_conf(lr=0.05))
    master = ttrainer.IciDataParallelTrainingMaster(mesh=mesh4)
    s0 = net.score(x=iris.features, y=iris.labels)
    for _ in range(15):
        master.execute_training(net, ListDataSetIterator(iris, 152))
    assert net.score(x=iris.features, y=iris.labels) < s0 * 0.8


# -------------------------------------------------------------- BatchNorm --
def test_cnn_batchnorm_ici_global_statistics(mesh2):
    """The fused BN+act+pool pair under the ICI master: global batch
    statistics forward and global per-channel sums backward, so two
    ranks equal one process on the whole batch and JAX's master on a
    2-device mesh — params and the running statistics."""
    x, y = _images(16, seed=1)
    single = _port(_cnn_conf())
    for _ in range(3):
        single.fit(x, y)
    jnet, dist = _pair(_cnn_conf())
    master = ttrainer.IciDataParallelTrainingMaster(mesh=mesh2)
    jm = jtrainer.IciDataParallelTrainingMaster(mesh=jmesh(2))
    for _ in range(3):
        master.execute_training(dist, [DataSet(x, y)])
        jm.execute_training(jnet, [JDataSet(x, y)])
    _close(dist.params_flat(), single.params_flat(), "params vs single")
    _close(_tvariables(dist), _tvariables(single), "BN stats vs single")
    _close(dist.params_flat(), jnet.params_flat(), "params vs JAX")
    _close(_tvariables(dist), _jvariables(jnet), "BN stats vs JAX")


def test_cnn_batchnorm_pa_local_statistics(mesh2):
    """Under parameter averaging the statistics stay each rank's own: one
    round equals the average of two local fits (params and running
    statistics) and JAX's master."""
    x, y = _images(16, seed=2)
    fits = [_port(_cnn_conf()) for _ in range(2)]
    for w, net in enumerate(fits):
        net.fit(x[8 * w:8 * (w + 1)], y[8 * w:8 * (w + 1)])
    jnet, dist = _pair(_cnn_conf())
    ttrainer.ParameterAveragingTrainingMaster(
        batch_size_per_worker=8, averaging_frequency=1,
        mesh=mesh2).execute_training(dist, [DataSet(x, y)])
    _close(dist.params_flat(),
           np.mean([f.params_flat() for f in fits], axis=0), "params")
    _close(_tvariables(dist),
           np.mean([_tvariables(f) for f in fits], axis=0), "BN stats")
    jtrainer.ParameterAveragingTrainingMaster(
        batch_size_per_worker=8, averaging_frequency=1,
        mesh=jmesh(2)).execute_training(jnet, [JDataSet(x, y)])
    _close(dist.params_flat(), jnet.params_flat(), "vs JAX")


def test_graph_batchnorm_ici_global_statistics(mesh2):
    """An unfused BatchNorm (a graph vertex): the global statistics'
    gradient reaches every rank's inputs (`_SyncStats`)."""
    x, y = _data(32, seed=4)
    single = _port(_graph_conf(bn=True))
    for _ in range(3):
        single.fit(x, y)
    dist = _port(_graph_conf(bn=True))
    master = ttrainer.IciDataParallelTrainingMaster(mesh=mesh2)
    for _ in range(3):
        master.execute_training(dist, [DataSet(x, y)])
    _close(dist.params_flat(), single.params_flat(), "params")
    _close(_tvariables(dist), _tvariables(single), "BN stats")


def test_graph_multi_input_output(mesh4):
    """Two inputs, two outputs, 50 rows over 4 ranks (ragged, list-wise
    fill weights): equal to JAX's master (graph :94)."""
    conf = (jconfig.NeuralNetConfiguration.builder().seed(7)
            .learning_rate(0.05).updater(jtrainer_sgd())
            .graph_builder().add_inputs("a", "b")
            .add_layer("da", jlayers.DenseLayer(n_in=3, n_out=8,
                                                activation="tanh"), "a")
            .add_layer("db", jlayers.DenseLayer(n_in=5, n_out=8,
                                                activation="tanh"), "b")
            .add_layer("out1", jlayers.OutputLayer(
                n_in=8, n_out=2, activation="softmax",
                loss="negativeloglikelihood"), "da")
            .add_layer("out2", jlayers.OutputLayer(
                n_in=8, n_out=4, activation="softmax",
                loss="negativeloglikelihood"), "db")
            .set_outputs("out1", "out2").build())
    rng = np.random.default_rng(1)
    n = 50
    arrs = ([rng.normal(size=(n, 3)).astype(np.float32),
             rng.normal(size=(n, 5)).astype(np.float32)],
            [np.eye(2, dtype=np.float32)[rng.integers(0, 2, n)],
             np.eye(4, dtype=np.float32)[rng.integers(0, 4, n)]])
    jnet, g = _pair(conf)
    master = ttrainer.IciDataParallelTrainingMaster(mesh=mesh4)
    jm = jtrainer.IciDataParallelTrainingMaster(mesh=jmesh(4))
    s0 = None
    for i in range(5):
        master.execute_training(g, [MultiDataSet(*arrs)])
        jm.execute_training(jnet, [JMulti(*arrs)])
        if i == 0:
            s0 = g.score_
    assert np.isfinite(g.score_) and g.score_ < s0
    _close(g.params_flat(), jnet.params_flat(), "vs JAX")


# ------------------------------------------- wrappers, facades, eval, CLI --
def test_parallel_wrapper(mesh4):
    """JAX :115."""
    iris = load_iris_dataset()
    net = _port(_mlp_conf(lr=0.05))
    wrapper = ttrainer.ParallelWrapper(net, averaging_frequency=2,
                                       batch_size_per_worker=16, mesh=mesh4)
    s0 = net.score(x=iris.features, y=iris.labels)
    for _ in range(8):
        wrapper.fit(ListDataSetIterator(iris, 150))
    assert net.score(x=iris.features, y=iris.labels) < s0


def test_distributed_evaluate_and_score_equal_local(mesh4):
    """Split evaluation and scoring (ragged batches) equal the local
    ones."""
    x, y = _data(90, seed=6)
    net = _port(_mlp_conf(l2=1e-3))
    net.fit(x, y)
    batches = [DataSet(x[:50], y[:50]), DataSet(x[50:], y[50:])]
    ev = distributed_evaluate(net, batches, mesh=mesh4)
    local = net.evaluate(ListDataSetIterator(DataSet(x, y), 50))
    np.testing.assert_array_equal(ev.confusion.matrix,
                                  local.confusion.matrix)
    want = (50 * net.score(x=x[:50], y=y[:50])
            + 40 * net.score(x=x[50:], y=y[50:])) / 90
    _close(distributed_score(net, batches, mesh=mesh4), want, "score")


def test_spark_facades(mesh4, tmp_path):
    """SparkDl4jMultiLayer and SparkComputationGraph (JAX :154): fit over
    an RDD-like list through the ICI master, split evaluate and score,
    predict, fit_paths from .npz files, the graph facade with parameter
    averaging."""
    from deeplearning4j_tpu_torch.models.zoo import mlp_iris
    from deeplearning4j_tpu_torch.parallel.spark_api import (
        SparkComputationGraph, SparkDl4jMultiLayer)
    iris = load_iris_dataset()
    rdd = [DataSet(iris.features[i:i + 30], iris.labels[i:i + 30])
           for i in range(0, 150, 30)]
    s = SparkDl4jMultiLayer(mlp_iris(), mesh=mesh4, device="cpu")
    for _ in range(30):
        s.fit(rdd)
    assert s.evaluate(rdd).accuracy() > 0.9
    assert np.isfinite(s.score(rdd))
    assert s.predict(iris.features[:10]).shape == (10, 3)
    assert s.get_network().step == 30 * 5
    paths = []
    for i, ds in enumerate(rdd):
        p = str(tmp_path / f"ds{i}.npz")
        np.savez(p, features=ds.features, labels=ds.labels)
        paths.append(p)
    s2 = SparkDl4jMultiLayer(mlp_iris(), mesh=mesh4, device="cpu")
    s2.fit_paths(paths)
    assert s2.get_network().step == 5
    gconf = TGConf.from_json(_graph_conf(seed=0).to_json())
    master = ttrainer.ParameterAveragingTrainingMaster(
        batch_size_per_worker=8, averaging_frequency=1, mesh=mesh4)
    sg = SparkComputationGraph(gconf, training_master=master, device="cpu")
    sg.fit(rdd)
    assert np.isfinite(sg.get_network().score_)
    assert sg.predict(iris.features[:4]).shape == (4, 3)
    assert mesh4.alive()


def test_distributed_early_stopping(mesh2):
    from deeplearning4j_tpu_torch.earlystopping.earlystopping import (
        EarlyStoppingConfiguration, MaxEpochsTerminationCondition)
    x, y = _data(64, seed=8)
    net = _port(_mlp_conf())
    cfg = EarlyStoppingConfiguration(
        epoch_termination_conditions=[MaxEpochsTerminationCondition(3)],
        score_calculator=DistributedDataSetLossCalculator(
            ListDataSetIterator(DataSet(x, y), 32), mesh=mesh2))
    res = DistributedEarlyStoppingTrainer(
        cfg, net, ListDataSetIterator(DataSet(x, y), 32),
        ttrainer.IciDataParallelTrainingMaster(mesh=mesh2)).fit()
    assert res.total_epochs == 3 and np.isfinite(res.best_model_score)
    assert net.step == 3 * 2


def test_cli_train_data_parallel(tmp_path, capsys):
    """`train --runtime data-parallel --workers 2` (JAX cli :74, :363)."""
    from deeplearning4j_tpu_torch.cli import main as tcli
    from deeplearning4j_tpu_torch.models.zoo import mlp_iris
    iris = load_iris_dataset()
    csv = tmp_path / "iris.csv"
    rows = np.concatenate([iris.features,
                           iris.labels.argmax(1)[:, None]], axis=1)
    np.savetxt(csv, rows, delimiter=",", fmt="%.4f")
    conf = tmp_path / "net.json"
    conf.write_text(mlp_iris().to_json())
    out = tmp_path / "m.zip"
    rc = tcli.main(["train", "--conf", str(conf), "--input", str(csv),
                    "--output", str(out), "--num-classes", "3",
                    "--batch", "50", "--runtime", "data-parallel",
                    "--workers", "2", "--device", "cpu"])
    assert rc == 0 and out.exists()
    assert "Model saved" in capsys.readouterr().out


def test_refusals_and_stats_trace(tmp_path):
    """A 2-D mesh builds with JAX's axes and shape, starting no rank (it
    was refused before ROADMAP A7.2.5). Both masters take a
    ``state_tracker`` (tests/test_torch_statetracker.py runs them), and
    `resume` without one skips nothing on any mesh, starting no rank."""
    tr = object()
    assert ttrainer.IciDataParallelTrainingMaster(
        state_tracker=tr).state_tracker is tr
    assert ttrainer.ParameterAveragingTrainingMaster(
        state_tracker=tr).state_tracker is tr
    assert ttrainer.IciDataParallelTrainingMaster().resume(None) == 0
    m2 = tmesh.default_mesh(2, ["cpu"] * 2)
    assert ttrainer.IciDataParallelTrainingMaster(mesh=m2).resume(None) == 0
    assert not m2.alive()
    from deeplearning4j_tpu.parallel.mesh import make_mesh as jmake_mesh
    m22 = tmesh.make_mesh({"data": 2, "model": 2}, ["cpu"] * 4)
    j22 = jmake_mesh({"data": 2, "model": 2})
    assert m22.axis_names == tuple(j22.axis_names)
    assert m22.shape == dict(j22.shape) and not m22.alive()
    from deeplearning4j_tpu_torch.parallel.stats import SparkTrainingStats
    st = SparkTrainingStats()
    with device_trace(str(tmp_path / "tr"), st):
        torch.ones(4).sum()
    assert st.count("device_trace") == 1
    assert (tmp_path / "tr" / "trace.json").exists()
