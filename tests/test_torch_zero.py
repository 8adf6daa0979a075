"""Port parity: ZeRO-1 updater-state sharding (ROADMAP A7.2.5).

The four cases of JAX tests/test_zero_sharding.py on the port's
`shard_updater_state` under `IciDataParallelTrainingMaster`, on two gloo
CPU ranks (``devices=["cpu"] * 2``, one torch thread a rank), held
against JAX's on a 2-device mesh of its virtual CPU devices: the same
(sharded, total) leaf counts and the same per-device bytes, training
golden-equal to the unsharded master (params and state within 1e-6) and
to JAX's sharded run (within 1e-5), the state still sharded after the
steps, and a model zip that holds the whole state.
"""
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.models.zoo import mlp_iris as jmlp_iris
from deeplearning4j_tpu.nn.conf.config import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.conf.layers import DenseLayer as JDense
from deeplearning4j_tpu.nn.conf.layers import OutputLayer as JOutput
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.nn.updater.updaters import Adam as JAdam
from deeplearning4j_tpu.parallel import IciDataParallelTrainingMaster as JIci
from deeplearning4j_tpu.parallel.mesh import default_mesh as jdefault_mesh
from deeplearning4j_tpu.parallel import zero as jzero
from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.models.zoo import mlp_iris
from deeplearning4j_tpu_torch.nn.conf.config import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.parallel import mesh as tmesh
from deeplearning4j_tpu_torch.parallel import zero as tzero
from deeplearning4j_tpu_torch.parallel.trainer import \
    IciDataParallelTrainingMaster
from deeplearning4j_tpu_torch.util import model_serializer as tms

TIMEOUT = 60.0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def mesh():
    m = tmesh.make_mesh({"data": 2}, ["cpu"] * 2, timeout=TIMEOUT)
    yield m.start()
    m.close()


def _jadam(seed=5):
    conf = (JNNC.builder().seed(seed).learning_rate(1e-2).updater(JAdam())
            .list()
            .layer(JDense(n_in=8, n_out=32, activation="relu"))
            .layer(JDense(n_in=32, n_out=32, activation="tanh"))
            .layer(JOutput(n_in=32, n_out=4, activation="softmax",
                           loss="negativeloglikelihood"))
            .build())
    return JMLN(conf).init()


def _port(jnet):
    t = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        jnet.conf.to_json()), device="cpu").init()
    t.set_params_flat(np.asarray(jnet.params_flat()))
    return t


def _data(n=128):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((n, 8)).astype(np.float32)
    y = np.eye(4, dtype=np.float32)[rng.integers(0, 4, n)]
    return x, y


def test_zero1_sharded_training_is_golden_equal(mesh, tmp_path):
    """JAX :45: the sharded run equals the unsharded master's (params and
    updater state within 1e-6) and JAX's sharded run on 2 devices; the
    counts are JAX's; a zip after training holds the whole state."""
    x, y = _data()
    starts = range(0, 128, 32)
    jz = _jadam()
    jcounts = jzero.shard_updater_state(jz, jdefault_mesh(2))
    JIci(mesh=jdefault_mesh(2)).execute_training(
        jz, iter([JDataSet(x[i:i + 32], y[i:i + 32]) for i in starts]))

    ref = _port(_jadam())
    IciDataParallelTrainingMaster(mesh=mesh).execute_training(
        ref, iter([DataSet(x[i:i + 32], y[i:i + 32]) for i in starts]))
    z = _port(_jadam())
    n_sharded, n_total = tzero.shard_updater_state(z, mesh)
    assert (n_sharded, n_total) == tuple(jcounts)
    assert n_sharded >= 4
    master = IciDataParallelTrainingMaster(mesh=mesh)
    mesh.reset_counts()
    master.execute_training(
        z, iter([DataSet(x[i:i + 32], y[i:i + 32]) for i in starts]))
    counts = mesh.query_counts(by_axis=True)
    # a gradient all-reduce a step; an all-gather a sharded param a step
    n_split = sum(d is not None for lu in z._zero.dims.values()
                  for d in lu.values())
    assert n_split == 6
    assert counts[1]["all_reduce@data"] == 4
    assert counts[1]["all_gather@data"] == 4 * n_split
    np.testing.assert_allclose(ref.params_flat(), z.params_flat(),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(ref.updater_state_flat(),
                               z.updater_state_flat(), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(np.asarray(jz.params_flat()), z.params_flat(),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.asarray(jz.updater_state_flat()),
                               z.updater_state_flat(), rtol=1e-4, atol=1e-6)
    path = tmp_path / "z.zip"
    tms.write_model(z, path, save_updater=True)
    back = tms.restore_multi_layer_network(str(path), device="cpu")
    np.testing.assert_array_equal(back.updater_state_flat(),
                                  z.updater_state_flat())
    master.close()


def test_zero1_state_stays_sharded_through_steps(mesh):
    """JAX :72: after a step the rank still holds slices, and no more
    bytes than before the step."""
    x, y = _data()
    net = _port(_jadam())
    tzero.shard_updater_state(net, mesh)
    before = tzero.updater_state_bytes_per_device(net)
    master = IciDataParallelTrainingMaster(mesh=mesh)
    master.execute_training(net, iter([DataSet(x[:64], y[:64])]))
    sharded = sum(1 for i, lu in enumerate(net._updater_state)
                  for p, st in lu.items() for t in st.values()
                  if tuple(t.shape) != tuple(net.params[i][p].shape))
    assert sharded >= 4, "state sharding lost in the train step"
    after = tzero.updater_state_bytes_per_device(net)
    assert after <= before * 1.01
    master.close()


def test_zero1_per_device_bytes_shrink():
    """JAX :98: the 32-wide tensors halve on 2 ranks, small biases stay;
    the bytes equal JAX's per-device bytes on 2 devices."""
    jnet = _jadam()
    net = _port(jnet)
    full = tzero.updater_state_bytes_per_device(net)
    assert full == jzero.updater_state_bytes_per_device(jnet)
    mesh = tmesh.make_mesh({"data": 2}, ["cpu"] * 2)
    tzero.shard_updater_state(net, mesh)
    jzero.shard_updater_state(jnet, jdefault_mesh(2))
    sharded = tzero.updater_state_bytes_per_device(net)
    assert sharded < full * 0.8
    assert sharded == jzero.updater_state_bytes_per_device(jnet)
    assert not mesh.alive()
    # the whole state still reads whole, without a rank
    np.testing.assert_array_equal(net.updater_state_flat(),
                                  np.asarray(jnet.updater_state_flat()))


def test_zero1_on_zoo_model():
    """JAX :110: mlp_iris (the helper handles any state tree); the counts
    are JAX's."""
    mesh = tmesh.make_mesh({"data": 2}, ["cpu"] * 2)
    net = MultiLayerNetwork(mlp_iris(), device="cpu").init()
    got = tzero.shard_updater_state(net, mesh)
    want = jzero.shard_updater_state(JMLN(jmlp_iris()).init(),
                                     jdefault_mesh(2))
    assert tuple(got) == tuple(want)
    assert got[1] >= 0
    with pytest.raises(ValueError, match="ZeRO-1"):
        x = np.zeros((4, 4), np.float32)
        net.fit_batch(x, np.eye(3, dtype=np.float32)[[0, 1, 2, 0]])
