"""Port parity: meshes of more than one axis (ROADMAP A7.2.5).

The cases of JAX tests/test_hybrid_mesh.py on the port's process meshes:
the geometry of `hybrid_mesh`, `mesh_2d` and `make_mesh` (built without
spawning a rank, held against JAX's on its virtual CPU devices), its
refusals, and data-parallel training on a {"data": 2} x {"model": 2}
hybrid mesh of gloo CPU ranks against JAX's single-device SGD. Then the
axis communicators of a started 2 x 2 mesh: each axis group's
all-reduce, all-gather, all-to-all, ring exchange and send/recv against
numpy, with their counts by axis. A follower that dies makes the next
command raise `MeshError`.
"""
import os
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

from deeplearning4j_tpu import MultiLayerNetwork as JMLN
from deeplearning4j_tpu import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu import Sgd as JSgd
from deeplearning4j_tpu.nn.conf.layers import DenseLayer as JDense
from deeplearning4j_tpu.nn.conf.layers import OutputLayer as JOutput
from deeplearning4j_tpu.parallel import mesh as jmesh
from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.datasets.iterators import ListDataSetIterator
from deeplearning4j_tpu_torch.nn.conf.config import \
    MultiLayerConfiguration as TConf
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.parallel import mesh as tmesh
from deeplearning4j_tpu_torch.parallel.trainer import \
    IciDataParallelTrainingMaster

import torch_parallel_fns as fns

TIMEOUT = 60.0
PROBE = "torch_parallel_fns:probe"
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NEW_MODULES = ("mesh", "tp_autograd", "tensor_parallel", "trainer", "zero",
               "ring", "pipeline", "moe")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def mesh22():
    m = tmesh.make_mesh({"data": 2, "model": 2}, ["cpu"] * 4,
                        timeout=TIMEOUT)
    yield m.start()
    m.close()


def _ids(jax_mesh):
    return np.vectorize(lambda d: d.id)(jax_mesh.devices)


def test_hybrid_mesh_geometry():
    """JAX :37: axes, shape, and contiguous rank blocks as pseudo-slices,
    equal to JAX's on its virtual devices; nothing spawned."""
    with pytest.warns(UserWarning, match="pseudo-slice"):
        m = tmesh.hybrid_mesh({"data": 2}, {"model": 4}, ["cpu"] * 8)
    with pytest.warns(UserWarning, match="pseudo-slice"):
        j = jmesh.hybrid_mesh({"data": 2}, {"model": 4})
    assert m.axis_names == tuple(j.axis_names) == ("data", "model")
    assert m.rank_grid.shape == j.devices.shape == (2, 4)
    ids = _ids(j)
    assert (m.rank_grid == ids - ids.min()).all()
    assert m.rank_grid[0].tolist() == sorted(m.rank_grid[0].tolist())
    assert set(m.rank_grid[0]) & set(m.rank_grid[1]) == set()
    assert not m.alive() and m.starts == 0
    assert m.axis_groups("model") == [[0, 1, 2, 3], [4, 5, 6, 7]]
    assert m.axis_groups("data") == [[0, 4], [1, 5], [2, 6], [3, 7]]
    assert m.coords(6) == {"data": 1, "model": 2}


@pytest.mark.parametrize("kind", ["make_mesh", "mesh_2d"])
def test_two_axis_mesh_geometry_matches_jax(kind):
    """make_mesh({data, model}) and mesh_2d lay the ranks out row-major,
    as JAX reshapes devices[:total] (JAX mesh.py :45-53, :35-42)."""
    if kind == "make_mesh":
        m = tmesh.make_mesh({"data": 2, "model": 3}, ["cpu"] * 6)
        j = jmesh.make_mesh({"data": 2, "model": 3})
    else:
        m = tmesh.mesh_2d(3, 2, devices=["cpu"] * 6)
        j = jmesh.mesh_2d(3, 2)
    assert m.axis_names == tuple(j.axis_names)
    assert m.shape == dict(j.shape) and m.size == j.size
    ids = _ids(j)
    assert (m.rank_grid == ids - ids.min()).all()
    assert m.backend == "gloo" and not m.alive()


def test_hybrid_mesh_rejects_duplicate_axes():
    with pytest.raises(ValueError):
        tmesh.hybrid_mesh({"data": 2}, {"data": 4}, ["cpu"] * 8)


def test_hybrid_mesh_rejects_oversize():
    with pytest.raises(ValueError):
        tmesh.hybrid_mesh({"data": 64}, {"model": 64}, ["cpu"] * 8)
    with pytest.raises(ValueError):
        tmesh.make_mesh({"data": 2, "model": 2}, ["cpu"] * 3)


def _jnet(lr=0.1):
    conf = (JNNC.builder().seed(12345).learning_rate(lr).updater(JSgd())
            .list()
            .layer(JDense(n_in=4, n_out=10, activation="tanh"))
            .layer(JOutput(n_in=10, n_out=3, activation="softmax",
                           loss="negativeloglikelihood"))
            .build())
    return JMLN(conf).init()


def _tnet(jnet):
    t = MultiLayerNetwork(TConf.from_json(jnet.conf.to_json()),
                          device="cpu").init()
    t.set_params_flat(np.asarray(jnet.params_flat()))
    return t


def test_training_on_hybrid_mesh_matches_single_device():
    """JAX :56: data-parallel SGD over the DCN axis of a {data: 2} x
    {model: 2} hybrid mesh equals JAX's single-device SGD; the model
    ranks repeat their data row's work and the gradient all-reduce runs
    on the data axis only."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(64, 4)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 64)]
    single = _jnet()
    for _ in range(5):
        single.fit(x, y)
    dist = _tnet(_jnet())
    with pytest.warns(UserWarning, match="pseudo-slice"):
        mesh = tmesh.hybrid_mesh({"data": 2}, {"model": 2}, ["cpu"] * 4,
                                 timeout=TIMEOUT)
    master = IciDataParallelTrainingMaster(mesh=mesh)
    try:
        for i in range(5):
            if i == 1:
                mesh.reset_counts()
            master.execute_training(dist, ListDataSetIterator(DataSet(x, y),
                                                              64))
        counts = mesh.query_counts(by_axis=True)
    finally:
        master.close()
        mesh.close()
    for c in counts:
        assert c["all_reduce@data"] == 4 and c["all_reduce@model"] == 0, c
    np.testing.assert_allclose(np.asarray(single.params_flat()),
                               dist.params_flat(), rtol=2e-5, atol=2e-6)


def _probe(mesh, kind, axis, rng, shape=(4, 6), **kw):
    inputs = [torch.tensor(rng.normal(size=shape), dtype=torch.float32)
              for _ in range(mesh.size)]
    data = {"kind": kind, "axis": axis, "inputs": inputs, **kw}
    out = mesh.run_service(PROBE, tmesh.SERVICE_OPS, data,
                           lambda: fns.run_probe(mesh, data))
    return [t.numpy() for t in inputs], out.numpy()


@pytest.mark.parametrize("axis", ["data", "model"])
def test_axis_all_reduce_and_gather(mesh22, axis):
    """An axis group's all-reduce and all-gather hold its own ranks' data
    only; counted by kind and by axis."""
    rng = np.random.default_rng(1)
    mesh22.reset_counts()
    x, out = _probe(mesh22, "all_reduce", axis, rng)
    groups = mesh22.axis_groups(axis)
    for g in groups:
        want = sum(x[r] for r in g)
        for r in g:
            np.testing.assert_allclose(out[r], want, rtol=1e-6, atol=1e-6)
    x, out = _probe(mesh22, "all_gather", axis, rng, dim=1)
    for g in groups:
        for r in g:
            np.testing.assert_array_equal(
                out[r], np.concatenate([x[q] for q in g], 1))
    for c in mesh22.query_counts(by_axis=True):
        assert c[f"all_reduce@{axis}"] == 1, c
        assert c[f"all_gather@{axis}"] == 1, c
        other = "model" if axis == "data" else "data"
        assert c[f"all_reduce@{other}"] == 0, c


@pytest.mark.parametrize("split,concat", [(0, 1), (1, 0), (2, 1)])
def test_all_to_all_matches_numpy(mesh22, split, concat):
    """JAX's tiled all_to_all: chunk j of rank i's split dim lands at
    position i of rank j's concat dim."""
    rng = np.random.default_rng(2)
    x, out = _probe(mesh22, "all_to_all", "model", rng, shape=(4, 6, 2),
                    split=split, concat=concat)
    for g in mesh22.axis_groups("model"):
        for j, r in enumerate(g):
            want = np.concatenate([np.split(x[q], len(g), split)[j]
                                   for q in g], concat)
            np.testing.assert_array_equal(out[r], want)


@pytest.mark.parametrize("axis", ["data", "model"])
def test_exchange_and_send_recv_match_numpy(mesh22, axis):
    """A ring rotation (each rank's tensor to the next, the previous
    one's received) and a send from the group's first rank to its last."""
    rng = np.random.default_rng(3)
    mesh22.reset_counts()
    x, out = _probe(mesh22, "exchange", axis, rng)
    for g in mesh22.axis_groups(axis):
        for i, r in enumerate(g):
            np.testing.assert_array_equal(out[r], x[g[i - 1]])
    x, out = _probe(mesh22, "send_recv", axis, rng)
    for g in mesh22.axis_groups(axis):
        np.testing.assert_array_equal(out[g[-1]], x[g[0]])
    counts = mesh22.query_counts(by_axis=True)
    assert counts[0][f"send@{axis}"] == 2 and counts[0]["recv"] == 1
    assert counts[1 if axis == "model" else 2][f"recv@{axis}"] == 2


def test_a_dead_follower_raises_mesh_error():
    """A killed follower of a 2 x 2 mesh: the next command raises
    MeshError."""
    m = tmesh.make_mesh({"data": 2, "model": 2}, ["cpu"] * 4,
                        timeout=TIMEOUT).start()
    try:
        os.kill(m._procs[1].pid, signal.SIGKILL)
        m._procs[1].join(10)
        with pytest.raises(tmesh.MeshError):
            m.reset_counts()
    finally:
        m.close()


@pytest.mark.parametrize("module", NEW_MODULES)
def test_new_modules_import_without_jax(module):
    """Each module of this slice imports in a process where importing jax
    or the JAX package fails, and pulls neither in."""
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['deeplearning4j_tpu'] = None; "
            f"import deeplearning4j_tpu_torch.parallel.{module}; "
            "import deeplearning4j_tpu_torch.parallel as p; "
            "assert p.ring_attention and p.GPipeExecutor and p.MoEExecutor; "
            "assert not [m for m in sys.modules if m.startswith('jax') "
            "and sys.modules[m] is not None]; print('ok')")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


@pytest.mark.parametrize("tp", [False, True])
def test_state_tracker_and_resume_on_a_two_axis_mesh(mesh22, tmp_path, tp):
    """The ICI master's ``state_tracker=`` and `resume` on the 2 x 2 mesh
    (refused before ROADMAP A7.2.5): checkpoints every step, a fresh net
    and master resume from the third and finish where the uninterrupted
    run does, bitwise; with ``tp``, a tensor-parallel transformer_lm
    whose checkpoints hold its whole state."""
    from deeplearning4j_tpu_torch.models.zoo import transformer_lm
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.parallel.statetracker import \
        TrainingStateTracker
    from deeplearning4j_tpu_torch.parallel.tensor_parallel import \
        shard_transformer_tp
    rng = np.random.default_rng(9)
    if tp:
        eye = np.eye(11, dtype=np.float32)
        batches = []
        for _ in range(5):
            ids = rng.integers(0, 11, (4, 7))
            batches.append(DataSet(eye[ids[:, :-1]], eye[ids[:, 1:]]))

        def make():
            net = ComputationGraph(transformer_lm(
                vocab_size=11, d_model=8, n_heads=2, n_blocks=1),
                device="cpu").init()
            shard_transformer_tp(net, mesh22)
            return net
    else:
        x = rng.normal(size=(5, 8, 4)).astype(np.float32)
        y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, (5, 8))]
        batches = [DataSet(x[i], y[i]) for i in range(5)]

        def make():
            return _tnet(_jnet())
    ref = make()
    IciDataParallelTrainingMaster(mesh=mesh22).execute_training(ref, batches)
    tracker = TrainingStateTracker(tmp_path / "ckpt", every_n_batches=1)
    net = make()
    IciDataParallelTrainingMaster(
        mesh=mesh22, state_tracker=tracker).execute_training(net,
                                                             batches[:3])
    fresh = make()
    master = IciDataParallelTrainingMaster(mesh=mesh22, state_tracker=tracker)
    assert master.resume(fresh) == 3
    np.testing.assert_array_equal(fresh.params_flat(), net.params_flat())
    np.testing.assert_array_equal(fresh.updater_state_flat(),
                                  net.updater_state_flat())
    master.execute_training(fresh, batches)
    np.testing.assert_array_equal(fresh.params_flat(), ref.params_flat())
    assert fresh.step == ref.step == 5
