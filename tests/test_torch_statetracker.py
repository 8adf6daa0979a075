"""Port parity: fault tolerance — the training state tracker, its async
writer, resumable training and the configuration registry (ROADMAP
A7.2.3).

The cases of tests/test_fault_tolerance.py (6), tests/test_async_
checkpoint.py (6) and the registry case of tests/test_long_tail.py:157 on
`deeplearning4j_tpu_torch.parallel.statetracker` / `.registry`, on the
CPU. A checkpoint is the shared model zip plus ``cursor.json``, so the
packages restore each other's checkpoints with the same params (the host
RNG state in the cursor is each package's own: the port's ``torch_rng``,
JAX's ``rng_key``). `fit_with_recovery` in both packages on the same data
and weights agrees within 1e-5 of each parameter's largest |value|.

The masters: rank 0 is this process, followers are spawned ranks on
``devices=["cpu"] * n`` over gloo, one torch thread a rank. The ICI and
parameter-averaging masters checkpoint from the driver and `resume()`
restores there, re-syncing the followers; the elastic case kills the
follower of a 2-rank fit mid-job (the driver's next collective raises),
disables it in the roster, restarts on one rank from the cursor and
reaches the uninterrupted 2-rank run's params within 1e-5 (the ranks sum
their shards in another order than one rank). Every collective carries
a 60 s timeout; meshes are killed at the end of each case.
"""
import os
import signal
import subprocess
import sys
import textwrap
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.datasets.iterators import \
    ListDataSetIterator as JListIt
from deeplearning4j_tpu.models.zoo import mlp_iris as jmlp
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu.parallel import statetracker as jst
from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.datasets.iterators import ListDataSetIterator
from deeplearning4j_tpu_torch.models.zoo import mlp_iris
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.parallel import mesh as tmesh
from deeplearning4j_tpu_torch.parallel.registry import ConfigurationRegistry
from deeplearning4j_tpu_torch.parallel.statetracker import (
    AsyncTrainingStateTracker, TrainingStateTracker, fit_with_recovery)
from deeplearning4j_tpu_torch.parallel.trainer import (
    IciDataParallelTrainingMaster, ParameterAveragingTrainingMaster)
from deeplearning4j_tpu_torch.util import model_serializer
from deeplearning4j_tpu_torch.util.model_serializer import params_from_jax

ROOT = str(Path(__file__).resolve().parent.parent)
TIMEOUT = 60.0
REL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _net():
    return MultiLayerNetwork(mlp_iris(), device="cpu").init()


def _make_iterator(epoch: int):
    rng = np.random.default_rng(100 + epoch)
    x = rng.normal(size=(60, 4)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 60)]
    return ListDataSetIterator(DataSet(x, y), batch=10)


def _run_clean(tmp_path, tag):
    net = _net()
    tracker = TrainingStateTracker(tmp_path / tag, every_n_batches=4)
    fit_with_recovery(net, _make_iterator, epochs=2, tracker=tracker)
    return net


def _close(a, b, what):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, what
    assert np.abs(a - b).max() <= REL * max(float(np.abs(b).max()), 1e-30), \
        (what, float(np.abs(a - b).max()))


# ------------------------------------------ tests/test_fault_tolerance.py --
def test_resume_reaches_identical_state(tmp_path):
    """Interrupt after a checkpoint, restore into a FRESH net, finish:
    params and updater state equal the uninterrupted run's bitwise."""
    ref = _run_clean(tmp_path, "ref")
    net = _net()
    tracker = TrainingStateTracker(tmp_path / "int", every_n_batches=4)
    for bi, ds in enumerate(_make_iterator(0)):
        net.fit_batch(ds.features, ds.labels)
        tracker.batch_done(net, {"epoch": 0, "batch": bi + 1})
    del net
    net2 = _net()
    fit_with_recovery(net2, _make_iterator, epochs=2, tracker=tracker)
    np.testing.assert_array_equal(ref.params_flat(), net2.params_flat())
    np.testing.assert_array_equal(ref.updater_state_flat(),
                                  net2.updater_state_flat())
    assert net2.step == ref.step


def test_corrupt_checkpoint_falls_back(tmp_path):
    net = _net()
    tracker = TrainingStateTracker(tmp_path / "c", every_n_batches=1,
                                   keep_last=3)
    for i, ds in enumerate(_make_iterator(0)):
        net.fit_batch(ds.features, ds.labels)
        tracker.batch_done(net, {"epoch": 0, "batch": i + 1})
    good = net.params_flat()
    paths = sorted((tmp_path / "c").glob("ckpt-*.zip"))
    assert len(paths) == 3  # keep_last honored
    with open(paths[-1], "r+b") as fh:  # torn write
        fh.truncate(100)
    net2 = _net()
    cursor = TrainingStateTracker(tmp_path / "c").restore(net2)
    assert cursor["batch"] == 5  # fell back to the previous intact one
    assert net2.step == net.step - 1
    assert not np.array_equal(net2.params_flat(), good)


def test_worker_lifecycle_registry(tmp_path):
    t = TrainingStateTracker(tmp_path / "w")
    t.add_worker("host0")
    t.add_worker("host1")
    t.disable_worker("host1")
    assert t.workers() == ["host0", "host1"]
    assert t.enabled_workers() == ["host0"]
    # the roster persists: a restarted job reads it back
    assert TrainingStateTracker(tmp_path / "w").enabled_workers() == ["host0"]
    t.add_worker("host1")  # an existing record wins over a re-register
    assert t.enabled_workers() == ["host0"]
    t.enable_worker("host1")
    assert t.enabled_workers() == ["host0", "host1"]


_CHILD = textwrap.dedent("""
    import os, sys, time
    import numpy as np
    import torch
    torch.set_num_threads(1)
    sys.path.insert(0, {repo!r})
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.datasets.iterators import \\
        ListDataSetIterator
    from deeplearning4j_tpu_torch.models.zoo import mlp_iris
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.parallel.statetracker import (
        TrainingStateTracker, fit_with_recovery)

    def make_iterator(epoch):
        rng = np.random.default_rng(100 + epoch)
        x = rng.normal(size=(60, 4)).astype(np.float32)
        y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 60)]
        return ListDataSetIterator(DataSet(x, y), batch=10)

    slow = os.environ.get("SLOW_BATCHES") == "1"
    net = MultiLayerNetwork(mlp_iris(), device="cpu").init()
    tracker = TrainingStateTracker({ckpt!r}, every_n_batches=2)
    if slow:  # give the parent a window to SIGKILL mid-training
        orig = net.fit_batch
        def slow_fit(*a, **k):
            out = orig(*a, **k)
            time.sleep(0.25)
            return out
        net.fit_batch = slow_fit
    fit_with_recovery(net, make_iterator, epochs=2, tracker=tracker)
    np.save({out!r}, net.params_flat())
    print("DONE", net.step)
""")


def test_sigkill_recovery_subprocess(tmp_path):
    """SIGKILL a port training subprocess mid-run; rerunning it resumes
    from the checkpoint and finishes with the uninterrupted run's
    params."""
    ckpt = str(tmp_path / "ckpt")
    out = str(tmp_path / "params.npy")
    script = tmp_path / "child.py"
    script.write_text(_CHILD.format(repo=ROOT, ckpt=ckpt, out=out))
    env = dict(os.environ, SLOW_BATCHES="1")
    proc = subprocess.Popen([sys.executable, str(script)], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    deadline = time.time() + 120
    while time.time() < deadline:
        if list(Path(ckpt).glob("ckpt-*.zip")):
            break
        if proc.poll() is not None:
            raise AssertionError(
                f"child exited early: {proc.communicate()[1].decode()}")
        time.sleep(0.05)
    else:
        proc.kill()
        raise AssertionError("no checkpoint appeared within 120s")
    time.sleep(0.3)
    proc.send_signal(signal.SIGKILL)
    proc.wait()
    assert not Path(out).exists()
    env["SLOW_BATCHES"] = "0"
    cp = subprocess.run([sys.executable, str(script)], env=env,
                        capture_output=True, timeout=300)
    assert cp.returncode == 0, cp.stderr.decode()
    ref = _run_clean(tmp_path, "ref")
    np.testing.assert_array_equal(ref.params_flat(), np.load(out))


def _batches(n=8, rows=16, seed=9):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        x = rng.normal(size=(rows, 4)).astype(np.float32)
        y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, rows)]
        out.append(DataSet(x, y))
    return out


@pytest.mark.parametrize("kind", ["ici", "pa"])
def test_master_resume_over_ranks(kind, tmp_path):
    """Master-level resume over 2 gloo ranks (JAX :161): checkpoint from
    the driver, "crash" after 5 batches, restore into a FRESH net and
    master, which skips the 5 batches and re-syncs its followers; the
    final params equal the uninterrupted run's."""
    def master(mesh, tracker=None):
        if kind == "ici":
            return IciDataParallelTrainingMaster(mesh=mesh,
                                                 state_tracker=tracker)
        return ParameterAveragingTrainingMaster(
            batch_size_per_worker=8, mesh=mesh, state_tracker=tracker)

    mesh = tmesh.default_mesh(2, ["cpu"] * 2, timeout=TIMEOUT).start()
    try:
        ref = _net()
        master(mesh).execute_training(ref, _batches())
        net = _net()
        tr = TrainingStateTracker(tmp_path / kind, every_n_batches=1)
        master(mesh, tr).execute_training(net, _batches()[:5])
        at5 = net.params_flat()
        del net
        net2 = _net()
        m2 = master(mesh, TrainingStateTracker(tmp_path / kind,
                                               every_n_batches=1))
        assert m2.resume(net2) == 5
        np.testing.assert_array_equal(net2.params_flat(), at5)
        m2.execute_training(net2, _batches())
        np.testing.assert_array_equal(ref.params_flat(), net2.params_flat())
        assert net2.step == ref.step
    finally:
        mesh.kill()


def test_graph_resume_reaches_identical_state(tmp_path):
    """fit_with_recovery on a ComputationGraph; the newest checkpoint
    lands mid-epoch (batch 4 of 6), so resume replays the lost tail."""
    from deeplearning4j_tpu_torch.nn.conf.config import \
        NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.conf.layers import (DenseLayer,
                                                         OutputLayer)
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph

    def build():
        conf = (NeuralNetConfiguration.builder().seed(4).learning_rate(0.1)
                .graph_builder().add_inputs("in")
                .add_layer("h", DenseLayer(n_in=4, n_out=8,
                                           activation="tanh"), "in")
                .add_layer("out", OutputLayer(n_in=8, n_out=3,
                                              activation="softmax",
                                              loss="negativeloglikelihood"),
                           "h")
                .set_outputs("out").build())
        return ComputationGraph(conf, device="cpu").init()

    ref = build()
    fit_with_recovery(ref, _make_iterator, epochs=2,
                      tracker=TrainingStateTracker(tmp_path / "gref",
                                                   every_n_batches=4))
    net = build()
    tracker = TrainingStateTracker(tmp_path / "gint", every_n_batches=4)
    for bi, ds in enumerate(_make_iterator(0)):
        net.fit(ds)
        tracker.batch_done(net, {"epoch": 0, "batch": bi + 1})
    del net
    net2 = build()
    fit_with_recovery(net2, _make_iterator, epochs=2, tracker=tracker)
    np.testing.assert_array_equal(ref.params_flat(), net2.params_flat())


# ------------------------------------------ tests/test_async_checkpoint.py --
def _net_and_data(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((64, 4)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 64)]
    return _net(), x, y


def _gated(monkeypatch):
    gate, entered = threading.Event(), threading.Event()
    orig = model_serializer.write_model

    def gated_write(n, path, save_updater=True):
        entered.set()
        assert gate.wait(30), "test gate never opened"
        orig(n, path, save_updater=save_updater)

    monkeypatch.setattr(model_serializer, "write_model", gated_write)
    return gate, entered


def test_save_is_nonblocking_and_snapshot_consistent(tmp_path, monkeypatch):
    """save() returns while the write is in flight; training goes on; the
    checkpoint restores the params, step and generator AT the snapshot."""
    net, x, y = _net_and_data()
    for _ in range(5):
        net.fit_batch(x, y)
    at_save = net.params_flat().copy()
    at_save_step = net.step
    at_save_rng = net._gen.get_state().clone()
    gate, entered = _gated(monkeypatch)
    with AsyncTrainingStateTracker(tmp_path, every_n_batches=1) as tracker:
        fut = tracker.save(net, {"epoch": 0, "batch": 5})
        assert entered.wait(30)
        assert not fut.done()
        for _ in range(5):
            net.fit_batch(x, y)
        torch.rand(3, generator=net._gen)  # the generator moves on too
        assert not np.allclose(net.params_flat(), at_save)
        gate.set()
        path = tracker.wait()
        assert path is not None and path.exists()
        fresh = _net()
        cursor = tracker.restore(fresh)
    assert cursor["batch"] == 5
    assert fresh.step == at_save_step
    np.testing.assert_array_equal(fresh.params_flat(), at_save)
    assert torch.equal(fresh._gen.get_state(), at_save_rng)


def test_async_artifact_equals_sync_artifact(tmp_path):
    net, x, y = _net_and_data(1)
    for _ in range(8):
        net.fit_batch(x, y)
    sync_t = TrainingStateTracker(tmp_path / "sync", every_n_batches=1)
    sync_t.save(net, {"epoch": 1, "batch": 8})
    with AsyncTrainingStateTracker(tmp_path / "async",
                                   every_n_batches=1) as async_t:
        async_t.save(net, {"epoch": 1, "batch": 8})
        async_t.wait()
        a, b = _net(), _net()
        cur_s = sync_t.restore(a)
        cur_a = async_t.restore(b)
    np.testing.assert_array_equal(a.params_flat(), b.params_flat())
    np.testing.assert_array_equal(a.updater_state_flat(),
                                  b.updater_state_flat())
    assert a.step == b.step
    assert cur_s["batch"] == cur_a["batch"] == 8


def test_fit_with_recovery_on_async_tracker(tmp_path):
    def make_it(_epoch):
        rng = np.random.default_rng(42)
        x = rng.standard_normal((96, 4)).astype(np.float32)
        y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 96)]
        return iter([DataSet(x[i:i + 32], y[i:i + 32]) for i in (0, 32, 64)])

    net_s, _, _ = _net_and_data(2)
    fit_with_recovery(net_s, make_it, epochs=2,
                      tracker=TrainingStateTracker(tmp_path / "s",
                                                   every_n_batches=2))
    net_a, _, _ = _net_and_data(2)
    with AsyncTrainingStateTracker(tmp_path / "a",
                                   every_n_batches=2) as tracker:
        fit_with_recovery(net_a, make_it, epochs=2, tracker=tracker)
        assert tracker.latest() is not None
    np.testing.assert_array_equal(net_s.params_flat(), net_a.params_flat())


def test_batch_counter_not_wiped_by_slow_writer(tmp_path, monkeypatch):
    net, x, y = _net_and_data(5)
    net.fit_batch(x, y)
    gate, entered = _gated(monkeypatch)
    with AsyncTrainingStateTracker(tmp_path, every_n_batches=3) as tracker:
        for _ in range(3):
            tracker.batch_done(net, {})
        assert entered.wait(30)
        tracker.batch_done(net, {})
        tracker.batch_done(net, {})
        gate.set()
        tracker.wait()
        assert tracker._since_save == 2


def _boom(msg):
    def boom(n, path, save_updater=True):
        raise OSError(msg)
    return boom


def test_master_path_surfaces_writer_error(tmp_path, monkeypatch):
    """The masters make the last async save durable before they return:
    a background write failure surfaces on the training thread."""
    net, x, y = _net_and_data(6)
    monkeypatch.setattr(model_serializer, "write_model",
                        _boom("checkpoint disk gone"))
    tracker = AsyncTrainingStateTracker(tmp_path, every_n_batches=1)
    master = IciDataParallelTrainingMaster(state_tracker=tracker)
    with pytest.raises(OSError, match="checkpoint disk gone"):
        master.execute_training(net, [DataSet(x, y)])
    tracker._writer.shutdown(wait=True)


def test_writer_error_surfaces_on_training_thread(tmp_path, monkeypatch):
    net, x, y = _net_and_data(3)
    net.fit_batch(x, y)
    monkeypatch.setattr(model_serializer, "write_model", _boom("disk gone"))
    tracker = AsyncTrainingStateTracker(tmp_path, every_n_batches=1)
    tracker.save(net, {})
    with pytest.raises(OSError, match="disk gone"):
        tracker.save(net, {})
    tracker._writer.shutdown(wait=True)


# ----------------------------------------- tests/test_long_tail.py:157 ----
def test_configuration_registry(tmp_path):
    from deeplearning4j_tpu.parallel.registry import \
        ConfigurationRegistry as JRegistry
    reg = ConfigurationRegistry(tmp_path / "reg")
    conf = mlp_iris()
    reg.register("worker-conf", conf)
    reg.register("hyper", {"lr": 0.1, "batch": 32})
    assert set(reg.keys()) == {"worker-conf", "hyper"}
    back = reg.retrieve("worker-conf")
    assert type(back).__name__ == "MultiLayerConfiguration"
    assert back.to_json() == conf.to_json()
    assert reg.retrieve("hyper") == {"lr": 0.1, "batch": 32}
    # the JAX registry reads the port's entries, and the reverse
    jreg = JRegistry(tmp_path / "reg")
    assert jreg.retrieve("worker-conf").to_json() == jmlp().to_json()
    jreg.register("from-jax", jmlp())
    assert reg.retrieve("from-jax").to_json() == conf.to_json()
    assert reg.delete("hyper") and reg.retrieve("hyper") is None
    with pytest.raises(ValueError):
        reg.register("../escape", {})


# --------------------------------------------- across the two packages --
def _jnet_and_port_copy():
    jnet = JNet(jmlp()).init()
    tnet = _net()
    tnet.set_params(params_from_jax([{k: np.asarray(a) for k, a in lp.items()}
                                     for lp in jnet.params]))
    return jnet, tnet


def _jmake_iterator(epoch: int):
    rng = np.random.default_rng(100 + epoch)
    x = rng.normal(size=(60, 4)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 60)]
    return JListIt(JDataSet(x, y), batch=10)


def test_checkpoints_cross_between_the_packages(tmp_path):
    """A port checkpoint restores in JAX's TrainingStateTracker, and a JAX
    checkpoint in the port's, with the same params, updater state, step
    and cursor."""
    jnet, tnet = _jnet_and_port_copy()
    for ds in _make_iterator(0):
        tnet.fit_batch(ds.features, ds.labels)
    TrainingStateTracker(tmp_path / "p").save(tnet, {"epoch": 0, "batch": 6})
    fresh_j = JNet(jmlp()).init()
    cur = jst.TrainingStateTracker(tmp_path / "p").restore(fresh_j)
    assert cur is not None and cur["batch"] == 6
    np.testing.assert_array_equal(np.asarray(fresh_j.params_flat()),
                                  tnet.params_flat())
    np.testing.assert_array_equal(np.asarray(fresh_j.updater_state_flat()),
                                  tnet.updater_state_flat())
    assert fresh_j.step == tnet.step
    for ds in _jmake_iterator(1):
        jnet.fit_batch(ds.features, ds.labels)
    jst.TrainingStateTracker(tmp_path / "j").save(jnet, {"epoch": 1,
                                                         "batch": 6})
    fresh_t = _net()
    cur = TrainingStateTracker(tmp_path / "j").restore(fresh_t)
    assert cur is not None and cur["epoch"] == 1 and "rng_key" not in cur
    np.testing.assert_array_equal(fresh_t.params_flat(),
                                  np.asarray(jnet.params_flat()))
    np.testing.assert_array_equal(fresh_t.updater_state_flat(),
                                  np.asarray(jnet.updater_state_flat()))
    assert fresh_t.step == jnet.step


def test_fit_with_recovery_matches_jax(tmp_path):
    """fit_with_recovery in both packages, on the same weights and data,
    with an interruption and a resume in each: params within 1e-5."""
    jnet, tnet = _jnet_and_port_copy()
    jt = jst.TrainingStateTracker(tmp_path / "j", every_n_batches=4)
    tt = TrainingStateTracker(tmp_path / "t", every_n_batches=4)
    for i, (jd, td) in enumerate(zip(_jmake_iterator(0),
                                     _make_iterator(0))):
        jnet.fit_batch(jd.features, jd.labels)
        tnet.fit_batch(td.features, td.labels)
        jt.batch_done(jnet, {"epoch": 0, "batch": i + 1})
        tt.batch_done(tnet, {"epoch": 0, "batch": i + 1})
    j2, t2 = JNet(jmlp()).init(), _net()
    jst.fit_with_recovery(j2, _jmake_iterator, epochs=2, tracker=jt)
    fit_with_recovery(t2, _make_iterator, epochs=2, tracker=tt)
    assert t2.step == j2.step
    _close(t2.params_flat(), np.asarray(j2.params_flat()), "params")


def test_elastic_restart_kill_one_of_two(tmp_path):
    """The elastic story (JAX tests/test_multihost.py:137): a 2-rank ICI
    fit under fit_with_recovery loses its follower to SIGKILL mid-fit and
    the driver's next collective raises; the restart disables the dead
    worker in the roster, runs on the one rank left, replays from the
    cursor, and reaches the uninterrupted 2-rank run's params."""
    def make_it(epoch):
        return _batches(n=12, seed=1234 + epoch)

    mesh = tmesh.default_mesh(2, ["cpu"] * 2, timeout=TIMEOUT).start()
    try:
        ref = _net()
        fit_with_recovery(ref, make_it, epochs=1,
                          tracker=TrainingStateTracker(tmp_path / "ref",
                                                       every_n_batches=1),
                          master=IciDataParallelTrainingMaster(mesh=mesh))

        class KillAt:
            def __init__(self, at):
                self.at = at

            def iteration_done(self, net, step):
                if step == self.at:
                    os.kill(mesh._procs[0].pid, signal.SIGKILL)
                    mesh._procs[0].join(10)

        ckpt = tmp_path / "ckpt"
        tracker = TrainingStateTracker(ckpt, every_n_batches=1)
        tracker.add_worker("rank0")
        tracker.add_worker("rank1")
        net = _net()
        net.listeners.append(KillAt(5))
        with pytest.raises(tmesh.MeshError):
            fit_with_recovery(net, make_it, epochs=1, tracker=tracker,
                              master=IciDataParallelTrainingMaster(
                                  mesh=mesh))
        assert not mesh.alive()
    finally:
        mesh.kill()
    # the restarted job: the roster minus the dead worker
    tracker = TrainingStateTracker(ckpt, every_n_batches=1)
    tracker.disable_worker("rank1")
    live = TrainingStateTracker(ckpt).enabled_workers()
    assert live == ["rank0"]
    one = tmesh.default_mesh(len(live), ["cpu"] * len(live))
    net2 = _net()
    fit_with_recovery(net2, make_it, epochs=1, tracker=tracker,
                      master=IciDataParallelTrainingMaster(mesh=one))
    assert net2.step == ref.step
    _close(net2.params_flat(), ref.params_flat(), "params")
