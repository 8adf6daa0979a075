"""Port: the durable log broker (`serving/durable.py`) and the queue-fed
`ServeRoute` (`serving/streaming.py`).

- Every case of tests/test_streaming_durable.py, parametrised over the
  JAX module and the port's copy: torn tails, the producer's torn-tail
  truncation, a consumer SIGKILLed mid-stream in a subprocess,
  `commit_through` and its crash-replay property, and the
  `DurableStreamingTrainer` over each package's own net.
- Cross-package: a log, a cursor and a block file either package writes,
  the other reads, byte for byte; the single-writer lock is honoured
  across packages.
- The port's `ServeRoute` against tests/test_serving.py's case, its
  predictions equal to the port net's own output.
"""
import json
import os
import signal
import struct
import subprocess
import sys
import time
import zlib

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.serving import durable as jdurable
from deeplearning4j_tpu.serving import streaming as jstreaming
from deeplearning4j_tpu_torch.serving import durable as tdurable
from deeplearning4j_tpu_torch.serving import streaming as tstreaming

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DURABLE = {"jax": jdurable, "port": tdurable}
STREAMING = {"jax": jstreaming, "port": tstreaming}
MODULE = {pkg: d.__file__ for pkg, d in DURABLE.items()}

# the consumer loads its package's durable.py alone (stdlib only), not the
# package: the kill/restart cycle should not pay a framework import
CONSUMER_SCRIPT = r"""
import importlib.util, json, sys, time
spec = importlib.util.spec_from_file_location("durable", sys.argv[4])
durable = importlib.util.module_from_spec(spec)
spec.loader.exec_module(durable)
DurableLogConsumer = durable.DurableLogConsumer

log, out, batch = sys.argv[1], sys.argv[2], int(sys.argv[3])
c = DurableLogConsumer(log, group="workers")
with open(out, "a") as f:
    idle_until = time.monotonic() + 3.0
    while time.monotonic() < idle_until:
        recs = c.poll(batch)
        if not recs:
            time.sleep(0.01)
            continue
        idle_until = time.monotonic() + 3.0
        for r in recs:
            f.write(json.dumps(r) + "\n")
        f.flush()
        c.commit()   # commit AFTER processing
"""


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _frame(payload: bytes) -> bytes:
    return struct.Struct("<HII").pack(0xD14A, len(payload),
                                      zlib.crc32(payload)) + payload


# ---------------------------------------- the JAX cases, both packages --
@pytest.mark.parametrize("pkg", list(DURABLE))
def test_torn_tail_frame_not_delivered(tmp_path, pkg):
    d = DURABLE[pkg]
    log = str(tmp_path / "records.log")
    p = d.DurableLogProducer(log)
    p.send({"i": 0})
    p.flush()
    # a producer killed mid-append: half a frame
    frame = _frame(json.dumps({"i": 1}).encode())
    with open(log, "ab") as f:
        f.write(frame[:len(frame) - 4])
    c = d.DurableLogConsumer(log)
    assert [r["i"] for r in c.poll()] == [0]
    c.commit()
    # the producer completes the frame -> the record becomes visible
    with open(log, "ab") as f:
        f.write(frame[len(frame) - 4:])
    assert [r["i"] for r in c.poll()] == [1]
    p.close()


@pytest.mark.parametrize("pkg", list(DURABLE))
def test_producer_restart_truncates_torn_tail(tmp_path, pkg):
    d = DURABLE[pkg]
    log = str(tmp_path / "records.log")
    p = d.DurableLogProducer(log)
    p.send({"i": 0})
    p.close()
    frame = _frame(json.dumps({"i": "torn"}).encode())
    with open(log, "ab") as f:
        f.write(frame[:len(frame) - 3])  # killed mid-append
    p2 = d.DurableLogProducer(log)  # restart: truncates the torn tail
    p2.send({"i": 1})
    p2.close()
    c = d.DurableLogConsumer(log)
    assert [r["i"] for r in c.poll()] == [0, 1]


@pytest.mark.parametrize("pkg", list(DURABLE))
def test_kill_consumer_mid_stream_no_loss(tmp_path, pkg):
    """A producer streams 400 records while a consumer subprocess is
    SIGKILLed mid-stream and restarted: the union of processed records
    covers every produced record (duplicates allowed: at-least-once)."""
    d = DURABLE[pkg]
    log = str(tmp_path / "records.log")
    out = str(tmp_path / "processed.jsonl")
    env = {**os.environ, "PYTHONPATH": REPO, "JAX_PLATFORMS": "cpu",
           "OMP_NUM_THREADS": "1"}

    def spawn():
        return subprocess.Popen(
            [sys.executable, "-c", CONSUMER_SCRIPT, log, out, "16",
             MODULE[pkg]], env=env, cwd=str(tmp_path))

    producer = d.DurableLogProducer(log, fsync_every=8)
    consumer = spawn()
    killed = False
    for i in range(400):
        producer.send({"i": i})
        if i == 150:
            producer.flush()
            deadline = time.monotonic() + 60
            while time.monotonic() < deadline and (
                    not os.path.exists(out) or os.path.getsize(out) == 0):
                time.sleep(0.05)
            consumer.send_signal(signal.SIGKILL)
            consumer.wait()
            killed = True
            consumer = spawn()
    assert killed
    producer.close()
    assert consumer.wait(timeout=120) == 0
    seen = [json.loads(ln)["i"] for ln in open(out)]
    assert set(seen) == set(range(400)), (
        f"lost records: {sorted(set(range(400)) - set(seen))[:10]}")
    assert len(seen) >= 400


def _jax_net():
    from deeplearning4j_tpu.nn.conf.config import NeuralNetConfiguration
    from deeplearning4j_tpu.nn.conf.layers import DenseLayer, OutputLayer
    from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu.nn.updater.updaters import Sgd
    return MultiLayerNetwork(
        (NeuralNetConfiguration.builder().seed(3).learning_rate(0.5)
         .updater(Sgd()).list()
         .layer(DenseLayer(n_in=2, n_out=8, activation="tanh"))
         .layer(OutputLayer(n_in=8, n_out=2, activation="softmax",
                            loss="negativeloglikelihood"))
         .build())).init()


def _port_net():
    from deeplearning4j_tpu_torch.nn.conf.config import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.conf.layers import (DenseLayer,
                                                         OutputLayer)
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.nn.updater.updaters import Sgd
    return MultiLayerNetwork(
        (NeuralNetConfiguration.builder().seed(3).learning_rate(0.5)
         .updater(Sgd()).list()
         .layer(DenseLayer(n_in=2, n_out=8, activation="tanh"))
         .layer(OutputLayer(n_in=8, n_out=2, activation="softmax",
                            loss="negativeloglikelihood"))
         .build()), device="cpu").init()


NETS = {"jax": _jax_net, "port": _port_net}


@pytest.mark.parametrize("pkg", list(DURABLE))
def test_durable_trainer_resumes_training(tmp_path, pkg):
    """Train, 'crash' (drop the trainer mid-stream, the cursor committed
    per batch), resume with a NEW consumer in the same group: every
    record trains at least once and the model separates the classes."""
    d, st = DURABLE[pkg], STREAMING[pkg]
    rng = np.random.default_rng(0)
    log = str(tmp_path / "train.log")
    producer = d.DurableLogProducer(log)
    n = 512
    labels = rng.integers(0, 2, n)
    feats = rng.normal(size=(n, 2)) + labels[:, None] * 2.0
    for f, lab in zip(feats, labels):
        producer.send([float(f[0]), float(f[1]), int(lab)])
    producer.flush()

    net = NETS[pkg]()
    conv = st.RecordToDataSetConverter(label_index=-1, num_classes=2)
    seen = []
    t1 = d.DurableStreamingTrainer(
        net, d.DurableLogConsumer(log, group="train"), conv, batch_size=64,
        on_batch=lambda recs: seen.extend(recs))
    t1.run_until_idle(idle_timeout=0.2, max_records=192)
    assert t1.records_trained == 192
    t2 = d.DurableStreamingTrainer(
        net, d.DurableLogConsumer(log, group="train"), conv, batch_size=64,
        on_batch=lambda recs: seen.extend(recs))
    t2.run_until_idle(idle_timeout=0.2)
    assert len(seen) >= n
    out = net.output(feats.astype(np.float32))
    out = out.detach().cpu().numpy() if isinstance(out, torch.Tensor) \
        else np.asarray(out)
    acc = float((out.argmax(1) == labels).mean())
    assert acc > 0.9, acc
    producer.close()


@pytest.mark.parametrize("pkg", list(DURABLE))
def test_commit_through_partial_batch(tmp_path, pkg):
    d = DURABLE[pkg]
    log = str(tmp_path / "p.log")
    p = d.DurableLogProducer(log)
    for i in range(10):
        p.send({"id": i})
    p.close()
    c = d.DurableLogConsumer(log, group="g")
    assert [r["id"] for r in c.poll(6)] == list(range(6))
    c.commit_through(4)
    c2 = d.DurableLogConsumer(log, group="g")
    assert [r["id"] for r in c2.poll(100)] == list(range(4, 10))
    c2.commit_through(3)
    c3 = d.DurableLogConsumer(log, group="g")
    assert [r["id"] for r in c3.poll(100)] == list(range(7, 10))
    c3.commit_through(0)
    with pytest.raises(ValueError):
        c3.commit_through(99)
    c3.commit()
    assert d.DurableLogConsumer(log, group="g").poll(100) == []


@pytest.mark.parametrize("pkg", list(DURABLE))
def test_commit_through_crash_replay_exactly_once_property(tmp_path, pkg):
    """Random poll sizes, partial commits and crash-replays: every record
    covered, nothing durable ever redelivered, and the run exercised
    replay (duplicates delivered and deduplicated)."""
    d = DURABLE[pkg]
    rng = np.random.default_rng(1234)
    log = str(tmp_path / "prop.log")
    n = 200
    p = d.DurableLogProducer(log)
    for i in range(n):
        p.send({"id": i})
    p.close()
    processed, done, uncommitted = [], set(), []
    watermark, crashes = -1, 0
    c = d.DurableLogConsumer(log, group="g")
    for _step in range(10_000):
        if len(done) == n and watermark == n - 1:
            break
        if rng.random() < 0.15:
            c = d.DurableLogConsumer(log, group="g")
            uncommitted = []
            crashes += 1
            continue
        for r in c.poll(int(rng.integers(1, 17))):
            assert r["id"] > watermark, (r["id"], watermark)
            processed.append(r["id"])
            done.add(r["id"])
            uncommitted.append(r["id"])
        if uncommitted and rng.random() < 0.7:
            k = int(rng.integers(0, len(uncommitted) + 1))
            c.commit_through(k)
            if k:
                watermark = uncommitted[k - 1]
                del uncommitted[:k]
    else:
        raise AssertionError("property loop never converged")
    assert done == set(range(n)), "records lost"
    assert crashes > 0 and len(processed) > n


# ----------------------------------------------- across the packages --
@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_log_written_by_one_package_reads_in_the_other(tmp_path, writer,
                                                       reader):
    """The frames are the shared format: the same records, byte for byte
    the same file, a torn tail truncated by the other package's producer,
    and a committed cursor resumed by the other package's consumer."""
    recs = [{"i": i, "s": "x" * i, "f": i / 7} for i in range(40)]
    paths = {}
    for pkg in ("jax", "port"):
        paths[pkg] = str(tmp_path / f"{pkg}.log")
        p = DURABLE[pkg].DurableLogProducer(paths[pkg])
        for r in recs:
            p.send(r)
        p.close()
    with open(paths["jax"], "rb") as a, open(paths["port"], "rb") as b:
        assert a.read() == b.read()
    log = paths[writer]
    c = DURABLE[writer].DurableLogConsumer(log, group="g")
    assert c.poll(10) == recs[:10]
    c.commit()
    c2 = DURABLE[reader].DurableLogConsumer(log, group="g")
    assert c2.poll(100) == recs[10:]
    frame = _frame(json.dumps({"i": "torn"}).encode())
    with open(log, "ab") as f:
        f.write(frame[:-2])
    p = DURABLE[reader].DurableLogProducer(log)  # truncates the torn tail
    p.send({"i": 40})
    p.close()
    assert DURABLE[writer].DurableLogConsumer(log, group="h").poll(100) \
        == recs + [{"i": 40}]


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_block_files_and_writer_lock_cross_packages(tmp_path, writer,
                                                    reader):
    payload = bytes(range(256)) * 7
    path = str(tmp_path / "blk")
    DURABLE[writer].write_block_file(path, payload)
    assert DURABLE[reader].read_block_file(path) == payload
    with open(path, "r+b") as f:
        f.truncate(100)
    assert DURABLE[reader].read_block_file(path) is None
    # one live producer per log, whichever package holds it
    log = str(tmp_path / "locked.log")
    p = DURABLE[writer].DurableLogProducer(log)
    with pytest.raises(RuntimeError, match="locked"):
        DURABLE[reader].DurableLogProducer(log)
    p.close()
    DURABLE[reader].DurableLogProducer(log).close()


# ------------------------------------------------------------ ServeRoute --
def test_serve_route_batches_port():
    """tests/test_serving.py's ServeRoute case on the port: 12 records
    through the route, predictions equal the net's own output."""
    net = _port_net()
    rng = np.random.default_rng(5)
    x = rng.normal(size=(12, 2)).astype(np.float32)
    got = []
    route = tstreaming.ServeRoute(
        net, tstreaming.RecordToDataSetConverter(label_index=None),
        on_prediction=lambda out: got.append(out), max_batch=5).start()
    for row in x:
        route.send([float(v) for v in row])
    route.stop()
    assert all(isinstance(o, np.ndarray) for o in got)
    preds = np.concatenate(got)
    assert preds.shape == (12, 2)
    want = net.output(x).detach().cpu().numpy()
    np.testing.assert_allclose(preds, want, rtol=1e-6, atol=1e-7)


def test_serve_route_fails_fast_after_consumer_death():
    class Boom:
        def output(self, x):
            raise ValueError("boom")

    route = tstreaming.ServeRoute(
        Boom(), tstreaming.RecordToDataSetConverter(label_index=None),
        on_prediction=lambda out: None, poll_timeout=0.05).start()
    route.send([1.0, 2.0])
    deadline = time.monotonic() + 10
    while route.error is None and time.monotonic() < deadline:
        time.sleep(0.01)
    with pytest.raises(RuntimeError, match="consumer died"):
        route.send([1.0, 2.0])
    with pytest.raises(ValueError, match="boom"):
        route.stop()
