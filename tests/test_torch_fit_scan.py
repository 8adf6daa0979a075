"""Port parity: fit_scan, the prefetching and chunking fit(iterator), and
the four iterators the port gained (INDArrayDataSetIterator,
SamplingDataSetIterator, AsyncDataSetIterator, IteratorDataSetIterator),
against the JAX package: the cases of JAX tests/test_fit_scan.py on the
port, then each against JAX on the same params and numpy data.

Tolerances (f32): params within 1e-6 of the largest |param| (fit_scan
against single steps on the port: bitwise; against JAX: the two sum the
products in other orders), scores within 1e-6 relative; iterators'
batches exact.
"""
import threading

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets import iterators as jit_
from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.models import zoo as jzoo
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu_torch.datasets import iterators as tit
from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.datasets.fetchers import IrisDataSetIterator
from deeplearning4j_tpu_torch.models import zoo as tzoo
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph as TGraph
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork as TNet
from deeplearning4j_tpu_torch.util import model_serializer as tms

REL = 1e-6


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


def _pair(name="mlp_iris", **kw):
    jnet = JNet(getattr(jzoo, name)(**kw)).init()
    tnet = TNet(getattr(tzoo, name)(**kw), device="cpu").init()
    tnet.set_params(tms.params_from_jax(
        [{k: np.asarray(v) for k, v in lp.items()} for lp in jnet.params]))
    return jnet, tnet


def _stacks(k=6, b=16, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(k, b, 4)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, (k, b))]
    return x, y


# -- JAX tests/test_fit_scan.py, on the port ----------------------------------

def test_fit_scan_matches_single_steps():
    x, y = _stacks()
    n1 = TNet(tzoo.mlp_iris(), device="cpu").init()
    n2 = TNet(tzoo.mlp_iris(), device="cpu").init()
    losses = n1.fit_scan(x, y)
    single = []
    for k in range(x.shape[0]):
        n2.fit_batch(x[k], y[k])
        single.append(n2.score_)
    np.testing.assert_array_equal(n1.params_flat(), n2.params_flat())
    np.testing.assert_array_equal(n1.updater_state_flat(),
                                  n2.updater_state_flat())
    np.testing.assert_array_equal(losses.numpy(), np.float32(single))
    assert n1.step == n2.step == 6


def test_fit_scan_matches_jax():
    x, y = _stacks(seed=1)
    jnet, tnet = _pair()
    jl = np.asarray(jnet.fit_scan(x, y))
    tl = tnet.fit_scan(x, y).numpy()
    _close(tl, jl, "losses")
    _close(tnet.params_flat(), jnet.params_flat(), "params")
    assert tnet.step == jnet.step == 6


def test_fit_iterator_chunks_and_trains():
    net = TNet(tzoo.mlp_iris(), device="cpu").init()
    net.scan_batches = 4
    it = IrisDataSetIterator(batch=30)
    calls = []
    scan = net.fit_scan
    net.fit_scan = lambda *a, **k: calls.append(len(a[0])) or scan(*a, **k)
    net.fit(it)
    first = net.score(x=it._data.features, y=it._data.labels)
    for _ in range(20):
        it.reset()
        net.fit(it)
    last = net.score(x=it._data.features, y=it._data.labels)
    assert last < first
    assert net.step == 21 * 5  # 5 minibatches per epoch all consumed
    assert calls == [4] * 21  # a chunk of 4, then one single step


def test_fit_iterator_matches_jax():
    """Chunks of scan_batches same-shape batches, then single steps (the
    short last run and the shorter last batch): the same params as JAX's
    fit(iterator)."""
    jnet, tnet = _pair()
    jnet.scan_batches = tnet.scan_batches = 3
    rng = np.random.default_rng(2)
    x = rng.normal(size=(100, 4)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 100)]
    jnet.fit(jit_.ListDataSetIterator(JDataSet(x, y), batch=12))
    tnet.fit(tit.ListDataSetIterator(DataSet(x, y), batch=12))
    assert tnet.step == jnet.step == 9
    _close(tnet.params_flat(), jnet.params_flat(), "params")
    _close([tnet.score_], [float(jnet.score_)], "score")


def test_scan_losses_monotone_reported():
    net = TNet(tzoo.mlp_iris(), device="cpu").init()
    scores = []

    class Collect:
        def iteration_done(self, model, iteration):
            scores.append((iteration, model.score_))

    net.add_listener(Collect())
    rng = np.random.default_rng(1)
    x = np.tile(rng.normal(size=(1, 32, 4)).astype(np.float32), (8, 1, 1))
    y = np.tile(np.eye(3, dtype=np.float32)[rng.integers(0, 3, (1, 32))],
                (8, 1, 1))
    net.fit_scan(x, y)
    assert len(scores) == 8
    assert scores[-1][1] < scores[0][1]
    assert [s[0] for s in scores] == list(range(1, 9))


def test_fit_scan_refusals():
    net = TNet(tzoo.char_rnn_lstm(vocab_size=11, hidden=16, tbptt=8),
               device="cpu").init()
    x = np.zeros((2, 4, 16, 11), np.float32)
    with pytest.raises(ValueError, match="tbptt_fwd_length"):
        net.fit_scan(x, x)
    one = TNet(tzoo.mlp_iris(), device="cpu").init()
    one.scan_batches = 1
    with pytest.raises(ValueError, match="SGD-class"):
        one.fit_scan(*_stacks())


def test_lenet_fits_flat_rows():
    net = TNet(tzoo.lenet_mnist(height=16, width=16), device="cpu").init()
    rng = np.random.default_rng(0)
    x = rng.uniform(size=(32, 256)).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, 32)]
    it = tit.ListDataSetIterator(DataSet(x, y), batch=16)
    net.fit(it)  # flat [N, h*w] rows adapted to NHWC
    it.reset()
    assert 0.0 <= net.evaluate(it).accuracy() <= 1.0
    assert tuple(net.output(np.zeros((2, 256), np.float32)).shape) == (2, 10)


def test_mlp_fits_iris():
    net = TNet(tzoo.mlp_iris(), device="cpu").init()
    it = IrisDataSetIterator(batch=50)
    net.fit(it)
    it.reset()
    assert 0.0 <= net.evaluate(it).accuracy() <= 1.0


def test_char_rnn_fits_tbptt_sequences():
    net = TNet(tzoo.char_rnn_lstm(vocab_size=11, hidden=16, tbptt=8),
               device="cpu").init()
    rng = np.random.default_rng(3)
    x = rng.normal(size=(4, 16, 11)).astype(np.float32)
    y = np.eye(11, dtype=np.float32)[rng.integers(0, 11, (4, 16))]
    net.fit(x, y)
    assert np.isfinite(net.score_) and net.step == 2


def test_graph_fit_scan_and_iterator_match_jax():
    from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
    kw = dict(vocab_size=7, d_model=8, n_heads=2, n_blocks=1)
    jg = JGraph(jzoo.transformer_lm(**kw)).init()
    tg = TGraph(tzoo.transformer_lm(**kw), device="cpu").init()
    tg.set_params(tms.params_from_jax(
        {n: {k: np.asarray(v) for k, v in lp.items()}
         for n, lp in jg.params.items()}))
    rng = np.random.default_rng(4)
    x = np.eye(7, dtype=np.float32)[rng.integers(0, 7, (4, 3, 5))]
    y = np.eye(7, dtype=np.float32)[rng.integers(0, 7, (4, 3, 5))]
    _close(tg.fit_scan([x], [y]).numpy(), np.asarray(jg.fit_scan([x], [y])),
           "losses")
    jg.scan_batches = tg.scan_batches = 2
    xs = x.reshape(12, 5, 7)
    ys = y.reshape(12, 5, 7)
    jg.fit(jit_.ListDataSetIterator(JDataSet(xs, ys), batch=4))
    tg.fit(tit.ListDataSetIterator(DataSet(xs, ys), batch=4))
    assert tg.step == jg.step == 7
    _close(tg.params_flat(), jg.params_flat(), "params")


# -- the four iterators -------------------------------------------------------

def _data(n=23, seed=5):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, 3)).astype(np.float32),
            np.eye(2, dtype=np.float32)[rng.integers(0, 2, n)])


def _batches(it):
    return [(ds.features.copy(), ds.labels.copy()) for ds in it]


def _same(a, b):
    assert len(a) == len(b)
    for (fa, la), (fb, lb) in zip(a, b):
        np.testing.assert_array_equal(np.asarray(fa), np.asarray(fb))
        np.testing.assert_array_equal(np.asarray(la), np.asarray(lb))


def test_indarray_iterator_matches_jax():
    x, y = _data()
    _same(_batches(tit.INDArrayDataSetIterator(x, y, batch=5)),
          _batches(jit_.INDArrayDataSetIterator(x, y, batch=5)))


def test_sampling_iterator_matches_jax():
    x, y = _data()
    t = tit.SamplingDataSetIterator(DataSet(x, y), batch=4, total_batches=6,
                                    seed=7)
    j = jit_.SamplingDataSetIterator(JDataSet(x, y), batch=4,
                                     total_batches=6, seed=7)
    first = _batches(t)
    _same(first, _batches(j))
    _same(_batches(t), first)  # reset restarts the draws


def test_iterator_dataset_iterator_matches_jax():
    x, y = _data(31)
    parts = [slice(0, 5), slice(5, 6), slice(6, 19), slice(19, 31)]
    t = tit.IteratorDataSetIterator([DataSet(x[s], y[s]) for s in parts], 7)
    j = jit_.IteratorDataSetIterator([JDataSet(x[s], y[s]) for s in parts], 7)
    _same(_batches(t), _batches(j))
    assert [d.num_examples() for d in t] == [7, 7, 7, 7, 3]


def test_async_iterator_prefetches_resets_and_raises():
    x, y = _data(40)
    under = tit.ListDataSetIterator(DataSet(x, y), batch=8)
    it = tit.AsyncDataSetIterator(under, queue_size=2)
    got = _batches(it)
    _same(got, _batches(tit.ListDataSetIterator(DataSet(x, y), batch=8)))
    _same(_batches(it), got)  # iterating again resets the worker

    class Boom(tit.ListDataSetIterator):
        def next_batch(self):
            if self._pos >= 16:
                raise RuntimeError("source failed")
            return super().next_batch()
    bad = tit.AsyncDataSetIterator(Boom(DataSet(x, y), batch=8))
    with pytest.raises(RuntimeError, match="source failed"):
        _batches(bad)
    assert threading.active_count() < 50


def test_prefetched_fit_matches_unprefetched():
    """fit(iterator) reads through the prefetching wrapper; an
    AsyncDataSetIterator handed in is iterated as it is: the same
    params."""
    x, y = _data(60)
    y = np.eye(3, dtype=np.float32)[np.argmax(y, 1)]
    x = np.concatenate([x, x[:, :1]], 1)
    a = TNet(tzoo.mlp_iris(), device="cpu").init()
    b = TNet(tzoo.mlp_iris(), device="cpu").init()
    a.fit(tit.ListDataSetIterator(DataSet(x, y), batch=10))
    b.fit(tit.AsyncDataSetIterator(
        tit.ListDataSetIterator(DataSet(x, y), batch=10)))
    np.testing.assert_array_equal(a.params_flat(), b.params_flat())
    assert a.step == b.step == 6
