"""Port parity: ComputationGraph vertices, preprocessors, BatchNorm
variables, the graph methods and graph zips with ``variables.bin``.

Each graph is built with the JAX package's builder; the port reads its
config JSON and takes the JAX graph's params and variables
(`params_from_jax`, `variables_from_jax`). Inputs are made with numpy
from a seed. The JAX side runs its XLA defaults on the CPU (no Pallas
kernel is registered); the port runs its kernels' plain versions on CPU
tensors.

Adam runs with epsilon 1e-4 in the multi-step cases: its first steps
move a parameter by about lr * g / (|g| + eps), so a gradient within
roundoff of the default eps (1e-8) takes a step that depends on its
rounding (one of 2048 dense weights did in the conv+BN graph).

Tolerances (f32):
  - forward outputs and feed_forward activations: max |diff| <= 1e-5;
  - params and running statistics after one SGD step or 5 Adam steps,
    fit_scan, fit_batch_accumulated or 3 iterations of a line-search
    solver: max |diff| <= 1e-5;
  - zips written by either package and read by the other: the outputs
    within 1e-6, the params, variables and updater state exact.
"""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from deeplearning4j_tpu import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.conf import graph as jg
from deeplearning4j_tpu.nn.conf import layers as jl
from deeplearning4j_tpu.nn.conf import preprocessors as jp
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.nn.updater.updaters import Adam as JAdam
from deeplearning4j_tpu.nn.updater.updaters import Sgd as JSgd
from deeplearning4j_tpu.util import model_serializer as jms
from deeplearning4j_tpu_torch.nn.conf.graph import \
    ComputationGraphConfiguration as TConf
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph as TGraph
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.util import model_serializer as tms

REPO = Path(__file__).resolve().parents[1]
TOL = 1e-5
B, F, T = 6, 6, 5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tier-1 runs several test files at once on a few cores; one torch
    intra-op thread keeps this file from starving the others' timings."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return {k: {n: np.asarray(a) for n, a in lp.items()}
            for k, lp in tree.items()}


def _pair(jconf):
    """(JAX graph, port graph on the CPU with its params and variables)."""
    jnet = JGraph(jconf).init()
    tnet = TGraph(TConf.from_json(jconf.to_json()), device="cpu").init()
    tnet.set_params(tms.params_from_jax(_np(jnet.params)))
    tnet.set_variables(tms.variables_from_jax(_np(jnet.variables)))
    return jnet, tnet


def _builder(updater=None, lr=0.1, seed=3):
    return (JNNC.builder().seed(seed).learning_rate(lr)
            .updater(updater or JSgd()).graph_builder())


def _onehot(n, c, seed):
    return np.eye(c, dtype=np.float32)[
        np.random.default_rng(seed).integers(0, c, n)]


def _rand(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _gap_params(jnet, tnet):
    return float(np.abs(jnet.params_flat() - tnet.params_flat()).max())


def _gap_vars(jnet, tnet):
    gaps = [float(np.abs(np.asarray(jnet.variables[k][n])
                         - tnet.variables[k][n].numpy()).max())
            for k in jnet.variables for n in jnet.variables[k]]
    return max(gaps, default=0.0)


def _out(net, *xs):
    return np.asarray(net.output(*xs)[0])


# -- each vertex and preprocessor: forward and one SGD step ---------------------

def _ff_case(kind):
    """A feed-forward graph over input "in" [B, F] with the vertex or
    preprocessor under test before a dense layer."""
    gb = _builder().add_inputs("in")
    n_in, src, pre = F, "in", None
    if kind == "subset":
        gb.add_vertex("v", jg.SubsetVertex(from_idx=1, to_idx=4), "in")
        n_in, src = 4, "v"
    elif kind == "scale":
        gb.add_vertex("v", jg.ScaleVertex(scale_factor=0.5), "in")
        src = "v"
    elif kind == "zero_mean_vertex":
        gb.add_vertex("v", jg.PreprocessorVertex(
            preprocessor=jp.ZeroMeanPrePreProcessor()), "in")
        src = "v"
    elif kind == "unit_variance_on_layer":
        pre = jp.UnitVarianceProcessor()
    elif kind == "composable_on_layer":
        pre = jp.ComposableInputPreProcessor(processors=[
            jp.ZeroMeanPrePreProcessor(), jp.UnitVarianceProcessor()])
    elif kind == "merge_elementwise":
        gb.add_layer("a", jl.DenseLayer(n_in=F, n_out=4, activation="tanh"),
                     "in")
        gb.add_layer("b", jl.DenseLayer(n_in=F, n_out=4,
                                        activation="sigmoid"), "in")
        gb.add_vertex("m", jg.ElementWiseVertex(op="product"), "a", "b")
        gb.add_vertex("v", jg.MergeVertex(), "m", "a")
        n_in, src = 8, "v"
    gb.add_layer("d", jl.DenseLayer(n_in=n_in, n_out=5, activation="tanh"),
                 src, preprocessor=pre)
    gb.add_layer("out", jl.OutputLayer(n_in=5, n_out=3, activation="softmax",
                                       loss="negativeloglikelihood"), "d")
    gb.set_outputs("out")
    return gb.build()


@pytest.mark.parametrize("kind", ["subset", "scale", "zero_mean_vertex",
                                  "unit_variance_on_layer",
                                  "composable_on_layer", "merge_elementwise"])
def test_vertex_forward_and_sgd_step(kind):
    jnet, tnet = _pair(_ff_case(kind))
    x, y = _rand((B, F), 1) * 2 + 0.5, _onehot(B, 3, 2)
    assert np.abs(_out(jnet, x) - _out(tnet, x)).max() <= TOL
    jnet.fit([x], [y])
    tnet.fit_batch([x], [y])
    assert _gap_params(jnet, tnet) <= TOL
    assert abs(jnet.score_ - tnet.score_) <= TOL * max(1.0, jnet.score_)


def _rnn_case(mask_input=None):
    """input "seq" [B, T, F] -> GravesLSTM -> last time step -> dense,
    and input "vec" [B, F] -> dense -> duplicate over "seq"'s time ->
    merged with the LSTM's sequence -> an RnnOutputLayer; two outputs."""
    gb = (_builder().add_inputs("seq", "vec")
          .add_layer("lstm", jl.GravesLSTM(n_in=F, n_out=4,
                                           activation="tanh"), "seq")
          .add_vertex("last", jg.LastTimeStepVertex(mask_input=mask_input),
                      "lstm")
          .add_layer("head", jl.OutputLayer(n_in=4, n_out=3,
                                            activation="softmax",
                                            loss="mcxent"), "last")
          .add_layer("emb", jl.DenseLayer(n_in=F, n_out=3,
                                          activation="tanh"), "vec")
          .add_vertex("dup", jg.DuplicateToTimeSeriesVertex(
              reference_input="seq"), "emb")
          .add_vertex("cat", jg.MergeVertex(), "lstm", "dup")
          .add_layer("seqout", jl.RnnOutputLayer(n_in=7, n_out=2,
                                                 activation="softmax",
                                                 loss="mcxent"), "cat"))
    gb.set_outputs("head", "seqout")
    return gb.build()


def _rnn_batch():
    seq, vec = _rand((B, T, F), 3), _rand((B, F), 4)
    y_seq = np.eye(2, dtype=np.float32)[
        np.random.default_rng(5).integers(0, 2, (B, T))]
    return seq, vec, _onehot(B, 3, 6), y_seq


def test_last_time_step_and_duplicate_vertices():
    jnet, tnet = _pair(_rnn_case())
    seq, vec, y_head, y_seq = _rnn_batch()
    for a, b in zip(jnet.output(seq, vec), tnet.output(seq, vec)):
        assert np.abs(np.asarray(a) - b.numpy()).max() <= TOL
    jnet.fit([seq, vec], [y_head, y_seq])
    tnet.fit_batch([seq, vec], [y_head, y_seq])
    assert _gap_params(jnet, tnet) <= TOL


def test_masks_through_last_time_step_and_duplicate():
    """LastTimeStepVertex(mask_input="seq") takes each row's last
    unmasked step; DuplicateToTimeSeriesVertex takes "seq"'s mask, which
    the merge and the RnnOutputLayer carry; both outputs' losses are
    masked."""
    jnet, tnet = _pair(_rnn_case(mask_input="seq"))
    seq, vec, y_head, y_seq = _rnn_batch()
    mask = np.ones((B, T), np.float32)
    for i, n in enumerate((5, 3, 1, 4, 2, 5)):
        mask[i, n:] = 0
    fm = [mask, np.ones((B, 1), np.float32)]
    for a, b in zip(jnet.output(seq, vec, fmasks=fm),
                    tnet.output(seq, vec, fmasks=fm)):
        assert np.abs(np.asarray(a) - b.numpy()).max() <= TOL
    # the gathered step is the last unmasked one, whatever follows it
    acts = tnet.feed_forward(seq, vec)
    seq2 = seq.copy()
    seq2[mask == 0] = 99.0
    h1 = tnet.output(seq, vec, fmasks=fm)[0].numpy()
    h2 = tnet.output(seq2, vec, fmasks=fm)[0].numpy()
    np.testing.assert_array_equal(h1, h2)
    assert acts["dup"].shape == (B, T, 3)
    lm = [None, mask]
    jnet._fit_one([seq, vec], [y_head, y_seq], fm, lm)
    tnet.fit_batch([seq, vec], [y_head, y_seq], fm, lm)
    assert _gap_params(jnet, tnet) <= TOL


def test_binomial_sampling_preprocessor():
    """Inference clips to [0, 1], the JAX package's transform, bit for
    bit. A train-mode forward draws {0, 1} units from the graph's
    generator; the JAX package clips at train time too, so the draws
    cannot match JAX's. What is held: the shape, the values in {0, 1},
    and the mean of 20400 draws of p = 0.3 within 0.02 of 0.3 (over 6
    standard errors of the mean)."""
    gb = (_builder().add_inputs("in")
          .add_vertex("bin", jg.PreprocessorVertex(
              preprocessor=jp.BinomialSamplingPreProcessor()), "in")
          .add_layer("out", jl.OutputLayer(n_in=F, n_out=3,
                                           activation="softmax",
                                           loss="mcxent"), "bin"))
    gb.set_outputs("out")
    jnet, tnet = _pair(gb.build())
    x = _rand((B, F), 7)
    np.testing.assert_array_equal(
        np.asarray(jnet.feed_forward(x)["bin"]),
        tnet.feed_forward(x)["bin"].numpy())
    p = np.full((3400, F), 0.3, np.float32)
    draws = tnet.feed_forward(p, train=True)["bin"].numpy()
    assert draws.shape == p.shape
    assert set(np.unique(draws)) <= {0.0, 1.0}
    assert abs(draws.mean() - 0.3) <= 0.02
    tnet.fit_batch([x], [_onehot(B, 3, 8)])  # trains through the draws
    assert np.isfinite(tnet.score_)


# -- a conv + BatchNorm graph ----------------------------------------------------

def _conv_bn_conf(lr=1e-2):
    """in [B, 8, 8, 2] -> conv 3x3 relu -> BatchNorm -> 2x2 max pool ->
    (CnnToFeedForward) dense -> softmax; Adam with epsilon 1e-4. The conv
    feeds the BN through a relu, so its bias has a gradient of its own."""
    gb = (_builder(JAdam(epsilon=1e-4), lr=lr).add_inputs("in")
          .add_layer("c1", jl.ConvolutionLayer(
              n_in=2, n_out=8, kernel_size=(3, 3), padding=(1, 1),
              activation="relu"), "in",
              preprocessor=jp.FeedForwardToCnnPreProcessor(8, 8, 2))
          .add_layer("bn", jl.BatchNormalization(n_in=8, n_out=8,
                                                 activation="identity"),
                     "c1")
          .add_layer("pool", jl.SubsamplingLayer(
              pooling_type="max", kernel_size=(2, 2), stride=(2, 2)), "bn")
          .add_layer("d", jl.DenseLayer(n_in=128, n_out=16,
                                        activation="tanh"), "pool",
                     preprocessor=jp.CnnToFeedForwardPreProcessor(4, 4, 8))
          .add_layer("out", jl.OutputLayer(n_in=16, n_out=3,
                                           activation="softmax",
                                           loss="negativeloglikelihood"),
                     "d"))
    gb.set_outputs("out")
    return gb.build()


def _cnn_batch(seed, n=B):
    return _rand((n, 8, 8, 2), seed), _onehot(n, 3, seed + 100)


def test_conv_bn_graph_five_adam_steps():
    jnet, tnet = _pair(_conv_bn_conf())
    x, y = _cnn_batch(0)
    assert np.abs(_out(jnet, x) - _out(tnet, x)).max() <= TOL
    # flat rows go through the first vertex's FeedForwardToCnn
    assert np.abs(_out(tnet, x.reshape(B, -1)) - _out(tnet, x)).max() == 0
    for _ in range(5):
        jnet.fit([x], [y])
        tnet.fit_batch([x], [y])
    assert _gap_params(jnet, tnet) <= TOL
    assert _gap_vars(jnet, tnet) <= TOL
    assert tnet.variables["bn"]["mean"].abs().max() > 0  # they moved
    np.testing.assert_allclose(tnet.updater_state_flat(),
                               jnet.updater_state_flat(), rtol=1e-4,
                               atol=1e-7)


def test_conv_bn_graph_fit_scan_and_accumulated():
    """fit_scan (K = 3) and fit_batch_accumulated (K = 2 micro-batches,
    the BN statistics carried from one to the next) against JAX's."""
    xs = np.stack([_cnn_batch(s)[0] for s in range(3)])
    ys = np.stack([_cnn_batch(s)[1] for s in range(3)])
    jnet, tnet = _pair(_conv_bn_conf())
    jl_ = np.asarray(jnet.fit_scan([xs], [ys]))
    tl_ = tnet.fit_scan([xs], [ys]).numpy()
    assert np.abs(jl_ - tl_).max() <= TOL
    assert _gap_params(jnet, tnet) <= TOL and _gap_vars(jnet, tnet) <= TOL
    jnet, tnet = _pair(_conv_bn_conf())
    x, y = _cnn_batch(9, 8)
    for _ in range(2):
        jm = float(jnet.fit_batch_accumulated([x], [y], 2))
        tm = float(tnet.fit_batch_accumulated([x], [y], 2))
        assert abs(jm - tm) <= TOL
    assert _gap_params(jnet, tnet) <= TOL and _gap_vars(jnet, tnet) <= TOL


@pytest.mark.parametrize("algo", ["lbfgs", "conjugate_gradient",
                                  "line_gradient_descent"])
def test_conv_bn_graph_under_the_solvers(algo):
    """3 iterations of a line-search solver on a conv + BN graph: the
    params as JAX's; the running statistics left as they were on both
    sides (the JAX graph's solver path does not update them)."""
    gb = (JNNC.builder().seed(3).learning_rate(0.1).updater(JSgd())
          .optimization_algo(algo).iterations(3).graph_builder()
          .add_inputs("in")
          .add_layer("c1", jl.ConvolutionLayer(
              n_in=2, n_out=4, kernel_size=(3, 3), padding=(1, 1),
              activation="relu"), "in")
          .add_layer("bn", jl.BatchNormalization(n_in=4, n_out=4), "c1")
          .add_layer("out", jl.OutputLayer(n_in=256, n_out=3,
                                           activation="softmax",
                                           loss="mcxent"), "bn",
                     preprocessor=jp.CnnToFeedForwardPreProcessor(8, 8, 4)))
    gb.set_outputs("out")
    jnet, tnet = _pair(gb.build())
    ptrs = [t.data_ptr() for t in tnet.variables["bn"].values()]
    x, y = _cnn_batch(0)
    jnet.fit([x], [y])
    tnet.fit_batch([x], [y])
    assert _gap_params(jnet, tnet) <= TOL
    assert _gap_vars(jnet, tnet) == 0.0
    assert ptrs == [t.data_ptr() for t in tnet.variables["bn"].values()]
    assert abs(jnet.score_ - tnet.score_) <= TOL * max(1.0, jnet.score_)


def test_alexnet_graph_equals_the_multilayer_network():
    """AlexNet-CIFAR10's layer stack (at 16x16, channels 8/16/16, Dense 32)
    as a graph of LayerVertices named in layer order, each with the list's
    preprocessor: the same init and the same eval outputs as the
    MultiLayerNetwork (which fuses BN + pool only in its train step, the
    graph never)."""
    from deeplearning4j_tpu_torch.nn.conf import layers as L
    from deeplearning4j_tpu_torch.nn.conf.config import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
    b = NeuralNetConfiguration.builder().seed(42).learning_rate(1e-3).list()
    for c in (8, 16, 16):
        b = (b.layer(L.ConvolutionLayer(n_out=c, kernel_size=(3, 3),
                                        padding=(1, 1),
                                        activation="identity"))
             .layer(L.BatchNormalization(activation="relu"))
             .layer(L.SubsamplingLayer(pooling_type="max", kernel_size=(2, 2),
                                       stride=(2, 2))))
    conf = (b.layer(L.DenseLayer(n_out=32, activation="relu"))
            .layer(L.OutputLayer(n_out=10, activation="softmax",
                                 loss="negativeloglikelihood"))
            .set_input_type(InputType.convolutional(16, 16, 3)).build())
    gb = NeuralNetConfiguration.builder().seed(42).graph_builder()
    gb.add_inputs("in")
    src = "in"
    for i, lc in enumerate(conf.layers):
        gb.add_layer(f"l{i:02d}", lc, src, preprocessor=conf.preprocessor(i))
        src = f"l{i:02d}"
    gb.set_outputs(src)
    mln = MultiLayerNetwork(conf, device="cpu").init()
    g = TGraph(gb.build(), device="cpu").init()
    np.testing.assert_array_equal(g.params_flat(), mln.params_flat())
    x = _rand((4, 16, 16, 3), 11)
    assert np.abs(g.output(x)[0].numpy()
                  - mln.output(x).numpy()).max() <= TOL


# -- the seq2seq addition graph --------------------------------------------------

def _seq2seq_conf(hidden=8):
    """examples/seq2seq_addition.py's graph at hidden 8 (Adam 3e-3, epsilon
    1e-4)."""
    V = 12
    gb = (_builder(JAdam(epsilon=1e-4), lr=3e-3, seed=0)
          .add_inputs("question", "answer_shape")
          .add_layer("enc", jl.GravesLSTM(n_in=V, n_out=hidden,
                                          activation="tanh"), "question")
          .add_vertex("thought", jg.LastTimeStepVertex(), "enc")
          .add_vertex("repeat", jg.DuplicateToTimeSeriesVertex(
              reference_input="answer_shape"), "thought")
          .add_layer("dec", jl.GravesLSTM(n_in=hidden, n_out=hidden,
                                          activation="tanh"), "repeat")
          .add_layer("out", jl.RnnOutputLayer(n_in=hidden, n_out=V,
                                              activation="softmax",
                                              loss="mcxent"), "dec"))
    gb.set_outputs("out")
    return gb.build()


def _addition_batch(rng, n):
    vocab = "0123456789+ "
    eye = np.eye(len(vocab), dtype=np.float32)
    xs, ys = [], []
    for _ in range(n):
        a, b = rng.integers(0, 50), rng.integers(0, 50)
        xs.append(eye[[vocab.index(c) for c in f"{a}+{b}".ljust(5)]])
        ys.append(eye[[vocab.index(c) for c in str(a + b).zfill(3)]])
    return np.stack(xs), np.stack(ys)


def test_seq2seq_addition_five_adam_steps():
    jnet, tnet = _pair(_seq2seq_conf())
    rng = np.random.default_rng(0)
    shape = np.zeros((16, 3, 1), np.float32)
    for _ in range(5):
        x, y = _addition_batch(rng, 16)
        jnet.fit([x, shape], [y])
        tnet.fit_batch([x, shape], [y])
        assert abs(jnet.score_ - tnet.score_) <= TOL * max(1, jnet.score_)
    assert _gap_params(jnet, tnet) <= TOL
    x, _ = _addition_batch(rng, 4)
    assert np.abs(_out(jnet, x, shape[:4])
                  - _out(tnet, x, shape[:4])).max() <= TOL


# -- feed_forward, output_single, clone, summary ----------------------------------

def test_feed_forward_output_single_clone_summary():
    jnet, tnet = _pair(_conv_bn_conf())
    x, y = _cnn_batch(1)
    ja, ta = jnet.feed_forward(x), tnet.feed_forward(x)
    assert set(ja) == set(ta)
    for k in ja:
        assert np.abs(np.asarray(ja[k]) - ta[k].numpy()).max() <= TOL, k
    np.testing.assert_array_equal(tnet.output_single(x).numpy(),
                                  tnet.output(x)[0].numpy())
    tnet.fit_batch([x], [y])
    c = tnet.clone()
    assert c.step == tnet.step == 1
    np.testing.assert_array_equal(c.params_flat(), tnet.params_flat())
    np.testing.assert_array_equal(c.updater_state_flat(),
                                  tnet.updater_state_flat())
    before = (tnet.params_flat(), tnet.updater_state_flat(),
              tnet.variables["bn"]["mean"].clone())
    ptrs = {t.data_ptr() for lp in tnet.params.values() for t in lp.values()}
    assert not ptrs & {t.data_ptr() for lp in c.params.values()
                       for t in lp.values()}
    for _ in range(2):
        c.fit_batch([x], [y])
    np.testing.assert_array_equal(tnet.params_flat(), before[0])
    np.testing.assert_array_equal(tnet.updater_state_flat(), before[1])
    assert torch.equal(tnet.variables["bn"]["mean"], before[2])
    assert not np.array_equal(c.params_flat(), before[0])
    # the MultiLayerNetwork's clone and summary
    from deeplearning4j_tpu.models.zoo import mlp_iris as jmlp
    from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
    from deeplearning4j_tpu_torch.models.zoo import mlp_iris
    net = MultiLayerNetwork(mlp_iris(), device="cpu").init()
    jm = JMLN(jmlp()).init()
    assert net.summary().splitlines()[1:] == jm.summary().splitlines()[1:]
    xi, yi = _rand((8, 4), 2), _onehot(8, 3, 3)
    net.fit_batch(xi, yi)
    mc = net.clone()
    mc.fit_batch(xi, yi)
    assert mc.step == 2 and net.step == 1
    assert not np.array_equal(mc.params_flat(), net.params_flat())


# -- graph zips with variables.bin ------------------------------------------------

def test_graph_zips_with_variables_both_ways(tmp_path):
    jnet, tnet = _pair(_conv_bn_conf())
    x, y = _cnn_batch(2)
    for _ in range(2):
        jnet.fit([x], [y])
        tnet.fit_batch([x], [y])
    jms.write_model(jnet, tmp_path / "j.zip")
    tms.write_model(tnet, tmp_path / "t.zip")
    from_j = tms.restore_computation_graph(tmp_path / "j.zip", device="cpu")
    from_t = jms.restore_computation_graph(tmp_path / "t.zip")
    np.testing.assert_array_equal(from_j.params_flat(), jnet.params_flat())
    np.testing.assert_array_equal(from_j.updater_state_flat(),
                                  jnet.updater_state_flat())
    np.testing.assert_array_equal(from_t.params_flat(), tnet.params_flat())
    for k in jnet.variables:
        for n in jnet.variables[k]:
            np.testing.assert_array_equal(from_j.variables[k][n].numpy(),
                                          np.asarray(jnet.variables[k][n]))
            np.testing.assert_array_equal(np.asarray(from_t.variables[k][n]),
                                          tnet.variables[k][n].numpy())
    assert from_j.step == 2 and from_t.step == 2
    assert np.abs(_out(from_j, x) - _out(jnet, x)).max() <= 1e-6
    assert np.abs(_out(from_t, x) - _out(tnet, x)).max() <= 1e-6
    # the port reads its own zip back bitwise, and restore_model dispatches
    again = tms.restore_model(tmp_path / "t.zip", device="cpu")
    assert isinstance(again, TGraph)
    np.testing.assert_array_equal(_out(again, x), _out(tnet, x))
    tms.write_model(tnet, tmp_path / "nu.zip", save_updater=False)
    import zipfile
    assert "updater.bin" not in zipfile.ZipFile(tmp_path / "nu.zip").namelist()


def test_conv_graph_builds_importing_only_the_graph_module():
    """A conv graph in a process that imported nothing but nn.graph (the
    conv and subsampling impls used to register only with nn.multilayer)."""
    code = (
        "from deeplearning4j_tpu_torch.nn.graph import ComputationGraph\n"
        "from deeplearning4j_tpu_torch.nn.conf.config import "
        "NeuralNetConfiguration\n"
        "from deeplearning4j_tpu_torch.nn.conf.layers import ("
        "ConvolutionLayer, SubsamplingLayer, OutputLayer)\n"
        "from deeplearning4j_tpu_torch.nn.conf.preprocessors import "
        "CnnToFeedForwardPreProcessor\n"
        "import torch\n"
        "gb = NeuralNetConfiguration.builder().graph_builder()\n"
        "gb.add_inputs('in')\n"
        "gb.add_layer('c', ConvolutionLayer(n_in=1, n_out=2, "
        "kernel_size=(3, 3)), 'in')\n"
        "gb.add_layer('p', SubsamplingLayer(), 'c')\n"
        "gb.add_layer('o', OutputLayer(n_in=8, n_out=2), 'p', "
        "preprocessor=CnnToFeedForwardPreProcessor(2, 2, 2))\n"
        "gb.set_outputs('o')\n"
        "g = ComputationGraph(gb.build(), device='cpu').init()\n"
        "print(tuple(g.output(torch.zeros(1, 6, 6, 1))[0].shape))\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=str(REPO), timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "(1, 2)"
