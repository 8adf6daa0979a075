"""Port parity: configuration YAML (nn/conf/serde.py), both ways.

The cases of the JAX package's tests/test_conf_serde.py that round-trip
YAML (:52-57, :115-182), and graph configurations with every vertex and
preprocessor. Each configuration is built twice, once with each
package's builder from the same calls; then:
  - the two builders give the same JSON;
  - YAML written by the JAX package loads in the port, and YAML written
    by the port loads in the JAX package, each to the same ``to_json()``;
  - the two packages write the same YAML text (the same dict, dumped
    with sorted keys).
Exact comparisons throughout.
"""
import types

import pytest

from deeplearning4j_tpu.nn.conf import config as jconfig
from deeplearning4j_tpu.nn.conf import graph as jgraph
from deeplearning4j_tpu.nn.conf import inputs as jinputs
from deeplearning4j_tpu.nn.conf import layers as jlayers
from deeplearning4j_tpu.nn.conf import preprocessors as jpre
from deeplearning4j_tpu.nn.updater import updaters as jupd
from deeplearning4j_tpu_torch.nn.conf import config as tconfig
from deeplearning4j_tpu_torch.nn.conf import graph as tgraph
from deeplearning4j_tpu_torch.nn.conf import inputs as tinputs
from deeplearning4j_tpu_torch.nn.conf import layers as tlayers
from deeplearning4j_tpu_torch.nn.conf import preprocessors as tpre
from deeplearning4j_tpu_torch.nn.updater import updaters as tupd

JAX = types.SimpleNamespace(conf=jconfig, graph=jgraph, inputs=jinputs,
                            L=jlayers, pre=jpre, upd=jupd)
PORT = types.SimpleNamespace(conf=tconfig, graph=tgraph, inputs=tinputs,
                             L=tlayers, pre=tpre, upd=tupd)


def _lenet(ns):
    L = ns.L
    return (ns.conf.NeuralNetConfiguration.builder()
            .seed(42).learning_rate(0.01)
            .updater(ns.upd.Nesterovs(momentum=0.9))
            .regularization(True).l2(5e-4).list()
            .layer(L.ConvolutionLayer(n_out=20, kernel_size=(5, 5),
                                      stride=(1, 1), activation="identity"))
            .layer(L.SubsamplingLayer(pooling_type="max", kernel_size=(2, 2),
                                      stride=(2, 2)))
            .layer(L.ConvolutionLayer(n_out=50, kernel_size=(5, 5),
                                      activation="identity"))
            .layer(L.SubsamplingLayer(pooling_type="max", kernel_size=(2, 2),
                                      stride=(2, 2)))
            .layer(L.DenseLayer(n_out=500, activation="relu"))
            .layer(L.OutputLayer(n_out=10, activation="softmax",
                                 loss="negativeloglikelihood"))
            .set_input_type(ns.inputs.InputType.convolutional(28, 28, 1))
            .build())


def _attention_norm(ns):
    L = ns.L
    return (ns.conf.NeuralNetConfiguration.builder().seed(1)
            .learning_rate(0.01).list()
            .layer(L.SelfAttentionLayer(n_in=8, n_out=16, n_heads=4,
                                        causal=True, activation="identity"))
            .layer(L.LayerNormalization(n_in=16, n_out=16,
                                        activation="identity"))
            .layer(L.DenseLayer(n_in=16, n_out=8, activation="relu"))
            .layer(L.OutputLayer(n_in=8, n_out=3, activation="softmax",
                                 loss="negativeloglikelihood"))
            .build())


def _ff_stack(ns):
    L = ns.L
    return (ns.conf.NeuralNetConfiguration.builder().seed(7)
            .learning_rate(0.1).list()
            .layer(L.DenseLayer(n_in=6, n_out=8, activation="relu",
                                dropout=0.25))
            .layer(L.ActivationLayer(activation="tanh"))
            .layer(L.DropoutLayer(dropout=0.5))
            .layer(L.OutputLayer(n_in=8, n_out=3, activation="softmax",
                                 loss="mcxent"))
            .build())


def _one_layer(make):
    def conf(ns):
        layer = make(ns.L)
        out = (ns.L.RnnOutputLayer if isinstance(layer,
                                                 ns.L.BaseRecurrentLayer)
               else ns.L.OutputLayer)
        return (ns.conf.NeuralNetConfiguration.builder().seed(7)
                .learning_rate(0.1).list()
                .layer(layer)
                .layer(out(n_in=layer.n_out, n_out=3, activation="softmax",
                           loss="mcxent"))
                .build())
    return conf


def _cnn_stack(ns):
    L = ns.L
    return (ns.conf.NeuralNetConfiguration.builder().seed(7)
            .learning_rate(0.1).list()
            .layer(L.ConvolutionLayer(n_out=4, kernel_size=(3, 3),
                                      activation="relu"))
            .layer(L.LocalResponseNormalization(k=2.0, alpha=1e-4, beta=0.75,
                                                n=5))
            .layer(L.GlobalPoolingLayer(pooling_type="max"))
            .layer(L.LossLayer(loss="mcxent", activation="softmax"))
            .set_input_type(ns.inputs.InputType.convolutional(8, 8, 2))
            .build())


def _every_vertex_graph(ns):
    """A graph with every vertex kind and every value preprocessor."""
    L, G, P = ns.L, ns.graph, ns.pre
    gb = (ns.conf.NeuralNetConfiguration.builder().seed(3)
          .learning_rate(0.01).updater(ns.upd.Adam()).graph_builder()
          .add_inputs("seq", "vec")
          .set_input_types(seq=ns.inputs.InputType.recurrent(6),
                           vec=ns.inputs.InputType.feed_forward(6))
          .add_layer("lstm", L.GravesLSTM(n_in=6, n_out=4,
                                          activation="tanh"), "seq")
          .add_vertex("last", G.LastTimeStepVertex(mask_input="seq"), "lstm")
          .add_vertex("sub", G.SubsetVertex(from_idx=1, to_idx=2), "last")
          .add_vertex("scaled", G.ScaleVertex(scale_factor=0.5), "sub")
          .add_vertex("norm", G.PreprocessorVertex(
              preprocessor=P.ComposableInputPreProcessor(processors=[
                  P.ZeroMeanPrePreProcessor(), P.UnitVarianceProcessor()])),
              "vec")
          .add_vertex("bin", G.PreprocessorVertex(
              preprocessor=P.BinomialSamplingPreProcessor()), "norm")
          .add_vertex("cat", G.MergeVertex(), "scaled", "bin")
          .add_vertex("dup", G.DuplicateToTimeSeriesVertex(
              reference_input="seq"), "cat")
          .add_vertex("sum", G.ElementWiseVertex(op="add"), "dup", "dup")
          .add_layer("out", L.RnnOutputLayer(n_in=8, n_out=2,
                                             activation="softmax",
                                             loss="mcxent"), "sum",
                     preprocessor=P.UnitVarianceProcessor()))
    gb.set_outputs("out")
    return gb.build()


def _conv_bn_graph(ns):
    L, P = ns.L, ns.pre
    gb = (ns.conf.NeuralNetConfiguration.builder().seed(3)
          .learning_rate(0.01).updater(ns.upd.Adam()).graph_builder()
          .add_inputs("in")
          .add_layer("c1", L.ConvolutionLayer(n_in=2, n_out=8,
                                              kernel_size=(3, 3),
                                              padding=(1, 1),
                                              activation="relu"), "in",
                     preprocessor=P.FeedForwardToCnnPreProcessor(8, 8, 2))
          .add_layer("bn", L.BatchNormalization(n_in=8, n_out=8), "c1")
          .add_layer("pool", L.SubsamplingLayer(pooling_type="max",
                                                kernel_size=(2, 2),
                                                stride=(2, 2)), "bn")
          .add_layer("out", L.OutputLayer(n_in=128, n_out=3,
                                          activation="softmax",
                                          loss="mcxent"), "pool",
                     preprocessor=P.CnnToFeedForwardPreProcessor(4, 4, 8)))
    gb.set_outputs("out")
    return gb.build()


CASES = {
    "lenet": _lenet,
    "attention_layer_norm": _attention_norm,
    "ff_activation_dropout": _ff_stack,
    "embedding": _one_layer(lambda L: L.EmbeddingLayer(n_in=30, n_out=8)),
    "rbm": _one_layer(lambda L: L.RBM(n_in=6, n_out=8,
                                      visible_unit="gaussian",
                                      hidden_unit="binary")),
    "autoencoder": _one_layer(lambda L: L.AutoEncoder(
        n_in=6, n_out=8, corruption_level=0.3)),
    "bidirectional_lstm": _one_layer(lambda L: L.GravesBidirectionalLSTM(
        n_in=5, n_out=7, activation="tanh")),
    "gru": _one_layer(lambda L: L.GRU(n_in=5, n_out=7, activation="tanh")),
    "cnn_lrn_global_pool_loss": _cnn_stack,
    "graph_every_vertex": _every_vertex_graph,
    "graph_conv_bn": _conv_bn_graph,
}


def _cls(ns, conf):
    if isinstance(conf, (jgraph.ComputationGraphConfiguration,
                         tgraph.ComputationGraphConfiguration)):
        return ns.graph.ComputationGraphConfiguration
    return ns.conf.MultiLayerConfiguration


@pytest.mark.parametrize("case", sorted(CASES))
def test_yaml_both_ways(case):
    jconf, tconf = CASES[case](JAX), CASES[case](PORT)
    js = jconf.to_json()
    assert tconf.to_json() == js
    jy, ty = jconf.to_yaml(), tconf.to_yaml()
    assert ty == jy
    assert _cls(PORT, tconf).from_yaml(jy).to_json() == js
    assert _cls(JAX, jconf).from_yaml(ty).to_json() == js
    # and each reads its own
    assert _cls(PORT, tconf).from_yaml(ty).to_json() == js


def test_net_level_configuration_yaml():
    jc = (jconfig.NeuralNetConfiguration.builder().seed(9)
          .learning_rate(0.3).updater(jupd.Adam(beta1=0.8)).build())
    tc = (tconfig.NeuralNetConfiguration.builder().seed(9)
          .learning_rate(0.3).updater(tupd.Adam(beta1=0.8)).build())
    assert tc.to_yaml() == jc.to_yaml()
    back = tconfig.NeuralNetConfiguration.from_yaml(jc.to_yaml())
    assert back.to_json() == jc.to_json()
    assert isinstance(back.updater, tupd.Adam) and back.updater.beta1 == 0.8
