"""Model zoo — port of ``lenet_mnist``, ``mlp_iris``, ``alexnet_cifar10``
and ``transformer_lm`` from deeplearning4j_tpu/models/zoo.py.

Each builds the same configuration as the JAX package (same layers,
names, defaults and hyperparameters), so its JSON, its flat parameter
order and its model zip are the JAX package's.
"""
from __future__ import annotations

from ..nn.conf.config import MultiLayerConfiguration, NeuralNetConfiguration
from ..nn.conf.graph import ElementWiseVertex
from ..nn.conf.inputs import InputType
from ..nn.conf.layers import (BatchNormalization, ConvolutionLayer,
                              DenseLayer, LayerNormalization, OutputLayer,
                              RnnOutputLayer, SelfAttentionLayer,
                              SubsamplingLayer)
from ..nn.updater.updaters import Adam, Nesterovs, Sgd


def lenet_mnist(seed: int = 123, lr: float = 0.01, dtype: str = "float32",
                height: int = 28, width: int = 28, channels: int = 1,
                n_classes: int = 10) -> MultiLayerConfiguration:
    """LeNet: Conv 20 5x5 / max pool / Conv 50 5x5 / max pool / Dense 500
    relu / softmax output; Nesterovs 0.9, l2 5e-4."""
    return (NeuralNetConfiguration.builder()
            .seed(seed).learning_rate(lr).updater(Nesterovs(momentum=0.9))
            .regularization(True).l2(5e-4).dtype(dtype)
            .list()
            .layer(ConvolutionLayer(n_out=20, kernel_size=(5, 5), stride=(1, 1),
                                    activation="identity", weight_init="xavier"))
            .layer(SubsamplingLayer(pooling_type="max", kernel_size=(2, 2),
                                    stride=(2, 2)))
            .layer(ConvolutionLayer(n_out=50, kernel_size=(5, 5), stride=(1, 1),
                                    activation="identity"))
            .layer(SubsamplingLayer(pooling_type="max", kernel_size=(2, 2),
                                    stride=(2, 2)))
            .layer(DenseLayer(n_out=500, activation="relu"))
            .layer(OutputLayer(n_out=n_classes, activation="softmax",
                               loss="negativeloglikelihood"))
            .set_input_type(InputType.convolutional(height, width, channels))
            .build())


def mlp_iris(seed: int = 12345, lr: float = 0.1) -> MultiLayerConfiguration:
    """Dense 4 -> 16 tanh, softmax output 3; SGD."""
    return (NeuralNetConfiguration.builder()
            .seed(seed).learning_rate(lr).updater(Sgd())
            .list()
            .layer(DenseLayer(n_in=4, n_out=16, activation="tanh"))
            .layer(OutputLayer(n_in=16, n_out=3, activation="softmax",
                               loss="negativeloglikelihood"))
            .build())


def alexnet_cifar10(seed: int = 42, lr: float = 1e-3, dtype: str = "float32",
                    n_classes: int = 10) -> MultiLayerConfiguration:
    """AlexNet for 32x32 CIFAR-10: three [Conv 3x3 pad 1 -> BatchNorm relu
    -> 2x2 max pool] stages of 64/128/256 channels, Dense 512 relu with
    dropout 0.5, softmax output; Adam, l2 1e-4."""
    return (NeuralNetConfiguration.builder()
            .seed(seed).learning_rate(lr).updater(Adam())
            .regularization(True).l2(1e-4).dtype(dtype)
            .list()
            .layer(ConvolutionLayer(n_out=64, kernel_size=(3, 3), stride=(1, 1),
                                    padding=(1, 1), activation="identity"))
            .layer(BatchNormalization(activation="relu"))
            .layer(SubsamplingLayer(pooling_type="max", kernel_size=(2, 2),
                                    stride=(2, 2)))
            .layer(ConvolutionLayer(n_out=128, kernel_size=(3, 3), padding=(1, 1),
                                    activation="identity"))
            .layer(BatchNormalization(activation="relu"))
            .layer(SubsamplingLayer(pooling_type="max", kernel_size=(2, 2),
                                    stride=(2, 2)))
            .layer(ConvolutionLayer(n_out=256, kernel_size=(3, 3), padding=(1, 1),
                                    activation="identity"))
            .layer(BatchNormalization(activation="relu"))
            .layer(SubsamplingLayer(pooling_type="max", kernel_size=(2, 2),
                                    stride=(2, 2)))
            .layer(DenseLayer(n_out=512, activation="relu", dropout=0.5))
            .layer(OutputLayer(n_out=n_classes, activation="softmax",
                               loss="negativeloglikelihood"))
            .set_input_type(InputType.convolutional(32, 32, 3))
            .build())


def transformer_lm(vocab_size: int = 77, d_model: int = 128, n_heads: int = 4,
                   n_blocks: int = 2, ff_mult: int = 4, seed: int = 7,
                   lr: float = 3e-4, dtype: str = "float32",
                   rope: bool = False, n_kv_heads=None):
    """Decoder-only transformer language model as a ComputationGraph
    configuration. Input: one-hot [B, T, vocab]; output: next-token
    distribution per timestep. Pre-LN residual blocks:
        x = x + Attn(LN(x));  x = x + FFN(LN(x))
    """
    gb = (NeuralNetConfiguration.builder()
          .seed(seed).learning_rate(lr).updater(Adam())
          .dtype(dtype)
          .graph_builder()
          .add_inputs("in")
          .add_layer("embed", DenseLayer(n_in=vocab_size, n_out=d_model,
                                         activation="identity"), "in"))
    prev = "embed"
    for i in range(n_blocks):
        gb.add_layer(f"ln{i}a", LayerNormalization(n_in=d_model, n_out=d_model,
                                                   activation="identity"),
                     prev)
        gb.add_layer(f"attn{i}",
                     SelfAttentionLayer(n_in=d_model, n_out=d_model,
                                        n_heads=n_heads, causal=True,
                                        rope=rope, n_kv_heads=n_kv_heads,
                                        activation="identity"), f"ln{i}a")
        gb.add_vertex(f"res{i}a", ElementWiseVertex(op="add"),
                      prev, f"attn{i}")
        gb.add_layer(f"ln{i}b", LayerNormalization(n_in=d_model, n_out=d_model,
                                                   activation="identity"),
                     f"res{i}a")
        gb.add_layer(f"ff{i}", DenseLayer(n_in=d_model,
                                          n_out=ff_mult * d_model,
                                          activation="gelu"), f"ln{i}b")
        gb.add_layer(f"ff{i}o", DenseLayer(n_in=ff_mult * d_model,
                                           n_out=d_model,
                                           activation="identity"), f"ff{i}")
        gb.add_vertex(f"res{i}b", ElementWiseVertex(op="add"),
                      f"res{i}a", f"ff{i}o")
        prev = f"res{i}b"
    gb.add_layer("ln_f", LayerNormalization(n_in=d_model, n_out=d_model,
                                            activation="identity"), prev)
    gb.add_layer("out", RnnOutputLayer(n_in=d_model, n_out=vocab_size,
                                       activation="softmax", loss="mcxent"),
                 "ln_f")
    gb.set_outputs("out")
    return gb.build()
