"""Model zoo — port of ``transformer_lm`` from deeplearning4j_tpu/models/zoo.py.

Builds the same ComputationGraphConfiguration (same vertex names, layer
configs and defaults), so its JSON, its flat parameter order and its
model zip are the JAX package's.
"""
from __future__ import annotations

from ..nn.conf.config import NeuralNetConfiguration
from ..nn.conf.graph import ElementWiseVertex
from ..nn.conf.layers import (DenseLayer, LayerNormalization, RnnOutputLayer,
                              SelfAttentionLayer)
from ..nn.updater.updaters import Adam


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
