"""The Megatron tensor-parallel plan for ComputationGraph networks — the
spec plan of deeplearning4j_tpu/parallel/tensor_parallel.py
(`_tp_specs_for_graph`, :31-58).

A spec is a tuple with one entry a parameter dim: the mesh axis name that
dim is split over, or None; ``()`` is replicated. Each equals, entry for
entry, the JAX package's `PartitionSpec` (``tuple(P(None, "tp")) ==
(None, "tp")``). The pairing:

  - SelfAttentionLayer: Wq/Wk/Wv split by column (heads), Wo by row,
    ``b`` replicated — one all-reduce per attention block;
  - a DenseLayer fed by a column-split DenseLayer alone: split by row
    (the FFN down-projection), ``b`` replicated;
  - any other DenseLayer with an activation: split by column with its
    ``b`` (the FFN up-projection);
  - everything else replicated.

The decode engine reads this plan through `inference/sharding.py`, with
the output vertices forced replicated. Training under the plan
(`shard_transformer_tp`) is listed in ROADMAP.md (A7).
"""
from __future__ import annotations

from typing import Dict, Tuple

MODEL_AXIS_DEFAULT = "model"

Spec = Tuple


def _tp_specs_for_graph(conf, axis: str) -> Dict[str, Dict[str, Spec]]:
    """Per-vertex, per-param specs of the Megatron scheme."""
    from ..nn.conf.graph import LayerVertex
    from ..nn.conf.layers import DenseLayer, SelfAttentionLayer

    specs: Dict[str, Dict[str, Spec]] = {}
    col_vertices = set()
    for name in conf.topological_order():
        vertex = conf.vertices[name]
        if not isinstance(vertex, LayerVertex):
            continue
        layer = vertex.layer
        srcs = conf.vertex_inputs[name]
        if isinstance(layer, SelfAttentionLayer):
            specs[name] = {"Wq": (None, axis), "Wk": (None, axis),
                           "Wv": (None, axis), "Wo": (axis, None),
                           "b": ()}
        elif isinstance(layer, DenseLayer):
            if len(srcs) == 1 and srcs[0] in col_vertices:
                specs[name] = {"W": (axis, None), "b": ()}
            elif (layer.activation or "identity") != "identity":
                specs[name] = {"W": (None, axis), "b": (axis,)}
                col_vertices.add(name)
            else:
                specs[name] = {}
        else:
            specs[name] = {}
    return specs
