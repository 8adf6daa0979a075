"""ComputationGraph configuration: DAG of layers + graph vertices.

Port of deeplearning4j_tpu/nn/conf/graph.py: every vertex class (layer
with an optional input preprocessor, merge, element-wise, subset,
preprocessor, scale, last time step, duplicate to time series), the
`ComputationGraphConfiguration` fields and `GraphBuilder` (input types,
the backprop, pretrain and truncated-BPTT settings), so a graph config's
JSON and YAML round-trip between the packages.
"""
from __future__ import annotations

import copy
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from . import serde
from .config import (BACKPROP_STANDARD, NeuralNetConfiguration,
                     resolve_layer_defaults)
from .inputs import InputType
from .layers import Layer
from .preprocessors import InputPreProcessor


@dataclass
class GraphVertex:
    """Base vertex config."""


@serde.register
@dataclass
class LayerVertex(GraphVertex):
    layer: Optional[Layer] = None
    preprocessor: Optional[InputPreProcessor] = None


@serde.register
@dataclass
class MergeVertex(GraphVertex):
    """Concatenate inputs along the feature (last) axis."""


@serde.register
@dataclass
class ElementWiseVertex(GraphVertex):
    """add | subtract | product | average | max."""

    op: str = "add"


@serde.register
@dataclass
class SubsetVertex(GraphVertex):
    """Feature range [from_idx, to_idx] of the last axis, inclusive."""

    from_idx: int = 0
    to_idx: int = 0


@serde.register
@dataclass
class PreprocessorVertex(GraphVertex):
    preprocessor: Optional[InputPreProcessor] = None


@serde.register
@dataclass
class ScaleVertex(GraphVertex):
    scale_factor: float = 1.0


@serde.register
@dataclass
class LastTimeStepVertex(GraphVertex):
    """[B, T, F] -> [B, F] at the last step, or at each row's last
    unmasked step of the feature mask of graph input ``mask_input``."""

    mask_input: Optional[str] = None


@serde.register
@dataclass
class DuplicateToTimeSeriesVertex(GraphVertex):
    """[B, F] -> [B, T, F], T the time length of graph input
    ``reference_input`` (whose mask the output takes)."""

    reference_input: Optional[str] = None


@serde.register
@dataclass
class ComputationGraphConfiguration:
    conf: NeuralNetConfiguration = field(default_factory=NeuralNetConfiguration)
    network_inputs: List[str] = field(default_factory=list)
    network_outputs: List[str] = field(default_factory=list)
    vertices: Dict[str, GraphVertex] = field(default_factory=dict)
    vertex_inputs: Dict[str, List[str]] = field(default_factory=dict)
    backprop: bool = True
    pretrain: bool = False
    backprop_type: str = BACKPROP_STANDARD
    tbptt_fwd_length: int = 20
    tbptt_back_length: int = 20
    input_types: Dict[str, InputType] = field(default_factory=dict)

    def to_json(self) -> str:
        return serde.to_json(self)

    @staticmethod
    def from_json(s: str) -> "ComputationGraphConfiguration":
        return serde.from_json(s)

    def to_yaml(self) -> str:
        return serde.to_yaml(self)

    @staticmethod
    def from_yaml(s: str) -> "ComputationGraphConfiguration":
        return serde.from_yaml(s)

    def topological_order(self) -> List[str]:
        """Kahn topological sort over vertices, ties in name order (the
        JAX package's order, so both packages run vertices alike)."""
        indeg = {name: 0 for name in self.vertices}
        children: Dict[str, List[str]] = {name: [] for name in self.vertices}
        for name, inputs in self.vertex_inputs.items():
            for src in inputs:
                if src in self.vertices:
                    indeg[name] += 1
                    children[src].append(name)
        queue = sorted(n for n, d in indeg.items() if d == 0)
        order = []
        while queue:
            n = queue.pop(0)
            order.append(n)
            for c in children[n]:
                indeg[c] -= 1
                if indeg[c] == 0:
                    queue.append(c)
        if len(order) != len(self.vertices):
            cyc = set(self.vertices) - set(order)
            raise ValueError(f"Graph has a cycle involving: {sorted(cyc)}")
        return order


class GraphBuilder:
    """Fluent builder (reference ComputationGraphConfiguration.GraphBuilder:446)."""

    def __init__(self, conf: NeuralNetConfiguration):
        self._conf = conf
        self._inputs: List[str] = []
        self._outputs: List[str] = []
        self._vertices: Dict[str, GraphVertex] = {}
        self._vertex_inputs: Dict[str, List[str]] = {}
        self._backprop = True
        self._pretrain = False
        self._backprop_type = BACKPROP_STANDARD
        self._tbptt_fwd = 20
        self._tbptt_back = 20
        self._input_types: Dict[str, InputType] = {}

    def add_inputs(self, *names: str) -> "GraphBuilder":
        self._inputs.extend(names)
        return self

    def set_input_types(self, **types: InputType) -> "GraphBuilder":
        self._input_types.update(types)
        return self

    def add_layer(self, name: str, layer: Layer, *inputs: str,
                  preprocessor: Optional[InputPreProcessor] = None
                  ) -> "GraphBuilder":
        layer = resolve_layer_defaults(layer, self._conf)
        return self.add_vertex(
            name, LayerVertex(layer=layer, preprocessor=preprocessor),
            *inputs)

    def add_vertex(self, name: str, vertex: GraphVertex, *inputs: str) -> "GraphBuilder":
        if name in self._vertices or name in self._inputs:
            raise ValueError(f"Duplicate vertex name '{name}'")
        if not inputs:
            raise ValueError(f"Vertex '{name}' needs at least one input")
        self._vertices[name] = vertex
        self._vertex_inputs[name] = list(inputs)
        return self

    def set_outputs(self, *names: str) -> "GraphBuilder":
        self._outputs = list(names)
        return self

    def backprop(self, flag: bool) -> "GraphBuilder":
        self._backprop = flag
        return self

    def pretrain(self, flag: bool) -> "GraphBuilder":
        self._pretrain = flag
        return self

    def backprop_type(self, t: str) -> "GraphBuilder":
        self._backprop_type = t
        return self

    def t_bptt_forward_length(self, n: int) -> "GraphBuilder":
        self._tbptt_fwd = n
        return self

    def t_bptt_backward_length(self, n: int) -> "GraphBuilder":
        self._tbptt_back = n
        return self

    def build(self) -> ComputationGraphConfiguration:
        if not self._inputs:
            raise ValueError("Graph needs at least one input (add_inputs)")
        if not self._outputs:
            raise ValueError("Graph needs at least one output (set_outputs)")
        known = set(self._inputs) | set(self._vertices)
        for name, inputs in self._vertex_inputs.items():
            for src in inputs:
                if src not in known:
                    raise ValueError(f"Vertex '{name}' references unknown input '{src}'")
        for out in self._outputs:
            if out not in self._vertices:
                raise ValueError(f"Output '{out}' is not a vertex")
        cfg = ComputationGraphConfiguration(
            conf=self._conf,
            network_inputs=list(self._inputs),
            network_outputs=list(self._outputs),
            vertices=copy.deepcopy(self._vertices),
            vertex_inputs=copy.deepcopy(self._vertex_inputs),
            backprop=self._backprop,
            pretrain=self._pretrain,
            backprop_type=self._backprop_type,
            tbptt_fwd_length=self._tbptt_fwd,
            tbptt_back_length=self._tbptt_back,
            input_types=dict(self._input_types),
        )
        cfg.topological_order()  # validate acyclicity at build time
        return cfg
