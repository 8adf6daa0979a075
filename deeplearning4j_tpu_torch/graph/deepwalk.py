"""DeepWalk graph embeddings: skip-gram over random walks.

Parity with the reference `deeplearning4j-graph/.../models/deepwalk/DeepWalk.java`
(skip-gram with GraphHuffman hierarchical softmax over random walks; tested by
DeepWalkGradientCheck). Reuses the batched SequenceVectors trainer — vertices
are "words", walks are "sentences"; hierarchical softmax via the same Huffman
machinery (GraphHuffman analog) or negative sampling.

Port of deeplearning4j_tpu/graph/deepwalk.py: the walks are the host copy's
(graph.py), and the embeddings train on the port's SequenceVectors on the
``device`` set on its Builder (default "cuda").
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from .graph import IGraph, RandomWalkIterator
from ..nlp.word2vec import SequenceVectors
from ..util.device import DeviceLike, resolve_device


class DeepWalk:
    class Builder:
        def __init__(self):
            self._vector_size = 100
            self._window = 4
            self._walk_length = 40
            self._walks_per_vertex = 5
            self._learning_rate = 0.025
            self._seed = 42
            self._epochs = 1
            self._negative = 5
            self._use_hs = False
            self._device: DeviceLike = "cuda"

        def vector_size(self, n):
            self._vector_size = n
            return self

        def window_size(self, n):
            self._window = n
            return self

        def walk_length(self, n):
            self._walk_length = n
            return self

        def walks_per_vertex(self, n):
            self._walks_per_vertex = n
            return self

        def learning_rate(self, lr):
            self._learning_rate = lr
            return self

        def seed(self, s):
            self._seed = s
            return self

        def epochs(self, n):
            self._epochs = n
            return self

        def negative_sample(self, n):
            self._negative = n
            return self

        def use_hierarchic_softmax(self, flag):
            self._use_hs = flag
            return self

        def device(self, device: DeviceLike):
            self._device = device
            return self

        def build(self) -> "DeepWalk":
            return DeepWalk(self)

    def __init__(self, b: "DeepWalk.Builder"):
        self._b = b
        self.device = resolve_device(b._device)
        self._sv: Optional[SequenceVectors] = None

    @staticmethod
    def builder() -> "DeepWalk.Builder":
        return DeepWalk.Builder()

    def fit(self, graph_or_walks) -> "DeepWalk":
        b = self._b
        if isinstance(graph_or_walks, IGraph):
            walks = RandomWalkIterator(graph_or_walks, b._walk_length, b._seed,
                                       b._walks_per_vertex)
            sequences = [[str(v) for v in walk] for walk in walks]
        else:
            sequences = [[str(v) for v in walk] for walk in graph_or_walks]
        self._sv = SequenceVectors(
            layer_size=b._vector_size, window=b._window, min_word_frequency=1,
            negative=b._negative, use_hierarchic_softmax=b._use_hs,
            learning_rate=b._learning_rate, epochs=b._epochs, seed=b._seed,
            device=self.device)
        self._sv.fit_sequences(sequences)
        return self

    # -- query (reference DeepWalk.getVertexVector / similarity) ---------------
    def vertex_vector(self, vertex: int) -> Optional[np.ndarray]:
        return self._sv.word_vector(str(vertex))

    def similarity(self, a: int, b: int) -> float:
        return self._sv.similarity(str(a), str(b))

    def verts_nearest(self, vertex: int, n: int = 10) -> List[int]:
        return [int(w) for w in self._sv.words_nearest(str(vertex), n)]

    @property
    def vector_size(self) -> int:
        return self._b._vector_size
