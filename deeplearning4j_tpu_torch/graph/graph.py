"""Graph API + random walks.

Parity with the reference `deeplearning4j-graph/` (SURVEY.md §2.5): IGraph
API, Graph adjacency impl, GraphLoader edge-list parsing, RandomWalkIterator
(+ weighted variant).

Port of deeplearning4j_tpu/graph/graph.py: a host-only copy (it holds
no tensor).
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np


class IGraph:
    """Reference api/IGraph."""

    def num_vertices(self) -> int:
        raise NotImplementedError

    def get_connected_vertices(self, vertex: int) -> List[int]:
        raise NotImplementedError


class Graph(IGraph):
    """Adjacency-list graph (reference graph/Graph.java)."""

    def __init__(self, num_vertices: int, directed: bool = False):
        self._n = num_vertices
        self.directed = directed
        self._adj: List[List[Tuple[int, float]]] = [[] for _ in range(num_vertices)]

    def add_edge(self, a: int, b: int, weight: float = 1.0):
        self._adj[a].append((b, weight))
        if not self.directed:
            self._adj[b].append((a, weight))

    def num_vertices(self) -> int:
        return self._n

    def num_edges(self) -> int:
        total = sum(len(a) for a in self._adj)
        return total if self.directed else total // 2

    def get_connected_vertices(self, vertex: int) -> List[int]:
        return [v for v, _ in self._adj[vertex]]

    def get_connected_weights(self, vertex: int) -> List[Tuple[int, float]]:
        return list(self._adj[vertex])

    def degree(self, vertex: int) -> int:
        return len(self._adj[vertex])


class GraphLoader:
    """Edge-list parsing (reference data/GraphLoader)."""

    @staticmethod
    def load_undirected_graph_edge_list(path, num_vertices: Optional[int] = None,
                                        delimiter: Optional[str] = None) -> Graph:
        edges = []
        max_v = -1
        for line in Path(path).read_text().splitlines():
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split(delimiter)
            a, b = int(parts[0]), int(parts[1])
            w = float(parts[2]) if len(parts) > 2 else 1.0
            edges.append((a, b, w))
            max_v = max(max_v, a, b)
        g = Graph(num_vertices or max_v + 1, directed=False)
        for a, b, w in edges:
            g.add_edge(a, b, w)
        return g


class RandomWalkIterator:
    """Uniform random walks from every vertex
    (reference iterator/RandomWalkIterator)."""

    def __init__(self, graph: IGraph, walk_length: int, seed: int = 42,
                 walks_per_vertex: int = 1):
        self.graph = graph
        self.walk_length = walk_length
        self.seed = seed
        self.walks_per_vertex = walks_per_vertex

    def __iter__(self) -> Iterator[List[int]]:
        rng = np.random.default_rng(self.seed)
        for _ in range(self.walks_per_vertex):
            for start in range(self.graph.num_vertices()):
                walk = [start]
                cur = start
                for _ in range(self.walk_length - 1):
                    nbrs = self.graph.get_connected_vertices(cur)
                    if not nbrs:
                        break
                    cur = int(nbrs[rng.integers(0, len(nbrs))])
                    walk.append(cur)
                yield walk


class WeightedRandomWalkIterator(RandomWalkIterator):
    """Edge-weight-proportional walks (reference WeightedRandomWalkIterator)."""

    def __iter__(self) -> Iterator[List[int]]:
        rng = np.random.default_rng(self.seed)
        for _ in range(self.walks_per_vertex):
            for start in range(self.graph.num_vertices()):
                walk = [start]
                cur = start
                for _ in range(self.walk_length - 1):
                    nbrs = self.graph.get_connected_weights(cur)
                    if not nbrs:
                        break
                    weights = np.asarray([w for _, w in nbrs], np.float64)
                    probs = weights / weights.sum()
                    cur = int(nbrs[rng.choice(len(nbrs), p=probs)][0])
                    walk.append(cur)
                yield walk
