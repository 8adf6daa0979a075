"""Driver-facing distributed model wrappers — port of
deeplearning4j_tpu/parallel/spark_api.py (the SparkDl4jMultiLayer /
SparkComputationGraph surface).

A facade that owns (network, TrainingMaster) and exposes fit over
distributed data, evaluate, score and predict: the entry point a
reference user's driver program calls (SparkDl4jMultiLayer.java:67,
SparkComputationGraph.java). "The cluster" is a process mesh
(`parallel/mesh.py`); the RDD is any (re-)iterable of DataSets. `fit`
hands it to the master (`IciDataParallelTrainingMaster` by default), and
evaluation and scoring run split over the same mesh
(`parallel/evaluation.py`). ``close()`` stops the followers.
"""
from __future__ import annotations

from typing import Iterable, Optional

import numpy as np

from .evaluation import distributed_evaluate, distributed_score
from .mesh import ProcessMesh
from .trainer import (IciDataParallelTrainingMaster, TrainingMaster,
                      _mesh_for)


class SparkDl4jMultiLayer:
    """Reference SparkDl4jMultiLayer.java:67 — the driver's handle on a
    distributed MultiLayerNetwork. ``conf_or_net``: a built net, or a
    configuration (built on ``device``)."""

    def __init__(self, conf_or_net, training_master: Optional[TrainingMaster]
                 = None, mesh: Optional[ProcessMesh] = None,
                 device="cuda"):
        from ..nn.multilayer import MultiLayerNetwork
        if hasattr(conf_or_net, "params"):
            self.net = conf_or_net
        else:
            self.net = MultiLayerNetwork(conf_or_net, device=device)
        self.net._check_init()
        self.mesh = mesh or getattr(training_master, "mesh", None) \
            or _mesh_for(None, self.net)
        self.master = training_master or IciDataParallelTrainingMaster(
            mesh=self.mesh)
        if getattr(self.master, "mesh", None) is None:
            self.master.mesh = self.mesh

    # -- training (reference fit(RDD):190,200) -----------------------------
    def fit(self, data: Iterable) -> "SparkDl4jMultiLayer":
        """data: any iterable of DataSets (the RDD analog)."""
        self.master.execute_training(self.net, data)
        return self

    def fit_paths(self, paths: Iterable[str],
                  loader=None) -> "SparkDl4jMultiLayer":
        """Reference fit(String path): train from serialized DataSet files.
        ``loader(path) -> DataSet`` defaults to numpy .npz with features
        and labels (and the masks where present)."""
        from ..datasets.dataset import DataSet

        def default_loader(p):
            with np.load(p) as z:
                return DataSet(z["features"], z["labels"],
                               z.get("features_mask"), z.get("labels_mask"))

        load = loader or default_loader
        self.master.execute_training(self.net, (load(p) for p in paths))
        return self

    # -- inference and metrics ---------------------------------------------
    def predict(self, x) -> np.ndarray:
        """MLlib-style predict (reference predict(Matrix):169-180)."""
        return np.asarray(self.net.output(np.asarray(x)).detach().cpu())

    def evaluate(self, iterator, n_classes: Optional[int] = None):
        """Evaluation split over the mesh."""
        return distributed_evaluate(self.net, iterator, mesh=self.mesh,
                                    n_classes=n_classes)

    def score(self, iterator) -> float:
        """Mean loss over a dataset, split over the mesh."""
        return distributed_score(self.net, iterator, mesh=self.mesh)

    def get_network(self):
        """Reference getNetwork(): the driver's net, final parameters."""
        return self.net

    def get_training_master(self) -> TrainingMaster:
        return self.master

    def get_training_stats(self):
        return self.master.get_training_stats()

    def close(self) -> None:
        """Stop the followers the master started."""
        self.master.close()


class SparkComputationGraph(SparkDl4jMultiLayer):
    """Reference impl/graph/SparkComputationGraph.java — the same facade
    over a ComputationGraph (the masters drive both)."""

    def __init__(self, conf_or_net, training_master: Optional[TrainingMaster]
                 = None, mesh: Optional[ProcessMesh] = None,
                 device="cuda"):
        from ..nn.graph import ComputationGraph
        if not hasattr(conf_or_net, "params"):
            conf_or_net = ComputationGraph(conf_or_net, device=device)
        super().__init__(conf_or_net, training_master, mesh, device)

    def predict(self, *inputs) -> np.ndarray:
        outs = self.net.output(*[np.asarray(a) for a in inputs])
        out = outs[0] if isinstance(outs, (list, tuple)) else outs
        return np.asarray(out.detach().cpu())
