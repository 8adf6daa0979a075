"""Distributed training and meshes — the part of
deeplearning4j_tpu/parallel/ ported so far (ROADMAP A7): the
process-group meshes (`mesh.py`), the tensor-parallel plan
(`tensor_parallel.py`, its specs), the data-parallel masters
(`trainer.py`), fault tolerance (`statetracker.py`), the configuration
registry (`registry.py`), distributed evaluation (`evaluation.py`), the
Spark facades (`spark_api.py`) and the training stats (`stats.py`).
Pipeline, MoE, ring/Ulysses attention, ZeRO and hybrid meshes are listed
in ROADMAP.md."""
from .mesh import (DATA_AXIS, EXPERT_AXIS, MODEL_AXIS, PIPE_AXIS, SEQ_AXIS,
                   MeshError, ProcessMesh, backend_for, default_mesh,
                   make_mesh)
from .trainer import (IciDataParallelTrainingMaster, ParallelWrapper,
                      ParameterAveragingTrainingMaster, TrainingMaster)
from .statetracker import (AsyncTrainingStateTracker,
                           TrainingStateTracker, fit_with_recovery)
from .registry import ConfigurationRegistry
from .spark_api import SparkComputationGraph, SparkDl4jMultiLayer
from .evaluation import (DistributedDataSetLossCalculator,
                         DistributedEarlyStoppingTrainer,
                         distributed_evaluate, distributed_score)
from .stats import (NTPTimeSource, SparkTrainingStats, SystemClockTimeSource,
                    TimeSource, device_trace, phase_timer)

__all__ = [
    "DATA_AXIS", "MODEL_AXIS", "SEQ_AXIS", "PIPE_AXIS", "EXPERT_AXIS",
    "MeshError", "ProcessMesh", "backend_for", "default_mesh", "make_mesh",
    "TrainingMaster", "IciDataParallelTrainingMaster",
    "ParameterAveragingTrainingMaster", "ParallelWrapper",
    "TrainingStateTracker", "AsyncTrainingStateTracker",
    "fit_with_recovery", "ConfigurationRegistry",
    "SparkDl4jMultiLayer", "SparkComputationGraph",
    "distributed_evaluate", "distributed_score",
    "DistributedDataSetLossCalculator", "DistributedEarlyStoppingTrainer",
    "SparkTrainingStats", "TimeSource", "SystemClockTimeSource",
    "NTPTimeSource", "phase_timer", "device_trace",
]
