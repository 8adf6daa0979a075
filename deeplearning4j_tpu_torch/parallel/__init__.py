"""Distributed training and meshes — the port of deeplearning4j_tpu/
parallel/: the process-group meshes of one or more axes (`mesh.py`,
with `make_mesh`, `mesh_2d` and `hybrid_mesh`), tensor-parallel
training (`tensor_parallel.py` over Megatron's autograd collectives,
`tp_autograd.py`), the data-parallel masters (`trainer.py`), ZeRO-1
(`zero.py`), ring and Ulysses attention (`ring.py`), GPipe
(`pipeline.py`), MoE (`moe.py`), fault tolerance (`statetracker.py`),
the configuration registry (`registry.py`), distributed evaluation
(`evaluation.py`), the Spark facades (`spark_api.py`) and the training
stats (`stats.py`)."""
from .mesh import (DATA_AXIS, EXPERT_AXIS, MODEL_AXIS, PIPE_AXIS, SEQ_AXIS,
                   MeshError, ProcessMesh, backend_for, default_mesh,
                   hybrid_mesh, make_mesh, mesh_2d)
from .trainer import (IciDataParallelTrainingMaster, ParallelWrapper,
                      ParameterAveragingTrainingMaster, TrainingMaster)
from .statetracker import (AsyncTrainingStateTracker,
                           TrainingStateTracker, fit_with_recovery)
from .registry import ConfigurationRegistry
from .pipeline import GPipeExecutor, stack_block_params
from .moe import MoEExecutor
from .spark_api import SparkComputationGraph, SparkDl4jMultiLayer
from .tensor_parallel import shard_transformer_tp
from .zero import shard_updater_state, updater_state_bytes_per_device
from .evaluation import (DistributedDataSetLossCalculator,
                         DistributedEarlyStoppingTrainer,
                         distributed_evaluate, distributed_score)
from .ring import full_attention, ring_attention, ulysses_attention
from .stats import (NTPTimeSource, SparkTrainingStats, SystemClockTimeSource,
                    TimeSource, device_trace, phase_timer)

__all__ = [
    "DATA_AXIS", "MODEL_AXIS", "SEQ_AXIS", "PIPE_AXIS", "EXPERT_AXIS",
    "MeshError", "ProcessMesh", "backend_for", "default_mesh", "hybrid_mesh",
    "make_mesh", "mesh_2d",
    "TrainingMaster", "IciDataParallelTrainingMaster",
    "ParameterAveragingTrainingMaster", "ParallelWrapper",
    "TrainingStateTracker", "AsyncTrainingStateTracker",
    "fit_with_recovery", "ConfigurationRegistry",
    "GPipeExecutor", "stack_block_params", "MoEExecutor",
    "SparkDl4jMultiLayer", "SparkComputationGraph", "shard_transformer_tp",
    "shard_updater_state", "updater_state_bytes_per_device",
    "distributed_evaluate", "distributed_score",
    "DistributedDataSetLossCalculator", "DistributedEarlyStoppingTrainer",
    "full_attention", "ring_attention", "ulysses_attention",
    "SparkTrainingStats", "TimeSource", "SystemClockTimeSource",
    "NTPTimeSource", "phase_timer", "device_trace",
]
