"""Serving: the HTTP server, the streaming routes, the durable log, and the
fleet (replica processes, the journaled router, the telemetry plane) — the
JAX package's `serving` exports, name for name."""
from ..inference.batcher import (MicroBatcher, QueueFullError,
                                 RequestTimeoutError)
from ..inference.engine import DecodeScheduler
from ..inference.metrics import MetricsRegistry
from .durable import (DurableLogConsumer, DurableLogProducer,
                      DurableStreamingTrainer)
from .replica import ReplicaProcess, ReplicaSupervisor
from .router import (FleetRouter, ReplicaEndpoint, RequestJournal,
                     affinity_key, pick_replica)
from .server import InferenceServer
from .streaming import (QueueDataSetIterator, RecordToDataSetConverter,
                        ServeRoute, StreamingTrainingPipeline)
from .telemetry import (TRACE_HEADER, ClientTracer, FleetMetrics,
                        FleetTelemetryServer, TraceAggregator,
                        TraceContext, format_trace_header,
                        parse_trace_header)

__all__ = ["ClientTracer", "DecodeScheduler", "DurableLogConsumer",
           "DurableLogProducer", "DurableStreamingTrainer",
           "FleetMetrics", "FleetRouter", "FleetTelemetryServer",
           "InferenceServer", "MetricsRegistry", "MicroBatcher",
           "QueueDataSetIterator", "QueueFullError",
           "RecordToDataSetConverter", "ReplicaEndpoint",
           "ReplicaProcess", "ReplicaSupervisor", "RequestJournal",
           "RequestTimeoutError", "ServeRoute",
           "StreamingTrainingPipeline", "TRACE_HEADER",
           "TraceAggregator", "TraceContext", "affinity_key",
           "format_trace_header", "parse_trace_header", "pick_replica"]
