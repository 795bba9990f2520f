"""The port's core: stages, pipelines and their persistence, the
columnar frame and its column metadata, resilience primitives,
telemetry, tracing, the metrics TSDB and the profilers
(``mmlspark_tpu/core``'s public names)."""
from mmlspark_tpu_torch.core.dataframe import DataFrame
from mmlspark_tpu_torch.core.params import Param, Params
from mmlspark_tpu_torch.core.stage import (
    PipelineStage,
    Transformer,
    Estimator,
    Model,
    Evaluator,
)
from mmlspark_tpu_torch.core.pipeline import Pipeline, PipelineModel
from mmlspark_tpu_torch.core.resilience import (
    BreakerBoard,
    CircuitBreaker,
    CircuitOpen,
    Deadline,
    DeadlineExceeded,
    ManualClock,
    RetryPolicy,
)
from mmlspark_tpu_torch.core.telemetry import (
    REGISTRY,
    MetricsRegistry,
    current_trace_id,
    trace_context,
)
from mmlspark_tpu_torch.core import schema

__all__ = [
    "REGISTRY",
    "MetricsRegistry",
    "current_trace_id",
    "trace_context",
    "BreakerBoard",
    "CircuitBreaker",
    "CircuitOpen",
    "Deadline",
    "DeadlineExceeded",
    "ManualClock",
    "RetryPolicy",
    "DataFrame",
    "Param",
    "Params",
    "PipelineStage",
    "Transformer",
    "Estimator",
    "Model",
    "Evaluator",
    "Pipeline",
    "PipelineModel",
    "schema",
]
