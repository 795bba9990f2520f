"""Micro-batch streaming engine: the structured-streaming half of the
reference system ("MMLSpark: Unifying Machine Learning Ecosystems at
Massive Scales", arxiv 1810.08744) — versioned micro-batches over a
write-ahead offset log + commit log (exactly-once sinks across
crash/restart), event-time watermarks with windowed aggregation, and
source-side backpressure wired into the resilience layer.

The headline consumer is the retrain->redeploy loop
(:mod:`mmlspark_tpu_torch.streaming.loop`): served traffic captured by
:class:`mmlspark_tpu_torch.serving.capture.TrafficCapture` flows through
:class:`~mmlspark_tpu_torch.streaming.traffic.TrafficLogSource` into
``NNLearner.fit_stream``, whose digest-manifested checkpoint exports a
:class:`~mmlspark_tpu_torch.streaming.loop.RetrainLoop` pushes through the
coordinator's shadow/canary rollout gates — the system continuously
learns from its own traffic and redeploys itself with zero downtime.
See docs/streaming.md.
"""

from mmlspark_tpu_torch.streaming.engine import (
    MemoryStreamSource,
    StreamingQuery,
    StreamingQueryError,
    WindowSpec,
)
from mmlspark_tpu_torch.streaming.loop import RetrainLoop
from mmlspark_tpu_torch.streaming.traffic import TrafficLogSource

__all__ = [
    "MemoryStreamSource",
    "RetrainLoop",
    "StreamingQuery",
    "StreamingQueryError",
    "TrafficLogSource",
    "WindowSpec",
]
