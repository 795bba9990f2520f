"""Serving: batched HTTP inference frontends, the decode plane and
multi-host coordination (the port's copy of
``mmlspark_tpu/serving/__init__.py``).

``POST /generate`` reaches a :class:`DecodeScheduler` bound to a
:class:`ServingServer`; its thread launches the decode kernels on the
card, and the socket edge (the event-loop frontend of
:mod:`mmlspark_tpu_torch.serving.frontend`, or the threaded
``http.server`` baseline with ``frontend="threaded"``) handles host JSON
only. Every worker serves ``GET /metrics`` and carries ``X-Trace-Id``
through its data plane; the :class:`ServingCoordinator` merges a fleet's
``/stats`` and scrapes. ``requests`` is imported only by the clients
that send (``ServingClient``, the coordinator's fan-out, rollout).
``POST /predict`` serves a frame-plane stage (an ``NNModel``, a GBDT
model, a pipeline of them); ``python -m mmlspark_tpu_torch.serving
worker`` loads one from ``$MODEL_URI``.
"""

from mmlspark_tpu_torch.serving.server import (
    ServingClient, ServingCoordinator, ServingServer,
)
from mmlspark_tpu_torch.serving.capture import TrafficCapture
from mmlspark_tpu_torch.serving.consolidator import PartitionConsolidator
from mmlspark_tpu_torch.serving.decode import (
    DecodeOverloaded, DecodeScheduler, PagePool, PrefixCache, Sampler,
    SlotPool, TransformerDecoder,
)
from mmlspark_tpu_torch.serving.frontend import EventLoopFrontend
from mmlspark_tpu_torch.serving.incident import (
    FanoutNotifier, IncidentManager,
)
from mmlspark_tpu_torch.serving.policy import (
    AdaptiveBatchPolicy, PriorityShedPolicy, SpeculationPolicy,
)
from mmlspark_tpu_torch.serving.quant import QuantizationConfig
from mmlspark_tpu_torch.serving.rollout import (
    ModelVersionManager, RolloutError, RolloutOrchestrator,
)
from mmlspark_tpu_torch.serving.tenancy import (
    FairCycle, Tenant, TenantRegistry, TokenBucket, extract_api_key,
)

__all__ = ["ServingServer", "ServingCoordinator", "ServingClient",
           "PartitionConsolidator", "EventLoopFrontend",
           "ModelVersionManager", "RolloutError", "RolloutOrchestrator",
           "DecodeScheduler", "DecodeOverloaded", "SlotPool", "PagePool",
           "PrefixCache",
           "TransformerDecoder", "AdaptiveBatchPolicy",
           "QuantizationConfig",
           "SpeculationPolicy", "Sampler", "TrafficCapture",
           "Tenant", "TenantRegistry", "TokenBucket", "FairCycle",
           "PriorityShedPolicy", "extract_api_key",
           "IncidentManager", "FanoutNotifier"]
