"""mmlspark_tpu_torch — the PyTorch/CUDA port of ``mmlspark_tpu``.

A second package beside the JAX reference, for NVIDIA H100 cards, with
the reference's modules under the same names:

- ``core``: stages, pipelines and their persistence, the columnar
  frame, resilience, and the observability plane (telemetry, tracing,
  the metrics TSDB, the sampling and device profilers);
- ``models``: the frame plane's networks (``NNFunction``, the ResNets,
  ``NNModel``, ``NNLearner``, ``ImageFeaturizer``, the zoo) and the
  transformer LM, dense or a mixture of experts, with its train steps
  on one card or over a mesh's data, sequence, model, expert and pipe
  axes;
- ``serving``: the batched HTTP frontends, the paged decode scheduler
  with the prefix cache and speculative decoding, rollouts, SLOs and
  incident capture;
- ``gbdt``: GBDT training and prediction on one card or sharded with the
  data, feature and voting learners;
- ``stages``, ``featurize``, ``automl``, ``recommend``, ``explain``:
  pipeline stages, featurization, training wrappers, evaluation and
  tuning, SAR, LIME;
- ``io`` and ``streaming``: whole-file and image reading (a host C++
  reader in ``native/``), checkpoints, HTTP on columns and the
  Cognitive Services clients, the file stream source and the retrain
  loop.

Hand-written Hopper kernels (``csrc/``: paged decode and prefill
attention, training attention, ring attention, the fused softmax
cross-entropy, the GBDT histogram) run the hot paths. Entry points run
on the card unless the caller passes ``device="cpu"``.
"""

from mmlspark_tpu_torch.version import __version__

from mmlspark_tpu_torch.core.dataframe import DataFrame
from mmlspark_tpu_torch.core.environment import (  # noqa: F401
    accelerator_count, describe, environment_info,
)
from mmlspark_tpu_torch.core.params import Param
from mmlspark_tpu_torch.core.stage import (
    Transformer, Estimator, Model, Evaluator, PipelineStage,
)
from mmlspark_tpu_torch.core.pipeline import Pipeline, PipelineModel

__all__ = [
    "__version__",
    "DataFrame",
    "Param",
    "PipelineStage",
    "Transformer",
    "Estimator",
    "Model",
    "Evaluator",
    "Pipeline",
    "PipelineModel",
]
