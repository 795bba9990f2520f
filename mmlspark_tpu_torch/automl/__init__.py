"""AutoML layer: the train wrappers (``mmlspark_tpu/automl``'s
``train`` names; its evaluators, model selection and tuning wait for
**the long tail**).

Capability parity with the reference's `src/train`
(TrainClassifier/TrainRegressor).
"""

from mmlspark_tpu_torch.automl.train import (
    TrainClassifier, TrainedClassifierModel,
    TrainRegressor, TrainedRegressorModel,
)

__all__ = [
    "TrainClassifier", "TrainedClassifierModel",
    "TrainRegressor", "TrainedRegressorModel",
]
