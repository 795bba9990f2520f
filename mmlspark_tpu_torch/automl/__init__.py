"""AutoML layer: train wrappers, evaluators, model selection, tuning
(``mmlspark_tpu/automl``'s names).

Capability parity with the reference's L4 meta-algorithms: `src/train`
(TrainClassifier/TrainRegressor), `src/compute-model-statistics`,
`src/compute-per-instance-statistics`, `src/find-best-model`,
`src/tune-hyperparameters`. The evaluators and model selection run on
the host; each inner estimator keeps its own device, and
``TuneHyperparameters`` pins each trial to its own card when the host
has more than one.
"""

from mmlspark_tpu_torch.automl.train import (
    TrainClassifier, TrainedClassifierModel,
    TrainRegressor, TrainedRegressorModel,
)
from mmlspark_tpu_torch.automl.metrics import (
    ComputeModelStatistics, ComputePerInstanceStatistics,
    classification_metrics, regression_metrics,
)
from mmlspark_tpu_torch.automl.best import FindBestModel, BestModel
from mmlspark_tpu_torch.automl.tune import (
    TuneHyperparameters, TuneHyperparametersModel,
    HyperparamBuilder, DiscreteHyperParam, RangeHyperParam,
    IntRangeHyperParam, DoubleRangeHyperParam,
    GridSpace, RandomSpace, DefaultHyperparams,
)

__all__ = [
    "TrainClassifier", "TrainedClassifierModel",
    "TrainRegressor", "TrainedRegressorModel",
    "ComputeModelStatistics", "ComputePerInstanceStatistics",
    "classification_metrics", "regression_metrics",
    "FindBestModel", "BestModel",
    "TuneHyperparameters", "TuneHyperparametersModel",
    "HyperparamBuilder", "DiscreteHyperParam", "RangeHyperParam",
    "IntRangeHyperParam", "DoubleRangeHyperParam",
    "GridSpace", "RandomSpace", "DefaultHyperparams",
]
