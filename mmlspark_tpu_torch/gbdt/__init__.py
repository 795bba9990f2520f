"""GBDT training, prediction and the pipeline stages: the port of
``mmlspark_tpu/gbdt``, on one device or sharded over a mesh's data axis
with the data, feature and voting learners (:mod:`.learners`). The
histogram build is K9 (``csrc/gbdt_histogram.cu``) on the card."""

from mmlspark_tpu_torch.gbdt.binning import BinMapper
from mmlspark_tpu_torch.gbdt.booster import Booster, BoosterParams
from mmlspark_tpu_torch.gbdt.stages import (
    GBDTClassifier, GBDTClassificationModel,
    GBDTRegressor, GBDTRegressionModel,
    LightGBMClassifier, LightGBMRegressor,
    load_native_model,
)

__all__ = [
    "BinMapper", "Booster", "BoosterParams",
    "GBDTClassifier", "GBDTClassificationModel",
    "GBDTRegressor", "GBDTRegressionModel",
    "LightGBMClassifier", "LightGBMRegressor",
    "load_native_model",
]
