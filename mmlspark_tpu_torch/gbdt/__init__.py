"""Single-device GBDT training and prediction: the port of
``mmlspark_tpu/gbdt`` without its stages (the frame plane) and its
feature/voting-parallel learners (the multi-GPU slice). The histogram
build is K9 (``csrc/gbdt_histogram.cu``) on the card."""

from mmlspark_tpu_torch.gbdt.binning import BinMapper
from mmlspark_tpu_torch.gbdt.booster import Booster, BoosterParams

__all__ = ["BinMapper", "Booster", "BoosterParams"]
