"""ImageFeaturizer: transfer-learning features from a truncated deep net.

The port of ``mmlspark_tpu/models/featurizer.py``: resize images to the
network's input size (the port's :class:`~mmlspark_tpu_torch.stages.
image.ImageTransformer`, on the stage's device), run a net cut N output
layers from the top (a cached :class:`~mmlspark_tpu_torch.models.nn.
NNModel` with ``cut_output_layers``) and emit feature vectors — the
front half of the reference's flowers transfer-learning pipeline
(notebook example 9). Runs on the card unless ``device="cpu"``.

Capability parity with `image-featurizer/src/main/scala/ImageFeaturizer.
scala:36,129-176`.
"""

from __future__ import annotations

import functools
import os

from mmlspark_tpu_torch.core.dataframe import DataFrame
from mmlspark_tpu_torch.core.params import (
    HasDevice, HasInputCol, HasOutputCol, Param,
)
from mmlspark_tpu_torch.core.schema import find_unused_column_name
from mmlspark_tpu_torch.core.stage import Transformer
from mmlspark_tpu_torch.models.function import NNFunction
from mmlspark_tpu_torch.models.nn import NNModel
from mmlspark_tpu_torch.stages.image import ImageTransformer


class ImageFeaturizer(Transformer, HasInputCol, HasOutputCol, HasDevice):
    input_col = Param("image", "image column", ptype=str)
    output_col = Param("features", "feature vector column", ptype=str)
    model = Param(None, "pretrained NNFunction", complex=True)
    cut_output_layers = Param(1, "layers to cut from the top", ptype=int)
    input_shape = Param(None, "(H, W, C) the net expects; taken from the "
                              "zoo manifest when present", ptype=list)
    batch_size = Param(256, "scoring minibatch size", ptype=int)
    drop_nulls = Param(True, "drop rows with missing images", ptype=bool)

    def _set_param(self, name, value):
        self.__dict__.pop("_scorer", None)  # params invalidate cached scorer
        super()._set_param(name, value)

    @functools.cached_property
    def _scorer(self) -> NNModel:
        """One NNModel reused across transforms, so its module stays on
        the device between calls."""
        return NNModel(model=self.model, output_col=self.output_col,
                       cut_output_layers=self.cut_output_layers,
                       batch_size=self.batch_size, device=self.device)

    def transform(self, df: DataFrame) -> DataFrame:
        if self.drop_nulls:
            df = df.drop_nulls(subset=[self.input_col])
        work = df
        feed = self.input_col
        tmp = None
        if self.input_shape:
            h, w = int(self.input_shape[0]), int(self.input_shape[1])
            tmp = find_unused_column_name("__feat_img", df)
            resizer = ImageTransformer(input_col=self.input_col,
                                       output_col=tmp,
                                       device=self.device).resize(h, w)
            work = resizer.transform(work)
            feed = tmp
        scorer = self._scorer
        if scorer.input_col != feed:  # keep the scorer's placed module
            scorer.input_col = feed
        out = scorer.transform(work)
        return out.drop(tmp) if tmp else out

    def _save_extra(self, path, arrays):
        self.model.save(os.path.join(path, "nnfunction"))

    def _load_extra(self, path, arrays):
        self.model = NNFunction.load(os.path.join(path, "nnfunction"))
