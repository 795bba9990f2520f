"""AutoML train wrappers: featurize-then-fit any learner.

The port's copy of ``mmlspark_tpu/automl/train.py``: the inner
estimator keeps its own device (a ``GBDTClassifier`` fits on the card
unless it was given ``device="cpu"``).

Capability parity with `src/train` (`AutoTrainer.scala:12`,
`TrainClassifier.scala:50,278`, `TrainRegressor.scala:21,139`): wrap any
Estimator so users hand a raw heterogeneous frame and a label column;
featurization (per-type handling + assembly), label reindexing, fitting,
and score-column metadata all happen inside. The fitted model carries the
featurization so scoring raw frames round-trips.
"""

from __future__ import annotations

import os
from typing import Any, List, Optional

import numpy as np

from mmlspark_tpu_torch.core.dataframe import DataFrame
from mmlspark_tpu_torch.core.params import Param, HasLabelCol, in_range
from mmlspark_tpu_torch.core.stage import Estimator, Model, PipelineStage
from mmlspark_tpu_torch.core import schema as S
from mmlspark_tpu_torch.featurize import Featurize


class _AutoTrainer(Estimator, HasLabelCol):
    """Parity: `AutoTrainer.scala:12` (shared model/featurization params)."""

    model = Param(None, "the inner estimator to fit", complex=True)
    features_col = Param("__auto_features", "internal assembled features",
                         ptype=str)
    number_of_features = Param(256, "hash dims for text columns", ptype=int,
                               validator=in_range(lo=1))

    def _featurize(self, df: DataFrame, one_hot: bool):
        feature_cols = [c for c in df.columns if c != self.label_col]
        feat = Featurize(
            feature_columns=feature_cols,
            number_of_features=self.number_of_features,
            one_hot_encode_categoricals=one_hot,
            output_col=self.features_col).fit(df)
        return feat


class TrainClassifier(_AutoTrainer):
    """Featurize + reindex labels + fit a classifier.

    Parity: `TrainClassifier.scala:50` — labels are reindexed to [0, n)
    (`ValueIndexer` role), features assembled from every non-label column,
    and the inner model's score columns get ML-role metadata so evaluators
    can auto-detect them.
    """

    reindex_label = Param(True, "reindex labels to [0, n)", ptype=bool)

    def fit(self, df: DataFrame) -> "TrainedClassifierModel":
        # tree learners keep categorical indexes; others one-hot. We can't
        # introspect arbitrary estimators, so one-hot by default and let
        # GBDT read categorical_slots either way.
        featurizer = self._featurize(df, one_hot=True)
        work = featurizer.transform(df)

        levels: Optional[List[Any]] = None
        y = df[self.label_col]
        if self.reindex_label:
            vals = [v.item() if isinstance(v, np.generic) else v for v in y]
            levels = sorted(set(vals), key=lambda v: (isinstance(v, str), v))
            lookup = {lv: i for i, lv in enumerate(levels)}
            work = work.with_column(
                self.label_col,
                np.array([lookup[v] for v in vals], dtype=np.int64),
                metadata=S.make_categorical_meta(levels))

        inner = self.model.copy(features_col=self.features_col,
                                label_col=self.label_col)
        fitted = inner.fit(work)
        return TrainedClassifierModel(
            label_col=self.label_col, features_col=self.features_col,
            featurizer=featurizer, fitted=fitted,
            levels=levels)


class TrainedClassifierModel(Model, HasLabelCol):
    """Parity: `TrainClassifier.scala:278` (TrainedClassifierModel)."""

    features_col = Param("__auto_features", "internal features", ptype=str)
    featurizer = Param(None, "fitted featurization", complex=True)
    fitted = Param(None, "fitted inner model", complex=True)
    levels = Param(None, "original label levels", ptype=list)

    def transform(self, df: DataFrame) -> DataFrame:
        out = self.fitted.transform(self.featurizer.transform(df))
        if self.levels is not None:
            levels = self.levels
            pred_col = getattr(self.fitted, "prediction_col", "prediction")
            if pred_col in out:
                idx = np.asarray(out[pred_col]).astype(np.int64)
                vals = [levels[i] if 0 <= i < len(levels) else None
                        for i in idx]
                meta = S.make_role_meta(S.SCORED_LABELS_KIND, self.uid)
                meta["levels"] = list(levels)
                out = out.with_column(pred_col, vals, metadata=meta)
            # level order on the probability column tells evaluators which
            # column belongs to which original label (per-instance log-loss)
            prob_col = getattr(self.fitted, "probability_col", "probability")
            if prob_col in out:
                meta = dict(out.get_metadata(prob_col))
                meta["levels"] = list(levels)
                out = out.with_metadata(prob_col, meta)
        return out.drop(self.features_col)

    def _save_extra(self, path, arrays):
        self.featurizer.save(os.path.join(path, "featurizer"))
        self.fitted.save(os.path.join(path, "fitted"))

    def _load_extra(self, path, arrays):
        self.featurizer = PipelineStage.load(os.path.join(path, "featurizer"))
        self.fitted = PipelineStage.load(os.path.join(path, "fitted"))


class TrainRegressor(_AutoTrainer):
    """Featurize + fit a regressor (parity: `TrainRegressor.scala:21`)."""

    def fit(self, df: DataFrame) -> "TrainedRegressorModel":
        featurizer = self._featurize(df, one_hot=True)
        work = featurizer.transform(df)
        work = work.with_column(
            self.label_col,
            np.asarray(df[self.label_col], dtype=np.float64))
        inner = self.model.copy(features_col=self.features_col,
                                label_col=self.label_col)
        fitted = inner.fit(work)
        return TrainedRegressorModel(
            label_col=self.label_col, features_col=self.features_col,
            featurizer=featurizer, fitted=fitted)


class TrainedRegressorModel(Model, HasLabelCol):
    """Parity: `TrainRegressor.scala:139`."""

    features_col = Param("__auto_features", "internal features", ptype=str)
    featurizer = Param(None, "fitted featurization", complex=True)
    fitted = Param(None, "fitted inner model", complex=True)

    def transform(self, df: DataFrame) -> DataFrame:
        out = self.fitted.transform(self.featurizer.transform(df))
        return out.drop(self.features_col)

    def _save_extra(self, path, arrays):
        self.featurizer.save(os.path.join(path, "featurizer"))
        self.fitted.save(os.path.join(path, "fitted"))

    def _load_extra(self, path, arrays):
        self.featurizer = PipelineStage.load(os.path.join(path, "featurizer"))
        self.fitted = PipelineStage.load(os.path.join(path, "fitted"))
