"""GBDT pipeline stages: the LightGBMClassifier/Regressor replacements
(the port's copy of ``mmlspark_tpu/gbdt/stages.py``).

The estimators fit the port's :class:`~mmlspark_tpu_torch.gbdt.booster.
Booster` on one device, the card unless ``device="cpu"`` (its histogram
build is K9 on the card), and the fitted models predict there; in a
``torch.distributed`` world of several processes a ``parallelism`` other
than ``serial`` shards the fit over the world's data axis, one rank a
process. A device is not persisted: a loaded model takes its loader's
device.

Capability parity with `lightgbm/src/main/scala/LightGBMClassifier.scala:
23,72`, `LightGBMRegressor.scala`, `LightGBMParams.scala:13` and the
model classes (`LightGBMBooster.scala`): Estimators over a features
column with the full param surface, fitted models that add raw-score /
probability / prediction columns, native-model-string save/load
(`saveNativeModel` / python `loadNativeModelFromFile` parity), feature
importances, and incremental batch training (`numBatches` +
`LGBM_BoosterMerge`, `LightGBMBase.scala:25-37`).

Categorical features come from column metadata (categorical slot indexes
inside the assembled vector — parity with `getCategoricalIndexes`,
`LightGBMUtils.scala:63`) or an explicit param.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from mmlspark_tpu_torch.core.dataframe import DataFrame
from mmlspark_tpu_torch.core.params import (
    Param, HasDevice, HasFeaturesCol, HasLabelCol, HasWeightCol, in_range,
    in_set,
)
from mmlspark_tpu_torch.core.stage import Estimator, Model
from mmlspark_tpu_torch.core import schema
from mmlspark_tpu_torch.gbdt.booster import Booster, BoosterParams

# stage-level parallelism names (reference spelling) -> Booster tree_learner
_TREE_LEARNERS = {"data_parallel": "data", "feature_parallel": "feature",
                  "voting_parallel": "voting", "serial": "data"}


class _GBDTParams(HasFeaturesCol, HasLabelCol, HasWeightCol, HasDevice):
    """Shared LightGBM-parity params (`LightGBMParams.scala:13`)."""

    boosting_type = Param("gbdt", "gbdt | rf | dart | goss",
                          validator=in_set("gbdt", "rf", "dart", "goss"))
    num_iterations = Param(100, "boosting rounds", ptype=int)
    learning_rate = Param(0.1, "shrinkage rate", ptype=float)
    num_leaves = Param(31, "max leaves per tree", ptype=int)
    max_depth = Param(-1, "max tree depth (-1 = unlimited)", ptype=int)
    max_bin = Param(255, "max feature bins", ptype=int)
    min_data_in_leaf = Param(20, "min rows per leaf", ptype=int)
    min_sum_hessian_in_leaf = Param(1e-3, "min hessian per leaf", ptype=float)
    lambda_l1 = Param(0.0, "L1 regularization", ptype=float)
    lambda_l2 = Param(0.0, "L2 regularization", ptype=float)
    min_gain_to_split = Param(0.0, "min split gain", ptype=float)
    bagging_fraction = Param(1.0, "row subsample fraction", ptype=float)
    bagging_freq = Param(0, "bag every k iterations", ptype=int)
    feature_fraction = Param(1.0, "feature subsample fraction", ptype=float)
    drop_rate = Param(0.1, "dart dropout rate", ptype=float)
    max_drop = Param(50, "dart max dropped trees", ptype=int)
    skip_drop = Param(0.5, "dart skip probability", ptype=float)
    top_rate = Param(0.2, "goss large-gradient keep rate", ptype=float)
    other_rate = Param(0.1, "goss small-gradient sample rate", ptype=float)
    early_stopping_round = Param(0, "stop after N rounds w/o improvement",
                                 ptype=int)
    metric = Param("", "validation metric (default from objective)", ptype=str)
    validation_fraction = Param(0.0, "held-out fraction for early stopping",
                                ptype=float)
    categorical_feature_indexes = Param(None, "categorical slot indexes "
                                        "(default: from column metadata)",
                                        ptype=list)
    num_batches = Param(0, "split training into N sequential batches merged "
                        "into one booster (parity: numBatches)", ptype=int)
    parallelism = Param("data_parallel", "tree learner (parity: parallelism "
                        "= tree_learner, `LightGBMParams.scala:13-18`): "
                        "data_parallel | feature_parallel | voting_parallel "
                        "| serial; one card fits serially", ptype=str)
    top_k = Param(20, "voting-parallel candidates per worker (parity: "
                  "top_k voting param)", ptype=int)
    histogram_impl = Param("auto", "histogram engine: auto | xla | pallas "
                           "| pallas_interpret (each runs K9 on the card, "
                           "its plain version on the CPU)", ptype=str)
    seed = Param(0, "random seed", ptype=int)
    verbosity = Param(0, "log every N iterations (0 = silent)", ptype=int)
    init_score_col = Param(None, "unused; API parity", ptype=str)

    def _booster_params(self, objective: str, num_class: int = 2,
                        **extra) -> BoosterParams:
        if self.parallelism not in _TREE_LEARNERS:
            raise ValueError(
                f"unknown parallelism {self.parallelism!r}; expected one of "
                f"{sorted(_TREE_LEARNERS)}")
        return BoosterParams(
            objective=objective, boosting_type=self.boosting_type,
            num_iterations=self.num_iterations,
            learning_rate=self.learning_rate, num_leaves=self.num_leaves,
            max_depth=self.max_depth, max_bin=self.max_bin,
            min_data_in_leaf=self.min_data_in_leaf,
            min_sum_hessian_in_leaf=self.min_sum_hessian_in_leaf,
            lambda_l1=self.lambda_l1, lambda_l2=self.lambda_l2,
            min_gain_to_split=self.min_gain_to_split,
            bagging_fraction=self.bagging_fraction,
            bagging_freq=self.bagging_freq,
            feature_fraction=self.feature_fraction,
            num_class=num_class, drop_rate=self.drop_rate,
            max_drop=self.max_drop, skip_drop=self.skip_drop,
            top_rate=self.top_rate, other_rate=self.other_rate,
            early_stopping_round=self.early_stopping_round,
            metric=self.metric, seed=self.seed,
            tree_learner=_TREE_LEARNERS[self.parallelism],
            top_k=self.top_k, histogram_impl=self.histogram_impl, **extra)

    def _categoricals(self, df: DataFrame) -> List[int]:
        if self.categorical_feature_indexes is not None:
            return [int(i) for i in self.categorical_feature_indexes]
        return schema.categorical_slot_indexes(
            df.get_metadata(self.features_col))

    def _feature_names(self, df: DataFrame, F: int) -> List[str]:
        meta = df.get_metadata(self.features_col)
        names = (meta or {}).get("feature_names")
        return list(names) if names and len(names) == F \
            else [f"f{j}" for j in range(F)]

    def _sharding(self):
        """The fit's mesh, where the reference's would shard it: not
        ``serial``, outside ``single_device_scope``, and more than one
        rank, which in the port means more than one process (one rank a
        process, over the world's data axis). ``None`` on one card in
        one process, as the reference's on one device."""
        from mmlspark_tpu_torch.parallel.topology import (
            build_mesh, in_single_device_scope,
        )
        world = (torch.distributed.get_world_size()
                 if torch.distributed.is_initialized() else 1)
        if self.parallelism == "serial" or world == 1 \
                or in_single_device_scope():
            return None
        return build_mesh(device=self.device)

    def _train(self, df: DataFrame, objective: str,
               num_class: int = 2, **extra) -> Booster:
        X = np.asarray(np.stack(df[self.features_col])
                       if df[self.features_col].dtype == np.dtype("O")
                       else df[self.features_col], dtype=np.float64)
        y = np.asarray(df[self.label_col])
        w = np.asarray(df[self.weight_col], dtype=np.float32) \
            if self.weight_col else None
        params = self._booster_params(objective, num_class, **extra)
        cats = self._categoricals(df)
        names = self._feature_names(df, X.shape[1])

        valid_sets = ()
        if self.validation_fraction > 0:
            rng = np.random.default_rng(self.seed)
            mask = rng.random(len(X)) < self.validation_fraction
            valid_sets = ((X[mask], y[mask]),)
            X, y = X[~mask], y[~mask]
            if w is not None:
                w = w[~mask]

        sharding = self._sharding()
        n_batches = max(self.num_batches, 1)
        booster: Optional[Booster] = None
        if n_batches == 1:
            booster = Booster.train(params, X, y, weights=w,
                                    categorical_features=cats,
                                    feature_names=names,
                                    valid_sets=valid_sets, sharding=sharding,
                                    log_every=self.verbosity,
                                    device=self.device)
        else:
            # incremental batch training: N sequential slices, trees merged
            bounds = np.linspace(0, len(X), n_batches + 1).astype(int)
            for i in range(n_batches):
                s, e = bounds[i], bounds[i + 1]
                booster = Booster.train(
                    params, X[s:e], y[s:e],
                    weights=w[s:e] if w is not None else None,
                    categorical_features=cats, feature_names=names,
                    valid_sets=valid_sets, init_model=booster,
                    sharding=sharding, log_every=self.verbosity,
                    device=self.device)
        return booster


class _GBDTModelBase(Model, HasFeaturesCol, HasDevice):
    booster = Param(None, "trained Booster", complex=True)
    prediction_col = Param("prediction", "prediction column", ptype=str)

    def _features(self, df: DataFrame) -> np.ndarray:
        col = df[self.features_col]
        return np.asarray(np.stack(col) if col.dtype == np.dtype("O") else col,
                          dtype=np.float64)

    def feature_importances(self, importance_type: str = "split") -> np.ndarray:
        return self.booster.feature_importances(importance_type)

    def save_native_model(self, path: str, format: Optional[str] = None) -> None:
        """Parity: LightGBMBooster.saveNativeModel (`LightGBMBooster.scala:104`).

        ``format="lightgbm"`` writes LightGBM's text model format
        (including categorical bitset splits), loadable by LightGBM
        tooling and by :func:`load_native_model`; ``format="json"``
        writes this framework's own model string (also loadable by
        :func:`load_native_model`). By default (``format=None``) the
        LightGBM format is written; the rare tree that format cannot
        represent (a categorical split routing MISSING left — LightGBM
        always sends NaN right) falls back to json with a warning, while
        an explicit ``format="lightgbm"`` request still raises
        ``NotImplementedError``.
        """
        if format not in (None, "lightgbm", "json"):
            raise ValueError(f"unknown format {format!r}")
        from mmlspark_tpu_torch.io import fs as _fs
        if format == "json":
            text = self.booster.model_to_string()
        else:
            try:
                text = self.booster.to_lightgbm_string()
            except NotImplementedError:
                if format == "lightgbm":
                    raise
                import warnings
                warnings.warn(
                    "model has a categorical split routing MISSING left, "
                    "which LightGBM's text format cannot represent; saving "
                    "format='json' instead (loadable by load_native_model)",
                    stacklevel=2)
                text = self.booster.model_to_string()
        _fs.write_text(path, text)

    def _save_extra(self, path, arrays):
        import os
        with open(os.path.join(path, "booster.json"), "w") as f:
            f.write(self.booster.model_to_string())

    def _load_extra(self, path, arrays):
        import os
        with open(os.path.join(path, "booster.json")) as f:
            self.booster = Booster.from_string(f.read(),
                                               device=self.device)


class GBDTClassifier(Estimator, _GBDTParams):
    """Binary/multiclass GBDT classifier (parity: LightGBMClassifier)."""

    objective = Param("binary", "binary | multiclass",
                      validator=in_set("binary", "multiclass"))
    probability_col = Param("probability", "probability column", ptype=str)
    raw_prediction_col = Param("raw_prediction", "raw score column", ptype=str)
    prediction_col = Param("prediction", "label prediction column", ptype=str)

    def fit(self, df: DataFrame) -> "GBDTClassificationModel":
        y = np.asarray(df[self.label_col])
        classes = np.unique(y)
        num_class = len(classes)
        objective = self.objective
        if objective == "binary" and num_class > 2:
            objective = "multiclass"
        y_idx = np.searchsorted(classes, y)
        work = df.with_column(self.label_col, y_idx)
        booster = self._train(work, objective, num_class=num_class)
        return GBDTClassificationModel(
            booster=booster, features_col=self.features_col,
            probability_col=self.probability_col,
            raw_prediction_col=self.raw_prediction_col,
            prediction_col=self.prediction_col,
            classes=[float(c) for c in classes], device=self.device)


class GBDTClassificationModel(_GBDTModelBase):
    probability_col = Param("probability", "probability column", ptype=str)
    raw_prediction_col = Param("raw_prediction", "raw score column", ptype=str)
    classes = Param(None, "original class labels", ptype=list)

    def transform(self, df: DataFrame) -> DataFrame:
        X = self._features(df)
        raw = self.booster.predict_raw(X)
        # the objective's transform in f32 on the booster's device, as
        # the reference transforms an f32 array
        prob = self.booster.obj.transform(torch.as_tensor(
            raw, dtype=torch.float32,
            device=self.booster.device)).cpu().numpy()
        if raw.shape[1] == 1:  # binary: expand to 2-class columns
            prob = np.concatenate([1 - prob, prob], axis=1)
            raw = np.concatenate([-raw, raw], axis=1)
        pred_idx = prob.argmax(axis=1)
        classes = np.asarray(self.classes or range(prob.shape[1]))
        out = df.with_column(
            self.raw_prediction_col, raw,
            metadata=schema.make_role_meta(schema.SCORES_KIND, self.uid,
                                           task=schema.CLASSIFICATION))
        out = out.with_column(
            self.probability_col, prob,
            metadata=schema.make_role_meta(schema.SCORED_PROBABILITIES_KIND,
                                           self.uid))
        return out.with_column(
            self.prediction_col, classes[pred_idx],
            metadata=schema.make_role_meta(schema.SCORED_LABELS_KIND,
                                           self.uid))


class GBDTRegressor(Estimator, _GBDTParams):
    """GBDT regressor (parity: LightGBMRegressor + application params)."""

    objective = Param("regression", "regression | regression_l1 | quantile | "
                      "poisson | tweedie",
                      validator=in_set("regression", "regression_l1", "l2",
                                       "l1", "mae", "mse", "quantile",
                                       "poisson", "tweedie"))
    alpha = Param(0.9, "quantile level", ptype=float)
    tweedie_variance_power = Param(1.5, "tweedie variance power",
                                   ptype=float, validator=in_range(1.0, 2.0))

    def fit(self, df: DataFrame) -> "GBDTRegressionModel":
        booster = self._train(df, self.objective, alpha=self.alpha,
                              tweedie_variance_power=self.tweedie_variance_power)
        return GBDTRegressionModel(booster=booster,
                                   features_col=self.features_col,
                                   device=self.device)


class GBDTRegressionModel(_GBDTModelBase):
    def transform(self, df: DataFrame) -> DataFrame:
        X = self._features(df)
        pred = self.booster.predict(X)
        return df.with_column(
            self.prediction_col, pred,
            metadata=schema.make_role_meta(schema.SCORES_KIND, self.uid,
                                           task=schema.REGRESSION))


def load_native_model(path: str, is_classifier: bool = True,
                      **stage_params):
    """Parity: python LightGBM*.loadNativeModelFromFile. Accepts local
    paths or remote URLs (the save/load pair both go through io.fs)."""
    from mmlspark_tpu_torch.io import fs as _fs
    booster = Booster.from_string(_fs.read_text(path),
                                  device=stage_params.get("device"))
    cls = GBDTClassificationModel if is_classifier else GBDTRegressionModel
    return cls(booster=booster, **stage_params)


# Familiar aliases for users migrating from the reference
LightGBMClassifier = GBDTClassifier
LightGBMRegressor = GBDTRegressor
