"""FindBestModel: evaluate candidate models on a validation frame, keep
best (the port's copy of ``mmlspark_tpu/automl/best.py``).

Capability parity with `src/find-best-model` (`FindBestModel.scala:51,149`,
`EvaluationUtils.scala:13`): every candidate is scored + evaluated on the
same frame; the winner (by the chosen metric) becomes ``BestModel``, which
also records all candidates' metrics and the winner's ROC for reporting.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional

import numpy as np

from mmlspark_tpu_torch.core.dataframe import DataFrame
from mmlspark_tpu_torch.core.params import Param, HasLabelCol
from mmlspark_tpu_torch.core.stage import Estimator, Model, PipelineStage
from mmlspark_tpu_torch.automl.metrics import ComputeModelStatistics

# metrics where larger is better
_HIGHER_BETTER = {"accuracy", "precision", "recall", "AUC", "R^2"}


def metric_higher_is_better(name: str) -> bool:
    return name in _HIGHER_BETTER


class FindBestModel(Estimator, HasLabelCol):
    """Parity: `FindBestModel.scala:51`."""

    models = Param(None, "candidate fitted models", complex=True)
    evaluation_metric = Param("accuracy", "metric to rank by", ptype=str)

    def fit(self, df: DataFrame) -> "BestModel":
        if not self.models:
            raise ValueError("no candidate models")
        evaluator = ComputeModelStatistics(
            label_col=self.label_col, evaluation_metric="all")
        rows: List[Dict[str, Any]] = []
        best_i, best_val = -1, None
        higher = metric_higher_is_better(self.evaluation_metric)
        all_metrics: List[DataFrame] = []
        for i, model in enumerate(self.models):
            scored = model.transform(df)
            metrics = evaluator.evaluate(scored)
            all_metrics.append(metrics)
            if self.evaluation_metric not in metrics:
                raise ValueError(
                    f"metric {self.evaluation_metric!r} not produced for "
                    f"model {type(model).__name__}; have {metrics.columns}")
            val = float(metrics[self.evaluation_metric][0])
            rows.append({"model": type(model).__name__, "uid": model.uid,
                         self.evaluation_metric: val})
            if best_val is None or (val > best_val if higher else val < best_val):
                best_i, best_val = i, val
        best = self.models[best_i]
        scored = best.transform(df)
        roc = None
        m = all_metrics[best_i]
        if "roc_curve" in m:
            roc = m["roc_curve"][0]
        return BestModel(
            best_model=best,
            best_model_metrics=all_metrics[best_i],
            all_model_metrics=DataFrame.from_rows(rows),
            roc_curve=roc,
            scored_frame=scored)


class BestModel(Model):
    """Parity: `FindBestModel.scala:149` — winner + evaluation artifacts."""

    best_model = Param(None, "the winning fitted model", complex=True)
    best_model_metrics = Param(None, "winner's metrics frame", complex=True)
    all_model_metrics = Param(None, "per-candidate metrics frame",
                              complex=True)
    roc_curve = Param(None, "winner's ROC points", complex=True)
    scored_frame = Param(None, "validation frame scored by winner",
                         complex=True)

    def transform(self, df: DataFrame) -> DataFrame:
        return self.best_model.transform(df)

    def get_evaluated_data(self) -> DataFrame:
        return self.scored_frame

    def get_best_model_metrics(self) -> DataFrame:
        return self.best_model_metrics

    def get_all_model_metrics(self) -> DataFrame:
        return self.all_model_metrics

    def get_roc_curve(self):
        return self.roc_curve

    def _save_extra(self, path, arrays):
        self.best_model.save(os.path.join(path, "best"))

    def _load_extra(self, path, arrays):
        self.best_model = PipelineStage.load(os.path.join(path, "best"))
