"""Evaluators: model-level and per-instance statistics from scored
frames (the port's copy of ``mmlspark_tpu/automl/metrics.py``).

Capability parity with `src/compute-model-statistics`
(`ComputeModelStatistics.scala:57`) and `src/compute-per-instance-statistics`
(`ComputePerInstanceStatistics.scala:42`), with the reference's
metadata-driven column auto-detection (score columns found via the ML-role
metadata models stamp on their outputs) and the canonical metric names from
`core/metrics/MetricConstants.scala:9-83`.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from mmlspark_tpu_torch.core.dataframe import DataFrame
from mmlspark_tpu_torch.core.params import Param, HasLabelCol, in_set
from mmlspark_tpu_torch.core.stage import Evaluator
from mmlspark_tpu_torch.core import schema as S

# canonical names (MetricConstants.scala)
CLASSIFICATION_METRICS = ("accuracy", "precision", "recall", "AUC")
REGRESSION_METRICS = ("mean_squared_error", "root_mean_squared_error",
                      "R^2", "mean_absolute_error")
ALL_METRICS = "all"


def _roc_points(y: np.ndarray, score: np.ndarray) -> np.ndarray:
    """ROC curve points (fpr, tpr): one point per distinct score threshold.

    Grouping by threshold (not by row) makes tied scores contribute a
    single diagonal segment, so the curve — like the AUC below — does not
    depend on row order.
    """
    order = np.argsort(-score, kind="stable")
    y = y[order]
    s = score[order]
    tps = np.cumsum(y == 1)
    fps = np.cumsum(y == 0)
    last_of_threshold = np.flatnonzero(np.diff(s, append=np.nan) != 0)
    tps, fps = tps[last_of_threshold], fps[last_of_threshold]
    n_pos = max(float(tps[-1]) if len(tps) else 0.0, 1e-12)
    n_neg = max(float(fps[-1]) if len(fps) else 0.0, 1e-12)
    tpr = np.concatenate([[0.0], tps / n_pos])
    fpr = np.concatenate([[0.0], fps / n_neg])
    return np.stack([fpr, tpr], axis=1)


def _auc(y: np.ndarray, score: np.ndarray) -> float:
    """Tie-corrected AUC (Mann-Whitney with average ranks).

    Tied scores get half credit, so a constant classifier scores 0.5
    regardless of row order.
    """
    n_pos = int((y == 1).sum())
    n_neg = len(y) - n_pos
    if n_pos == 0 or n_neg == 0:
        return 0.0
    # average rank within each tie group, fully vectorized
    _, inv, counts = np.unique(score, return_inverse=True,
                               return_counts=True)
    ends = np.cumsum(counts)
    avg_rank = (ends - counts + 1 + ends) / 2.0  # mean of 1-based positions
    ranks = avg_rank[inv]
    rank_sum_pos = float(ranks[y == 1].sum())
    return (rank_sum_pos - n_pos * (n_pos + 1) / 2.0) / (n_pos * n_neg)


def classification_metrics(y: np.ndarray, pred: np.ndarray,
                           score: Optional[np.ndarray] = None
                           ) -> Dict[str, Any]:
    """Accuracy / macro precision / macro recall / AUC + confusion matrix."""
    classes = np.unique(np.concatenate([y, pred]))
    k = len(classes)
    idx = {c: i for i, c in enumerate(classes)}
    cm = np.zeros((k, k), dtype=np.int64)
    for yi, pi in zip(y, pred):
        cm[idx[yi], idx[pi]] += 1
    tp = np.diag(cm).astype(np.float64)
    col_sums = cm.sum(axis=0).astype(np.float64)
    row_sums = cm.sum(axis=1).astype(np.float64)
    precision = float(np.mean(np.where(col_sums > 0, tp / np.maximum(col_sums, 1), 0.0)))
    recall = float(np.mean(np.where(row_sums > 0, tp / np.maximum(row_sums, 1), 0.0)))
    out: Dict[str, Any] = {
        "accuracy": float(np.mean(y == pred)),
        "precision": precision,
        "recall": recall,
        "confusion_matrix": cm,
    }
    if score is not None and k == 2:
        y_bin = (y == classes[1]).astype(np.int64)
        out["AUC"] = _auc(y_bin, score)
        out["roc_curve"] = _roc_points(y_bin, score)
    return out


def regression_metrics(y: np.ndarray, pred: np.ndarray) -> Dict[str, float]:
    y = np.asarray(y, dtype=np.float64)
    pred = np.asarray(pred, dtype=np.float64)
    mse = float(np.mean((y - pred) ** 2))
    ss_tot = float(np.sum((y - np.mean(y)) ** 2))
    ss_res = float(np.sum((y - pred) ** 2))
    return {
        "mean_squared_error": mse,
        "root_mean_squared_error": float(np.sqrt(mse)),
        "R^2": 1.0 - ss_res / ss_tot if ss_tot > 0 else 0.0,
        "mean_absolute_error": float(np.mean(np.abs(y - pred))),
    }


class ComputeModelStatistics(Evaluator, HasLabelCol):
    """Compute classification or regression metrics from a scored frame.

    Parity: `ComputeModelStatistics.scala:57` — the task and columns are
    auto-detected from ML-role metadata when not set explicitly;
    ``evaluate`` returns a one-row metrics frame (confusion matrix and ROC
    as array-valued cells, as the reference returns them in DataFrame
    cells).
    """

    evaluation_metric = Param("all", "metric set or single metric name",
                              ptype=str)
    scores_col = Param(None, "raw score column", ptype=str)
    scored_labels_col = Param(None, "predicted label column", ptype=str)
    scored_probabilities_col = Param(None, "probability column", ptype=str)

    def _detect(self, df: DataFrame) -> Tuple[str, str, Optional[str], Optional[str]]:
        """-> (task, pred_col, scores_col, prob_col)"""
        pred_col = self.scored_labels_col or \
            S.find_column_by_role(df, S.SCORED_LABELS_KIND)
        scores_col = self.scores_col or \
            S.find_column_by_role(df, S.SCORES_KIND)
        prob_col = self.scored_probabilities_col or \
            S.find_column_by_role(df, S.SCORED_PROBABILITIES_KIND)
        task = None
        if scores_col is not None:
            task = (df.get_metadata(scores_col) or {}).get("task")
        if task is None:
            task = S.CLASSIFICATION if pred_col is not None else S.REGRESSION
        if task == S.REGRESSION and pred_col is None:
            pred_col = scores_col or "prediction"
        return task, pred_col, scores_col, prob_col

    def evaluate(self, df: DataFrame) -> DataFrame:
        task, pred_col, scores_col, prob_col = self._detect(df)
        y = df[self.label_col]
        if task == S.CLASSIFICATION:
            pred = df[pred_col]
            score = None
            if prob_col is not None:
                p = np.asarray(df[prob_col], dtype=np.float64)
                if p.ndim == 2 and p.shape[1] >= 2:
                    score = p[:, 1]
                else:
                    score = p.reshape(len(p))
            elif scores_col is not None:
                s = np.asarray(df[scores_col], dtype=np.float64)
                score = s[:, -1] if s.ndim == 2 else s
            m = classification_metrics(np.asarray(y), np.asarray(pred), score)
        else:
            m = regression_metrics(df[self.label_col], df[pred_col])
        want = self.evaluation_metric
        if want != ALL_METRICS:
            if want not in m:
                raise ValueError(f"metric {want!r} unavailable; have "
                                 f"{sorted(m)}")
            m = {want: m[want]}
        cols: Dict[str, Any] = {}
        for k, v in m.items():
            if isinstance(v, np.ndarray):
                cols[k] = np.empty(1, dtype=object)
                cols[k][0] = v
            else:
                cols[k] = np.array([v])
        return DataFrame(cols)


class ComputePerInstanceStatistics(Evaluator, HasLabelCol):
    """Per-row losses appended as columns.

    Parity: `ComputePerInstanceStatistics.scala:42` — regression: L1/L2
    loss per row; classification: log-loss of the true label's predicted
    probability.
    """

    def evaluate(self, df: DataFrame) -> DataFrame:
        cms = ComputeModelStatistics(label_col=self.label_col)
        task, pred_col, scores_col, prob_col = cms._detect(df)
        y = df[self.label_col]
        if task == S.REGRESSION:
            pred = np.asarray(df[pred_col], dtype=np.float64)
            yv = np.asarray(y, dtype=np.float64)
            df = df.with_column("L1_loss", np.abs(yv - pred))
            return df.with_column("L2_loss", (yv - pred) ** 2)
        if prob_col is None:
            raise ValueError("classification per-instance stats need a "
                             "probability column")
        prob = np.asarray(df[prob_col], dtype=np.float64)
        y_idx = np.asarray(y)
        if y_idx.dtype == np.dtype("O") or y_idx.dtype.kind in "US":
            # Training-time level order rides on the score columns' metadata
            # (stamped by TrainedClassifierModel); the eval frame's own label
            # set can be a subset, so deriving order from it would misalign
            # probability columns.
            levels = None
            for col in (prob_col, pred_col):
                if col is not None:
                    levels = df.get_metadata(col).get("levels")
                    if levels:
                        break
            if not levels:
                levels = sorted(set(y_idx))
            lookup = {v: i for i, v in enumerate(levels)}
            y_idx = np.array([lookup.get(v, -1) for v in y_idx])
        y_idx = y_idx.astype(np.int64)
        unseen = (y_idx < 0) | (y_idx >= prob.shape[1])
        p_true = prob[np.arange(len(prob)), np.clip(y_idx, 0,
                                                    prob.shape[1] - 1)]
        loss = -np.log(np.clip(p_true, 1e-15, 1.0))
        # labels outside the training levels have no probability column
        loss[unseen] = np.nan
        return df.with_column("log_loss", loss)
