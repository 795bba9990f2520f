"""SAR (Smart Adaptive Recommendations) on the card (the port of
``mmlspark_tpu/recommend/sar.py``).

Capability parity with `recommendation/src/main/scala/SAR.scala:36,82,148`
and `SARModel.scala:21`:

* user-item affinity with exponential time decay
  (`calculateUserItemAffinities`),
* item-item similarity from co-occurrence counts, as cooccurrence / lift /
  Jaccard (`calculateItemItemSimilarity`),
* top-k recommendation for all users (`SARModel.recommendForAllUsers`).

Where the reference does broadcast sparse matrix multiplies over Spark
partitions, here both the co-occurrence count ``C = B^T B`` (B = the
binarized user-item matrix) and the scoring product ``scores = A @ S``
are dense f32 products on the stage's device (the card unless
``device="cpu"``), as JAX computes them with jitted matmuls and x64 off.
TF32 is off where the products run, so the card's scores are f32
products; the counts are exact integers in f32. The affinity and the
top-k sort stay on the host, as in JAX.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from mmlspark_tpu_torch.core.dataframe import DataFrame, obj_col
from mmlspark_tpu_torch.core.environment import resolve_device
from mmlspark_tpu_torch.core.params import HasDevice, Param, in_range, in_set
from mmlspark_tpu_torch.core.stage import Estimator, Model
from mmlspark_tpu_torch.models.function import ieee_f32

SECONDS_PER_DAY = 86400.0


def _affinity_matrix(users: np.ndarray, items: np.ndarray,
                     ratings: np.ndarray,
                     timestamps: Optional[np.ndarray],
                     n_users: int, n_items: int,
                     time_decay: bool, half_life_days: float) -> np.ndarray:
    """Dense (n_users, n_items) affinity with exponential time decay.

    Parity: SAR.scala:36-80 — affinity = sum_e rating_e * 2^(-(t_ref - t_e)/T).
    """
    weights = ratings.astype(np.float32)
    if time_decay and timestamps is not None:
        t = timestamps.astype(np.float64)
        t_ref = float(t.max())
        age_days = (t_ref - t) / SECONDS_PER_DAY
        weights = weights * np.exp2(
            -age_days / float(half_life_days)).astype(np.float32)
    aff = np.zeros((n_users, n_items), dtype=np.float32)
    np.add.at(aff, (users, items), weights)
    return aff


def _f32(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    """An f32 host array on ``dev`` (a read-only array, as a loaded or
    bridged model holds, is copied first)."""
    a = np.ascontiguousarray(a, np.float32)
    if not a.flags.writeable:
        a = a.copy()
    return torch.from_numpy(a).to(dev)


def _build_similarity(aff: torch.Tensor, metric: str,
                      support_threshold: float) -> torch.Tensor:
    """B = binarize(aff); C = B^T B (one f32 product on ``aff``'s
    device); then the metric."""
    b = (aff > 0).to(torch.float32)
    with ieee_f32():
        cooc = b.T @ b
    return _similarity_from_cooccurrence(cooc, metric, support_threshold)


def _score_users(aff: torch.Tensor, sim: torch.Tensor,
                 remove_seen: bool) -> torch.Tensor:
    """scores = aff @ sim, with seen items masked out when asked."""
    with ieee_f32():
        s = aff @ sim
    if remove_seen:
        s = s.masked_fill(aff > 0, -torch.inf)
    return s


def _similarity_from_cooccurrence(cooc: torch.Tensor, metric: str,
                                  support_threshold: float) -> torch.Tensor:
    """Item-item similarity from a dense co-occurrence count matrix.

    Parity: SAR.scala:82-147 (jaccard / lift / plain counts, with
    ``supportThreshold`` zeroing under-supported pairs), in f32 with the
    threshold an f32 scalar, as JAX compares it.
    """
    diag = torch.diagonal(cooc)
    zero = torch.zeros((), dtype=cooc.dtype, device=cooc.device)
    if metric == "jaccard":
        denom = diag[:, None] + diag[None, :] - cooc
        sim = torch.where(denom > 0, cooc / denom, zero)
    elif metric == "lift":
        denom = diag[:, None] * diag[None, :]
        sim = torch.where(denom > 0, cooc / denom, zero)
    else:  # cooccurrence
        sim = cooc
    threshold = torch.tensor(np.float32(support_threshold),
                             device=cooc.device)
    return torch.where(cooc >= threshold, sim, zero)


class SAR(Estimator, HasDevice):
    """Fit a SAR model from (user, item, rating[, timestamp]) events."""

    user_col = Param("user_idx", "indexed user column (int)")
    item_col = Param("item_idx", "indexed item column (int)")
    rating_col = Param("rating", "rating/affinity weight column")
    timestamp_col = Param(None, "optional unix-seconds timestamp column")
    time_decay_enabled = Param(True, "apply exponential time decay")
    time_decay_half_life = Param(
        30.0, "half-life of event weight, days", in_range(lo=1e-6))
    similarity_function = Param(
        "jaccard", "item-item similarity metric",
        in_set("jaccard", "lift", "cooccurrence"))
    support_threshold = Param(
        4, "min co-occurrence count for a nonzero similarity",
        in_range(lo=0))
    num_users = Param(None, "total user count (default: max index + 1)")
    num_items = Param(None, "total item count (default: max index + 1)")

    def fit(self, df: DataFrame) -> "SARModel":
        dev = resolve_device(self.device)
        users = np.asarray(df[self.user_col], dtype=np.int64)
        items = np.asarray(df[self.item_col], dtype=np.int64)
        if self.rating_col and self.rating_col in df:
            ratings = np.asarray(df[self.rating_col], dtype=np.float32)
        else:
            ratings = np.ones(len(users), dtype=np.float32)
        ts = None
        if self.timestamp_col and self.timestamp_col in df:
            ts = np.asarray(df[self.timestamp_col], dtype=np.float64)

        n_users = int(self.num_users or users.max() + 1)
        n_items = int(self.num_items or items.max() + 1)

        aff = _affinity_matrix(users, items, ratings, ts, n_users, n_items,
                               self.time_decay_enabled,
                               self.time_decay_half_life)

        with torch.no_grad():
            sim = _build_similarity(
                _f32(aff, dev), self.similarity_function,
                self.support_threshold).cpu().numpy()
        return SARModel(user_col=self.user_col, item_col=self.item_col,
                        rating_col=self.rating_col, device=self.device,
                        affinity=aff, similarity=sim)


class SARModel(Model, HasDevice):
    """Fitted SAR: score = affinity @ similarity; top-k per user."""

    user_col = Param("user_idx", "indexed user column (int)")
    item_col = Param("item_idx", "indexed item column (int)")
    rating_col = Param("rating", "rating column name for output")
    affinity = Param(None, "(n_users, n_items) affinity", complex=True)
    similarity = Param(None, "(n_items, n_items) similarity", complex=True)
    remove_seen = Param(True, "exclude items the user already interacted with")

    def _scores(self, user_rows: np.ndarray,
                remove_seen: bool) -> np.ndarray:
        dev = resolve_device(self.device)
        with torch.no_grad():
            return _score_users(_f32(self.affinity[user_rows], dev),
                                _f32(self.similarity, dev),
                                remove_seen=remove_seen).cpu().numpy()

    def recommend_for_all_users(self, k: int) -> DataFrame:
        """Parity: SARModel.recommendForAllUsers (SARModel.scala:21).

        With ``remove_seen``, users with fewer than k unseen items get
        shorter (ragged) recommendation lists rather than -inf fillers.
        """
        n_users = self.affinity.shape[0]
        scores = self._scores(np.arange(n_users), self.remove_seen)
        top = np.argsort(-scores, axis=1)[:, :k].astype(np.int32)
        ratings = np.take_along_axis(scores, top, axis=1)
        recs, rats = [], []
        for t, r in zip(top, ratings.astype(np.float32)):
            valid = np.isfinite(r)
            recs.append(t[valid])
            rats.append(r[valid])
        return DataFrame({
            self.user_col: np.arange(n_users, dtype=np.int32),
            "recommendations": obj_col(recs),
            "ratings": obj_col(rats),
        })

    def transform(self, df: DataFrame) -> DataFrame:
        """Score each (user, item) row: predicted affinity."""
        users = np.asarray(df[self.user_col], dtype=np.int64)
        items = np.asarray(df[self.item_col], dtype=np.int64)
        uniq, inverse = np.unique(users, return_inverse=True)
        scores = self._scores(uniq, remove_seen=False)
        return df.with_column("prediction",
                              scores[inverse, items].astype(np.float32))

    def _save_extra(self, path, arrays):
        arrays["affinity"] = self.affinity
        arrays["similarity"] = self.similarity

    def _load_extra(self, path, arrays):
        self.affinity = arrays["affinity"]
        self.similarity = arrays["similarity"]
