"""Ranking evaluation + train/validation-split infrastructure (the
port's copy of ``mmlspark_tpu/recommend/ranking.py``).

Capability parity with `recommendation/src/main/scala/RankingEvaluator.scala:97,14`
(`AdvancedRankingMetrics`: ndcg@k, map, precision@k, recall@k, mrr, fcp),
`RankingAdapter.scala:66,104` (adapt a recommender so its output frame holds
per-user predicted and ground-truth item lists) and
`RankingTrainValidationSplit.scala:22,295` (per-user chronological/random
split + grid evaluation).
"""

from __future__ import annotations

import itertools
from typing import Dict, List, Sequence

import numpy as np

from mmlspark_tpu_torch.core.dataframe import DataFrame, obj_col
from mmlspark_tpu_torch.core.params import Param, in_range, in_set
from mmlspark_tpu_torch.core.stage import Estimator, Evaluator, Model


class AdvancedRankingMetrics:
    """Metrics over parallel lists of (predicted items, relevant items).

    Parity: RankingEvaluator.scala:14-95. Pure numpy — list lengths are
    ragged and tiny; nothing here is worth a device round-trip.
    """

    def __init__(self, predictions: Sequence[Sequence],
                 ground_truth: Sequence[Sequence], k: int):
        self.pred = [list(p) for p in predictions]
        self.truth = [set(t) for t in ground_truth]
        self.k = k

    def precision_at_k(self) -> float:
        vals = [len(set(p[:self.k]) & t) / self.k
                for p, t in zip(self.pred, self.truth)]
        return float(np.mean(vals)) if vals else 0.0

    def recall_at_k(self) -> float:
        vals = [len(set(p[:self.k]) & t) / max(len(t), 1)
                for p, t in zip(self.pred, self.truth)]
        return float(np.mean(vals)) if vals else 0.0

    def ndcg_at_k(self) -> float:
        vals = []
        for p, t in zip(self.pred, self.truth):
            dcg = sum(1.0 / np.log2(i + 2)
                      for i, item in enumerate(p[:self.k]) if item in t)
            ideal = sum(1.0 / np.log2(i + 2)
                        for i in range(min(len(t), self.k)))
            vals.append(dcg / ideal if ideal > 0 else 0.0)
        return float(np.mean(vals)) if vals else 0.0

    def map_metric(self) -> float:
        vals = []
        for p, t in zip(self.pred, self.truth):
            hits, acc = 0, 0.0
            for i, item in enumerate(p):
                if item in t:
                    hits += 1
                    acc += hits / (i + 1.0)
            vals.append(acc / max(len(t), 1))
        return float(np.mean(vals)) if vals else 0.0

    def map_at_k(self) -> float:
        vals = []
        for p, t in zip(self.pred, self.truth):
            hits, acc = 0, 0.0
            for i, item in enumerate(p[:self.k]):
                if item in t:
                    hits += 1
                    acc += hits / (i + 1.0)
            vals.append(acc / max(min(len(t), self.k), 1))
        return float(np.mean(vals)) if vals else 0.0

    def mrr(self) -> float:
        vals = []
        for p, t in zip(self.pred, self.truth):
            rank = next((i + 1 for i, item in enumerate(p) if item in t), None)
            vals.append(1.0 / rank if rank else 0.0)
        return float(np.mean(vals)) if vals else 0.0

    def recommended_fraction(self) -> float:
        """Fraction of users with at least one relevant recommendation."""
        vals = [1.0 if set(p[:self.k]) & t else 0.0
                for p, t in zip(self.pred, self.truth)]
        return float(np.mean(vals)) if vals else 0.0

    def fcp(self) -> float:
        """Fraction of concordant pairs: among (relevant, irrelevant) item
        pairs in a user's predicted list, how often the relevant one is
        ranked first, averaged over users with at least one such pair."""
        vals = []
        for p, t in zip(self.pred, self.truth):
            rel = [i for i, item in enumerate(p) if item in t]
            irr = [i for i, item in enumerate(p) if item not in t]
            if not rel or not irr:
                continue
            concordant = sum(1 for r in rel for s in irr if r < s)
            vals.append(concordant / (len(rel) * len(irr)))
        return float(np.mean(vals)) if vals else 0.0

    def diversity_at_k(self) -> float:
        """Distinct items recommended in top-k across users / distinct
        items relevant anywhere (coverage of the catalog actually used)."""
        recommended = {item for p in self.pred for item in p[:self.k]}
        universe = {item for t in self.truth for item in t} | recommended
        return len(recommended) / max(len(universe), 1)

    def get(self, name: str) -> float:
        table = {
            "precisionAtk": self.precision_at_k,
            "recallAtK": self.recall_at_k,
            "ndcgAt": self.ndcg_at_k,
            "map": self.map_metric,
            "mapk": self.map_at_k,
            "mrr": self.mrr,
            "fcp": self.fcp,
            "recommendedAtK": self.recommended_fraction,
            "diversityAtK": self.diversity_at_k,
        }
        return table[name]()

    def all_metrics(self) -> Dict[str, float]:
        return {n: self.get(n)
                for n in ("map", "ndcgAt", "precisionAtk", "recallAtK",
                          "mrr", "mapk", "fcp", "recommendedAtK",
                          "diversityAtK")}


class RankingEvaluator(Evaluator):
    """Evaluate a frame of per-user prediction/label item lists.

    Parity: RankingEvaluator.scala:97 (metricName param, k param).
    """

    k = Param(10, "cutoff for @k metrics", in_range(lo=1))
    metric_name = Param("ndcgAt", "which metric",
                        in_set("ndcgAt", "map", "mapk", "precisionAtk",
                               "recallAtK", "mrr", "fcp", "recommendedAtK",
                               "diversityAtK"))
    prediction_col = Param("recommendations", "predicted item-list column")
    label_col = Param("labels", "ground-truth item-list column")

    def _metrics(self, df: DataFrame) -> AdvancedRankingMetrics:
        return AdvancedRankingMetrics(
            [list(np.ravel(p)) for p in df[self.prediction_col]],
            [list(np.ravel(t)) for t in df[self.label_col]], self.k)

    def evaluate(self, df: DataFrame) -> float:
        return self._metrics(df).get(self.metric_name)

    def evaluate_all(self, df: DataFrame) -> DataFrame:
        m = self._metrics(df).all_metrics()
        return DataFrame({k: [v] for k, v in m.items()})


class RankingAdapter(Estimator):
    """Wrap a recommender Estimator so evaluation frames come out directly.

    Parity: RankingAdapter.scala:66 — fit the inner recommender, then
    ``transform(test)`` emits one row per user with top-k predictions and
    that user's ground-truth items.
    """

    recommender = Param(None, "inner recommender estimator", complex=True)
    k = Param(10, "how many items to recommend", in_range(lo=1))
    user_col = Param("user_idx", "indexed user column")
    item_col = Param("item_idx", "indexed item column")
    rating_col = Param("rating", "rating column")

    def fit(self, df: DataFrame) -> "RankingAdapterModel":
        model = self.recommender.fit(df)
        return RankingAdapterModel(
            recommender_model=model, k=self.k, user_col=self.user_col,
            item_col=self.item_col, rating_col=self.rating_col)


class RankingAdapterModel(Model):
    recommender_model = Param(None, "fitted recommender", complex=True)
    k = Param(10, "how many items to recommend")
    user_col = Param("user_idx", "indexed user column")
    item_col = Param("item_idx", "indexed item column")
    rating_col = Param("rating", "rating column")

    def transform(self, df: DataFrame) -> DataFrame:
        recs = self.recommender_model.recommend_for_all_users(self.k)
        rec_map = {int(u): list(np.ravel(r)) for u, r in
                   zip(recs[self.user_col], recs["recommendations"])}
        users = np.asarray(df[self.user_col], dtype=np.int64)
        items = np.asarray(df[self.item_col], dtype=np.int64)
        truth: Dict[int, List[int]] = {}
        for u, i in zip(users, items):
            truth.setdefault(int(u), []).append(int(i))
        uids = sorted(truth)
        return DataFrame({
            self.user_col: np.asarray(uids, dtype=np.int32),
            "recommendations": obj_col(
                [rec_map.get(u, []) for u in uids]),
            "labels": obj_col([truth[u] for u in uids]),
        })

    def _save_extra(self, path, arrays):
        import os
        self.recommender_model.save(os.path.join(path, "inner"))

    def _load_extra(self, path, arrays):
        import os
        from mmlspark_tpu_torch.core.stage import PipelineStage
        self.recommender_model = PipelineStage.load(
            os.path.join(path, "inner"))


def per_user_split(df: DataFrame, user_col: str, train_ratio: float,
                   seed: int = 0, min_ratings: int = 1):
    """Split events per user so every user appears in both halves.

    Parity: RankingTrainValidationSplit.scala's stratified split (:295).
    """
    rng = np.random.default_rng(seed)
    users = np.asarray(df[user_col], dtype=np.int64)
    train_mask = np.zeros(len(users), dtype=bool)
    for u in np.unique(users):
        idx = np.flatnonzero(users == u)
        rng.shuffle(idx)
        n_train = max(int(round(len(idx) * train_ratio)), min_ratings)
        n_train = min(n_train, max(len(idx) - 1, 1))
        train_mask[idx[:n_train]] = True
    return df.filter(train_mask), df.filter(~train_mask)


class RankingTrainValidationSplit(Estimator):
    """Grid-search a recommender by ranking metric on a per-user split.

    Parity: RankingTrainValidationSplit.scala:22 (estimator + paramMaps +
    evaluator + trainRatio).
    """

    estimator = Param(None, "recommender estimator", complex=True)
    evaluator = Param(None, "RankingEvaluator", complex=True)
    param_maps = Param(None, "list of {param: value} dicts to try",
                       complex=True)
    train_ratio = Param(0.75, "per-user train fraction",
                        in_range(lo=0.0, hi=1.0))
    user_col = Param("user_idx", "indexed user column")
    item_col = Param("item_idx", "indexed item column")
    seed = Param(0, "split seed")

    def fit(self, df: DataFrame) -> "RankingTrainValidationSplitModel":
        evaluator = self.evaluator or RankingEvaluator()
        train, valid = per_user_split(df, self.user_col, self.train_ratio,
                                      seed=self.seed)
        param_maps = self.param_maps or [{}]
        results = []
        for pm in param_maps:
            est = self.estimator.copy().set(**pm)
            adapter = RankingAdapter(
                recommender=est, k=evaluator.k, user_col=self.user_col,
                item_col=self.item_col)
            model = adapter.fit(train)
            metric = evaluator.evaluate(model.transform(valid))
            results.append((metric, pm, model))
        best = max(results, key=lambda r: r[0])
        return RankingTrainValidationSplitModel(
            best_model=best[2], best_params=best[1],
            validation_metrics=[r[0] for r in results])


class RankingTrainValidationSplitModel(Model):
    best_model = Param(None, "best fitted RankingAdapterModel", complex=True)
    best_params = Param(None, "winning param map", complex=True)
    validation_metrics = Param(None, "metric per param map", complex=True)

    def transform(self, df: DataFrame) -> DataFrame:
        return self.best_model.transform(df)

    def recommend_for_all_users(self, k: int) -> DataFrame:
        return self.best_model.recommender_model.recommend_for_all_users(k)

    def _save_extra(self, path, arrays):
        import json
        import os
        self.best_model.save(os.path.join(path, "inner"))
        arrays["validation_metrics"] = np.asarray(
            self.validation_metrics or [], dtype=np.float64)
        from mmlspark_tpu_torch.core.serialize import _json_default
        with open(os.path.join(path, "best_params.json"), "w") as f:
            json.dump(self.best_params or {}, f, default=_json_default)

    def _load_extra(self, path, arrays):
        import json
        import os
        from mmlspark_tpu_torch.core.stage import PipelineStage
        self.best_model = PipelineStage.load(os.path.join(path, "inner"))
        self.validation_metrics = list(arrays["validation_metrics"])
        params_file = os.path.join(path, "best_params.json")
        if os.path.exists(params_file):  # absent in pre-fix checkpoints
            with open(params_file) as f:
                self.best_params = json.load(f)
