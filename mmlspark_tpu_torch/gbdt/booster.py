"""Booster: the boosting loop over TreeGrower, on one device.

The port of ``mmlspark_tpu/gbdt/booster.py`` for one card: gbdt, rf,
dart and goss boosting, the binary/multiclass/regression/quantile/
tweedie/poisson/l1 objectives, bagging and feature fraction, early
stopping against a validation set, model-string save/load in the
reference's format (``"mmlspark_tpu.gbdt.v1"``: a model written by
either package loads in the other), LightGBM text import and export,
split/gain feature importances, batched prediction and booster merging.

:meth:`Booster.train` runs on ``device`` — ``None`` means the card and
raises without CUDA, ``"cpu"`` runs the plain versions — and the booster
keeps that device for :meth:`Booster.predict`. Eligible fits (gbdt or
goss, no per-iteration logging, early stopping only with a device
metric) run :func:`.tree.boost_loop_device` and read the device once, at
the end; the others take the per-iteration loop, whose sampling draws
from ``np.random.default_rng(seed)`` exactly as the reference's does.
``sharding`` (the data-parallel fit) waits for the multi-GPU slice and
raises.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from mmlspark_tpu_torch.core.environment import DeviceLike, resolve_device
from mmlspark_tpu_torch.gbdt import device_metrics
from mmlspark_tpu_torch.gbdt import tree as tree_mod
from mmlspark_tpu_torch.gbdt.binning import BinMapper
from mmlspark_tpu_torch.gbdt.cuda_hist import prepare_bins_t
from mmlspark_tpu_torch.gbdt.objectives import Objective, get_objective, \
    sigmoid
from mmlspark_tpu_torch.gbdt.tree import (
    GrowthParams, Tree, TreeGrower, predict_tree_raw,
)

HISTOGRAM_IMPLS = ("auto", "xla", "pallas", "pallas_interpret")


@dataclasses.dataclass(frozen=True)
class BoosterParams:
    """The reference's parameters, field for field, so that its model
    strings load (LightGBMParams, `LightGBMParams.scala:13`)."""

    objective: str = "regression"
    boosting_type: str = "gbdt"          # gbdt | rf | dart | goss
    num_iterations: int = 100
    learning_rate: float = 0.1
    num_leaves: int = 31
    max_depth: int = -1
    max_bin: int = 255
    min_data_in_leaf: int = 20
    min_sum_hessian_in_leaf: float = 1e-3
    lambda_l1: float = 0.0
    lambda_l2: float = 0.0
    min_gain_to_split: float = 0.0
    bagging_fraction: float = 1.0
    bagging_freq: int = 0
    feature_fraction: float = 1.0
    num_class: int = 2
    alpha: float = 0.9                   # quantile level
    tweedie_variance_power: float = 1.5
    # dart
    drop_rate: float = 0.1
    max_drop: int = 50
    skip_drop: float = 0.5
    # goss
    top_rate: float = 0.2
    other_rate: float = 0.1
    # early stopping
    early_stopping_round: int = 0
    metric: str = ""                     # default chosen from objective
    seed: int = 0
    # the reference's choice between two engines of one function; here
    # every value runs K9 on the card and its plain version on the CPU
    histogram_impl: str = "auto"         # auto | xla | pallas | pallas_interpret
    # distributed tree learner: data | feature | voting (the latter two
    # with the multi-GPU slice)
    tree_learner: str = "data"
    top_k: int = 20                      # voting-parallel candidates/worker

    def growth(self) -> GrowthParams:
        return GrowthParams(
            num_leaves=self.num_leaves, max_depth=self.max_depth,
            min_data_in_leaf=self.min_data_in_leaf,
            min_sum_hessian_in_leaf=self.min_sum_hessian_in_leaf,
            lambda_l1=self.lambda_l1, lambda_l2=self.lambda_l2,
            min_gain_to_split=self.min_gain_to_split)


DEFAULT_METRICS = {"binary": "auc", "multiclass": "multi_logloss",
                   "regression": "rmse", "regression_l1": "l1",
                   "quantile": "quantile", "poisson": "poisson",
                   "tweedie": "tweedie"}


def eval_metric(name: str, y: np.ndarray, pred: np.ndarray,
                obj: Objective, alpha: float = 0.9,
                tweedie_p: float = 1.5) -> Tuple[float, bool]:
    """Returns (value, higher_is_better). ``pred`` is user-facing."""
    y = np.asarray(y, dtype=np.float64)
    pred = np.asarray(pred, dtype=np.float64)
    eps = 1e-15
    if name == "auc":
        # tie-averaged ranks (rank-sum AUC), pure numpy
        uniq, inv, counts = np.unique(pred, return_inverse=True,
                                      return_counts=True)
        cum = np.cumsum(counts)
        avg_rank = (cum - counts + 1 + cum) / 2.0
        ranks = avg_rank[inv]
        n_pos = float(np.sum(y == 1))
        n_neg = float(np.sum(y == 0))
        if n_pos == 0 or n_neg == 0:
            return 0.5, True
        auc = (np.sum(ranks[y == 1]) - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg)
        return float(auc), True
    if name == "binary_logloss":
        p = np.clip(pred, eps, 1 - eps)
        return float(-np.mean(y * np.log(p) + (1 - y) * np.log(1 - p))), False
    if name == "binary_error":
        return float(np.mean((pred > 0.5) != (y > 0.5))), False
    if name == "multi_logloss":
        p = np.clip(pred[np.arange(len(y)), y.astype(int)], eps, 1)
        return float(-np.mean(np.log(p))), False
    if name == "multi_error":
        return float(np.mean(np.argmax(pred, axis=1) != y)), False
    if name in ("rmse", "l2"):
        mse = float(np.mean((pred - y) ** 2))
        return (np.sqrt(mse) if name == "rmse" else mse), False
    if name in ("l1", "mae"):
        return float(np.mean(np.abs(pred - y))), False
    if name == "quantile":
        d = y - pred
        return float(np.mean(np.where(d >= 0, alpha * d, (alpha - 1) * d))), False
    if name == "poisson":
        mu = np.maximum(pred, eps)
        return float(np.mean(mu - y * np.log(mu))), False
    if name == "tweedie":
        p_ = tweedie_p
        mu = np.maximum(pred, eps)
        dev = -y * np.power(mu, 1 - p_) / (1 - p_) + np.power(mu, 2 - p_) / (2 - p_)
        return float(np.mean(dev)), False
    raise ValueError(f"unknown metric {name!r}")


class Booster:
    """A trained (or training) additive tree model on one device."""

    def __init__(self, params: BoosterParams, mapper: BinMapper,
                 obj: Objective, feature_names: Sequence[str],
                 device: DeviceLike = None):
        self.params = params
        self.mapper = mapper
        self.obj = obj
        self.feature_names = list(feature_names)
        self.device = resolve_device(device)
        self.trees: List[List[Tree]] = []  # [iteration][output]
        self.init_score: np.ndarray = np.zeros(1)
        self.best_iteration: int = -1

    # -- training -----------------------------------------------------------

    @staticmethod
    def train(params: BoosterParams, X: np.ndarray, y: np.ndarray,
              weights: Optional[np.ndarray] = None,
              categorical_features: Sequence[int] = (),
              feature_names: Optional[Sequence[str]] = None,
              valid_sets: Sequence[Tuple[np.ndarray, np.ndarray]] = (),
              init_model: Optional["Booster"] = None,
              sharding=None,
              log_every: int = 0,
              device: DeviceLike = None) -> "Booster":
        """Fit a booster on ``device`` (``None``: the card). A continuation
        (``init_model``) runs on the device ``device`` names, and the
        booster moves there."""
        if sharding is not None:
            raise NotImplementedError(
                "sharded fits wait for the port's multi-GPU slice (ROADMAP "
                "queue 1 item 9); pass sharding=None")
        dev = resolve_device(device)
        X = np.asarray(X, dtype=np.float64)
        y = np.asarray(y)
        n, F = X.shape
        obj = get_objective(params.objective, params.num_class,
                            params.alpha, params.tweedie_variance_power)
        K = obj.num_model_outputs

        if init_model is not None:
            mapper = init_model.mapper
            booster = init_model
            booster._set_device(dev)
        else:
            mapper = BinMapper(max_bin=params.max_bin).fit(
                X, categorical_features)
            booster = Booster(params, mapper, obj,
                              feature_names or [f"f{j}" for j in range(F)],
                              device=dev)
            booster.init_score = np.atleast_1d(
                np.asarray(obj.init_score(y, _weights(weights, n)),
                           dtype=np.float64))

        bins_np = mapper.transform(X)
        n_bins = mapper.max_bins_total
        w_np = _weights(weights, n).astype(np.float32)
        y_np = np.asarray(y, dtype=np.float32)
        valid_rows = np.ones(n, dtype=bool)
        if params.tree_learner not in ("data", "feature", "voting"):
            raise ValueError(f"unknown tree_learner {params.tree_learner!r}")
        if params.histogram_impl not in HISTOGRAM_IMPLS:
            raise ValueError(
                f"unknown histogram_impl {params.histogram_impl!r}")

        def put(a):
            return torch.as_tensor(a).to(dev)

        bins_t = put(prepare_bins_t(torch.from_numpy(bins_np), n_bins))
        w, y_dev = put(w_np), put(y_np)
        grower = TreeGrower(mapper, params.growth(), F, n_bins, device=dev)
        rng = np.random.default_rng(params.seed)

        # raw predictions (n, K) on the device
        raw_np = np.broadcast_to(
            np.asarray(booster.init_score, dtype=np.float32)[None, :],
            (n, K)).copy()
        if init_model is not None and booster.trees:
            prior = (booster._predict_raw_np(X)
                     - booster.init_score[None, :]).astype(np.float32)
            raw_np += prior
        raw = put(raw_np)

        # continuation must re-decide the best iteration over the new run
        booster.best_iteration = -1

        is_rf = params.boosting_type == "rf"
        is_dart = params.boosting_type == "dart"
        is_goss = params.boosting_type == "goss"
        shrink = 1.0 if is_rf else params.learning_rate

        metric_name = params.metric or DEFAULT_METRICS.get(obj.name, "l2")
        best_metric, best_iter, rounds_no_improve = None, -1, 0
        tree_raw_contribs: List[torch.Tensor] = []  # dart: per-tree raw
        valid_eval: Optional[_ValidEval] = None

        start_iter = len(booster.trees)

        # -- the fused fit: the whole boosting loop without a host read
        # until its end, when nothing in the loop needs the host (gbdt or
        # goss, no logging, early stopping only with a device metric)
        es_active = bool(valid_sets) and params.early_stopping_round > 0
        device_metric = None
        if es_active and not log_every and len(valid_sets) == 1 \
                and len(valid_sets[0][0]) > 0:
            device_metric = device_metrics.get_device_metric(
                metric_name, obj, params.alpha,
                params.tweedie_variance_power)
        fused = (params.boosting_type in ("gbdt", "goss") and K <= 16
                 and (not es_active or device_metric is not None)
                 and not log_every)
        if fused:
            n_valid = 0
            bins_fit, y_fit, w_fit, mask_fit, raw_fit = \
                bins_t, y_dev, w, put(valid_rows), raw
            if device_metric is not None:
                # validation rows become the tail of the row set: masked
                # out of histograms/sampling/renewal, routed and scored
                vX = np.asarray(valid_sets[0][0], dtype=np.float64)
                vy_np = np.asarray(valid_sets[0][1], dtype=np.float32)
                n_valid = len(vX)
                vbins = mapper.transform(vX)
                bins_fit = put(prepare_bins_t(torch.from_numpy(
                    np.concatenate([bins_np, vbins])), n_bins))
                y_fit = put(np.concatenate([y_np, vy_np]))
                w_fit = put(np.concatenate(
                    [w_np, np.ones(n_valid, np.float32)]))
                mask_fit = put(np.concatenate(
                    [valid_rows, np.zeros(n_valid, bool)]))
                raw_v = np.broadcast_to(
                    np.asarray(booster.init_score, np.float32)[None, :],
                    (n_valid, K)).copy()
                if init_model is not None and booster.trees:
                    raw_v += (booster._predict_raw_np(vX)
                              - booster.init_score[None, :]
                              ).astype(np.float32)
                raw_fit = put(np.concatenate([raw_np, raw_v])
                              .astype(np.float32))
            gen = torch.Generator(device=dev).manual_seed(params.seed)
            _, stacked = tree_mod.boost_loop_device(
                bins_fit, y_fit, w_fit, mask_fit, raw_fit, obj.grad_hess,
                params.num_iterations, K, params.growth(),
                grower.is_categorical, None, grower.n_features,
                grower.n_bins, shrink, obj.renew_quantile, n_valid=n_valid,
                metric_fn=device_metric[0] if device_metric else None,
                generator=gen,
                bagging_fraction=params.bagging_fraction,
                bagging_freq=params.bagging_freq,
                goss=is_goss, top_rate=params.top_rate,
                other_rate=params.other_rate,
                feature_fraction=params.feature_fraction,
                n_real=n, it_offset=start_iter)
            host = tree_mod.to_host(stacked)  # ONE read for the whole fit
            kept = params.num_iterations
            if device_metric is not None:
                # replay the per-iteration loop's stopping rule over the
                # fetched metric series (same comparisons, same messages)
                _, higher = device_metric
                for it in range(params.num_iterations):
                    val = float(host["metric"][it])
                    improved = (best_metric is None or
                                (val > best_metric if higher
                                 else val < best_metric))
                    if improved:
                        best_metric, best_iter, rounds_no_improve = \
                            val, it, 0
                    else:
                        rounds_no_improve += 1
                    if rounds_no_improve >= params.early_stopping_round:
                        kept = it + 1
                        booster.best_iteration = best_iter
                        print(f"[gbdt] early stop at iter {it + 1}; "
                              f"best iter {best_iter + 1} "
                              f"{metric_name}={best_metric:.6f}")
                        break
            for it in range(kept):
                booster.trees.append([tree_mod.tree_from_arrays(
                    mapper, host["feature"][it][k],
                    host["threshold_bin"][it][k],
                    host["missing_left"][it][k], host["categorical"][it][k],
                    host["cat_mask"][it][k], host["left"][it][k],
                    host["right"][it][k], host["value"][it][k],
                    host["gain"][it][k], int(host["n_nodes"][it][k]))
                    for k in range(K)])
            if booster.best_iteration < 0:
                booster.best_iteration = len(booster.trees) - 1
            booster._invalidate()
            return booster

        bag_mask_host = None   # persisted bag between bagging redraws
        for it in range(start_iter, start_iter + params.num_iterations):
            # -- dart: drop trees for this round's gradient computation
            # (drop indices are relative to THIS run's trees,
            # tree_raw_contribs[d] <-> booster.trees[start_iter + d])
            dropped: List[int] = []
            if is_dart and tree_raw_contribs and rng.random() >= params.skip_drop:
                k_drop = min(max(1, int(params.drop_rate * len(tree_raw_contribs))),
                             params.max_drop)
                dropped = list(rng.choice(len(tree_raw_contribs),
                                          size=k_drop, replace=False))
            raw_for_grad = raw
            if dropped:
                raw_for_grad = raw - sum(tree_raw_contribs[d] for d in dropped)

            if is_rf:
                base = put(np.broadcast_to(
                    np.asarray(booster.init_score, np.float32)[None, :],
                    (n, K)).copy())
                grad, hess = obj.grad_hess(_squeeze(base, K), y_dev, w)
            else:
                grad, hess = obj.grad_hess(_squeeze(raw_for_grad, K), y_dev, w)
            grad = _unsqueeze(grad, K)
            hess = _unsqueeze(hess, K)

            # -- row sampling: bagging / goss (numpy stream, as the
            # reference's per-iteration loop draws it)
            sample = valid_rows.copy()
            goss_amp = None
            if is_goss and it >= 1:
                g_abs = np.abs(torch.sum(torch.abs(grad), dim=1).cpu().numpy())
                n_top = int(params.top_rate * n)
                n_other = int(params.other_rate * n)
                top_idx = np.argpartition(-g_abs, max(n_top - 1, 0))[:n_top]
                rest = np.setdiff1d(np.flatnonzero(valid_rows), top_idx,
                                    assume_unique=False)
                other_idx = rng.choice(rest, size=min(n_other, len(rest)),
                                       replace=False)
                sample = np.zeros(n, dtype=bool)
                sample[top_idx] = True
                sample[other_idx] = True
                goss_amp = np.ones(n, dtype=np.float32)
                goss_amp[other_idx] = (1.0 - params.top_rate) / max(
                    params.other_rate, 1e-12)
            elif params.bagging_fraction < 1.0 and (
                    is_rf or params.bagging_freq > 0):
                # redraw every bagging_freq iterations (rf: every
                # iteration); the bag persists between redraws
                if (is_rf or it % params.bagging_freq == 0
                        or bag_mask_host is None):
                    bag_mask_host = valid_rows & (
                        rng.random(n) < params.bagging_fraction)
                sample = bag_mask_host

            # -- feature sampling: exactly int(frac * F) columns without
            # replacement per iteration
            feat_mask = None
            if params.feature_fraction < 1.0:
                k_keep = max(int(params.feature_fraction * F), 1)
                keep = np.zeros(F, dtype=bool)
                keep[rng.permutation(F)[:k_keep]] = True
                feat_mask = put(keep)

            sample_dev = put(sample)
            amp_dev = put(goss_amp) if goss_amp is not None else None

            iter_trees: List[Tree] = []
            new_contrib = torch.zeros(n, K, dtype=torch.float32, device=dev)
            for k in range(K):
                gk, hk = grad[:, k].contiguous(), hess[:, k].contiguous()
                if amp_dev is not None:
                    gk, hk = gk * amp_dev, hk * amp_dev
                renew = None
                if obj.renew_quantile is not None:
                    # residuals against the scores the gradients used (RF
                    # trees fit y - init, not the ensemble)
                    scores = base if is_rf else raw_for_grad
                    renew = {"q": obj.renew_quantile,
                             "residual": y_dev - _squeeze(scores, K),
                             "weights": w}
                tree, row_vals, _ = grower.grow(
                    bins_t, gk, hk, sample_dev, shrink, feat_mask=feat_mask,
                    renew=renew)
                iter_trees.append(tree)
                new_contrib[:, k] += row_vals

            # -- dart normalization
            if dropped:
                factor = len(dropped) / (len(dropped) + params.learning_rate)
                new_contrib = new_contrib * (params.learning_rate /
                                             (len(dropped) + params.learning_rate))
                for k in range(K):
                    iter_trees[k].value *= (params.learning_rate /
                                            (len(dropped) + params.learning_rate))
                for d in dropped:
                    tree_raw_contribs[d] = tree_raw_contribs[d] * factor
                    for t in booster.trees[start_iter + d]:
                        t.value *= factor
                raw = raw_for_grad + new_contrib + sum(
                    tree_raw_contribs[d] for d in dropped)
            else:
                raw = raw + new_contrib

            booster.trees.append(iter_trees)
            booster._invalidate()                    # tree set changed
            if is_dart:
                tree_raw_contribs.append(new_contrib)

            # -- eval + early stopping
            if valid_sets and (params.early_stopping_round > 0 or log_every):
                if valid_eval is None:
                    valid_eval = _ValidEval(booster, valid_sets[0][0])
                vy = valid_sets[0][1]
                vpred = valid_eval.predict()
                val, higher = eval_metric(metric_name, vy, vpred, obj,
                                          params.alpha,
                                          params.tweedie_variance_power)
                improved = (best_metric is None or
                            (val > best_metric if higher else val < best_metric))
                if improved:
                    best_metric, best_iter, rounds_no_improve = val, it, 0
                else:
                    rounds_no_improve += 1
                if log_every and (it + 1) % log_every == 0:
                    print(f"[gbdt] iter {it + 1} valid {metric_name}={val:.6f}")
                if (params.early_stopping_round > 0 and
                        rounds_no_improve >= params.early_stopping_round):
                    booster.best_iteration = best_iter
                    print(f"[gbdt] early stop at iter {it + 1}; "
                          f"best iter {best_iter + 1} "
                          f"{metric_name}={best_metric:.6f}")
                    break
            elif log_every and (it + 1) % log_every == 0:
                print(f"[gbdt] iter {it + 1}")

        if booster.best_iteration < 0:
            booster.best_iteration = len(booster.trees) - 1
        return booster

    def _invalidate(self) -> None:
        """Drop the caches of the tree set (its max depth and its
        device arrays) after the trees or their leaf values change."""
        self.__dict__.pop("_mdc", None)
        self.__dict__.pop("_tree_dev", None)

    def _set_device(self, device: torch.device) -> None:
        if device != self.device:
            self.device = device
            self._invalidate()

    # -- prediction ---------------------------------------------------------

    def _tree_to_arrays(self, t: Tree) -> Dict[str, Any]:
        """A tree's arrays on the booster's device: thresholds in f32, as
        the reference uploads them, and node ids as int64."""
        B = self.mapper.max_bins_total
        cm = t.cat_mask
        if cm.shape[1] < B:
            cm = np.pad(cm, ((0, 0), (0, B - cm.shape[1])))
        dev = self.device

        def put(a, dtype):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

        return {
            "feature": put(t.feature, torch.int64),
            "threshold": put(t.threshold.astype(np.float32), torch.float32),
            "missing_left": put(t.missing_left, torch.bool),
            "categorical": put(t.categorical, torch.bool),
            "cat_mask": put(cm, torch.bool),
            "left": put(t.left, torch.int64),
            "right": put(t.right, torch.int64),
            "value": put(t.value, torch.float32),
        }

    def _tree_arrays(self) -> List[List[Dict[str, Any]]]:
        """Device-resident tree constants, uploaded ONCE per tree set;
        dropped by :meth:`_invalidate`."""
        if not hasattr(self, "_tree_dev"):
            self._tree_dev = [[self._tree_to_arrays(t) for t in iteration]
                              for iteration in self.trees]
        return self._tree_dev

    def _cat_bins(self, X: np.ndarray) -> np.ndarray:
        """Bin-space values for categorical features (0 elsewhere)."""
        if not any(self.mapper.categorical):
            return np.zeros(X.shape, dtype=np.int64)
        bins = self.mapper.transform(np.asarray(X, dtype=np.float64))
        keep = np.asarray(self.mapper.categorical)
        return np.where(keep[None, :], bins, 0).astype(np.int64)

    def _inputs(self, X: np.ndarray):
        """X as f32 and its categorical bins, on the device."""
        X_dev = torch.as_tensor(np.asarray(X, dtype=np.float32),
                                device=self.device)
        return X_dev, torch.as_tensor(self._cat_bins(X), device=self.device)

    def predict_raw(self, X: np.ndarray,
                    num_iteration: Optional[int] = None) -> np.ndarray:
        X = np.asarray(X, dtype=np.float64)
        zf = getattr(self, "zero_missing_features", None)
        if zf:
            # imported LightGBM missing_type=Zero (zero_as_missing=true):
            # |x| <= 1e-35 is missing on these features and routes to the
            # node's default side
            X = X.copy()
            for j in zf:
                col = X[:, j]
                X[:, j] = np.where(np.abs(col) <= 1e-35, np.nan, col)
        n = X.shape[0]
        K = self.obj.num_model_outputs
        stop = (num_iteration if num_iteration is not None
                else self.best_iteration + 1) or len(self.trees)
        raw = np.broadcast_to(self.init_score[None, :], (n, K)).copy()
        if n == 0 or not self.trees:
            return raw
        X_dev, cat_bins = self._inputs(X)
        acc = torch.zeros(n, K, dtype=torch.float32, device=self.device)
        depth = self._max_depth_cache()
        for iteration in self._tree_arrays()[:stop]:
            for k, arrs in enumerate(iteration):
                acc[:, k] += predict_tree_raw(arrs, X_dev, cat_bins, depth)
        raw = raw + acc.cpu().numpy().astype(np.float64)
        if self.params.boosting_type == "rf":
            raw = (self.init_score[None, :]
                   + (raw - self.init_score[None, :]) / max(stop, 1))
        return raw

    def _max_depth_cache(self) -> int:
        if not hasattr(self, "_mdc"):
            self._mdc = max((t.max_depth() for it in self.trees for t in it),
                            default=0)
        return self._mdc

    def _predict_raw_np(self, X: np.ndarray) -> np.ndarray:
        return self.predict_raw(X, num_iteration=len(self.trees))

    def _transform(self, raw: np.ndarray) -> np.ndarray:
        """The objective's transform of f64 raw scores, taken in f32 on
        the booster's device (the reference transforms an f32 array)."""
        t = torch.as_tensor(raw, dtype=torch.float32, device=self.device)
        out = self.obj.transform(t).cpu().numpy()
        return out[:, 0] if self.obj.num_model_outputs == 1 else out

    def predict(self, X: np.ndarray,
                num_iteration: Optional[int] = None) -> np.ndarray:
        return self._transform(self.predict_raw(X, num_iteration))

    # -- introspection ------------------------------------------------------

    def feature_importances(self, importance_type: str = "split") -> np.ndarray:
        """Split counts or gains per feature (LGBM_BoosterFeatureImportance)."""
        imp = np.zeros(len(self.feature_names))
        for iteration in self.trees:
            for t in iteration:
                for i in range(t.n_nodes):
                    f = t.feature[i]
                    if f >= 0:
                        imp[f] += 1 if importance_type == "split" else \
                            float(t.gain[i])
        return imp

    @property
    def num_total_iterations(self) -> int:
        return len(self.trees)

    # -- persistence --------------------------------------------------------

    def model_to_string(self) -> str:
        d = {
            "format": "mmlspark_tpu.gbdt.v1",
            "params": dataclasses.asdict(self.params),
            "mapper": self.mapper.to_json(),
            "objective": self.obj.name,
            "num_class": self.params.num_class,
            "feature_names": self.feature_names,
            "init_score": self.init_score.tolist(),
            "best_iteration": self.best_iteration,
            "trees": [[t.to_json() for t in it] for it in self.trees],
        }
        # imported-LightGBM predict-time state survives the json round
        # trip too
        sigmoid_k = getattr(self, "lgbm_sigmoid", 1.0)
        if sigmoid_k != 1.0:
            d["lgbm_sigmoid"] = sigmoid_k
        zf = getattr(self, "zero_missing_features", None)
        if zf:
            d["zero_missing_features"] = sorted(int(j) for j in zf)
        return json.dumps(d)

    def to_lightgbm_string(self) -> str:
        """Export as LightGBM's text model format."""
        from mmlspark_tpu_torch.gbdt.lgbm_compat import to_lightgbm_text
        return to_lightgbm_text(self)

    @staticmethod
    def from_string(s: str, device: DeviceLike = None) -> "Booster":
        """Load a model string (this format, the reference's, or LightGBM
        text) onto ``device`` (``None``: the card)."""
        from mmlspark_tpu_torch.gbdt.lgbm_compat import (
            from_lightgbm_text, is_lightgbm_text)
        if is_lightgbm_text(s):
            return from_lightgbm_text(s, device=device)
        d = json.loads(s)
        params = BoosterParams(**d["params"])
        mapper = BinMapper.from_json(d["mapper"])
        obj = get_objective(params.objective, params.num_class,
                            params.alpha, params.tweedie_variance_power)
        b = Booster(params, mapper, obj, d["feature_names"], device=device)
        b.init_score = np.asarray(d["init_score"], dtype=np.float64)
        b.best_iteration = d["best_iteration"]
        b.trees = [[Tree.from_json(t) for t in it] for it in d["trees"]]
        sigmoid_k = float(d.get("lgbm_sigmoid", 1.0))
        if sigmoid_k != 1.0:
            b.obj = dataclasses.replace(
                b.obj, transform=lambda raw, k=sigmoid_k: sigmoid(k * raw))
            b.lgbm_sigmoid = sigmoid_k
        if d.get("zero_missing_features"):
            b.zero_missing_features = frozenset(
                int(j) for j in d["zero_missing_features"])
        return b

    def merge(self, other: "Booster") -> "Booster":
        """Append another booster's trees (parity: LGBM_BoosterMerge)."""
        self.trees.extend(other.trees)
        self.best_iteration = len(self.trees) - 1
        self._invalidate()
        return self


class _ValidEval:
    """Incremental validation scorer for the per-iteration loop: bins
    and uploads the validation set once and adds only the new
    iterations' raw scores each round. DART rescales trees it already
    scored, so DART re-scores in full."""

    def __init__(self, booster: "Booster", vx: np.ndarray):
        self.booster = booster
        self.vx = np.asarray(vx, dtype=np.float64)
        self.X_dev, self.cat_bins_dev = booster._inputs(self.vx)
        K = booster.obj.num_model_outputs
        self.acc = torch.zeros(len(self.vx), K, dtype=torch.float32,
                               device=booster.device)
        self.done = 0

    def predict(self) -> np.ndarray:
        b = self.booster
        if b.params.boosting_type == "dart":
            return b.predict(self.vx, num_iteration=len(b.trees))
        for iteration in b.trees[self.done:]:
            for k, t in enumerate(iteration):
                self.acc[:, k] += predict_tree_raw(
                    b._tree_to_arrays(t), self.X_dev, self.cat_bins_dev,
                    t.max_depth())
        self.done = len(b.trees)
        raw = self.acc.cpu().numpy().astype(np.float64) \
            + b.init_score[None, :]
        if b.params.boosting_type == "rf":
            raw = (b.init_score[None, :]
                   + (raw - b.init_score[None, :]) / max(self.done, 1))
        return b._transform(raw)


def _weights(w: Optional[np.ndarray], n: int) -> np.ndarray:
    return np.ones(n, dtype=np.float32) if w is None \
        else np.asarray(w, dtype=np.float32)


def _squeeze(raw, K: int):
    return raw[:, 0] if K == 1 else raw


def _unsqueeze(g, K: int):
    return g[:, None] if K == 1 else g
