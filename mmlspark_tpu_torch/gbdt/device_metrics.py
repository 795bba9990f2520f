"""On-device validation metrics for the fused GBDT boosting loop.

The port of ``mmlspark_tpu/gbdt/device_metrics.py``: the fused fit
(:func:`.tree.boost_loop_device`) carries the validation rows' raw
scores and evaluates the metric as a device scalar each iteration, so an
early-stopping fit still reads the device once, at its end. The host's
:func:`.booster.eval_metric` stays the source of truth for the metric
definitions; these mirror it in f32 tensors.

AUC uses tie-averaged ranks: sort (stably), group equal predictions via
a cumsum of group starts, take each group's min and max rank with
order-free ``scatter_reduce`` (amin/amax), and average.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional, Tuple

import torch

from mmlspark_tpu_torch.gbdt.objectives import Objective

_EPS = 1e-15


def _tie_rank_auc(pred, y):
    m = pred.shape[0]
    dev = pred.device
    order = torch.argsort(pred, stable=True)
    sp, sy = pred[order], y[order]
    starts = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                        sp[1:] != sp[:-1]])
    gid = torch.cumsum(starts.to(torch.int64), dim=0) - 1  # tie group per row
    r = torch.arange(1, m + 1, dtype=torch.float32, device=dev)
    gmin = torch.full((m,), float("inf"), device=dev).scatter_reduce_(
        0, gid, r, "amin", include_self=True)
    gmax = torch.full((m,), -float("inf"), device=dev).scatter_reduce_(
        0, gid, r, "amax", include_self=True)
    avg_rank = (gmin[gid] + gmax[gid]) / 2.0
    pos = (sy == 1).to(torch.float32)
    n_pos, n_neg = torch.sum(pos), torch.sum((sy == 0).to(torch.float32))
    auc = (torch.sum(avg_rank * pos) - n_pos * (n_pos + 1) / 2.0) \
        / torch.clamp(n_pos * n_neg, min=1e-12)
    return torch.where((n_pos == 0) | (n_neg == 0), 0.5, auc)


_SUPPORTED = ("auc", "binary_logloss", "binary_error", "multi_logloss",
              "multi_error", "rmse", "l2", "l1", "mae", "quantile",
              "poisson", "tweedie")


def get_device_metric(name: str, obj: Objective, alpha: float,
                      tweedie_p: float
                      ) -> Optional[Tuple[Callable, bool]]:
    """``(metric_fn, higher_is_better)`` or None if the metric has no
    device implementation (the caller takes the per-iteration loop).

    ``metric_fn(vraw, vy) -> f32 scalar`` where ``vraw`` is the
    validation rows' raw scores ``(m, K)`` and ``vy`` their labels
    ``(m,)``. Cached as in the reference (the key drops ``alpha`` and
    ``tweedie_p`` for the metrics that ignore them).
    """
    if name not in _SUPPORTED:
        return None
    if name != "quantile":
        alpha = 0.0
    if name != "tweedie":
        tweedie_p = 0.0
    return _cached_metric(name, obj, alpha, tweedie_p)


@functools.lru_cache(maxsize=None)
def _cached_metric(name: str, obj: Objective, alpha: float,
                   tweedie_p: float) -> Tuple[Callable, bool]:

    def fn(vraw, vy):
        pred = obj.transform(vraw)                     # user-facing (m, K)
        p1 = pred[:, 0]
        if name == "auc":
            return _tie_rank_auc(p1, vy)
        if name == "binary_logloss":
            p = torch.clamp(p1, _EPS, 1 - _EPS)
            return -torch.mean(vy * torch.log(p) + (1 - vy) * torch.log(1 - p))
        if name == "binary_error":
            return torch.mean(((p1 > 0.5) != (vy > 0.5)).to(torch.float32))
        if name == "multi_logloss":
            p = pred[torch.arange(pred.shape[0], device=pred.device),
                     vy.to(torch.int64)]
            return -torch.mean(torch.log(torch.clamp(p, _EPS, 1.0)))
        if name == "multi_error":
            return torch.mean((torch.argmax(pred, dim=1)
                               != vy.to(torch.int64)).to(torch.float32))
        if name in ("rmse", "l2"):
            mse = torch.mean(torch.square(p1 - vy))
            return torch.sqrt(mse) if name == "rmse" else mse
        if name in ("l1", "mae"):
            return torch.mean(torch.abs(p1 - vy))
        if name == "quantile":
            d = vy - p1
            return torch.mean(torch.where(d >= 0, alpha * d, (alpha - 1) * d))
        if name == "poisson":
            mu = torch.clamp(p1, min=_EPS)
            return torch.mean(mu - vy * torch.log(mu))
        if name == "tweedie":
            mu = torch.clamp(p1, min=_EPS)
            return torch.mean(-vy * torch.pow(mu, 1 - tweedie_p)
                              / (1 - tweedie_p)
                              + torch.pow(mu, 2 - tweedie_p) / (2 - tweedie_p))
        raise AssertionError(name)

    return fn, (name == "auc")
