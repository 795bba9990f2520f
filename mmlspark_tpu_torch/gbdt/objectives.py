"""GBDT objectives: gradients/hessians, init scores, prediction transforms.

The port of ``mmlspark_tpu/gbdt/objectives.py``: the same objectives
(binary, multiclass, l2, l1, quantile, poisson, tweedie) with the same
formulas, written on tensors. ``grad_hess`` and ``transform`` run on
whatever device their inputs lie on, in their dtype (f32 in a fit, as
the JAX package runs with x64 off); ``init_score`` stays numpy.

Every exponential goes through :func:`exp`, which gives the same bits on
the CPU and on CUDA, and the softmax sums its K columns left to right:
gradients, and so every split and leaf of a fit, are the same on both
devices and under any order of the rows.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, Optional

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Objective:
    name: str
    num_model_outputs: int  # trees trained per boosting round
    grad_hess: Callable  # (pred_raw, y, w, aux) -> (grad, hess) per output
    init_score: Callable  # (y, w) -> scalar or (K,) init raw score
    transform: Callable  # raw scores -> user-facing prediction
    is_classification: bool = False
    # constant-hessian objectives renew each leaf's output to this
    # residual quantile after growth (LightGBM RenewTreeOutput,
    # `regression_objective.hpp`): 0.5 for L1, alpha for quantile
    renew_quantile: Optional[float] = None


#: :func:`exp`'s range in f64: below it e^x rounds to 0 in f32, above it
#: to inf, so clamping there changes no f32 result
_EXP_LO, _EXP_HI = -104.0, 89.0
_LN2 = math.log(2.0)
_INV_LN2 = 1.0 / _LN2
#: e^r's Taylor coefficients 1/9! .. 1/0!: at |r| <= ln 2 / 2 the
#: truncation is below 1e-11 of e^r, far under an f32 ulp
_EXP_HORNER = tuple(1.0 / math.factorial(k) for k in range(9, -1, -1))


def exp(x: torch.Tensor) -> torch.Tensor:
    """``e^x`` in ``x``'s dtype, the same bits on the CPU and on CUDA for
    every input and every layout (``torch.exp`` rounds differently on
    each, and on the CPU differs between its vector body and its tail).

    Only correctly rounded IEEE operations, each its own operator (so no
    device can fuse a multiply and an add): in f64, ``n = round(x / ln
    2)``, ``r = x - n ln 2``, a fixed Horner polynomial for ``e^r``, and
    ``2^n`` made from its exponent bits by integer ops; the product
    rounded once to the output dtype, within an f32 ulp of ``e^x``."""
    xd = torch.clamp(x.to(torch.float64), _EXP_LO, _EXP_HI)
    n = torch.round(xd * _INV_LN2)
    r = xd - n * _LN2
    p = torch.full_like(r, _EXP_HORNER[0])
    for c in _EXP_HORNER[1:]:
        p = p * r + c
    two_n = torch.bitwise_left_shift(n.to(torch.int64) + 1023, 52)
    return (p * two_n.view(torch.float64)).to(x.dtype)


def softmax(raw: torch.Tensor) -> torch.Tensor:
    """The softmax over the last dim through :func:`exp`, its denominator
    summed over the K columns left to right (K - 1 elementwise adds, the
    same order on every device)."""
    e = exp(raw - torch.amax(raw, dim=-1, keepdim=True))
    total = e[..., 0]
    for k in range(1, e.shape[-1]):
        total = total + e[..., k]
    return e / total[..., None]


def _weighted_mean(y, w):
    return float(np.sum(y * w) / max(np.sum(w), 1e-12))


def _identity(raw):
    return raw


# -- regression --------------------------------------------------------------

def make_regression(alpha: float = 0.9, tweedie_p: float = 1.5,
                    kind: str = "l2") -> Objective:
    if kind in ("l2", "regression", "mean_squared_error", "mse"):
        def gh(pred, y, w, aux=None):
            return (pred - y) * w, w

        return Objective("regression", 1, gh,
                         lambda y, w: _weighted_mean(y, w), _identity)

    if kind in ("l1", "mae", "regression_l1"):
        def gh(pred, y, w, aux=None):
            return torch.sign(pred - y) * w, w  # constant hessian

        def init(y, w):
            return float(np.median(np.asarray(y)))

        return Objective("regression_l1", 1, gh, init, _identity,
                         renew_quantile=0.5)

    if kind == "quantile":
        def gh(pred, y, w, aux=None):
            # pinball loss: grad is -alpha under-prediction, (1-alpha) over
            g = torch.where(y > pred, -alpha, 1.0 - alpha).to(pred.dtype)
            return g * w, w

        def init(y, w):
            return float(np.quantile(np.asarray(y), alpha))

        return Objective("quantile", 1, gh, init, _identity,
                         renew_quantile=alpha)

    if kind == "poisson":
        def gh(pred, y, w, aux=None):
            mu = exp(pred)
            return (mu - y) * w, mu * w

        def init(y, w):
            return float(np.log(max(_weighted_mean(y, w), 1e-12)))

        return Objective("poisson", 1, gh, init, exp)

    if kind == "tweedie":
        p = tweedie_p

        def gh(pred, y, w, aux=None):
            # d/df of tweedie deviance with log link (LightGBM's formulation)
            g = -y * exp((1.0 - p) * pred) + exp((2.0 - p) * pred)
            h = -y * (1.0 - p) * exp((1.0 - p) * pred) \
                + (2.0 - p) * exp((2.0 - p) * pred)
            return g * w, torch.clamp(h, min=1e-12) * w

        def init(y, w):
            return float(np.log(max(_weighted_mean(y, w), 1e-12)))

        return Objective("tweedie", 1, gh, init, exp)

    raise ValueError(f"unknown regression objective {kind!r}")


# -- binary ------------------------------------------------------------------

def make_binary() -> Objective:
    def gh(pred, y, w, aux=None):
        p = sigmoid(pred)
        return (p - y) * w, torch.clamp(p * (1.0 - p), min=1e-12) * w

    def init(y, w):
        p = min(max(_weighted_mean(y, w), 1e-12), 1 - 1e-12)
        return float(np.log(p / (1 - p)))

    return Objective("binary", 1, gh, init, sigmoid,
                     is_classification=True)


def sigmoid(x):
    """``1 / (1 + exp(-x))``, the reference's ``jax_sigmoid`` formula
    (not ``torch.sigmoid``, whose rounding differs), through :func:`exp`."""
    return 1.0 / (1.0 + exp(-x))


# -- multiclass --------------------------------------------------------------

def make_multiclass(num_class: int) -> Objective:
    def gh(pred, y, w, aux=None):
        # pred: (n, K) raw; y: (n,) int labels
        p = softmax(pred)
        onehot = torch.nn.functional.one_hot(
            y.to(torch.int64), num_class).to(p.dtype)
        grad = (p - onehot) * w[:, None]
        hess = torch.clamp(p * (1.0 - p), min=1e-12) * w[:, None] * 2.0
        return grad, hess

    def init(y, w):
        counts = np.array([max(float(np.sum((np.asarray(y) == k) * w)), 1e-12)
                           for k in range(num_class)])
        return np.log(counts / counts.sum())

    return Objective("multiclass", num_class, gh, init, softmax,
                     is_classification=True)


@functools.lru_cache(maxsize=64)
def get_objective(name: str, num_class: int = 2, alpha: float = 0.9,
                  tweedie_p: float = 1.5) -> Objective:
    """Objectives are frozen and stateless, so instances are cached, as
    in the reference (whose jit caches key on ``grad_hess``)."""
    name = name.lower()
    if name == "binary":
        return make_binary()
    if name in ("multiclass", "softmax"):
        return make_multiclass(num_class)
    return make_regression(alpha=alpha, tweedie_p=tweedie_p, kind=name)
