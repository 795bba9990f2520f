"""TuneHyperparameters: randomized/grid search with k-fold CV (the
port's copy of ``mmlspark_tpu/automl/tune.py``).

Capability parity with `src/tune-hyperparameters`
(`TuneHyperparameters.scala:33`): a param space (grid or random dists,
`ParamSpace.scala:25,34`, `HyperparamBuilder.scala:17-98`) is evaluated
with k-fold cross-validation; trials run concurrently on a driver thread
pool (`TuneHyperparameters.scala:80-94`). The thread pool overlaps
host-side featurization/binning with device work; with
``trial_devices=True`` each trial is additionally pinned to its own card
(round-robin over ``cuda:0`` .. ``cuda:n-1``): the trial's thread runs
under ``torch.cuda.device(i)`` inside ``single_device_scope``, and the
trial's estimator (and its inner ``model``) is placed on ``cuda:i``, so
single-card fits run in parallel across the cards instead of contending
for one (SURVEY §2.9 row 6). ``"auto"`` pins only with more than one
card; otherwise every estimator keeps its own device.
"""

from __future__ import annotations

import contextlib
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from mmlspark_tpu_torch.core.environment import accelerator_count
from mmlspark_tpu_torch.core.dataframe import DataFrame, py_scalar as _scalar
from mmlspark_tpu_torch.core.params import Param, HasLabelCol, in_range, in_set
from mmlspark_tpu_torch.core.stage import Estimator, Model, PipelineStage
from mmlspark_tpu_torch.automl.metrics import ComputeModelStatistics
from mmlspark_tpu_torch.automl.best import metric_higher_is_better
from mmlspark_tpu_torch.parallel.topology import single_device_scope


# ---------------------------------------------------------------------------
# Hyperparameter distributions (parity: HyperparamBuilder.scala:17-98)
# ---------------------------------------------------------------------------

class DiscreteHyperParam:
    """A finite set of values (uniform when sampled randomly)."""

    def __init__(self, values: Sequence[Any]):
        self.values = list(values)

    def grid(self) -> List[Any]:
        return list(self.values)

    def sample(self, rng: np.random.Generator) -> Any:
        return self.values[int(rng.integers(len(self.values)))]


class RangeHyperParam:
    """A continuous or integer range [lo, hi); optionally log-uniform.

    ``is_int=None`` (the default) samples continuously — integer bounds do
    NOT silently switch to integer sampling (``RangeHyperParam(0, 1)`` means
    uniform [0, 1), not a coin flip). Use ``is_int=True`` or
    :class:`IntRangeHyperParam` for integer params (parity: the reference
    has typed IntRangeHyperParam / DoubleRangeHyperParam,
    `HyperparamBuilder.scala:17-98`).
    """

    def __init__(self, lo, hi, is_int: Optional[bool] = None,
                 log: bool = False):
        if isinstance(lo, bool) or isinstance(hi, bool):
            raise TypeError("bool bounds make no sense for a range; "
                            "use DiscreteHyperParam([False, True])")
        self.lo, self.hi = lo, hi
        self.is_int = bool(is_int)
        self.log = log

    def grid(self, n: int = 3) -> List[Any]:
        if self.log:
            vals = np.geomspace(self.lo, self.hi, n)
        else:
            vals = np.linspace(self.lo, self.hi, n)
        return [int(round(v)) if self.is_int else float(v) for v in vals]

    def sample(self, rng: np.random.Generator) -> Any:
        if self.log:
            v = float(np.exp(rng.uniform(np.log(self.lo), np.log(self.hi))))
        else:
            v = float(rng.uniform(self.lo, self.hi))
        return int(round(v)) if self.is_int else v


class IntRangeHyperParam(RangeHyperParam):
    def __init__(self, lo: int, hi: int, log: bool = False):
        super().__init__(lo, hi, is_int=True, log=log)


class DoubleRangeHyperParam(RangeHyperParam):
    def __init__(self, lo: float, hi: float, log: bool = False):
        super().__init__(lo, hi, is_int=False, log=log)


class HyperparamBuilder:
    """Collects (param name -> dist) pairs (parity: HyperparamBuilder)."""

    def __init__(self):
        self._dists: Dict[str, Any] = {}

    def add_hyperparam(self, name: str, dist) -> "HyperparamBuilder":
        self._dists[name] = dist
        return self

    def build(self) -> Dict[str, Any]:
        return dict(self._dists)


class GridSpace:
    """Cartesian product of every dist's grid (parity: GridSpace)."""

    def __init__(self, dists: Dict[str, Any]):
        self.dists = dists

    def param_maps(self) -> Iterator[Dict[str, Any]]:
        names = list(self.dists)
        grids = [d.grid() if hasattr(d, "grid") else list(d)
                 for d in self.dists.values()]
        def rec(i: int, acc: Dict[str, Any]):
            if i == len(names):
                yield dict(acc)
                return
            for v in grids[i]:
                acc[names[i]] = v
                yield from rec(i + 1, acc)
        yield from rec(0, {})


class RandomSpace:
    """Random samples from every dist (parity: RandomSpace)."""

    def __init__(self, dists: Dict[str, Any], seed: int = 0):
        self.dists = dists
        self.seed = seed

    def sample(self, n: int) -> Iterator[Dict[str, Any]]:
        rng = np.random.default_rng(self.seed)
        for _ in range(n):
            yield {k: d.sample(rng) for k, d in self.dists.items()}


class DefaultHyperparams:
    """Reasonable default search spaces per estimator class
    (parity: `DefaultHyperparams.scala:12`)."""

    @staticmethod
    def for_estimator(est) -> Dict[str, Any]:
        name = type(est).__name__
        if name.startswith("GBDT"):
            return {
                "num_leaves": DiscreteHyperParam([15, 31, 63]),
                "learning_rate": RangeHyperParam(0.01, 0.3, log=True),
                "num_iterations": DiscreteHyperParam([50, 100, 200]),
            }
        if name == "NNLearner":
            return {
                "learning_rate": RangeHyperParam(1e-4, 1e-1, log=True),
                "batch_size": DiscreteHyperParam([64, 128, 256]),
            }
        return {}


# ---------------------------------------------------------------------------
# The tuner
# ---------------------------------------------------------------------------

class TuneHyperparameters(Estimator, HasLabelCol):
    """Search a param space with k-fold CV, thread-pool parallel trials.

    Parity: `TuneHyperparameters.scala:33` (executor at `:80-94`, fit at
    `:113`). ``models`` may hold several heterogeneous estimators; each
    gets its own space (``param_space`` maps estimator index -> dists, or
    one shared dict).
    """

    models = Param(None, "candidate estimators", complex=True)
    param_space = Param(None, "dists dict or list of dicts per model",
                        complex=True)
    evaluation_metric = Param("accuracy", "metric to optimize", ptype=str)
    num_folds = Param(3, "k-fold CV folds", ptype=int,
                      validator=in_range(lo=2))
    num_runs = Param(8, "random samples per model (random mode)", ptype=int)
    parallelism = Param(4, "concurrent trials", ptype=int,
                        validator=in_range(lo=1))
    search_mode = Param("random", "random | grid", ptype=str)
    seed = Param(0, "sampling/fold seed", ptype=int)
    trial_devices = Param("auto", "assign each trial its own card "
                          "(round-robin over cuda:0 .. cuda:n-1) so "
                          "trials run device-parallel instead of "
                          "contending for one; parallelism should be "
                          ">= the card count. auto = enabled whenever "
                          "the host has more than one card | True | "
                          "False", validator=in_set("auto", True, False))

    def _spaces(self) -> List[Dict[str, Any]]:
        models = self.models or []
        ps = self.param_space
        if ps is None:
            return [DefaultHyperparams.for_estimator(m) for m in models]
        if isinstance(ps, dict):
            return [ps for _ in models]
        return list(ps)

    def fit(self, df: DataFrame) -> "TuneHyperparametersModel":
        models = self.models or []
        spaces = self._spaces()
        metric = self.evaluation_metric
        higher = metric_higher_is_better(metric)

        # trial list: (model_idx, param_map)
        trials: List[Tuple[int, Dict[str, Any]]] = []
        for mi, space in enumerate(spaces):
            if not space:
                trials.append((mi, {}))
            elif self.search_mode == "grid":
                trials.extend((mi, pm) for pm in GridSpace(space).param_maps())
            else:
                trials.extend(
                    (mi, pm)
                    for pm in RandomSpace(space, self.seed).sample(self.num_runs))

        # k-fold split indexes
        n = df.num_rows
        rng = np.random.default_rng(self.seed)
        perm = rng.permutation(n)
        folds = np.array_split(perm, self.num_folds)

        evaluator = ComputeModelStatistics(label_col=self.label_col,
                                           evaluation_metric="all")

        # per-trial device assignment (SURVEY §2.9 row 6: the reference's
        # driver thread pool contends for shared executors; here each
        # trial gets its own card so single-card fits run in parallel)
        devices = None
        use_devices = self.trial_devices
        if use_devices == "auto":
            use_devices = accelerator_count() > 1
        if use_devices:
            devices = trial_device_list()
            if not devices:
                raise RuntimeError("trial_devices=True needs a CUDA card "
                                   "to pin trials to; none is visible")

        def run_trial(ti_trial: Tuple[int, Tuple[int, Dict[str, Any]]]
                      ) -> float:
            ti, (mi, pm) = ti_trial
            device = None if devices is None else devices[ti % len(devices)]
            with (contextlib.nullcontext() if device is None
                  else _pinned(device)):
                vals = []
                for f in range(self.num_folds):
                    test_idx = folds[f]
                    train_idx = np.concatenate(
                        [folds[j] for j in range(self.num_folds) if j != f])
                    est = _apply_params(models[mi], pm)
                    if device is not None:
                        est = _placed(est, device)
                    fitted = est.fit(df.take(train_idx))
                    scored = fitted.transform(df.take(test_idx))
                    m = evaluator.evaluate(scored)
                    vals.append(float(m[metric][0]))
            return float(np.mean(vals))

        # the user's parallelism cap is respected in both modes (trials
        # can dominate host RAM; silently raising it to the device count
        # could OOM the host) — set parallelism >= len(devices) to keep
        # every card busy
        workers = max(1, min(self.parallelism, len(trials)))
        with ThreadPoolExecutor(max_workers=workers) as pool:
            results = list(pool.map(run_trial, enumerate(trials)))

        best_i = int(np.argmax(results) if higher else np.argmin(results))
        best_mi, best_pm = trials[best_i]
        best_model = _apply_params(models[best_mi], best_pm).fit(df)

        rows = [{"model": type(models[mi]).__name__,
                 **{k: _scalar(v) for k, v in pm.items()},
                 metric: res}
                for (mi, pm), res in zip(trials, results)]
        return TuneHyperparametersModel(
            best_model=best_model,
            best_metric=float(results[best_i]),
            best_params={k: _scalar(v) for k, v in best_pm.items()},
            history=DataFrame.from_rows(rows))


def _apply_params(est, pm: Dict[str, Any]):
    """Copy ``est`` with the param map, routing params the estimator does
    not declare to its wrapped inner estimator (``model`` param) — so a
    search space over e.g. GBDT params works on a TrainClassifier wrapper
    (the reference's ParamSpace binds params to stages the same way)."""
    declared = type(est).params()
    own = {k: v for k, v in pm.items() if k in declared}
    rest = {k: v for k, v in pm.items() if k not in declared}
    out = est.copy(**own)
    if rest:
        inner = getattr(out, "model", None)
        if inner is None:
            raise KeyError(
                f"{type(est).__name__} has no params {sorted(rest)} and no "
                f"inner 'model' estimator to route them to")
        out.set(model=inner.copy(**rest))
    return out


def trial_device_list() -> List[str]:
    """The cards a trial may be pinned to: ``cuda:0`` .. ``cuda:n-1``
    (none without CUDA)."""
    return [f"cuda:{i}" for i in range(accelerator_count())]


@contextlib.contextmanager
def _pinned(device: str):
    """Run a trial's thread on ``device``: its current CUDA device (for a
    card), inside ``single_device_scope`` (framework estimators must not
    build full-mesh placements inside a pinned trial: concurrent threads
    interleaving multi-device collective launches can deadlock)."""
    dev = torch.device(device)
    with contextlib.ExitStack() as stack:
        if dev.type == "cuda":
            stack.enter_context(torch.cuda.device(dev))
        stack.enter_context(single_device_scope())
        yield


def _placed(est, device: str):
    """``est`` with every stage that takes a device placed on ``device``:
    the estimator itself and its wrapped inner ``model`` estimator (a
    ``TrainClassifier`` keeps no device; its ``GBDTClassifier`` does)."""
    if "device" in type(est).params():
        est = est.copy(device=device)
    inner = getattr(est, "model", None)
    if hasattr(inner, "params") and "device" in type(inner).params():
        est = est.copy()
        est.set(model=inner.copy(device=device))
    return est


class TuneHyperparametersModel(Model):
    """The winning refitted model + search history."""

    best_model = Param(None, "winner refit on full data", complex=True)
    best_metric = Param(None, "winner's CV metric", ptype=float)
    best_params = Param(None, "winner's param map", ptype=dict)
    history = Param(None, "all trials frame", complex=True)

    def transform(self, df: DataFrame) -> DataFrame:
        return self.best_model.transform(df)

    def get_best_model(self):
        return self.best_model

    def get_history(self) -> DataFrame:
        return self.history

    def _save_extra(self, path, arrays):
        import os
        self.best_model.save(os.path.join(path, "best"))

    def _load_extra(self, path, arrays):
        import os
        self.best_model = PipelineStage.load(os.path.join(path, "best"))
