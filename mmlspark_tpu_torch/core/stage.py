"""Pipeline stage base classes: Transformer / Estimator / Model / Evaluator.

Capability parity with the Spark ML stage model the whole reference is built
on: an ``Estimator.fit(df)`` returns a ``Model`` (a ``Transformer``);
``Transformer.transform(df)`` maps a columnar frame to a columnar frame;
``Evaluator.evaluate(df)`` computes metrics. Stages carry declared params,
a uid, and directory-based persistence.
"""

from __future__ import annotations

import itertools
import time
from typing import Any, Dict, Optional

import numpy as np

from mmlspark_tpu_torch.core import registry, serialize
from mmlspark_tpu_torch.core.dataframe import DataFrame
from mmlspark_tpu_torch.core.params import Params

_uid_counter = itertools.count()


class PipelineStage(Params):
    """Base for all stages: params + uid + persistence + registry."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self._uid: Optional[str] = None

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        registry.register(cls)

    @property
    def uid(self) -> str:
        if self._uid is None:
            self._uid = f"{type(self).__name__}_{next(_uid_counter):04d}"
        return self._uid

    # -- persistence hooks --------------------------------------------------

    def save(self, path: str) -> None:
        serialize.save_stage(self, path)

    @staticmethod
    def load(path: str, device: Optional[str] = None) -> "PipelineStage":
        """Load a saved stage; ``device`` places every stage of the tree
        that takes one (``None``: the card, or the process's default
        load device)."""
        return serialize.load_stage(path, device=device)

    def _save_extra(self, path: str, arrays: Dict[str, np.ndarray]) -> None:
        """Override to persist complex state (put ndarrays into ``arrays``)."""

    def _load_extra(self, path: str, arrays: Dict[str, np.ndarray]) -> None:
        """Override to restore complex state saved by ``_save_extra``."""

    def _save_substage(self, path: str, name: str) -> None:
        """Persist a complex stage-valued param under ``path/name`` (None ok)."""
        import os
        stage = getattr(self, name)
        if stage is not None:
            stage.save(os.path.join(path, name))

    def _load_substage(self, path: str, name: str) -> None:
        """Restore a stage saved by ``_save_substage`` (missing -> None)."""
        import os
        sub = os.path.join(path, name)
        if os.path.isdir(sub):
            setattr(self, name, PipelineStage.load(sub))

    def __repr__(self) -> str:
        params = ", ".join(f"{k}={v!r}" for k, v in self._param_values.items())
        return f"{type(self).__name__}({params})"


class Transformer(PipelineStage):
    def transform(self, df: DataFrame) -> DataFrame:
        raise NotImplementedError

    def __call__(self, df: DataFrame) -> DataFrame:
        return self.transform(df)


class Estimator(PipelineStage):
    def fit(self, df: DataFrame) -> "Model":
        raise NotImplementedError


class Model(Transformer):
    """A fitted transformer produced by an Estimator."""


class Evaluator(PipelineStage):
    def evaluate(self, df: DataFrame) -> DataFrame:
        raise NotImplementedError


# -- fluent API (parity: core/spark/FluentAPI.scala df.mlTransform/mlFit) ----

def ml_transform(df: DataFrame, *stages: Transformer) -> DataFrame:
    for s in stages:
        df = s.transform(df)
    return df


def ml_fit(df: DataFrame, estimator: Estimator) -> Model:
    return estimator.fit(df)


_STAGE_HIST = None


def _stage_histogram():
    """The shared per-stage span histogram: batch pipelines (this Timer)
    and the serving plane's ``StageTimings`` report through the same
    telemetry surface, so one ``/metrics`` scrape covers both. Cached
    at module level so a Timer-wrapped transform pays one dict lookup,
    not a registry-lock round trip per call."""
    global _STAGE_HIST
    if _STAGE_HIST is None:
        from mmlspark_tpu_torch.core.telemetry import REGISTRY
        _STAGE_HIST = REGISTRY.histogram(
            "pipeline_stage_duration_ms",
            "Wall-clock of Timer-wrapped pipeline stage fits/transforms.",
            labels=("stage", "phase"))
    return _STAGE_HIST


class Timer(Estimator):
    """Wraps a stage and logs wall-clock of its fit/transform.

    Parity: pipeline-stages Timer (an Estimator producing a TimerModel,
    `Timer.scala:14-90`). Fitting times the inner estimator's fit (or wraps
    a transformer directly); the TimerModel times each transform. Every
    span also lands in the process-wide metrics registry
    (``pipeline_stage_duration_ms{stage=...,phase=fit|transform}``), so
    batch pipelines report through the same exposition as serving.
    """

    from mmlspark_tpu_torch.core.params import Param as _P
    stage = _P(None, "the stage to time", complex=True)

    def fit(self, df: DataFrame) -> "TimerModel":
        inner = self.stage
        if isinstance(inner, Estimator):
            from mmlspark_tpu_torch.core.tracing import ambient_tracer
            t0 = time.time()
            # the span nests under any ambient trace (a traced batch
            # job sees Timer-wrapped fits in its captured timeline)
            with ambient_tracer().span(
                    f"fit:{type(self.stage).__name__}",
                    route="pipeline"):
                inner = inner.fit(df)
            dt = time.time() - t0
            _stage_histogram().labels(
                type(self.stage).__name__, "fit").observe(dt * 1000.0)
            print(f"[Timer] {type(self.stage).__name__}.fit took "
                  f"{dt:.3f}s")
        return TimerModel(stage=inner)

    def _save_extra(self, path, arrays):
        self._save_substage(path, "stage")

    def _load_extra(self, path, arrays):
        self._load_substage(path, "stage")


class TimerModel(Model):
    from mmlspark_tpu_torch.core.params import Param as _P
    stage = _P(None, "the fitted stage to time", complex=True)

    def transform(self, df: DataFrame) -> DataFrame:
        from mmlspark_tpu_torch.core.tracing import ambient_tracer
        t0 = time.time()
        with ambient_tracer().span(
                f"transform:{type(self.stage).__name__}",
                route="pipeline"):
            out = self.stage.transform(df)
        dt = time.time() - t0
        _stage_histogram().labels(
            type(self.stage).__name__, "transform").observe(dt * 1000.0)
        print(f"[Timer] {type(self.stage).__name__}.transform took "
              f"{dt:.3f}s")
        return out

    def _save_extra(self, path, arrays):
        self._save_substage(path, "stage")

    def _load_extra(self, path, arrays):
        self._load_substage(path, "stage")
