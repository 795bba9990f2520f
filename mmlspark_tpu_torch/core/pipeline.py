"""Pipeline composition: fit a chain of stages, get a PipelineModel."""

from __future__ import annotations

import os
from typing import Dict, List, Sequence

import numpy as np

from mmlspark_tpu_torch.core.dataframe import DataFrame
from mmlspark_tpu_torch.core.params import Param
from mmlspark_tpu_torch.core.stage import Estimator, Model, PipelineStage, Transformer


class Pipeline(Estimator):
    """Chain of stages; ``fit`` runs estimators in order, threading data.

    Every fit/transform runs under a :mod:`~mmlspark_tpu_torch.core.tracing`
    span (one ``pipeline.fit`` root — or a child, when an ambient span
    exists — with one child per stage), so a slow batch fit leaves the
    same tail-captured timeline a slow serving request does.
    """

    stages = Param(None, "ordered list of pipeline stages", complex=True)

    def fit(self, df: DataFrame) -> "PipelineModel":
        from mmlspark_tpu_torch.core.tracing import ambient_tracer
        tracer = ambient_tracer()
        fitted: List[Transformer] = []
        stages = list(self.stages or [])
        last_fit = max((i for i, s in enumerate(stages)
                        if isinstance(s, Estimator)), default=-1)
        with tracer.span("pipeline.fit", route="pipeline",
                         n_stages=len(stages)):
            for i, stage in enumerate(stages):
                name = type(stage).__name__
                if isinstance(stage, Estimator):
                    with tracer.span(f"fit:{name}", stage_index=i):
                        model = stage.fit(df)
                    fitted.append(model)
                elif isinstance(stage, Transformer):
                    model = stage
                    fitted.append(stage)
                else:
                    raise TypeError(f"not a pipeline stage: {stage!r}")
                if i < last_fit:  # no estimator downstream -> skip it
                    with tracer.span(f"transform:{name}", stage_index=i):
                        df = model.transform(df)
        return PipelineModel(stages=fitted)

    def _save_extra(self, path: str, arrays: Dict[str, np.ndarray]) -> None:
        _save_stage_list(self.stages or [], path)

    def _load_extra(self, path: str, arrays: Dict[str, np.ndarray]) -> None:
        self.stages = _load_stage_list(path)


class PipelineModel(Model):
    stages = Param(None, "ordered list of fitted transformers", complex=True)

    def transform(self, df: DataFrame) -> DataFrame:
        # per-stage spans: under a serving dispatch the executor has
        # bound the batch-representative request span, so these nest
        # inside that request's "dispatch" — the captured trace then
        # shows WHICH stage of the served pipeline was slow
        from mmlspark_tpu_torch.core.tracing import ambient_tracer
        tracer = ambient_tracer()
        with tracer.span("pipeline.transform", route="pipeline",
                         n_stages=len(self.stages or [])):
            for i, stage in enumerate(self.stages or []):
                with tracer.span(f"transform:{type(stage).__name__}",
                                 stage_index=i):
                    df = stage.transform(df)
        return df

    def _save_extra(self, path: str, arrays: Dict[str, np.ndarray]) -> None:
        _save_stage_list(self.stages or [], path)

    def _load_extra(self, path: str, arrays: Dict[str, np.ndarray]) -> None:
        self.stages = _load_stage_list(path)


def _save_stage_list(stages: Sequence[PipelineStage], path: str) -> None:
    for i, stage in enumerate(stages):
        stage.save(os.path.join(path, f"stage_{i:03d}"))


def _load_stage_list(path: str) -> List[PipelineStage]:
    out = []
    i = 0
    while os.path.isdir(os.path.join(path, f"stage_{i:03d}")):
        out.append(PipelineStage.load(os.path.join(path, f"stage_{i:03d}")))
        i += 1
    return out
