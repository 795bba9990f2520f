"""Global stage registry (the port's copy of
``mmlspark_tpu/core/registry.py``).

Every concrete stage class auto-registers by qualified name when defined.
This powers (a) persistence — ``load`` resolves the class to instantiate —
and (b) generic sweeps over all stages.
"""

from __future__ import annotations

import importlib
from typing import Dict, Type

STAGE_REGISTRY: Dict[str, Type] = {}

#: the port's modules that define stages: ``all_stages`` imports these
STAGE_MODULES = ("mmlspark_tpu_torch.core.stage",
                 "mmlspark_tpu_torch.core.pipeline",
                 "mmlspark_tpu_torch.models.nn",
                 "mmlspark_tpu_torch.gbdt.stages",
                 "mmlspark_tpu_torch.serving.consolidator",
                 "mmlspark_tpu_torch.stages.image",
                 "mmlspark_tpu_torch.models.featurizer",
                 "mmlspark_tpu_torch.models.trainer",
                 "mmlspark_tpu_torch.featurize.assemble",
                 "mmlspark_tpu_torch.featurize.text",
                 "mmlspark_tpu_torch.automl.train",
                 "mmlspark_tpu_torch.automl.metrics",
                 "mmlspark_tpu_torch.automl.best",
                 "mmlspark_tpu_torch.automl.tune",
                 "mmlspark_tpu_torch.stages.basic",
                 "mmlspark_tpu_torch.stages.prep",
                 "mmlspark_tpu_torch.stages.batching",
                 "mmlspark_tpu_torch.recommend.indexer",
                 "mmlspark_tpu_torch.recommend.sar",
                 "mmlspark_tpu_torch.recommend.ranking",
                 "mmlspark_tpu_torch.explain.superpixel",
                 "mmlspark_tpu_torch.explain.lime",
                 "mmlspark_tpu_torch.io.http",
                 "mmlspark_tpu_torch.io.services")


def register(cls: Type) -> None:
    STAGE_REGISTRY[f"{cls.__module__}.{cls.__qualname__}"] = cls


def resolve(qualname: str) -> Type:
    if qualname not in STAGE_REGISTRY:
        module = qualname.rsplit(".", 1)[0]
        if module.split(".", 1)[0] == "mmlspark_tpu":
            # a checkpoint the JAX package wrote names its own classes:
            # the port never imports that package
            raise KeyError(f"stage class {qualname!r} belongs to the JAX "
                           f"package; the port loads its own stages only")
        importlib.import_module(module)
    if qualname not in STAGE_REGISTRY:
        raise KeyError(f"unknown stage class {qualname!r}")
    return STAGE_REGISTRY[qualname]


def all_stages() -> Dict[str, Type]:
    """Import the port's stage modules, then return every public
    registered stage of the port."""
    for module in STAGE_MODULES:
        importlib.import_module(module)
    return {k: v for k, v in STAGE_REGISTRY.items()
            if not v.__name__.startswith("_")
            and v.__module__.startswith("mmlspark_tpu_torch")}
