"""Declarative parameter system for pipeline stages.

Capability parity with Spark ML ``Params`` as used throughout the reference
(`core/contracts/src/main/scala/Params.scala:10-82`, the extended param types
in `core/serialize/src/main/scala/params/`): every stage declares typed,
documented, validated params; params serialize to JSON for persistence; and
shared mixins (``HasInputCol`` etc.) give a uniform API across stages.

Python-native design: params are class-level :class:`Param` descriptors;
stages accept them as constructor keyword arguments and expose snake_case
attributes plus a fluent ``.set(**kwargs)``.
"""

from __future__ import annotations

import copy as _copy
from typing import Any, Callable, Dict, Optional, Type


class Param:
    """A declared, typed, documented parameter on a stage class."""

    def __init__(self, default: Any = None, doc: str = "",
                 validator: Optional[Callable[[Any], bool]] = None,
                 ptype: Optional[Type] = None, complex: bool = False):
        self.default = default
        self.doc = doc
        self.validator = validator
        self.ptype = ptype
        # complex params (models, functions, frames) are excluded from JSON
        # and persisted via the owning stage's _save_extra/_load_extra hooks
        # (parity: ComplexParam hierarchy, core/serialize/ComplexParam.scala)
        self.complex = complex
        self.name: str = ""  # filled by __set_name__

    def __set_name__(self, owner, name):
        self.name = name

    def __get__(self, obj, objtype=None):
        if obj is None:
            return self
        return obj._param_values.get(self.name, self.default)

    def __set__(self, obj, value):
        obj._set_param(self.name, value)

    def validate(self, value: Any) -> None:
        """Validate an already-coerced value (coercion lives in _set_param)."""
        if value is None:
            return
        if self.ptype is not None:
            if not isinstance(value, self.ptype):
                raise TypeError(
                    f"param {self.name!r} expects {self.ptype.__name__}, "
                    f"got {type(value).__name__}: {value!r}")
        if self.validator is not None and not self.validator(value):
            raise ValueError(f"invalid value for param {self.name!r}: {value!r}")


def in_range(lo=None, hi=None):
    def check(v):
        return (lo is None or v >= lo) and (hi is None or v <= hi)
    return check


def in_set(*options):
    opts = set(options)
    return lambda v: v in opts


class Params:
    """Base class collecting :class:`Param` descriptors and their values."""

    def __init__(self, **kwargs):
        self._param_values: Dict[str, Any] = {}
        self.set(**kwargs)

    @classmethod
    def params(cls) -> Dict[str, Param]:
        out: Dict[str, Param] = {}
        for klass in reversed(cls.__mro__):
            for k, v in vars(klass).items():
                if isinstance(v, Param):
                    out[k] = v
        return out

    def _set_param(self, name: str, value: Any) -> None:
        p = type(self).params().get(name)
        if p is None:
            raise KeyError(f"{type(self).__name__} has no param {name!r}")
        if value is not None and p.ptype is float and isinstance(value, int) \
                and not isinstance(value, bool):
            value = float(value)
        p.validate(value)
        self._param_values[name] = value

    def set(self, **kwargs) -> "Params":
        for k, v in kwargs.items():
            self._set_param(k, v)
        return self

    def get(self, name: str) -> Any:
        return getattr(self, name)

    def is_set(self, name: str) -> bool:
        return name in self._param_values

    def get_param_values(self, include_defaults: bool = False) -> Dict[str, Any]:
        if include_defaults:
            return {k: getattr(self, k) for k in type(self).params()}
        return dict(self._param_values)

    def explain_params(self) -> str:
        lines = []
        for name, p in sorted(type(self).params().items()):
            current = self._param_values.get(name, p.default)
            lines.append(f"{name}: {p.doc} (default: {p.default!r}, "
                         f"current: {current!r})")
        return "\n".join(lines)

    def copy(self, **overrides) -> "Params":
        out = _copy.copy(self)
        out._param_values = dict(self._param_values)
        out.set(**overrides)
        return out

    def _json_params(self) -> Dict[str, Any]:
        """Explicitly-set non-complex params, for JSON persistence."""
        declared = type(self).params()
        return {k: v for k, v in self._param_values.items()
                if not declared[k].complex}


# ---------------------------------------------------------------------------
# Shared param mixins (parity: core/contracts/Params.scala HasInputCol etc.)
# ---------------------------------------------------------------------------

class HasInputCol(Params):
    input_col = Param(None, "name of the input column", ptype=str)


class HasInputCols(Params):
    input_cols = Param(None, "names of the input columns", ptype=list)


class HasOutputCol(Params):
    output_col = Param(None, "name of the output column", ptype=str)


class HasOutputCols(Params):
    output_cols = Param(None, "names of the output columns", ptype=list)


class HasLabelCol(Params):
    label_col = Param("label", "name of the label column", ptype=str)


class HasFeaturesCol(Params):
    features_col = Param("features", "name of the features column", ptype=str)


class HasWeightCol(Params):
    weight_col = Param(None, "name of the instance weight column", ptype=str)


class HasDevice(Params):
    """Where a stage computes. The port's own param (the JAX package
    places by its default device): ``None`` is the card, and raises
    without CUDA; ``"cpu"`` is the only way onto the CPU. A device is
    where a stage runs, not part of the model, so it is not persisted:
    a loaded stage takes the device its loader asks for
    (``PipelineStage.load(path, device=...)``)."""

    device = Param(None, "the device: None = the card (raises without "
                   "CUDA), 'cpu' = the CPU; not persisted", ptype=str)

    def _json_params(self) -> Dict[str, Any]:
        out = super()._json_params()
        out.pop("device", None)
        return out
