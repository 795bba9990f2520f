"""The quantized serving wire: per-version QuantizationConfig (the
port's copy of the config half of ``mmlspark_tpu/serving/quant.py``).

* a :class:`QuantizationConfig` rides each
  :class:`~mmlspark_tpu_torch.serving.rollout.ModelVersion` (boot config via
  ``ServingServer(quantization=...)``; rollout configs via
  ``POST /rollout/stage {"quantization": {...}}`` — the staged
  version's config survives verify -> warmup -> flip untouched);
* the dispatch stage casts the assembled columnar frame to the wire
  dtype (saturating — out-of-range payload values clamp, the standard
  quantization semantics, never wrap into garbage) right before the
  model sees it;
* ``serving_wire_bytes_total{dtype}`` counts the bytes each dispatch
  actually put on the device wire, ``GET /stats`` reports the active
  config, and dispatch spans carry ``wire_dtype``.

Config validation is strict and happens at CONSTRUCTION (so a
malformed scale/zero-point in a rollout body is a 400 at the stage
endpoint, never a batch of garbage dispatched at serving time): the
scale must be a finite non-zero number, the zero_point finite, the
wire dtype one of ``uint8``/``int8``.

:class:`ComputeQuantization` is the validated config of int8 weights
and low-precision activations inside a model's matmuls:
:func:`quantize_param_tree` derives the int8 kernels and per-channel
scales once (numpy, bit-equal to the JAX package's on the same tree,
the scales keyed by JAX's ``keystr`` path strings), and
:func:`dequantize_param_tree` is the forward-time inverse that
:class:`~mmlspark_tpu_torch.models.nn.NNModel` runs on the device.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional

import numpy as np

__all__ = ["QuantizationConfig", "ComputeQuantization",
           "quantize_param_tree", "dequantize_param_tree"]

_WIRE_DTYPES = {
    "uint8": (np.uint8, 0, 255),
    "int8": (np.int8, -128, 127),
}

_ACT_DTYPES = ("bfloat16", "float32")


class ComputeQuantization:
    """The ON-DEVICE half of the quantization story: int8
    weights / low-precision activations inside the matmuls themselves,
    not just on the wire.

    ``weight_dtype`` — ``"int8"`` (the only engine): every eligible
    weight matrix is stored int8 in device memory with per-output-channel
    symmetric scales (``amax(|w|) / 127`` over the input axes, f32,
    computed ONCE at rollout stage time) and dequantizes into the
    matmul — the int8->float cast is exact, and the accumulator stays
    f32.

    ``activation_dtype`` — what the activations meet the weights as in
    the matmuls: ``"bfloat16"`` (the fast path) or
    ``"float32"`` (full-precision activations against int8 weights —
    the conservative A/B arm). Softmax, normalization, and the
    residual stream stay f32 either way, mirroring the train path's
    ``cfg.dtype`` flow.

    ``tolerance`` — the row-wise RELATIVE tolerance the quantized
    plane must hold against the f32 reference: the rollout verify step
    refuses to stage a config outside it (state -> ``error``, the
    active version keeps serving — automatic rollback) and the
    shadow-traffic comparator uses it instead of the exact-parity
    default while an int8-compute version is staged.

    ``scale_multiplier`` — a deliberate scale corruption (!= 1.0) for
    chaos/rollback drills: the bench gate stages a broken config and
    proves the verify step catches it BEFORE the flip.
    """

    __slots__ = ("weight_dtype", "activation_dtype", "tolerance",
                 "scale_multiplier")

    def __init__(self, weight_dtype: str = "int8",
                 activation_dtype: str = "bfloat16",
                 tolerance: float = 5e-2,
                 scale_multiplier: float = 1.0):
        if weight_dtype != "int8":
            raise ValueError(
                f"compute weight_dtype must be 'int8', got "
                f"{weight_dtype!r}")
        if activation_dtype not in _ACT_DTYPES:
            raise ValueError(
                f"compute activation_dtype must be one of "
                f"{list(_ACT_DTYPES)}, got {activation_dtype!r}")
        try:
            tolerance = float(tolerance)
            scale_multiplier = float(scale_multiplier)
        except (TypeError, ValueError):
            raise ValueError(
                "compute tolerance/scale_multiplier must be numbers, "
                f"got {tolerance!r} / {scale_multiplier!r}") from None
        if not math.isfinite(tolerance) or tolerance <= 0.0:
            raise ValueError(
                f"compute tolerance must be finite and positive, got "
                f"{tolerance!r}")
        if not math.isfinite(scale_multiplier) \
                or scale_multiplier == 0.0:
            raise ValueError(
                f"compute scale_multiplier must be finite and "
                f"non-zero, got {scale_multiplier!r}")
        self.weight_dtype = weight_dtype
        self.activation_dtype = activation_dtype
        self.tolerance = tolerance
        self.scale_multiplier = scale_multiplier

    @classmethod
    def from_value(cls, value: Any) -> Optional["ComputeQuantization"]:
        if value is None or isinstance(value, cls):
            return value
        if not isinstance(value, dict):
            raise ValueError(
                f"quantization compute must be a JSON object, got "
                f"{type(value).__name__}")
        unknown = set(value) - {"weight_dtype", "activation_dtype",
                                "tolerance", "scale_multiplier"}
        if unknown:
            raise ValueError(
                f"unknown quantization compute keys {sorted(unknown)}")
        return cls(**value)

    def to_dict(self) -> Dict[str, Any]:
        return {"weight_dtype": self.weight_dtype,
                "activation_dtype": self.activation_dtype,
                "tolerance": self.tolerance,
                "scale_multiplier": self.scale_multiplier}

    def __repr__(self) -> str:
        return (f"ComputeQuantization("
                f"weight_dtype={self.weight_dtype!r}, "
                f"activation_dtype={self.activation_dtype!r}, "
                f"tolerance={self.tolerance!r}, "
                f"scale_multiplier={self.scale_multiplier!r})")

    def __eq__(self, other) -> bool:
        return isinstance(other, ComputeQuantization) and \
            self.to_dict() == other.to_dict()


def _tree_leaves(tree, path=()):
    """``(path, leaf)`` pairs of a nested dict, in JAX's flatten order
    (keys sorted)."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _tree_leaves(v, path + (k,))
        else:
            yield path + (k,), v


def keystr(path) -> str:
    """``jax.tree_util.keystr`` of a dict path: ``"['params']['z']"``."""
    return "".join(f"[{k!r}]" for k in path)


def _tree_set(tree, path, leaf) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = leaf


def quantize_param_tree(params, comp: ComputeQuantization):
    """Per-channel int8 quantization of a model param tree — the
    scale-derivation step, run ONCE at rollout stage time.

    Every eligible leaf (a ``kernel`` of ndim >= 2 — Dense ``(I, O)``
    and Conv ``(..., I, O)`` kernels in the flax layout; biases, norms
    and everything 1-D stay f32) is replaced in the returned tree by
    its int8 rounding under symmetric per-output-channel scales
    ``amax(|w|, input axes) / 127`` (zero channels guard to scale 1.0).
    The scales ride OUTSIDE the tree in a dict keyed by the leaf's
    ``keystr`` path, so the tree keeps its structure. The config's
    ``scale_multiplier`` folds into the stored scales. Numpy on both
    sides, so the JAX package gives the same bits."""
    scales: Dict[str, np.ndarray] = {}
    out: Dict[str, Any] = {}
    for path, leaf in _tree_leaves(params):
        arr = np.asarray(leaf)
        if "kernel" in str(path[-1]) and arr.ndim >= 2 \
                and arr.dtype.kind == "f":
            s = np.max(np.abs(arr), axis=tuple(range(arr.ndim - 1)))
            s = (s / 127.0).astype(np.float32)
            s = np.where(s > 0, s, np.float32(1.0))
            q = np.clip(np.rint(arr / s), -127, 127).astype(np.int8)
            scales[keystr(path)] = (s * np.float32(comp.scale_multiplier))
            _tree_set(out, path, q)
        else:
            _tree_set(out, path, leaf)
    if not scales:
        raise ValueError(
            "compute quantization found no eligible kernel leaves in "
            "the param tree — nothing would be quantized")
    return out, scales


def dequantize_param_tree(qparams, scales: Dict[str, np.ndarray],
                          activation_dtype: str, device=None):
    """The forward-time inverse: int8 kernels back to
    ``activation_dtype`` via their per-channel scales (an f32 multiply
    first, one downcast after), as torch tensors on ``device`` (``None``:
    where each leaf already lies, the CPU for numpy leaves); other
    leaves pass through unchanged."""
    import torch
    act = getattr(torch, activation_dtype)
    out: Dict[str, Any] = {}
    for path, leaf in _tree_leaves(qparams):
        s = scales.get(keystr(path))
        if s is not None:
            w = torch.as_tensor(leaf, device=device)
            leaf = (w.to(torch.float32)
                    * torch.as_tensor(s, device=w.device)).to(act)
        _tree_set(out, path, leaf)
    return out


class QuantizationConfig:
    """How a model version's request payloads cross the wire.

    ``wire_dtype`` — ``"uint8"`` or ``"int8"``: the integer dtype
    payload values are cast to for assembly + host->device transfer
    (4x fewer bytes than f32, 2x than bf16). ``"none"`` leaves
    payloads in their native float dtype — the compute-only shape
    (``{"wire_dtype": "none", "compute": {...}}``) quantizes weights
    on device without touching ingest.

    ``scale`` / ``zero_point`` — the on-device dequantization
    ``x * scale + zero_point`` in the model's first layer (for models
    with ``input_scale``/``input_offset`` params). Defaults: ``1/255`` and
    ``0.0`` — u8 images to ``[0, 1]`` (``1.0`` / ``0.0`` under
    ``wire_dtype: "none"``, where there is no wire step to invert;
    anything else there is refused).

    ``columns`` — the input columns the wire dtype applies to (None =
    every numeric input column; reply columns are never touched).

    ``compute`` — optional :class:`ComputeQuantization`: int8 weights
    / low-precision activations INSIDE the model's matmuls (the wire
    fields above only cover ingest). None = f32 compute, the default.
    """

    __slots__ = ("wire_dtype", "scale", "zero_point", "columns",
                 "compute")

    def __init__(self, wire_dtype: str = "uint8",
                 scale: Optional[float] = None,
                 zero_point: float = 0.0,
                 columns: Optional[List[str]] = None,
                 compute: Any = None):
        if wire_dtype != "none" and wire_dtype not in _WIRE_DTYPES:
            raise ValueError(
                f"wire_dtype must be one of "
                f"{sorted(_WIRE_DTYPES) + ['none']}, got {wire_dtype!r}")
        if scale is None:
            scale = 1.0 if wire_dtype == "none" else 1.0 / 255.0
        try:
            scale = float(scale)
            zero_point = float(zero_point)
        except (TypeError, ValueError):
            raise ValueError(
                "quantization scale/zero_point must be numbers, got "
                f"scale={scale!r} zero_point={zero_point!r}") from None
        if not math.isfinite(scale) or scale == 0.0:
            # a zero or non-finite scale dequantizes every payload to
            # one constant (or NaN) — refuse at config time, not after
            # a batch of garbage replies
            raise ValueError(
                f"quantization scale must be finite and non-zero, "
                f"got {scale!r}")
        if not math.isfinite(zero_point):
            raise ValueError(
                f"quantization zero_point must be finite, got "
                f"{zero_point!r}")
        if wire_dtype == "none" and (scale != 1.0
                                     or zero_point != 0.0):
            # no wire cast means no dequant step to invert — a
            # non-identity scale here would silently rescale raw f32
            # payloads
            raise ValueError(
                "wire_dtype 'none' requires scale=1.0/zero_point=0.0, "
                f"got scale={scale!r} zero_point={zero_point!r}")
        if columns is not None:
            if not isinstance(columns, (list, tuple)) or \
                    not all(isinstance(c, str) for c in columns):
                raise ValueError("quantization columns must be a list "
                                 f"of column names, got {columns!r}")
            columns = list(columns)
        self.wire_dtype = wire_dtype
        self.scale = scale
        self.zero_point = zero_point
        self.columns = columns
        self.compute = ComputeQuantization.from_value(compute)

    # -- construction --------------------------------------------------------

    @classmethod
    def from_value(cls, value: Any) -> Optional["QuantizationConfig"]:
        """Coerce a config from user input: an existing config passes
        through, a dict becomes one (unknown keys refused — a typoed
        ``zero_pont`` must not silently default), None stays None.
        Raises ``ValueError`` on anything malformed — the rollout
        endpoint turns that into a 400."""
        if value is None or isinstance(value, cls):
            return value
        if not isinstance(value, dict):
            raise ValueError(
                f"quantization must be a JSON object, got "
                f"{type(value).__name__}")
        unknown = set(value) - {"wire_dtype", "scale", "zero_point",
                                "columns", "compute"}
        if unknown:
            raise ValueError(
                f"unknown quantization keys {sorted(unknown)}")
        return cls(**value)

    # -- the wire cast -------------------------------------------------------

    @property
    def np_dtype(self) -> np.dtype:
        if self.wire_dtype == "none":
            return np.dtype(np.float32)
        return np.dtype(_WIRE_DTYPES[self.wire_dtype][0])

    def applies_to(self, column: str) -> bool:
        return self.columns is None or column in self.columns

    def quantize_column(self, arr: np.ndarray) -> np.ndarray:
        """Cast one assembled column to the wire dtype (saturating:
        values outside the dtype's range clamp to its edges — the
        standard quantized-tensor semantics; integer casts that WRAP
        would dispatch garbage for one out-of-range payload value).
        Non-numeric (object/string) columns pass through untouched."""
        if self.wire_dtype == "none" or arr.dtype == self.np_dtype:
            return arr
        if arr.dtype == np.dtype("O") or arr.dtype.kind not in "fiub":
            return arr
        _, lo, hi = _WIRE_DTYPES[self.wire_dtype]
        if arr.dtype.kind == "f":
            # round-to-nearest, not truncation: a client's fp-noisy
            # 254.9999 must land on 255, not 254 (astype truncates
            # toward zero — a one-sided LSB of error otherwise)
            return np.clip(np.rint(arr), lo, hi).astype(self.np_dtype)
        if arr.dtype.kind in "iu" and arr.size:
            # integer payloads already in range (the steady state once
            # clients send wire-ready values) skip the clip's full-size
            # temporary: two C-speed scans, one cast
            mn, mx = arr.min(), arr.max()
            if lo <= mn and mx <= hi:
                return arr.astype(self.np_dtype)
        return np.clip(arr, lo, hi).astype(self.np_dtype)

    def quantize_frame(self, df):
        """Cast every applicable column of a columnar frame to the
        wire dtype; returns the frame unchanged when nothing needs the
        cast (the steady state once clients send integer payloads)."""
        out = {}
        changed = False
        for name in df.columns:
            col = df[name]
            if self.applies_to(name):
                q = self.quantize_column(col)
                changed = changed or q is not col
                out[name] = q
            else:
                out[name] = col
        if not changed:
            return df
        from mmlspark_tpu_torch.core.dataframe import DataFrame
        return DataFrame(out)

    # -- model wiring --------------------------------------------------------

    def configure_model(self, model) -> None:
        """Point a model's ingest at this config: for models with the
        ``NNModel`` quantization surface (``input_dtype`` +
        ``input_scale``/``input_offset`` params) the wire dtype and
        dequant constants are set so the on-device dequantize matches
        the wire exactly. A model that carries its OWN ``quantization``
        param (a persisted quantized checkpoint restaged under a new
        config) has it replaced too — that param takes precedence
        inside the model, so leaving the old one would silently
        dequantize with the superseded constants. Models without the
        surface are left alone — they see the integer columns and
        handle them as data."""
        if hasattr(model, "input_dtype") and \
                hasattr(model, "input_scale"):
            # "none" = native float payloads: "auto" keeps the model's
            # arch-driven transfer dtype and the identity scale/offset
            # below make the input dequant a no-op
            model.input_dtype = ("auto" if self.wire_dtype == "none"
                                 else self.wire_dtype)
            model.input_scale = self.scale
            model.input_offset = self.zero_point
            if self.compute is not None:
                # compute quantization lives ON the model (the int8
                # tree + scales hang off model.quantization.compute) —
                # a model staged without its own config must adopt
                # this one or it serves f32 silently
                if getattr(model, "quantization", None) != self:
                    model.quantization = self
            elif getattr(model, "quantization", None) is not None \
                    and model.quantization != self:
                model.quantization = self

    # -- surfaces ------------------------------------------------------------

    def to_dict(self) -> Dict[str, Any]:
        return {"wire_dtype": self.wire_dtype, "scale": self.scale,
                "zero_point": self.zero_point, "columns": self.columns,
                "compute": (self.compute.to_dict()
                            if self.compute is not None else None)}

    def __repr__(self) -> str:
        return (f"QuantizationConfig(wire_dtype={self.wire_dtype!r}, "
                f"scale={self.scale!r}, zero_point={self.zero_point!r},"
                f" columns={self.columns!r}, compute={self.compute!r})")

    def __eq__(self, other) -> bool:
        return isinstance(other, QuantizationConfig) and \
            self.to_dict() == other.to_dict()
