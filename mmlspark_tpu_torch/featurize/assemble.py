"""Vector assembly + AutoML per-type featurization.

The port's copy of ``mmlspark_tpu/featurize/assemble.py``.

Capability parity with `src/featurize`:
- :class:`VectorAssembler` — assemble numeric/vector columns into one
  feature-vector column, carrying slot names and categorical-slot levels in
  column metadata (parity: `core/spark/FastVectorAssembler.scala:23`, which
  exists precisely to keep categorical metadata cheap and up front).
- :class:`Featurize` — AutoML featurization (parity: `Featurize.scala:24`,
  `AssembleFeatures.scala:93`): per-type column handling — numerics cast
  (with missing-value indicator + mean impute), strings token-hashed
  (`HashingTF` parity), categorical-metadata columns one-hot or indexed,
  datetime expansion, vector passthrough — then assembly.

Everything here is host-side numpy: featurization shapes the columns the
device work consumes; the heavy math downstream (GBDT/NN) runs on the
card. Output is a dense 2D float array (the reference's SparseVector
path exists for JVM memory reasons that don't apply to a columnar host
batch feeding device memory).
"""

from __future__ import annotations

import datetime as _dt
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from mmlspark_tpu_torch.core.dataframe import DataFrame, is_null
from mmlspark_tpu_torch.core import schema as S
from mmlspark_tpu_torch.core.params import Param, HasOutputCol, in_range
from mmlspark_tpu_torch.core.stage import Transformer, Estimator, Model
from mmlspark_tpu_torch.featurize.text import hash_token


class VectorAssembler(Transformer, HasOutputCol):
    """Assemble numeric scalar/vector columns into one 2D features column.

    Parity: `FastVectorAssembler.scala:23` — categorical metadata of input
    columns is preserved as categorical slots in the output metadata (and
    categorical columns are placed first, as the reference does, so slot
    indexes stay stable for tree learners).
    """

    input_cols = Param(None, "columns to assemble", ptype=list)
    cats_first = Param(True, "order categorical columns first", ptype=bool)

    def transform(self, df: DataFrame) -> DataFrame:
        names = list(self.input_cols or [])
        if self.cats_first:
            names.sort(key=lambda n: 0 if S.is_categorical(
                df.get_metadata(n)) else 1)
        parts: List[np.ndarray] = []
        slot_names: List[str] = []
        cat_slots: Dict[str, List[Any]] = {}
        for name in names:
            col = df[name]
            meta = df.get_metadata(name)
            if col.dtype == np.dtype("O"):
                col = np.stack([np.asarray(v, dtype=np.float64) for v in col])
            if col.ndim == 1:
                parts.append(col.astype(np.float64)[:, None])
                slot_names.append(name)
                levels = S.categorical_levels(meta)
                if levels is not None:
                    cat_slots[name] = list(levels)
            else:
                col = col.reshape(len(col), -1).astype(np.float64)
                parts.append(col)
                sub = (meta or {}).get("feature_names")
                if sub and len(sub) == col.shape[1]:
                    slot_names.extend(sub)
                    for s, lv in ((meta or {}).get("categorical_slots")
                                  or {}).items():
                        cat_slots[s] = list(lv)
                else:
                    slot_names.extend(f"{name}_{j}" for j in range(col.shape[1]))
        X = np.concatenate(parts, axis=1) if parts else \
            np.zeros((df.num_rows, 0))
        out_meta = S.make_features_meta(slot_names, cat_slots)
        return df.with_column(self.output_col or "features", X,
                              metadata=out_meta)


_DATE_PARTS = ("year", "month", "day", "weekday", "hour", "minute")


def _expand_datetime(epochs: np.ndarray) -> np.ndarray:
    out = np.zeros((len(epochs), len(_DATE_PARTS)), dtype=np.float64)
    for i, e in enumerate(epochs):
        if is_null(e):
            continue  # null date -> all-zero expansion (imputed downstream)
        d = _dt.datetime.fromtimestamp(int(e), tz=_dt.timezone.utc)
        out[i] = (d.year, d.month, d.day, d.weekday(), d.hour, d.minute)
    return out


class Featurize(Estimator, HasOutputCol):
    """AutoML featurization of heterogeneous columns into one feature vector.

    Parity: `Featurize.scala:24` / `AssembleFeatures.scala:93`. Per-type
    handling decided at fit time:

    - numeric: cast float64; if NaNs seen, mean-impute + append a
      ``<col>_missing`` indicator slot (the reference's missing-value
      double-columns);
    - categorical metadata present: one-hot (``one_hot_encode_categoricals``)
      or keep the index as a single categorical slot;
    - plain strings: treated as categorical below
      ``number_of_features`` distinct values, else token-hashed into
      ``number_of_features`` TF slots (HashingTF parity);
    - datetime columns (``datetime`` metadata from DataConversion): expanded
      to year/month/day/weekday/hour/minute;
    - vector (2D) columns: passthrough.
    """

    feature_columns = Param(None, "columns to featurize", ptype=list)
    number_of_features = Param(256, "hash dims for free-text columns",
                               ptype=int, validator=in_range(lo=1))
    one_hot_encode_categoricals = Param(True, "one-hot categoricals",
                                        ptype=bool)
    allow_images = Param(False, "kept for API parity (images handled by "
                         "ImageFeaturizer)", ptype=bool)

    def fit(self, df: DataFrame) -> "FeaturizeModel":
        plans: List[Dict[str, Any]] = []
        for name in self.feature_columns or []:
            col = df[name]
            meta = df.get_metadata(name)
            levels = S.categorical_levels(meta)
            if levels is not None:
                plans.append({"col": name, "kind": "categorical",
                              "levels": list(levels)})
            elif (meta or {}).get("datetime"):
                plans.append({"col": name, "kind": "datetime"})
            elif col.ndim == 1 and (
                    col.dtype.kind in ("U", "S")   # numpy str columns
                    or (col.dtype == np.dtype("O") and (
                        not len(col)
                        or isinstance(_first_non_null(col), str)))):
                distinct = {v for v in col if v is not None}
                if len(distinct) < min(self.number_of_features, 100):
                    lv = sorted(distinct)
                    plans.append({"col": name, "kind": "string_categorical",
                                  "levels": lv})
                else:
                    plans.append({"col": name, "kind": "text",
                                  "dims": self.number_of_features})
            elif col.ndim > 1 or col.dtype == np.dtype("O"):
                plans.append({"col": name, "kind": "vector"})
            else:
                vals = col.astype(np.float64)
                has_missing = bool(np.any(~np.isfinite(vals)))
                mean = float(np.mean(vals[np.isfinite(vals)])) \
                    if np.any(np.isfinite(vals)) else 0.0
                plans.append({"col": name, "kind": "numeric",
                              "has_missing": has_missing, "mean": mean})
        return FeaturizeModel(
            output_col=self.output_col or "features",
            one_hot=self.one_hot_encode_categoricals,
            plans=plans)


def _first_non_null(col):
    for v in col:
        if v is not None:
            return v
    return None


class FeaturizeModel(Model, HasOutputCol):
    """Fitted featurization (parity: `AssembleFeatures.scala:312`)."""

    plans = Param(None, "per-column featurization plans", ptype=list)
    one_hot = Param(True, "one-hot categoricals", ptype=bool)

    def transform(self, df: DataFrame) -> DataFrame:
        parts: List[np.ndarray] = []
        slot_names: List[str] = []
        cat_slots: Dict[str, List[Any]] = {}
        n = df.num_rows
        for plan in self.plans or []:
            name, kind = plan["col"], plan["kind"]
            col = df[name]
            if kind == "numeric":
                vals = col.astype(np.float64).copy()
                if plan["has_missing"]:
                    miss = ~np.isfinite(vals)
                    vals[miss] = plan["mean"]
                    parts.append(vals[:, None])
                    slot_names.append(name)
                    parts.append(miss.astype(np.float64)[:, None])
                    slot_names.append(f"{name}_missing")
                else:
                    parts.append(np.nan_to_num(vals)[:, None])
                    slot_names.append(name)
            elif kind in ("categorical", "string_categorical"):
                levels = plan["levels"]
                lookup = {lv: i for i, lv in enumerate(levels)}
                if kind == "categorical":
                    idx = col.astype(np.int64)
                else:
                    idx = np.array([lookup.get(v, -1) for v in col],
                                   dtype=np.int64)
                if self.one_hot:
                    oh = np.zeros((n, len(levels)), dtype=np.float64)
                    valid = (idx >= 0) & (idx < len(levels))
                    oh[np.arange(n)[valid], idx[valid]] = 1.0
                    parts.append(oh)
                    slot_names.extend(f"{name}={lv}" for lv in levels)
                else:
                    parts.append(idx.astype(np.float64)[:, None])
                    slot_names.append(name)
                    cat_slots[name] = list(levels)
            elif kind == "datetime":
                parts.append(_expand_datetime(col))
                slot_names.extend(f"{name}.{p}" for p in _DATE_PARTS)
            elif kind == "text":
                dims = plan["dims"]
                tf = np.zeros((n, dims), dtype=np.float64)
                for i, text in enumerate(col):
                    for tok in str(text).lower().split():
                        tf[i, hash_token(tok, dims)] += 1.0
                parts.append(tf)
                slot_names.extend(f"{name}#tf{j}" for j in range(dims))
            else:  # vector
                v = col
                if v.dtype == np.dtype("O"):
                    v = np.stack([np.asarray(x, dtype=np.float64) for x in v])
                parts.append(v.reshape(n, -1).astype(np.float64))
                slot_names.extend(
                    f"{name}_{j}" for j in range(parts[-1].shape[1]))
        X = np.concatenate(parts, axis=1) if parts else np.zeros((n, 0))
        meta = S.make_features_meta(slot_names, cat_slots)
        return df.with_column(self.output_col or "features", X, metadata=meta)
