"""Data-preparation estimators: indexing, imputation, type conversion
(the port's copy of ``mmlspark_tpu/stages/prep.py``).

Capability parity with the reference's data-prep modules:
- ``ValueIndexer``/``IndexToValue`` — typed, null-ordering-aware categorical
  indexing with inverse (`value-indexer/ValueIndexer.scala:54,101`,
  `IndexToValue.scala:26`, null ordering at `ValueIndexer.scala:38`).
- ``CleanMissingData`` — per-column mean/median/custom imputation
  (`clean-missing-data/CleanMissingData.scala:46,127`).
- ``DataConversion`` — column type conversion + date formatting
  (`data-conversion/DataConversion.scala:23`).

These run host-side (numpy) and stamp categorical metadata so downstream
AutoML featurization and the GBDT engine see the levels
(`core/schema/Categoricals.scala` parity via ``core.schema``).
"""

from __future__ import annotations

import datetime as _dt
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from mmlspark_tpu_torch.core.dataframe import DataFrame, py_scalar as _py, \
    is_null as _is_null, obj_col as _obj_col
from mmlspark_tpu_torch.core.params import (
    Param, HasInputCol, HasOutputCol, in_set,
)
from mmlspark_tpu_torch.core import schema as S
from mmlspark_tpu_torch.core.stage import Transformer, Estimator, Model


class ValueIndexer(Estimator, HasInputCol, HasOutputCol):
    """Index a column's distinct values to [0, n) with typed level metadata.

    Parity: `value-indexer/ValueIndexer.scala:54` — levels are sorted in
    the column's natural order with nulls placed per ``null_ordering``
    (`ValueIndexer.scala:38`); the output column carries categorical
    metadata consumed by `IndexToValue` and AutoML featurization.
    """

    null_ordering = Param("nullsFirst", "where nulls sort",
                          validator=in_set("nullsFirst", "nullsLast", "none"))

    def fit(self, df: DataFrame) -> "ValueIndexerModel":
        col = df[self.input_col]
        values = [_py(v) for v in col]
        non_null = sorted({v for v in values if not _is_null(v)},
                          key=lambda v: (isinstance(v, str), v))
        has_null = any(_is_null(v) for v in values)
        levels: List[Any] = list(non_null)
        if has_null and self.null_ordering != "none":
            if self.null_ordering == "nullsFirst":
                levels = [None] + levels
            else:
                levels = levels + [None]
        return ValueIndexerModel(
            input_col=self.input_col,
            output_col=self.output_col or f"{self.input_col}_indexed",
            levels=levels,
        )


class ValueIndexerModel(Model, HasInputCol, HasOutputCol):
    """Parity: `ValueIndexer.scala:101` (ValueIndexerModel)."""

    levels = Param(None, "ordered category levels (None = null level)",
                   ptype=list)

    def transform(self, df: DataFrame) -> DataFrame:
        levels = self.levels or []
        lookup = {lv: i for i, lv in enumerate(levels) if lv is not None}
        null_index = levels.index(None) if None in levels else -1
        col = df[self.input_col]
        out = np.empty(len(col), dtype=np.int64)
        for i, v in enumerate(col):
            v = _py(v)
            if _is_null(v):
                if null_index < 0:
                    raise ValueError(
                        f"null in column {self.input_col!r} but no null level")
                out[i] = null_index
            else:
                if v not in lookup:
                    raise ValueError(
                        f"unseen value {v!r} in column {self.input_col!r}")
                out[i] = lookup[v]
        meta = S.make_categorical_meta(
            levels, has_null_level=None in levels)
        return df.with_column(self.output_col, out, metadata=meta)


class IndexToValue(Transformer, HasInputCol, HasOutputCol):
    """Map an indexed column back to its original values.

    Parity: `value-indexer/IndexToValue.scala:26` — reads the categorical
    levels from column metadata.
    """

    def transform(self, df: DataFrame) -> DataFrame:
        meta = df.get_metadata(self.input_col)
        levels = S.categorical_levels(meta)
        if levels is None:
            raise ValueError(
                f"column {self.input_col!r} has no categorical metadata")
        col = df[self.input_col].astype(np.int64)
        values = [levels[i] for i in col]
        return df.with_column(self.output_col, values)


class CleanMissingData(Estimator):
    """Impute missing values per column: mean / median / custom constant.

    Parity: `clean-missing-data/CleanMissingData.scala:46`. Fit computes the
    replacement per input column over finite values; the model fills NaN/None.
    """

    input_cols = Param(None, "columns to clean", ptype=list)
    output_cols = Param(None, "output columns (default: in place)", ptype=list)
    cleaning_mode = Param("Mean", "imputation mode",
                          validator=in_set("Mean", "Median", "Custom"))
    custom_value = Param(None, "replacement for Custom mode")

    def fit(self, df: DataFrame) -> "CleanMissingDataModel":
        fills: List[float] = []
        for name in self.input_cols or []:
            col = df[name]
            if col.dtype == np.dtype("O"):
                vals = np.array([v for v in col if not _is_null(v)],
                                dtype=np.float64)
            else:
                vals = col.astype(np.float64)
                vals = vals[np.isfinite(vals)]
            if self.cleaning_mode == "Mean":
                fill = float(np.mean(vals)) if len(vals) else 0.0
            elif self.cleaning_mode == "Median":
                fill = float(np.median(vals)) if len(vals) else 0.0
            else:
                fill = float(self.custom_value)
            fills.append(fill)
        return CleanMissingDataModel(
            input_cols=list(self.input_cols or []),
            output_cols=list(self.output_cols or self.input_cols or []),
            fill_values=fills,
        )


class CleanMissingDataModel(Model):
    """Parity: `CleanMissingData.scala:127` (CleanMissingDataModel)."""

    input_cols = Param(None, "columns to clean", ptype=list)
    output_cols = Param(None, "output columns", ptype=list)
    fill_values = Param(None, "per-column replacement values", ptype=list)

    def transform(self, df: DataFrame) -> DataFrame:
        for name, out_name, fill in zip(self.input_cols, self.output_cols,
                                        self.fill_values):
            col = df[name]
            if col.dtype == np.dtype("O"):
                vals = np.array([fill if _is_null(v) else float(v)
                                 for v in col], dtype=np.float64)
            else:
                vals = col.astype(np.float64).copy()
                vals[~np.isfinite(vals)] = fill
            df = df.with_column(out_name, vals)
        return df


_CONVERSIONS = {
    "boolean": np.bool_,
    "byte": np.int8,
    "short": np.int16,
    "integer": np.int32,
    "long": np.int64,
    "float": np.float32,
    "double": np.float64,
    "string": None,   # handled specially
    "date": None,     # handled specially
    "toCategorical": None,
    "clearCategorical": None,
}


class DataConversion(Transformer):
    """Convert column types; parse/format dates; toggle categorical metadata.

    Parity: `data-conversion/DataConversion.scala:23` — ``convert_to`` is one
    of boolean/byte/short/integer/long/float/double/string/date/
    toCategorical/clearCategorical; ``date_time_format`` is a strptime/
    strftime pattern for the date conversions.
    """

    cols = Param(None, "columns to convert", ptype=list)
    convert_to = Param("double", "target type",
                       validator=in_set(*_CONVERSIONS))
    date_time_format = Param("%Y-%m-%d %H:%M:%S", "date parse/format pattern",
                             ptype=str)

    def transform(self, df: DataFrame) -> DataFrame:
        for name in self.cols or []:
            df = self._convert(df, name)
        return df

    def _convert(self, df: DataFrame, name: str) -> DataFrame:
        col = df[name]
        target = self.convert_to
        if target == "toCategorical":
            model = ValueIndexer(input_col=name, output_col=name).fit(df)
            return model.transform(df)
        if target == "clearCategorical":
            meta = df.get_metadata(name)
            levels = S.categorical_levels(meta)
            if levels is not None:
                values = [levels[int(i)] for i in col]
                return df.with_column(name, values, metadata={})
            return df.with_metadata(name, {})
        if target == "string":
            if col.dtype == np.dtype("O"):
                values = [None if _is_null(v) else str(v) for v in col]
            elif np.issubdtype(col.dtype, np.floating):
                values = [repr(float(v)) for v in col]
            else:
                values = [str(v.item() if isinstance(v, np.generic) else v)
                          for v in col]
            return df.with_column(name, values)
        if target == "date":
            fmt = self.date_time_format
            if col.dtype == np.dtype("O"):
                # string -> epoch seconds; nulls become NaN
                values = np.array(
                    [np.nan if _is_null(v) else
                     _dt.datetime.strptime(str(v), fmt)
                     .replace(tzinfo=_dt.timezone.utc).timestamp()
                     for v in col], dtype=np.float64)
                if not np.any(np.isnan(values)):
                    values = values.astype(np.int64)
                return df.with_column(name, values,
                                      metadata={"datetime": True})
            # numeric epoch seconds -> formatted string; nulls become None
            values = _obj_col([
                None if _is_null(_py(v)) else
                _dt.datetime.fromtimestamp(int(v), tz=_dt.timezone.utc)
                .strftime(fmt) for v in col])
            return df.with_column(name, values)
        np_type = _CONVERSIONS[target]
        if col.dtype == np.dtype("O"):
            def parse(v):
                if _is_null(v):
                    return np.nan if np_type in (np.float32, np.float64) else 0
                if target == "boolean" and isinstance(v, str):
                    return v.strip().lower() in ("true", "1", "yes")
                return float(v) if np_type in (np.float32, np.float64) \
                    else int(float(v))
            arr = np.array([parse(v) for v in col], dtype=np_type)
        else:
            arr = col.astype(np_type)
        return df.with_column(name, arr)
