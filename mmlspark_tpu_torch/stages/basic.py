"""Small DataFrame operations packaged as pipeline stages (the port's
copy of ``mmlspark_tpu/stages/basic.py``).

Capability parity with the reference's `src/pipeline-stages` module
(`pipeline-stages/src/main/scala/*.scala`): tiny, composable frame→frame
stages so whole workflows serialize as one Pipeline. Also hosts the
multi-column adapter (`multi-column-adapter/MultiColumnAdapter.scala:17`),
partition sampling (`partition-sample/PartitionSample.scala:141`), dataset
checkpointing (`checkpoint-data/CheckpointData.scala:49`), and key-grouped
ensembling (`ensemble/EnsembleByKey.scala:21`).

These run host-side on the columnar frame (pure numpy): they shape data
*around* device work and touch no device. ``EnsembleByKey``'s
grouped averaging is the only numeric hot spot and uses vectorized
segment-sums rather than per-group Python loops.
"""

from __future__ import annotations

import os
import unicodedata
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

from mmlspark_tpu_torch.core.dataframe import DataFrame, py_scalar as _py, \
    is_null as _is_null, obj_col as _obj_col
from mmlspark_tpu_torch.core.params import (
    Param, HasInputCol, HasInputCols, HasOutputCol, HasOutputCols,
    HasLabelCol, in_set, in_range,
)
from mmlspark_tpu_torch.core.stage import (
    Transformer, Estimator, Model, PipelineStage,
)
# re-exported here because this module is the parity home of the
# reference's pipeline-stages (`Timer.scala:14-90`): the Timer wraps any
# stage, logs its fit/transform wall-clock, AND records every span into
# the process-wide metrics registry (pipeline_stage_duration_ms), so
# batch pipelines and the serving plane report through one telemetry
# surface — see docs/observability.md
from mmlspark_tpu_torch.core.stage import Timer, TimerModel  # noqa: F401


class DropColumns(Transformer):
    """Drop the listed columns (`pipeline-stages/DropColumns.scala`)."""

    cols = Param(None, "columns to drop", ptype=list)

    def transform(self, df: DataFrame) -> DataFrame:
        return df.drop(*(self.cols or []))


class SelectColumns(Transformer):
    """Keep only the listed columns (`pipeline-stages/SelectColumns.scala`)."""

    cols = Param(None, "columns to keep", ptype=list)

    def transform(self, df: DataFrame) -> DataFrame:
        return df.select(self.cols or [])


class RenameColumn(Transformer, HasInputCol, HasOutputCol):
    """Rename one column (`pipeline-stages/RenameColumn.scala`)."""

    def transform(self, df: DataFrame) -> DataFrame:
        return df.rename({self.input_col: self.output_col})


class ScaleColumn(Transformer, HasInputCol, HasOutputCol):
    """``output_col = input_col * scale + offset`` — a fully persistable
    arithmetic stage (all-JSON params, no complex state).

    Exists for pipelines that need a cheap numeric map, and as the
    canonical *versionable* serving model: two saved ``ScaleColumn``
    checkpoints with different ``scale`` are distinguishable model
    versions, which the rollout tests and ``tools/chaos_serving.py``'s
    kill-mid-rollout drill stage and flip through real checkpoint
    directories (see docs/serving.md "Zero-downtime rollout")."""

    scale = Param(1.0, "multiplier", ptype=float)
    offset = Param(0.0, "additive constant", ptype=float)

    def transform(self, df: DataFrame) -> DataFrame:
        x = np.asarray(df[self.input_col], dtype=np.float64)
        return df.with_column(self.output_col,
                              x * float(self.scale) + float(self.offset))


class Repartition(Transformer):
    """Reorder rows so ``n`` contiguous shards are statistically similar.

    Parity: `pipeline-stages/Repartition.scala`. The columnar frame has no
    partitions — sharding happens at device dispatch — so the only
    observable effect of a Spark round-robin repartition worth keeping is
    the row dispersal itself (``disperse=True``); with ``disperse=False``
    this is an identity stage kept for pipeline API compatibility.
    """

    n = Param(None, "number of shards", ptype=int, validator=in_range(lo=1))
    disperse = Param(False, "round-robin disperse rows across shards", ptype=bool)

    def transform(self, df: DataFrame) -> DataFrame:
        n = self.n or 1
        if self.disperse and df.num_rows:
            order = np.argsort(np.arange(df.num_rows) % n, kind="stable")
            df = df.take(order)
        return df


class Cacher(Transformer):
    """Materialize the frame (`pipeline-stages/Cacher.scala`).

    Frames here are eager numpy, so caching means ensuring every column is
    a contiguous owned array (detaching views/lazy wrappers).
    """

    def transform(self, df: DataFrame) -> DataFrame:
        data = {k: np.ascontiguousarray(v) if v.dtype != np.dtype("O")
                else v for k, v in df.to_dict().items()}
        return df._derive(data)


class CheckpointData(Transformer):
    """Persist the frame to disk and return the reloaded copy.

    Parity: `checkpoint-data/CheckpointData.scala:49` (cache/persist with a
    storage level). Disk round-trip truncates upstream lineage the way a
    Spark checkpoint does and gives a restartable artifact.
    """

    path = Param(None, "directory to checkpoint into", ptype=str)
    remove_checkpoint = Param(False, "delete the checkpoint after reload",
                              ptype=bool)

    def transform(self, df: DataFrame) -> DataFrame:
        path = self.path
        os.makedirs(path, exist_ok=True)
        df.save(os.path.join(path, "frame.npz"))
        out = DataFrame.load(os.path.join(path, "frame.npz"))
        if self.remove_checkpoint:
            os.remove(os.path.join(path, "frame.npz"))
            meta_path = os.path.join(path, "frame.meta.json")
            if os.path.exists(meta_path):
                os.remove(meta_path)
        return out


class Explode(Transformer, HasInputCol, HasOutputCol):
    """Explode a list-valued column into one row per element.

    Parity: `pipeline-stages/Explode.scala`.
    """

    def transform(self, df: DataFrame) -> DataFrame:
        col = df[self.input_col]
        lengths = np.array([len(v) for v in col], dtype=np.int64)
        idx = np.repeat(np.arange(df.num_rows), lengths)
        flat: List[Any] = [item for v in col for item in v]
        out = df.take(idx)
        return out.with_column(self.output_col or self.input_col, flat)


class Lambda(Transformer):
    """Arbitrary frame→frame function as a stage.

    Parity: `pipeline-stages/Lambda.scala` (arbitrary df→df function).
    The function is a complex param persisted via cloudpickle-free source
    capture is NOT attempted — like the reference's UDF params, a loaded
    Lambda requires re-supplying the function.
    """

    transform_fn = Param(None, "frame -> frame function", complex=True)

    def transform(self, df: DataFrame) -> DataFrame:
        return self.transform_fn(df)


class UDFTransformer(Transformer, HasInputCol, HasInputCols, HasOutputCol):
    """Apply a per-value (or per-row-tuple) function to produce a column.

    Parity: `pipeline-stages/UDFTransformer.scala`. With ``input_col`` the
    udf maps value→value; with ``input_cols`` it maps (v1, v2, ...)→value.
    ``vectorized=True`` passes whole numpy arrays instead (the
    device-friendly path — hand the udf arrays, let it call torch itself).
    """

    udf = Param(None, "the function to apply", complex=True)
    vectorized = Param(False, "pass whole columns instead of scalars", ptype=bool)

    def transform(self, df: DataFrame) -> DataFrame:
        fn = self.udf
        if self.input_cols:
            cols = [df[c] for c in self.input_cols]
            if self.vectorized:
                values = fn(*cols)
            else:
                values = [fn(*vals) for vals in zip(*cols)]
        else:
            col = df[self.input_col]
            values = fn(col) if self.vectorized else [fn(v) for v in col]
        return df.with_column(self.output_col, values)


class _Trie:
    """Character trie for longest-match find/replace."""

    __slots__ = ("children", "value")

    def __init__(self):
        self.children: Dict[str, "_Trie"] = {}
        self.value: Optional[str] = None

    def put(self, key: str, value: str) -> None:
        node = self
        for ch in key:
            node = node.children.setdefault(ch, _Trie())
        node.value = value

    def longest_match(self, text: str, start: int):
        node, best = self, None
        for i in range(start, len(text)):
            node = node.children.get(text[i])
            if node is None:
                break
            if node.value is not None:
                best = (i + 1, node.value)
        return best


class TextPreprocessor(Transformer, HasInputCol, HasOutputCol):
    """Trie-based longest-match find/replace over strings.

    Parity: `pipeline-stages/TextPreprocessor.scala:14` (trie find/replace
    with an optional normalization function applied first).
    """

    map = Param(None, "substring -> replacement map", ptype=dict)
    norm_func = Param("identity", "normalization applied before matching",
                      validator=in_set("identity", "lowercase"))

    def transform(self, df: DataFrame) -> DataFrame:
        trie = _Trie()
        for k, v in (self.map or {}).items():
            trie.put(k, v)
        lower = self.norm_func == "lowercase"

        def process(text: str) -> str:
            if lower:
                text = text.lower()
            out, i = [], 0
            while i < len(text):
                m = trie.longest_match(text, i)
                if m is None:
                    out.append(text[i])
                    i += 1
                else:
                    i, val = m
                    out.append(val)
            return "".join(out)

        values = [process(str(v)) for v in df[self.input_col]]
        return df.with_column(self.output_col, values)


class UnicodeNormalize(Transformer, HasInputCol, HasOutputCol):
    """Unicode-normalize strings (`pipeline-stages/UnicodeNormalize.scala`)."""

    form = Param("NFKD", "unicode normal form",
                 validator=in_set("NFC", "NFD", "NFKC", "NFKD"))
    lower = Param(True, "lowercase after normalizing", ptype=bool)

    def transform(self, df: DataFrame) -> DataFrame:
        def norm(v):
            s = unicodedata.normalize(self.form, str(v))
            return s.lower() if self.lower else s
        return df.with_column(self.output_col,
                              [norm(v) for v in df[self.input_col]])


class ClassBalancer(Estimator, HasInputCol, HasOutputCol):
    """Compute inverse-frequency class weights as a column.

    Parity: `pipeline-stages/ClassBalancer.scala` — fit counts each level of
    ``input_col`` and emits weight = max_count / count; the model joins the
    weight back per row (feeds ``HasWeightCol`` learners).
    """

    broadcast_join = Param(True, "unused; kept for API parity", ptype=bool)

    def fit(self, df: DataFrame) -> "ClassBalancerModel":
        from collections import Counter
        counts = Counter(_py(v) for v in df[self.input_col])
        top = max(counts.values())
        levels = sorted(counts, key=lambda v: (isinstance(v, str), str(v)))
        weights = [top / counts[lv] for lv in levels]
        return ClassBalancerModel(
            input_col=self.input_col,
            output_col=self.output_col or "weight",
        )._with_table(levels, weights)


class ClassBalancerModel(Model, HasInputCol, HasOutputCol):
    levels = Param(None, "class levels", ptype=list)
    weights = Param(None, "per-level weights", ptype=list)

    def _with_table(self, levels: List[Any], weights: List[float]):
        self.set(levels=levels, weights=weights)
        return self

    def transform(self, df: DataFrame) -> DataFrame:
        table = {lv: w for lv, w in zip(self.levels, self.weights)}
        col = df[self.input_col]
        out = np.array([table[_py(v)] for v in col], dtype=np.float64)
        return df.with_column(self.output_col or "weight", out)


class PartitionSample(Transformer):
    """Head / random-sample row selection as a stage.

    Parity: `partition-sample/PartitionSample.scala:141` (modes: head,
    random sample, assign-to-partition). The partition-assignment mode maps
    to tagging rows with a shard id column.
    """

    mode = Param("randomSample", "sampling mode",
                 validator=in_set("head", "randomSample", "assignToPartition"))
    count = Param(1000, "rows for head mode", ptype=int)
    percent = Param(0.1, "fraction for randomSample", ptype=float,
                    validator=in_range(0.0, 1.0))
    seed = Param(0, "rng seed", ptype=int)
    new_col_name = Param("Partition", "shard-id column for assignToPartition",
                         ptype=str)
    num_parts = Param(10, "shards for assignToPartition", ptype=int)

    def transform(self, df: DataFrame) -> DataFrame:
        if self.mode == "head":
            return df.head(self.count)
        if self.mode == "randomSample":
            return df.sample(self.percent, seed=self.seed)
        rng = np.random.default_rng(self.seed)
        ids = rng.integers(0, self.num_parts, size=df.num_rows)
        return df.with_column(self.new_col_name, ids.astype(np.int64))


class MultiColumnAdapter(Transformer):
    """Apply a single-column stage across many column pairs.

    Parity: `multi-column-adapter/MultiColumnAdapter.scala:17`. The base
    stage must expose ``input_col``/``output_col`` params; it is copied per
    column pair. Estimator bases: use :class:`MultiColumnAdapterEstimator`.
    """

    base_stage = Param(None, "the single-column stage to replicate", complex=True)
    input_cols = Param(None, "input columns", ptype=list)
    output_cols = Param(None, "output columns", ptype=list)

    def _pairs(self):
        ins, outs = self.input_cols or [], self.output_cols or []
        if len(ins) != len(outs):
            raise ValueError("input_cols and output_cols must align")
        return list(zip(ins, outs))

    def transform(self, df: DataFrame) -> DataFrame:
        for i, o in self._pairs():
            df = self.base_stage.copy(input_col=i, output_col=o).transform(df)
        return df

    def _save_extra(self, path, arrays):
        self._save_substage(path, "base_stage")

    def _load_extra(self, path, arrays):
        self._load_substage(path, "base_stage")


class EnsembleByKey(Transformer):
    """Group rows by key column(s); average (or collect) value columns.

    Parity: `ensemble/EnsembleByKey.scala:21` — used to ensemble per-model
    scores sharing an id. Vector and scalar columns both average; string
    strategy is "collect". Uses ``np.add.at`` segment sums, no per-group
    Python loop.
    """

    keys = Param(None, "key columns", ptype=list)
    cols = Param(None, "value columns to aggregate", ptype=list)
    strategy = Param("mean", "aggregation strategy", validator=in_set("mean"))
    collapse_group = Param(True, "one row per key (vs broadcast back)", ptype=bool)
    vector_dims = Param(None, "unused; API parity", ptype=dict)

    def transform(self, df: DataFrame) -> DataFrame:
        keys = self.keys or []
        key_tuples = list(zip(*[df[k] for k in keys]))
        uniq: Dict[tuple, int] = {}
        group = np.empty(df.num_rows, dtype=np.int64)
        for row_i, kt in enumerate(key_tuples):
            kt = tuple(_py(v) for v in kt)
            group[row_i] = uniq.setdefault(kt, len(uniq))
        n_groups = len(uniq)
        counts = np.bincount(group, minlength=n_groups).astype(np.float64)

        data: Dict[str, Any] = {}
        meta: Dict[str, Any] = {}
        for j, k in enumerate(keys):
            vals = [kt[j] for kt in uniq.keys()]
            data[k] = vals if vals and isinstance(vals[0], str) else np.asarray(vals)
        for c in self.cols or []:
            col = df[c]
            if col.dtype == np.dtype("O"):
                collected: List[List[Any]] = [[] for _ in range(n_groups)]
                for g, v in zip(group, col):
                    collected[g].append(v)
                data[f"{c}_collected"] = _obj_col(collected)
                continue
            sums = np.zeros((n_groups,) + col.shape[1:], dtype=np.float64)
            np.add.at(sums, group, col.astype(np.float64))
            denom = counts.reshape((n_groups,) + (1,) * (col.ndim - 1))
            data[f"{c}_mean"] = sums / np.maximum(denom, 1.0)
            if df.get_metadata(c):
                meta[f"{c}_mean"] = dict(df.get_metadata(c))

        out = DataFrame(data, metadata=meta)
        if self.collapse_group:
            return out
        joined = df
        for name in out.columns:
            if name in keys:
                continue
            col = out[name]
            if col.dtype == np.dtype("O"):
                joined = joined.with_column(
                    name, _obj_col([col[g] for g in group]))
            else:
                joined = joined.with_column(name, col[group])
        return joined


class SummarizeData(Transformer):
    """Per-column counts / basic stats / percentiles as a frame.

    Parity: `summarize-data/SummarizeData.scala:99` (counts, basic stats,
    sample percentiles; error-threshold param kept for API parity — the
    percentiles here are exact).
    """

    counts = Param(True, "include count/unique/missing", ptype=bool)
    basic = Param(True, "include mean/std/min/max", ptype=bool)
    percentiles = Param(True, "include p0.5/1/5/25/50/75/95/99/99.5", ptype=bool)
    error_threshold = Param(0.0, "approximation error (exact here)", ptype=float)

    _PCTS = [0.5, 1, 5, 25, 50, 75, 95, 99, 99.5]

    def transform(self, df: DataFrame) -> DataFrame:
        rows: List[Dict[str, Any]] = []
        for name in df.columns:
            col = df[name]
            row: Dict[str, Any] = {"Feature": name}
            is_num = col.dtype != np.dtype("O") and col.ndim == 1 \
                and col.dtype.kind in "bifu"
            vals = col.astype(np.float64) if is_num else None
            finite = vals[np.isfinite(vals)] if is_num else None
            if self.counts:
                row["Count"] = float(len(col))
                if is_num:
                    row["Unique Value Count"] = float(len(np.unique(col)))
                    row["Missing Value Count"] = float(np.sum(~np.isfinite(vals)))
                else:
                    row["Unique Value Count"] = float(len(set(map(str, col))))
                    row["Missing Value Count"] = float(
                        sum(_is_null(v) for v in col))
            if self.basic:
                row["Mean"] = float(np.mean(finite)) if is_num and len(finite) else float("nan")
                row["Standard Deviation"] = (
                    float(np.std(finite, ddof=1)) if is_num and len(finite) > 1
                    else float("nan"))
                row["Min"] = float(np.min(finite)) if is_num and len(finite) else float("nan")
                row["Max"] = float(np.max(finite)) if is_num and len(finite) else float("nan")
            if self.percentiles:
                for p in self._PCTS:
                    key = f"P{p}"
                    row[key] = (float(np.percentile(finite, p))
                                if is_num and len(finite) else float("nan"))
            rows.append(row)
        return DataFrame.from_rows(rows)
