"""Column metadata: categorical levels and ML column roles.

Capability parity with the reference's column-metadata machinery
(`core/schema/src/main/scala/Categoricals.scala`, `SparkSchema.scala`,
`SchemaConstants.scala`): categorical levels ride along with columns, and
trained models tag their score columns with roles so downstream evaluators
can autodetect them (`ComputeModelStatistics.scala:57`).

Metadata here is a plain JSON-able dict attached per column on a
:class:`~mmlspark_tpu_torch.core.dataframe.DataFrame`.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

# ---------------------------------------------------------------------------
# Schema constants (parity: core/schema/src/main/scala/SchemaConstants.scala)
# ---------------------------------------------------------------------------

SCORES_KIND = "scores"
SCORED_LABELS_KIND = "scored_labels"
SCORED_PROBABILITIES_KIND = "scored_probabilities"
LABEL_KIND = "label"

CLASSIFICATION = "classification"
REGRESSION = "regression"

MML_TAG = "mml"  # namespace key inside column metadata


# ---------------------------------------------------------------------------
# Categorical metadata (parity: Categoricals.scala:16,178,295)
# ---------------------------------------------------------------------------

def make_categorical_meta(levels: Sequence[Any], ordinal: bool = False,
                          has_null_level: bool = False) -> Dict[str, Any]:
    """Build categorical metadata recording the distinct levels of a column."""
    return {
        "categorical": True,
        "levels": list(levels),
        "ordinal": bool(ordinal),
        "has_null_level": bool(has_null_level),
    }


def is_categorical(meta: Optional[Dict[str, Any]]) -> bool:
    return bool(meta) and bool(meta.get("categorical"))


def categorical_levels(meta: Optional[Dict[str, Any]]) -> Optional[List[Any]]:
    if not is_categorical(meta):
        return None
    return meta.get("levels")


# ---------------------------------------------------------------------------
# Score-column roles (parity: SparkSchema.scala set/get*ColumnName)
# ---------------------------------------------------------------------------

def make_role_meta(kind: str, model_uid: str, task: Optional[str] = None) -> Dict[str, Any]:
    """Tag a column with an ML role produced by a given model."""
    meta: Dict[str, Any] = {"role": kind, "model_uid": model_uid}
    if task is not None:
        meta["task"] = task
    return meta


def column_role(meta: Optional[Dict[str, Any]]) -> Optional[str]:
    return meta.get("role") if meta else None


def find_column_by_role(df, kind: str, model_uid: Optional[str] = None) -> Optional[str]:
    """Find a column tagged with the given role (optionally for a given model)."""
    for name in df.columns:
        meta = df.get_metadata(name)
        if not meta:
            continue
        if meta.get("role") != kind:
            continue
        if model_uid is not None and meta.get("model_uid") != model_uid:
            continue
        return name
    return None


def find_unused_column_name(prefix: str, df) -> str:
    """Parity: DatasetExtensions.findUnusedColumnName."""
    name = prefix
    i = 0
    existing = set(df.columns)
    while name in existing:
        i += 1
        name = f"{prefix}_{i}"
    return name


# ---------------------------------------------------------------------------
# Feature-vector slot names (parity: vector-assembler attribute metadata)
# ---------------------------------------------------------------------------

def make_features_meta(slot_names: Sequence[str],
                       categorical_slots: Optional[Dict[str, List[Any]]] = None) -> Dict[str, Any]:
    """Metadata for an assembled feature-vector column.

    ``categorical_slots`` maps slot name -> levels, preserving categorical
    information through assembly (parity: FastVectorAssembler keeping
    categorical metadata up front, `FastVectorAssembler.scala:23`).
    """
    return {
        "feature_names": list(slot_names),
        "categorical_slots": dict(categorical_slots or {}),
    }


def categorical_slot_indexes(meta: Optional[Dict[str, Any]]) -> List[int]:
    """Indexes of categorical slots inside an assembled feature vector."""
    if not meta:
        return []
    names = meta.get("feature_names") or []
    cats = meta.get("categorical_slots") or {}
    return [i for i, n in enumerate(names) if n in cats]
