"""Stage persistence: JSON params + npz arrays in a directory.

Capability parity with the reference's save/load machinery (Spark ML
persistence extended by `ComplexParamsWritable`/`ConstructorWritable`,
`core/serialize/src/main/scala/`): every stage saves to a directory with
``metadata.json`` (class name, version, JSON params) and, when needed,
``arrays.npz`` plus stage-specific extra files written by ``_save_extra``.

Integrity: every save finishes by writing a SHA-256 manifest
(``checkpoint.sha256.json``, :mod:`mmlspark_tpu_torch.io.checkpoint`) over the
whole checkpoint tree; every load verifies it. A corrupted/truncated
checkpoint raises :class:`~mmlspark_tpu_torch.io.checkpoint.
CheckpointIntegrityError` instead of loading garbage weights; a
digest-less legacy checkpoint loads with a warning (backward compat).
The serving rollout path additionally requires a *present and valid*
manifest before a model version becomes flip-eligible.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Any, Dict, Optional

import numpy as np

from mmlspark_tpu_torch.core import registry
from mmlspark_tpu_torch.version import __version__

#: nesting depth of in-flight load_stage calls (per thread): the
#: top-level manifest covers the whole tree, so only depth 0 verifies
_LOAD_DEPTH = threading.local()

METADATA_FILE = "metadata.json"
ARRAYS_FILE = "arrays.npz"


def save_stage(stage, path: str) -> None:
    os.makedirs(path, exist_ok=True)
    meta: Dict[str, Any] = {
        "class": f"{type(stage).__module__}.{type(stage).__qualname__}",
        "framework_version": __version__,
        "uid": stage.uid,
        "params": _jsonify(stage._json_params()),
    }
    arrays: Dict[str, np.ndarray] = {}
    stage._save_extra(path, arrays)
    if arrays:
        np.savez_compressed(os.path.join(path, ARRAYS_FILE), **arrays)
    with open(os.path.join(path, METADATA_FILE), "w") as f:
        json.dump(meta, f, indent=2, default=_json_default)
    # the digest manifest goes LAST: an interrupted save leaves a
    # missing/stale manifest, never a valid-looking one over torn files
    from mmlspark_tpu_torch.io import checkpoint as _ckpt
    _ckpt.write_digest(path)


#: the device stages load onto when their loader names none (set once
#: by a process that serves on the CPU, ``serving/__main__.py``)
_DEFAULT_LOAD_DEVICE: Optional[str] = None


def set_default_load_device(device: Optional[str]) -> None:
    """Every later :func:`load_stage` that names no device places the
    stages it loads (nested ones included) on ``device``."""
    global _DEFAULT_LOAD_DEVICE
    _DEFAULT_LOAD_DEVICE = None if device is None else str(device)


def load_stage(path: str, verify: bool = True,
               device: Optional[str] = None):
    """Load the stage saved under ``path``. ``device`` is set on every
    stage of the tree that takes one (``HasDevice``) before its
    ``_load_extra`` runs; ``None`` keeps the default load device (none:
    the card)."""
    # A manifest pins the WHOLE tree under its directory (substage
    # subdirectories included), so the top-level verification already
    # covered every nested checkpoint: nested loads (Pipeline stages,
    # wrapper substages — they re-enter here via PipelineStage.load)
    # skip re-hashing, or a depth-k pipeline would hash its leaves
    # k+1 times. Thread-local so concurrent loads can't cross-talk.
    depth = getattr(_LOAD_DEPTH, "n", 0)
    if verify and depth == 0:
        from mmlspark_tpu_torch.io import checkpoint as _ckpt
        ok, detail = _ckpt.verify_digest(path, strict=False)
        if not ok:
            raise _ckpt.CheckpointIntegrityError(
                f"checkpoint {path} failed integrity verification: "
                f"{detail}")
    outer_device = getattr(_LOAD_DEPTH, "device", None)
    _LOAD_DEPTH.n = depth + 1
    if device is not None:
        _LOAD_DEPTH.device = str(device)
    elif depth == 0:
        _LOAD_DEPTH.device = _DEFAULT_LOAD_DEVICE
    try:
        return _load_stage_inner(path)
    finally:
        _LOAD_DEPTH.n = depth
        _LOAD_DEPTH.device = outer_device


def _load_stage_inner(path: str):
    with open(os.path.join(path, METADATA_FILE)) as f:
        meta = json.load(f)
    cls = registry.resolve(meta["class"])
    stage = cls.__new__(cls)
    stage._param_values = {}
    stage._uid = meta.get("uid")
    stage.set(**meta.get("params", {}))
    device = getattr(_LOAD_DEPTH, "device", None)
    if device is not None and "device" in cls.params():
        stage.device = device
    arrays: Dict[str, np.ndarray] = {}
    npz_path = os.path.join(path, ARRAYS_FILE)
    if os.path.exists(npz_path):
        with np.load(npz_path, allow_pickle=True) as npz:
            arrays = {k: npz[k] for k in npz.files}
    stage._load_extra(path, arrays)
    return stage


def _jsonify(obj: Any) -> Any:
    if isinstance(obj, dict):
        return {k: _jsonify(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonify(v) for v in obj]
    return _json_default(obj) if isinstance(obj, (np.generic, np.ndarray)) else obj


def _json_default(obj: Any) -> Any:
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.floating):
        return float(obj)
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    raise TypeError(f"not JSON serializable: {type(obj)}")
