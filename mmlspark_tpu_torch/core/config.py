"""Namespaced runtime configuration.

Parity: `core/env/src/main/scala/Configuration.scala:18-50` — the
reference layers typesafe-config namespaces (``mmlspark.sdk``, ``.cntk``,
``.tlc``) over defaults. Here three layers, lowest to highest
precedence:

1. code defaults registered via :func:`register_defaults`,
2. a JSON file named by ``$MMLSPARK_TPU_CONFIG``,
3. environment variables ``MMLSPARK_TPU_<NAMESPACE>_<KEY>`` (upper-case,
   values parsed as JSON when possible, else kept as strings).

Usage::

    from mmlspark_tpu_torch.core.config import MMLConfig
    cfg = MMLConfig.get("serving")      # the namespace dict
    port = cfg.get("port", 8890)
"""

from __future__ import annotations

import json
import os
import threading
from typing import Any, Dict

_lock = threading.Lock()
_defaults: Dict[str, Dict[str, Any]] = {}
_ENV_PREFIX = "MMLSPARK_TPU_"
_RESERVED = {"CONFIG", "NATIVE", "TEST", "EXAMPLE", "DRYRUN"}  # non-config vars


def register_defaults(namespace: str, values: Dict[str, Any]) -> None:
    """Layer-1 defaults for a namespace (later calls merge over earlier)."""
    with _lock:
        _defaults.setdefault(namespace, {}).update(values)


def _file_layer() -> Dict[str, Dict[str, Any]]:
    path = os.environ.get(_ENV_PREFIX + "CONFIG")
    if not path or not os.path.exists(path):
        return {}
    with open(path) as f:
        data = json.load(f)
    return {str(ns): dict(vals) for ns, vals in data.items()}


def _env_layer(namespace: str) -> Dict[str, Any]:
    if namespace.upper() in _RESERVED:
        # framework control variables (MMLSPARK_TPU_NATIVE_DIR,
        # MMLSPARK_TPU_TEST_TPU, ...) are not user config
        return {}
    prefix = _ENV_PREFIX + namespace.upper() + "_"
    out: Dict[str, Any] = {}
    for key, raw in os.environ.items():
        if not key.startswith(prefix):
            continue
        name = key[len(prefix):].lower()
        try:
            out[name] = json.loads(raw)
        except ValueError:
            out[name] = raw
    return out


class MMLConfig:
    """Read-side API (parity: ``MMLConfig.get()``)."""

    @staticmethod
    def get(namespace: str) -> Dict[str, Any]:
        """The merged config dict for ``namespace``."""
        with _lock:
            out = dict(_defaults.get(namespace, {}))
        out.update(_file_layer().get(namespace, {}))
        out.update(_env_layer(namespace))
        return out
