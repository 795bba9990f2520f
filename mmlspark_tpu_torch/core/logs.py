"""Namespaced logger factory (the port's copy of
``mmlspark_tpu/core/logs.py:get_logger``).

Stdlib logging under one ``mmlspark_tpu_torch`` root with a plain
stream handler; the level comes from ``MMLSPARK_TPU_LOGGING_LEVEL``
(default INFO). Trace-id stamping and the JSON format arrive with the
serving stack they belong to.
"""

from __future__ import annotations

import logging
import os
import threading

_ROOT = "mmlspark_tpu_torch"
_lock = threading.Lock()


def _ensure_root() -> None:
    with _lock:
        root = logging.getLogger(_ROOT)
        if root.handlers:
            return
        handler = logging.StreamHandler()
        handler.setFormatter(logging.Formatter(
            "%(asctime)s %(name)s %(levelname)s: %(message)s"))
        root.addHandler(handler)
        root.propagate = False
        level = os.environ.get("MMLSPARK_TPU_LOGGING_LEVEL", "INFO").upper()
        root.setLevel(getattr(logging, level, logging.INFO))


def get_logger(namespace: str) -> logging.Logger:
    """Logger at ``mmlspark_tpu_torch.<namespace>`` (created on first
    use)."""
    _ensure_root()
    return logging.getLogger(f"{_ROOT}.{namespace}")
