"""Namespaced logger factory (the port's copy of
``mmlspark_tpu/core/logs.py``).

Stdlib logging under one ``mmlspark_tpu_torch`` root, with the level
from the ``logging`` config namespace (``MMLSPARK_TPU_LOGGING_LEVEL=DEBUG``
or the config file — see ``core/config.py``; default INFO).

Observability extensions:

* ``MMLSPARK_TPU_LOGGING_FORMAT=json`` switches every record to one
  structured JSON object per line — the shape log pipelines (Loki,
  Stackdriver, `jq`) ingest without a parse regex.
* every record carries the ambient trace id
  (:func:`mmlspark_tpu_torch.core.telemetry.current_trace_id`) and span
  name (:func:`mmlspark_tpu_torch.core.tracing.current_span_name`): a
  handler filter stamps ``record.trace_id`` / ``record.span_name``, the
  JSON format emits both as fields, and the plain format appends
  ``trace=<id> span=<name>`` only when actually bound.
"""

from __future__ import annotations

import json as _json
import logging as _logging
import threading as _threading
import time as _time
from collections import deque as _deque

_ROOT = "mmlspark_tpu_torch"
_configured = False


class _TraceFilter(_logging.Filter):
    """Stamp the ambient trace id AND span name onto every record at
    emit time — a log line inside a serving dispatch reads
    ``trace=<id> span=dispatch``, so grep finds not just the request
    but the stage it was in."""

    def filter(self, record: _logging.LogRecord) -> bool:
        from mmlspark_tpu_torch.core.telemetry import current_trace_id
        from mmlspark_tpu_torch.core.tracing import current_span_name
        record.trace_id = current_trace_id() or "-"
        record.span_name = current_span_name() or "-"
        return True


def _record_trace_id(record: _logging.LogRecord):
    tid = getattr(record, "trace_id", None)
    if tid is None:
        # formatter used without the handler filter (tests formatting a
        # bare record): resolve directly
        from mmlspark_tpu_torch.core.telemetry import current_trace_id
        tid = current_trace_id() or "-"
    return tid


def _record_span_name(record: _logging.LogRecord):
    name = getattr(record, "span_name", None)
    if name is None:
        from mmlspark_tpu_torch.core.tracing import current_span_name
        name = current_span_name() or "-"
    return name


class _PlainFormatter(_logging.Formatter):
    """The historical plain format, plus ``trace=<id>`` / ``span=<name>``
    when bound (no trailing noise for untraced records)."""

    def __init__(self):
        super().__init__("%(asctime)s %(name)s %(levelname)s: %(message)s")

    def format(self, record: _logging.LogRecord) -> str:
        out = super().format(record)
        tid = _record_trace_id(record)
        if tid and tid != "-":
            out += f" trace={tid}"
        span = _record_span_name(record)
        if span and span != "-":
            out += f" span={span}"
        return out


class _JsonFormatter(_logging.Formatter):
    """One JSON object per line: ts/level/logger/message/trace_id/span
    (+ exc when an exception rode the record)."""

    def format(self, record: _logging.LogRecord) -> str:
        out = {
            "ts": self.formatTime(record),
            "level": record.levelname,
            "logger": record.name,
            "message": record.getMessage(),
            "trace_id": _record_trace_id(record),
            "span": _record_span_name(record),
        }
        if record.exc_info:
            out["exc"] = self.formatException(record.exc_info)
        return _json.dumps(out, default=str)


def make_formatter(fmt: str = "plain") -> _logging.Formatter:
    """The formatter for a ``logging.format`` config value (``plain``
    or ``json``; unknown values fall back to plain)."""
    return _JsonFormatter() if str(fmt).lower() == "json" \
        else _PlainFormatter()


def _config() -> dict:
    """The ``logging`` config namespace (``MMLSPARK_TPU_LOGGING_LEVEL``
    / ``_FORMAT``, or the config file — see ``core/config.py``)."""
    from mmlspark_tpu_torch.core.config import MMLConfig
    return MMLConfig.get("logging")


def _ensure_root() -> None:
    global _configured
    if _configured:
        return
    cfg = _config()
    root = _logging.getLogger(_ROOT)
    if not root.handlers:
        handler = _logging.StreamHandler()
        handler.setFormatter(make_formatter(cfg.get("format", "plain")))
        handler.addFilter(_TraceFilter())
        root.addHandler(handler)
        root.propagate = False
    level = str(cfg.get("level", "INFO")).upper()
    root.setLevel(getattr(_logging, level, _logging.INFO))
    _configured = True


def reconfigure() -> None:
    """Re-read the ``logging`` settings (level + format) so a
    long-lived process can flip to JSON logs without a restart. The
    installed handler's formatter is swapped IN PLACE (one attribute
    assignment) rather than removed-and-readded — concurrent request
    threads never hit a handler-less, non-propagating root logger, so
    no record is dropped mid-flip."""
    global _configured
    root = _logging.getLogger(_ROOT)
    if not root.handlers:
        _configured = False      # nothing installed: next get_logger runs
        return                   # the full _ensure_root
    cfg = _config()
    for h in root.handlers:
        h.setFormatter(make_formatter(cfg.get("format", "plain")))
    level = str(cfg.get("level", "INFO")).upper()
    root.setLevel(getattr(_logging, level, _logging.INFO))


def get_logger(namespace: str) -> _logging.Logger:
    """Logger at ``mmlspark_tpu_torch.<namespace>`` (created on first use)."""
    _ensure_root()
    return _logging.getLogger(f"{_ROOT}.{namespace}")


class LogRing(_logging.Handler):
    """Bounded in-memory ring of the last N log records.

    The postmortem plane's log surface: a worker serves the ring at
    ``GET /logs?trace=<id>&level=<name>`` and the incident bundle
    snapshots the *same* ring — what the operator greps and what the
    bundle preserves are one buffer, not two codepaths.

    Records are stored as plain dicts (``ts``/``level``/``levelno``/
    ``logger``/``message``/``trace``/``span``) at emit time, so reading
    the ring never touches live ``LogRecord`` objects. ``level`` is the
    handler's severity floor (records below it never enter the ring);
    :meth:`records` can filter further by trace id and level name.
    ``emit`` swallows its own errors — a broken record loses one line,
    never the caller.
    """

    def __init__(self, capacity: int = 2048,
                 level: int = _logging.INFO):
        super().__init__(level=level)
        self.capacity = int(capacity)
        self._ring = _deque(maxlen=self.capacity)
        self._rlock = _threading.Lock()
        self.n_emitted = 0
        self.addFilter(_TraceFilter())

    def emit(self, record: _logging.LogRecord) -> None:
        try:
            entry = {
                "ts": getattr(record, "created", None) or _time.time(),
                "level": record.levelname,
                "levelno": record.levelno,
                "logger": record.name,
                "message": record.getMessage(),
                "trace": _record_trace_id(record),
                "span": _record_span_name(record),
            }
            if record.exc_info:
                try:
                    entry["exc"] = _logging.Formatter().formatException(
                        record.exc_info)
                except Exception:
                    pass
            with self._rlock:
                self._ring.append(entry)
                self.n_emitted += 1
        except Exception:       # pragma: no cover - defensive
            pass

    def records(self, trace: str = None, level: str = None,
                limit: int = None) -> list:
        """Newest-last snapshot, optionally filtered by trace id and/or
        minimum level name; ``limit`` keeps only the newest N."""
        floor = None
        if level:
            floor = getattr(_logging, str(level).upper(), None)
        with self._rlock:
            out = list(self._ring)
        if trace:
            out = [r for r in out if r.get("trace") == trace]
        if floor is not None:
            out = [r for r in out if r.get("levelno", 0) >= floor]
        if limit is not None and limit >= 0:
            out = out[-limit:]
        return out

    def status(self) -> dict:
        with self._rlock:
            return {"capacity": self.capacity, "len": len(self._ring),
                    "emitted": self.n_emitted,
                    "floor": _logging.getLevelName(self.level)}


_log_ring: LogRing = None
_ring_lock = _threading.Lock()


def install_log_ring(capacity: int = 2048,
                     level: int = _logging.INFO) -> LogRing:
    """Attach one process-wide :class:`LogRing` to the
    ``mmlspark_tpu_torch`` root logger (idempotent — repeated calls
    return the same ring, so every server in a process shares one
    buffer, matching the shared stream handler)."""
    global _log_ring
    with _ring_lock:
        if _log_ring is None:
            _ensure_root()
            ring = LogRing(capacity=capacity, level=level)
            _logging.getLogger(_ROOT).addHandler(ring)
            _log_ring = ring
        return _log_ring


def get_log_ring() -> LogRing:
    """The installed ring, or ``None`` before :func:`install_log_ring`."""
    return _log_ring
