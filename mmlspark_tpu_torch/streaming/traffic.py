"""TrafficLogSource: served-traffic capture segments as a stream source
(the port of ``mmlspark_tpu/streaming/traffic.py``).

Reads the rotating JSON-line segments
:class:`~mmlspark_tpu_torch.serving.capture.TrafficCapture` writes (one
directory per worker; point this at a parent directory and every
worker's segments are merged) and exposes the engine source protocol:
``plan`` hands out line ranges of settled (newline-terminated) records,
``read`` materializes a range deterministically — the same offsets
yield the same rows on a post-crash replay, because segments are
append-only — and ``ack`` advances a durable cursor journal so a
restarted query resumes where the committed work ended. Torn tails
(a capture writer killed mid-line) are simply not planned until the
line completes; pruned segments fall out of the cursor at ack time
(the same dead-path compaction rule as ``FileStreamSource``).
"""

from __future__ import annotations

import json
import os
import threading
from typing import Any, Dict, List, Optional, Tuple

from mmlspark_tpu_torch.core.dataframe import DataFrame
from mmlspark_tpu_torch.core.logs import get_logger

logger = get_logger("streaming.traffic")

#: meta columns every produced row carries, ordered first in frames.
#: On a name collision the PAYLOAD's value wins (a request feature
#: named "version" is training data; the serving metadata yields)
_META_COLS = ("kind", "event_time", "rid", "trace_id", "version")


class TrafficLogSource:
    """Stream source over a tree of ``*.jsonl`` capture segments.

    ``kinds`` filters records (default: live ``traffic`` rows only —
    pass ``("traffic", "shadow")`` to stream shadow-diff rows too).
    Each produced row flattens to: the meta columns (``kind``,
    ``event_time`` (wall seconds), ``rid``, ``trace_id``, ``version``),
    then the ``request`` object's keys, then the ``reply`` object's
    keys (request wins name collisions). ``cursor_path`` (default
    ``<directory>/_cursor.json``) journals the committed read position
    per segment, so a fresh source instance resumes exactly after the
    last acked line.
    """

    def __init__(self, directory: str,
                 kinds: Tuple[str, ...] = ("traffic",),
                 cursor_path: Optional[str] = None,
                 include_reply: bool = True):
        self.directory = os.path.abspath(directory)
        self.kinds = tuple(kinds)
        self.include_reply = bool(include_reply)
        self.cursor_path = cursor_path or os.path.join(
            self.directory, "_cursor.json")
        self._lock = threading.Lock()
        #: per-segment (bytes_scanned, complete_lines) — line counting
        #: reads only the appended tail, so plan()/backlog() (which the
        #: metrics gauge calls every scrape) cost O(new bytes), not a
        #: full reread of every segment
        self._line_cache: Dict[str, Tuple[int, int]] = {}
        #: committed lines per segment relpath (durable via the journal)
        self._cursor: Dict[str, int] = {}
        #: planned-but-unacked lines per relpath (in-memory; the engine
        #: WAL re-acks across restarts)
        self._planned: Dict[str, int] = {}
        self.n_bad_lines = 0
        if os.path.exists(self.cursor_path):
            try:
                with open(self.cursor_path) as f:
                    self._cursor = {str(k): int(v)
                                    for k, v in json.load(f).items()}
            except (ValueError, OSError):
                logger.warning("unreadable cursor journal %s; starting "
                               "from zero", self.cursor_path)
        self._planned = dict(self._cursor)

    # -- segment discovery ---------------------------------------------------

    def _segments(self) -> List[str]:
        """Sorted relpaths of every settled-looking segment file."""
        out = []
        for root, dirs, files in os.walk(self.directory):
            dirs.sort()
            for name in sorted(files):
                if not name.endswith(".jsonl"):
                    continue
                out.append(os.path.relpath(os.path.join(root, name),
                                           self.directory))
        return out

    def _complete_lines(self, rel: str) -> int:
        """Newline-terminated line count of one segment (a torn tail is
        not yet a record). Incremental: only bytes beyond the last scan
        are read — a partial tail contributes no newline now and its
        completing bytes carry the newline later, so chunked counts
        sum exactly."""
        path = os.path.join(self.directory, rel)
        try:
            size = os.path.getsize(path)
        except OSError:
            self._line_cache.pop(rel, None)
            return 0
        off, lines = self._line_cache.get(rel, (0, 0))
        if size < off:
            off, lines = 0, 0        # replaced/truncated: rescan
        if size > off:
            try:
                with open(path, "rb") as f:
                    f.seek(off)
                    data = f.read()
            except OSError:
                return lines
            lines += data.count(b"\n")
            off += len(data)
            self._line_cache[rel] = (off, lines)
        return lines

    # -- engine source protocol ----------------------------------------------

    def plan(self, limit_rows: Optional[int] = None
             ) -> Optional[Dict[str, Any]]:
        budget = int(limit_rows) if limit_rows else None
        parts: List[List[Any]] = []
        with self._lock:
            for rel in self._segments():
                done = self._planned.get(rel, 0)
                avail = self._complete_lines(rel)
                if avail <= done:
                    continue
                take = avail - done
                if budget is not None:
                    take = min(take, budget)
                if take <= 0:
                    break
                parts.append([rel, done, done + take])
                self._planned[rel] = done + take
                if budget is not None:
                    budget -= take
                    if budget <= 0:
                        break
        if not parts:
            return None
        return {"parts": parts}

    def read(self, meta: Dict[str, Any]) -> DataFrame:
        rows: List[Dict[str, Any]] = []
        for rel, start, end in meta["parts"]:
            path = os.path.join(self.directory, rel)
            try:
                with open(path, "rb") as f:
                    lines = f.read().split(b"\n")
            except OSError:
                # segment pruned between plan and (replayed) read: the
                # rows are gone; deliver what remains rather than wedge
                logger.warning("capture segment %s vanished before "
                               "read; its rows are lost", rel)
                continue
            for ln in lines[int(start):int(end)]:
                if not ln:
                    continue
                try:
                    rec = json.loads(ln)
                except ValueError:
                    self.n_bad_lines += 1
                    continue
                if rec.get("kind") not in self.kinds:
                    continue
                rows.append(self._flatten(rec))
        return _frame_from_ragged_rows(rows)

    def ack(self, meta: Dict[str, Any]) -> None:
        with self._lock:
            for rel, _start, end in meta["parts"]:
                if int(end) > self._cursor.get(rel, 0):
                    self._cursor[rel] = int(end)
                if self._planned.get(rel, 0) < self._cursor[rel]:
                    self._planned[rel] = self._cursor[rel]
            # dead-path compaction: segments pruned from disk stay out
            # of the journal (same rule as FileStreamSource._checkpoint)
            live = set(self._segments())
            self._cursor = {rel: n for rel, n in self._cursor.items()
                            if rel in live}
            self._planned = {rel: n for rel, n in self._planned.items()
                             if rel in live}
            self._line_cache = {rel: v for rel, v
                                in self._line_cache.items()
                                if rel in live}
            self._write_cursor()

    def backlog(self) -> int:
        with self._lock:
            total = 0
            for rel in self._segments():
                total += max(self._complete_lines(rel)
                             - self._planned.get(rel, 0), 0)
            return total

    # -- helpers -------------------------------------------------------------

    def _flatten(self, rec: Dict[str, Any]) -> Dict[str, Any]:
        # payload fields FIRST: a request feature named "version" or
        # "kind" is training data and must not be shadowed by serving
        # metadata (request wins over reply, both win over meta)
        row: Dict[str, Any] = {}
        for key, obj in (("request", rec.get("request")),
                         ("reply", rec.get("reply")
                          if self.include_reply else None),
                         ("live", rec.get("live")),
                         ("shadow", rec.get("shadow"))):
            if not isinstance(obj, dict):
                continue
            prefix = "" if key in ("request", "reply") else f"{key}_"
            for k, v in obj.items():
                row.setdefault(f"{prefix}{k}", v)
        row.setdefault("kind", rec.get("kind"))
        row.setdefault("event_time", rec.get("t"))
        row.setdefault("rid", rec.get("rid"))
        row.setdefault("trace_id", rec.get("trace"))
        row.setdefault("version", rec.get("version"))
        if "staged_version" in rec:      # shadow-diff rows only
            row.setdefault("staged_version", rec["staged_version"])
        return row

    def _write_cursor(self) -> None:
        tmp = f"{self.cursor_path}.tmp.{os.getpid()}"
        try:
            with open(tmp, "w") as f:
                json.dump(self._cursor, f, sort_keys=True)
            os.replace(tmp, self.cursor_path)
        except OSError:
            logger.warning("cursor journal write to %s failed",
                           self.cursor_path, exc_info=True)


def _frame_from_ragged_rows(rows: List[Dict[str, Any]]) -> DataFrame:
    """Rows may be heterogeneous (mixed kinds / evolving schemas):
    build the column union with ``None`` holes, meta columns first."""
    if not rows:
        return DataFrame({})
    cols: List[str] = [c for c in _META_COLS if any(c in r for r in rows)]
    seen = set(cols)
    for r in rows:
        for k in r:
            if k not in seen:
                seen.add(k)
                cols.append(k)
    return DataFrame({c: [r.get(c) for r in rows] for c in cols})
