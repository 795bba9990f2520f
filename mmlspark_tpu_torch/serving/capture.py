"""Traffic capture: an opt-in, bounded, non-blocking journal of served
request/reply rows — the feedstock of the retrain->redeploy loop (the
port's copy of ``mmlspark_tpu/serving/capture.py``).

The capture sink rides the serving data plane the way shadow traffic
does: the encoder stage offers each COMMITTED batch's rows to a
shallow queue and never waits — when the writer thread is behind, the
batch is dropped and counted (``serving_capture_dropped_total``); the
live path pays one sampling-tick check per batch. A dedicated writer
thread formats rows as JSON lines into **rotating segments**
(``segment-000001.jsonl``) with a byte-size rotation threshold and a
bounded segment count, so capture disk usage is O(max_segments x
max_segment_bytes) however long the worker lives.

Every row is self-describing: wall timestamp, request id, trace id
(the observability correlation key), the model version that served it,
the request payload, and the reply — the JAX package's
``TrafficLogSource`` turns the segments back into frames for training.

This is also the home of **shadow-output
sampling**: the rollout shadow thread offers a sampled slice of each
mirrored batch here (``kind="shadow"`` rows carrying the live AND
staged outputs side by side) for offline diffing beyond the in-process
mismatch counters.
"""

from __future__ import annotations

import json
import os
import threading
import time
from queue import Empty, Full, Queue
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from mmlspark_tpu_torch.core.logs import get_logger

logger = get_logger("serving.capture")

SEGMENT_PREFIX = "segment-"
SEGMENT_SUFFIX = ".jsonl"


def _py(v: Any) -> Any:
    """JSON-encodable view of a payload/reply value."""
    if isinstance(v, np.generic):
        return v.item()
    if isinstance(v, np.ndarray):
        return v.tolist()
    if isinstance(v, bytes):
        return v.decode("utf-8", "replace")
    if isinstance(v, dict):
        return {k: _py(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_py(x) for x in v]
    return v


class TrafficCapture:
    """Bounded, non-blocking traffic journal for one serving worker.

    ``sample_every``: capture every Nth committed batch (1 = all).
    ``shadow_sample_every``: same cadence for mirrored shadow batches
    (0 disables shadow sampling). ``shadow_rows_per_batch`` bounds the
    rows written per sampled shadow batch (diff evidence, not a full
    mirror).
    """

    def __init__(self, directory: str,
                 sample_every: int = 1,
                 shadow_sample_every: int = 1,
                 shadow_rows_per_batch: int = 16,
                 max_segment_bytes: int = 4 << 20,
                 max_segments: int = 64,
                 queue_depth: int = 256):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.sample_every = max(int(sample_every), 1)
        self.shadow_sample_every = max(int(shadow_sample_every), 0)
        self.shadow_rows_per_batch = max(int(shadow_rows_per_batch), 1)
        self.max_segment_bytes = max(int(max_segment_bytes), 1 << 10)
        self.max_segments = max(int(max_segments), 2)
        self._q: "Queue[Tuple[str, Any]]" = Queue(
            maxsize=max(int(queue_depth), 1))
        self._tick = 0
        self._shadow_tick = 0
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._fh = None
        self._seg_path: Optional[str] = None
        self._seg_bytes = 0
        # restart continues with a FRESH segment after the newest on
        # disk: a consumer mid-way through an old segment never sees it
        # grow again under its cursor
        self._seg_idx = self._next_segment_index()
        self.n_rows = 0
        self.n_shadow_rows = 0
        self.n_dropped_batches = 0
        self.n_segments_rotated = 0
        self.n_segments_pruned = 0
        self.n_write_errors = 0

    # -- hot path (encoder / shadow threads) ---------------------------------

    def offer(self, version: str, committed: List[Any]) -> None:
        """Offer one committed batch's requests+replies. Called by the
        encoder stage AFTER the batch committed; never blocks. Each
        element needs ``.rid``/``.trace``/``.payload``/``.reply``
        (the server's pending-request shape)."""
        if not committed:
            return
        self._tick += 1
        if self._tick % self.sample_every:
            return
        rows = [(p.rid, p.trace, p.payload, p.reply) for p in committed]
        try:
            self._q.put_nowait(("traffic", (version, time.time(), rows)))
        except Full:
            self.n_dropped_batches += 1
            return
        self._ensure_writer()

    def offer_shadow(self, live_version: str, staged_version: str,
                     df, live_out, shadow_out) -> None:
        """Offer a sampled slice of one mirrored batch (live vs staged
        outputs side by side). Called from the rollout shadow thread;
        never blocks."""
        if not self.shadow_sample_every:
            return
        self._shadow_tick += 1
        if self._shadow_tick % self.shadow_sample_every:
            return
        try:
            self._q.put_nowait((
                "shadow",
                (live_version, staged_version, time.time(),
                 df, live_out, shadow_out)))
        except Full:
            self.n_dropped_batches += 1
            return
        self._ensure_writer()

    # -- writer thread -------------------------------------------------------

    def _ensure_writer(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            return
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._writer_loop, daemon=True,
                name="traffic-capture")
            self._thread.start()

    def _writer_loop(self) -> None:
        while not self._stop.is_set():
            try:
                item = self._q.get(timeout=0.2)
            except Empty:
                continue
            self._write_item(item)

    def _write_item(self, item: Tuple[str, Any]) -> None:
        try:
            kind, payload = item
            if kind == "traffic":
                lines = self._format_traffic(*payload)
            else:
                lines = self._format_shadow(*payload)
            if lines:
                self._append(lines)
        except Exception:  # noqa: BLE001 — capture is best-effort
            # observability of the data plane, never a hazard to it
            self.n_write_errors += 1
            logger.warning("traffic capture write failed", exc_info=True)

    def _format_traffic(self, version: str, t_wall: float,
                        rows: List[Tuple]) -> List[bytes]:
        out = []
        for rid, trace, payload, reply in rows:
            try:
                rep = json.loads(reply) if reply else {}
            except ValueError:
                rep = {"_raw": reply.decode("utf-8", "replace")}
            rec = {"kind": "traffic", "t": round(t_wall, 3),
                   "rid": rid, "trace": trace, "version": version,
                   "request": _py(payload), "reply": _py(rep)}
            out.append(json.dumps(rec).encode())
            self.n_rows += 1
        return out

    def _format_shadow(self, live_version: str, staged_version: str,
                       t_wall: float, df, live_out, shadow_out
                       ) -> List[bytes]:
        added = [c for c in live_out.columns if c not in df.columns]
        shadow_cols = [c for c in shadow_out.columns
                       if c not in df.columns]
        out = []
        for i in range(min(df.num_rows, self.shadow_rows_per_batch)):
            rec = {"kind": "shadow", "t": round(t_wall, 3),
                   "version": live_version,
                   "staged_version": staged_version,
                   "request": {c: _py(df[c][i]) for c in df.columns},
                   "live": {c: _py(live_out[c][i]) for c in added},
                   "shadow": {c: _py(shadow_out[c][i])
                              for c in shadow_cols}}
            out.append(json.dumps(rec).encode())
            self.n_shadow_rows += 1
        return out

    # -- segments ------------------------------------------------------------

    def _next_segment_index(self) -> int:
        latest = 0
        for name in os.listdir(self.directory):
            if name.startswith(SEGMENT_PREFIX) \
                    and name.endswith(SEGMENT_SUFFIX):
                try:
                    latest = max(latest, int(
                        name[len(SEGMENT_PREFIX):-len(SEGMENT_SUFFIX)]))
                except ValueError:
                    continue
        return latest + 1

    def _open_segment(self) -> None:
        if self._fh is not None:
            try:
                self._fh.close()
            except Exception:  # noqa: BLE001
                pass
        self._seg_path = os.path.join(
            self.directory,
            f"{SEGMENT_PREFIX}{self._seg_idx:06d}{SEGMENT_SUFFIX}")
        self._fh = open(self._seg_path, "ab")
        self._seg_bytes = os.path.getsize(self._seg_path)
        self._seg_idx += 1

    def _append(self, lines: List[bytes]) -> None:
        if self._fh is None or self._seg_bytes >= self.max_segment_bytes:
            if self._fh is not None:
                self.n_segments_rotated += 1
            self._open_segment()
            self._prune()
        blob = b"".join(ln + b"\n" for ln in lines)
        self._fh.write(blob)
        self._fh.flush()
        self._seg_bytes += len(blob)

    def _segments(self) -> List[str]:
        return sorted(
            name for name in os.listdir(self.directory)
            if name.startswith(SEGMENT_PREFIX)
            and name.endswith(SEGMENT_SUFFIX))

    def _prune(self) -> None:
        segs = self._segments()
        for name in segs[:-self.max_segments]:
            try:
                os.remove(os.path.join(self.directory, name))
                self.n_segments_pruned += 1
            except OSError:
                continue

    # -- lifecycle / surfaces ------------------------------------------------

    def flush(self, timeout: float = 5.0) -> None:
        """Drain queued batches to disk (tests / shutdown)."""
        deadline = time.monotonic() + timeout
        while not self._q.empty() and time.monotonic() < deadline:
            if self._thread is None or not self._thread.is_alive():
                # no writer running: drain inline
                try:
                    self._write_item(self._q.get_nowait())
                except Empty:
                    break
            else:
                time.sleep(0.01)

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None and t.is_alive():
            t.join(timeout=2)
        self.flush()
        if self._fh is not None:
            try:
                self._fh.close()
            except Exception:  # noqa: BLE001
                pass
            self._fh = None

    def bind(self, registry) -> None:
        """Expose capture counters in a server's registry."""
        for name, help_, attr in (
            ("serving_capture_rows_total",
             "Committed request/reply rows written to the traffic "
             "capture journal.", "n_rows"),
            ("serving_capture_shadow_rows_total",
             "Sampled shadow-comparison rows written to the capture "
             "journal (live vs staged outputs).", "n_shadow_rows"),
            ("serving_capture_dropped_total",
             "Sampled batches dropped because the capture writer was "
             "behind (capture never delays live traffic).",
             "n_dropped_batches"),
            ("serving_capture_segments_rotated_total",
             "Capture segments closed at the rotation threshold.",
             "n_segments_rotated"),
            ("serving_capture_segments_pruned_total",
             "Old capture segments deleted beyond max_segments.",
             "n_segments_pruned"),
            ("serving_capture_write_errors_total",
             "Capture writer failures (rows lost, live path "
             "unaffected).", "n_write_errors"),
        ):
            registry.counter(name, help_).set_function(
                lambda a=attr: getattr(self, a))

    def status(self) -> Dict[str, Any]:
        segs = self._segments()
        return {"directory": self.directory,
                "sample_every": self.sample_every,
                "shadow_sample_every": self.shadow_sample_every,
                "rows": self.n_rows,
                "shadow_rows": self.n_shadow_rows,
                "dropped_batches": self.n_dropped_batches,
                "segments": len(segs),
                "segments_rotated": self.n_segments_rotated,
                "segments_pruned": self.n_segments_pruned,
                "write_errors": self.n_write_errors}
