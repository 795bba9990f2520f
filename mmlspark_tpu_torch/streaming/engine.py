"""Micro-batch streaming engine core (the port of
``mmlspark_tpu/streaming/engine.py``; it uses no device).

Execution model (the structured-streaming shape, at this repo's scale):
a :class:`StreamingQuery` runs a ``source -> transform -> sink`` graph
in **versioned micro-batches**. Each batch is durably *planned* before
it runs — the source's offset descriptor lands in a write-ahead
**offset log** — and durably *committed* after the sink finishes — the
batch's post-state (watermark, window-aggregation state, counters)
lands in a **commit log**. Both logs are one atomic-rename JSON file
per batch under ``checkpoint_dir``, the same journal idiom the serving
replay journal and checkpoint digest manifests use (manifest-last /
append-then-replace; torn writes are detectably incomplete).

Exactly-once: on restart the query replays every planned-but-
uncommitted batch from its logged offsets — the *same* rows reach the
sink again, under the *same* batch id. A crash between the sink write
and the commit append therefore downgrades to at-least-once at the
engine boundary, and idempotent sinks (keyed by batch id — e.g. the
``fit_stream`` trainer sink journals its high-water batch id inside
its own checkpoint) restore exactly-once end to end: replay beats
re-dispatch, exactly like the serving journal's rule.

Event time: with ``event_time_col`` the engine tracks the max event
time seen and a **watermark** ``max_event - delay`` (monotone,
persisted in the commit log so restarts resume it). Windowed
aggregation (:class:`WindowSpec`, tumbling or sliding) accumulates
per-window partial aggregates in engine state; a window is emitted to
the sink once the watermark passes its end, and rows older than the
watermark are **late data**: counted, surfaced, excluded from state.

Backpressure: the planner asks the source for at most ``rows_limit``
rows per batch; the limit adapts off a sink-latency EWMA toward
``target_batch_ms`` (source-side rate adaptation). Sink faults ride
the resilience layer: a :class:`~mmlspark_tpu_torch.core.resilience.
RetryPolicy` retries the batch in place (never skips — skipping would
break exactly-once) and an optional breaker gives a collapsed sink
time to recover; retries exhausted is a terminal query failure,
surfaced via :meth:`StreamingQuery.status` / :attr:`exception`.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from mmlspark_tpu_torch.core.dataframe import DataFrame
from mmlspark_tpu_torch.core.logs import get_logger
from mmlspark_tpu_torch.core.resilience import (
    Clock, CircuitBreaker, RetryPolicy, SYSTEM_CLOCK,
)

logger = get_logger("streaming.engine")

OFFSETS_DIR = "offsets"
COMMITS_DIR = "commits"


class StreamingQueryError(RuntimeError):
    """The query is in a state that cannot honor the request."""


def _atomic_write_json(path: str, obj: Dict[str, Any]) -> None:
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(obj, f, sort_keys=True)
    os.replace(tmp, path)


def _read_log(dirpath: str) -> Dict[int, Dict[str, Any]]:
    """``{batch_id: entry}`` for every readable log file; torn/partial
    files (no atomic rename happened) simply do not exist here."""
    out: Dict[int, Dict[str, Any]] = {}
    if not os.path.isdir(dirpath):
        return out
    for name in os.listdir(dirpath):
        if not name.endswith(".json"):
            continue
        try:
            bid = int(name[:-len(".json")])
            with open(os.path.join(dirpath, name)) as f:
                out[bid] = json.load(f)
        except (ValueError, OSError):
            continue
    return out


# ---------------------------------------------------------------------------
# sources
# ---------------------------------------------------------------------------

class MemoryStreamSource:
    """In-memory source (the MemoryStream parity): rows appended via
    :meth:`add_rows` are planned in arrival order by absolute position,
    so a replayed offset range reads back the identical rows. Testing
    and docs — positions do not survive the process."""

    def __init__(self):
        self._rows: List[Dict[str, Any]] = []
        self._planned = 0      # rows handed to the engine (plan cursor)
        self._acked = 0        # rows durably committed downstream
        self._lock = threading.Lock()

    def add_rows(self, rows: List[Dict[str, Any]]) -> None:
        with self._lock:
            self._rows.extend(dict(r) for r in rows)

    # -- engine source protocol ---------------------------------------------

    def plan(self, limit_rows: Optional[int] = None
             ) -> Optional[Dict[str, Any]]:
        with self._lock:
            end = len(self._rows)
            if limit_rows is not None:
                end = min(end, self._planned + max(int(limit_rows), 1))
            if end <= self._planned:
                return None
            meta = {"start": self._planned, "end": end}
            self._planned = end
            return meta

    def read(self, meta: Dict[str, Any]) -> DataFrame:
        with self._lock:
            rows = self._rows[int(meta["start"]):int(meta["end"])]
        return DataFrame.from_rows(rows)

    def ack(self, meta: Dict[str, Any]) -> None:
        with self._lock:
            self._acked = max(self._acked, int(meta["end"]))
            self._planned = max(self._planned, self._acked)

    def backlog(self) -> int:
        with self._lock:
            return len(self._rows) - self._planned


# ---------------------------------------------------------------------------
# event-time windows
# ---------------------------------------------------------------------------

_AGG_OPS = ("count", "sum", "mean", "min", "max")


class WindowSpec:
    """Tumbling/sliding event-time window aggregation.

    ``size_s`` is the window length, ``slide_s`` the hop (defaults to
    ``size_s`` — tumbling). ``aggs`` maps output columns to
    ``(op, input_col)`` with ops ``count|sum|mean|min|max`` (``count``
    ignores its input column). Emitted frames carry ``window_start``,
    ``window_end`` and one row per closed window, ordered by start.
    """

    def __init__(self, size_s: float, slide_s: Optional[float] = None,
                 aggs: Optional[Dict[str, Tuple[str, Optional[str]]]] = None):
        self.size_s = float(size_s)
        self.slide_s = float(slide_s) if slide_s is not None else self.size_s
        if self.size_s <= 0 or self.slide_s <= 0:
            raise ValueError("window size_s and slide_s must be > 0")
        if self.slide_s > self.size_s:
            raise ValueError("slide_s > size_s leaves event-time gaps no "
                             "window covers; use slide_s <= size_s")
        self.aggs = dict(aggs or {"count": ("count", None)})
        for out, (op, _col) in self.aggs.items():
            if op not in _AGG_OPS:
                raise ValueError(f"unknown agg op {op!r} for {out!r}; "
                                 f"have {_AGG_OPS}")

    def starts_for(self, t: float) -> List[float]:
        """Every window start containing event time ``t`` (one for a
        tumbling window, ``size/slide`` for a sliding one)."""
        last = float(np.floor(t / self.slide_s)) * self.slide_s
        starts = []
        s = last
        while s > t - self.size_s:
            starts.append(float(round(s, 9)))
            s -= self.slide_s
        return starts


class _WindowState:
    """Partial aggregates per open window, JSON round-trippable (the
    commit log persists it so a restarted query resumes mid-window)."""

    def __init__(self, spec: WindowSpec):
        self.spec = spec
        #: {start: {"count": n, "sum": {col: v}, "min": {...}, "max": {...}}}
        self.windows: Dict[float, Dict[str, Any]] = {}

    def update(self, times: np.ndarray, df: DataFrame,
               not_late: np.ndarray) -> None:
        cols = {c for _, (op, c) in self.spec.aggs.items()
                if c is not None and op != "count"}
        data = {c: np.asarray(df[c], dtype=np.float64) for c in cols}
        for i in np.nonzero(not_late)[0]:
            t = float(times[i])
            for start in self.spec.starts_for(t):
                w = self.windows.setdefault(
                    start, {"count": 0, "sum": {}, "min": {}, "max": {}})
                w["count"] += 1
                for c, col in data.items():
                    v = float(col[i])
                    w["sum"][c] = w["sum"].get(c, 0.0) + v
                    w["min"][c] = min(w["min"].get(c, v), v)
                    w["max"][c] = max(w["max"].get(c, v), v)

    def close_until(self, watermark: float) -> Optional[DataFrame]:
        """Finalize every window whose end the watermark passed."""
        done = sorted(s for s in self.windows
                      if s + self.spec.size_s <= watermark)
        if not done:
            return None
        rows = []
        for start in done:
            w = self.windows.pop(start)
            row: Dict[str, Any] = {
                "window_start": start,
                "window_end": round(start + self.spec.size_s, 9)}
            for out, (op, c) in self.spec.aggs.items():
                if op == "count":
                    row[out] = w["count"]
                elif op == "sum":
                    row[out] = w["sum"].get(c, 0.0)
                elif op == "mean":
                    row[out] = (w["sum"].get(c, 0.0) / w["count"]
                                if w["count"] else float("nan"))
                else:
                    row[out] = w[op].get(c, float("nan"))
            rows.append(row)
        return DataFrame.from_rows(rows)

    def to_json(self) -> Dict[str, Any]:
        return {repr(float(s)): w for s, w in self.windows.items()}

    def load_json(self, obj: Dict[str, Any]) -> None:
        self.windows = {float(s): w for s, w in (obj or {}).items()}


# ---------------------------------------------------------------------------
# the query
# ---------------------------------------------------------------------------

class StreamingQuery:
    """One running micro-batch pipeline: ``source -> transform ->
    [windowed agg] -> sink`` with WAL-backed exactly-once batches.

    ``sink`` is ``callable(batch_id, df)`` (or an object with a
    ``process(batch_id, df)`` method). With a :class:`WindowSpec` the
    sink receives closed-window aggregate frames; otherwise the
    transformed raw batches. ``checkpoint_dir=None`` runs without a WAL
    (no crash recovery — tests/ephemeral pipes only).

    Drive it either synchronously — :meth:`process_available` runs
    plan/read/sink inline on the caller's thread (deterministic; the
    ManualClock test mode) — or threaded via :meth:`start`, which polls
    the source every ``trigger_interval_s``.
    """

    def __init__(self, source, sink=None,
                 transform: Optional[Callable[[DataFrame], DataFrame]] = None,
                 name: str = "query",
                 checkpoint_dir: Optional[str] = None,
                 trigger_interval_s: float = 0.2,
                 event_time_col: Optional[str] = None,
                 watermark_delay_s: float = 0.0,
                 window: Optional[WindowSpec] = None,
                 max_batch_rows: int = 1024,
                 min_batch_rows: int = 1,
                 target_batch_ms: Optional[float] = None,
                 retry_policy: Optional[RetryPolicy] = None,
                 breaker: Optional[CircuitBreaker] = None,
                 keep_log_entries: int = 64,
                 registry=None,
                 tracer=None,
                 clock: Clock = SYSTEM_CLOCK):
        if window is not None and event_time_col is None:
            raise ValueError("windowed aggregation needs event_time_col")
        self.source = source
        self.sink = sink
        self.transform = transform
        self.name = str(name)
        self.checkpoint_dir = checkpoint_dir
        self.trigger_interval_s = float(trigger_interval_s)
        self.event_time_col = event_time_col
        self.watermark_delay_s = float(watermark_delay_s)
        self.window = window
        self._window_state = _WindowState(window) if window else None
        self.max_batch_rows = max(int(max_batch_rows), 1)
        self.min_batch_rows = max(int(min_batch_rows), 1)
        # rate adaptation target: how long one batch (sink included)
        # should take; defaults to the trigger interval so a saturated
        # sink pushes the planner down toward smaller batches instead
        # of queueing an ever-deeper backlog
        self.target_batch_ms = (float(target_batch_ms)
                                if target_batch_ms is not None
                                else max(self.trigger_interval_s * 1000.0,
                                         1.0))
        self.retry_policy = retry_policy if retry_policy is not None \
            else RetryPolicy(max_attempts=4, base=0.05, cap=2.0,
                             clock=clock)
        self.breaker = breaker
        self.keep_log_entries = max(int(keep_log_entries), 8)
        self.clock = clock
        from mmlspark_tpu_torch.core.tracing import TRACER
        self.tracer = tracer if tracer is not None else TRACER

        # -- progress state
        self.batch_id = 0              # last PLANNED batch id
        self.watermark: Optional[float] = None
        self.max_event_time: Optional[float] = None
        self._rows_limit = self.max_batch_rows
        self._sink_ms_ewma: Optional[float] = None
        self.state = "initialized"     # -> running -> terminated | failed
        self.error: Optional[BaseException] = None
        # -- counters
        self.n_batches = 0
        self.n_rows = 0
        self.n_late_rows = 0
        self.n_replayed_batches = 0
        self.n_sink_retries = 0
        self.n_sink_failures = 0
        self.n_windows_emitted = 0
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._terminated = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._replay: List[Tuple[int, Dict[str, Any]]] = []
        if checkpoint_dir:
            os.makedirs(os.path.join(checkpoint_dir, OFFSETS_DIR),
                        exist_ok=True)
            os.makedirs(os.path.join(checkpoint_dir, COMMITS_DIR),
                        exist_ok=True)
            self._recover()
        if registry is None:
            from mmlspark_tpu_torch.core.telemetry import REGISTRY
            registry = REGISTRY
        self._register_metrics(registry)

    # -- telemetry -----------------------------------------------------------

    def _register_metrics(self, registry) -> None:
        # set_function closures hold only a WEAK reference to the
        # query: a long-lived process creating many uniquely-named
        # queries must not keep each one (and, for fit_stream, its
        # device-resident train state) alive through the registry
        # forever. A dead query's series reads 0. Two queries sharing
        # a name share a child — last registered wins, the same
        # documented idiom as server tail-capture thresholds.
        import weakref
        ref = weakref.ref(self)

        def attr_fn(attr):
            def read() -> float:
                q = ref()
                return float(getattr(q, attr)) if q is not None else 0.0
            return read

        def derived_fn(fn):
            def read() -> float:
                q = ref()
                return float(fn(q)) if q is not None else 0.0
            return read

        lbl = (self.name,)
        for mname, help_, attr in (
            ("streaming_batches_total",
             "Micro-batches committed by the streaming engine.",
             "n_batches"),
            ("streaming_rows_total",
             "Source rows processed by the streaming engine.", "n_rows"),
            ("streaming_late_rows_total",
             "Rows older than the watermark (excluded from windowed "
             "aggregation state).", "n_late_rows"),
            ("streaming_replayed_batches_total",
             "Planned-but-uncommitted batches replayed from the offset "
             "log after a restart (idempotent sinks deduplicate them).",
             "n_replayed_batches"),
            ("streaming_sink_retries_total",
             "Sink attempts retried under the query's RetryPolicy.",
             "n_sink_retries"),
            ("streaming_sink_failures_total",
             "Batches whose sink exhausted its retries (terminal "
             "query failures).", "n_sink_failures"),
        ):
            registry.counter(mname, help_, labels=("query",)).labels(
                *lbl).set_function(attr_fn(attr))
        registry.gauge(
            "streaming_watermark_seconds",
            "Current event-time watermark (event-time seconds; absent "
            "until the first event).", labels=("query",)).labels(
            *lbl).set_function(
            derived_fn(lambda q: q.watermark or 0.0))
        registry.gauge(
            "streaming_event_time_lag_seconds",
            "Max event time seen minus the watermark (the late-data "
            "allowance actually in force).", labels=("query",)).labels(
            *lbl).set_function(
            derived_fn(lambda q: (q.max_event_time or 0.0)
                       - (q.watermark or 0.0)))
        registry.gauge(
            "streaming_source_backlog",
            "Source-reported unplanned backlog (rows/files/lines).",
            labels=("query",)).labels(*lbl).set_function(
            derived_fn(lambda q: q._backlog_metric()))
        registry.gauge(
            "streaming_batch_rows_limit",
            "Adaptive per-batch row budget the planner asks the source "
            "for (rate adaptation off the sink-latency EWMA).",
            labels=("query",)).labels(*lbl).set_function(
            derived_fn(lambda q: q._rows_limit))
        self._m_batch_ms = registry.histogram(
            "streaming_batch_duration_ms",
            "Wall-clock per committed micro-batch (read + transform + "
            "sink + commit).", labels=("query",)).labels(*lbl)
        self._m_sink_ms = registry.histogram(
            "streaming_sink_latency_ms",
            "Sink call wall-clock per micro-batch (the rate-adaptation "
            "signal).", labels=("query",)).labels(*lbl)

    def _backlog_metric(self) -> float:
        try:
            return float(self.source.backlog())
        except Exception:  # noqa: BLE001 — a source without backlog()
            return 0.0

    # -- WAL -----------------------------------------------------------------

    def _log_path(self, kind: str, batch_id: int) -> str:
        return os.path.join(self.checkpoint_dir, kind,
                            f"{batch_id:08d}.json")

    def _recover(self) -> None:
        """Rebuild progress from the logs: restore watermark/state from
        the newest commit, re-ack committed offsets into the source
        (its own progress journal may be a step behind — ack is
        idempotent), queue planned-but-uncommitted offsets for replay."""
        offsets = _read_log(os.path.join(self.checkpoint_dir, OFFSETS_DIR))
        commits = _read_log(os.path.join(self.checkpoint_dir, COMMITS_DIR))
        last_commit = max(commits) if commits else 0
        self.batch_id = max(list(offsets) + list(commits) + [0])
        if last_commit:
            entry = commits[last_commit]
            self.watermark = entry.get("watermark")
            self.max_event_time = entry.get("max_event_time")
            if self._window_state is not None:
                self._window_state.load_json(entry.get("window_state"))
        for bid in sorted(offsets):
            if bid <= last_commit:
                # the crash window between commit-append and source-ack:
                # re-acking is idempotent and closes it
                try:
                    self.source.ack(offsets[bid]["offset"])
                except Exception:  # noqa: BLE001 — best effort; the
                    logger.warning("source re-ack of batch %d failed",
                                   bid, exc_info=True)
            else:
                self._replay.append((bid, offsets[bid]["offset"]))
        if self._replay:
            logger.info(
                "streaming query %r: replaying %d planned-but-"
                "uncommitted batch(es) %s from the offset log",
                self.name, len(self._replay),
                [b for b, _ in self._replay])

    def _prune_logs(self) -> None:
        horizon = self.batch_id - self.keep_log_entries
        if horizon <= 0:
            return
        for kind in (OFFSETS_DIR, COMMITS_DIR):
            d = os.path.join(self.checkpoint_dir, kind)
            for fname in os.listdir(d):
                try:
                    if fname.endswith(".json") \
                            and int(fname[:-len(".json")]) <= horizon:
                        os.remove(os.path.join(d, fname))
                except (ValueError, OSError):
                    continue

    # -- one batch -----------------------------------------------------------

    def _plan(self) -> Optional[Tuple[int, Dict[str, Any]]]:
        meta = self.source.plan(self._rows_limit)
        if meta is None:
            return None
        self.batch_id += 1
        bid = self.batch_id
        if self.checkpoint_dir:
            # the WAL write: once this lands, the batch WILL run (now
            # or as a post-restart replay) — the exactly-once anchor
            _atomic_write_json(self._log_path(OFFSETS_DIR, bid),
                               {"batch_id": bid, "offset": meta,
                                "planned_unix": round(time.time(), 3)})
        return bid, meta

    def _sink_call(self, batch_id: int, df: DataFrame) -> None:
        sink = self.sink
        if sink is None:
            return
        fn = sink.process if hasattr(sink, "process") else sink

        attempts = {"n": 0}

        def once():
            attempts["n"] += 1
            if attempts["n"] > 1:
                self.n_sink_retries += 1
            if self.breaker is not None:
                return self.breaker.call(lambda: fn(batch_id, df))
            return fn(batch_id, df)

        # CircuitOpen is retryable here by design: the breaker halves
        # open after its recovery timeout and the SAME batch goes again
        # — a streaming engine may never skip a planned batch
        self.retry_policy.call(once)

    def _process(self, batch_id: int, meta: Dict[str, Any],
                 replayed: bool = False) -> None:
        t_batch = self.clock.now()
        with self.tracer.span("stream_batch",
                              route=f"stream:{self.name}",
                              batch=batch_id, replayed=replayed) as sp:
            t0 = self.clock.now()
            df = self.source.read(meta)
            self.tracer.add("read", t0, self.clock.now(), parent=sp,
                            rows=df.num_rows)
            if self.transform is not None and df.num_rows:
                t0 = self.clock.now()
                df = self.transform(df)
                self.tracer.add("transform", t0, self.clock.now(),
                                parent=sp)
            out, late = self._advance_event_time(df)
            if out is not None and out.num_rows:
                t0 = self.clock.now()
                try:
                    self._sink_call(batch_id, out)
                except Exception:
                    self.n_sink_failures += 1
                    raise
                dt_ms = (self.clock.now() - t0) * 1000.0
                self._m_sink_ms.observe(dt_ms)
                self._note_sink_latency(dt_ms)
                self.tracer.add("sink", t0, self.clock.now(), parent=sp,
                                rows=out.num_rows)
            t0 = self.clock.now()
            if self.checkpoint_dir:
                entry: Dict[str, Any] = {
                    "batch_id": batch_id,
                    "watermark": self.watermark,
                    "max_event_time": self.max_event_time,
                    "n_rows": int(df.num_rows),
                    "committed_unix": round(time.time(), 3)}
                if self._window_state is not None:
                    entry["window_state"] = self._window_state.to_json()
                _atomic_write_json(
                    self._log_path(COMMITS_DIR, batch_id), entry)
                self._prune_logs()
            self.source.ack(meta)
            self.tracer.add("commit", t0, self.clock.now(), parent=sp)
        with self._lock:
            self.n_batches += 1
            self.n_rows += int(df.num_rows)
            self.n_late_rows += late
            if replayed:
                self.n_replayed_batches += 1
        self._m_batch_ms.observe((self.clock.now() - t_batch) * 1000.0)

    def _advance_event_time(self, df: DataFrame
                            ) -> Tuple[Optional[DataFrame], int]:
        """Watermark + window bookkeeping for one batch. Returns the
        frame the sink should see and the late-row count."""
        if self.event_time_col is None:
            return df, 0
        late = 0
        if df.num_rows and self.event_time_col in df:
            times = np.asarray(df[self.event_time_col], dtype=np.float64)
            # late vs the watermark as of batch START: rows the
            # downstream state may already have finalized past
            wm = self.watermark
            late_mask = (times < wm) if wm is not None \
                else np.zeros(len(times), dtype=bool)
            late = int(late_mask.sum())
            if self._window_state is not None:
                self._window_state.update(times, df, ~late_mask)
            batch_max = float(times.max())
            self.max_event_time = batch_max \
                if self.max_event_time is None \
                else max(self.max_event_time, batch_max)
            new_wm = self.max_event_time - self.watermark_delay_s
            # monotone: event time regressing never pulls it back
            if self.watermark is None or new_wm > self.watermark:
                self.watermark = new_wm
        if self._window_state is None:
            return df, late
        emitted = None
        if self.watermark is not None:
            emitted = self._window_state.close_until(self.watermark)
        if emitted is not None:
            self.n_windows_emitted += emitted.num_rows
        return emitted, late

    def _note_sink_latency(self, dt_ms: float) -> None:
        ew = self._sink_ms_ewma
        self._sink_ms_ewma = dt_ms if ew is None \
            else 0.7 * ew + 0.3 * dt_ms
        # multiplicative rate adaptation, bounded per step so one
        # outlier batch can't collapse (or explode) the budget
        ratio = self.target_batch_ms / max(self._sink_ms_ewma, 1e-3)
        ratio = min(max(ratio, 0.5), 2.0)
        self._rows_limit = int(min(max(self._rows_limit * ratio,
                                       self.min_batch_rows),
                                   self.max_batch_rows))

    # -- driving -------------------------------------------------------------

    def run_once(self) -> bool:
        """Process one micro-batch if the source has data (replays
        first). Returns True when a batch was processed. Terminal
        failures re-raise after recording state."""
        if self.state == "failed":
            raise StreamingQueryError(
                f"query {self.name!r} already failed: {self.error!r}")
        try:
            if self._replay:
                bid, meta = self._replay.pop(0)
                self._process(bid, meta, replayed=True)
                return True
            planned = self._plan()
            if planned is None:
                return False
            self._process(*planned)
            return True
        except Exception as e:
            self.state = "failed"
            self.error = e
            self._terminated.set()
            logger.error("streaming query %r failed on batch %d: %s",
                         self.name, self.batch_id, e)
            raise

    def process_available(self, max_batches: Optional[int] = None) -> int:
        """Synchronous drain: run batches until the source is idle (or
        ``max_batches``). The deterministic test/driver mode."""
        n = 0
        while max_batches is None or n < max_batches:
            if not self.run_once():
                break
            n += 1
        return n

    def _run_loop(self) -> None:
        try:
            while not self._stop.is_set():
                if not self.run_once():
                    self._stop.wait(self.trigger_interval_s)
        except Exception:  # noqa: BLE001 — recorded by run_once; the
            pass           # thread must die quietly, status() says why
        finally:
            if self.state != "failed":
                self.state = "terminated"
            self._terminated.set()

    def start(self) -> "StreamingQuery":
        if self._thread is not None and self._thread.is_alive():
            raise StreamingQueryError(f"query {self.name!r} already "
                                      "running")
        self.state = "running"
        self._stop.clear()
        self._terminated.clear()
        self._thread = threading.Thread(
            target=self._run_loop, daemon=True,
            name=f"stream-{self.name}")
        self._thread.start()
        return self

    def stop(self, timeout: float = 10.0) -> None:
        self._stop.set()
        t = self._thread
        if t is not None and t.is_alive():
            t.join(timeout)
        if self.state == "running":
            self.state = "terminated"
        self._terminated.set()

    def await_termination(self, timeout: Optional[float] = None) -> bool:
        """Block until the query terminates (stop() or failure).
        Returns True when it did."""
        return self._terminated.wait(timeout)

    @property
    def exception(self) -> Optional[BaseException]:
        return self.error

    def status(self) -> Dict[str, Any]:
        with self._lock:
            st: Dict[str, Any] = {
                "name": self.name,
                "state": self.state,
                "batch_id": self.batch_id,
                "watermark": self.watermark,
                "max_event_time": self.max_event_time,
                "rows_limit": self._rows_limit,
                "sink_ms_ewma": (round(self._sink_ms_ewma, 3)
                                 if self._sink_ms_ewma is not None
                                 else None),
                "n_batches": self.n_batches,
                "n_rows": self.n_rows,
                "n_late_rows": self.n_late_rows,
                "n_replayed_batches": self.n_replayed_batches,
                "n_sink_retries": self.n_sink_retries,
                "n_sink_failures": self.n_sink_failures,
                "n_windows_emitted": self.n_windows_emitted,
                "pending_replays": len(self._replay),
                "error": (f"{type(self.error).__name__}: {self.error}"
                          if self.error is not None else None),
            }
        try:
            st["source_backlog"] = int(self.source.backlog())
        except Exception:  # noqa: BLE001
            st["source_backlog"] = None
        if self.window is not None:
            st["open_windows"] = len(self._window_state.windows)
        return st

    def __enter__(self) -> "StreamingQuery":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()
