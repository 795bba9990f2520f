"""The retrospective plane: an embedded, bounded metrics TSDB.

The port's copy of ``mmlspark_tpu/core/tsdb.py``. The SLO engine can
*alert* but the stack cannot *remember*: every
sample older than the burn windows is gone, so "what did decode TTFT
p95 look like over the last hour, per tenant, before the alert fired?"
needed an external Prometheus. This module closes that gap with four
pieces, all in-process and all bounded:

* :func:`take_scrape` / :class:`Scrape` — ONE pass over a set of
  :class:`~mmlspark_tpu_torch.core.telemetry.MetricsRegistry` instances,
  capturing names, kinds, bucket edges, and child values together.
  From one scrape you can render the text exposition (the ``.prom``
  dumper), flatten ingest rows for the store, and build the SLO
  engine's snapshot dict — so the dumper, the TSDB, and the SLO
  history all ride a single scrape per interval instead of three.
* :class:`TimeSeriesStore` — series keyed by ``(name, labels)`` with
  tiered downsampling rings (raw -> 10s -> 60s by default), per-tier
  retention eviction, and counter-reset-aware ingest: every point
  carries both its raw value and a monotonic *adjusted* value whose
  deltas are clamped exactly like the SLO engine's (a worker restart
  reads as "no traffic", never negative traffic), so ``rate()`` is
  exact across resets.
* a query plane — :meth:`TimeSeriesStore.query` (instant) and
  :meth:`TimeSeriesStore.query_range` (series) over a small PromQL-
  shaped grammar: label matchers (``=``, ``!=``, ``=~``, ``!~``),
  ``rate()``/``increase()`` over counters, and
  ``quantile(q, hist[window])`` over histogram buckets (reusing
  :func:`~mmlspark_tpu_torch.core.telemetry.quantile_from_buckets`). The
  serving worker serves this at ``GET /query`` / ``GET /query_range``
  and the coordinator fans out + merges per-worker series under
  ``worker=host:port`` labels.
* baseline-relative regression detection — :class:`RecordingRule`
  precomputes hot series (per-bucket dispatch p95, decode TTFT/TPOT,
  tokens/s, recompile rate, per-tenant shed + device-time rates) each
  tick, and :class:`AnomalyDetector` runs an EWMA + MAD z-score over
  the recorded series: warm-up guarded (no verdict before
  ``min_samples``), baseline frozen while violated (a sustained
  regression cannot teach itself normal), hysteresis via the same
  ``ok -> pending -> firing -> resolved`` state machine the SLO
  engine uses, transitions delivered through the same
  :class:`~mmlspark_tpu_torch.serving.slo.AlertNotifier`.

Everything is fed by a background :class:`Recorder` on the
MetricsSnapshot cadence at a perf-gated ingest budget
(``bench.py tsdb_overhead_v1`` enforces it). Nothing here touches a
request hot path: the recorder scrapes exposition-time views, exactly
like ``GET /metrics`` does.
"""

from __future__ import annotations

import re
import threading
import time
from collections import deque
from typing import Any, Dict, Iterable, List, Optional, Tuple

from mmlspark_tpu_torch.core.resilience import Clock, SYSTEM_CLOCK
from mmlspark_tpu_torch.core.telemetry import (
    MetricsRegistry, quantile_from_buckets,
    _escape_help, _escape_label, _fmt,
)

__all__ = [
    "Scrape", "take_scrape", "TimeSeriesStore", "DEFAULT_TIERS",
    "QueryError", "parse_duration", "parse_expr",
    "RecordingRule", "default_serving_rules",
    "AnomalyWatch", "AnomalyDetector", "default_serving_watches",
    "Recorder",
]


# ---------------------------------------------------------------------------
# One scrape, three consumers
# ---------------------------------------------------------------------------

class Scrape:
    """One captured pass over a set of registries.

    ``entries`` is a list of ``(name, kind, help, label_names, edges,
    children)`` in exposition order (per-registry, families sorted by
    name); ``children`` is a sorted list of ``(label_key, value)``
    where value is a float (counter/gauge) or ``(buckets, sum, count)``
    (histogram, per-bucket counts with the +Inf overflow last).
    """

    __slots__ = ("at", "entries")

    def __init__(self, at: float, entries: List[tuple]):
        self.at = float(at)
        self.entries = entries

    # -- consumer 1: the .prom dumper ----------------------------------------

    def render(self) -> str:
        """The Prometheus text exposition of this scrape — the same
        bytes :meth:`MetricsRegistry.render` would emit (no
        exemplars), produced WITHOUT touching the registries again."""
        lines: List[str] = []
        for name, kind, help_, label_names, edges, children in \
                self.entries:
            lines.append(f"# HELP {name} {_escape_help(help_)}")
            lines.append(f"# TYPE {name} {kind}")
            for key, val in children:
                label_str = _label_str(label_names, key)
                if kind != "histogram":
                    lines.append(f"{name}{label_str} {_fmt(val)}")
                    continue
                buckets, total, count = val
                cum = 0
                for edge, n in zip(edges, buckets):
                    cum += n
                    lines.append(
                        f"{name}_bucket"
                        f"{_label_str(label_names, key, ('le', _fmt(edge)))}"
                        f" {cum}")
                cum += buckets[-1]
                lines.append(
                    f"{name}_bucket"
                    f"{_label_str(label_names, key, ('le', '+Inf'))}"
                    f" {cum}")
                lines.append(f"{name}_sum{label_str} {_fmt(total)}")
                lines.append(f"{name}_count{label_str} {count}")
        return "\n".join(lines) + ("\n" if lines else "")

    # -- consumer 2: TSDB ingest rows ----------------------------------------

    def rows(self) -> Iterable[Tuple[str, Tuple[Tuple[str, str], ...],
                                     float, str]]:
        """Flat ``(name, labels, value, kind)`` ingest rows, kind in
        ``{"c", "g"}``. Histograms expand to the standard cumulative
        ``_bucket``/``_sum``/``_count`` series (all counters), exactly
        mirroring the exposition — so a ``quantile()`` query reads the
        same numbers a Prometheus scraping ``/metrics`` would."""
        for name, kind, _help, label_names, edges, children in \
                self.entries:
            k = "g" if kind == "gauge" else "c"
            for key, val in children:
                labels = tuple(zip(label_names, key))
                if kind != "histogram":
                    yield name, labels, float(val), k
                    continue
                buckets, total, count = val
                cum = 0
                for edge, n in zip(edges, buckets):
                    cum += n
                    yield (f"{name}_bucket",
                           labels + (("le", _fmt(edge)),), float(cum),
                           "c")
                cum += buckets[-1]
                yield (f"{name}_bucket", labels + (("le", "+Inf"),),
                       float(cum), "c")
                yield f"{name}_sum", labels, float(total), "c"
                yield f"{name}_count", labels, float(count), "c"

    # -- consumer 3: the SLO engine's snapshot history -----------------------

    def slo_snapshot(self, wanted: Iterable[str]) -> dict:
        """The exact dict shape :meth:`SLOEngine._collect` builds —
        ``{metric: (kind, edges, label_names, {key: value})}`` with
        histogram values as per-bucket count lists — restricted to
        ``wanted`` metric names, so the engine's history can be fed
        from this scrape instead of taking its own."""
        wanted = set(wanted)
        snap: dict = {}
        for name, kind, _help, label_names, edges, children in \
                self.entries:
            if name not in wanted:
                continue
            if kind == "histogram":
                snap[name] = ("h", edges, label_names,
                              {key: list(val[0])
                               for key, val in children})
            else:
                snap[name] = ("c", None, label_names,
                              {key: float(val) for key, val in children})
        return snap


def _label_str(label_names: Tuple[str, ...], key: Tuple[str, ...],
               extra: Optional[Tuple[str, str]] = None) -> str:
    pairs = [f'{n}="{_escape_label(v)}"'
             for n, v in zip(label_names, key)]
    if extra is not None:
        pairs.append(f'{extra[0]}="{_escape_label(extra[1])}"')
    return "{" + ",".join(pairs) + "}" if pairs else ""


def take_scrape(*registries: MetricsRegistry,
                at: Optional[float] = None) -> Scrape:
    """One pass over ``registries`` capturing every family's kind,
    edges, and child values — the single scrape the dumper, the TSDB,
    and the SLO history share. ``at`` stamps the scrape (the
    recorder's clock); defaults to ``time.monotonic()``."""
    entries: List[tuple] = []
    for reg in registries:
        for fam in reg.families():
            if fam.kind == "histogram":
                children = []
                for key, c in sorted(fam.children()):
                    s = c.stats()
                    children.append(
                        (key, (s["buckets"], s["sum"], s["count"])))
                entries.append((fam.name, "histogram", fam.help,
                                fam.label_names, fam.buckets, children))
            else:
                children = [(key, float(c.value))
                            for key, c in sorted(fam.children())]
                entries.append((fam.name, fam.kind, fam.help,
                                fam.label_names, None, children))
    return Scrape(time.monotonic() if at is None else at, entries)


# ---------------------------------------------------------------------------
# The store: tiered rings, counter-reset-aware
# ---------------------------------------------------------------------------

#: default tiers as ``(resolution_s, retention_s)``: raw points for
#: 5 min, one point per 10 s for 30 min, one point per 60 s for 6 h.
#: Resolution 0 means "every scrape" (the raw ring).
DEFAULT_TIERS: Tuple[Tuple[float, float], ...] = (
    (0.0, 300.0),
    (10.0, 1800.0),
    (60.0, 21600.0),
)


class _Series:
    """One ``(name, labels)`` series: the reset-adjusted accumulator
    plus one ring per tier. Every stored point is ``(ts, raw,
    adjusted)`` — instant queries return ``raw``; ``rate()`` /
    ``increase()`` difference ``adjusted``, which only ever grows for
    counters (resets clamped at ingest, the SLOEngine delta idiom)."""

    __slots__ = ("name", "labels", "kind", "last_raw", "adjusted",
                 "rings", "cur_bucket", "pending")

    def __init__(self, name: str, labels: Tuple[Tuple[str, str], ...],
                 kind: str, n_tiers: int):
        self.name = name
        self.labels = labels
        self.kind = kind                      # "c" or "g"
        self.last_raw: Optional[float] = None
        self.adjusted = 0.0
        self.rings: List[deque] = [deque() for _ in range(n_tiers)]
        # per COARSE tier (index 1..): the open downsample bucket id
        # and its last-sample-wins pending point
        self.cur_bucket: List[Optional[int]] = [None] * n_tiers
        self.pending: List[Optional[tuple]] = [None] * n_tiers


class QueryError(ValueError):
    """A malformed query expression (HTTP callers get a 400)."""


_DURATION_RE = re.compile(r"^\s*(\d+(?:\.\d+)?)\s*(ms|s|m|h)?\s*$")
_DUR_SCALE = {"ms": 0.001, "s": 1.0, "m": 60.0, "h": 3600.0, None: 1.0}


def parse_duration(text: str) -> float:
    """``"150ms" | "10s" | "5m" | "1h" | "30"`` -> seconds."""
    m = _DURATION_RE.match(str(text))
    if not m:
        raise QueryError(f"bad duration {text!r}")
    return float(m.group(1)) * _DUR_SCALE[m.group(2)]


_FUNC_RE = re.compile(
    r"^\s*(rate|increase)\s*\(\s*(.+?)\s*\[\s*([^\]]+)\s*\]\s*\)\s*$")
_QUANT_RE = re.compile(
    r"^\s*quantile\s*\(\s*(\d*\.?\d+)\s*,\s*(.+?)"
    r"\s*\[\s*([^\]]+)\s*\]\s*\)\s*$")
_SEL_RE = re.compile(
    r"^\s*([a-zA-Z_:][a-zA-Z0-9_:]*)\s*(\{.*\})?\s*$")
_MATCHER_RE = re.compile(
    r'([a-zA-Z_][a-zA-Z0-9_]*)\s*(=~|!~|!=|=)\s*"((?:[^"\\]|\\.)*)"')
_MATCHERS_OK_RE = re.compile(
    r'^\{\s*(?:[a-zA-Z_][a-zA-Z0-9_]*\s*(?:=~|!~|!=|=)\s*'
    r'"(?:[^"\\]|\\.)*"\s*,?\s*)*\}$')


class _Matcher:
    __slots__ = ("label", "op", "value", "_re")

    def __init__(self, label: str, op: str, value: str):
        self.label = label
        self.op = op
        self.value = value
        self._re = None
        if op in ("=~", "!~"):
            try:
                # anchored like PromQL: the pattern must match the
                # WHOLE label value
                self._re = re.compile(value)
            except re.error as e:
                raise QueryError(f"bad regex {value!r}: {e}") from e

    def match(self, have: Dict[str, str]) -> bool:
        v = have.get(self.label, "")
        if self.op == "=":
            return v == self.value
        if self.op == "!=":
            return v != self.value
        hit = self._re.fullmatch(v) is not None
        return hit if self.op == "=~" else not hit


def _parse_selector(text: str) -> Tuple[str, List[_Matcher]]:
    m = _SEL_RE.match(text)
    if not m:
        raise QueryError(f"bad selector {text!r}")
    name, raw = m.groups()
    matchers: List[_Matcher] = []
    if raw:
        if not _MATCHERS_OK_RE.match(raw):
            raise QueryError(f"bad label matchers {raw!r}")
        for label, op, value in _MATCHER_RE.findall(raw):
            matchers.append(_Matcher(label, op,
                                     value.replace('\\"', '"')
                                          .replace("\\\\", "\\")))
    return name, matchers


def parse_expr(expr: str) -> tuple:
    """Parse one query expression into its evaluation form:

    * ``name{label="v",other=~"re"}``      -> ``("instant", ...)``
    * ``rate(sel[window])``                -> ``("rate", ...)``
    * ``increase(sel[window])``            -> ``("increase", ...)``
    * ``quantile(0.95, hist[window])``     -> ``("quantile", ...)``

    Raises :class:`QueryError` on anything else."""
    m = _QUANT_RE.match(expr)
    if m:
        q = float(m.group(1))
        if not 0.0 <= q <= 1.0:
            raise QueryError(f"quantile must be in [0, 1], got {q}")
        name, matchers = _parse_selector(m.group(2))
        return "quantile", q, name, matchers, parse_duration(m.group(3))
    m = _FUNC_RE.match(expr)
    if m:
        name, matchers = _parse_selector(m.group(2))
        return m.group(1), name, matchers, parse_duration(m.group(3))
    name, matchers = _parse_selector(expr)
    return "instant", name, matchers


class TimeSeriesStore:
    """Bounded in-process time-series storage with tiered
    downsampling.

    ``tiers`` is ``((resolution_s, retention_s), ...)`` finest first;
    resolution 0 = the raw ring (one point per scrape). Downsampling
    is last-sample-wins per resolution bucket — correct for the
    cumulative counters and gauges the exposition carries (a counter's
    last sample in a window IS its state at the window's edge), and it
    keeps the adjusted accumulator exact across tiers. Retention is
    enforced at ingest from each series' newest timestamp, so memory
    is bounded by ``retention / resolution`` points per tier per
    series and ``max_series`` series overall (past the cap new series
    are dropped and counted, never grown without bound)."""

    def __init__(self,
                 tiers: Tuple[Tuple[float, float], ...] = DEFAULT_TIERS,
                 max_series: int = 8192,
                 lookback_s: float = 300.0,
                 raw_max_points: int = 4096):
        tiers = tuple((float(r), float(ret)) for r, ret in tiers)
        if not tiers or tiers[0][0] != 0.0:
            raise ValueError(
                "tiers must start with the raw ring (resolution 0), "
                f"got {tiers!r}")
        if any(a[0] >= b[0] for a, b in zip(tiers[1:], tiers[2:])):
            raise ValueError(
                f"tier resolutions must be increasing: {tiers!r}")
        self.tiers = tiers
        self.max_series = int(max_series)
        self.lookback_s = float(lookback_s)
        self.raw_max_points = int(raw_max_points)
        self._series: Dict[Tuple[str, Tuple[Tuple[str, str], ...]],
                           _Series] = {}
        self._lock = threading.Lock()
        self._last_ts: Optional[float] = None
        self.n_points = 0
        self.n_dropped_series = 0

    # -- ingest --------------------------------------------------------------

    def ingest(self, scrape: Scrape) -> int:
        """Ingest one :class:`Scrape`; returns points written."""
        return self.ingest_rows(scrape.at, scrape.rows())

    def ingest_rows(self, ts: float,
                    rows: Iterable[Tuple[str, tuple, float, str]]
                    ) -> int:
        ts = float(ts)
        n = 0
        with self._lock:
            for name, labels, value, kind in rows:
                if self._write_locked(ts, name, tuple(labels), value,
                                      kind):
                    n += 1
            if self._last_ts is None or ts > self._last_ts:
                self._last_ts = ts
        return n

    def write(self, ts: float, name: str, labels: Any, value: float,
              kind: str = "g") -> bool:
        """One derived point (recording rules, tests). ``labels`` is a
        dict or a tuple of pairs."""
        if isinstance(labels, dict):
            labels = tuple(sorted(labels.items()))
        with self._lock:
            ok = self._write_locked(float(ts), name, tuple(labels),
                                    float(value), kind)
            if ok and (self._last_ts is None or ts > self._last_ts):
                self._last_ts = float(ts)
            return ok

    def _write_locked(self, ts: float, name: str, labels: tuple,
                      value: float, kind: str) -> bool:
        key = (name, labels)
        s = self._series.get(key)
        if s is None:
            if len(self._series) >= self.max_series:
                self.n_dropped_series += 1
                return False
            s = _Series(name, labels, kind, len(self.tiers))
            self._series[key] = s
        # counter-reset-aware adjustment (the SLOEngine delta clamp): a
        # value below its predecessor is a restart — the delta is the
        # post-reset count, never negative
        if s.kind == "c":
            prev = s.last_raw
            if prev is None:
                s.adjusted = value
            else:
                s.adjusted += (value - prev) if value >= prev else value
        else:
            s.adjusted = value
        s.last_raw = value
        point = (ts, value, s.adjusted)
        raw = s.rings[0]
        raw.append(point)
        raw_keep = self.tiers[0][1]
        while raw and (ts - raw[0][0] > raw_keep
                       or len(raw) > self.raw_max_points):
            raw.popleft()
        # roll into the coarser tiers: last sample wins inside a
        # resolution bucket; the bucket flushes when a sample lands in
        # a NEWER bucket (queries read the open bucket via `pending`)
        for i in range(1, len(self.tiers)):
            res, keep = self.tiers[i]
            b = int(ts // res)
            if s.cur_bucket[i] is None or b == s.cur_bucket[i]:
                s.cur_bucket[i] = b
                s.pending[i] = point
                continue
            if s.pending[i] is not None:
                ring = s.rings[i]
                ring.append(s.pending[i])
                while ring and ts - ring[0][0] > keep:
                    ring.popleft()
            s.cur_bucket[i] = b
            s.pending[i] = point
        self.n_points += 1
        return True

    # -- selection -----------------------------------------------------------

    def _select(self, name: str, matchers: List[_Matcher]
                ) -> List[_Series]:
        out = []
        for (n, _labels), s in self._series.items():
            if n != name:
                continue
            have = dict(s.labels)
            if all(m.match(have) for m in matchers):
                out.append(s)
        return out

    @staticmethod
    def _window_points(s: _Series, t0: float, t1: float) -> List[tuple]:
        """Every retained point in ``[t0, t1]``, merged across tiers
        (coarse history + fine recency; duplicate timestamps collapse,
        finest tier wins). Sorted by timestamp."""
        by_ts: Dict[float, tuple] = {}
        for i in range(len(s.rings) - 1, -1, -1):
            for p in s.rings[i]:
                if t0 <= p[0] <= t1:
                    by_ts[p[0]] = p
            if i > 0 and s.pending[i] is not None:
                p = s.pending[i]
                if t0 <= p[0] <= t1:
                    by_ts[p[0]] = p
        return [by_ts[k] for k in sorted(by_ts)]

    def _instant(self, s: _Series, at: float) -> Optional[float]:
        pts = self._window_points(s, at - self.lookback_s, at)
        return pts[-1][1] if pts else None

    def _delta(self, s: _Series, at: float, window: float,
               per_second: bool) -> Optional[float]:
        pts = self._window_points(s, at - window, at)
        if len(pts) < 2:
            return None
        d = pts[-1][2] - pts[0][2]
        if not per_second:
            return d
        span = pts[-1][0] - pts[0][0]
        return d / span if span > 0 else None

    def _quantile_groups(self, name: str, matchers: List[_Matcher]
                         ) -> Dict[tuple, List[Tuple[float, _Series]]]:
        """Histogram ``_bucket`` series grouped by their non-``le``
        labels: ``{group_labels: [(le_float, series), ...]}``."""
        groups: Dict[tuple, List[Tuple[float, _Series]]] = {}
        for s in self._select(name + "_bucket", matchers):
            have = dict(s.labels)
            le = have.pop("le", None)
            if le is None:
                continue
            edge = float("inf") if le == "+Inf" else float(le)
            groups.setdefault(tuple(sorted(have.items())),
                              []).append((edge, s))
        for rows in groups.values():
            rows.sort(key=lambda r: r[0])
        return groups

    def _quantile_at(self, rows: List[Tuple[float, _Series]], q: float,
                     at: float, window: float) -> Optional[float]:
        """One group's quantile over the window: cumulative adjusted
        deltas per ``le``, differenced into per-bucket counts, then
        :func:`quantile_from_buckets`."""
        edges: List[float] = []
        cums: List[float] = []
        for edge, s in rows:
            d = self._delta(s, at, window, per_second=False)
            if d is None:
                return None
            edges.append(edge)
            cums.append(d)
        if not edges or edges[-1] != float("inf"):
            return None
        counts = [cums[0]] + [cums[i] - cums[i - 1]
                              for i in range(1, len(cums))]
        # clamp scrape-skew artifacts: cumulative deltas are
        # monotone in `le` on any single scrape pair
        counts = [max(c, 0.0) for c in counts]
        return quantile_from_buckets(tuple(edges[:-1]), counts, q)

    # -- the query plane -----------------------------------------------------

    def query(self, expr: str, at: Optional[float] = None
              ) -> Dict[str, Any]:
        """Instant query: ``{"expr", "at", "results": [{"labels",
        "value"}, ...]}``. ``at`` defaults to the newest ingested
        timestamp (data-relative, so ManualClock tests and live
        workers read the same way)."""
        parsed = parse_expr(expr)
        with self._lock:
            at = self._resolve_at(at)
            results = self._eval_locked(parsed, at)
        return {"expr": expr, "at": at, "results": results}

    def query_range(self, expr: str, start: Optional[float] = None,
                    end: Optional[float] = None,
                    step: float = 10.0) -> Dict[str, Any]:
        """Range query: the expression evaluated at each ``step`` from
        ``start`` to ``end`` (inclusive), one ``{"labels", "points":
        [[ts, value], ...]}`` entry per series. Defaults: ``end`` =
        newest ingested timestamp, ``start`` = ``end - 300``. A
        NEGATIVE ``start`` is relative to ``end`` (``start=-600`` =
        the trailing 10 minutes) — store timestamps ride a monotonic
        clock a remote caller cannot know, relative windows are the
        usable remote form."""
        parsed = parse_expr(expr)
        step = float(step)
        if step <= 0:
            raise QueryError(f"step must be > 0, got {step}")
        with self._lock:
            end = self._resolve_at(end)
            start = float(start) if start is not None else -300.0
            if start < 0:
                start = end + start
            if end < start:
                raise QueryError(f"end {end} < start {start}")
            n_steps = int((end - start) / step) + 1
            if n_steps > 11_000:
                raise QueryError(
                    f"{n_steps} evaluation steps (max 11000) — raise "
                    "step or narrow the window")
            series: Dict[tuple, List[List[float]]] = {}
            order: List[tuple] = []
            for i in range(n_steps):
                t = start + i * step
                for row in self._eval_locked(parsed, t):
                    key = tuple(sorted(row["labels"].items()))
                    if key not in series:
                        series[key] = []
                        order.append(key)
                    series[key].append([t, row["value"]])
        return {"expr": expr, "start": start, "end": end, "step": step,
                "series": [{"labels": dict(k), "points": series[k]}
                           for k in order]}

    def _resolve_at(self, at: Optional[float]) -> float:
        if at is not None:
            return float(at)
        return self._last_ts if self._last_ts is not None else 0.0

    def _eval_locked(self, parsed: tuple, at: float
                     ) -> List[Dict[str, Any]]:
        out: List[Dict[str, Any]] = []
        if parsed[0] == "quantile":
            _, q, name, matchers, window = parsed
            for key, rows in sorted(
                    self._quantile_groups(name, matchers).items()):
                v = self._quantile_at(rows, q, at, window)
                if v is not None:
                    out.append({"labels": dict(key), "value": v})
            return out
        if parsed[0] in ("rate", "increase"):
            _, name, matchers, window = parsed
            for s in sorted(self._select(name, matchers),
                            key=lambda s: s.labels):
                v = self._delta(s, at, window,
                                per_second=parsed[0] == "rate")
                if v is not None:
                    out.append({"labels": dict(s.labels), "value": v})
            return out
        _, name, matchers = parsed
        for s in sorted(self._select(name, matchers),
                        key=lambda s: s.labels):
            v = self._instant(s, at)
            if v is not None:
                out.append({"labels": dict(s.labels), "value": v})
        return out

    # -- observability of the observer ---------------------------------------

    def status(self) -> Dict[str, Any]:
        with self._lock:
            tier_points = [0] * len(self.tiers)
            for s in self._series.values():
                for i, ring in enumerate(s.rings):
                    tier_points[i] += len(ring)
            return {
                "n_series": len(self._series),
                "max_series": self.max_series,
                "n_points_ingested": self.n_points,
                "n_dropped_series": self.n_dropped_series,
                "last_ts": self._last_ts,
                "tiers": [{"resolution_s": r, "retention_s": keep,
                           "points": tier_points[i]}
                          for i, (r, keep) in enumerate(self.tiers)],
            }


# ---------------------------------------------------------------------------
# Recording rules
# ---------------------------------------------------------------------------

class RecordingRule:
    """Precompute one hot expression per tick into a derived gauge
    series (the Prometheus ``level:metric:operation`` naming
    convention — colons are valid metric-name characters and signal
    "recorded, not scraped"). The rule's instant result rides the same
    tiers/retention as scraped series, so ``/query_range`` answers
    over it directly without re-deriving per step."""

    def __init__(self, record: str, expr: str,
                 labels: Optional[Dict[str, str]] = None):
        self.record = str(record)
        self.expr = str(expr)
        self._parsed = parse_expr(self.expr)   # fail at construction
        self.static = dict(labels or {})
        self.n_errors = 0

    def evaluate(self, store: TimeSeriesStore, now: float) -> int:
        n = 0
        res = store.query(self.expr, at=now)
        for row in res["results"]:
            labels = dict(row["labels"])
            labels.update(self.static)
            store.write(now, self.record, labels, row["value"],
                        kind="g")
            n += 1
        return n

    def to_dict(self) -> Dict[str, Any]:
        out = {"record": self.record, "expr": self.expr}
        if self.static:
            out["labels"] = dict(self.static)
        return out

    @classmethod
    def from_value(cls, value: Any) -> "RecordingRule":
        if isinstance(value, RecordingRule):
            return value
        if isinstance(value, dict):
            return cls(**value)
        raise ValueError(
            f"cannot build a RecordingRule from {type(value).__name__}")


def default_serving_rules(has_decoder: bool = False,
                          has_tenancy: bool = False
                          ) -> List[RecordingRule]:
    """The stock per-worker recording rules: the hot series an
    operator asks for first, precomputed every tick."""
    rules = [
        RecordingRule("serving:dispatch_latency_ms:p95",
                      "quantile(0.95, serving_dispatch_latency_ms"
                      "[300s])"),
        RecordingRule("serving:requests:rate1m",
                      "rate(serving_requests_total[60s])"),
        RecordingRule("serving:errors:rate1m",
                      "rate(serving_errors_total[60s])"),
        RecordingRule("serving:recompiles:rate5m",
                      "rate(serving_recompiles_total[300s])"),
        RecordingRule("serving:tenant_device_ms:rate5m",
                      "rate(serving_tenant_device_ms_total[300s])"),
    ]
    if has_decoder:
        rules += [
            RecordingRule("serving:decode_ttft_ms:p95",
                          "quantile(0.95, serving_decode_ttft_ms"
                          "[300s])"),
            RecordingRule("serving:decode_tpot_ms:p95",
                          "quantile(0.95, serving_decode_tpot_ms"
                          "[300s])"),
            RecordingRule("serving:decode_tokens:rate1m",
                          "rate(serving_decode_tokens_total[60s])"),
        ]
    if has_tenancy:
        rules.append(
            RecordingRule("serving:tenant_shed:rate5m",
                          "rate(serving_tenant_shed_total[300s])"))
    return rules


# ---------------------------------------------------------------------------
# Baseline-relative anomaly detection
# ---------------------------------------------------------------------------

class AnomalyWatch:
    """One watched expression: fire when the instant value deviates
    from its own EWMA baseline by more than ``z_threshold`` robust
    z-units (EWMA of absolute deviation, MAD-style, scaled by 1.4826
    to estimate sigma) AND by at least ``min_abs`` in raw units (the
    absolute floor keeps a near-zero-variance baseline from turning
    measurement noise into sigmas). No verdict before ``min_samples``
    baseline points (warm-up guard); hysteresis via ``for_s`` /
    ``resolve_after_s`` exactly like an SLO policy."""

    def __init__(self, name: str, expr: str, direction: str = "high",
                 z_threshold: float = 6.0, min_samples: int = 30,
                 alpha: float = 0.1, min_abs: float = 0.0,
                 for_s: float = 0.0, resolve_after_s: float = 60.0):
        if direction not in ("high", "low", "both"):
            raise ValueError(f"unknown direction {direction!r}")
        self.name = str(name)
        self.expr = str(expr)
        self._parsed = parse_expr(self.expr)   # fail at construction
        self.direction = direction
        self.z_threshold = float(z_threshold)
        self.min_samples = int(min_samples)
        self.alpha = float(alpha)
        self.min_abs = float(min_abs)
        self.for_s = float(for_s)
        self.resolve_after_s = float(resolve_after_s)

    @classmethod
    def from_value(cls, value: Any) -> "AnomalyWatch":
        if isinstance(value, AnomalyWatch):
            return value
        if isinstance(value, dict):
            return cls(**value)
        raise ValueError(
            f"cannot build an AnomalyWatch from {type(value).__name__}")

    def to_dict(self) -> Dict[str, Any]:
        return {"name": self.name, "expr": self.expr,
                "direction": self.direction,
                "z_threshold": self.z_threshold,
                "min_samples": self.min_samples, "alpha": self.alpha,
                "min_abs": self.min_abs, "for_s": self.for_s,
                "resolve_after_s": self.resolve_after_s}


class _WatchState:
    """Per-(watch, labelset) detector state: the EWMA baseline and an
    alert state machine with the SLO engine's exact lifecycle
    (``ok -> pending --for_s--> firing --quiet resolve_after_s-->
    resolved``, quiet clock counted from the last violated tick)."""

    __slots__ = ("ewma", "mad", "n", "last_value", "last_z",
                 "state", "pending_since", "last_violated", "fired_at",
                 "resolved_at", "n_fired", "n_resolved")

    def __init__(self):
        self.ewma: Optional[float] = None
        self.mad = 0.0
        self.n = 0
        self.last_value: Optional[float] = None
        self.last_z: Optional[float] = None
        self.state = "ok"
        self.pending_since: Optional[float] = None
        self.last_violated: Optional[float] = None
        self.fired_at: Optional[float] = None
        self.resolved_at: Optional[float] = None
        self.n_fired = 0
        self.n_resolved = 0


def _advance_watch(st: _WatchState, violated: bool, now: float,
                   for_s: float, resolve_after_s: float
                   ) -> Optional[str]:
    """Advance one state machine; returns ``"firing"``/``"resolved"``
    on a notifiable transition, None otherwise (mirrors
    ``SLOEngine._advance_alert``)."""
    if violated:
        st.last_violated = now
        if st.state in ("ok", "resolved"):
            st.state = "pending"
            st.pending_since = now
        if st.state == "pending" and \
                now - (st.pending_since or now) >= for_s:
            st.state = "firing"
            st.fired_at = now
            st.n_fired += 1
            return "firing"
        return None
    if st.state == "pending":
        st.state = "ok"
        st.pending_since = None
    elif st.state == "firing":
        ref = st.last_violated if st.last_violated is not None \
            else (st.fired_at or now)
        if now - ref >= resolve_after_s:
            st.state = "resolved"
            st.resolved_at = now
            st.n_resolved += 1
            return "resolved"
    return None


class AnomalyDetector:
    """Baseline-relative regression detection over recorded series.

    Each tick (driven by the :class:`Recorder`), every watch's
    expression is evaluated instantly against the store and each
    resulting labelset is scored against its own EWMA + MAD baseline.
    The baseline is FROZEN while the point violates — a sustained
    regression cannot teach itself normal; it resolves when the cause
    reverts, which is exactly what the chaos drill exercises.
    Transitions flow through the same
    :class:`~mmlspark_tpu_torch.serving.slo.AlertNotifier` the SLO engine
    uses (when one is wired), with the violating series' labels as
    attribution."""

    def __init__(self, store: TimeSeriesStore,
                 watches: Iterable[AnomalyWatch],
                 clock: Clock = SYSTEM_CLOCK, notifier=None,
                 max_states: int = 1024):
        self.store = store
        self.watches = [AnomalyWatch.from_value(w) for w in watches]
        names = [w.name for w in self.watches]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate watch names in {names}")
        self.clock = clock
        self.notifier = notifier
        self.max_states = int(max_states)
        self._states: Dict[Tuple[str, tuple], _WatchState] = {}
        self._lock = threading.Lock()
        self.n_observations = 0
        self.n_states_dropped = 0

    def observe(self, now: Optional[float] = None
                ) -> List[Dict[str, Any]]:
        """One detection pass; returns (and notifies) the
        transitions."""
        now = self.clock.now() if now is None else float(now)
        transitions: List[Dict[str, Any]] = []
        with self._lock:
            self.n_observations += 1
            for watch in self.watches:
                res = self.store.query(watch.expr, at=now)
                for row in res["results"]:
                    key = (watch.name,
                           tuple(sorted(row["labels"].items())))
                    st = self._states.get(key)
                    if st is None:
                        if len(self._states) >= self.max_states:
                            self.n_states_dropped += 1
                            continue
                        st = self._states[key] = _WatchState()
                    ev = self._score(watch, st, row["labels"],
                                     float(row["value"]), now)
                    if ev is not None:
                        transitions.append(ev)
        if self.notifier is not None:
            for ev in transitions:
                self.notifier.notify(ev)
        return transitions

    def _score(self, watch: AnomalyWatch, st: _WatchState,
               labels: Dict[str, str], x: float, now: float
               ) -> Optional[Dict[str, Any]]:
        violated = False
        z = None
        if st.n >= watch.min_samples and st.ewma is not None:
            sigma = 1.4826 * st.mad + 1e-9
            dev = x - st.ewma
            z = dev / sigma
            if watch.direction == "high":
                violated = z > watch.z_threshold and dev >= watch.min_abs
            elif watch.direction == "low":
                violated = (z < -watch.z_threshold
                            and -dev >= watch.min_abs)
            else:
                violated = (abs(z) > watch.z_threshold
                            and abs(dev) >= watch.min_abs)
        st.last_value = x
        st.last_z = z
        if not violated:
            # the baseline learns ONLY from non-violating points: a
            # regression in progress must not drag its own baseline up
            # (it resolves when the cause reverts, not by habituation)
            if st.ewma is None:
                st.ewma = x
            else:
                a = watch.alpha
                st.mad = (1 - a) * st.mad + a * abs(x - st.ewma)
                st.ewma = (1 - a) * st.ewma + a * x
            st.n += 1
        kind = _advance_watch(st, violated, now, watch.for_s,
                              watch.resolve_after_s)
        if kind is None:
            return None
        return {"type": kind, "policy": watch.name,
                "slo_kind": "anomaly", "expr": watch.expr,
                "at_mono": now, "at_unix": time.time(),
                "labels": dict(labels),
                "value": x, "z": round(z, 3) if z is not None else None,
                "baseline": (round(st.ewma, 6)
                             if st.ewma is not None else None),
                "direction": watch.direction}

    # -- views ---------------------------------------------------------------

    def alerts(self) -> Dict[str, Any]:
        """The compact anomaly view merged into ``GET /alerts``: one
        entry per non-ok (or recently resolved) watch state, labels as
        attribution."""
        with self._lock:
            rows = []
            firing = 0
            for (name, labels), st in sorted(self._states.items()):
                if st.state == "firing":
                    firing += 1
                if st.state == "ok" and st.n_fired == 0:
                    continue
                rows.append({
                    "watch": name, "labels": dict(labels),
                    "state": st.state, "value": st.last_value,
                    "z": (round(st.last_z, 3)
                          if st.last_z is not None else None),
                    "baseline": (round(st.ewma, 6)
                                 if st.ewma is not None else None),
                    "fired_at": st.fired_at,
                    "resolved_at": st.resolved_at,
                    "n_fired": st.n_fired,
                })
            return {"firing": firing, "alerts": rows}

    def status(self) -> Dict[str, Any]:
        with self._lock:
            states = list(self._states.values())
            return {
                "n_watches": len(self.watches),
                "n_states": len(states),
                "n_observations": self.n_observations,
                "n_warming": sum(
                    1 for st in states
                    if st.n < max(w.min_samples
                                  for w in self.watches)),
                "firing": sum(1 for st in states
                              if st.state == "firing"),
                "n_fired": sum(st.n_fired for st in states),
            }


def default_serving_watches(has_decoder: bool = False
                            ) -> List[AnomalyWatch]:
    """The stock regression watches over the stock recording rules:
    deliberately conservative (z=6, absolute floors, 30-sample
    warm-up) — the acceptance bar is ZERO steady-state false
    positives; a real latency regression or recompile storm clears
    these thresholds by an order of magnitude."""
    watches = [
        AnomalyWatch("dispatch_p95_regression",
                     "serving:dispatch_latency_ms:p95",
                     direction="high", min_abs=5.0),
        AnomalyWatch("error_rate_regression",
                     "serving:errors:rate1m",
                     direction="high", min_abs=0.5),
        AnomalyWatch("recompile_storm",
                     "serving:recompiles:rate5m",
                     direction="high", min_abs=0.2),
    ]
    if has_decoder:
        watches += [
            AnomalyWatch("decode_ttft_regression",
                         "serving:decode_ttft_ms:p95",
                         direction="high", min_abs=25.0),
            AnomalyWatch("decode_tpot_regression",
                         "serving:decode_tpot_ms:p95",
                         direction="high", min_abs=5.0),
        ]
    return watches


# ---------------------------------------------------------------------------
# The recorder: one scrape per interval, four consumers
# ---------------------------------------------------------------------------

class Recorder:
    """The background pump of the retrospective plane.

    Each tick takes ONE scrape of the configured registries and feeds
    every consumer from it: TSDB ingest, the optional ``.prom`` dump
    (the :class:`~mmlspark_tpu_torch.core.telemetry.MetricsSnapshot` role —
    a server wiring a Recorder with ``snapshot_dir`` must NOT also run
    a MetricsSnapshot, that is exactly the double-scrape this class
    removes), and the optional SLO engine's snapshot history (via
    :meth:`SLOEngine.observe`). Recording rules and the anomaly
    detector then run over the freshly-ingested store.

    The scrape+ingest cost is measured every tick against
    ``ingest_budget_ms`` — ``last_ingest_ms`` / ``ewma_ingest_ms`` /
    ``n_over_budget`` make the observer's own overhead observable, and
    ``bench.py tsdb_overhead_v1`` gates it."""

    def __init__(self, registries: Iterable[MetricsRegistry],
                 store: Optional[TimeSeriesStore] = None,
                 interval_s: float = 10.0,
                 clock: Clock = SYSTEM_CLOCK,
                 snapshot_dir: Optional[str] = None,
                 snapshot_keep: int = 24,
                 snapshot_prefix: str = "metrics",
                 slo=None,
                 rules: Iterable[RecordingRule] = (),
                 detector: Optional[AnomalyDetector] = None,
                 ingest_budget_ms: float = 25.0):
        self.registries = tuple(registries)
        self.store = store if store is not None else TimeSeriesStore()
        self.interval_s = float(interval_s)
        self.clock = clock
        self.snapshot_dir = snapshot_dir
        self.snapshot_keep = int(snapshot_keep)
        self.snapshot_prefix = snapshot_prefix
        self.slo = slo
        self.rules = [RecordingRule.from_value(r) for r in rules]
        self.detector = detector
        self.ingest_budget_ms = float(ingest_budget_ms)
        self.n_scrapes = 0
        self.n_points = 0
        self.n_rule_errors = 0
        self.n_snapshot_errors = 0
        self.n_over_budget = 0
        self.last_ingest_ms = 0.0
        self.ewma_ingest_ms = 0.0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def record_now(self, now: Optional[float] = None) -> Dict[str, Any]:
        """One full tick: scrape once, feed every consumer. Never
        raises (telemetry must never kill the process); per-consumer
        failures are counted and logged."""
        now = self.clock.now() if now is None else float(now)
        t0 = time.perf_counter()
        scrape = take_scrape(*self.registries, at=now)
        n = self.store.ingest(scrape)
        # the perf-gated budget covers scrape + ingest — the part that
        # scales with registry size and runs unconditionally
        ms = (time.perf_counter() - t0) * 1000.0
        self.n_scrapes += 1
        self.n_points += n
        self.last_ingest_ms = ms
        self.ewma_ingest_ms = (ms if self.n_scrapes == 1
                               else 0.9 * self.ewma_ingest_ms + 0.1 * ms)
        if ms > self.ingest_budget_ms:
            self.n_over_budget += 1
        if self.slo is not None:
            try:
                self.slo.observe(
                    now, scrape.slo_snapshot(self.slo.wanted_metrics()))
            except Exception:  # noqa: BLE001 — never kill the tick
                from mmlspark_tpu_torch.core.logs import get_logger
                get_logger("tsdb").warning(
                    "SLO snapshot feed failed", exc_info=True)
        for rule in self.rules:
            try:
                rule.evaluate(self.store, now)
            except Exception:  # noqa: BLE001
                rule.n_errors += 1
                self.n_rule_errors += 1
        transitions: List[Dict[str, Any]] = []
        if self.detector is not None:
            try:
                transitions = self.detector.observe(now)
            except Exception:  # noqa: BLE001
                from mmlspark_tpu_torch.core.logs import get_logger
                get_logger("tsdb").warning(
                    "anomaly detection tick failed", exc_info=True)
        if self.snapshot_dir:
            try:
                from mmlspark_tpu_torch.core.telemetry import write_snapshot
                write_snapshot(self.snapshot_dir, scrape.render(),
                               prefix=self.snapshot_prefix,
                               keep=self.snapshot_keep)
            except Exception:  # noqa: BLE001
                self.n_snapshot_errors += 1
                from mmlspark_tpu_torch.core.logs import get_logger
                get_logger("tsdb").warning(
                    "metrics snapshot to %s failed", self.snapshot_dir,
                    exc_info=True)
        return {"at": now, "points": n, "ingest_ms": round(ms, 3),
                "transitions": transitions}

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.record_now()
            except Exception:  # noqa: BLE001 — belt over braces
                from mmlspark_tpu_torch.core.logs import get_logger
                get_logger("tsdb").warning(
                    "recorder tick raised", exc_info=True)

    def start(self) -> "Recorder":
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="tsdb-recorder")
        self._thread.start()
        return self

    def stop(self) -> None:
        """Stop the pump and take one final tick, so a clean shutdown
        leaves the terminal counters in the store and (when dumping)
        on disk — the MetricsSnapshot final-flush contract."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        try:
            self.record_now()
        except Exception:  # noqa: BLE001
            pass

    def __enter__(self) -> "Recorder":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def status(self) -> Dict[str, Any]:
        return {
            "interval_s": self.interval_s,
            "n_scrapes": self.n_scrapes,
            "n_points": self.n_points,
            "last_ingest_ms": round(self.last_ingest_ms, 3),
            "ewma_ingest_ms": round(self.ewma_ingest_ms, 3),
            "ingest_budget_ms": self.ingest_budget_ms,
            "n_over_budget": self.n_over_budget,
            "n_rule_errors": self.n_rule_errors,
            "n_snapshot_errors": self.n_snapshot_errors,
            "n_rules": len(self.rules),
            "snapshot_dir": self.snapshot_dir,
            "store": self.store.status(),
            "anomalies": (self.detector.status()
                          if self.detector is not None else None),
        }
