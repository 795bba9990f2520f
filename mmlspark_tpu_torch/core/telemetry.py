"""Unified telemetry: metrics registry, Prometheus exposition, trace ids
(the port's copy of ``mmlspark_tpu/core/telemetry.py``; its exposition,
parsers and remote-write encoding are the JAX package's byte for byte,
and ``serving_build_info`` names torch, CUDA and the card in its labels).

The reference's observability stops at wall-clock stage timing
(`pipeline-stages/Timer.scala:14-90`); sustained perf at pod scale is won
by continuous low-overhead production telemetry instead — step timings,
queue depths, per-stage histograms that are always on, not one-off
profiler traces. This module is the one place those primitives live so
every layer reports through the same surface:

* :class:`MetricsRegistry` — process-wide (or per-component) home for
  :class:`Counter` / :class:`Gauge` / :class:`Histogram` families with
  Prometheus-style labels. Hot-path updates are lock-striped (a bounded
  pool of locks shared round-robin across children, so a thousand
  metrics never allocate a thousand locks and two busy counters rarely
  contend) and cost well under 2 us each — cheap enough to leave on in
  production (the `perf`-marked test in ``tests/test_telemetry.py`` and
  the ``telemetry_overhead_v1`` bench both enforce the budget).
* :func:`MetricsRegistry.render` — the Prometheus text exposition format
  (``text/plain; version=0.0.4``), served by every worker's
  ``GET /metrics`` (``serving/server.py`` in the JAX package).
* :func:`parse_prometheus` / :func:`merge_prometheus` — the minimal
  scrape parser the serving coordinator uses to fold N workers' scrapes
  into one fleet view (sample values are summed across workers, so
  counters and histogram buckets aggregate exactly and per-worker gauges
  become fleet totals).
* ``trace_context`` — a :mod:`contextvars` carried ``X-Trace-Id``:
  generated (or adopted from the inbound header) at serving ingress,
  flowed through collect -> dispatch -> encode, stamped into journal
  lines, HTTP egress headers (``io/http.py``), and every
  log record (:mod:`mmlspark_tpu_torch.core.logs`).

Clocks are injectable (:class:`mmlspark_tpu_torch.core.resilience.Clock`), so
chaos tests drive :meth:`Histogram.time` spans deterministically.

Usage::

    from mmlspark_tpu_torch.core.telemetry import REGISTRY

    hits = REGISTRY.counter("cache_hits_total", "Cache hits.",
                            labels=("layer",))
    hot = hits.labels("l1")       # bind the child once, outside the loop
    hot.inc()                     # lock-striped, sub-microsecond

    lat = REGISTRY.histogram("rpc_latency_ms", "RPC wall-clock.")
    with lat.time():              # observes milliseconds on exit
        do_rpc()
"""

from __future__ import annotations

import contextlib
import contextvars
import itertools
import math
import os
import re
import struct
import threading
import time
import uuid
from bisect import bisect_left
from typing import (
    Any, Callable, Dict, Iterable, Iterator, List, Optional, Tuple,
)

from mmlspark_tpu_torch.core.resilience import Clock, SYSTEM_CLOCK

__all__ = [
    "BoundedLabelSet", "Counter", "Gauge", "Histogram",
    "MetricsRegistry", "REGISTRY",
    "DEFAULT_LATENCY_BUCKETS_MS", "log_buckets",
    "render_registries", "parse_prometheus", "merge_prometheus",
    "render_samples", "MetricsSnapshot", "snapshot_registries",
    "write_snapshot",
    "MetricsPusher", "quantile_from_buckets",
    "collect_samples", "encode_write_request", "compress_write_request",
    "snappy_available",
    "CONTENT_TYPE", "OPENMETRICS_CONTENT_TYPE",
    "REMOTE_WRITE_CONTENT_TYPE",
    "TRACE_HEADER", "new_trace_id", "current_trace_id", "trace_context",
    "trace_id_from_headers", "sanitize_trace_id",
]


# ---------------------------------------------------------------------------
# Lock striping
# ---------------------------------------------------------------------------

# children draw their update lock from this fixed pool round-robin: the
# common case (each hot child holds its own stripe) contends on nothing,
# while pathological label cardinality shares locks instead of allocating
# one per child forever
_N_STRIPES = 64
_STRIPES = tuple(threading.Lock() for _ in range(_N_STRIPES))
_stripe_counter = itertools.count()


def _next_stripe() -> threading.Lock:
    return _STRIPES[next(_stripe_counter) % _N_STRIPES]


# ---------------------------------------------------------------------------
# Buckets
# ---------------------------------------------------------------------------

def log_buckets(lo: float, hi: float) -> Tuple[float, ...]:
    """A 1-2.5-5 log-scale bucket ladder covering ``[lo, hi]``."""
    if lo <= 0 or hi <= lo:
        raise ValueError(f"need 0 < lo < hi, got ({lo}, {hi})")
    out: List[float] = []
    decade = 10.0 ** math.floor(math.log10(lo))
    while decade <= hi:
        for m in (1.0, 2.5, 5.0):
            edge = decade * m
            if lo <= edge <= hi:
                out.append(edge)
        decade *= 10.0
    return tuple(out)


def quantile_from_buckets(edges: Tuple[float, ...],
                          counts: List[int], q: float) -> Optional[float]:
    """Estimate the ``q``-quantile of a fixed-bucket histogram from
    its per-bucket counts (``len(edges) + 1`` entries, +Inf last) with
    linear interpolation inside the landing bucket — the
    ``histogram_quantile()`` PromQL estimate, computed locally. A rank
    landing in the +Inf bucket returns the top edge (the ladder's
    honest maximum); ``None`` on an empty histogram."""
    total = sum(counts)
    if total <= 0 or not edges:
        return None
    rank = q * total
    cum = 0
    lo = 0.0
    for edge, n in zip(edges, counts):
        if cum + n >= rank and n > 0:
            return lo + (rank - cum) / n * (edge - lo)
        cum += n
        lo = edge
    return float(edges[-1])


#: fixed log-scale latency ladder, in milliseconds: 0.1 ms .. 10 s.
#: Fixed (not per-metric-adaptive) so scrapes from different workers and
#: different build versions aggregate bucket-for-bucket in the fleet view.
DEFAULT_LATENCY_BUCKETS_MS: Tuple[float, ...] = (
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0,
    250.0, 500.0, 1000.0, 2500.0, 5000.0, 10000.0,
)

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")


class BoundedLabelSet:
    """Cap on tracked label values: past ``cap`` distinct values, new
    ones fold into the ``overflow`` key, so unbounded input domains
    (hosts in a URL column, breaker names) cannot grow a long-lived
    process's registry and exposition without limit.

    :meth:`key` returns ``(label_value, overflowed)`` — callers skip
    non-aggregatable samples (e.g. a state gauge, which would be
    last-writer-wins across unrelated overflow members) when
    ``overflowed`` is True.
    """

    def __init__(self, cap: int = 256, overflow: str = "other"):
        self.cap = int(cap)
        self.overflow = overflow
        self._seen: set = set()
        #: monotonic count of :meth:`key` calls that folded into the
        #: overflow label — the observable evidence that the cap is
        #: too small for the live value domain (per-tenant metric rows
        #: surface it so an operator sees "other" is hiding tenants)
        self.n_overflowed = 0

    def key(self, value: str) -> Tuple[str, bool]:
        if value in self._seen:        # set membership: atomic under GIL
            return value, False
        if len(self._seen) < self.cap:
            self._seen.add(value)
            return value, False
        self.n_overflowed += 1
        return self.overflow, True

    def values(self) -> Tuple[str, ...]:
        """The tracked (non-overflow) label values, sorted — a stats
        surface, not for hot paths."""
        return tuple(sorted(self._seen))


def _escape_label(value: str) -> str:
    return value.replace("\\", "\\\\").replace('"', '\\"') \
                .replace("\n", "\\n")


def _escape_help(text: str) -> str:
    return text.replace("\\", "\\\\").replace("\n", "\\n")


def _fmt(v: float) -> str:
    """Prometheus sample value: integers without a decimal point."""
    if v != v or v in (float("inf"), float("-inf")):
        return {float("inf"): "+Inf", float("-inf"): "-Inf"}.get(v, "NaN")
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


# ---------------------------------------------------------------------------
# Children (one per label-value combination; the hot-path objects)
# ---------------------------------------------------------------------------

class _CounterChild:
    """Monotonic count. ``set_function`` turns the child into a zero-cost
    *view* over an existing monotonic value (e.g. a server's own
    ``n_shed`` int maintained under its own lock) — the hot path then
    pays nothing extra and only exposition reads the callable."""

    __slots__ = ("_lock", "_value", "_fn")

    def __init__(self):
        self._lock = _next_stripe()
        self._value = 0.0
        self._fn: Optional[Callable[[], float]] = None

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("counters only go up; use a Gauge")
        with self._lock:
            self._value += amount

    def set_function(self, fn: Callable[[], float]) -> None:
        self._fn = fn

    def reset(self) -> None:
        with self._lock:
            self._value = 0.0

    @property
    def value(self) -> float:
        if self._fn is not None:
            return float(self._fn())
        with self._lock:
            return self._value


class _GaugeChild:
    __slots__ = ("_lock", "_value", "_fn")

    def __init__(self):
        self._lock = _next_stripe()
        self._value = 0.0
        self._fn: Optional[Callable[[], float]] = None

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value -= amount

    def set_function(self, fn: Callable[[], float]) -> None:
        """Read the gauge from ``fn`` at exposition time (live views —
        queue depths, breaker states — without hot-path writes)."""
        self._fn = fn

    def reset(self) -> None:
        with self._lock:
            self._value = 0.0

    @property
    def value(self) -> float:
        if self._fn is not None:
            return float(self._fn())
        with self._lock:
            return self._value


class _HistogramChild:
    """Fixed-bucket histogram + running sum/count/last/max.

    ``observe`` is the hot path: one C-speed ``bisect`` over the edge
    tuple, then four updates under the stripe lock.

    Exemplars: when a trace id is bound, the observation's bucket
    remembers ``(trace_id, value, unix_ts)`` — last-traced-observation
    sampling, written OUTSIDE the stripe lock (one list-slot store,
    atomic under the GIL; a torn read across the tuple is impossible
    because the tuple is built first and the slot swap is one
    bytecode). A p99 bucket in the exposition then links straight to a
    captured trace (see :mod:`mmlspark_tpu_torch.core.tracing`).
    """

    __slots__ = ("_lock", "_edges", "_counts", "_sum", "_count",
                 "_last", "_max", "_clock", "_exemplars")

    def __init__(self, edges: Tuple[float, ...], clock: Clock):
        self._lock = _next_stripe()
        self._edges = edges
        self._counts = [0] * (len(edges) + 1)   # +1: the +Inf overflow
        self._sum = 0.0
        self._count = 0
        self._last = 0.0
        self._max = 0.0
        self._clock = clock
        # one optional (trace_id, value, unix_ts) per bucket, +Inf incl.
        self._exemplars: List[Optional[Tuple[str, float, float]]] = \
            [None] * (len(edges) + 1)

    def observe(self, value: float) -> None:
        i = bisect_left(self._edges, value)
        with self._lock:
            self._counts[i] += 1
            self._sum += value
            self._count += 1
            self._last = value
            if value > self._max:
                self._max = value
        # exemplar write stays OUTSIDE the lock stripe: the contextvar
        # read is the only cost untraced hot paths pay
        tid = _trace_id.get()
        if tid is not None:
            self._exemplars[i] = (tid, value, time.time())

    def exemplars(self) -> List[Optional[Tuple[str, float, float]]]:
        return list(self._exemplars)

    @contextlib.contextmanager
    def time(self, scale: float = 1000.0) -> Iterator[None]:
        """Observe the block's wall-clock on exit — in milliseconds by
        default (matching :data:`DEFAULT_LATENCY_BUCKETS_MS`)."""
        t0 = self._clock.now()
        try:
            yield
        finally:
            self.observe((self._clock.now() - t0) * scale)

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {"count": self._count, "sum": self._sum,
                    "last": self._last, "max": self._max,
                    "buckets": list(self._counts)}

    def cumulative_rows(self, edges
                        ) -> "Tuple[List[Tuple[str, int]], float, int]":
        """``([(le_label, cumulative_count), ...], sum, count)`` with
        the ``+Inf`` overflow row last — the ONE expansion of this
        child into Prometheus histogram samples, shared by the text
        exposition (:meth:`Histogram._render_child`) and the
        remote-write encoder (:func:`collect_samples`) so the scrape
        and the push can never disagree."""
        s = self.stats()
        rows: List[Tuple[str, int]] = []
        cum = 0
        for edge, n in zip(edges, s["buckets"]):
            cum += n
            rows.append((_fmt(edge), cum))
        cum += s["buckets"][-1]
        rows.append(("+Inf", cum))
        return rows, s["sum"], s["count"]

    def reset(self) -> None:
        with self._lock:
            self._counts = [0] * (len(self._edges) + 1)
            self._sum = 0.0
            self._count = 0
            self._last = 0.0
            self._max = 0.0
            self._exemplars = [None] * (len(self._edges) + 1)


# ---------------------------------------------------------------------------
# Families
# ---------------------------------------------------------------------------

class _Family:
    """A named metric + its per-label-value children.

    Label-less families proxy the child API (``inc``/``set``/``observe``
    on the family hit the single default child), so simple metrics need
    no ``labels()`` call at all.
    """

    kind = "untyped"

    def __init__(self, name: str, help: str, label_names: Tuple[str, ...]):
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        for ln in label_names:
            if not _LABEL_RE.match(ln):
                raise ValueError(f"invalid label name {ln!r}")
        self.name = name
        self.help = help
        self.label_names = tuple(label_names)
        self._children: Dict[Tuple[str, ...], Any] = {}
        self._create_lock = threading.Lock()

    def _new_child(self):
        raise NotImplementedError

    def labels(self, *values) -> Any:
        """The child for these label values (created on first use).
        Bind it once outside a hot loop — the dict lookup here is cheap
        but not free."""
        key = tuple(str(v) for v in values)
        if len(key) != len(self.label_names):
            raise ValueError(
                f"{self.name} takes labels {self.label_names}, "
                f"got {len(key)} value(s)")
        child = self._children.get(key)      # atomic under the GIL
        if child is None:
            with self._create_lock:
                child = self._children.get(key)
                if child is None:
                    child = self._new_child()
                    self._children[key] = child
        return child

    def children(self) -> List[Tuple[Tuple[str, ...], Any]]:
        with self._create_lock:
            return list(self._children.items())

    def _default(self):
        return self.labels()

    def _label_str(self, key: Tuple[str, ...],
                   extra: Tuple[Tuple[str, str], ...] = ()) -> str:
        pairs = [f'{n}="{_escape_label(v)}"'
                 for n, v in zip(self.label_names, key)]
        pairs += [f'{n}="{_escape_label(v)}"' for n, v in extra]
        return "{" + ",".join(pairs) + "}" if pairs else ""

    def render(self, exemplars: bool = False) -> List[str]:
        lines = [f"# HELP {self.name} {_escape_help(self.help)}",
                 f"# TYPE {self.name} {self.kind}"]
        for key, child in sorted(self.children()):
            lines.extend(self._render_child(key, child,
                                            exemplars=exemplars))
        return lines

    def _render_child(self, key, child, exemplars: bool = False
                      ) -> List[str]:
        return [f"{self.name}{self._label_str(key)} {_fmt(child.value)}"]


class Counter(_Family):
    kind = "counter"

    def _new_child(self):
        return _CounterChild()

    def inc(self, amount: float = 1.0) -> None:
        self._default().inc(amount)

    def set_function(self, fn: Callable[[], float]) -> None:
        self._default().set_function(fn)

    @property
    def value(self) -> float:
        return self._default().value


class Gauge(_Family):
    kind = "gauge"

    def _new_child(self):
        return _GaugeChild()

    def set(self, value: float) -> None:
        self._default().set(value)

    def inc(self, amount: float = 1.0) -> None:
        self._default().inc(amount)

    def dec(self, amount: float = 1.0) -> None:
        self._default().dec(amount)

    def set_function(self, fn: Callable[[], float]) -> None:
        self._default().set_function(fn)

    @property
    def value(self) -> float:
        return self._default().value


class Histogram(_Family):
    kind = "histogram"

    def __init__(self, name, help, label_names,
                 buckets: Tuple[float, ...], clock: Clock):
        edges = tuple(float(b) for b in buckets)
        if not edges or any(a >= b for a, b in zip(edges, edges[1:])):
            raise ValueError(
                f"{name}: buckets must be strictly increasing, "
                f"got {buckets!r}")
        self.buckets = edges
        self._clock = clock
        super().__init__(name, help, label_names)

    def _new_child(self):
        return _HistogramChild(self.buckets, self._clock)

    def observe(self, value: float) -> None:
        self._default().observe(value)

    def time(self, scale: float = 1000.0):
        return self._default().time(scale)

    def stats(self) -> Dict[str, Any]:
        return self._default().stats()

    @staticmethod
    def _exemplar_suffix(ex) -> str:
        """OpenMetrics exemplar: ``# {trace_id="..."} value ts`` after
        a bucket sample. Emitted ONLY in the OpenMetrics exposition
        (``render(exemplars=True)``): the classic 0.0.4 text-format
        grammar allows nothing after the value but a timestamp, and a
        vanilla Prometheus scraper fails the WHOLE scrape on the ``#``
        token. The in-house parser and the fleet merge take the value
        as the first post-label token and ignore the trailer either
        way."""
        if ex is None:
            return ""
        tid, value, ts = ex
        return (f' # {{trace_id="{_escape_label(tid)}"}} '
                f"{_fmt(value)} {_fmt(round(ts, 3))}")

    def _render_child(self, key, child, exemplars: bool = False
                      ) -> List[str]:
        rows, total, count = child.cumulative_rows(self.buckets)
        ex = child.exemplars() if exemplars else [None] * len(rows)
        lines = [
            f"{self.name}_bucket"
            f"{self._label_str(key, (('le', le),))} {cum}"
            f"{self._exemplar_suffix(ex[i])}"
            for i, (le, cum) in enumerate(rows)]
        lines.append(
            f"{self.name}_sum{self._label_str(key)} {_fmt(total)}")
        lines.append(
            f"{self.name}_count{self._label_str(key)} {count}")
        return lines


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

class MetricsRegistry:
    """A home for metric families; one process-wide :data:`REGISTRY`
    plus per-component instances (each :class:`ServingServer` keeps its
    own, so two workers in one test process never mix counts).

    ``counter``/``gauge``/``histogram`` are get-or-create: a second call
    with the same name returns the same family (and raises on a
    kind/label mismatch — two call sites silently sharing a name with
    different schemas is a bug worth failing loudly on).
    """

    def __init__(self, clock: Clock = SYSTEM_CLOCK):
        self.clock = clock
        self._families: Dict[str, _Family] = {}
        self._lock = threading.Lock()

    def _get_or_create(self, name: str, factory: Callable[[], _Family],
                       kind: str, label_names: Tuple[str, ...]) -> _Family:
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = factory()
                self._families[name] = fam
                return fam
        if fam.kind != kind or fam.label_names != tuple(label_names):
            raise ValueError(
                f"metric {name!r} already registered as {fam.kind} with "
                f"labels {fam.label_names}, requested {kind} with "
                f"{tuple(label_names)}")
        return fam

    def counter(self, name: str, help: str = "",
                labels: Iterable[str] = ()) -> Counter:
        labels = tuple(labels)
        return self._get_or_create(
            name, lambda: Counter(name, help, labels), "counter", labels)

    def gauge(self, name: str, help: str = "",
              labels: Iterable[str] = ()) -> Gauge:
        labels = tuple(labels)
        return self._get_or_create(
            name, lambda: Gauge(name, help, labels), "gauge", labels)

    def histogram(self, name: str, help: str = "",
                  labels: Iterable[str] = (),
                  buckets: Tuple[float, ...] = DEFAULT_LATENCY_BUCKETS_MS
                  ) -> Histogram:
        labels = tuple(labels)
        fam = self._get_or_create(
            name,
            lambda: Histogram(name, help, labels, buckets, self.clock),
            "histogram", labels)
        # schema mismatches fail loudly (see class docstring) — buckets
        # are schema too: silently inheriting another call site's ladder
        # would collapse out-of-range samples into +Inf with no error
        requested = tuple(float(b) for b in buckets)
        if fam.buckets != requested:
            raise ValueError(
                f"histogram {name!r} already registered with buckets "
                f"{fam.buckets}, requested {requested}")
        return fam

    def families(self) -> List[_Family]:
        with self._lock:
            return sorted(self._families.values(), key=lambda f: f.name)

    def render(self, exemplars: bool = False) -> str:
        """Prometheus text exposition (version 0.0.4): families sorted
        by name, children by label values — byte-stable for goldens.
        ``exemplars=True`` appends OpenMetrics exemplar trailers to
        histogram bucket lines — serve that ONLY under the OpenMetrics
        content type (:data:`OPENMETRICS_CONTENT_TYPE`): the classic
        format's grammar rejects the trailer and a strict scraper
        would fail the whole scrape."""
        lines: List[str] = []
        for fam in self.families():
            lines.extend(fam.render(exemplars=exemplars))
        return "\n".join(lines) + ("\n" if lines else "")

    def reset(self) -> None:
        """Zero every child's accumulators IN PLACE (tests; a
        production registry never resets — counters are forever).
        Families and children survive, so call sites holding cached
        family/child references (io/http, resilience, trainer, Timer)
        stay wired to the exposition — dropping families would orphan
        those caches into invisible updates."""
        for fam in self.families():
            for _, child in fam.children():
                child.reset()


#: the process-wide default registry: framework-level metrics
#: (pipeline stages, trainer, HTTP/resilience) report here; servers add
#: their own per-instance registry on top (see ``GET /metrics``).
REGISTRY = MetricsRegistry()

#: the exposition content type.
CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

#: the OpenMetrics content type — the exposition a scraper must
#: negotiate (Accept header) to receive histogram exemplars.
OPENMETRICS_CONTENT_TYPE = \
    "application/openmetrics-text; version=1.0.0; charset=utf-8"


def render_registries(*registries: MetricsRegistry,
                      exemplars: bool = False) -> str:
    """Concatenate several registries' expositions (a worker's
    ``/metrics`` = its own registry + the process-wide one)."""
    return "".join(r.render(exemplars=exemplars) for r in registries)


# ---------------------------------------------------------------------------
# Metrics snapshots (batch jobs that exit before a scrape)
# ---------------------------------------------------------------------------

def write_snapshot(directory: str, text: str, tag: Optional[str] = None,
                   prefix: str = "metrics", keep: int = 0) -> str:
    """Write already-rendered exposition ``text`` to
    ``directory/<prefix>-<tag>.prom`` (any io.fs target — a checkpoint
    dir, gs://...). ``tag`` defaults to a UTC timestamp; ``keep > 0``
    prunes the directory to the newest ``keep`` snapshots (tags sort
    lexically: both timestamps and zero-padded step tags order
    correctly). Returns the path.

    This is the shared write path under :func:`snapshot_registries`
    (which scrapes, then calls here) and the TSDB Recorder (which
    dumps the SAME scrape it ingests — one scrape per interval, not
    one per consumer)."""
    from mmlspark_tpu_torch.io import fs as _fs
    if tag is None:
        tag = time.strftime("%Y%m%dT%H%M%SZ", time.gmtime())
    _fs.makedirs(directory)
    path = _fs.join(directory, f"{prefix}-{tag}.prom")
    _fs.write_text(path, text)
    if keep > 0:
        mine = sorted(
            p for p in _fs.find_files(directory, recursive=False)
            if os.path.basename(p).startswith(prefix + "-")
            and p.endswith(".prom"))
        for old in mine[:-keep]:
            try:
                if _fs.is_remote(old):
                    fs_obj, p = _fs.get_fs(old)
                    fs_obj.rm(p)
                else:
                    os.remove(old)
            except Exception:  # noqa: BLE001 — pruning is best-effort
                pass
    return path


def snapshot_registries(directory: str, tag: Optional[str] = None,
                        registries: Iterable[MetricsRegistry] = (),
                        prefix: str = "metrics", keep: int = 0) -> str:
    """Scrape ``registries`` (default: the process-wide one) and write
    the exposition via :func:`write_snapshot`. Returns the path."""
    regs = tuple(registries) or (REGISTRY,)
    return write_snapshot(directory, render_registries(*regs), tag,
                          prefix, keep)


class MetricsSnapshot:
    """Periodic registry-scrape dumper for batch jobs.

    A Prometheus server scrapes long-lived workers, but a training or
    ETL job that exits between scrapes leaves no telemetry behind.
    ``MetricsSnapshot`` writes the exposition to a directory on an
    interval (daemon thread) and once more on :meth:`stop`, so the
    job's final counters always land on disk — the in-repo stand-in
    for a push gateway. The trainer also drops a scrape next to every
    checkpoint (``metrics-step<NNNNNNNN>.prom``), so a preempted fit's
    telemetry survives exactly as far as its checkpoints do.

    Usage::

        with MetricsSnapshot("/ckpt/telemetry", interval_s=60):
            run_job()
    """

    def __init__(self, directory: str,
                 registries: Iterable[MetricsRegistry] = (),
                 interval_s: float = 60.0, keep: int = 24,
                 prefix: str = "metrics"):
        self.directory = directory
        self.registries = tuple(registries) or (REGISTRY,)
        self.interval_s = float(interval_s)
        self.keep = int(keep)
        self.prefix = prefix
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def write_now(self, tag: Optional[str] = None) -> str:
        return snapshot_registries(self.directory, tag, self.registries,
                                   self.prefix, self.keep)

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.write_now()
            except Exception:  # noqa: BLE001 — telemetry never kills jobs
                from mmlspark_tpu_torch.core.logs import get_logger
                get_logger("telemetry").warning(
                    "metrics snapshot to %s failed", self.directory,
                    exc_info=True)

    def start(self) -> "MetricsSnapshot":
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        """Stop the writer and flush one final snapshot (the scrape a
        batch job exists to leave behind)."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        try:
            self.write_now()
        except Exception:  # noqa: BLE001
            pass

    def __enter__(self) -> "MetricsSnapshot":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


# ---------------------------------------------------------------------------
# Prometheus remote-write protobuf encoding (hand-rolled, zero deps)
# ---------------------------------------------------------------------------
#
# The native remote-write v1 wire format is a snappy-compressed
# protobuf ``prometheus.WriteRequest``:
#
#   message WriteRequest { repeated TimeSeries timeseries = 1; }
#   message TimeSeries   { repeated Label labels = 1;
#                          repeated Sample samples = 2; }
#   message Label        { string name = 1; string value = 2; }
#   message Sample       { double value = 1; int64 timestamp = 2; }
#
# Four messages, three wire types — small enough to encode by hand
# (varints + length-delimited fields + one little-endian double), so a
# real Prometheus can ingest pushes directly at /api/v1/write with no
# protobuf dependency baked into the image. ``python-snappy`` is
# optional: when absent the encoder still produces valid protobuf and
# the pusher sends it UNCOMPRESSED (spec-noncompliant but accepted by
# several shims; the text exposition stays the default path either
# way, so nothing regresses without snappy).


def _pb_varint(n: int) -> bytes:
    out = bytearray()
    n &= (1 << 64) - 1            # int64 timestamps encode two's-complement
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _pb_delim(field: int, payload: bytes) -> bytes:
    return _pb_varint((field << 3) | 2) + _pb_varint(len(payload)) + payload


def _pb_label(name: str, value: str) -> bytes:
    return (_pb_delim(1, name.encode()) + _pb_delim(2, str(value).encode()))


def _pb_sample(value: float, ts_ms: int) -> bytes:
    return (_pb_varint((1 << 3) | 1) + struct.pack("<d", float(value))
            + _pb_varint(2 << 3) + _pb_varint(int(ts_ms)))


def _pb_series(name: str, labels, value: float, ts_ms: int) -> bytes:
    # labels MUST be sorted by name with __name__ first per the spec
    pairs = sorted([("__name__", name)] + list(labels))
    body = b"".join(_pb_delim(1, _pb_label(n, v)) for n, v in pairs)
    body += _pb_delim(2, _pb_sample(value, ts_ms))
    return _pb_delim(1, body)


def collect_samples(*registries: MetricsRegistry
                    ) -> List[Tuple[str, Tuple[Tuple[str, str], ...], float]]:
    """Flatten registries into ``(metric_name, ((label, value), ...),
    sample_value)`` rows — histograms expand to the standard
    ``_bucket``/``_sum``/``_count`` series with cumulative ``le``
    counts, exactly mirroring the text exposition."""
    rows: List[Tuple[str, Tuple[Tuple[str, str], ...], float]] = []
    for reg in registries:
        for fam in reg.families():
            base = tuple(fam.label_names)
            for key, child in sorted(fam.children()):
                labels = tuple(zip(base, key))
                if fam.kind in ("counter", "gauge"):
                    rows.append((fam.name, labels, float(child.value)))
                    continue
                # one expansion shared with the text exposition
                # (cumulative_rows), so scrape and push cannot drift
                hrows, total, count = child.cumulative_rows(fam.buckets)
                rows.extend((f"{fam.name}_bucket",
                             labels + (("le", le),), float(cum))
                            for le, cum in hrows)
                rows.append((f"{fam.name}_sum", labels, float(total)))
                rows.append((f"{fam.name}_count", labels, float(count)))
    return rows


def encode_write_request(*registries: MetricsRegistry,
                         ts_ms: Optional[int] = None,
                         extra_labels: Tuple[Tuple[str, str], ...] = ()
                         ) -> bytes:
    """Serialize registries as a ``prometheus.WriteRequest`` protobuf
    (uncompressed — see :func:`compress_write_request`)."""
    if ts_ms is None:
        ts_ms = int(time.time() * 1000)
    return b"".join(
        _pb_series(name, labels + extra_labels, value, ts_ms)
        for name, labels, value in collect_samples(*registries))


def snappy_available() -> bool:
    try:
        import snappy  # noqa: F401
        return True
    except ImportError:
        return False


def compress_write_request(payload: bytes) -> Tuple[bytes, Optional[str]]:
    """Snappy-compress when the optional codec exists: returns
    ``(body, content_encoding)`` — ``(payload, None)`` in the
    snappy-less fallback, which stays valid protobuf and is accepted
    by permissive receivers."""
    if snappy_available():
        import snappy
        return snappy.compress(payload), "snappy"
    return payload, None


#: remote-write v1 request content type
REMOTE_WRITE_CONTENT_TYPE = "application/x-protobuf"


# ---------------------------------------------------------------------------
# Remote-write: push the exposition to a live gateway
# ---------------------------------------------------------------------------

class MetricsPusher:
    """Background remote-write: POST the registry exposition to a
    push-gateway URL on an interval, and once more on :meth:`stop`.

    :class:`MetricsSnapshot` leaves scrapes on *disk*;
    ``MetricsPusher`` closes the remaining gap to a LIVE Prometheus —
    point ``url`` at a Pushgateway job path
    (``http://gw:9091/metrics/job/<job>``) or any remote-write-shim
    endpoint that accepts the text exposition. Sends go through
    :mod:`mmlspark_tpu_torch.io.http`'s resilient client: a jittered/bounded
    :class:`~mmlspark_tpu_torch.core.resilience.RetryPolicy` per push and a
    circuit breaker on the gateway host, so a dead gateway costs one
    short retry schedule per interval (then an instant breaker-refused
    attempt), never a hung telemetry thread. Push failures are counted
    (``n_errors``) and logged — telemetry must never kill the job.

    Usage::

        with MetricsPusher("http://gw:9091/metrics/job/train",
                           interval_s=30):
            run_job()                  # final flush on exit
    """

    def __init__(self, url: str,
                 registries: Iterable[MetricsRegistry] = (),
                 interval_s: float = 30.0, timeout: float = 5.0,
                 policy=None, headers: Optional[Dict[str, str]] = None,
                 header_provider: Optional[
                     Callable[[], Optional[Dict[str, str]]]] = None,
                 session=None, format: str = "text"):
        self.url = url
        self.registries = tuple(registries) or (REGISTRY,)
        self.interval_s = float(interval_s)
        self.timeout = float(timeout)
        # wire format: "text" (default — Pushgateway and every text
        # shim) or "remote_write" (the NATIVE Prometheus remote-write
        # v1 protobuf, pointed straight at /api/v1/write: hand-rolled
        # WriteRequest encoding + snappy compression when the optional
        # codec exists; without snappy the same valid protobuf goes
        # uncompressed with no Content-Encoding — permissive receivers
        # accept it, strict ones 400 visibly in last_status rather
        # than silently dropping samples)
        if format not in ("text", "remote_write"):
            raise ValueError(f"unknown push format {format!r} "
                             "(expected 'text' or 'remote_write')")
        self.format = format
        self.n_uncompressed = 0   # snappy-less remote-write pushes
        # auth surface: ``headers`` are static (set once, sent on every
        # push); ``header_provider`` is re-invoked per push and its
        # result layered on top, so short-lived bearer tokens rotate
        # without restarting the pusher. Provider failures are counted
        # + logged and the push proceeds with the static set — a broken
        # token refresher degrades to 401s at the gateway (visible in
        # last_status), never a dead telemetry thread.
        self.headers = dict(headers or {})
        self.header_provider = header_provider
        self.n_pushes = 0
        self.n_errors = 0
        self.last_status: Optional[int] = None
        self._policy = policy
        self._session = session
        self._client = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _get_client(self):
        # lazy: io.http imports this module, so the cycle must resolve
        # at call time; a pusher that never pushes imports nothing
        if self._client is None:
            from mmlspark_tpu_torch.core.resilience import (
                BreakerBoard, RetryPolicy,
            )
            from mmlspark_tpu_torch.io.http import HTTPClient
            policy = self._policy or RetryPolicy(
                max_attempts=3, base=0.2, cap=2.0)
            # a PRIVATE breaker board: the push gateway's health must
            # not open the process-wide SHARED_BREAKERS entry some
            # model egress may share, and vice versa
            self._client = HTTPClient(
                timeout=self.timeout, policy=policy,
                breakers=BreakerBoard(failure_threshold=5,
                                      reset_timeout=30.0),
                session=self._session)
        return self._client

    def push_now(self) -> bool:
        """One synchronous push; True iff the gateway answered 2xx
        (after the retry schedule). Never raises."""
        from mmlspark_tpu_torch.io.http import HTTPRequestData
        if self.format == "remote_write":
            body, encoding = compress_write_request(
                encode_write_request(*self.registries))
            h = {"Content-Type": REMOTE_WRITE_CONTENT_TYPE,
                 "X-Prometheus-Remote-Write-Version": "0.1.0"}
            if encoding is not None:
                h["Content-Encoding"] = encoding
            else:
                self.n_uncompressed += 1
        else:
            body = render_registries(*self.registries).encode()
            h = {"Content-Type": CONTENT_TYPE}
        h.update(self.headers)
        if self.header_provider is not None:
            try:
                h.update(self.header_provider() or {})
            except Exception:  # noqa: BLE001 — a broken token refresher
                self.n_errors += 1     # must not kill the push cadence
                from mmlspark_tpu_torch.core.logs import get_logger
                get_logger("telemetry").warning(
                    "metrics push header_provider raised; pushing with "
                    "static headers only", exc_info=True)
        req = HTTPRequestData(url=self.url, method="POST", headers=h,
                              body=body)
        # bind a trace id with no ambient span: egress spans then mark
        # themselves mid-trace and a flaky gateway cannot churn the
        # trace store with one-span error captures every interval
        with trace_context():
            resp = self._get_client().send([req])[0]
        self.last_status = resp.status_code if resp is not None else None
        ok = resp is not None and 200 <= resp.status_code < 300
        if ok:
            self.n_pushes += 1
        else:
            self.n_errors += 1
            from mmlspark_tpu_torch.core.logs import get_logger
            get_logger("telemetry").warning(
                "metrics push to %s failed (status=%s reason=%s)",
                self.url, getattr(resp, "status_code", None),
                getattr(resp, "reason", "no response"))
        return ok

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.push_now()
            except Exception:  # noqa: BLE001 — telemetry never kills jobs
                from mmlspark_tpu_torch.core.logs import get_logger
                get_logger("telemetry").warning(
                    "metrics push to %s raised", self.url, exc_info=True)

    def start(self) -> "MetricsPusher":
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        """Stop the pusher and flush one final push — the scrape that
        carries a batch job's terminal counters to the gateway."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2 * self.timeout + 5)
            self._thread = None
        try:
            self.push_now()
        except Exception:  # noqa: BLE001
            pass

    def __enter__(self) -> "MetricsPusher":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


# ---------------------------------------------------------------------------
# Scrape parsing + fleet merge
# ---------------------------------------------------------------------------

# the label block matches QUOTED values (backslash escapes honored), so
# a value containing '}' or ',' cannot truncate the block
_SAMPLE_RE = re.compile(
    r'^([a-zA-Z_:][a-zA-Z0-9_:]*)'
    r'(\{\s*(?:[a-zA-Z_][a-zA-Z0-9_]*="(?:[^"\\]|\\.)*"\s*,?\s*)*\})?'
    r'\s+(\S+)')
_LABEL_PAIR_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')
_UNESCAPE_RE = re.compile(r'\\(.)')


def _unescape_label(value: str) -> str:
    # one pass over \X pairs: sequential str.replace would mis-handle a
    # literal backslash followed by 'n' (escaped \\ + n is NOT \n)
    return _UNESCAPE_RE.sub(
        lambda m: "\n" if m.group(1) == "n" else m.group(1), value)


def parse_prometheus(text: str
                     ) -> List[Tuple[str, Tuple[Tuple[str, str], ...], float]]:
    """Parse an exposition into ``(name, sorted label pairs, value)``
    samples. Minimal by design: enough to round-trip what
    :meth:`MetricsRegistry.render` emits (the coordinator merging its
    own workers' scrapes), not a general OpenMetrics parser."""
    out = []
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if not m:
            continue
        name, labels_raw, value_raw = m.groups()
        try:
            value = float(value_raw)
        except ValueError:
            continue
        labels = tuple(sorted(
            (k, _unescape_label(v))
            for k, v in _LABEL_PAIR_RE.findall(labels_raw or "")))
        out.append((name, labels, value))
    return out


def render_samples(samples: Dict[Tuple[str, Tuple[Tuple[str, str], ...]],
                                 float]) -> str:
    """Render ``{(name, labels): value}`` samples (e.g. a
    :func:`merge_prometheus` result) back into exposition lines, with
    the SAME escaping/formatting as :meth:`MetricsRegistry.render` —
    newline-bearing label values and infinities survive the
    round-trip. No HELP/TYPE comments (a merge has no single source
    family)."""
    lines = []
    for (name, labels), value in sorted(samples.items()):
        label_str = "{" + ",".join(
            f'{k}="{_escape_label(v)}"' for k, v in labels) + "}" \
            if labels else ""
        lines.append(f"{name}{label_str} {_fmt(value)}")
    return "\n".join(lines) + ("\n" if lines else "")


def merge_prometheus(texts: Iterable[str]
                     ) -> Dict[Tuple[str, Tuple[Tuple[str, str], ...]], float]:
    """Fold N workers' scrapes into one: sample values summed per
    ``(name, labels)``. Exact for counters and histogram
    buckets/sums/counts; per-worker gauges (queue depth, inflight)
    become fleet totals, which is the number an operator wants."""
    merged: Dict[Tuple[str, Tuple[Tuple[str, str], ...]], float] = {}
    for text in texts:
        for name, labels, value in parse_prometheus(text):
            key = (name, labels)
            merged[key] = merged.get(key, 0.0) + value
    return merged


# ---------------------------------------------------------------------------
# Trace ids
# ---------------------------------------------------------------------------

TRACE_HEADER = "X-Trace-Id"

_trace_id: "contextvars.ContextVar[Optional[str]]" = \
    contextvars.ContextVar("mmlspark_tpu_trace_id", default=None)

# same trick as the serving rids: uuid4 per request is an os.urandom
# syscall; a process-unique random prefix + a counter is unique across
# the fleet and ~free per id
_TRACE_PREFIX = uuid.uuid4().hex[:16]
_TRACE_COUNTER = itertools.count(1)


def new_trace_id() -> str:
    return f"{_TRACE_PREFIX}{next(_TRACE_COUNTER):08x}"


def current_trace_id() -> Optional[str]:
    """The trace id bound to this context, or None outside any trace."""
    return _trace_id.get()


@contextlib.contextmanager
def trace_context(trace_id: Optional[str] = None) -> Iterator[str]:
    """Bind a trace id (generated when None) to the current context;
    every log record and egress HTTP request inside the block carries
    it. Contextvars do NOT cross thread handoffs — a staged pipeline
    re-enters ``trace_context`` per stage from the id it carried on the
    work item (see ``serving/server.py``)."""
    tid = trace_id or new_trace_id()
    token = _trace_id.set(tid)
    try:
        yield tid
    finally:
        _trace_id.reset(token)


_TRACE_ID_OK_RE = re.compile(r"[A-Za-z0-9._-]{1,128}")


def sanitize_trace_id(raw) -> Optional[str]:
    """Sanitize an inbound trace id to ``[A-Za-z0-9._-]`` (<= 128
    chars), ``None`` when nothing survives. Spaces and ``=`` would let
    a client inject spoofed ``key=value`` tokens into the worker's own
    plain-format log lines — the ingress contract, shared with
    :func:`mmlspark_tpu_torch.core.tracing.extract_span_context`. A clean id
    (the overwhelmingly common case — our own ids always are) passes
    on one C-speed fullmatch; only dirty input pays the per-char
    scrub. The fast path keeps context extraction inside the
    2 us/hop ``trace_propagation_overhead_v1`` budget."""
    if not raw:
        return None
    if type(raw) is not str:
        raw = str(raw)
    if _TRACE_ID_OK_RE.fullmatch(raw):
        return raw
    raw = "".join(ch for ch in raw.strip()[:128]
                  if ch.isalnum() or ch in "._-")
    return raw or None


def trace_id_from_headers(headers) -> str:
    """Adopt the inbound ``X-Trace-Id`` (sanitized — it lands in logs
    and journal lines) or mint a fresh one."""
    raw = headers.get(TRACE_HEADER) if headers is not None else None
    return sanitize_trace_id(raw) or new_trace_id()


# ---------------------------------------------------------------------------
# Build info
# ---------------------------------------------------------------------------

_BUILD_INFO: Optional[Dict[str, str]] = None


def build_info() -> Dict[str, str]:
    """The process's build identity — framework, torch and CUDA versions
    and the card's name — computed once (the device query is not free)
    and shared by every registration. Without CUDA, ``cuda`` and
    ``device_kind`` are ``"none"``."""
    global _BUILD_INFO
    if _BUILD_INFO is None:
        import torch
        from mmlspark_tpu_torch.version import __version__
        info = {"version": __version__, "torch": torch.__version__,
                "cuda": "none", "device_kind": "none"}
        if torch.cuda.is_available():
            info["cuda"] = str(torch.version.cuda or "none")
            info["device_kind"] = torch.cuda.get_device_name(0)
        _BUILD_INFO = info
    return dict(_BUILD_INFO)


def register_build_info(registry: MetricsRegistry,
                        frontend: str = "none") -> Dict[str, str]:
    """Stamp the ``serving_build_info`` gauge (constant 1; identity in
    the labels — the Prometheus ``*_build_info`` convention) into
    ``registry`` and return the label dict for ``/stats`` echo.
    ``frontend`` distinguishes the serving edge in play (``eventloop``
    / ``threaded`` / ``coordinator``). The family is the JAX
    package's; its ``torch`` and ``cuda`` labels take the place of
    ``jax`` and ``jaxlib``."""
    info = build_info()
    info["frontend"] = str(frontend)
    g = registry.gauge(
        "serving_build_info",
        "Constant 1; build identity in the labels.",
        labels=("version", "torch", "cuda", "device_kind", "frontend"))
    g.labels(info["version"], info["torch"], info["cuda"],
             info["device_kind"], info["frontend"]).set(1.0)
    return info
