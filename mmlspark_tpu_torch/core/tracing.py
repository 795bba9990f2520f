"""Span tracing + flight recorder: per-request span trees, tail capture.

The port's copy of ``mmlspark_tpu/core/tracing.py``. Trace ids make a
request *correlatable* (one ``X-Trace-Id``
across logs, journal lines, egress headers); this module makes it
*inspectable*. The TPU-pod scaling literature (MLPerf on TPU-v3 pods,
arxiv 1909.09756; TensorFlow's timeline-driven performance work, arxiv
1605.08695) is unambiguous that step- and op-level *timelines*, not
aggregate counters, are what make straggler and pipeline-bubble
diagnosis tractable — so every layer that already carries a trace id
now also records :class:`Span` s into a per-process **flight
recorder**:

* a :class:`Span` is name + start/end (on an injectable
  :class:`~mmlspark_tpu_torch.core.resilience.Clock`) + attributes + status,
  nested parent->child; the ambient span rides a contextvar next to
  the trace-id one, and (exactly like trace ids) is handed across the
  serving stage threads on the work item, never through the contextvar;
* finished spans land in a **lock-striped ring buffer**
  (:class:`FlightRecorder`): recording is a clock read + one striped
  append (~hundreds of ns, budget-tested like the metrics hot path),
  and the stripe is chosen by trace id so one trace's spans colocate
  and gathering them scans a single stripe;
* **tail-based capture**: when a ROOT span finishes, the completed
  trace is retained in a bounded LRU store only if it was slow (root
  duration over the per-route threshold) or ended non-ok
  (error/shed/deadline/timeout) — everything else ages out of the ring
  unexamined. ``GET /trace/<id>`` serves a retained trace's span tree,
  ``GET /traces`` lists the store, and :func:`to_perfetto` renders any
  retained trace as Chrome ``trace_event`` JSON for
  ``chrome://tracing`` / Perfetto (``tools/trace_dump.py``).

Histogram exemplars close the loop from the *other* direction: every
:class:`~mmlspark_tpu_torch.core.telemetry.Histogram` bucket remembers the
last traced observation's trace id and exposes it in the Prometheus
exposition (OpenMetrics ``# {trace_id="..."}`` syntax), so a p99
outlier bucket links straight to its captured trace.

Usage::

    from mmlspark_tpu_torch.core.tracing import TRACER

    with TRACER.span("load", route="batch") as sp:
        with TRACER.span("parse", rows=1000):
            parse()

    TRACER.get_trace(sp.trace_id)       # retained iff slow or non-ok

Caveat — trace ids are the correlation key everywhere here (ring
stripe, gather, capture store), and serving adopts inbound
``X-Trace-Id`` headers verbatim (the ingress contract): a buggy client
that reuses one id across many requests will colocate all of them on
one stripe and, when any of them is captured, produce a merged tree of
every same-id span still in the ring. Ids must be unique per logical
request — that is the protocol, not something this layer can repair.
"""

from __future__ import annotations

import contextvars
import itertools
import json
import os
import re
import threading
import time
import uuid
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Tuple

from mmlspark_tpu_torch.core.resilience import Clock, SYSTEM_CLOCK
from mmlspark_tpu_torch.core.telemetry import (
    TRACE_HEADER, current_trace_id, new_trace_id, sanitize_trace_id,
)
# the clean-id regex itself (not just the sanitize wrapper): ingress
# extraction fast-paths already-clean ids with one fullmatch
from mmlspark_tpu_torch.core.telemetry import _TRACE_ID_OK_RE
# the raw trace-id contextvar (not the trace_context contextmanager):
# span scopes bind trace + span together on the hot path, and a
# generator-contextmanager pair per span would triple the span budget
from mmlspark_tpu_torch.core.telemetry import _trace_id

__all__ = [
    "Span", "FlightRecorder", "Tracer", "TRACER",
    "current_span", "current_span_name", "ambient_tracer",
    "span_tree", "to_perfetto", "dump_perfetto",
    "PARENT_SPAN_HEADER", "format_span_id", "parse_span_id",
    "inject_span_context", "extract_span_context",
    "merge_traces", "AdaptiveThreshold",
]

_SPAN_COUNTER = itertools.count(1)

# span ids must stay unambiguous when traces MERGE across processes
# (the coordinator stitches N workers' span lists into one tree, and a
# worker root's parent_id names a span in the CALLER's process): plain
# per-process counters would collide at 1, so every process draws its
# ids from a random 63-bit base + the counter — still one integer add
# per span, still monotonic within the process, collision probability
# across a fleet ~2^-39 even at a billion spans per worker
_SPAN_ID_BASE = uuid.uuid4().int & 0x7FFF_FFFF_FF00_0000

_current_span: "contextvars.ContextVar[Optional[Span]]" = \
    contextvars.ContextVar("mmlspark_tpu_span", default=None)

# the tracer that bound the ambient span: layers that record spans from
# arbitrary call sites (pipeline stages, HTTP egress, trainer) resolve
# it via ambient_tracer(), so a server wired with a PRIVATE tracer
# captures its model-internal spans too — recording those through the
# global TRACER would parent them correctly but land them in the wrong
# recorder, and the private capture would silently miss them
_current_tracer: "contextvars.ContextVar[Optional[Tracer]]" = \
    contextvars.ContextVar("mmlspark_tpu_tracer", default=None)


def current_span() -> Optional["Span"]:
    """The span bound to this context, or None outside any span."""
    return _current_span.get()


def current_span_name() -> Optional[str]:
    sp = _current_span.get()
    return sp.name if sp is not None else None


def ambient_tracer() -> "Tracer":
    """The tracer that bound the ambient span, falling back to the
    process-wide :data:`TRACER` — what framework layers record
    through."""
    return _current_tracer.get() or TRACER


class Span:
    """One timed operation in a trace.

    ``t0``/``t1`` are seconds on the owning tracer's clock (monotonic
    by default); ``thread`` is the recording thread's ident, so the
    Perfetto export lays the serving pipeline's collector/executor/
    encoder work out on separate lanes. Spans are plain mutable records
    — the tracer, not the span, owns lifecycle (:meth:`Tracer.finish`).

    Hot-path notes (the <2 us/span bench budget, ``tracing_overhead_v1``):
    span ids are plain process-unique ints (no per-span string format),
    and ``attrs`` stays ``None`` until someone actually attaches one —
    most child spans never allocate a dict.
    """

    __slots__ = ("trace_id", "span_id", "parent_id", "name",
                 "t0", "t1", "status", "attrs", "thread", "remote",
                 "force")

    def __init__(self, name: str, trace_id: str,
                 parent_id: Optional[int], t0: float,
                 attrs: Optional[Dict[str, Any]] = None):
        self.name = name
        self.trace_id = trace_id
        self.span_id = _SPAN_ID_BASE + next(_SPAN_COUNTER)
        self.parent_id = parent_id
        self.t0 = t0
        self.t1: Optional[float] = None
        self.status = "ok"
        self.attrs: Optional[Dict[str, Any]] = attrs
        self.thread = threading.get_ident()
        # True when parent_id names a span in ANOTHER process (adopted
        # from an inbound header): the span is still a capture root
        # locally — its real parent finishes elsewhere
        self.remote = False
        # force-capture (the X-Capture wire hint): a forced ROOT is
        # retained regardless of the route's slow-trace threshold, and
        # the flag inherits parent -> child so egress spans know to
        # propagate the hint on the wire
        self.force = False

    @property
    def duration_ms(self) -> float:
        return ((self.t1 or self.t0) - self.t0) * 1000.0

    def set_attr(self, key: str, value: Any) -> None:
        if self.attrs is None:
            self.attrs = {}
        self.attrs[key] = value

    def to_dict(self, origin: float = 0.0) -> Dict[str, Any]:
        """JSON-able record; times relative to ``origin`` (the trace's
        first span start) so exported trees read from 0."""
        d = {
            "name": self.name,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "start_ms": round((self.t0 - origin) * 1000.0, 3),
            "duration_ms": round(self.duration_ms, 3),
            "status": self.status,
            "attrs": self.attrs or {},
            "thread": self.thread,
        }
        if self.remote:
            d["remote"] = True
        if self.force:
            d["forced"] = True
        return d

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, trace={self.trace_id}, "
                f"id={self.span_id}, parent={self.parent_id}, "
                f"status={self.status})")


class _SpanScope:
    """``with tracer.span(...)``: binds the span + its trace id + its
    tracer on enter, finishes (status ``error`` on exception) on
    exit."""

    __slots__ = ("_tracer", "span", "_tok_span", "_tok_trace",
                 "_tok_tracer")

    def __init__(self, tracer: "Tracer", span: "Span"):
        self._tracer = tracer
        self.span = span

    def __enter__(self) -> "Span":
        self._tok_span = _current_span.set(self.span)
        self._tok_trace = _trace_id.set(self.span.trace_id)
        self._tok_tracer = _current_tracer.set(self._tracer)
        return self.span

    def __exit__(self, exc_type, exc, tb) -> bool:
        _current_tracer.reset(self._tok_tracer)
        _trace_id.reset(self._tok_trace)
        _current_span.reset(self._tok_span)
        self._tracer.finish(self.span,
                            status="error" if exc_type is not None
                            else None)
        return False


class _BindScope:
    """``with tracer.bind(span)``: ambient span + trace id + tracer
    for the block; ``None`` span binds nothing (no-op)."""

    __slots__ = ("_tracer", "span", "_tok_span", "_tok_trace",
                 "_tok_tracer")

    def __init__(self, tracer: "Tracer", span: Optional["Span"]):
        self._tracer = tracer
        self.span = span

    def __enter__(self) -> Optional["Span"]:
        if self.span is not None:
            self._tok_span = _current_span.set(self.span)
            self._tok_trace = _trace_id.set(self.span.trace_id)
            self._tok_tracer = _current_tracer.set(self._tracer)
        return self.span

    def __exit__(self, exc_type, exc, tb) -> bool:
        if self.span is not None:
            _current_tracer.reset(self._tok_tracer)
            _trace_id.reset(self._tok_trace)
            _current_span.reset(self._tok_span)
        return False


class FlightRecorder:
    """Per-process lock-striped ring buffer of finished spans.

    Stripes are keyed by trace id, so (a) two busy traces almost never
    contend on a lock and (b) gathering one trace's spans scans exactly
    one stripe's ring, not the whole recorder. Each stripe is a
    fixed-size list used circularly — recording is one store + one
    index bump under the stripe lock, and old spans are overwritten in
    place (a flight recorder, not a log: history exists to be *seized*
    at capture time, not kept)."""

    def __init__(self, capacity: int = 8192, stripes: int = 16):
        self.stripes = max(int(stripes), 1)
        per = max(int(capacity) // self.stripes, 16)
        self.capacity = per * self.stripes
        self._rings: List[List[Optional[Span]]] = [
            [None] * per for _ in range(self.stripes)]
        self._idx = [0] * self.stripes
        self._locks = [threading.Lock() for _ in range(self.stripes)]
        self._per = per

    def _stripe(self, trace_id: str) -> int:
        return hash(trace_id) % self.stripes

    def record(self, span: Span) -> None:
        s = hash(span.trace_id) % self.stripes
        with self._locks[s]:
            self._rings[s][self._idx[s] % self._per] = span
            self._idx[s] += 1

    def gather(self, trace_id: str) -> List[Span]:
        """Every recorded span of ``trace_id`` still in its ring,
        sorted by start time. Best-effort by design: spans evicted by
        ring wraparound are simply absent from the capture."""
        s = self._stripe(trace_id)
        with self._locks[s]:
            found = [sp for sp in self._rings[s]
                     if sp is not None and sp.trace_id == trace_id]
        found.sort(key=lambda sp: sp.t0)
        return found


class Tracer:
    """Span factory + flight recorder + tail-sampled slow-trace store.

    One process-wide :data:`TRACER` serves every layer (the per-route
    thresholds keep serving/trainer/pipeline captures independently
    tuned); tests build private tracers with a
    :class:`~mmlspark_tpu_torch.core.resilience.ManualClock` to drive span
    durations deterministically.
    """

    def __init__(self, clock: Clock = SYSTEM_CLOCK,
                 capacity: int = 8192, store_capacity: int = 128,
                 default_slow_ms: Optional[float] = 250.0):
        self.clock = clock
        self.recorder = FlightRecorder(capacity)
        self.store_capacity = int(store_capacity)
        self.default_slow_ms = default_slow_ms
        self._thresholds: Dict[str, float] = {}
        self._store: "OrderedDict[str, Dict[str, Any]]" = OrderedDict()
        self._store_lock = threading.Lock()
        # hot-path bindings (one attribute + descriptor resolve saved
        # per call — real money at <2 us/span)
        self._now = clock.now
        self._record = self.recorder.record

    # -- thresholds ---------------------------------------------------------

    def set_threshold(self, route: str, slow_ms: Optional[float]) -> None:
        """Per-route tail-capture threshold (ms). ``<= 0`` retains every
        completed trace on that route (trace-everything mode for
        harnesses); ``None`` retains only non-ok traces."""
        self._thresholds[route] = slow_ms

    def threshold(self, route: str) -> Optional[float]:
        return self._thresholds.get(route, self.default_slow_ms)

    # -- span lifecycle -----------------------------------------------------

    def start(self, name: str, trace_id: Optional[str] = None,
              parent: Optional[Span] = None,
              remote_parent: Optional[int] = None, **attrs) -> Span:
        """Begin a span. Parent defaults to the ambient span; the trace
        id resolves explicit > parent's > ambient trace id > fresh.
        ``remote_parent`` is a span id adopted from an inbound header
        (:func:`extract_span_context`): the new span records that
        cross-process parent link but is still a LOCAL capture root —
        its real parent finishes in the caller's process."""
        if parent is None:
            parent = _current_span.get()
        if parent is not None:
            tid = trace_id or parent.trace_id
            pid = parent.span_id
        else:
            tid = trace_id or current_trace_id() or new_trace_id()
            pid = remote_parent
        sp = Span(name, tid, pid, self._now(), attrs or None)
        if parent is None and remote_parent is not None:
            sp.remote = True
        if parent is not None and parent.force:
            sp.force = True
        return sp

    def finish(self, span: Span, status: Optional[str] = None,
               capture: bool = True, **attrs) -> None:
        """End + record a span; a finishing ROOT span (no parent) runs
        the tail-capture decision for its whole trace. ``capture=False``
        suppresses that for spans that are parentless only because the
        ambient span did not cross a boundary (e.g. an HTTP egress
        attempt inside a client's ``trace_context``): they belong to a
        larger trace whose real root will run the decision."""
        if span.t1 is not None:
            return                       # double-finish: first one wins
        if attrs:
            if span.attrs is None:
                span.attrs = attrs
            else:
                span.attrs.update(attrs)
        if status is not None:
            span.status = status
        span.t1 = self._now()
        self._record(span)
        if capture and (span.parent_id is None or span.remote):
            self._maybe_capture(span)

    def add(self, name: str, t0: float, t1: float, parent: Span,
            status: str = "ok", **attrs) -> Span:
        """Record an already-completed child span with explicit
        timestamps — the shape the serving pipeline needs, where one
        batch-level measurement (assemble, dispatch, encode) becomes a
        child of every live request's root without re-running clocks
        per request."""
        sp = Span(name, parent.trace_id, parent.span_id, t0, attrs or None)
        sp.t1 = t1
        sp.status = status
        self._record(sp)
        return sp

    def event(self, name: str, t: float, parent: Span,
              **attrs) -> Span:
        """Record an instant (zero-duration) event under ``parent`` —
        a point on the timeline rather than an interval: a decode
        request's first emitted token, an alert transition. Renders as
        an ordinary span with ``t0 == t1``."""
        return self.add(name, t, t, parent, **attrs)

    def span(self, name: str, **attrs) -> "_SpanScope":
        """Scoped span: nests under the ambient span, binds itself (and
        its trace id) for the block, finishes on exit — with status
        ``error`` when the block raises. A class-based context manager,
        not a generator one: two generator frames per span would eat
        most of the <2 us budget by themselves."""
        return _SpanScope(self, self.start(name, **attrs))

    def bind(self, span: Optional[Span]) -> "_BindScope":
        """Re-bind an existing span (and its trace id, and this tracer)
        as the ambient parent — the cross-thread handoff: contextvars
        do not follow the serving pipeline's stage threads, so each
        stage re-binds from the span carried on the work item. ``None``
        is a no-op (synthetic warmup work records nothing)."""
        return _BindScope(self, span)

    # -- tail-based capture -------------------------------------------------

    def _maybe_capture(self, root: Span) -> None:
        route = str((root.attrs or {}).get("route") or root.name)
        dur = root.duration_ms
        if root.status != "ok":
            reason = root.status
        elif root.force:
            # the X-Capture wire hint: this request asked to be kept,
            # threshold or not (one-request debugging in production)
            reason = "forced"
        else:
            thr = self.threshold(route)
            if thr is None or dur < thr:
                return                   # the tail-sampling drop path
            reason = "slow"
        spans = self.recorder.gather(root.trace_id)
        if not spans:
            spans = [root]
        origin = spans[0].t0
        wall = time.time()
        trace = {
            "trace_id": root.trace_id,
            "root": root.name,
            "route": route,
            "duration_ms": round(dur, 3),
            "status": root.status,
            "reason": reason,
            "captured_at": round(wall, 3),
            # wall-clock anchor of the trace's first local span: span
            # t0/t1 are per-process monotonic and NOT comparable across
            # workers, so a distributed merge aligns each part by this
            # anchor instead (best-effort — as good as the hosts' NTP)
            "origin_unix": round(wall - max(self._now() - origin, 0.0), 6),
            "n_spans": len(spans),
            "spans": [sp.to_dict(origin) for sp in spans],
        }
        with self._store_lock:
            self._store.pop(root.trace_id, None)
            self._store[root.trace_id] = trace
            # per-reason quota: an overload storm produces THOUSANDS of
            # identical shed/error captures per second, and pure global
            # LRU would churn out the genuinely interesting slow traces
            # within seconds of an incident starting — exactly when the
            # operator needs them. Each reason evicts its own oldest
            # first; the global cap still bounds the store.
            quota = max(self.store_capacity // 4, 8)
            same = [t["trace_id"] for t in self._store.values()
                    if t["reason"] == trace["reason"]]
            if len(same) > quota:
                self._store.pop(same[0], None)
            while len(self._store) > self.store_capacity:
                self._store.popitem(last=False)

    # -- read side ----------------------------------------------------------

    def get_trace(self, trace_id: str) -> Optional[Dict[str, Any]]:
        """A retained trace (summary + flat span list), or None if it
        was never captured / already evicted."""
        with self._store_lock:
            return self._store.get(trace_id)

    def traces(self, slow_only: bool = False) -> List[Dict[str, Any]]:
        """Summaries of every retained trace, most recent first.
        ``slow_only`` filters to threshold-retained captures (drops the
        error/shed/deadline ones)."""
        with self._store_lock:
            items = list(self._store.values())
        items.reverse()
        return [{k: t[k] for k in ("trace_id", "root", "route",
                                   "duration_ms", "status", "reason",
                                   "captured_at", "n_spans")}
                for t in items
                if not slow_only or t["reason"] == "slow"]

    def clear(self) -> None:
        """Drop every retained trace (tests; the ring is left alone —
        it self-overwrites)."""
        with self._store_lock:
            self._store.clear()


# ---------------------------------------------------------------------------
# Cross-process span context (the distributed-tracing wire contract)
# ---------------------------------------------------------------------------

#: W3C traceparent-style parent link, split across two headers so the
#: existing ``X-Trace-Id`` contract is untouched: the trace id rides
#: ``X-Trace-Id`` (sanitized, as at ingress) and the CALLER's span id
#: rides ``X-Parent-Span-Id`` as lowercase hex. A worker that adopts
#: the pair parents its root "request" span under the caller's egress
#: span, so a client's whole failover schedule and every worker-side
#: tree stitch into one distributed trace.
PARENT_SPAN_HEADER = "X-Parent-Span-Id"

#: force-capture wire hint: a request carrying ``X-Capture: 1`` is
#: retained end to end regardless of slow-trace thresholds — honored at
#: every ingress (the root span is flagged ``force``) and re-emitted on
#: every egress whose span inherited the flag, so one marked request
#: leaves a capture on every worker it touched.
CAPTURE_HEADER = "X-Capture"

_SPAN_ID_RE = re.compile(r"^[0-9a-fA-F]{1,16}$")


def format_span_id(span_id: int) -> str:
    """A span id as it travels on the wire (lowercase hex, <= 16
    chars)."""
    return format(span_id, "x")


def parse_span_id(raw: Optional[str]) -> Optional[int]:
    """Parse an inbound ``X-Parent-Span-Id``. Strict by design — the
    value becomes a parent link in retained trees and a key in merged
    exports, so anything malformed (non-hex, overlong, zero, empty) is
    REJECTED to ``None`` rather than sanitized into a wrong link.
    (The int() fallback path never runs: the regex admits only plain
    hex, rejecting the whitespace/sign/underscore forms int() itself
    would accept.)"""
    if not raw:
        return None
    if type(raw) is not str:
        raw = str(raw)
    if not _SPAN_ID_RE.match(raw):          # clean wire value: one
        raw = raw.strip()                   # C-speed match, no strip
        if not _SPAN_ID_RE.match(raw):
            return None
    return int(raw, 16) or None


def inject_span_context(headers: Dict[str, str], span: Span,
                        _trace: str = TRACE_HEADER,
                        _parent: str = PARENT_SPAN_HEADER
                        ) -> Dict[str, str]:
    """Headers + the span's trace context (``X-Trace-Id`` +
    ``X-Parent-Span-Id``). Caller-supplied headers win (names compared
    case-insensitively — two conflicting trace headers would fork
    downstream correlation); the input dict is never mutated."""
    # the scan runs on every egress attempt: a length prefilter skips
    # unrelated keys on one int compare, and only length-10/-16 keys
    # (candidate context headers) pay an equality or lower() check
    trace_val = None
    has_trace = has_parent = False
    for k in headers:
        lk = len(k)
        if lk == 10:
            if k == _trace or k.lower() == "x-trace-id":
                has_trace = True
                trace_val = headers[k]
        elif lk == 16:
            if k == _parent or k.lower() == "x-parent-span-id":
                has_parent = True
    if has_trace and has_parent:
        return (_with_capture_hint(headers, span) if span.force
                else headers)
    if has_trace and trace_val != span.trace_id:
        # the caller aimed this request at a DIFFERENT trace: our span
        # id would be a cross-trace parent link — worse than no link
        # (the receiver would forever hold a dangling parent). Leave
        # the caller's context alone.
        return headers
    out = dict(headers)
    if not has_trace:
        out[_trace] = span.trace_id
    if not has_parent:
        out[_parent] = format(span.span_id, "x")
    if span.force:
        return _with_capture_hint(out, span, copied=out is not headers)
    return out


def _with_capture_hint(headers: Dict[str, str], span: Span,
                       copied: bool = False) -> Dict[str, str]:
    """Add ``X-Capture: 1`` to a forced span's egress headers. Callers
    gate on ``span.force`` BEFORE calling (the check is inlined at the
    call sites: a function call per hop is real money against the 2 us
    propagation budget)."""
    for k in headers:
        if len(k) == 9 and (k == CAPTURE_HEADER
                            or k.lower() == "x-capture"):
            return headers               # caller's hint wins
    out = headers if copied else dict(headers)
    out[CAPTURE_HEADER] = "1"
    return out


def capture_hint(headers) -> bool:
    """True iff the inbound request carries the force-capture hint
    (``X-Capture: 1``; any other value is ignored — the hint is a
    boolean, not a knob)."""
    if headers is None:
        return False
    return headers.get(CAPTURE_HEADER) == "1"


def extract_span_context(headers,
                         _tid_ok=_TRACE_ID_OK_RE.fullmatch,
                         _sid_ok=_SPAN_ID_RE.match,
                         _th: str = TRACE_HEADER,
                         _ph: str = PARENT_SPAN_HEADER
                         ) -> Tuple[str, Optional[int]]:
    """Adopt inbound trace context: ``(trace_id, parent_span_id)``.

    The trace id is sanitized exactly like
    :func:`~mmlspark_tpu_torch.core.telemetry.trace_id_from_headers` (or
    minted fresh when absent/empty); the parent span id is parsed
    strictly (:func:`parse_span_id`) and is honored ONLY when the trace
    id itself was adopted — a parent link without the trace it belongs
    to is meaningless and is dropped. Runs at every ingress: a clean
    inbound pair costs two C-speed regex checks (the 2 us/hop
    ``trace_propagation_overhead_v1`` budget)."""
    # bound-method/constant defaults: the fast paths resolve with zero
    # per-call global or attribute lookups — this runs at every ingress
    raw = headers.get(_th) if headers is not None else None
    if not raw:
        return new_trace_id(), None
    if type(raw) is str and _tid_ok(raw):
        tid = raw                            # clean id: no scrub pass
    else:
        tid = sanitize_trace_id(raw)
        if tid is None:
            return new_trace_id(), None
    sid = headers.get(_ph)
    if not sid:
        return tid, None
    if type(sid) is str and _sid_ok(sid):    # clean wire value:
        return tid, int(sid, 16) or None     # parse_span_id inlined
    return tid, parse_span_id(sid)


def merge_traces(parts: List[Tuple[str, Dict[str, Any]]]
                 ) -> Optional[Dict[str, Any]]:
    """Stitch one logical trace's per-process captures into a single
    span list: ``parts`` is ``[(worker_label, captured_trace), ...]``
    for ONE trace id (e.g. the client's capture plus every worker's,
    fetched via ``GET /trace/<id>?format=raw``).

    Each part's spans carry per-process monotonic-relative times, so
    parts are aligned by their ``origin_unix`` wall-clock anchors
    (best-effort: as accurate as the hosts' clock sync) and re-zeroed
    to the earliest span. Every merged span gains a ``worker`` label
    (its originating part) for per-worker attribution and Perfetto
    lanes; span ids are globally unique, so cross-process
    ``parent_id`` links resolve and :func:`span_tree` nests worker
    roots under the caller's egress spans."""
    parts = [(lbl, t) for lbl, t in parts if t]
    if not parts:
        return None
    origins = [t.get("origin_unix") for _, t in parts
               if t.get("origin_unix") is not None]
    zero = min(origins) if origins else 0.0
    spans: List[Dict[str, Any]] = []
    seen: set = set()
    workers: List[str] = []
    owner_of: Dict[int, int] = {}        # span_id -> part index
    for pi, (lbl, t) in enumerate(parts):
        off_ms = ((t.get("origin_unix") or zero) - zero) * 1000.0
        if lbl not in workers:
            workers.append(lbl)
        for sp in t.get("spans", ()):
            if sp["span_id"] in seen:
                continue                 # a part polled twice
            seen.add(sp["span_id"])
            owner_of[sp["span_id"]] = pi
            s = dict(sp)
            s["start_ms"] = round(s["start_ms"] + off_ms, 3)
            s["worker"] = lbl
            spans.append(s)
    if not spans:
        return None
    # -- cross-host clock-skew estimation: origin_unix alignment is
    # only as good as the hosts' wall clocks. Every cross-process
    # parent link gives a physical constraint — the callee's remote
    # root must nest inside the caller's egress span (the request was
    # on the wire outside that window). A subtree that nests is left
    # untouched (zero estimated skew: asymmetric network latency must
    # not be "corrected" away); one that escapes its egress window is
    # shifted by the NTP-style midpoint offset
    # ((e0 - s0) + (e1 - s1)) / 2, which splits the RTT evenly.
    # Corrections propagate caller-first (a worker two hops out is
    # corrected against its already-corrected parent), and the
    # per-worker estimate is reported so merged fleet traces stay
    # honest — and say so — on badly-synced hosts.
    skew_ms = _estimate_clock_skew(spans, owner_of)
    if skew_ms:
        for s in spans:
            shift = skew_ms.get(owner_of[s["span_id"]])
            if shift:
                s["start_ms"] = round(s["start_ms"] + shift, 3)
    spans.sort(key=lambda s: s["start_ms"])
    base = spans[0]["start_ms"]
    if base:
        for s in spans:
            s["start_ms"] = round(s["start_ms"] - base, 3)
    # the distributed root: parentless AND not remote-parented (a
    # worker root's parent finished in another process — it is a root
    # only of its local part); fall back to the earliest span when the
    # caller's part was never captured
    roots = [s for s in spans
             if s["parent_id"] is None and not s.get("remote")]
    root = roots[0] if roots else spans[0]
    owner = parts[owner_of[root["span_id"]]][1]
    end = max(s["start_ms"] + s["duration_ms"] for s in spans)
    return {
        "trace_id": owner["trace_id"],
        "root": root["name"],
        "route": owner.get("route", root["name"]),
        "duration_ms": round(end, 3),
        "status": root["status"],
        "reason": owner.get("reason", root["status"]),
        "captured_at": max(t.get("captured_at", 0.0) for _, t in parts),
        "n_spans": len(spans),
        "workers": workers,
        # estimated wall-clock skew per worker part (ms, the shift
        # applied to that part's spans): 0.0 = link-consistent clocks,
        # absent = no cross-process link to estimate from
        "clock_skew_ms": {parts[pi][0]: round(off, 3)
                          for pi, off in skew_ms.items()},
        "spans": spans,
    }


def _estimate_clock_skew(spans: List[Dict[str, Any]],
                         owner_of: Dict[int, int]) -> Dict[int, float]:
    """Per-part clock corrections from egress/ingress span overlap.

    For every remote-parented span (a worker subtree root) whose
    parent egress span lives in another part: if the subtree escapes
    the egress window, its part is skewed by the midpoint offset;
    inside the window the estimate is 0. Estimates average over a
    part's links and accumulate along the caller chain (BFS from
    parts that are nobody's callee)."""
    by_id = {s["span_id"]: s for s in spans}
    links: Dict[int, list] = {}          # child part -> [(parent, off)]
    for s in spans:
        if not s.get("remote"):
            continue
        e = by_id.get(s["parent_id"])
        if e is None:
            continue
        ci, pi = owner_of[s["span_id"]], owner_of[e["span_id"]]
        if ci == pi:
            continue
        e0, e1 = e["start_ms"], e["start_ms"] + e["duration_ms"]
        s0, s1 = s["start_ms"], s["start_ms"] + s["duration_ms"]
        off = 0.0 if (s0 >= e0 and s1 <= e1) \
            else ((e0 - s0) + (e1 - s1)) / 2.0
        links.setdefault(ci, []).append((pi, off))
    if not links:
        return {}
    resolved: Dict[int, float] = {}
    # caller-first: resolve parts whose parents are all resolved (or
    # are not callees themselves); bounded passes guard cycles
    for _ in range(len(links) + 1):
        progressed = False
        for ci, ls in links.items():
            if ci in resolved:
                continue
            if any(pi in links and pi not in resolved for pi, _ in ls):
                continue
            resolved[ci] = sum(resolved.get(pi, 0.0) + off
                               for pi, off in ls) / len(ls)
            progressed = True
        if not progressed:
            break
    # cycle leftovers: estimate against raw offsets (no propagation)
    for ci, ls in links.items():
        if ci not in resolved:
            resolved[ci] = sum(off for _, off in ls) / len(ls)
    return resolved


# ---------------------------------------------------------------------------
# Adaptive slow-trace thresholds
# ---------------------------------------------------------------------------

class AdaptiveThreshold:
    """Derive a route's ``slow_trace_ms`` from its own latency
    histogram instead of a fixed number.

    A fixed 250 ms threshold captures *everything* on a route whose
    p50 is 300 ms and *nothing* on one whose p99 is 40 ms. This tracks
    the route's observed ``quantile`` (default p95, read from the
    histogram's bucket counts with in-bucket linear interpolation),
    pads it by ``margin``, clamps to ``[floor_ms, ceiling_ms]``, and
    installs the result via :meth:`Tracer.set_threshold` — so tail
    capture always means "slower than this route usually is".

    Off the hot path by construction: :meth:`tick` is one integer
    bump per batch; only every ``refresh_every``-th tick walks the
    histogram's (bounded) bucket counts. Below ``min_count`` total
    observations nothing changes — the configured fixed threshold
    keeps ruling until the route has a believable distribution
    (the warm-up contract).

    ``stats_fn`` returns ``[(edges, counts), ...]`` pairs — one per
    histogram child when the family is labeled (e.g. the serving
    dispatch histogram's per-bucket children merge into one route
    distribution).
    """

    def __init__(self, tracer: "Tracer", route: str, stats_fn,
                 quantile: float = 0.95, margin: float = 1.25,
                 floor_ms: float = 25.0, ceiling_ms: float = 5000.0,
                 min_count: int = 50, refresh_every: int = 32):
        self.tracer = tracer
        self.route = route
        self.stats_fn = stats_fn
        self.quantile = float(quantile)
        self.margin = float(margin)
        self.floor_ms = float(floor_ms)
        self.ceiling_ms = float(ceiling_ms)
        self.min_count = int(min_count)
        self.refresh_every = max(int(refresh_every), 1)
        self.value: Optional[float] = None       # last installed, ms
        self.n_refreshes = 0
        self._since = 0

    def tick(self, n: int = 1) -> Optional[float]:
        """Count ``n`` units of work; refresh when ``refresh_every``
        accumulate. Racy by design (plain int, no lock): a lost tick
        delays a refresh by one batch, which is free compared to a
        lock on the commit path."""
        self._since += n
        if self._since < self.refresh_every:
            return None
        self._since = 0
        return self.refresh()

    def refresh(self) -> Optional[float]:
        """Recompute and install the threshold now; ``None`` when the
        route is still warming up (below ``min_count`` samples)."""
        from mmlspark_tpu_torch.core.telemetry import quantile_from_buckets
        edges = None
        merged: Optional[List[int]] = None
        for e, counts in self.stats_fn():
            if merged is None:
                edges, merged = e, list(counts)
            else:
                merged = [a + b for a, b in zip(merged, counts)]
        if not merged or sum(merged) < self.min_count:
            return None
        q = quantile_from_buckets(edges, merged, self.quantile)
        if q is None:
            return None
        thr = min(max(q * self.margin, self.floor_ms), self.ceiling_ms)
        self.tracer.set_threshold(self.route, thr)
        self.value = thr
        self.n_refreshes += 1
        return thr


# ---------------------------------------------------------------------------
# Exporters
# ---------------------------------------------------------------------------

def span_tree(trace: Dict[str, Any]) -> Dict[str, Any]:
    """Nest a captured trace's flat span list into its parent->child
    tree. Spans whose parent fell out of the ring before capture attach
    under the root (best-effort flight-recorder semantics, never an
    error); the root is the parentless span, or the earliest span when
    even the root was evicted."""
    spans = [dict(sp) for sp in trace["spans"]]
    for sp in spans:
        sp["children"] = []
    by_id = {sp["span_id"]: sp for sp in spans}
    roots = [sp for sp in spans if sp["parent_id"] is None]
    root = roots[0] if roots else spans[0]
    for sp in spans:
        if sp is root:
            continue
        parent = by_id.get(sp["parent_id"])
        if parent is None or parent is sp:
            parent = root                # orphan: parent left the ring
        parent["children"].append(sp)
    return root


def to_perfetto(trace: Dict[str, Any]) -> Dict[str, Any]:
    """A captured trace as Chrome ``trace_event`` JSON — load the file
    in ``chrome://tracing`` or https://ui.perfetto.dev. Complete
    (``ph: "X"``) events, microsecond timestamps relative to the
    trace's first span, one lane per recording thread (the serving
    pipeline's collector/executor/encoder stages separate visually).

    A MERGED distributed trace (:func:`merge_traces` — its spans carry
    ``worker`` labels) renders each worker as its own *process* lane
    (``pid`` per worker, named via ``process_name`` metadata) with its
    threads nested inside, so the client's failover schedule and every
    worker's stage work read side by side on one timebase."""
    spans = trace["spans"]
    distributed = any("worker" in sp for sp in spans)
    events: List[Dict[str, Any]] = []
    if distributed:
        workers: List[str] = []
        for sp in spans:
            w = sp.get("worker", "")
            if w not in workers:
                workers.append(w)
        wlane = {w: i for i, w in enumerate(workers)}
        lane: Dict[Any, Tuple[int, int]] = {}
        for w in workers:
            pid = wlane[w]
            events.append({"ph": "M", "pid": pid, "tid": 0,
                           "name": "process_name",
                           "args": {"name": w or "local"}})
            threads = sorted({sp["thread"] for sp in spans
                              if sp.get("worker", "") == w})
            for ti, t in enumerate(threads):
                lane[(w, t)] = (pid, ti)
                events.append({"ph": "M", "pid": pid, "tid": ti,
                               "name": "thread_name",
                               "args": {"name": f"thread-{t}"}})
    else:
        pid = os.getpid()
        threads = sorted({sp["thread"] for sp in spans})
        lane = {("", t): (pid, i) for i, t in enumerate(threads)}
        for i, t in enumerate(threads):
            events.append({"ph": "M", "pid": pid, "tid": i,
                           "name": "thread_name",
                           "args": {"name": f"thread-{t}"}})
    for sp in spans:
        args = dict(sp["attrs"])
        args["trace_id"] = trace["trace_id"]
        args["status"] = sp["status"]
        args["span_id"] = sp["span_id"]
        if distributed:
            args["worker"] = sp.get("worker", "")
        epid, etid = lane[(sp.get("worker", "") if distributed else "",
                           sp["thread"])]
        events.append({
            "ph": "X",
            "name": sp["name"],
            "cat": trace["route"],
            "pid": epid,
            "tid": etid,
            "ts": int(round(sp["start_ms"] * 1000.0)),
            "dur": max(int(round(sp["duration_ms"] * 1000.0)), 1),
            "args": args,
        })
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": {"trace_id": trace["trace_id"],
                          "root": trace["root"],
                          "reason": trace["reason"]}}


def dump_perfetto(trace: Dict[str, Any], path: str) -> str:
    """Write :func:`to_perfetto` JSON to ``path`` (any io.fs target)."""
    from mmlspark_tpu_torch.io import fs as _fs
    parent = os.path.dirname(path)
    if parent:
        _fs.makedirs(parent)
    _fs.write_text(path, json.dumps(to_perfetto(trace)))
    return path


#: the process-wide tracer every layer records through. Per-component
#: isolation comes from routes (thresholds) and trace ids, not from
#: separate recorders — one flight recorder per process is the point.
TRACER = Tracer()
