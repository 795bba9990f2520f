"""Serving: HTTP frontend -> pipelined data plane -> inference -> replies
(the port's copy of ``mmlspark_tpu/serving/server.py``).

Capability parity with Spark Serving (`HTTPSourceV2.scala:50,178,272`,
`HTTPSinkV2.scala:20-106`, `DistributedHTTPSource.scala:89,244`,
`ServingUDFs.scala:15`): instead of streaming rows through a query plan,
each host runs an HTTP server whose requests are micro-batched into a
columnar frame, pushed through any fitted Transformer, and answered from
the output columns; ``POST /generate`` is served by a bound
:class:`~mmlspark_tpu_torch.serving.decode.DecodeScheduler`, whose own
thread is the only one that launches kernels on the card (the HTTP
threads handle host JSON only). Request identity -> reply routing is
the in-process equivalent of the reference's exchange-id state holder.

The data plane is a staged pipeline (micro-batch assembly overlapping
model execution):

1. **collect + assemble** — drain the request queue into a micro-batch,
   run deadline check #1, build the columnar frame directly from the
   payloads (no per-row dict round-trip for homogeneous JSON objects),
   and pad it up to a power-of-two **shape bucket**
   (:func:`mmlspark_tpu_torch.parallel.sharding.pad_to_bucket`), so
   steady-state traffic dispatches a fixed set of shapes;
2. **dispatch** — push the bucketed frame through the model and hand the
   output straight to the encoders, so host work for batch N+1 overlaps
   model execution for batch N;
3. **encode + commit** — unpad, select ``reply_cols``, JSON-encode
   (columnar fast path for scalar reply columns), run deadline check #2,
   and commit replies/journal exactly as the serial plane did.

``pipeline=False`` runs the same three stages inline on one thread (the
pre-pipeline behavior; also the A/B baseline for
``tools/bench_serving_pipeline.py``). Per-stage wall-clock timings and a
recompile counter (new dispatch shapes seen) are exported via
``GET /stats``.

Telemetry (see ``docs/observability.md``): every worker serves a
Prometheus text exposition at ``GET /metrics`` (per-stage span
histograms, per-bucket dispatch latency, backlog/inflight gauges,
shed/deadline/recompile counters, process vitals) from a per-server
:class:`~mmlspark_tpu_torch.core.telemetry.MetricsRegistry` plus the
process-wide one; every request carries an ``X-Trace-Id`` (inbound or
minted at ingress) through the staged pipeline, journal lines, log
records, and any model-internal HTTP egress; and the coordinator's
``GET /fleet`` / ``GET /fleet/metrics`` merge N workers into one view
that names the fleet's slowest stage.

Multi-host: workers register with a :class:`ServingCoordinator` (parity:
DriverServiceUtils' coordination server, `HTTPSourceV2.scala:111-167`).
"""

from __future__ import annotations

import json
import os
import threading
import time
import urllib.parse as _urlparse
import uuid
from collections import OrderedDict
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from queue import Empty, Full, Queue, SimpleQueue
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from collections import deque

from mmlspark_tpu_torch.core.dataframe import DataFrame
from mmlspark_tpu_torch.core.logs import get_logger, install_log_ring
from mmlspark_tpu_torch.core.profiler import SamplingProfiler
from mmlspark_tpu_torch.core.profiling import (
    CompileLedger, DeviceProfiler, MfuMeter, ProfilerBusy,
    StageTimings, device_memory_stats, process_rss_bytes,
    process_uptime_s,
)
from mmlspark_tpu_torch.parallel.sharding import (
    bucket_ladder, bucket_target, padded_device_batch,
)
from mmlspark_tpu_torch.core.resilience import (
    SYSTEM_CLOCK, BreakerBoard, Clock, Deadline, DeadlineExceeded,
    RetryPolicy,
)
from mmlspark_tpu_torch.core.serialize import _jsonify
from mmlspark_tpu_torch.core.stage import Transformer
from mmlspark_tpu_torch.core.telemetry import (
    CONTENT_TYPE as _METRICS_CONTENT_TYPE,
    OPENMETRICS_CONTENT_TYPE as _OPENMETRICS_CONTENT_TYPE,
    MetricsRegistry, REGISTRY,
    TRACE_HEADER, current_trace_id, merge_prometheus, new_trace_id,
    register_build_info, render_registries, render_samples,
    trace_context,
)
from mmlspark_tpu_torch.core.tsdb import (
    AnomalyDetector, AnomalyWatch, DEFAULT_TIERS, QueryError, Recorder,
    RecordingRule, TimeSeriesStore, default_serving_rules,
    default_serving_watches,
)
from mmlspark_tpu_torch.core.tracing import (
    CAPTURE_HEADER, PARENT_SPAN_HEADER, TRACER, AdaptiveThreshold,
    ambient_tracer, capture_hint, extract_span_context, format_span_id,
    merge_traces, span_tree, to_perfetto,
)
from mmlspark_tpu_torch.serving.decode import DecodeOverloaded, DecodeScheduler
from mmlspark_tpu_torch.serving.frontend import EventLoopFrontend, batched_replies
from mmlspark_tpu_torch.serving.incident import FanoutNotifier, IncidentManager
from mmlspark_tpu_torch.serving.policy import AdaptiveBatchPolicy
from mmlspark_tpu_torch.serving.quant import QuantizationConfig
from mmlspark_tpu_torch.serving.rollout import (
    ModelVersionManager, RolloutError, RolloutOrchestrator,
)
from mmlspark_tpu_torch.serving.slo import (
    AlertNotifier, DEFAULT_WINDOWS, SLOEngine, SLOPolicy,
    resolve_policies,
)
from mmlspark_tpu_torch.serving.tenancy import (
    ANONYMOUS_ID, FairCycle, TenantRegistry, extract_api_key,
)

logger = get_logger("serving")


class _Server(ThreadingHTTPServer):
    # the stdlib default backlog (5) resets connections under bursty load;
    # serving frontends must absorb a full batch's worth of simultaneous
    # connects
    request_queue_size = 1024
    daemon_threads = True


# anonymous request ids: a process-unique random prefix + a counter.
# uuid4() costs an os.urandom syscall per request — pure overhead for
# requests that never supplied an X-Request-Id (their rid only keys the
# in-flight table, never crosses the wire)
import itertools

_RID_PREFIX = uuid.uuid4().hex[:16]
_RID_COUNTER = itertools.count()    # .__next__ is atomic under the GIL

#: cap on remembered dispatch shapes (recompile dedup / /stats evidence);
#: a healthy bucketed worker uses ~log2(max_batch_size) of these
_MAX_SHAPES_TRACKED = 1024


class _PendingRequest:
    __slots__ = ("rid", "payload", "event", "reply", "status", "deadline",
                 "trace", "span", "t_enqueue", "callbacks", "stream",
                 "tenant")

    def __init__(self, payload: Any, rid: Optional[str] = None,
                 deadline: Optional[Deadline] = None,
                 trace: Optional[str] = None):
        self.rid = rid or f"{_RID_PREFIX}-{next(_RID_COUNTER):x}"
        self.payload = payload
        self.event = threading.Event()
        # completion fan-out: the threaded frontend's handler threads
        # block on ``event``; the event-loop frontend registers a
        # callback here instead (fired at commit, from whichever stage
        # thread resolves the request) — both may be active at once
        # when a threaded retry joins a request an event-loop client
        # enqueued, or vice versa
        self.callbacks: List[Any] = []
        self.reply: Optional[bytes] = None
        self.status = 200
        self.deadline = deadline
        # the request's X-Trace-Id (inbound or minted at ingress):
        # carried on the work item because the staged pipeline crosses
        # threads, where contextvars do not follow — each stage
        # re-enters trace_context from this field
        self.trace = trace or new_trace_id()
        # the request's ROOT span (and enqueue timestamp): carried for
        # the same cross-thread reason — each stage records its child
        # spans (queue_wait/assemble/dispatch/encode/commit) under this
        # parent. None for synthetic warmup work, which records nothing.
        self.span = None
        self.t_enqueue: Optional[float] = None
        # token-streaming handle (decode plane, stream=1): the decode
        # scheduler emits per-token SSE events through it and finishes
        # the chunked body at resolution; None for everything else
        self.stream = None
        # owning tenant id while this request holds a tenant in-flight
        # slot (tenancy enabled); cleared by the release funnel so the
        # slot can never be returned twice
        self.tenant: Optional[str] = None


class _ThreadedStream:
    """Token-stream handle for the threaded frontend: the decode
    scheduler's ``emit``/``finish`` land on a queue the blocked
    handler thread drains into chunked writes (the threaded analogue
    of :class:`~mmlspark_tpu_torch.serving.frontend._EventLoopStream`).
    ``closed`` flips on a write error (client gone) or a stalled
    stream; producers poll it and cancel."""

    __slots__ = ("q", "closed", "done", "t_first")

    def __init__(self):
        self.q: "Queue[tuple]" = Queue()
        self.closed = False
        self.done = False
        # monotonic stamp of the first chunk actually written to the
        # client socket — the socket-edge TTFT (0.0 = none yet)
        self.t_first = 0.0

    def emit(self, data: bytes) -> None:
        if not (self.closed or self.done):
            self.q.put((data, False))

    def finish(self, data: bytes = b"") -> None:
        if self.closed or self.done:
            return
        self.done = True
        self.q.put((data, True))


def _stream_requested(path: str, payload: Any) -> bool:
    """Token streaming opt-in: ``?stream=1`` on the decode path or
    ``"stream": true`` in the payload. The query is parsed per
    parameter — ``stream=10`` or ``upstream=1`` must NOT upgrade a
    client that expects a plain JSON reply."""
    q = path.partition("?")[2]
    if q and any(p == "stream=1" for p in q.split("&")):
        return True
    return isinstance(payload, dict) and payload.get("stream") is True


class ServingServer:
    """One host's serving frontend.

    ``model`` is any Transformer; request JSON objects become rows of a
    micro-batched frame, ``reply_cols`` (default: columns the model added)
    are returned per row as JSON.
    """

    def __init__(self, model: Transformer, host: str = "127.0.0.1",
                 port: int = 0, api_path: str = "/predict",
                 max_batch_size: int = 64, max_latency_ms: float = 10.0,
                 reply_cols: Optional[List[str]] = None,
                 request_timeout: float = 30.0,
                 journal_size: int = 4096,
                 journal_ttl: Optional[float] = None,
                 journal_path: Optional[str] = None,
                 idle_timeout: Optional[float] = 60.0,
                 max_queue: int = 1024,
                 shed_retry_after: float = 0.1,
                 pipeline: bool = True,
                 bucket_batches: bool = True,
                 encoder_threads: int = 2,
                 max_inflight_batches: int = 2,
                 slow_trace_ms: Optional[float] = 250.0,
                 adaptive_slow_trace: bool = True,
                 adaptive_floor_ms: float = 25.0,
                 adaptive_ceiling_ms: float = 5000.0,
                 adaptive_min_count: int = 50,
                 tracer=None,
                 frontend: str = "eventloop",
                 acceptors: int = 1,
                 reuse_port: bool = False,
                 max_conns_per_ip: int = 0,
                 max_pipelined_per_iter: int = 16,
                 model_version: str = "v1",
                 verify_checkpoints: bool = True,
                 rollout_fault_plan=None,
                 decoder: Optional[DecodeScheduler] = None,
                 decode_path: str = "/generate",
                 batch_policy: str = "fixed",
                 capture=None,
                 quantization=None,
                 tls_cert: Optional[str] = None,
                 tls_key: Optional[str] = None,
                 ssl_context=None,
                 tenancy=None,
                 slo=None,
                 slo_webhook: Optional[str] = None,
                 tsdb=None,
                 profile_dir: Optional[str] = None,
                 cpu_profiler=None,
                 incidents=None,
                 clock: Clock = SYSTEM_CLOCK):
        self.api_path = api_path
        self.max_batch_size = int(max_batch_size)
        self.max_latency_ms = float(max_latency_ms)
        self.reply_cols = reply_cols
        self.request_timeout = request_timeout
        # -- data plane: with ``pipeline`` (the default) collection,
        # model dispatch, and reply encoding run as separate stages on
        # their own threads, so host JSON/frame work for batch N+1
        # overlaps model execution for batch N. ``bucket_batches`` pads
        # every live batch up to the shared power-of-two bucket ladder
        # (pad_to_bucket) so steady-state traffic hits a fixed set of
        # compiled executables: models see padded row counts; replies
        # are always unpadded. ``max_inflight_batches`` bounds the
        # pipeline depth (backpressure to the collector), and
        # ``encoder_threads`` sizes the reply-encoder pool.
        self.pipeline = bool(pipeline)
        self.bucket_batches = bool(bucket_batches)
        self.encoder_threads = max(int(encoder_threads), 1)
        self.max_inflight_batches = max(int(max_inflight_batches), 1)
        # -- telemetry: a PER-SERVER registry (two workers in one test
        # process must never mix counts) rendered by ``GET /metrics``
        # together with the process-wide REGISTRY. StageTimings is a
        # thin view over the same registry, so /stats and /metrics
        # report the one set of samples. The pre-existing plain-int
        # counters (n_shed, n_recompiles, ...) stay the source of truth
        # — the registry exposes them through exposition-time callbacks,
        # so the request hot path pays nothing for the counter surface;
        # only the per-bucket dispatch histogram adds a (sub-us) observe
        # per BATCH.
        # the server's injectable clock feeds the registry too, so
        # chaos tests drive Histogram.time() spans deterministically
        self.registry = MetricsRegistry(clock=clock)
        self.timings = StageTimings(registry=self.registry,
                                    metric="serving_stage_duration_ms")
        # -- versioned hot-swap: the manager owns the ACTIVE model
        # version the dispatch stage reads (one snapshot per batch, so
        # a flip lands between batches and in-flight batches finish on
        # the version that dispatched them), plus at most one staged
        # next version (loaded/digest-verified/bucket-warmed in the
        # background) and the previous version kept resident for
        # instant rollback — see serving/rollout.py and docs/serving.md
        # "Zero-downtime rollout". ``model_version`` names the boot
        # version; ``verify_checkpoints=False`` disables the strict
        # flip-eligibility digest check (tests only).
        # -- the quantized wire (optional): a per-version
        # QuantizationConfig rides the ModelVersion — the dispatch
        # stage casts the assembled frame to the wire dtype (u8/int8)
        # right after its version snapshot, the model dequantizes on
        # device (x*scale+zero_point fused into the first layer), and
        # serving_wire_bytes_total{dtype} counts what actually crossed
        # to the device. Validated at construction: a malformed
        # scale/zero-point raises here (and 400s at the rollout
        # endpoint), never dispatches garbage. When the model itself
        # carries a config (a persisted quantized checkpoint), it is
        # adopted — one source of truth either way.
        quantization = QuantizationConfig.from_value(quantization)
        if quantization is None:
            quantization = QuantizationConfig.from_value(
                getattr(model, "quantization", None))
        if quantization is not None:
            quantization.configure_model(model)
        self.versions = ModelVersionManager(
            self, model, version=model_version,
            verify_checkpoints=verify_checkpoints,
            fault_plan=rollout_fault_plan,
            quantization=quantization)
        self._m_wire_bytes = self.registry.counter(
            "serving_wire_bytes_total",
            "Bytes of assembled frame columns dispatched into the "
            "model, labeled by column dtype — the bytes-on-wire "
            "evidence that the quantized plane is engaged (u8 rows "
            "are 4x smaller than f32).", labels=("dtype",))
        # remembered by warmup(): staged versions warm with the same
        # payload schema unless the rollout supplies its own
        self.warmup_payload: Any = None
        # -- tracing: one root span per request, child spans per stage,
        # recorded into the process-wide flight recorder. Tail capture:
        # a completed trace is RETAINED (GET /trace/<id>) only when its
        # root exceeded ``slow_trace_ms`` (per-route threshold, keyed by
        # api_path) or ended non-ok (error/shed/deadline/timeout);
        # everything else is dropped after the histograms have their
        # samples. ``tracer`` is injectable so tests drive captures with
        # a ManualClock-backed private tracer. NOTE: thresholds are
        # per-(tracer, route) — two servers sharing the process TRACER
        # and one api_path share one threshold (last constructed wins);
        # inject private tracers where that matters (tests, A/B tools).
        self.tracer = tracer if tracer is not None else TRACER
        self.slow_trace_ms = slow_trace_ms
        self.tracer.set_threshold(api_path, slow_trace_ms)
        if decoder is not None:
            # the decode route shares the configured threshold — without
            # this, trace-everything mode (0.0) never applied to decode
            # requests and their token-timeline spans were unreachable
            # via GET /trace/<id>
            self.tracer.set_threshold(decode_path, slow_trace_ms)
        self._m_dispatch = self.registry.histogram(
            "serving_dispatch_latency_ms",
            "Model dispatch wall-clock per shape bucket (label = padded "
            "row count actually dispatched).", labels=("bucket",))
        # billing-grade device-time attribution: each batch's dispatch
        # wall-clock is pro-rated across the tenants whose rows rode it
        # (the decode plane pro-rates its step/spec-round/prefill time
        # the same way through this family — see decode.py)
        self._m_tenant_device = self.registry.counter(
            "serving_tenant_device_ms_total",
            "Device wall-clock milliseconds attributed to each tenant: "
            "batch dispatch pro-rated by rows, decode steps pro-rated "
            "by active slots, prefill charged to its request.",
            labels=("tenant",))
        # -- adaptive tail-capture threshold: once the route has enough
        # dispatch-latency samples (adaptive_min_count — until then the
        # configured slow_trace_ms keeps ruling), the threshold tracks
        # the route's own p95 (clamped to [floor, ceiling]), refreshed
        # every few batches from the encoder thread — a route whose
        # baseline is 8 ms captures its 40 ms outliers, one whose
        # baseline is 400 ms stops capturing everything. Disabled when
        # adaptation is off or the fixed threshold is a sentinel
        # (0 = trace-everything harness mode, None = errors only).
        self.adaptive: Optional[AdaptiveThreshold] = None
        if adaptive_slow_trace and slow_trace_ms is not None \
                and slow_trace_ms > 0:
            fam = self._m_dispatch
            self.adaptive = AdaptiveThreshold(
                self.tracer, api_path,
                lambda: [(fam.buckets, c.stats()["buckets"])
                         for _, c in fam.children()],
                floor_ms=adaptive_floor_ms,
                ceiling_ms=adaptive_ceiling_ms,
                min_count=adaptive_min_count)
        # -- adaptive micro-batching (A/B vs the fixed knob): with
        # ``batch_policy="adaptive"`` the collector's batch-mate wait
        # is decided per batch from the measured arrival rate and the
        # per-bucket dispatch-latency histograms, with the configured
        # ``max_latency_ms`` demoted to a hard ceiling — see
        # serving/policy.py and docs/serving.md "Adaptive batching".
        # ``"fixed"`` (the default) keeps the constant knob.
        self.batch_policy = str(batch_policy)
        if self.batch_policy not in ("fixed", "adaptive"):
            raise ValueError(
                f"unknown batch_policy {batch_policy!r} "
                "(expected 'fixed' or 'adaptive')")
        self.adaptive_batcher: Optional[AdaptiveBatchPolicy] = None
        if self.batch_policy == "adaptive":
            fam = self._m_dispatch

            def _bucket_stats():
                out = []
                for key, child in fam.children():
                    try:
                        rows = int(key[0])
                    except (IndexError, ValueError):
                        continue
                    out.append((rows, fam.buckets,
                                child.stats()["buckets"]))
                return out

            self.adaptive_batcher = AdaptiveBatchPolicy(
                _bucket_stats, self._bucket_sizes(),
                ceiling_ms=self.max_latency_ms, clock=clock)
        # -- continuous-batching decode plane (optional): POSTs to
        # ``decode_path`` route to a DecodeScheduler (slot-indexed
        # KV-cache continuous batching — serving/decode.py) through
        # the SAME admission path as the frame plane, so replay/join/
        # shed/deadline/journal semantics are identical. GET
        # /decode/stats exposes slot occupancy + in-flight progress.
        self.decode_path = decode_path
        self.decoder = decoder
        self.n_recompiles = 0
        self._shapes_seen: set = set()
        self._stats_lock = threading.Lock()
        # accepted-but-undispatched request count: the overload signal.
        # The ingress queue alone no longer measures backlog — the
        # pipelined collector drains it into the dispatch stage — so
        # shedding counts every request that has been accepted but has
        # not yet entered the model (ingress queue + staged batches).
        self._n_backlog = 0
        self._dispatch_q: "Queue[dict]" = Queue(
            maxsize=self.max_inflight_batches)
        self._encode_q: "Queue[dict]" = Queue(
            maxsize=2 * self.max_inflight_batches)
        # None (stdlib idiom) and <= 0 both mean "no keep-alive reap"
        self.idle_timeout = (float(idle_timeout)
                             if idle_timeout is not None else 0.0)
        # -- degradation under overload: beyond ``max_queue`` queued
        # requests (0 = unbounded) NEW work is shed with 429 +
        # Retry-After instead of queueing into a timeout — the client
        # gets an honest backpressure signal while replays/joins of
        # already-accepted work keep succeeding. ``clock`` feeds
        # per-request deadlines (X-Deadline-Ms): injectable so chaos
        # tests expire deadlines without wall-clock waits.
        self.max_queue = int(max_queue)
        self.shed_retry_after = float(shed_retry_after)
        self.clock = clock
        # -- tenant isolation (optional): ``tenancy`` is a
        # TenantRegistry / config dict / JSON path; when omitted the
        # MMLSPARK_TENANTS env var is consulted. With a registry, API
        # keys resolve to tenants at the edge, _admit charges token
        # buckets + in-flight caps per tenant, shedding becomes
        # priority-aware past the registry's high-water mark, and the
        # collector assembles batches in deficit-weighted round-robin
        # order per tenant (see serving/tenancy.py and docs/serving.md
        # "Tenancy & overload control"). All of it is host-side
        # bookkeeping BEFORE batch assembly — dispatch shapes, and
        # therefore the compiled-executable set, are tenant-blind.
        self.tenancy: Optional[TenantRegistry] = \
            TenantRegistry.from_value(tenancy, clock=clock)
        if self.tenancy is None and tenancy is None:
            self.tenancy = TenantRegistry.from_env(clock=clock)
        # collector-thread-only fair-share state (never touched by the
        # ingress threads — they only feed self._queue)
        self._fair_cycle = FairCycle()
        self._fair_q: Dict[str, "deque[_PendingRequest]"] = {}
        self._fair_total = 0
        self._m_tenant_latency = None
        self.n_shed = 0
        self.n_deadline_expired = 0
        # 5xx replies committed (model/encode failures): the per-worker
        # error signal the rollout canary comparison reads
        self.n_errors = 0
        self._draining = threading.Event()
        self._active_batches = 0
        # SimpleQueue, not Queue: the ingress handoff runs once PER
        # REQUEST from the frontend threads — the C-implemented
        # lock-free put/get is measurably cheaper than Queue's Python
        # lock + condvar at serving rates (the stage queues below keep
        # Queue for its maxsize backpressure)
        self._queue: "SimpleQueue[_PendingRequest]" = SimpleQueue()
        self._stop = threading.Event()
        # -- the socket edge: ``frontend="eventloop"`` (the default)
        # serves ingress from selectors-based non-blocking accept/read/
        # write loops — HTTP/1.1 keep-alive steady state, zero-copy
        # framing, vectored single-syscall replies, and optional
        # SO_REUSEPORT multi-acceptor loops (``acceptors``/
        # ``reuse_port``) — see serving/frontend.py and docs/serving.md
        # "The socket edge". ``frontend="threaded"`` keeps the
        # thread-per-connection http.server plane as the A/B baseline.
        # Both speak to the SAME staged data plane; only the edge
        # differs.
        self.frontend = str(frontend)
        if self.frontend == "eventloop":
            self._server = None
            self._frontend: Optional[EventLoopFrontend] = \
                EventLoopFrontend(
                    self, host, port,
                    acceptors=acceptors, reuse_port=reuse_port,
                    idle_timeout=self.idle_timeout,
                    request_timeout=self.request_timeout,
                    max_conns_per_ip=max_conns_per_ip,
                    max_pipelined_per_iter=max_pipelined_per_iter,
                    tls_cert=tls_cert, tls_key=tls_key,
                    ssl_context=ssl_context,
                    registry=self.registry, name="serving")
            self.host, self.port = (self._frontend.host,
                                    self._frontend.port)
        elif self.frontend == "threaded":
            if tls_cert or tls_key or ssl_context is not None:
                # TLS termination lives in the event-loop state machine
                # (non-blocking handshakes); the threaded A/B plane
                # stays plaintext rather than growing a second,
                # blocking TLS implementation that could drift
                raise ValueError(
                    "TLS requires frontend='eventloop' (the threaded "
                    "plane is the plaintext A/B baseline)")
            self._frontend = None
            self._server = _Server((host, port), self._handler_class())
            self.host, self.port = self._server.server_address[:2]
        else:
            raise ValueError(
                f"unknown frontend {frontend!r} "
                "(expected 'eventloop' or 'threaded')")
        self._threads: List[threading.Thread] = []
        self.n_requests = 0
        self.n_batches = 0
        # exactly-once reply semantics (parity: the continuous reader's
        # per-epoch offset commits, `HTTPSourceV2.scala:272,312`): a
        # client-supplied X-Request-Id keys a committed-reply journal, so
        # a retried/re-submitted request returns the SAME reply without
        # re-running inference; retries racing the original join its
        # in-flight entry instead of enqueuing a second compute.
        #
        # The journal is a bounded window, not an infinite log: entries
        # are evicted beyond ``journal_size`` commits (LRU) or after
        # ``journal_ttl`` seconds. A retry landing AFTER its entry was
        # evicted cannot be deduplicated — it re-executes. To make that
        # window *observable* rather than silent, evicted ids are kept in
        # a cheap id-only ring (16x journal_size); a rid seen there is a
        # detected past-window retry: it re-executes with a warning log,
        # an ``X-Replay-Window-Missed: 1`` response header, and the
        # ``n_window_missed`` counter (surfaced via ``GET /status``).
        self.journal_size = int(journal_size)
        # 0/negative means "no age-out", matching idle_timeout's idiom
        self.journal_ttl = (float(journal_ttl)
                            if journal_ttl is not None and journal_ttl > 0
                            else None)
        # rid -> (status, reply, committed_at_mono, trace_id)
        self._journal: "OrderedDict[str, Tuple[int, bytes, float, str]]" \
            = OrderedDict()
        self._evicted: "OrderedDict[str, None]" = OrderedDict()
        self._inflight: Dict[str, _PendingRequest] = {}
        self._commit_lock = threading.Lock()
        self.n_replayed = 0
        self.n_journal_evicted = 0
        self.n_window_missed = 0
        # -- durable journal (optional): the in-memory journal dies with
        # the process, so a pod crash-restart (exactly the k8s scenario)
        # would lose the replay window and a client retry spanning the
        # restart would re-execute. With ``journal_path`` (any io.fs
        # path — a PVC mount, gs://...), every commit appends one JSON
        # line and ServingServer REPLAYS the file on construction:
        # committed replies survive restarts, surfaced via
        # ``journal_recovered`` in ``GET /status``. Wall-clock
        # timestamps ride the file so the TTL window spans restarts.
        # Journal lines are written by a DEDICATED writer thread: the
        # commit path only enqueues the encoded line, so file append
        # latency (a real cost when journal_path is a remote io.fs
        # target like gs://, where every append is object I/O) never
        # lands on request tail latency or serializes commits (r4
        # advisor). Durability window: a reply can be released a few
        # microseconds before its line is flushed, so a crash in that
        # gap downgrades exactly-once to at-least-once for the affected
        # requests — the same contract as the reference's epoch commits.
        self.journal_path = journal_path
        self.n_journal_recovered = 0
        self._journal_fh = None
        self._journal_file_lines = 0   # appended since last compaction
        self._journal_queue: "Queue[bytes]" = Queue()
        if journal_path:
            self._recover_journal()
        # -- traffic capture (optional): an opt-in, bounded,
        # NON-BLOCKING journal of committed request/reply rows (plus
        # sampled shadow-diff rows) — the feedstock of the retrain
        # loop. The encoder stage offers each committed batch; a
        # dedicated writer thread does all file I/O, and a full queue
        # drops the batch (counted) rather than delay live traffic.
        # See serving/capture.py and docs/streaming.md.
        self.capture = capture
        # warmup() flips this around its synthetic batches so they are
        # never captured as traffic (warmup runs serially pre-start)
        self._in_warmup = False
        if capture is not None:
            capture.bind(self.registry)
        if self.decoder is not None:
            # bound last: bind reads the server's clock/tracer/registry
            # and commit path, all of which must exist first
            self.decoder.bind(self)
        # -- SLO engine (on by default): declarative burn-rate alerting
        # over this worker's OWN registry — ``slo`` is False (off), a
        # policy list / config dict (serving/slo.py), or None for the
        # stock worker policies (availability + dispatch latency, plus
        # TTFT/TPOT when the decode plane exists). Evaluation is pulled
        # by scrapes of ``GET /alerts`` / ``GET /slo`` and by the
        # firing-gauge exposition callback — nothing runs on the
        # request hot path. ``slo_webhook`` POSTs each firing/resolved
        # transition (own breaker board, never blocks evaluation).
        self.slo: Optional[SLOEngine] = None
        if slo is not False:
            self.slo = SLOEngine(
                self.registry,
                resolve_policies(slo,
                                 has_decoder=self.decoder is not None),
                clock=clock,
                notifier=(AlertNotifier(slo_webhook)
                          if slo_webhook else None))
        # -- retrospective plane (on by default): the embedded TSDB +
        # background Recorder (core/tsdb.py). ``tsdb`` is False (off),
        # None for stock tiers/rules/watches, or a config dict:
        # interval_s, tiers, max_series, snapshot_dir/keep/prefix,
        # budget_ms, rules (list of RecordingRule or dicts; None =
        # stock), watches (likewise), anomaly (False disables
        # detection). ONE scrape per tick feeds the TSDB, the optional
        # .prom dumper, and the SLO engine's snapshot history — a
        # server with a Recorder must not also run a MetricsSnapshot.
        # ``GET /query`` / ``GET /query_range`` serve the store;
        # anomaly transitions ride the SLO notifier and merge into
        # ``GET /alerts``.
        self.tsdb: Optional[TimeSeriesStore] = None
        self.recorder: Optional[Recorder] = None
        self.anomalies: Optional[AnomalyDetector] = None
        if tsdb is not False:
            cfg = dict(tsdb) if isinstance(tsdb, dict) else {}
            has_decoder = self.decoder is not None
            self.tsdb = TimeSeriesStore(
                tiers=cfg.get("tiers", DEFAULT_TIERS),
                max_series=cfg.get("max_series", 8192))
            rules = cfg.get("rules")
            rules = (default_serving_rules(
                         has_decoder=has_decoder,
                         has_tenancy=self.tenancy is not None)
                     if rules is None
                     else [RecordingRule.from_value(r) for r in rules])
            # incident bundles dump exactly these precomputed series
            self._tsdb_rules = rules
            if cfg.get("anomaly", True):
                watches = cfg.get("watches")
                watches = (default_serving_watches(
                               has_decoder=has_decoder)
                           if watches is None
                           else [AnomalyWatch.from_value(w)
                                 for w in watches])
                self.anomalies = AnomalyDetector(
                    self.tsdb, watches, clock=clock,
                    notifier=(self.slo.notifier
                              if self.slo is not None else None))
            self.recorder = Recorder(
                (self.registry, REGISTRY), store=self.tsdb,
                interval_s=cfg.get("interval_s", 10.0), clock=clock,
                snapshot_dir=cfg.get("snapshot_dir"),
                snapshot_keep=cfg.get("keep", 24),
                snapshot_prefix=cfg.get("prefix", "metrics"),
                slo=self.slo, rules=rules, detector=self.anomalies,
                ingest_budget_ms=cfg.get("budget_ms", 25.0))
        # -- device observability: one-at-a-time on-demand profiler
        # windows (POST /profile -> torch.profiler trace on disk), the
        # bounded compile-event ledger the dispatch stage feeds, and
        # the per-bucket MFU meter (flops via the model's
        # dispatch_flops/cost_analysis hook, when it has one)
        self.profiler = DeviceProfiler(base_dir=profile_dir)
        self.compile_ledger = CompileLedger()
        self.mfu = MfuMeter()
        self._flops_cache: Dict[tuple, Optional[float]] = {}
        # -- postmortem plane: always-on sampling CPU profiler +
        # anomaly-triggered incident capture. ``cpu_profiler`` is None
        # for the stock always-on sampler (50 hz, ~3 min retention),
        # False/{"hz": 0} to disable, or a config dict (hz,
        # retention_s, max_depth, max_stacks). ``GET /profile/cpu``
        # serves windows/diffs; the incident bundle reads the same
        # ring. ``incidents`` is None/False (off — nothing written
        # unless asked), a directory path, or a config dict (dir,
        # cooldown_s, max_incidents, profile_pre_s, profile_post_s,
        # lookback_s, series_step_s): when set, every SLO/anomaly
        # pending->firing transition snapshots an evidence bundle to
        # ``<dir>/<id>/`` — see serving/incident.py and
        # docs/observability.md "The postmortem plane".
        self.cpu_profiler: Optional[SamplingProfiler] = None
        if cpu_profiler is not False:
            pcfg = (dict(cpu_profiler) if isinstance(cpu_profiler, dict)
                    else {})
            if float(pcfg.get("hz", 50.0)) > 0:
                self.cpu_profiler = SamplingProfiler(
                    hz=pcfg.get("hz", 50.0),
                    retention_s=pcfg.get("retention_s", 180.0),
                    max_depth=pcfg.get("max_depth", 48),
                    max_stacks=pcfg.get("max_stacks", 8192),
                    clock=clock)
        # the process-wide log ring (core/logs.py): what GET /logs
        # serves and what the incident bundle snapshots
        self.log_ring = install_log_ring()
        self.incidents: Optional[IncidentManager] = None
        if incidents:
            icfg = ({"dir": incidents} if isinstance(incidents, str)
                    else dict(incidents))
            self.incidents = IncidentManager(
                icfg["dir"],
                tsdb=self.tsdb,
                tracer=self.tracer,
                profiler=self.cpu_profiler,
                log_ring=self.log_ring,
                stats_fn=self._incident_stats,
                related_exprs=[r.record for r in
                               getattr(self, "_tsdb_rules", [])],
                cooldown_s=icfg.get("cooldown_s", 300.0),
                max_incidents=icfg.get("max_incidents", 16),
                profile_pre_s=icfg.get("profile_pre_s", 60.0),
                profile_post_s=icfg.get("profile_post_s", 30.0),
                lookback_s=icfg.get("lookback_s", 600.0),
                series_step_s=icfg.get("series_step_s", 10.0),
                clock=clock)
            # fan alert transitions out to BOTH the webhook notifier
            # (when configured) and the incident manager — the SLO
            # engine and the anomaly detector keep their single
            # notifier slot, the fan-out sits behind it
            fan = FanoutNotifier(
                self.slo.notifier if self.slo is not None else None,
                self.incidents)
            if self.slo is not None:
                self.slo.notifier = fan
            if self.anomalies is not None:
                self.anomalies.notifier = fan
        self._register_metric_views()

    @property
    def model(self):
        """The ACTIVE model version's transformer. Kept as a property
        so the pre-rollout ``server.model`` surface still works; the
        dispatch stage itself snapshots the whole
        :class:`~mmlspark_tpu_torch.serving.rollout.ModelVersion` per batch
        (model + version label together, so a mid-batch flip can't
        split them)."""
        return self.versions.active.model

    def _charge_tenant_device(self, pendings, total_ms: float) -> None:
        """Pro-rate one batch's dispatch wall-clock across the tenants
        whose rows rode it (equal share per row — rows are what the
        batch is made of). Tenant ids resolve to their bounded metric
        labels via the tenant registry; unattributed traffic charges
        to the anonymous tenant. One counter inc per distinct tenant
        per batch — micro-cost on the dispatch (not request) path."""
        if total_ms <= 0 or not pendings:
            return
        counts: Dict[Optional[str], int] = {}
        for p in pendings:
            tid = getattr(p, "tenant", None)
            counts[tid] = counts.get(tid, 0) + 1
        share = total_ms / len(pendings)
        for tid, n in counts.items():
            if tid is None:
                label = ANONYMOUS_ID
            elif self.tenancy is not None:
                label = self.tenancy.label_of(tid)
            else:
                label = str(tid)
            self._m_tenant_device.labels(label).inc(share * n)

    def _register_metric_views(self) -> None:
        """Expose the server's existing counters/state as registry
        families via exposition-time callbacks: ``GET /metrics`` reads
        them live, the hot paths keep their plain-int increments (int
        reads are tear-free under the GIL)."""
        m = self.registry
        for name, help_, fn in (
            ("serving_requests_total",
             "Requests that entered a batch (includes synthetic warmup "
             "rows).", lambda: self.n_requests),
            ("serving_batches_total",
             "Micro-batches processed.", lambda: self.n_batches),
            ("serving_shed_total",
             "New requests refused with 429 under overload.",
             lambda: self.n_shed),
            ("serving_deadline_missed_total",
             "Requests 504ed because their X-Deadline-Ms budget expired "
             "(at ingress, before dispatch, or before commit).",
             lambda: self.n_deadline_expired),
            ("serving_recompiles_total",
             "Distinct dispatch shapes seen (each forces a jit retrace "
             "in any jitted model).", lambda: self.n_recompiles),
            ("serving_replayed_total",
             "Requests answered from the exactly-once reply journal.",
             lambda: self.n_replayed),
            ("serving_journal_evicted_total",
             "Journal entries evicted past the replay window.",
             lambda: self.n_journal_evicted),
            ("serving_window_missed_total",
             "Retries that arrived after their journal entry was "
             "evicted (re-executed).", lambda: self.n_window_missed),
            ("serving_errors_total",
             "Requests answered 5xx (model/encode failures) — the "
             "per-worker error signal rollout canarying compares.",
             lambda: self.n_errors),
        ):
            m.counter(name, help_).set_function(fn)
        m.gauge("serving_backlog",
                "Requests accepted but not yet dispatched into the "
                "model (the shedding signal).").set_function(self.backlog)
        m.gauge("serving_inflight_batches",
                "Batches between collection and commit."
                ).set_function(lambda: self._active_batches)
        m.gauge("serving_journal_entries",
                "Live replay-journal entries."
                ).set_function(lambda: len(self._journal))
        # build identity: a constant-1 gauge whose labels ARE the value
        # (version/torch/cuda/device_kind/frontend) — joinable against
        # every other serving metric, echoed in /stats as "build"
        self.build = register_build_info(self.registry,
                                         frontend=self.frontend)
        # device memory from the CUDA caching allocator (0s without CUDA
        # — the families still exist so dashboards don't 404)
        for name, help_, key in (
            ("serving_hbm_bytes_in_use",
             "Device HBM bytes currently allocated (device 0).",
             "bytes_in_use"),
            ("serving_hbm_peak_bytes",
             "Device HBM high-water mark since process start.",
             "peak_bytes"),
            ("serving_hbm_bytes_limit",
             "Device HBM allocator limit.", "bytes_limit"),
        ):
            m.gauge(name, help_).set_function(
                lambda k=key: device_memory_stats().get(k, 0))
        if self.slo is not None:
            self.slo.register_metrics(m)
        if self.tenancy is not None:
            self._register_tenant_metric_views()
        # process vitals belong to the PROCESS-wide registry: two
        # co-hosted workers read the same RSS, and the fleet merge
        # (which scrapes ?scope=server) must not sum it once per worker
        REGISTRY.gauge(
            "process_uptime_seconds",
            "Seconds since process start (resets on restart)."
        ).set_function(process_uptime_s)
        REGISTRY.gauge(
            "process_rss_bytes",
            "Resident set size (leak evidence across chaos drills)."
        ).set_function(lambda: process_rss_bytes() or 0)

    def _register_tenant_metric_views(self) -> None:
        """Per-tenant metric families, exposition-time views over the
        registry's plain counters. Cardinality is bounded by the
        registry's BoundedLabelSet: the first ``label_cap`` tenants
        (declaration order) get their own label value, the tail folds
        into ``other`` — a child's view function sums every state
        mapped to its label, so ``other`` is one honest aggregate row,
        not last-writer-wins."""
        m, reg = self.registry, self.tenancy
        c_req = m.counter(
            "serving_tenant_requests_total",
            "Requests admitted per tenant (replays and sheds are "
            "counted separately).", labels=("tenant",))
        c_shed = m.counter(
            "serving_tenant_shed_total",
            "Requests refused per tenant, by reason: rate (token "
            "bucket empty), concurrency (in-flight cap), overload "
            "(priority-aware queue-pressure shed).",
            labels=("tenant", "reason"))
        c_tok = m.counter(
            "serving_tenant_tokens_total",
            "Decode-plane tokens generated per tenant.",
            labels=("tenant",))
        c_good = m.counter(
            "serving_tenant_goodput_tokens_total",
            "Decode-plane tokens from requests that resolved cleanly "
            "(eos/length) per tenant — the numerator of per-tenant "
            "goodput.", labels=("tenant",))
        g_inf = m.gauge(
            "serving_tenant_inflight",
            "Requests currently holding a tenant in-flight slot.",
            labels=("tenant",))
        self._m_tenant_latency = m.histogram(
            "serving_tenant_request_latency_ms",
            "Enqueue->commit wall-clock per tenant (the per-tenant "
            "dispatch-latency surface; admission-rejected requests "
            "never reach it).", labels=("tenant",))
        for label in reg.labels():
            states = reg.states_for_label(label)
            c_req.labels(label).set_function(
                lambda ss=states: sum(s.n_requests for s in ss))
            c_tok.labels(label).set_function(
                lambda ss=states: sum(s.n_tokens for s in ss))
            c_good.labels(label).set_function(
                lambda ss=states:
                sum(s.n_goodput_tokens for s in ss))
            g_inf.labels(label).set_function(
                lambda ss=states: sum(s.inflight for s in ss))
            for reason, attr in (("rate", "n_shed_rate"),
                                 ("concurrency", "n_shed_concurrency"),
                                 ("overload", "n_shed_overload")):
                c_shed.labels(label, reason).set_function(
                    lambda ss=states, a=attr:
                    sum(getattr(s, a) for s in ss))

    # -- HTTP side -----------------------------------------------------------

    def _handler_class(self):
        serving = self

        class Handler(BaseHTTPRequestHandler):
            # HTTP/1.1: keep-alive sockets (every reply carries an
            # explicit Content-Length) — per-request TCP connects would
            # dominate the latency the server exists to minimize.
            # Nagle must go with it: status/headers/body are separate
            # writes, and Nagle + delayed ACK turns each keep-alive
            # response into a 40 ms stall. The idle timeout reaps
            # keep-alive connections so parked clients can't pin
            # handler threads forever.
            protocol_version = "HTTP/1.1"
            disable_nagle_algorithm = True
            # 0/negative means "no reap"; a literal 0 would set a
            # NON-BLOCKING socket and kill every connection instantly
            timeout = (serving.idle_timeout
                       if serving.idle_timeout > 0 else None)

            # the Date header is formatted per reply by the stdlib
            # (strftime + tuple math); at thousands of replies/sec that
            # is real CPU for a value that changes once a second
            _date_cache = [0.0, ""]

            def date_time_string(self, timestamp=None):
                if timestamp is not None:
                    return super().date_time_string(timestamp)
                cache = type(self)._date_cache
                now = time.time()
                if now - cache[0] >= 1.0:
                    # value BEFORE timestamp: a concurrent reader that
                    # sees the fresh timestamp must never read the old
                    # (or startup-empty) string
                    cache[1] = super().date_time_string(now)
                    cache[0] = now
                return cache[1]

            def _reply(self, status: int, body: bytes, replayed=False,
                       window_missed=False, retry_after=None,
                       trace=None, ctype="application/json", extra=()):
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                if trace:
                    # echo the trace id so a client that did not supply
                    # one can still correlate its reply with worker logs
                    self.send_header(TRACE_HEADER, trace)
                if replayed:
                    self.send_header("X-Replayed", "1")
                if window_missed:
                    self.send_header("X-Replay-Window-Missed", "1")
                if retry_after is not None:
                    self.send_header("Retry-After", str(retry_after))
                for k, v in extra:
                    self.send_header(k, v)
                self.send_header("Content-Length", str(len(body)))
                # one write for status+headers+body: Nagle is disabled,
                # so the stdlib's separate end_headers()/body writes
                # would leave as separate packets. HTTP/0.9 requests
                # (e.g. `nc`-style probes) never get a headers buffer —
                # fall back to the stdlib path for them
                buf = getattr(self, "_headers_buffer", None)
                if buf:
                    buf.append(b"\r\n")
                    self.wfile.write(b"".join(buf) + body)
                    self._headers_buffer = []
                else:
                    self.end_headers()
                    self.wfile.write(body)

            def do_GET(self):
                # one route table for both frontends: the threaded
                # handler and the event-loop frontend's handle_request
                # serve the SAME _get_route result — observability
                # endpoints cannot drift between the A/B planes
                route = serving._get_route(self.path, self.headers)
                if route is None:
                    self.send_error(404)
                    return
                status, body, ctype, extra = route
                self._reply(status, body, ctype=ctype, extra=extra)

            def do_POST(self):
                # the decode path matches on the BASE path so the
                # streaming opt-in query (?stream=1) still routes here
                is_decode = (serving.decoder is not None
                             and self.path.partition("?")[0]
                             == serving.decode_path)
                if self.path != serving.api_path and not is_decode:
                    # control-plane POSTs (rollout admin) share one
                    # route table with the event-loop frontend
                    length = int(self.headers.get("Content-Length", 0))
                    routed = serving._post_route(
                        self.path, self.rfile.read(length))
                    if routed is None:
                        self.send_error(404)
                        return
                    status, rbody, ctype = routed
                    self._reply(status, rbody, ctype=ctype)
                    return
                # trace ingress: adopt the inbound X-Trace-Id or mint
                # one; bound for this handler thread's logs, carried on
                # the pending request for the stage threads, echoed on
                # every reply. The request's ROOT span opens here and
                # closes when the reply is written — finishing it runs
                # the tail-capture decision (slow or non-ok traces are
                # retained for GET /trace/<id>). An inbound
                # X-Parent-Span-Id (strictly validated; malformed
                # values are dropped, never sanitized into a wrong
                # link) parents this root under the CALLER's egress
                # span, so the worker-side tree stitches into the
                # caller's distributed trace at GET /fleet/trace/<id>.
                tid, parent_sid = extract_span_context(self.headers)
                with trace_context(tid):
                    root = serving.tracer.start(
                        "request", trace_id=tid,
                        remote_parent=parent_sid,
                        route=(serving.decode_path if is_decode
                               else serving.api_path))
                    if capture_hint(self.headers):
                        # the X-Capture wire hint: retain this trace
                        # end to end, thresholds notwithstanding
                        root.force = True
                    status = "error"
                    try:
                        status = self._do_predict(tid, root,
                                                  decode=is_decode)
                    finally:
                        serving.tracer.finish(root, status=status)

            def _do_predict(self, tid, root, decode=False):
                """Serve one POST; returns the root span's terminal
                status (``ok``/``shed``/``deadline``/``timeout``/
                ``error`` — everything but ``ok`` is tail-captured)."""
                if serving._draining.is_set():
                    # graceful drain: accepted work finishes, new work
                    # is refused so the orchestrator's retry lands on a
                    # live worker
                    self._reply(503, b'{"error": "draining"}',
                                retry_after=serving.shed_retry_after,
                                trace=tid)
                    return "shed"
                length = int(self.headers.get("Content-Length", 0))
                try:
                    payload = json.loads(self.rfile.read(length) or b"{}")
                except ValueError:
                    # _reply (not send_error): even a rejected request
                    # must echo its trace id, or the client cannot
                    # correlate the failure with worker logs
                    self._reply(400, b'{"error": "invalid JSON"}',
                                trace=tid)
                    return "error"

                deadline = Deadline.from_headers(self.headers,
                                                 clock=serving.clock)
                rid = self.headers.get("X-Request-Id")
                tenant = serving._resolve_tenant(self.headers)
                if tenant is serving._TENANT_REJECTED:
                    self._reply(401, serving._UNKNOWN_KEY_BODY,
                                trace=tid)
                    return "error"
                if tenant is not None:
                    root.set_attr("tenant", tenant.id)
                kind, pending, committed, window_missed, shed = \
                    serving._admit(payload, rid, deadline, tid,
                                   decode=decode, tenant=tenant)
                if rid:
                    root.set_attr("rid", rid)
                if kind == "replay":
                    root.set_attr("replayed", True)
                    self._reply(committed[0], committed[1],
                                replayed=True, trace=tid)
                    return "ok"
                if kind == "shed":
                    self._reply(429, shed["body"],
                                retry_after=shed["retry_after"],
                                trace=tid)
                    return "shed"
                if kind == "doa":
                    self._reply(504, pending.reply, trace=tid)
                    return "deadline"
                if kind == "enqueue":
                    if decode:
                        stream = (_ThreadedStream()
                                  if _stream_requested(self.path,
                                                       payload)
                                  else None)
                        pending.stream = stream
                        err = serving._enqueue_decode(pending, root)
                        if err is not None:
                            pending.stream = None
                            e_status, e_body = err
                            self._reply(
                                e_status, e_body, trace=tid,
                                retry_after=(
                                    serving._decode_retry_after()
                                    if e_status == 429 else None))
                            return ("shed" if e_status == 429
                                    else "error")
                        if stream is not None:
                            return self._serve_stream(tid, pending,
                                                      stream)
                    else:
                        serving._enqueue(pending, root)
                if not pending.event.wait(serving.request_timeout):
                    # the stuck-batch timeout is the reply operators
                    # most need to trace: echo the id here too
                    self._reply(504, b'{"error": "inference timed out"}',
                                trace=tid)
                    return "timeout"
                # a joined duplicate is only "replayed" if the reply was
                # actually committed — errors are never journaled, so
                # they must not carry the committed-replay marker
                self._reply(pending.status, pending.reply or b"{}",
                            replayed=(kind == "join"
                                      and pending.status == 200),
                            window_missed=window_missed, trace=tid)
                return ("ok" if pending.status == 200 else
                        "deadline" if pending.status == 504 else "error")

            def _serve_stream(self, tid, pending, stream) -> str:
                """Drain the decode scheduler's token events into
                chunked SSE writes from this handler thread — the
                threaded analogue of the event-loop stream. The stream
                was attached BEFORE submit, so no token can slip out
                unstreamed; a write failure (client gone) flips
                ``closed`` and the scheduler cancels the decode."""
                self.send_response(200)
                self.send_header("Content-Type", "text/event-stream")
                self.send_header("Transfer-Encoding", "chunked")
                self.send_header("Cache-Control", "no-cache")
                self.send_header(TRACE_HEADER, tid)
                self.end_headers()
                while True:
                    try:
                        data, end = stream.q.get(
                            timeout=serving.request_timeout)
                    except Empty:
                        # no event within the stuck-batch budget: give
                        # up exactly like the non-streamed 504 path
                        stream.closed = True
                        self.close_connection = True
                        return "timeout"
                    try:
                        if data:
                            self.wfile.write(b"%x\r\n" % len(data)
                                             + data + b"\r\n")
                            if stream.t_first == 0.0:
                                stream.t_first = time.monotonic()
                        if end:
                            self.wfile.write(b"0\r\n\r\n")
                            break
                        self.wfile.flush()
                    except OSError:
                        stream.closed = True
                        self.close_connection = True
                        return "error"
                return ("ok" if pending.status == 200 else
                        "deadline" if pending.status == 504 else
                        "error")

            def log_message(self, *args):  # quiet
                pass

        return Handler

    # -- shared ingress (both frontends) -------------------------------------

    def _get_route(self, path: str, headers
                   ) -> Optional[Tuple[int, bytes, str, tuple]]:
        """The GET route table: ``(status, body, content_type, extra
        headers)`` or None for 404. The threaded handler and the
        event-loop frontend both serve exactly this, so the
        observability surface cannot drift between the A/B planes."""
        if path == "/healthz":
            # liveness: the process answers HTTP at all
            return 200, b'{"ok": true}', "application/json", ()
        if path == "/readyz":
            # readiness: flips 503 the moment drain starts, so an
            # orchestrator stops routing BEFORE the listener goes away
            # (the k8s readiness-probe contract)
            if self._draining.is_set() or self._stop.is_set():
                return (503, b'{"ready": false, "reason": "draining"}',
                        "application/json", ())
            body = {"ready": True,
                    "queue_depth": self.backlog(),
                    "max_queue": self.max_queue}
            return 200, json.dumps(body).encode(), "application/json", ()
        base = path.split("?", 1)[0]
        if base == "/metrics":
            # Prometheus text exposition: the per-server registry
            # (stage/dispatch histograms + counter views) plus the
            # process-wide one (trainer, HTTP egress, breakers, Timer
            # stages). ``?scope=server`` limits to the per-server
            # registry — the fleet merge scrapes that, so co-hosted
            # workers sharing one process REGISTRY never double-count
            # its families in the sum. Exemplars ride ONLY the
            # OpenMetrics exposition (Accept-negotiated, or forced via
            # ?exemplars=1): the classic 0.0.4 grammar has no exemplar
            # production and a strict scraper would fail the whole
            # scrape on the trailer
            server_only = "scope=server" in path
            regs = (self.registry,) if server_only \
                else (self.registry, REGISTRY)
            accept = headers.get("Accept", "") if headers is not None \
                else ""
            openmetrics = ("application/openmetrics-text"
                           in (accept or "")
                           or "exemplars=1" in path)
            body = render_registries(*regs, exemplars=openmetrics)
            if openmetrics:
                body += "# EOF\n"
            return (200, body.encode(),
                    _OPENMETRICS_CONTENT_TYPE if openmetrics
                    else _METRICS_CONTENT_TYPE, ())
        if path == "/stats":
            # data-plane observability: per-stage timings, the bucket
            # set actually dispatched, and the recompile counter (a
            # dispatch shape seen for the first time forces a
            # trace/compile in any jitted model) — the evidence that
            # the bucketed pipeline holds a fixed compiled-shape set
            # after warm-up
            with self._stats_lock:
                stats = {
                    "pipeline": self.pipeline,
                    "bucket_batches": self.bucket_batches,
                    "encoder_threads": self.encoder_threads,
                    "n_batches": self.n_batches,
                    "n_requests": self.n_requests,
                    "n_recompiles": self.n_recompiles,
                    "dispatch_sizes": sorted(
                        {k[0] for k in self._shapes_seen}),
                    "inflight_batches": self._active_batches,
                    "queue_depth": self._n_backlog,
                    "stage_timings": self.timings.snapshot(),
                    # the active model version (full lifecycle detail
                    # at GET /version): the fleet view aggregates this
                    # into its coherent-version-set check
                    "model_version": self.versions.active.version,
                    # the active version's quantized-wire config (None
                    # = the f32 plane): wire dtype + dequant constants
                    # — what serving_wire_bytes_total{dtype} is
                    # evidence OF
                    "quantization": (
                        self.versions.active.quantization.to_dict()
                        if self.versions.active.quantization is not None
                        else None),
                    # per-device placement of the active model (tensor-
                    # parallel dispatch mode): mesh axes, device list,
                    # sharded/replicated leaf split, bytes per device —
                    # None for models that don't report placement
                    "placement": self._model_placement(),
                    # pipeline-parallel dispatch (when the active
                    # model stages itself over mesh slices): stages,
                    # per-stage placement + probe-measured service
                    # times, bubble ratio, in-flight micro-batches.
                    # None = not pipelined. (The "pipeline" key above
                    # is the serving DATA plane's staged-thread flag —
                    # an older, unrelated surface.)
                    "pipeline_parallel": self._model_pipeline(),
                    # the LIVE tail-capture threshold (adaptive
                    # refreshes move it; fixed config pins it)
                    "slow_trace_ms":
                        self.tracer.threshold(self.api_path),
                    "adaptive_slow_trace": self.adaptive is not None,
                    # the dispatch-wait policy: "fixed" = the constant
                    # max_latency_ms knob; "adaptive" learns the wait
                    # per batch (rate + per-bucket latency — A/B
                    # selectable, docs/serving.md "Adaptive batching")
                    "batch_policy": self.batch_policy,
                    "adaptive_batch": (self.adaptive_batcher.status()
                                       if self.adaptive_batcher
                                       is not None else None),
                    # the socket edge: keep-alive reuse rate, open
                    # connections, accept-loop saturation (eventloop);
                    # the threaded plane reports only its kind
                    "frontend": (self._frontend.stats()
                                 if self._frontend is not None
                                 else {"kind": "threaded"}),
                    # traffic capture (when opted in): journal rows,
                    # drop counts, live segment inventory
                    "capture": (self.capture.status()
                                if self.capture is not None else None),
                    # process vitals: chaos drills diff these across
                    # kill/restart cycles — uptime proves the restart,
                    # RSS spots the leak
                    "uptime_s": round(process_uptime_s(), 3),
                    "rss_bytes": process_rss_bytes(),
                    # per-tenant admission ledger: quotas, in-flight,
                    # shed counts by reason, tokens — None when the
                    # server runs without a tenant registry
                    "tenancy": (self.tenancy.stats()
                                if self.tenancy is not None else None),
                    # build identity (echoes serving_build_info's
                    # labels): version, torch/cuda, device kind,
                    # frontend — what a fleet diff pins a worker to
                    "build": self.build,
                    # SLO engine surface WITHOUT forcing an evaluation
                    # (GET /slo runs one); None when disabled
                    "slo": (self.slo.status()
                            if self.slo is not None else None),
                    # the retrospective plane: recorder cadence/budget,
                    # store size per tier, anomaly detector state; None
                    # when the TSDB is disabled
                    "tsdb": (self.recorder.status()
                             if self.recorder is not None else None),
                    # device observability: profiler window state, the
                    # bounded compile-event ledger, per-bucket MFU,
                    # and HBM live/peak/limit bytes
                    "profiling": {
                        "profiler": self.profiler.status(),
                        "compile_events": self.compile_ledger.snapshot(),
                        "mfu": self.mfu.snapshot(),
                        "hbm": device_memory_stats(),
                    },
                    # the postmortem plane: sampling-profiler ring
                    # health, incident-capture counters, log-ring
                    # fill — docs/observability.md "The postmortem
                    # plane"
                    "postmortem": {
                        "cpu_profiler": (self.cpu_profiler.status()
                                         if self.cpu_profiler
                                         is not None else None),
                        "incidents": (self.incidents.status()
                                      if self.incidents is not None
                                      else None),
                        "log_ring": self.log_ring.status(),
                    },
                }
            return 200, json.dumps(stats).encode(), "application/json", ()
        if base == "/traces":
            # the tail-capture store: every retained trace was slow or
            # ended non-ok; ?slow=1 keeps only the threshold-retained
            # ones. Slowest first (root duration descending), so the
            # capture an operator wants tops the list without fetching
            # every tree
            items = self.tracer.traces(slow_only="slow=1" in path)
            items.sort(key=lambda t: -t["duration_ms"])
            return 200, json.dumps(items).encode(), "application/json", ()
        if path.startswith("/trace/"):
            tid, _, query = path[len("/trace/"):].partition("?")
            tr = self.tracer.get_trace(tid)
            if tr is None:
                return (404, json.dumps(
                    {"error": "trace not retained (fast + ok traces "
                              "are tail-dropped)",
                     "trace_id": tid}).encode(), "application/json", ())
            if "format=raw" in query:
                # the stored capture verbatim (flat span list +
                # origin_unix anchor): what the coordinator's
                # distributed merge consumes
                body = json.dumps(tr).encode()
            elif "format=perfetto" in query:
                # Chrome trace_event JSON: load the body in
                # chrome://tracing or ui.perfetto.dev (see
                # tools/trace_dump.py)
                body = json.dumps(to_perfetto(tr)).encode()
            else:
                out = {k: tr[k] for k in
                       ("trace_id", "root", "route", "duration_ms",
                        "status", "reason", "captured_at", "n_spans")}
                out["tree"] = span_tree(tr)
                body = json.dumps(out).encode()
            return 200, body, "application/json", ()
        if path == "/version":
            # the rollout state machine: active/staged/previous version
            # lifecycle, shadow-traffic stats, flip/rollback counters
            return (200, json.dumps(self.versions.status()).encode(),
                    "application/json", ())
        if path == "/decode/stats":
            # the continuous-batching plane: slot occupancy, waiting
            # depth, step/token counters, compile count (flat after
            # warmup = zero retraces), and per-slot in-flight progress
            # (the incremental token emission, observable mid-decode)
            if self.decoder is None:
                return (404, b'{"error": "no decode plane configured"}',
                        "application/json", ())
            return (200, json.dumps(self.decoder.stats()).encode(),
                    "application/json", ())
        if path == "/alerts":
            # the SLO engine's compact alert view (state machine +
            # violating window pairs); the GET itself drives an
            # evaluation pass — pull-based, nothing on the hot path.
            # Anomaly-watch states ride along under "anomalies" (their
            # firing count adds into "firing"), so one endpoint answers
            # "is anything wrong" for both alert sources.
            if self.slo is None:
                return (404, b'{"error": "slo engine disabled"}',
                        "application/json", ())
            self.slo.evaluate()
            body = self.slo.alerts()
            if self.anomalies is not None:
                an = self.anomalies.alerts()
                body["anomalies"] = an["alerts"]
                body["firing"] = body.get("firing", 0) + an["firing"]
            return (200, json.dumps(body).encode(),
                    "application/json", ())
        if path == "/slo":
            # the full burn-rate report: every policy's long/short
            # window burns, measured quantiles, and attribution
            if self.slo is None:
                return (404, b'{"error": "slo engine disabled"}',
                        "application/json", ())
            return (200, json.dumps(self.slo.evaluate()).encode(),
                    "application/json", ())
        if base in ("/query", "/query_range"):
            # the retrospective plane's query surface (core/tsdb.py):
            # ?expr=<selector | rate(sel[w]) | increase(sel[w]) |
            # quantile(q, hist[w])> — /query takes ?at=, /query_range
            # takes ?start=&end=&step= (timestamps on the worker's
            # monotonic clock, defaulting to the newest recorded data).
            # Malformed expressions are a 400, never a 500.
            if self.tsdb is None:
                return (404, b'{"error": "tsdb disabled"}',
                        "application/json", ())
            params = _urlparse.parse_qs(
                path.partition("?")[2], keep_blank_values=True)
            expr = (params.get("expr") or [""])[0]
            try:
                if base == "/query":
                    at = params.get("at")
                    body = self.tsdb.query(
                        expr, at=float(at[0]) if at else None)
                else:
                    start = params.get("start")
                    end = params.get("end")
                    step = (params.get("step") or ["10"])[0]
                    body = self.tsdb.query_range(
                        expr,
                        start=float(start[0]) if start else None,
                        end=float(end[0]) if end else None,
                        step=float(step))
            except (QueryError, ValueError) as e:
                return (400, json.dumps({"error": str(e),
                                         "expr": expr}).encode(),
                        "application/json", ())
            return (200, json.dumps(body).encode(),
                    "application/json", ())
        if base == "/profile/cpu":
            # the always-on sampling profiler (core/profiler.py):
            # ?window_s=N aggregates the last N seconds (JSON
            # top-table by default; &format=collapsed for folded
            # flamegraph text, &format=trace for Chrome trace_event
            # JSON); &baseline_s=M returns the differential profile —
            # the last window_s vs the baseline_s before it, frames
            # ranked by how much hotter they got
            if self.cpu_profiler is None:
                return (404, b'{"error": "cpu profiler disabled"}',
                        "application/json", ())
            params = _urlparse.parse_qs(
                path.partition("?")[2], keep_blank_values=True)
            try:
                window_s = float((params.get("window_s") or ["30"])[0])
                baseline = params.get("baseline_s")
                fmt = (params.get("format") or ["json"])[0]
                if baseline:
                    body = self.cpu_profiler.diff(
                        window_s, float(baseline[0]))
                elif fmt == "collapsed":
                    text = self.cpu_profiler.render_collapsed(window_s)
                    return (200, text.encode(),
                            "text/plain; charset=utf-8", ())
                elif fmt == "trace":
                    body = self.cpu_profiler.chrome_trace(window_s)
                else:
                    body = self.cpu_profiler.profile(window_s)
            except ValueError as e:
                return (400, json.dumps({"error": str(e)}).encode(),
                        "application/json", ())
            return (200, json.dumps(body).encode(),
                    "application/json", ())
        if base == "/logs":
            # the bounded in-memory log ring (core/logs.py):
            # ?trace=<id> filters to one request's records (the
            # injected trace field), ?level=<name> floors severity,
            # ?n= keeps the newest N. Same ring the incident bundle
            # snapshots.
            params = _urlparse.parse_qs(
                path.partition("?")[2], keep_blank_values=True)
            trace = (params.get("trace") or [None])[0]
            level = (params.get("level") or [None])[0]
            n = (params.get("n") or [None])[0]
            try:
                limit = int(n) if n else None
            except ValueError:
                return (400, b'{"error": "n must be an integer"}',
                        "application/json", ())
            body = {"status": self.log_ring.status(),
                    "records": self.log_ring.records(
                        trace=trace, level=level, limit=limit)}
            return (200, json.dumps(body).encode(),
                    "application/json", ())
        if base == "/incidents" or base.startswith("/incidents/"):
            # the postmortem bundles (serving/incident.py): list,
            # per-bundle manifest + inventory, and raw artifacts
            # (/incidents/<id>/<file>, whitelisted names only)
            if self.incidents is None:
                return (404, b'{"error": "incident capture disabled '
                        b'(configure incidents=<dir>)"}',
                        "application/json", ())
            if base == "/incidents":
                body = {"incidents": self.incidents.list(),
                        "status": self.incidents.status()}
                return (200, json.dumps(body).encode(),
                        "application/json", ())
            rest = base[len("/incidents/"):]
            inc_id, _, artifact = rest.partition("/")
            if artifact:
                art = self.incidents.artifact(inc_id, artifact)
                if art is None:
                    return (404, json.dumps(
                        {"error": "no such incident artifact",
                         "id": inc_id,
                         "artifact": artifact}).encode(),
                        "application/json", ())
                return 200, art["body"], art["content_type"], ()
            info = self.incidents.get(inc_id)
            if info is None:
                return (404, json.dumps(
                    {"error": "no such incident",
                     "id": inc_id}).encode(), "application/json", ())
            return (200, json.dumps(info).encode(),
                    "application/json", ())
        if path == "/profile":
            # profiler status (busy flag, last capture window); the
            # capture itself is POST /profile
            return (200, json.dumps(self.profiler.status()).encode(),
                    "application/json", ())
        if path != "/status":
            return None
        with self._commit_lock:
            status = {
                "n_requests": self.n_requests,
                "n_batches": self.n_batches,
                "n_errors": self.n_errors,
                "model_version": self.versions.active.version,
                "n_replayed": self.n_replayed,
                "n_journal_evicted": self.n_journal_evicted,
                "n_window_missed": self.n_window_missed,
                "n_shed": self.n_shed,
                "n_deadline_expired": self.n_deadline_expired,
                "queue_depth": self.backlog(),
                "max_queue": self.max_queue,
                "draining": self._draining.is_set(),
                "journal_entries": len(self._journal),
                "journal_size": self.journal_size,
                "journal_ttl": self.journal_ttl,
                "journal_path": self.journal_path,
                "journal_recovered": self.n_journal_recovered,
            }
        return 200, json.dumps(status).encode(), "application/json", ()

    def _incident_stats(self) -> dict:
        """The worker-state snapshot an incident bundle embeds:
        ``/stats`` + ``/decode/stats`` + placement, captured through
        the same route table the frontends serve (one codepath, no
        drift). Runs on the capture thread — never the hot path."""
        out: Dict[str, Any] = {}
        for key, route in (("stats", "/stats"),
                           ("decode_stats", "/decode/stats"),
                           ("status", "/status")):
            try:
                r = self._get_route(route, None)
                if r is not None and r[0] == 200:
                    out[key] = json.loads(r[1])
            except Exception as exc:  # noqa: BLE001 — capture survives
                out[key] = {"error": str(exc)}
        out["placement"] = self._model_placement()
        return out

    def _model_placement(self) -> Optional[dict]:
        """The active model's device placement, when it reports one
        (NNModel.placement / TransformerDecoder.placement) — scrapes
        must never fail on a model without the surface."""
        fn = getattr(self.versions.active.model, "placement", None)
        if fn is None:
            return None
        try:
            return fn()
        except Exception:  # noqa: BLE001 — stats never 500 on a model
            return None

    def _model_pipeline(self) -> Optional[dict]:
        """The active model's pipeline-parallel report (stage
        placement, bubble ratio, in-flight micro-batches) when it has
        one — the ``/stats`` "pipeline_parallel" block."""
        fn = getattr(self.versions.active.model, "pipeline_report", None)
        if fn is None:
            return None
        try:
            return fn()
        except Exception:  # noqa: BLE001 — stats never 500 on a model
            return None

    def _post_route(self, path: str, body: bytes
                    ) -> Optional[Tuple[int, bytes, str]]:
        """The worker's control-plane POST routes (rollout admin),
        shared by both frontends exactly like ``_get_route`` — only
        ``api_path`` itself takes the data-plane admission path.
        Returns ``(status, body, content_type)`` or None for 404."""
        if path == "/profile":
            # on-demand device profiling: open ONE torch.profiler trace
            # window (duration_ms, clamped) on a background thread and
            # 202 immediately with the on-disk log_dir; a second POST
            # while a window runs gets an honest 409, a runtime that
            # cannot profile (no backend support) a 503
            try:
                args = json.loads(body or b"{}")
                if not isinstance(args, dict):
                    raise ValueError("body must be a JSON object")
            except ValueError as e:
                return (400, json.dumps({"error": f"invalid JSON: {e}"}
                                        ).encode(), "application/json")
            duration_ms = args.get("duration_ms", 1000)
            try:
                duration_ms = min(max(float(duration_ms), 50.0),
                                  30000.0)
            except (TypeError, ValueError):
                return (400, b'{"error": "duration_ms must be a '
                             b'number"}', "application/json")
            try:
                info = self.profiler.start_window(
                    duration_s=duration_ms / 1000.0,
                    log_dir=args.get("log_dir"))
            except ProfilerBusy as e:
                return (409, json.dumps(
                    {"error": str(e),
                     "status": self.profiler.status()}).encode(),
                    "application/json")
            except Exception as e:  # noqa: BLE001 — backend can't
                return (503, json.dumps(
                    {"error": f"profiler unavailable: {e}"}).encode(),
                    "application/json")
            return 202, json.dumps(info).encode(), "application/json"
        if not path.startswith("/rollout/"):
            return None
        try:
            args = json.loads(body or b"{}")
            if not isinstance(args, dict):
                raise ValueError("body must be a JSON object")
        except ValueError as e:
            return (400, json.dumps({"error": f"invalid JSON: {e}"}
                                    ).encode(), "application/json")
        try:
            if path == "/rollout/stage":
                if not args.get("path"):
                    return (400, b'{"error": "stage needs a checkpoint '
                                 b'path"}', "application/json")
                if args.get("sync"):
                    # sync staging is Python-API-only: this handler
                    # runs ON the event-loop thread, and inline
                    # digest-hashing + every-bucket warmup of a big
                    # checkpoint would stall every connection on the
                    # loop — the rollout endpoint causing downtime
                    return (400, b'{"error": "staging is asynchronous '
                                 b'over HTTP; poll GET /version until '
                                 b'the staged state settles"}',
                            "application/json")
                try:
                    out = self.versions.stage(
                        source=args["path"],
                        version=args.get("version"),
                        warmup_payload=args.get("warmup_payload"),
                        shadow_fraction=args.get("shadow_fraction"),
                        quantization=args.get("quantization"))
                except ValueError as e:
                    # a malformed quantization config (zero scale,
                    # non-finite zero-point, unknown wire dtype) is a
                    # client error caught at the door — never a staged
                    # version that dispatches garbage
                    return (400, json.dumps(
                        {"error": str(e)}).encode(), "application/json")
                # 202: staging continues in the background — poll
                # GET /version until the staged state settles
                return (202, json.dumps(out).encode(),
                        "application/json")
            if path == "/rollout/flip":
                out = self.versions.flip(version=args.get("version"))
                return 200, json.dumps(out).encode(), "application/json"
            if path == "/rollout/rollback":
                out = self.versions.rollback()
                return 200, json.dumps(out).encode(), "application/json"
            if path == "/rollout/abort":
                out = self.versions.abort()
                return 200, json.dumps(out).encode(), "application/json"
        except RolloutError as e:
            # an illegal transition is a conflict with current state,
            # not a server fault: 409 + the state that refused it
            return (409, json.dumps(
                {"error": str(e),
                 "rollout": self.versions.status()}).encode(),
                "application/json")
        return None

    #: sentinel: the API key was missing/unknown under the "reject"
    #: policy — the frontends answer 401 without touching _admit
    _TENANT_REJECTED = object()
    _UNKNOWN_KEY_BODY = b'{"error": "unknown or missing API key"}'

    def _resolve_tenant(self, headers):
        """Identity at the edge: API key (``X-Api-Key`` /
        ``Authorization: Bearer``) → tenant. ``None`` when tenancy is
        off; :data:`_TENANT_REJECTED` when the registry's policy
        refuses the credential (the caller 401s)."""
        if self.tenancy is None:
            return None
        tenant = self.tenancy.resolve(extract_api_key(headers))
        return tenant if tenant is not None else self._TENANT_REJECTED

    def _decode_retry_after(self) -> float:
        """Honest decode-plane Retry-After: the scheduler's
        slot-release EWMA scaled by the waiting depth, falling back to
        the configured constant while cold/stale."""
        hint = (self.decoder.retry_after_hint()
                if self.decoder is not None else None)
        return hint if hint is not None else self.shed_retry_after

    def _shed_info(self, reason: str, decode: bool,
                   retry_after: Optional[float] = None) -> dict:
        """The 429 detail a shed decision carries back to the
        frontends: reason-specific body plus the most honest
        ``Retry-After`` available — the bucket's refill math for rate
        sheds, the decode slot-release EWMA for decode-plane pressure,
        the configured constant otherwise."""
        if retry_after is None or retry_after <= 0:
            retry_after = (self._decode_retry_after() if decode
                           else self.shed_retry_after)
        body = (b'{"error": "overloaded"}' if reason == "overload"
                else json.dumps({"error": "tenant quota exceeded",
                                 "reason": reason}).encode())
        return {"reason": reason, "body": body,
                "retry_after": round(max(float(retry_after), 1e-3), 3)}

    def _overload_shed(self, tenant, decode: bool) -> bool:
        """The overload verdict for NEW work: the plain full-queue
        check without tenancy; priority-aware (background sheds at the
        high-water mark, batch midway, interactive only when full)
        with it."""
        if tenant is None or self.tenancy is None:
            return (self.decoder.overloaded() if decode
                    else self._overloaded())
        if decode:
            depth, cap = self.decoder.queue_pressure()
        else:
            depth, cap = self.backlog(), self.max_queue
        return self.tenancy.should_shed(tenant, depth, cap)

    def _admit(self, payload: Any, rid: Optional[str],
               deadline: Optional[Deadline], tid: str,
               decode: bool = False, tenant=None
               ) -> Tuple[str, Optional[_PendingRequest],
                          Optional[tuple], bool, Optional[dict]]:
        """Ingress admission, shared by both frontends AND both data
        planes (``decode=True`` sheds on the decode scheduler's
        waiting-queue depth instead of the frame backlog; everything
        else — replay, join, doa — is identical). Returns ``(kind,
        pending, committed_entry, window_missed, shed)`` with kind one
        of:

        * ``"replay"`` — the rid's reply is already committed
          (``committed_entry`` is the journal tuple);
        * ``"join"``   — the rid is in flight: wait on / watch
          ``pending`` without enqueuing a second compute;
        * ``"shed"``   — refused with 429; ``shed`` carries the
          reason-specific body and honest Retry-After;
        * ``"doa"``    — the deadline was spent before admission:
          ``pending`` is already resolved with its 504;
        * ``"enqueue"`` — ``pending`` is fresh; the caller enqueues it
          (:meth:`_enqueue`) and awaits resolution.

        With ``tenant`` set, quota checks run AFTER the replay/join
        short-circuits (a replay returns the journaled reply without
        re-charging the tenant's bucket or in-flight cap — retries of
        answered work are free) and BEFORE the pending is created, so
        every charged admission has exactly one release in the
        resolution funnel."""
        window_missed = False
        if rid:
            with self._commit_lock:
                self._reap_expired_locked()
                committed = self._journal.get(rid)
                pending = (self._inflight.get(rid)
                           if committed is None else None)
                if committed is not None:
                    self.n_replayed += 1
                    if self.tenancy is not None:
                        # replay attribution follows the JOURNALED
                        # owner when the entry carries one (a replay
                        # through a different key still bills the
                        # tenant that paid for the compute)
                        owner = (committed[4] if len(committed) > 4
                                 and committed[4] else
                                 tenant.id if tenant is not None
                                 else None)
                        if owner:
                            self.tenancy.note_replay(owner)
                    return "replay", None, committed, False, None
                if pending is not None:
                    return "join", pending, None, False, None
                if self._overload_shed(tenant, decode):
                    # shedding applies to NEW work only: replays and
                    # in-flight joins above cost no inference and
                    # always succeed
                    self.n_shed += 1
                    if tenant is not None:
                        self.tenancy.note_shed_overload(tenant.id)
                    return ("shed", None, None, False,
                            self._shed_info("overload", decode))
                # request ids are unique per logical request, so a rid
                # in the evicted ring can only be a retry that outlived
                # the replay window — detected, warned, and re-executed
                # (the documented past-window semantics)
                window_missed = rid in self._evicted
                if window_missed:
                    self.n_window_missed += 1
                if tenant is not None:
                    quota = self.tenancy.admit(tenant)
                    if quota is not None:
                        self.n_shed += 1
                        return ("shed", None, None, False,
                                self._shed_info(quota[0], decode,
                                                quota[1]))
                pending = _PendingRequest(payload, rid, deadline,
                                          trace=tid)
                if tenant is not None:
                    pending.tenant = tenant.id
                self._inflight[rid] = pending
            if window_missed:
                logger.warning(
                    "request id %s retried after its journal entry was "
                    "evicted (journal_size=%d, journal_ttl=%s); "
                    "re-executing", rid, self.journal_size,
                    self.journal_ttl)
        else:
            if self._overload_shed(tenant, decode):
                with self._commit_lock:
                    self.n_shed += 1
                if tenant is not None:
                    self.tenancy.note_shed_overload(tenant.id)
                return ("shed", None, None, False,
                        self._shed_info("overload", decode))
            if tenant is not None:
                quota = self.tenancy.admit(tenant)
                if quota is not None:
                    with self._commit_lock:
                        self.n_shed += 1
                    return ("shed", None, None, False,
                            self._shed_info(quota[0], decode,
                                            quota[1]))
            pending = _PendingRequest(payload, deadline=deadline,
                                      trace=tid)
            if tenant is not None:
                pending.tenant = tenant.id
        if deadline is not None and deadline.expired:
            # dead on arrival: the client's budget is already spent —
            # never enqueue work nobody will read. The pending is
            # resolved (status + event) BEFORE it leaves _inflight, so
            # a duplicate that joined it in the window between the two
            # locked sections is released immediately instead of
            # blocking until request_timeout
            pending.status = 504
            pending.reply = b'{"error": "deadline exceeded"}'
            with self._stats_lock:
                self.n_deadline_expired += 1
            with self._commit_lock:
                self._inflight.pop(pending.rid, None)
            self._release(pending)
            return "doa", pending, None, window_missed, None
        return "enqueue", pending, None, window_missed, None

    def _enqueue(self, pending: _PendingRequest, root) -> None:
        """Hand an admitted request to the data plane. The root span
        rides the work item across the stage threads (exactly as the
        trace id does); ``t_enqueue`` anchors the queue_wait child
        span."""
        pending.span = root
        pending.t_enqueue = self.tracer.clock.now()
        if self.adaptive_batcher is not None:
            # one clock read + two float ops: the arrival-rate EWMA
            # the adaptive batch policy decides wait windows from
            self.adaptive_batcher.note_arrival()
        with self._stats_lock:
            self._n_backlog += 1
        self._queue.put(pending)

    def _enqueue_decode(self, pending: _PendingRequest, root,
                        parsed=None) -> Optional[Tuple[int, bytes]]:
        """Hand an admitted request to the decode scheduler. Returns
        ``None`` on success or ``(status, body)`` for a synchronous
        reject (bad payload -> 400, waiting queue full -> 429) — the
        reject path removes the in-flight entry so a retried rid
        re-admits instead of joining a dead pending. ``parsed``
        forwards a streaming pre-check's parse result so the payload
        is validated once."""
        pending.span = root
        pending.t_enqueue = self.tracer.clock.now()
        try:
            self.decoder.submit(pending, parsed=parsed)
            return None
        except DecodeOverloaded:
            with self._commit_lock:
                self._inflight.pop(pending.rid, None)
                self.n_shed += 1
            self._release_tenant(pending)
            return 429, b'{"error": "overloaded"}'
        except ValueError as e:
            with self._commit_lock:
                self._inflight.pop(pending.rid, None)
            self._release_tenant(pending)
            return 400, json.dumps({"error": str(e)}).encode()

    def _release_tenant(self, p: _PendingRequest) -> None:
        """Return ``p``'s tenant in-flight slot (idempotent: the slot
        id is cleared first, so every resolution path may call this
        and the slot still comes back exactly once)."""
        owner, p.tenant = p.tenant, None
        if owner is None or self.tenancy is None:
            return
        self.tenancy.release(owner)
        if self._m_tenant_latency is not None \
                and p.t_enqueue is not None:
            self._m_tenant_latency.labels(
                self.tenancy.label_of(owner)).observe(
                (self.tracer.clock.now() - p.t_enqueue) * 1000.0)

    def _release(self, p: _PendingRequest) -> None:
        """Resolve a pending request: wake any threaded-frontend
        handler blocked on the event AND fire any event-loop completion
        callbacks. A callback registered concurrently with release may
        fire twice (see :meth:`_add_waiter`); the event-loop frontend
        drops the duplicate reply by connection generation."""
        self._release_tenant(p)
        p.event.set()
        for cb in p.callbacks:
            try:
                cb(p)
            except Exception:  # noqa: BLE001 — one bad reply callback
                logger.warning("reply callback failed",  # must never
                               exc_info=True)            # strand others

    def _add_waiter(self, p: _PendingRequest, cb) -> None:
        """Watch a pending request from the event-loop frontend. Append
        -then-check: if release already ran (or runs concurrently and
        misses the append), the is_set check fires the callback here —
        at worst both sides fire it, which the frontend's generation
        guard absorbs."""
        p.callbacks.append(cb)
        if p.event.is_set():
            try:
                cb(p)
            except Exception:  # noqa: BLE001
                logger.warning("reply callback failed", exc_info=True)

    # -- event-loop frontend protocol ----------------------------------------

    def handle_request(self, method: str, path: str, headers,
                       body: bytes, reply) -> bool:
        """The :class:`EventLoopFrontend` application protocol (see
        serving/frontend.py): route one framed request. GET routes
        answer synchronously on the loop thread (they are in-memory
        reads); POST predict replies later, from whichever stage thread
        commits the request — ``reply`` is thread-safe and
        duplicate-proof by design."""
        if method == "GET":
            route = self._get_route(path, headers)
            if route is None:
                return False
            status, rbody, ctype, extra = route
            reply(status, rbody, ctype=ctype, extra=extra)
            return True
        if method != "POST":
            return False
        # decode matches on the BASE path (the ?stream=1 opt-in rides
        # the query string); the frame plane stays an exact match
        is_decode = (self.decoder is not None
                     and path.partition("?")[0] == self.decode_path)
        if path != self.api_path and not is_decode:
            routed = self._post_route(path, body)
            if routed is None:
                return False
            status, rbody, ctype = routed
            reply(status, rbody, ctype=ctype)
            return True
        tid, parent_sid = extract_span_context(headers)
        with trace_context(tid):
            root = self.tracer.start("request", trace_id=tid,
                                     remote_parent=parent_sid,
                                     route=(self.decode_path if is_decode
                                            else self.api_path))
            if capture_hint(headers):
                root.force = True
            status = "error"
            try:
                status = self._predict_eventloop(headers, body, tid,
                                                 root, reply,
                                                 decode=is_decode,
                                                 path=path)
            finally:
                if status is not None:
                    # sync reject paths; async completions finish the
                    # root in their on_done callback instead
                    self.tracer.finish(root, status=status)
        return True

    def _predict_eventloop(self, headers, body: bytes, tid: str,
                           root, reply, decode: bool = False,
                           path: str = ""
                           ) -> Optional[str]:
        """Admission for the event-loop frontend: same decisions as the
        threaded ``_do_predict`` (one ``_admit`` serves both), but the
        enqueue/join paths return None and deliver via callback — no
        thread ever blocks on a pending request."""
        if self._draining.is_set():
            # graceful drain: accepted work finishes, new work is
            # refused so the orchestrator's retry lands on a live worker
            reply(503, b'{"error": "draining"}',
                  extra=((TRACE_HEADER, tid),
                         ("Retry-After", str(self.shed_retry_after))))
            return "shed"
        try:
            payload = json.loads(body or b"{}")
        except ValueError:
            # even a rejected request must echo its trace id, or the
            # client cannot correlate the failure with worker logs
            reply(400, b'{"error": "invalid JSON"}',
                  extra=((TRACE_HEADER, tid),))
            return "error"
        deadline = Deadline.from_headers(headers, clock=self.clock)
        rid = headers.get("X-Request-Id")
        tenant = self._resolve_tenant(headers)
        if tenant is self._TENANT_REJECTED:
            reply(401, self._UNKNOWN_KEY_BODY,
                  extra=((TRACE_HEADER, tid),))
            return "error"
        if tenant is not None:
            root.set_attr("tenant", tenant.id)
        kind, pending, committed, window_missed, shed = \
            self._admit(payload, rid, deadline, tid, decode=decode,
                        tenant=tenant)
        if rid:
            root.set_attr("rid", rid)
        if kind == "replay":
            root.set_attr("replayed", True)
            reply(committed[0], committed[1],
                  extra=((TRACE_HEADER, tid), ("X-Replayed", "1")))
            return "ok"
        if kind == "shed":
            reply(429, shed["body"],
                  extra=((TRACE_HEADER, tid),
                         ("Retry-After", str(shed["retry_after"]))))
            return "shed"
        if kind == "doa":
            reply(504, pending.reply, extra=((TRACE_HEADER, tid),))
            return "deadline"

        tracer = self.tracer
        joined = kind == "join"

        def on_done(p: _PendingRequest) -> None:
            extra = [(TRACE_HEADER, tid)]
            # a joined duplicate is only "replayed" if the reply was
            # actually committed — errors are never journaled, so they
            # must not carry the committed-replay marker
            if joined and p.status == 200:
                extra.append(("X-Replayed", "1"))
            if window_missed:
                extra.append(("X-Replay-Window-Missed", "1"))
            reply(p.status, p.reply or b"{}", extra=tuple(extra))
            # the root finishes HERE, with the commit-time status: if
            # the frontend's request-timeout sweep already 504ed the
            # connection, this reply is dropped by generation but the
            # trace still records what actually happened. (A request
            # whose reply never comes at all leaves its root
            # unfinished — the threaded frontend remains the plane
            # that tail-captures true stuck-batch timeouts.)
            tracer.finish(root, status="ok" if p.status == 200 else
                          "deadline" if p.status == 504 else "error")

        if joined:
            self._add_waiter(pending, on_done)
        elif decode:
            stream = parsed = None
            want_stream = _stream_requested(path, payload)
            if want_stream:
                # pre-validate so sync rejects (400/429) stay plain
                # replies — once the chunked 200 head is on the wire
                # there is no taking it back; the parse result is
                # forwarded to submit so the payload is checked once
                try:
                    parsed = self.decoder.parse(payload)
                except ValueError as e:
                    with self._commit_lock:
                        self._inflight.pop(pending.rid, None)
                    self._release_tenant(pending)
                    reply(400, json.dumps({"error": str(e)}).encode(),
                          extra=((TRACE_HEADER, tid),))
                    return "error"
                stream = reply.begin_stream(
                    extra=((TRACE_HEADER, tid),))
                # the stream is attached BEFORE submit so the very
                # first token already flows through it; None means
                # the connection died between framing and now
                pending.stream = stream
            err = self._enqueue_decode(pending, root, parsed=parsed)
            if err is not None:
                pending.stream = None
                e_status, e_body = err
                if stream is not None:
                    # headers are out: deliver the reject as the one
                    # and only SSE event (racy overload/parse change)
                    stream.finish(b"data: " + e_body + b"\n\n")
                    return "shed" if e_status == 429 else "error"
                extra = [(TRACE_HEADER, tid)]
                if e_status == 429:
                    extra.append(("Retry-After",
                                  str(self._decode_retry_after())))
                reply(e_status, e_body, extra=tuple(extra))
                return "shed" if e_status == 429 else "error"
            if stream is not None:
                # the stream delivers the body; the waiter only
                # finishes the root span at commit
                tracer2 = self.tracer

                def on_stream_done(p: _PendingRequest) -> None:
                    tracer2.finish(
                        root, status="ok" if p.status == 200 else
                        "deadline" if p.status == 504 else "error")

                self._add_waiter(pending, on_stream_done)
                return None
            self._add_waiter(pending, on_done)
        else:
            self._enqueue(pending, root)
            self._add_waiter(pending, on_done)
        return None

    # -- batching loop -------------------------------------------------------

    def backlog(self) -> int:
        """Requests accepted but not yet dispatched into the model."""
        with self._stats_lock:
            return self._n_backlog

    def _overloaded(self) -> bool:
        return self.max_queue > 0 and self.backlog() >= self.max_queue

    def _collect_batch(self) -> List[_PendingRequest]:
        if self.tenancy is not None and self.tenancy.fair_share:
            return self._collect_batch_fair()
        try:
            first = self._queue.get(timeout=0.05)
        except Empty:
            return []
        # the "collect" span starts at the FIRST request, so /stats
        # reports the batch-mate gathering window (real latency cost),
        # not the idle 0.05s polls of an unloaded server
        with self.timings.span("collect"):
            return self._collect_rest(first)

    # -- fair-share batch assembly (tenancy + fair_share on) ----------------
    #
    # The ingress SimpleQueue stays the handoff (frontend threads only
    # ever put); the collector drains it into per-tenant FIFO deques
    # and pops in deficit-weighted round-robin order, so one tenant's
    # burst can reorder only its OWN requests — a 10:1 flood fills at
    # most its fair share of every batch once another tenant is
    # waiting. All of this is collector-thread-local state: no lock,
    # no hot-path cost for the ingress threads, and the batch still
    # pads to the same shape buckets (fairness reorders rows, never
    # reshapes the dispatch).

    def _fair_push(self, p: _PendingRequest) -> None:
        tid_t = p.tenant or ANONYMOUS_ID
        self._fair_q.setdefault(tid_t, deque()).append(p)
        self._fair_total += 1

    def _fair_drain_ingress(self) -> None:
        try:
            while True:
                self._fair_push(self._queue.get_nowait())
        except Empty:
            pass

    def _fair_pop(self) -> Optional[_PendingRequest]:
        present = {t: self.tenancy.weight_of(t)
                   for t, dq in self._fair_q.items() if dq}
        if not present:
            return None
        t = self._fair_cycle.choose(present)
        dq = self._fair_q[t]
        p = dq.popleft()
        if not dq:
            del self._fair_q[t]
        self._fair_total -= 1
        return p

    def _collect_batch_fair(self) -> List[_PendingRequest]:
        self._fair_drain_ingress()
        if self._fair_total == 0:
            try:
                self._fair_push(self._queue.get(timeout=0.05))
            except Empty:
                return []
            self._fair_drain_ingress()
        with self.timings.span("collect"):
            return self._collect_rest_fair()

    def _collect_rest_fair(self) -> List[_PendingRequest]:
        batch = [self._fair_pop()]
        limit = min(self.max_batch_size, self._bucket_sizes()[-1])
        window_ms = self.max_latency_ms
        if self.adaptive_batcher is not None:
            decided = self.adaptive_batcher.decide_wait_ms(
                1 + self._fair_total + self._queue.qsize())
            if decided is not None:
                window_ms = decided
        deadline = time.monotonic() + max(window_ms, 0.0) / 1000.0
        while len(batch) < limit:
            p = self._fair_pop()
            if p is not None:
                batch.append(p)
                continue
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                self._fair_push(self._queue.get(timeout=remaining))
            except Empty:
                break
            self._fair_drain_ingress()
        return batch

    def _collect_rest(self, first: _PendingRequest
                      ) -> List[_PendingRequest]:
        batch = [first]
        # the collection ceiling is the LADDER's top bucket, not the
        # raw max_batch_size: with a batch multiple that does not
        # divide the cap (100-row budget over 8 shards -> top bucket
        # 96), collecting past the top would force a bucket beyond the
        # operator's ceiling
        limit = min(self.max_batch_size, self._bucket_sizes()[-1])
        window_ms = self.max_latency_ms
        if self.adaptive_batcher is not None:
            # the adaptive policy picks THIS batch's wait from the
            # live arrival rate + per-bucket dispatch latencies (None
            # while warming up -> the fixed knob keeps ruling; the
            # fixed knob is also the policy's hard ceiling)
            decided = self.adaptive_batcher.decide_wait_ms(
                1 + self._queue.qsize())
            if decided is not None:
                window_ms = decided
        if window_ms <= 0:
            # latency-first mode: take whatever is already queued and
            # serve immediately — no added wait for batch-mates
            while len(batch) < limit:
                try:
                    batch.append(self._queue.get_nowait())
                except Empty:
                    break
            return batch
        deadline = time.monotonic() + window_ms / 1000.0
        while len(batch) < limit:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                batch.append(self._queue.get(timeout=remaining))
            except Empty:
                break
        return batch

    def _expire(self, p: _PendingRequest, where: str) -> None:
        """504 a request whose deadline passed; never journaled (status
        != 200), so a fresh-budget retry re-executes for real."""
        p.status = 504
        p.reply = json.dumps(
            {"error": f"deadline exceeded {where}"}).encode()
        # under the stats lock: _expire now runs concurrently from the
        # collector, executor, AND encoder-pool threads
        with self._stats_lock:
            self.n_deadline_expired += 1
        self._commit(p)

    # -- data plane stages ---------------------------------------------------
    #
    # Each batch travels through three stage functions; the pipelined
    # plane runs them on separate threads (collector -> executor ->
    # encoder pool), the serial plane (pipeline=False) runs them inline.
    # A batch is a "job" dict: {"batch_n": total collected, "live":
    # not-yet-expired requests, "df": the (bucket-padded) frame,
    # "n_live": true row count, "out": model output, "error": the
    # failure that 500s the batch}.

    def _filter_expired(self, requests: List[_PendingRequest]
                        ) -> List[_PendingRequest]:
        """Deadline check #1: 504 the expired, return the survivors."""
        live = []
        for p in requests:
            if p.deadline is not None and p.deadline.expired:
                self._expire(p, "before dispatch")
            else:
                live.append(p)
        return live

    def _add_spans(self, requests: List[_PendingRequest], name: str,
                   t0: float, t1: float, status: str = "ok",
                   **attrs) -> None:
        """Record one batch-level measurement as a child span of every
        traced request's root: the batch does the work once, but each
        request's trace must show its own full timeline. Synthetic
        warmup requests carry no root span and record nothing."""
        for p in requests:
            if p.span is not None:
                self.tracer.add(name, t0, t1, parent=p.span,
                                status=status, **attrs)

    def _refresh_live(self, job: dict,
                      requests: List[_PendingRequest]) -> dict:
        """Deadline check #1 over ``requests`` + (re)assembly of the
        job's frame — the shared body of _stage_prepare and the
        dispatch-time re-check."""
        live = self._filter_expired(requests)
        job["live"], job["n_live"] = live, len(live)
        job["df"] = None
        if live:
            t0 = self.tracer.clock.now()
            try:
                # remember which wire config assembled this frame: the
                # dispatch stage compares it against ITS version
                # snapshot and re-assembles on mismatch (a flip landing
                # in the assemble->dispatch window)
                job["wire_qc"] = self.versions.active.quantization
                with self.timings.span("assemble"):
                    job["df"] = self._assemble_frame(
                        live, qc=job["wire_qc"])
            except Exception as e:  # noqa: BLE001 — bad payloads -> 500s
                job["error"] = e
            self._add_spans(live, "assemble", t0, self.tracer.clock.now(),
                            status="ok" if job["error"] is None
                            else "error")
        return job

    def _stage_prepare(self, batch: List[_PendingRequest]) -> dict:
        """Stage 1 (collector): deadline check #1 — before dispatch: a
        request whose budget expired while queued must not occupy a
        batch slot or run through the model at all — then columnar
        frame assembly + shape-bucket padding."""
        # queue_wait: enqueue -> the moment the collector owns the
        # batch; recorded for EVERY collected request (the expired ones
        # below waited too — that wait is usually why they expired)
        now = self.tracer.clock.now()
        for p in batch:
            if p.span is not None and p.t_enqueue is not None:
                self.tracer.add("queue_wait", p.t_enqueue, now,
                                parent=p.span)
        job = {"batch_n": len(batch), "live": [], "n_live": 0,
               "df": None, "out": None, "error": None, "version": None,
               "wire_qc": None}
        return self._refresh_live(job, batch)

    #: sentinel: "use the active version's quantization config"
    _ACTIVE_QC = object()

    def _assemble_frame(self, live: List[_PendingRequest],
                        qc=_ACTIVE_QC) -> DataFrame:
        """Payloads -> columnar frame, padded up to the shared bucket.

        ``DataFrame.from_rows`` builds one list per column straight off
        the payload dicts (heterogeneous key sets raise -> batch 500,
        the framework-wide row-assembly policy). With ``bucket_batches`` every
        column is edge-padded (repeat last row: valid for object/string
        columns) to the power-of-two bucket, so any live batch size maps
        onto a bounded set of dispatch shapes.

        ``qc`` is the wire config the frame is cast for (default: the
        active version's): the quantized wire starts HERE — columns
        drop to the wire dtype before bucket padding (edge-padding
        1-byte rows, not the 8-byte int64 ``from_rows`` produced) and
        before the device upload. Staged-version warmup passes its own
        config, and the dispatch stage re-assembles from the RAW
        payloads when a flip changed the config mid-window (casting is
        lossy, so a cast frame cannot be re-cast for a different
        plane).
        """
        payloads = [p.payload if isinstance(p.payload, dict)
                    else {"value": p.payload} for p in live]
        df = DataFrame.from_rows(payloads)
        if qc is self._ACTIVE_QC:
            qc = self.versions.active.quantization
        if qc is not None and df.columns:
            df = qc.quantize_frame(df)
        if self.bucket_batches and df.columns:
            # TP-aware ladder: buckets are rounded up to the model's
            # batch multiple HERE, once, so data/tensor-sharded
            # dispatch (dist.put_batch / batch_sharding) never re-pads
            mult = self._batch_multiple()
            df = DataFrame({
                n: padded_device_batch(df[n], self.max_batch_size,
                                       bucket=True, pad_mode="edge",
                                       multiple=mult)[0]
                for n in df.columns})
        return df

    @staticmethod
    def _shape_key(df: DataFrame):
        """The dispatch-shape identity: row count + column schema —
        exactly what forces a retrace in any jitted model."""
        return (df.num_rows, tuple(sorted(df.schema().items())))

    def _batch_multiple(self, model=None) -> int:
        """A model's batch divisibility constraint (the mesh data-axis
        size for TP/data-sharded models; 1 for everything else) — the
        ACTIVE model's by default, read per call so a flip to a
        differently-sharded version moves the ladder with it."""
        if model is None:
            model = self.versions.active.model
        return max(int(getattr(model, "batch_multiple", 1) or 1), 1)

    def _bucket_sizes(self, model=None) -> List[int]:
        """Every reachable shape bucket: the pow2 ladder clamped at
        max_batch_size, rounded up to the model's batch multiple
        (the active model's by default; staged-version warmup passes
        the STAGED model, whose sharding may differ — it must warm the
        ladder live traffic will dispatch AFTER the flip, or the flip
        retraces)."""
        return bucket_ladder(self.max_batch_size,
                             multiple=self._batch_multiple(model))

    def _warmup_frame(self, payload: Any, n: int,
                      qc=_ACTIVE_QC) -> DataFrame:
        """One synthetic bucket-shaped frame, built exactly like live
        traffic's (payload -> rows -> wire cast -> bucket padding), so
        a model warmed on it compiles the very executables live
        dispatch uses. ``qc`` overrides the wire config (staged-
        version warmup: the STAGED plane's dtypes, not the active
        one's)."""
        return self._assemble_frame(
            [_PendingRequest(payload) for _ in range(n)], qc=qc)

    def _stage_dispatch(self, job: dict) -> dict:
        """Stage 2 (executor): push the bucketed frame through the
        model. New dispatch shapes are counted as recompiles (any jitted
        model retraces exactly when the input shape set grows)."""
        with self._stats_lock:
            self._n_backlog -= job["batch_n"]
        # deadline check #1 runs twice on the pipelined plane: once at
        # collection (cheap early filter, saves the assembly) and again
        # HERE, at true dispatch time — a request can expire while its
        # batch waits behind a slow model, and it must still never reach
        # the model. Only the (rare) expiry case pays a re-assembly.
        if job["error"] is None and any(
                p.deadline is not None and p.deadline.expired
                for p in job["live"]):
            self._refresh_live(job, job["live"])
        df = job["df"]
        if job["error"] is None and df is not None:
            # ONE snapshot of the active version per batch: the rollout
            # flip is a reference assignment, so this batch dispatches,
            # labels, and counts wholly on the version it read here —
            # a flip landing mid-batch affects only the NEXT batch
            mv = self.versions.active
            job["version"] = mv.version
            t0 = self.tracer.clock.now()
            qc = mv.quantization
            new_shape = False
            try:
                if job.get("wire_qc", qc) != qc:
                    # a flip changed the wire contract between assemble
                    # and dispatch (rare — the window is one pipeline
                    # handoff): the cast is lossy, so re-assemble from
                    # the RAW payloads for THIS version's plane rather
                    # than mis-feeding frames cast for the old one
                    df = self._assemble_frame(job["live"], qc=qc)
                    job["df"], job["wire_qc"] = df, qc
                key = self._shape_key(df)
                # bytes-on-wire evidence, by column dtype: what this
                # dispatch actually moves host->device (u8 rows are 4x
                # smaller than the f32 plane's)
                wire: Dict[str, int] = {}
                for c in df.columns:
                    a = df[c]
                    if a.dtype != np.dtype("O"):
                        name = a.dtype.name
                        wire[name] = wire.get(name, 0) + int(a.nbytes)
                for name, nb in wire.items():
                    self._m_wire_bytes.labels(name).inc(nb)
                with self._stats_lock:
                    new_shape = key not in self._shapes_seen
                    if new_shape:
                        self.n_recompiles += 1
                        # bounded: adversarial/heterogeneous schemas
                        # (a new field name per request) must not grow
                        # a long-lived worker's memory without limit —
                        # past the cap, new shapes still count as
                        # recompiles but are no longer remembered
                        if len(self._shapes_seen) < _MAX_SHAPES_TRACKED:
                            self._shapes_seen.add(key)
                # per-version shape bookkeeping: a shape first reaching
                # the live path after this version flipped is a
                # post-flip recompile (/version, model_swap_v1 gate)
                mv.record_shape(key)
                # batch-representative trace AND span (the first live
                # request's): contextvars do not follow the thread
                # handoff, so the executor re-binds here — model-
                # internal logs, pipeline-stage spans, and any io/http
                # egress the model performs nest under that request's
                # root (and the dispatch histogram's exemplar picks up
                # its trace id). Per-request exact ids ride the journal
                # lines; per-request dispatch child spans are recorded
                # for every live root below.
                t_d0 = self.tracer.clock.now()
                with trace_context(job["live"][0].trace), \
                        self.tracer.bind(job["live"][0].span), \
                        self.timings.span("dispatch"), \
                        self._m_dispatch.labels(df.num_rows).time():
                    out = mv.model.transform(df)
                seconds = self.tracer.clock.now() - t_d0
                if new_shape:
                    # a retrace happened inside that dispatch: ledger
                    # it (bounded ring — /stats "compile_events" and
                    # the span's compiled=true attribute)
                    self.compile_ledger.note(
                        "dispatch", shape=str(key),
                        duration_ms=seconds * 1000.0,
                        bucket=df.num_rows, model_version=mv.version)
                # always-on compute accounting: wall-clock per bucket,
                # MFU when the model reports flops for the shape
                self.mfu.note(df.num_rows, seconds,
                              flops=self._flops_for(mv, df, key))
                self._charge_tenant_device(job["live"],
                                           seconds * 1000.0)
                # df.num_rows < n_live only for degenerate frames (e.g.
                # empty-object payloads -> a zero-column frame): still a
                # row-count error, never a silent short batch
                if out.num_rows != df.num_rows \
                        or df.num_rows < job["n_live"]:
                    raise RuntimeError(
                        f"model returned {out.num_rows} rows for a "
                        f"{df.num_rows}-row dispatch ({job['n_live']} live "
                        f"requests); serving models must preserve row "
                        f"count")
                job["out"] = out
                # shadow traffic: mirror this batch to the staged
                # version (sampled, queued, never blocking) — outputs
                # are compared off the client path
                self.versions.maybe_shadow(df, out)
            except Exception as e:  # noqa: BLE001 — model failure -> 500s
                job["error"] = e
            span_attrs = {"bucket": df.num_rows,
                          "model_version": mv.version}
            if new_shape:
                # a captured slow dispatch that compiled says so —
                # first-shape latency is expected, not a regression
                span_attrs["compiled"] = True
            if qc is not None:
                # a captured slow dispatch says which wire it rode
                span_attrs["wire_dtype"] = qc.wire_dtype
            # tensor-parallel dispatch carries its placement on the
            # span (a cheap precomputed label like "data=4,model=2"),
            # so a captured slow dispatch says where it ran
            pl = getattr(mv.model, "placement_label", None)
            if pl:
                span_attrs["placement"] = pl
            self._add_spans(
                job["live"], "dispatch", t0, self.tracer.clock.now(),
                status="ok" if job["error"] is None else "error",
                **span_attrs)
        return job

    def _flops_for(self, mv, df, key) -> Optional[float]:
        """Per-shape flops for the MFU meter, memoized per (version,
        shape key): a model may expose ``dispatch_flops(df)`` (exact
        count) or ``cost_analysis(df)`` (a compiler's estimate, a dict
        with "flops"). Models with neither cost one attribute
        probe per shape and meter wall-clock only."""
        ck = (mv.version, key)
        if ck in self._flops_cache:
            return self._flops_cache[ck]
        flops = None
        for attr in ("dispatch_flops", "cost_analysis"):
            fn = getattr(mv.model, attr, None)
            if fn is None:
                continue
            try:
                val = fn(df)
                if attr == "cost_analysis":
                    val = (val or {}).get("flops")
                if val:
                    flops = float(val)
                    break
            except Exception:  # noqa: BLE001 — accounting is optional
                pass
        # bounded exactly like _shapes_seen: adversarial schemas must
        # not grow the memo without limit
        if len(self._flops_cache) < _MAX_SHAPES_TRACKED:
            self._flops_cache[ck] = flops
        return flops

    def _encode_replies(self, out: DataFrame, in_cols: List[str],
                        n_live: int) -> List[bytes]:
        """Unpad, select reply columns, JSON-encode. Scalar (1-D
        numeric/bool) reply columns take the columnar fast path: one
        ``tolist`` per column, plain-python dict per row — no per-row
        numpy-scalar round trip."""
        cols = self.reply_cols or \
            [c for c in out.columns if c not in in_cols]
        sub = out.select(cols)       # raises on missing reply_cols
        if not cols:
            return [b"{}"] * n_live
        arrays = [sub[c] for c in cols]
        if all(a.ndim == 1 and a.dtype.kind in "fiub" for a in arrays):
            lists = [a[:n_live].tolist() for a in arrays]
            return [json.dumps(dict(zip(cols, vals))).encode()
                    for vals in zip(*lists)]
        replies = []
        for i in range(n_live):
            row = {c: a[i] for c, a in zip(cols, arrays)}
            replies.append(json.dumps(_jsonify(row)).encode())
        return replies

    def _stage_finish(self, job: dict) -> None:
        """Stage 3 (encoder): encode replies, deadline check #2, commit."""
        live = job["live"]
        with self._stats_lock:
            self.n_batches += 1
            self.n_requests += job["batch_n"]
        # adaptive-threshold upkeep rides the encoder stage — off the
        # request path; one int bump per batch, a histogram walk every
        # refresh_every-th batch (same cadence for the batch policy's
        # service-time table)
        if self.adaptive is not None:
            self.adaptive.tick()
        if self.adaptive_batcher is not None:
            self.adaptive_batcher.tick()
        if not live:
            return
        replies = None
        if job["error"] is None:
            t0 = self.tracer.clock.now()
            try:
                with trace_context(live[0].trace), \
                        self.tracer.bind(live[0].span), \
                        self.timings.span("encode"):
                    replies = self._encode_replies(
                        job["out"], job["df"].columns, job["n_live"])
            except Exception as e:  # noqa: BLE001 — encode failure -> 500s
                job["error"] = e
            self._add_spans(live, "encode", t0, self.tracer.clock.now(),
                            status="ok" if job["error"] is None
                            else "error")
        version = job["version"] or self.versions.active.version
        if job["error"] is not None:
            err = json.dumps({"error": str(job["error"])}).encode()
            with self._stats_lock:
                self.n_errors += len(live)
            for p in live:
                p.status = 500
                p.reply = err
            self.versions.count_committed(version, len(live))
            self._commit_many(live)
            return
        to_commit = []
        for p, r in zip(live, replies):
            # deadline check #2 — before commit: the client is already
            # gone, so the reply must not be journaled as a committed
            # (replayable) result
            if p.deadline is not None and p.deadline.expired:
                self._expire(p, "before commit")
                continue
            p.reply = r
            to_commit.append(p)
        self.versions.count_committed(version, len(to_commit))
        self._commit_many(to_commit)
        # capture AFTER commit: only committed (journal-visible)
        # request/reply rows feed the retrain loop; offer never blocks.
        # Synthetic warmup batches are excluded — "nothing is
        # journaled" for them (see warmup()) covers the capture
        # journal too, or every worker restart/rollout would feed one
        # ladder of fabricated operator-payload rows into retraining
        if self.capture is not None and to_commit \
                and not self._in_warmup:
            self.capture.offer(version, to_commit)

    def _serve_batch(self, batch: List[_PendingRequest]) -> None:
        """The serial plane: all three stages inline (pipeline=False;
        also the semantic reference the pipelined plane must match)."""
        self._stage_finish(self._stage_dispatch(self._stage_prepare(batch)))

    def warmup(self, payload: Any,
               sizes: Optional[List[int]] = None) -> List[int]:
        """Dispatch one synthetic batch per shape bucket, serially, in
        the calling thread — after this, steady-state traffic with the
        same payload schema never grows the compiled-shape set (the
        ``n_recompiles`` counter in ``GET /stats`` stays flat).

        Call it before exposing the worker to traffic — ideally before
        ``start()`` (the listen socket is bound at construction, so
        early connections just queue in the accept backlog): every jit
        executable then exists before the first real request pays a
        compile, and the model never runs concurrently with a live
        dispatch. Synthetic requests carry no client request id, so
        nothing is journaled; they do count in
        ``n_batches``/``n_requests`` (they really ran the model).
        Returns the dispatched batch sizes.
        """
        # remember the payload: staged rollout versions warm every
        # bucket with the same schema before they become flip-eligible
        self.warmup_payload = payload
        if sizes is None:
            # one batch per reachable bucket: the pow2 ladder clamped at
            # max_batch_size (buckets never exceed the cap)
            sizes = self._bucket_sizes()
        self._in_warmup = True
        try:
            for n in sizes:
                batch = [_PendingRequest(payload) for _ in range(n)]
                # the dispatch stage debits the backlog; synthetic
                # requests never passed the ingress credit, so balance
                # it here
                with self._stats_lock:
                    self._n_backlog += len(batch)
                self._serve_batch(batch)
        finally:
            self._in_warmup = False
        return list(sizes)

    def _evict_locked(self, rid: str) -> None:
        # remember the id (not the reply) so a past-window retry is
        # detectable; ids are ~64 bytes vs whole reply bodies, so the
        # ring can be much deeper than the journal. pop-then-insert so a
        # re-evicted id restarts its ring lifetime at the tail
        self._evicted.pop(rid, None)
        self._evicted[rid] = None
        self.n_journal_evicted += 1
        while len(self._evicted) > 16 * self.journal_size:
            self._evicted.popitem(last=False)

    def _reap_expired_locked(self) -> None:
        if self.journal_ttl is None:
            return
        horizon = time.monotonic() - self.journal_ttl
        while self._journal:
            rid, entry = next(iter(self._journal.items()))
            if entry[2] >= horizon:
                break
            self._journal.popitem(last=False)
            self._evict_locked(rid)

    def _recover_journal(self) -> None:
        """Replay the durable journal file into the in-memory window,
        then compact it (rewrite only the surviving entries)."""
        from mmlspark_tpu_torch.io import fs as _fs
        now_wall, now_mono = time.time(), time.monotonic()
        if _fs.exists(self.journal_path):
            for line in _fs.read_text(self.journal_path).splitlines():
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                    rid, status = rec["rid"], int(rec["status"])
                    reply, t_wall = rec["reply"].encode(), float(rec["t"])
                except (ValueError, KeyError):
                    continue                      # torn tail write
                age = max(now_wall - t_wall, 0.0)
                if self.journal_ttl is not None and age > self.journal_ttl:
                    continue
                self._journal.pop(rid, None)      # newest record wins
                self._journal[rid] = (status, reply, now_mono - age,
                                      str(rec.get("trace", "")),
                                      str(rec.get("tenant", "")))
            while len(self._journal) > self.journal_size:
                self._journal.popitem(last=False)
            self.n_journal_recovered = len(self._journal)
        parent = os.path.dirname(self.journal_path)
        if parent:
            _fs.makedirs(parent)
        self._compact_journal()

    @staticmethod
    def _journal_line(rid, entry, t_wall) -> str:
        # the trace id rides every journal line, so a committed reply
        # correlates with its ingress/dispatch/egress log records even
        # after a restart replays the file; the tenant id rides along
        # so a replay across a restart still bills the owner
        return json.dumps({"rid": rid, "status": entry[0],
                           "reply": entry[1].decode(),
                           "t": round(t_wall, 3),
                           "trace": entry[3] if len(entry) > 3 else "",
                           "tenant": entry[4] if len(entry) > 4 else ""
                           }) + "\n"

    def _compact_journal(self) -> None:
        """Rewrite the file to exactly the live in-memory window and
        reopen the append handle. Runs at construction and (from the
        writer thread) whenever the append-only file outgrows the window
        by 4x — the file stays O(journal_size) however long the worker
        lives, and the next restart's replay stays O(window), not
        O(requests-ever). Only the in-memory snapshot is taken under the
        commit lock; the file rewrite happens outside it.

        The queue is DISCARDED under the same lock that snapshots the
        window (r5 advisor): commits enqueue their line while holding
        the commit lock *after* inserting into ``_journal``, so at
        snapshot time every queued line's rid is already in the
        snapshot (or evicted from it) — the rewrite supersedes them
        all. Without the drain those lines would be re-appended after
        the rewrite (duplicate lines; ``_journal_file_lines``
        over-counting, compacting early)."""
        from mmlspark_tpu_torch.io import fs as _fs
        with self._commit_lock:
            items = list(self._journal.items())
            try:
                while True:
                    self._journal_queue.get_nowait()
            except Empty:
                pass
        if self._journal_fh is not None:
            try:
                self._journal_fh.close()
            except Exception:  # noqa: BLE001
                pass
        now_wall, now_mono = time.time(), time.monotonic()
        _fs.write_text(self.journal_path, "".join(
            self._journal_line(rid, e, now_wall - (now_mono - e[2]))
            for rid, e in items))
        self._journal_fh = _fs.open_file(self.journal_path, "ab")
        self._journal_file_lines = len(items)

    def _drain_journal_queue(self) -> None:
        """Write every queued line in one append+flush (writer thread /
        final drain in stop()); compact when the file outgrows the
        window."""
        lines = []
        try:
            while True:
                lines.append(self._journal_queue.get_nowait())
        except Empty:
            pass
        if not lines or self._journal_fh is None:
            return
        try:
            self._journal_fh.write(b"".join(lines))
            self._journal_fh.flush()
            self._journal_file_lines += len(lines)
            if self._journal_file_lines > 4 * self.journal_size:
                self._compact_journal()
        except Exception:  # noqa: BLE001 — durability is best-effort;
            logger.warning("journal append to %s failed",
                           self.journal_path, exc_info=True)

    def _journal_loop(self):
        while not self._stop.is_set():
            try:
                first = self._journal_queue.get(timeout=0.2)
            except Empty:
                continue
            # put the head back conceptually: write it plus whatever
            # else queued while we slept, in one append+flush
            buf = [first]
            try:
                while True:
                    buf.append(self._journal_queue.get_nowait())
            except Empty:
                pass
            try:
                self._journal_fh.write(b"".join(buf))
                self._journal_fh.flush()
                self._journal_file_lines += len(buf)
                if self._journal_file_lines > 4 * self.journal_size:
                    self._compact_journal()
            except Exception:  # noqa: BLE001
                logger.warning("journal append to %s failed",
                               self.journal_path, exc_info=True)

    def _commit_locked(self, p: _PendingRequest) -> None:
        if self._inflight.pop(p.rid, None) is not None \
                and p.status == 200:
            entry = (p.status, p.reply or b"{}", time.monotonic(),
                     p.trace, p.tenant or "")
            self._journal[p.rid] = entry
            if self._journal_fh is not None:
                # enqueue only: the writer thread does the file I/O
                self._journal_queue.put(self._journal_line(
                    p.rid, entry, time.time()).encode())
            while len(self._journal) > self.journal_size:
                old_rid, _ = self._journal.popitem(last=False)
                self._evict_locked(old_rid)

    def _commit(self, p: _PendingRequest) -> None:
        """Commit a reply, then release waiters. Successful replies are
        journaled under the client request id (exactly-once); errors are
        not journaled, so a client may retry them."""
        t0 = self.tracer.clock.now()
        with self._commit_lock:
            self._commit_locked(p)
            self._reap_expired_locked()
        # the commit child span must hit the recorder BEFORE the
        # release — waiters finish the ROOT on wake (threaded handler
        # thread or event-loop callback), and capture only gathers
        # spans already recorded
        self._add_spans([p], "commit", t0, self.tracer.clock.now())
        self._release(p)

    def _commit_many(self, ps: List[_PendingRequest]) -> None:
        """Batch commit: one lock acquisition and one TTL reap for the
        whole micro-batch (the per-request lock churn was measurable at
        128-row batches), preserving in-batch journal order; waiters are
        released outside the lock, in batch order."""
        if not ps:
            return
        t0 = self.tracer.clock.now()
        with self._commit_lock:
            for p in ps:
                self._commit_locked(p)
            self._reap_expired_locked()
        # record commit children before ANY release fires (see _commit)
        self._add_spans(ps, "commit", t0, self.tracer.clock.now())
        # batched reply flushing: event-loop completion callbacks fired
        # by these releases post their replies into one per-loop batch,
        # flushed with ONE deque extend + ONE wake per loop when the
        # scope exits — a 64-row commit wakes each loop once, not up to
        # 64 times (threaded-frontend waiters are Event.set, unaffected)
        with batched_replies():
            for p in ps:
                self._release(p)

    # -- pipeline loops ------------------------------------------------------

    def _track_batch(self, n: int) -> None:
        with self._stats_lock:
            self._active_batches += n

    def _handoff(self, q: "Queue[dict]", job: dict, on_stop) -> None:
        """Put a job to the next stage. Once ``_stop`` is set the
        consumer may already have exited, so a queued job could strand
        its clients until request_timeout — resolve it via ``on_stop``
        (in this thread) instead; stop()'s flush catches anything that
        races past this check."""
        while True:
            if self._stop.is_set():
                try:
                    on_stop(job)
                finally:
                    self._track_batch(-1)
                return
            try:
                q.put(job, timeout=0.1)
                return
            except Full:
                continue

    def _fail_undispatched(self, job: dict) -> None:
        """Stop-path resolution for a job that never reached the model:
        never dispatch from the collector thread — the executor may be
        mid-``model.transform``, and a second concurrent call through a
        non-thread-safe transformer could commit corrupt (journaled!)
        replies. Fail the stragglers instead; ``_flush_pipeline``
        dispatches the queued ones for real once every stage thread is
        dead."""
        if job["error"] is None:
            job["error"] = RuntimeError("server stopping before dispatch")
        # _stage_dispatch (skipped) is where the backlog debit lives
        with self._stats_lock:
            self._n_backlog -= job["batch_n"]
        self._stage_finish(job)

    def _batch_loop(self):
        """Collector thread: collect + assemble, then either run the
        batch inline (serial plane) or hand it to the executor stage.
        ``_active_batches`` counts a batch from collection until its
        replies are committed, so drain (stop()) covers the whole
        pipeline, not just this thread."""
        while not self._stop.is_set():
            batch = self._collect_batch()
            if not batch:
                continue
            self._track_batch(+1)
            if not self.pipeline:
                try:
                    self._serve_batch(batch)
                finally:
                    self._track_batch(-1)
                continue
            self._handoff(self._dispatch_q, self._stage_prepare(batch),
                          self._fail_undispatched)

    def _executor_loop(self):
        """Executor thread: model dispatch only — it hands the output to
        the encoder pool and immediately returns to the next batch, so
        encode/commit for batch N overlaps model execution for N+1."""
        while True:
            try:
                job = self._dispatch_q.get(timeout=0.05)
            except Empty:
                if self._stop.is_set():
                    return
                continue
            try:
                job = self._stage_dispatch(job)
            except Exception as e:  # noqa: BLE001 — never kill the stage
                job["error"] = job["error"] or e
            # on stop, encoding inline is safe (no model call)
            self._handoff(self._encode_q, job, self._stage_finish)

    def _encoder_loop(self):
        """Encoder-pool thread: unpad + encode + deadline check #2 +
        commit. Pool size ``encoder_threads``: JSON encoding is the
        dominant pure-python cost at high request rates, so it gets the
        parallelism."""
        while True:
            try:
                job = self._encode_q.get(timeout=0.05)
            except Empty:
                if self._stop.is_set():
                    return
                continue
            try:
                self._stage_finish(job)
            except Exception:  # noqa: BLE001 — never kill the stage
                logger.warning("encoder stage failed", exc_info=True)
            finally:
                self._track_batch(-1)

    def _flush_pipeline(self) -> None:
        """Finish any job still sitting in a stage queue after the
        pipeline threads exited (a handoff can race the consumers'
        shutdown): every accepted request gets its reply — or at worst
        a 500 — instead of hanging to request_timeout. Runs in the
        stop() thread after the joins, so nothing else is pulling from
        these queues (and Queue.get is atomic regardless)."""
        while True:
            try:
                job = self._dispatch_q.get_nowait()
            except Empty:
                break
            try:
                self._stage_finish(self._stage_dispatch(job))
            finally:
                self._track_batch(-1)
        while True:
            try:
                job = self._encode_q.get_nowait()
            except Empty:
                break
            try:
                self._stage_finish(job)
            finally:
                self._track_batch(-1)

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "ServingServer":
        self._threads = []
        if self._frontend is not None:
            self._frontend.start()
        else:
            t_http = threading.Thread(target=self._server.serve_forever,
                                      daemon=True)
            t_http.start()
            self._threads.append(t_http)
        # stage threads are NAMED: the sampling profiler attributes
        # samples to pipeline stages by thread name (core/profiler.py
        # STAGE_PREFIXES), so a profile reads collector/dispatch/
        # encoder, not Thread-7
        t_batch = threading.Thread(target=self._batch_loop, daemon=True,
                                   name="serving-collector")
        t_batch.start()
        self._threads.append(t_batch)
        self._stage_threads = [t_batch]
        if self.pipeline:
            t_exec = threading.Thread(target=self._executor_loop,
                                      daemon=True,
                                      name="serving-executor")
            t_exec.start()
            self._threads.append(t_exec)
            self._stage_threads.append(t_exec)
            for i in range(self.encoder_threads):
                t_enc = threading.Thread(target=self._encoder_loop,
                                         daemon=True,
                                         name=f"serving-encoder-{i}")
                t_enc.start()
                self._threads.append(t_enc)
                self._stage_threads.append(t_enc)
        self._journal_thread = None
        if self._journal_fh is not None:
            self._journal_thread = threading.Thread(
                target=self._journal_loop, daemon=True,
                name="serving-journal")
            self._journal_thread.start()
            self._threads.append(self._journal_thread)
        if self.decoder is not None:
            self.decoder.start()
        if self.recorder is not None:
            # the retrospective plane's pump: one scrape per interval
            # feeding the TSDB, the SLO history, recording rules, the
            # anomaly detector, and (when configured) the .prom dumper
            self.recorder.start()
        if self.cpu_profiler is not None:
            # always-on: the CPU history must already be in the ring
            # when a detector fires — see docs/observability.md
            self.cpu_profiler.start()
        if self.incidents is not None:
            self.incidents.start()
        return self

    def stop(self, drain: bool = True, drain_timeout: float = 5.0):
        """Stop serving. With ``drain`` (the default), new requests are
        refused first (503 + Retry-After; ``/readyz`` flips to 503) and
        already-accepted work is given ``drain_timeout`` seconds to
        batch, commit, and reply before the listener goes down — a
        rolling restart loses no accepted request."""
        self._draining.set()
        if drain:
            # backlog(), not the ingress queue: a request the collector
            # has already popped but not yet dispatched is still
            # accepted work (it is only debited at dispatch), and the
            # pipelined plane keeps work in stage queues the ingress
            # queue never sees
            t_end = time.monotonic() + float(drain_timeout)
            while time.monotonic() < t_end and \
                    (self.backlog() > 0 or self._active_batches > 0):
                time.sleep(0.005)
        if self.decoder is not None:
            # the decode plane drains itself: in-slot requests would
            # take seconds to finish naturally, so the scheduler stops
            # its loop and resolves stragglers with 503s (a retry
            # lands on a live worker) — accepted-and-journaled replies
            # are already committed and replayable
            self.decoder.stop()
        self._stop.set()
        if self._frontend is None:
            self._server.shutdown()
            self._server.server_close()
        else:
            # stop taking NEW connections now (established keep-alive
            # connections keep being served so in-flight replies land);
            # the loops themselves stop below, after the pipeline flush
            # has posted every reply that will ever exist
            self._frontend.pause_accept()
        for t in self._threads:
            t.join(timeout=5)
        if any(t.is_alive() for t in getattr(self, "_stage_threads", [])):
            # a stage thread is stuck (hung model / slow device): the
            # flush's no-concurrent-consumer invariant doesn't hold, and
            # running the model from this thread too could interleave
            # two batches through a non-thread-safe transformer — leave
            # the queues to the daemon threads instead
            logger.warning(
                "pipeline threads did not stop in 5s; skipping the "
                "final stage-queue flush (stranded requests will 504 "
                "at request_timeout)")
        else:
            self._flush_pipeline()
        if self._frontend is not None:
            # everything that will ever call reply() has run: the loops
            # deliver what's queued, flush pending writes, close fds
            self._frontend.stop()
        # stop mirroring shadow traffic (the staged version, if any,
        # stays staged — a restart-less stop/start keeps it resident)
        self.versions.close()
        if self.capture is not None:
            # flush queued capture rows so a clean stop loses nothing
            self.capture.stop()
        if self.recorder is not None:
            # final tick: the terminal counters land in the store (and
            # on disk when dumping) before the process exits
            self.recorder.stop()
        if self.incidents is not None:
            # before the profiler: an in-flight capture still gets its
            # profile window from the (stopped but readable) ring
            self.incidents.stop()
        if self.cpu_profiler is not None:
            self.cpu_profiler.stop()
        if self._journal_fh is not None:
            jt = getattr(self, "_journal_thread", None)
            if jt is not None and jt.is_alive():
                # the writer is stuck mid-append (slow remote fs):
                # closing/draining here would interleave two writers on
                # one handle and corrupt journal lines — leak the handle
                # instead (the daemon thread dies with the process)
                logger.warning(
                    "journal writer did not stop in 5s; leaving the "
                    "journal handle to it (lines queued after this "
                    "point are dropped)")
                return
            self._drain_journal_queue()   # flush lines queued at stop
            try:
                self._journal_fh.close()
            except Exception:  # noqa: BLE001
                pass
            self._journal_fh = None

    @property
    def address(self) -> str:
        return f"http://{self.host}:{self.port}{self.api_path}"

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()


class ServingCoordinator:
    """Driver-side service registry for multi-host serving.

    Parity: the coordination HttpServer in `HTTPSourceV2.scala:111-167` —
    workers POST ``{"host": ..., "port": ...}`` to ``/register``; clients
    GET ``/services`` for the worker list and round-robin between them.
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 stale_after: Optional[float] = None,
                 tracer=None, frontend: str = "eventloop",
                 acceptors: int = 1, reuse_port: bool = False,
                 rollout_history: int = 32,
                 slo=None):
        # stale_after: drop workers not re-registered within this many
        # seconds — workers heartbeat (a worker process re-registers
        # every REGISTER_INTERVAL), so dead pods age out instead of
        # accumulating forever. None = never expire.
        self._services: List[Dict[str, Any]] = []
        self._seen: Dict[Tuple[Any, Any], float] = {}
        self.stale_after = (float(stale_after)
                            if stale_after and stale_after > 0 else None)
        # the coordinator usually runs next to the driver/client, whose
        # OWN tracer holds the client side of a distributed trace (the
        # predict root + per-attempt egress spans); fleet_trace() folds
        # that store in as the "client" part, so merged trees include
        # the failover schedule, not just the worker fragments
        self.tracer = tracer if tracer is not None else TRACER
        self._lock = threading.Lock()
        # the current (or last) fleet rollout: POST /rollout starts
        # one RolloutOrchestrator at a time; GET /rollout reports it
        self._rollout: Optional[RolloutOrchestrator] = None
        self._rollout_lock = threading.Lock()
        # bounded ring of rollout runs (current included): GET
        # /rollouts lists every remembered run's state machine + phase
        # decisions, newest first — the audit trail an operator reads
        # after an auto-rollback they did not witness
        from collections import deque as _deque
        self._rollout_runs: "_deque[RolloutOrchestrator]" = _deque(
            maxlen=max(int(rollout_history), 1))
        # previous poll's merged counters: GET /fleet reports
        # rate()-style deltas alongside the lifetime totals (trend
        # needs two scrapes — the ROADMAP fleet-rate item)
        self._prev_totals: Optional[Tuple[float, Dict[str, int]]] = None
        # -- fleet SLO plane (on by default; ``slo=False`` disables):
        # the coordinator keeps a PRIVATE registry with per-worker
        # scrape/scrape-failure counters — every /fleet/alerts and
        # /fleet/slo request polls the workers, feeds the counters,
        # and evaluates one fleet_availability burn-rate policy over
        # them, so a dead worker burns error budget with per-worker
        # attribution until it ages out of stale_after AND the
        # windows. ``slo`` takes {"objective", "windows", "for_s",
        # "resolve_after_s", "webhook"} overrides.
        cfg = dict(slo) if isinstance(slo, dict) else {}
        self.registry = MetricsRegistry()
        self._m_polls = self.registry.counter(
            "fleet_worker_polls_total",
            "Worker scrape attempts by the coordinator's SLO plane.",
            labels=("worker",))
        self._m_poll_failures = self.registry.counter(
            "fleet_worker_poll_failures_total",
            "Worker scrapes that failed (dead/unreachable worker) — "
            "the fleet availability burn's bad-event counter.",
            labels=("worker",))
        self.slo: Optional[SLOEngine] = None
        if slo is not False:
            policy = SLOPolicy(
                name="fleet_availability", kind="availability",
                objective=float(cfg.get("objective", 0.999)),
                total_metric="fleet_worker_polls_total",
                bad_metric="fleet_worker_poll_failures_total",
                windows=(tuple(tuple(w) for w in cfg["windows"])
                         if "windows" in cfg else DEFAULT_WINDOWS),
                for_s=float(cfg.get("for_s", 0.0)),
                resolve_after_s=float(cfg.get("resolve_after_s",
                                              60.0)))
            self.slo = SLOEngine(
                self.registry, [policy],
                notifier=(AlertNotifier(cfg["webhook"])
                          if cfg.get("webhook") else None))
            self.slo.register_metrics(self.registry)
        coordinator = self

        class Handler(BaseHTTPRequestHandler):
            def do_POST(self):
                length = int(self.headers.get("Content-Length", 0))
                routed = coordinator._post_route(
                    self.path, self.rfile.read(length))
                if routed is None:
                    self.send_error(404)
                    return
                self._send(*routed)

            def do_GET(self):
                routed = coordinator._route(self.path)
                if routed is None:
                    self.send_error(404)
                    return
                self._send(*routed)

            def _send(self, status, body, ctype):
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):
                pass

        # the coordinator rides the same socket edge as the workers:
        # fleet dashboards poll /fleet every few seconds, and with the
        # event-loop frontend (the default) those pollers hold ONE
        # keep-alive connection instead of a fresh handshake per scrape.
        # ``frontend="threaded"`` keeps the http.server plane selectable,
        # mirroring ServingServer's A/B switch.
        self.frontend = str(frontend)
        self._thread: Optional[threading.Thread] = None
        if self.frontend == "eventloop":
            self._server = None
            self._frontend: Optional[EventLoopFrontend] = \
                EventLoopFrontend(self, host, port,
                                  acceptors=acceptors,
                                  reuse_port=reuse_port,
                                  name="coordinator")
            self.host, self.port = (self._frontend.host,
                                    self._frontend.port)
        elif self.frontend == "threaded":
            self._frontend = None
            self._server = _Server((host, port), Handler)
            self.host, self.port = self._server.server_address[:2]
        else:
            raise ValueError(
                f"unknown frontend {frontend!r} "
                "(expected 'eventloop' or 'threaded')")

    # -- route table (both frontends serve exactly this) ---------------------

    def _post_route(self, path: str, body: bytes
                    ) -> Optional[Tuple[int, bytes, str]]:
        if path == "/rollout":
            # fleet rollout: stage everywhere -> (shadow) -> canary ->
            # flip or auto-rollback, orchestrated in the background;
            # poll GET /rollout for the state machine
            try:
                args = json.loads(body or b"{}")
                if not isinstance(args, dict) or not args.get("version"):
                    raise ValueError('need a JSON object with "version"')
            except ValueError as e:
                return (400, json.dumps({"error": str(e)}).encode(),
                        "application/json")
            try:
                run = self.rollout(**args)
            except (TypeError, ValueError) as e:
                # TypeError: unknown parameter; ValueError: a malformed
                # value (e.g. a zero-scale quantization config) — both
                # are client errors, refused before any worker is asked
                # to stage anything
                return (400, json.dumps(
                    {"error": f"bad rollout parameter: {e}"}).encode(),
                    "application/json")
            except RolloutError as e:
                return (409, json.dumps(
                    {"error": str(e),
                     "rollout": self.rollout_status()}).encode(),
                    "application/json")
            return (202, json.dumps(run.status()).encode(),
                    "application/json")
        if path not in ("/register", "/deregister"):
            return None
        try:
            info = json.loads(body)
        except ValueError:
            return 400, b'{"error": "invalid JSON"}', "application/json"
        key = (info.get("host"), info.get("port"))
        with self._lock:
            if path == "/register":
                # idempotent: a re-registering worker (periodic
                # heartbeat, or after a coordinator restart) replaces
                # its old entry instead of duplicating
                self._services = [
                    s for s in self._services
                    if (s.get("host"), s.get("port")) != key]
                self._services.append(info)
                self._seen[key] = time.monotonic()
            else:
                self._services = [
                    s for s in self._services
                    if (s.get("host"), s.get("port")) != key]
                self._seen.pop(key, None)
        return 200, b"{}", "application/json"

    def _route(self, path: str) -> Optional[Tuple[int, bytes, str]]:
        if path == "/fleet":
            # one-stop fleet observability: polls every live worker's
            # /stats + /metrics and serves the merged view (slowest
            # stage, widest bucket, totals)
            return (200, json.dumps(self.fleet_stats()).encode(),
                    "application/json")
        if path == "/fleet/metrics":
            return (200, self.fleet_metrics().encode(),
                    _METRICS_CONTENT_TYPE)
        if path == "/fleet/alerts":
            # the fleet alert roll-up: the coordinator's own
            # fleet_availability evaluation (dead workers burn with
            # per-worker attribution) plus every live worker's compact
            # alert view, worker-attributed
            return (200, json.dumps(self.fleet_alerts()).encode(),
                    "application/json")
        if path == "/fleet/slo":
            return (200, json.dumps(self.fleet_slo()).encode(),
                    "application/json")
        if path == "/fleet/traces":
            # every worker's retained slow/error captures in one
            # listing (concurrent polls; a dead worker degrades to an
            # error entry, never a 5xx here)
            return (200, json.dumps(self.fleet_traces()).encode(),
                    "application/json")
        if path == "/fleet/incidents":
            # the fleet postmortem inventory: every worker's captured
            # incident bundles, worker-attributed, newest first — one
            # fleet-wide regression reads as one correlated evidence
            # set (fetch a bundle from its worker via
            # /incidents/<id>/<artifact>; tools/trace_dump.py
            # --incidents --fetch does this)
            return (200, json.dumps(self.fleet_incidents()).encode(),
                    "application/json")
        if path.startswith("/fleet/trace/"):
            raw, _, query = path[len("/fleet/trace/"):].partition("?")
            # same charset as trace ids: the id is spliced into
            # per-worker URLs and must not smuggle a path/query
            tid = "".join(ch for ch in raw[:128]
                          if ch.isalnum() or ch in "._-")
            merged, errors = self.fleet_trace(tid)
            if merged is None:
                body = json.dumps(
                    {"error": "trace not retained by any worker "
                              "(fast + ok traces are tail-dropped)",
                     "trace_id": tid,
                     "workers_failed": errors}).encode()
                return 404, body, "application/json"
            if "format=perfetto" in query:
                # per-worker lanes: each process renders as its own
                # pid with named process_name metadata
                body = json.dumps(to_perfetto(merged)).encode()
            else:
                out = {k: merged[k] for k in
                       ("trace_id", "root", "route", "duration_ms",
                        "status", "reason", "captured_at", "n_spans",
                        "workers")}
                out["tree"] = span_tree(merged)
                out["workers_failed"] = errors
                body = json.dumps(out).encode()
            return 200, body, "application/json"
        if path.startswith("/fleet/query"):
            # the one-stop fleet view over the retrospective plane:
            # /fleet/query and /fleet/query_range fan the expression
            # out to every worker's TSDB and merge the answers under
            # worker=host:port labels (same query grammar; dead
            # workers degrade to error entries, never a 5xx)
            sub = path[len("/fleet"):]
            base = sub.split("?", 1)[0]
            if base not in ("/query", "/query_range"):
                return None
            return (200, json.dumps(self.fleet_query(sub)).encode(),
                    "application/json")
        if path == "/rollout":
            return (200, json.dumps(self.rollout_status()).encode(),
                    "application/json")
        if path == "/rollouts":
            # the bounded history ring: past runs + the current one,
            # newest first, each with its phase decisions (canary
            # verdict, failure detail, per-worker staging states)
            return (200, json.dumps(self.rollout_history()).encode(),
                    "application/json")
        if path == "/services":
            with self._lock:
                self._prune_stale_locked()
                body = json.dumps(self._services).encode()
            return 200, body, "application/json"
        return None

    # -- event-loop frontend protocol ----------------------------------------

    def handle_request(self, method: str, path: str, headers,
                       body: bytes, reply) -> bool:
        """The :class:`EventLoopFrontend` application protocol. Every
        coordinator route answers synchronously — registry mutations
        are in-memory, and the fleet polls run on the loop thread (the
        coordinator is a control-plane process; a multi-second fleet
        poll stalling its own accept loop is the same behavior the
        single-threaded pollers already observe)."""
        if method == "POST":
            routed = self._post_route(path, body)
        elif method == "GET":
            routed = self._route(path)
        else:
            return False
        if routed is None:
            return False
        status, rbody, ctype = routed
        reply(status, rbody, ctype=ctype)
        return True

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "ServingCoordinator":
        if self._frontend is not None:
            self._frontend.start()
            return self
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self):
        if self._frontend is not None:
            self._frontend.stop()
            return
        self._server.shutdown()
        self._server.server_close()
        if self._thread:
            self._thread.join(timeout=5)

    def _prune_stale_locked(self) -> None:
        if self.stale_after is None:
            return
        horizon = time.monotonic() - self.stale_after
        self._services = [
            s for s in self._services
            if self._seen.get((s.get("host"), s.get("port")), 0) >= horizon]
        # drop the timestamps too: months of rolling pod redeploys must
        # not accumulate one _seen entry per worker IP ever seen
        self._seen = {k: t for k, t in self._seen.items() if t >= horizon}

    def services(self) -> List[Dict[str, Any]]:
        with self._lock:
            self._prune_stale_locked()
            return list(self._services)

    # -- fleet rollout orchestration -----------------------------------------

    def rollout(self, version: str, **kwargs) -> RolloutOrchestrator:
        """Start one fleet rollout (see
        :class:`~mmlspark_tpu_torch.serving.rollout.RolloutOrchestrator` for
        the phases and knobs). One at a time: a second call while one
        is running raises :class:`RolloutError` (HTTP callers get a
        409)."""
        with self._rollout_lock:
            if self._rollout is not None and self._rollout.running:
                raise RolloutError(
                    f"a rollout to {self._rollout.version!r} is "
                    f"already {self._rollout.state}")
            run = RolloutOrchestrator(self, version, **kwargs)
            self._rollout = run
            # remembered from the start: a run that dies mid-phase is
            # exactly the one the history must still show
            self._rollout_runs.append(run)
            run.start()
            return run

    def rollout_status(self) -> Dict[str, Any]:
        with self._rollout_lock:
            if self._rollout is None:
                return {"state": "idle"}
            return self._rollout.status()

    def rollout_history(self) -> Dict[str, Any]:
        """Every remembered rollout run (bounded ring, newest first):
        final state, phase decision, failure detail, per-worker
        staging/flip bookkeeping — ``RolloutOrchestrator.status()``
        verbatim per run. Live runs report their current phase."""
        with self._rollout_lock:
            runs = [r.status() for r in reversed(self._rollout_runs)]
        return {"capacity": self._rollout_runs.maxlen,
                "n_runs": len(runs), "rollouts": runs}

    # -- fleet-level stats aggregation ---------------------------------------

    def _poll_workers(self, path: str, timeout: float
                      ) -> List[Tuple[str, Any, Optional[str]]]:
        """``(worker_key, parsed_or_text, error)`` per registered
        worker; a dead worker contributes its error instead of failing
        the whole fleet view. Polls run CONCURRENTLY so k unreachable
        pods cost one connect timeout, not k of them — a fleet view
        must stay fast exactly when workers are failing."""
        import requests
        from concurrent.futures import ThreadPoolExecutor

        def poll(s):
            wk = f"{s.get('host')}:{s.get('port')}"
            try:
                r = requests.get(f"http://{wk}{path}", timeout=timeout)
                r.raise_for_status()
                json_paths = ("/stats", "/traces", "/trace/",
                              "/alerts", "/slo", "/query",
                              "/incidents")
                return (wk, r.json() if path.startswith(json_paths)
                        else r.text, None)
            except Exception as e:  # noqa: BLE001 — worker down/old
                return (wk, None, str(e))

        services = self.services()
        if not services:
            return []
        with ThreadPoolExecutor(
                max_workers=min(len(services), 16)) as pool:
            return list(pool.map(poll, services))

    def fleet_stats(self, timeout: float = 5.0) -> Dict[str, Any]:
        """Poll every worker's ``/stats`` and merge them into one fleet
        view — the single place a fleet's slowest stage is visible
        (closing the ROADMAP item): per-stage timings are combined
        (counts and totals sum, maxes max), and ``slowest_stage`` names
        the stage with the highest merged mean AND the worker whose
        per-worker mean for it is worst. ``widest_bucket`` is the
        largest dispatch shape any worker compiled.
        """
        per_worker: Dict[str, Any] = {}
        merged: Dict[str, Dict[str, float]] = {}
        totals = {k: 0 for k in (
            "n_requests", "n_batches", "n_recompiles", "queue_depth",
            "inflight_batches")}
        widest = 0
        worst: Dict[str, Tuple[float, str]] = {}   # stage -> (mean, worker)
        n_live = 0
        for wk, stats, err in self._poll_workers("/stats", timeout):
            if err is not None:
                per_worker[wk] = {"error": err}
                continue
            n_live += 1
            per_worker[wk] = stats
            for k in totals:
                totals[k] += int(stats.get(k) or 0)
            sizes = stats.get("dispatch_sizes") or []
            widest = max(widest, max(sizes, default=0))
            for stage, t in (stats.get("stage_timings") or {}).items():
                m = merged.setdefault(stage, {"count": 0, "total_ms": 0.0,
                                              "max_ms": 0.0})
                m["count"] += t.get("count", 0)
                m["total_ms"] += t.get("total_ms", 0.0)
                m["max_ms"] = max(m["max_ms"],
                                  t.get("max_ms", t.get("last_ms", 0.0)))
                mean = t.get("mean_ms", 0.0)
                if mean > worst.get(stage, (-1.0, ""))[0]:
                    worst[stage] = (mean, wk)
        for m in merged.values():
            m["mean_ms"] = round(m["total_ms"] / m["count"], 4) \
                if m["count"] else 0.0
            m["total_ms"] = round(m["total_ms"], 3)
        slowest = None
        if merged:
            stage = max(merged, key=lambda s: merged[s]["mean_ms"])
            slowest = {"stage": stage,
                       "mean_ms": merged[stage]["mean_ms"],
                       "max_ms": merged[stage]["max_ms"],
                       "worker": worst[stage][1],
                       "worker_mean_ms": round(worst[stage][0], 4)}
        # rate()-style deltas between this poll and the previous one:
        # the merged counters are lifetime totals, so trend needs two
        # scrapes — held here so ANY /fleet consumer gets rates for
        # free. Counters only (queue_depth/inflight are gauges, a delta
        # of those is noise); clamped at 0 so a worker restart's
        # counter reset reads as "no traffic", not negative traffic.
        # The baseline advances at most once per second: a second
        # consumer (an operator's curl next to the dashboard's poll)
        # must not shrink everyone's window to near-zero, where the
        # quantized counter deltas read as spikes. Rates stay correct
        # over whatever interval is reported — rate_interval_s says
        # which.
        now = time.monotonic()
        with self._lock:
            prev = self._prev_totals
            if prev is None or now - prev[0] >= 1.0:
                self._prev_totals = (now, dict(totals))
        rates: Optional[Dict[str, float]] = None
        interval = None
        if prev is not None and now > prev[0]:
            interval = round(now - prev[0], 3)
            rates = {k: round(max(totals[k] - prev[1].get(k, 0), 0)
                              / (now - prev[0]), 3)
                     for k in ("n_requests", "n_batches", "n_recompiles")}
        # the fleet's model-version set (RESPONDING workers only): a
        # completed rollout reads as one coherent version fleet-wide —
        # the kill-mid-rollout drill's acceptance signal
        versions = sorted({str(s["model_version"])
                           for s in per_worker.values()
                           if isinstance(s, dict)
                           and s.get("model_version")})
        # per-tenant ledgers merged fleet-wide: counters sum, in-flight
        # sums (a gauge, but per-tenant concurrency IS additive across
        # workers), priority/quota config taken from the first worker
        # that names the tenant. None when no responding worker runs a
        # tenant registry.
        tenants: Dict[str, Dict[str, Any]] = {}
        for s in per_worker.values():
            if not isinstance(s, dict):
                continue
            ten = (s.get("tenancy") or {}).get("tenants") or []
            for row in ten:
                tid = str(row.get("id", ""))
                if not tid:
                    continue
                agg = tenants.get(tid)
                if agg is None:
                    tenants[tid] = dict(row)
                    continue
                for k, v in row.items():
                    if isinstance(v, (int, float)) \
                            and not isinstance(v, bool) \
                            and k not in ("rate_per_s", "burst",
                                          "max_inflight",
                                          "max_cache_pages", "weight"):
                        agg[k] = agg.get(k, 0) + v
        return {"n_workers": len(per_worker), "n_responding": n_live,
                "totals": totals, "rates_per_s": rates,
                "rate_interval_s": interval, "stage_timings": merged,
                "slowest_stage": slowest, "widest_bucket": widest,
                "model_versions": versions,
                "version_coherent": len(versions) <= 1,
                "tenants": (sorted(tenants.values(),
                                   key=lambda r: str(r.get("id", "")))
                            if tenants else None),
                "workers": per_worker}

    def fleet_metrics(self, timeout: float = 5.0) -> str:
        """Poll every worker's ``/metrics`` and serve ONE merged
        exposition: sample values summed per (name, labels) — exact for
        counters and histogram buckets, fleet totals for gauges (see
        :func:`mmlspark_tpu_torch.core.telemetry.merge_prometheus`). Scraping
        the coordinator thus covers the fleet with one target.

        Scrapes ``?scope=server`` (each worker's own registry): the
        process-wide REGISTRY would be summed once per worker when
        several workers share a process, double-counting its families —
        process-level metrics stay on the individual workers'
        unscoped ``/metrics``.

        Every registered worker contributes a
        ``serving_worker_up{worker=...}`` sample (1 scraped, 0 failed):
        when a worker drops out, the merged counters dip (Prometheus
        reads that as a counter reset), and this is the signal that the
        dip means "incomplete sum", not "restarted fleet"."""
        polls = self._poll_workers("/metrics?scope=server", timeout)
        merged = merge_prometheus(
            body for _, body, err in polls if err is None)
        for wk, _, err in polls:
            merged[("serving_worker_up", (("worker", wk),))] = \
                0.0 if err is not None else 1.0
        # the coordinator stamps its OWN build identity into the fleet
        # exposition (frontend="coordinator"), so a scrape of the one
        # fleet target also answers "what is the control plane running"
        from mmlspark_tpu_torch.core.telemetry import build_info
        info = dict(build_info())
        info["frontend"] = "coordinator"
        merged[("serving_build_info",
                tuple(sorted(info.items())))] = 1.0
        return render_samples(merged)

    # -- fleet SLO roll-up ---------------------------------------------------

    def fleet_alerts(self, timeout: float = 5.0) -> Dict[str, Any]:
        """The fleet alert view: poll every worker's ``GET /alerts``
        (each poll feeds the coordinator's per-worker scrape counters
        — the fleet_availability policy's total/bad events), evaluate
        the coordinator's own engine, and report both. ``firing``
        totals the fleet policy and every responding worker's count;
        a dead worker appears as an ``{"error": ...}`` entry AND as
        availability burn with its ``worker=host:port`` attribution."""
        polls = self._poll_slo("alerts", timeout)
        fleet_view = None
        firing = 0
        if self.slo is not None:
            self.slo.evaluate()
            fleet_view = self.slo.alerts()
            firing += int(fleet_view.get("firing", 0))
        workers: Dict[str, Any] = {}
        for wk, body, err in polls:
            if err is not None:
                workers[wk] = {"error": err}
                continue
            workers[wk] = body
            if isinstance(body, dict):
                firing += int(body.get("firing", 0))
        return {"firing": firing, "fleet": fleet_view,
                "workers": workers}

    def fleet_slo(self, timeout: float = 5.0) -> Dict[str, Any]:
        """The full fleet burn-rate report: the coordinator policy's
        evaluation plus every worker's ``GET /slo`` report verbatim,
        worker-attributed."""
        polls = self._poll_slo("slo", timeout)
        fleet_view = self.slo.evaluate() if self.slo is not None \
            else None
        workers = {wk: (body if err is None else {"error": err})
                   for wk, body, err in polls}
        firing = 0
        if self.slo is not None:
            firing += len(self.slo.firing())
        return {"firing": firing, "fleet": fleet_view,
                "workers": workers}

    def _poll_slo(self, mode: str, timeout: float
                  ) -> List[Tuple[str, Any, Optional[str]]]:
        """Poll every worker's ``/alerts`` or ``/slo``, charging the
        per-worker scrape counters the fleet availability policy
        evaluates (success AND failure both count a poll; only
        failures count bad events)."""
        polls = self._poll_workers(f"/{mode}", timeout)
        for wk, _, err in polls:
            self._m_polls.labels(wk).inc()
            if err is not None:
                self._m_poll_failures.labels(wk).inc()
        return polls

    def fleet_query(self, path_with_query: str, timeout: float = 5.0
                    ) -> Dict[str, Any]:
        """Fan one ``/query`` or ``/query_range`` (path WITH its query
        string) out to every worker's TSDB and merge the per-worker
        answers: every result/series gains a ``worker: host:port``
        label, so a fleet-wide ``rate(serving_requests_total[60s])``
        comes back as one list with per-worker attribution. A dead
        worker (or a worker-side 400) contributes an ``errors`` entry
        instead of failing the view; the query echo (expr/at or
        start/end/step) is taken from the first responding worker."""
        merged: List[Dict[str, Any]] = []
        errors: Dict[str, str] = {}
        echo: Dict[str, Any] = {}
        key = None
        polls = self._poll_workers(path_with_query, timeout)
        for wk, body, err in polls:
            if err is not None or not isinstance(body, dict):
                errors[wk] = err or "malformed worker response"
                continue
            if key is None:
                key = "series" if "series" in body else "results"
                echo = {k: body[k] for k in
                        ("expr", "at", "start", "end", "step")
                        if k in body}
            for row in body.get(key) or []:
                entry = dict(row)
                entry["labels"] = dict(entry.get("labels") or {})
                entry["labels"]["worker"] = wk
                merged.append(entry)
        out = dict(echo)
        out.update({"n_workers": len(polls),
                    "n_responding": len(polls) - len(errors),
                    "errors": errors,
                    (key or "results"): merged})
        return out

    # -- fleet-level trace aggregation ---------------------------------------

    def fleet_traces(self, timeout: float = 5.0) -> Dict[str, Any]:
        """Every worker's retained-trace listing in one place: polls
        each worker's ``GET /traces`` concurrently and flattens the
        summaries with per-worker attribution (``worker: host:port``
        on every entry), slowest first. A dead worker contributes an
        entry in ``errors`` instead of failing the view — exactly when
        workers are dying is when an operator reads this."""
        traces: List[Dict[str, Any]] = []
        errors: Dict[str, str] = {}
        polls = self._poll_workers("/traces", timeout)
        for wk, items, err in polls:
            if err is not None:
                errors[wk] = err
                continue
            for t in items:
                entry = dict(t)
                entry["worker"] = wk
                traces.append(entry)
        traces.sort(key=lambda t: -t.get("duration_ms", 0.0))
        return {"n_workers": len(polls),
                "n_responding": len(polls) - len(errors),
                "traces": traces, "errors": errors}

    def fleet_incidents(self, timeout: float = 5.0) -> Dict[str, Any]:
        """Every worker's incident-bundle inventory in one place:
        polls each worker's ``GET /incidents`` concurrently and
        flattens the listings with per-worker attribution, newest
        first. A worker with incident capture disabled (its 404) or a
        dead worker contributes an ``errors`` entry instead of failing
        the view."""
        incidents: List[Dict[str, Any]] = []
        errors: Dict[str, str] = {}
        polls = self._poll_workers("/incidents", timeout)
        for wk, payload, err in polls:
            if err is not None:
                errors[wk] = err
                continue
            for inc in payload.get("incidents", []):
                entry = dict(inc)
                entry["worker"] = wk
                incidents.append(entry)
        incidents.sort(key=lambda i: -(i.get("at_unix") or 0.0))
        return {"n_workers": len(polls),
                "n_responding": len(polls) - len(errors),
                "incidents": incidents, "errors": errors}

    def fleet_trace(self, trace_id: str, timeout: float = 5.0
                    ) -> Tuple[Optional[Dict[str, Any]], Dict[str, str]]:
        """Fetch-and-merge one distributed trace: every worker's
        retained capture of ``trace_id`` (``GET /trace/<id>?format=raw``,
        polled concurrently) plus this process's own tracer store (the
        ``client`` part — the driver-side predict root and failover
        egress spans), stitched by
        :func:`mmlspark_tpu_torch.core.tracing.merge_traces` so worker roots
        nest under the caller's egress spans. Returns ``(merged,
        errors)``; merged is None when no part retained the trace. A
        404 from a worker means "not retained there" — normal
        tail-capture behavior, not an error."""
        import requests
        from concurrent.futures import ThreadPoolExecutor

        def poll(s):
            wk = f"{s.get('host')}:{s.get('port')}"
            try:
                r = requests.get(
                    f"http://{wk}/trace/{trace_id}?format=raw",
                    timeout=timeout)
                if r.status_code == 404:
                    return (wk, None, None)
                r.raise_for_status()
                return (wk, r.json(), None)
            except Exception as e:  # noqa: BLE001 — worker down/old
                return (wk, None, str(e))

        services = self.services()
        polls: List[Tuple[str, Any, Optional[str]]] = []
        if services:
            with ThreadPoolExecutor(
                    max_workers=min(len(services), 16)) as pool:
                polls = list(pool.map(poll, services))
        parts: List[Tuple[str, Dict[str, Any]]] = []
        local = self.tracer.get_trace(trace_id) \
            if self.tracer is not None else None
        if local is not None:
            parts.append(("client", local))
        parts.extend((wk, tr) for wk, tr, err in polls
                     if tr is not None)
        errors = {wk: err for wk, _, err in polls if err is not None}
        if not parts:
            return None, errors
        return merge_traces(parts), errors

    @staticmethod
    def register_worker(coordinator_url: str, host: str, port: int):
        import requests
        requests.post(f"{coordinator_url}/register",
                      json={"host": host, "port": port}, timeout=10)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()


class ServingClient:
    """Round-robin client over a coordinator's worker list, with
    breaker-guarded failover and budgeted idempotent retries.

    Every logical request carries a generated ``X-Request-Id``; a retry
    (after a dropped connection, a 5xx, or worker death) reuses the id,
    so a worker that already computed the reply returns its journaled
    copy instead of re-running inference (see :class:`ServingServer`).
    Parity: the reference's clients round-robin the `/services` list of
    `DriverServiceUtils` (`HTTPSourceV2.scala:111`).

    Resilience wiring:

    * a :class:`CircuitBreaker` per worker (``breakers``): a worker that
      keeps failing is skipped without a connect attempt until its
      reset timeout (on the injected clock) elapses;
    * a :class:`RetryPolicy` bounds the TOTAL failover/retry schedule
      per logical request (attempts + elapsed-time budget, jittered
      backoff, 429 ``Retry-After`` honored);
    * ``timeout_budget`` puts a :class:`Deadline` on the whole call,
      propagated to workers via ``X-Deadline-Ms`` so the server also
      stops spending on it (dropped before dispatch / commit).

    Dedup scope: the reply journal lives in each worker, so replay
    dedup is **per worker** — a retry that lands on a *different* worker
    re-runs inference there. To keep the common slow-worker case
    exactly-once, a ``requests.Timeout`` is retried once on the SAME
    worker (whose journal can replay the reply) before failing over;
    only connection failures (worker dead) fail over immediately, where
    re-execution on a new worker is the intended at-least-once fallback.
    """

    def __init__(self, coordinator_url: str, api_path: str = "/predict",
                 timeout: float = 15.0,
                 retry_policy: Optional[RetryPolicy] = None,
                 breakers: Optional[BreakerBoard] = None,
                 tracer=None,
                 api_key: Optional[str] = None,
                 clock: Clock = SYSTEM_CLOCK):
        self.coordinator_url = coordinator_url.rstrip("/")
        self.api_path = api_path
        self.timeout = timeout
        # tenant identity: sent as X-Api-Key on every attempt so a
        # tenancy-enabled fleet (docs/serving.md "Tenancy & overload
        # control") bills the whole failover schedule to one tenant
        self.api_key = api_key
        # spans record through this tracer (None = the ambient one at
        # call time, falling back to the process TRACER): one "predict"
        # root per logical request with an egress child per attempt,
        # whose id travels as X-Parent-Span-Id so every worker-side
        # tree stitches under the failover schedule
        self.tracer = tracer
        self.clock = clock
        self.policy = retry_policy or RetryPolicy(
            max_attempts=6, base=0.02, cap=0.5, clock=clock)
        self.breakers = breakers or BreakerBoard(
            clock=clock, failure_threshold=3, reset_timeout=5.0)
        self.n_failovers = 0
        self._workers: List[str] = []
        self._dead: set = set()
        self._rr = 0
        # one pooled session: every attempt rides a kept-alive
        # connection to its worker (urllib3's pool is thread-safe, so
        # concurrent predict() calls share it) — against an event-loop
        # worker each burst costs one handshake, not one per request
        import requests as _requests
        self._http = _requests.Session()
        self.refresh()

    def refresh(self) -> List[str]:
        import requests
        services = requests.get(self.coordinator_url + "/services",
                                timeout=self.timeout).json()
        self._workers = [f"http://{s['host']}:{s['port']}{self.api_path}"
                         for s in services]
        self._dead.clear()
        return list(self._workers)

    def _pick(self) -> str:
        """Next worker: alive, breaker-admitted, round-robin. Falls back
        to breaker-refused workers rather than failing a request that
        still has budget (availability over protection — the breakers
        exist to stop *hammering*, not to refuse the only option)."""
        alive = [w for w in self._workers if w not in self._dead] \
            or self.refresh()
        if not alive:
            raise RuntimeError("no serving workers registered")
        for _ in range(len(alive)):
            url = alive[self._rr % len(alive)]
            self._rr += 1
            if self.breakers.get(url).allow():
                return url
        url = alive[self._rr % len(alive)]
        self._rr += 1
        return url

    def predict(self, payload: Any, request_id: Optional[str] = None,
                timeout_budget: Optional[float] = None) -> Any:
        rid = request_id or uuid.uuid4().hex
        # one trace id per LOGICAL request (adopting the ambient one
        # when the caller is already inside a trace): every failover/
        # retry attempt carries the same id, so the whole schedule is
        # one line-set in worker logs
        trace = current_trace_id() or new_trace_id()
        tracer = self.tracer if self.tracer is not None \
            else ambient_tracer()
        # one client-side ROOT span over the whole failover schedule:
        # each wire attempt nests under it, and every worker-side tree
        # parents under those attempts in the merged distributed trace
        # (GET /fleet/trace/<id>). Tail capture follows the tracer's
        # "serving_client" route threshold.
        root = tracer.start("predict", trace_id=trace,
                            route="serving_client", rid=rid)
        status = "error"
        try:
            out = self._predict_attempts(payload, rid, trace,
                                         timeout_budget, tracer, root)
            status = "ok"
            return out
        except DeadlineExceeded:
            status = "deadline"
            raise
        finally:
            tracer.finish(root, status=status)

    def _predict_attempts(self, payload: Any, rid: str, trace: str,
                          timeout_budget: Optional[float],
                          tracer, root) -> Any:
        import requests
        deadline = (Deadline(timeout_budget, clock=self.clock)
                    if timeout_budget is not None else None)
        sched = self.policy.schedule(deadline)
        last_err: Optional[Exception] = None
        url: Optional[str] = None
        while True:
            if deadline is not None and deadline.expired:
                raise DeadlineExceeded(
                    f"request {rid} ran out of budget") from last_err
            prev, url = url, self._pick()
            if prev is not None and url != prev:
                self.n_failovers += 1
            breaker = self.breakers.get(url)
            retry_after = None
            headers = {"X-Request-Id": rid, TRACE_HEADER: trace}
            if self.api_key is not None:
                headers["X-Api-Key"] = self.api_key
            if deadline is not None:
                headers[Deadline.HEADER] = deadline.to_header()
            # attempt 0, plus one same-worker retry after a timeout: the
            # worker may be alive-but-slow, and only ITS journal can
            # replay the reply without re-running inference
            for attempt in range(2):
                # one egress span per wire attempt; its id travels as
                # X-Parent-Span-Id so the worker's root "request" span
                # parents under THIS attempt, not just the same trace
                att = tracer.start("http_egress", parent=root,
                                   host=url)
                headers[PARENT_SPAN_HEADER] = \
                    format_span_id(att.span_id)
                try:
                    r = self._http.post(url, json=payload,
                                        timeout=self.timeout,
                                        headers=headers)
                except requests.ConnectionError as e:
                    tracer.finish(att, status="error")
                    last_err = e
                    breaker.record_failure()
                    self._dead.add(url)  # dead: fail over immediately
                    break
                except requests.Timeout as e:
                    tracer.finish(att, status="timeout")
                    last_err = e
                    continue
                except BaseException:
                    # anything else (mid-body resets, redirect loops,
                    # bad URLs) propagates to the caller — but the
                    # attempt span must still land in the recorder, or
                    # the captured trace would omit the one attempt
                    # that explains the failure
                    tracer.finish(att, status="error")
                    raise
                tracer.finish(
                    att,
                    status="shed" if r.status_code == 429 else
                    "error" if r.status_code >= 400 else "ok",
                    status_code=r.status_code)
                if r.status_code == 429 or r.status_code >= 500:
                    # shed/erroring worker: not dead, but this request
                    # should back off and go elsewhere. 504 is excluded
                    # from breaker health: a deadline-expired reply
                    # says the REQUEST's budget was too tight, not that
                    # the worker is sick — tight-budget clients must
                    # not open circuits against healthy workers
                    if r.status_code >= 500 and r.status_code != 504:
                        breaker.record_failure()
                    retry_after = r.headers.get("Retry-After")
                    last_err = requests.HTTPError(
                        f"{r.status_code} from {url}", response=r)
                    break
                breaker.record_success()
                r.raise_for_status()    # other 4xx: caller's error
                return r.json()
            else:
                # both same-worker attempts timed out
                breaker.record_failure()
                self._dead.add(url)
            if sched.give_up(retry_after):
                raise RuntimeError(
                    f"serving workers unreachable after "
                    f"{sched.attempt} attempts") from last_err
