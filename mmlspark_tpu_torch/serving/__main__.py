"""Runnable serving entrypoints for containers/orchestrators (the port's
copy of ``mmlspark_tpu/serving/__main__.py``).

``python -m mmlspark_tpu_torch.serving coordinator`` — the fleet
registry (`serving.ServingCoordinator`); ``python -m
mmlspark_tpu_torch.serving worker`` — load a persisted pipeline/
transformer of the port from ``$MODEL_URI`` (any io.fs path), serve it
(`serving.ServingServer`) on the card, and register ``$POD_IP:$PORT``
with ``$COORDINATOR_URL``. The readiness probe hits the server's
``GET /readyz`` (drain-aware), liveness ``GET /healthz``, counters
``GET /status``, Prometheus exposition ``GET /metrics`` (or the
coordinator's ``GET /fleet/metrics`` for the merged fleet).
``MMLSPARK_TPU_LOGGING_FORMAT=json`` switches workers to structured
JSON logs with per-request trace ids. SIGTERM triggers the server's
graceful drain (``ServingServer.stop``), so a pod delete finishes its
accepted requests before the listener closes.

The worker runs its stages on the card and fails without CUDA;
``MMLSPARK_TPU_SERVING_CPU=1`` asks for ``device="cpu"`` on every stage
it loads (its boot model and every version a rollout stages).

Environment:
  PORT             listen port (default 8000)
  MODEL_URI        (worker) persisted stage directory to serve
  COORDINATOR_URL  (worker, optional) http://host:port to register with
  POD_IP           (worker, optional) address advertised to the
                   coordinator; defaults to the local hostname
  MAX_BATCH_SIZE / MAX_LATENCY_MS / JOURNAL_SIZE / JOURNAL_TTL /
  MAX_QUEUE        (worker, optional) ServingServer knobs (MAX_QUEUE
                   bounds the accepted-request backlog: beyond it new
                   requests shed with 429 + Retry-After, see
                   docs/resilience.md)
  PIPELINE / BUCKET_BATCHES / ENCODER_THREADS
                   (worker, optional) data-plane knobs: PIPELINE=0
                   falls back to the serial plane, BUCKET_BATCHES=0
                   disables shape-bucket padding (models then see exact
                   live batch sizes, at the cost of per-size jit
                   retraces), ENCODER_THREADS sizes the reply-encoder
                   pool — see docs/serving.md "The data plane"
  BATCH_POLICY     (worker, optional) "adaptive" decides the batch-
                   mate wait per batch from the live arrival rate +
                   per-bucket dispatch latencies (MAX_LATENCY_MS
                   becomes the hard ceiling); default "fixed" keeps
                   the constant knob — docs/serving.md "Adaptive
                   batching"
  WARMUP_PAYLOAD   (worker, optional) a JSON example payload; when set,
                   the worker dispatches one synthetic batch per shape
                   bucket (ServingServer.warmup) BEFORE registering
                   with the coordinator, so no live request ever pays a
                   jit compile — without it the first request at each
                   bucket size traces on the serving path
  JOURNAL_PATH     (worker, optional) durable replay-journal file (any
                   io.fs path — mount a PVC and point this at it, or
                   gs://...): committed replies survive pod restarts,
                   reported as ``journal_recovered`` in GET /status
  SLOW_TRACE_MS    (worker, optional) tail-capture threshold for this
                   worker's route (default 250): requests slower than
                   this — or that end in error/shed/deadline — retain
                   their span tree at ``GET /trace/<id>`` (Perfetto
                   export via ``?format=perfetto``; 0 captures every
                   request — see docs/observability.md "Tracing")
  ADAPTIVE_SLOW_TRACE
                   (worker, optional) 0 pins the tail-capture
                   threshold at SLOW_TRACE_MS forever; by default
                   (1) the threshold tracks the route's own dispatch-
                   latency p95 (floor/ceiling clamped) once enough
                   samples accumulate — see docs/observability.md
                   "Distributed tracing"
  FRONTEND         (both, optional) the socket edge: "eventloop" (the
                   default — selectors-based keep-alive frontend, see
                   docs/serving.md "The socket edge") or "threaded"
                   (the thread-per-connection http.server baseline)
  ACCEPTORS        (worker, optional) number of SO_REUSEPORT accept/
                   event loops sharing the port (default 1). Raise it
                   when /metrics shows serving_accept_loop_busy_ratio
                   pinned near 1.0; setting it > 1 implies REUSE_PORT=1
                   unless REUSE_PORT=0 is forced (which then fails
                   fast at startup)
  IDLE_TIMEOUT     (worker, optional) seconds a keep-alive connection
                   may sit idle between requests (default 60; also the
                   slow-loris mid-request reap clock; 0 disables)
  MODEL_VERSION    (worker, optional) the version label of the model
                   served at boot (default "v1") — the zero-downtime
                   rollout machinery stages/flips later versions via
                   POST /rollout/{stage,flip,rollback,abort} and
                   GET /version; see docs/serving.md "Zero-downtime
                   rollout"
  VERIFY_CHECKPOINTS
                   (worker, optional) 0 disables the strict digest
                   verification a staged checkpoint must pass before
                   it is flip-eligible (leave on: a truncated or
                   corrupt checkpoint must never go live)
  MAX_CONNS_PER_IP (worker, optional) per-peer-address concurrent
                   connection cap at the socket edge: accepts beyond
                   it get an immediate 429 + close (0 = off; a
                   shedding layer in front of MAX_QUEUE)
  MAX_PIPELINED_PER_ITER
                   (worker, optional) HTTP/1.1 pipelining fairness
                   cap: buffered pipelined requests served per
                   connection per event-loop pass (default 16; one
                   flooding connection cannot monopolize a loop)
  TLS_CERT / TLS_KEY
                   (worker, optional) PEM certificate chain + private
                   key: the event-loop edge terminates TLS itself
                   (non-blocking handshakes in the connection state
                   machine — docs/serving.md "TLS at the edge"), so
                   the worker is internet-facing without a fronting
                   proxy. Both or neither; requires FRONTEND=eventloop
  QUANTIZATION     (worker, optional) a JSON QuantizationConfig for
                   the boot model version, e.g.
                   '{"wire_dtype": "uint8", "scale": 0.0039}': request
                   payloads are cast to the wire dtype at dispatch and
                   dequantized on device — docs/serving.md "The
                   quantized wire". Malformed configs fail startup
  CAPTURE_DIR      (worker, optional) opt-in traffic capture: committed
                   request/reply rows (plus sampled shadow-diff rows
                   during rollouts) journal into rotating JSON-line
                   segments under this directory — the feedstock of
                   the retrain loop (docs/streaming.md). Bounded and
                   non-blocking: a slow disk drops sampled batches,
                   never delays replies
  CAPTURE_SAMPLE_EVERY / CAPTURE_MAX_SEGMENTS / CAPTURE_SEGMENT_BYTES
                   (worker, optional) capture knobs: sample every Nth
                   committed batch (default 1 = all), keep at most N
                   segments (default 64) of at most N bytes each
                   (default 4 MiB)
  PUSH_GATEWAY_URL / PUSH_INTERVAL_S
                   (worker, optional) remote-write: POST the worker's
                   metrics exposition (per-server + process registry)
                   to this URL every PUSH_INTERVAL_S seconds (default
                   30) through the resilient HTTP client, with a
                   final flush on shutdown — telemetry for fleets
                   without a scraping Prometheus
  PROFILER_HZ      (worker, optional) the always-on sampling CPU
                   profiler's rate (default 50; served at
                   ``GET /profile/cpu``, windows/diffs over a bounded
                   in-memory ring — docs/observability.md "The
                   postmortem plane"). ``0`` or ``false`` disables
                   the sampler entirely
  INCIDENTS_DIR    (worker, optional) directory for anomaly-triggered
                   incident bundles: when set, every SLO/anomaly
                   firing transition snapshots alert + series +
                   traces + profile window + logs + stats to
                   ``<dir>/<id>/`` (bounded retention, one bundle per
                   alert per cooldown; ``GET /incidents`` lists them,
                   the coordinator merges the fleet at
                   ``GET /fleet/incidents``). Unset, ``0`` or
                   ``false`` disables capture — nothing is written
  INCIDENT_COOLDOWN_S / INCIDENT_MAX
                   (worker, optional) incident-capture knobs: minimum
                   seconds between bundles for the same alert
                   (default 300) and the on-disk bundle cap (default
                   16, oldest evicted)
"""

import os
import signal
import socket
import sys
import threading
import time


def _env_float(name, default):
    v = os.environ.get(name)
    return default if v in (None, "") else float(v)


def _json_env(name):
    v = os.environ.get(name)
    if v in (None, ""):
        return None
    import json
    return json.loads(v)


def run_coordinator() -> None:
    from mmlspark_tpu_torch.serving.server import ServingCoordinator
    port = int(os.environ.get("PORT", "8000"))
    stale = _env_float("STALE_AFTER", 0.0)   # 0 = never expire
    coord = ServingCoordinator(
        host="0.0.0.0", port=port, stale_after=stale or None,
        frontend=os.environ.get("FRONTEND", "eventloop")).start()
    print(f"[serving] coordinator listening on :{coord.port}", flush=True)
    _wait_forever(coord.stop)


def run_worker() -> None:
    from mmlspark_tpu_torch.core.stage import PipelineStage
    from mmlspark_tpu_torch.serving.server import (
        ServingCoordinator, ServingServer)

    uri = os.environ.get("MODEL_URI")
    if not uri:
        raise SystemExit("worker needs MODEL_URI (a persisted stage dir)")
    model = PipelineStage.load(uri)
    port = int(os.environ.get("PORT", "8000"))
    ttl = _env_float("JOURNAL_TTL", 0.0)
    acceptors = int(_env_float("ACCEPTORS", 1))
    capture = None
    capture_dir = os.environ.get("CAPTURE_DIR")
    if capture_dir:
        from mmlspark_tpu_torch.serving.capture import TrafficCapture
        capture = TrafficCapture(
            capture_dir,
            sample_every=int(_env_float("CAPTURE_SAMPLE_EVERY", 1)),
            max_segments=int(_env_float("CAPTURE_MAX_SEGMENTS", 64)),
            max_segment_bytes=int(
                _env_float("CAPTURE_SEGMENT_BYTES", 4 << 20)))
        print(f"[serving] capturing traffic to {capture_dir}",
              flush=True)
    srv = ServingServer(
        model, host="0.0.0.0", port=port,
        max_batch_size=int(_env_float("MAX_BATCH_SIZE", 64)),
        max_latency_ms=_env_float("MAX_LATENCY_MS", 10.0),
        journal_size=int(_env_float("JOURNAL_SIZE", 4096)),
        journal_ttl=ttl if ttl > 0 else None,
        journal_path=os.environ.get("JOURNAL_PATH") or None,
        max_queue=int(_env_float("MAX_QUEUE", 1024)),
        pipeline=_env_float("PIPELINE", 1) != 0,
        bucket_batches=_env_float("BUCKET_BATCHES", 1) != 0,
        encoder_threads=int(_env_float("ENCODER_THREADS", 2)),
        slow_trace_ms=_env_float("SLOW_TRACE_MS", 250.0),
        adaptive_slow_trace=_env_float("ADAPTIVE_SLOW_TRACE", 1) != 0,
        frontend=os.environ.get("FRONTEND", "eventloop"),
        acceptors=acceptors,
        # ACCEPTORS > 1 needs SO_REUSEPORT (N loops cannot share one
        # listener); default it on so the one knob is enough
        reuse_port=_env_float("REUSE_PORT",
                              1 if acceptors > 1 else 0) != 0,
        idle_timeout=_env_float("IDLE_TIMEOUT", 60.0),
        max_conns_per_ip=int(_env_float("MAX_CONNS_PER_IP", 0)),
        max_pipelined_per_iter=int(
            _env_float("MAX_PIPELINED_PER_ITER", 16)),
        model_version=os.environ.get("MODEL_VERSION", "v1"),
        verify_checkpoints=_env_float("VERIFY_CHECKPOINTS", 1) != 0,
        batch_policy=os.environ.get("BATCH_POLICY", "fixed"),
        capture=capture,
        tls_cert=os.environ.get("TLS_CERT") or None,
        tls_key=os.environ.get("TLS_KEY") or None,
        quantization=(_json_env("QUANTIZATION")),
        # TSDB=0 disables the retrospective plane; a JSON dict
        # overrides its knobs (interval_s, tiers, snapshot_dir,
        # rules, watches, ...); unset = the stock plane
        tsdb=(False if os.environ.get("TSDB") in ("0", "false")
              else _json_env("TSDB")),
        # PROFILER_HZ=0/false disables the always-on sampler; any
        # other value overrides the 50 hz default
        cpu_profiler=(False
                      if os.environ.get("PROFILER_HZ") in ("0", "false")
                      else ({"hz": _env_float("PROFILER_HZ", 50.0)}
                            if os.environ.get("PROFILER_HZ")
                            else None)),
        # INCIDENTS_DIR enables anomaly-triggered incident capture
        incidents=(None
                   if os.environ.get("INCIDENTS_DIR") in (None, "", "0",
                                                          "false")
                   else {"dir": os.environ["INCIDENTS_DIR"],
                         "cooldown_s": _env_float(
                             "INCIDENT_COOLDOWN_S", 300.0),
                         "max_incidents": int(_env_float(
                             "INCIDENT_MAX", 16))}))
    warm = os.environ.get("WARMUP_PAYLOAD")
    if warm:
        # warm BEFORE start(): the socket is already bound (early
        # connects sit in the accept backlog), but no handler/executor
        # thread is live yet, so warmup's model calls can never run
        # concurrently with a real dispatch — and every bucket is
        # compiled before the first request is read
        import json as _json
        sizes = srv.warmup(_json.loads(warm))
        print(f"[serving] warmed buckets {sizes}", flush=True)
    srv.start()
    print(f"[serving] worker serving {uri} on :{srv.port}", flush=True)

    pusher = None
    push_url = os.environ.get("PUSH_GATEWAY_URL")
    if push_url:
        from mmlspark_tpu_torch.core.telemetry import REGISTRY, MetricsPusher
        pusher = MetricsPusher(
            push_url, registries=(srv.registry, REGISTRY),
            interval_s=_env_float("PUSH_INTERVAL_S", 30.0)).start()
        print(f"[serving] pushing metrics to {push_url}", flush=True)

    coord_url = os.environ.get("COORDINATOR_URL")
    if coord_url:
        ip = os.environ.get("POD_IP") or socket.gethostbyname(
            socket.gethostname())
        ServingCoordinator.register_worker(coord_url, ip, srv.port)
        print(f"[serving] registered {ip}:{srv.port} with {coord_url}",
              flush=True)

        # periodic re-register: registration is idempotent, so this is
        # a heartbeat that repopulates a restarted (in-memory-registry)
        # coordinator without operator intervention
        def heartbeat():
            interval = float(os.environ.get("REGISTER_INTERVAL", "10"))
            while True:
                time.sleep(interval)
                try:
                    ServingCoordinator.register_worker(coord_url, ip,
                                                       srv.port)
                except Exception:  # noqa: BLE001 — coordinator down;
                    pass           # keep serving, retry next tick

        threading.Thread(target=heartbeat, daemon=True).start()

    def shutdown():
        # drain first (accepted requests finish), then flush the final
        # metrics push so the gateway sees the worker's terminal counts
        srv.stop()
        if pusher is not None:
            pusher.stop()

    _wait_forever(shutdown)


def _wait_forever(stop) -> None:
    done = threading.Event()

    def handler(signum, frame):
        done.set()

    signal.signal(signal.SIGTERM, handler)
    signal.signal(signal.SIGINT, handler)
    done.wait()
    stop()


def main() -> None:
    if os.environ.get("MMLSPARK_TPU_SERVING_CPU") == "1":
        # an explicit request for the CPU: every stage this process
        # loads (the boot model, rollout versions) takes device="cpu"
        from mmlspark_tpu_torch.core.serialize import (
            set_default_load_device)
        set_default_load_device("cpu")
    role = sys.argv[1] if len(sys.argv) > 1 else ""
    if role == "coordinator":
        run_coordinator()
    elif role == "worker":
        run_worker()
    else:
        raise SystemExit(
            "usage: python -m mmlspark_tpu_torch.serving "
            "coordinator|worker")


if __name__ == "__main__":
    main()
