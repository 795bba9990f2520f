"""Anomaly-triggered incident capture: the second half of the
postmortem plane (the port's copy of ``mmlspark_tpu/serving/incident.py``).

The worker has *detectors* — SLO burn-rate alerting
(serving/slo.py) and TSDB anomaly detection (core/tsdb.py) — whose
transitions already ride one notifier channel. This module subscribes
an :class:`IncidentManager` to that channel: on every ``pending ->
firing`` transition it snapshots a correlated evidence bundle to
``incidents/<id>/`` while the evidence still exists — the slow traces
before the flight recorder rotates them out, the CPU profile window
*around* the firing instant (the always-on sampler in
core/profiler.py means the history is already in memory), the violated
series, the log ring, and the worker's stats surfaces.

Capture correctness rules:

* **Never on the hot path.** :meth:`IncidentManager.notify` is called
  under the SLO engine's / anomaly detector's evaluation locks; it only
  enqueues (bounded queue, drops + counts when full) — all file I/O,
  range queries and trace serialization happen on one dedicated
  ``incident-capture`` daemon thread.
* **No races with the finishing alert.** Capture works exclusively
  from the *transition event payload* (an immutable snapshot taken at
  fire time) plus point-in-time snapshots of the trace store / TSDB /
  log ring taken at capture start — it never reads live alert-state
  machines, so an alert that resolves mid-capture cannot corrupt the
  bundle.
* **Detectably complete.** ``manifest.json`` — the trigger plus a
  SHA-256 digest of every artifact — is written LAST (tmp + rename,
  the PR-7 checkpoint idiom): a bundle interrupted by a crash has no
  manifest and surfaces as ``complete: false``.
* **Bounded.** One bundle per alert per ``cooldown_s`` (suppressed
  captures are counted, not queued), and at most ``max_incidents``
  bundles on disk (oldest evicted after each capture).

Read side: ``GET /incidents`` (list), ``GET /incidents/<id>``
(manifest + file inventory), ``GET /incidents/<id>/<artifact>`` (raw
file) on every worker — both frontends, same route table — and
coordinator ``GET /fleet/incidents`` fan-out with worker attribution
(dead workers degrade to an errors entry). ``tools/trace_dump.py
--incidents [--fetch <id>]`` is the terminal client.
"""

from __future__ import annotations

import hashlib
import json
import os
import queue
import shutil
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

from mmlspark_tpu_torch.core.logs import get_logger
from mmlspark_tpu_torch.core.resilience import Clock, SYSTEM_CLOCK

logger = get_logger("serving.incident")

#: artifact filenames a bundle may contain (also the route whitelist
#: for ``GET /incidents/<id>/<artifact>`` — nothing outside this set is
#: ever served, so the path segment cannot traverse).
BUNDLE_FILES = ("alert.json", "series.json", "traces.json",
                "logs.json", "stats.json", "profile.collapsed",
                "profile.trace.json", "profile.json", "manifest.json")


def _slug(name: str, max_len: int = 48) -> str:
    out = "".join(c if (c.isalnum() or c in "-_") else "-"
                  for c in str(name))
    return (out or "alert")[:max_len]


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(65536), b""):
            h.update(chunk)
    return h.hexdigest()


class FanoutNotifier:
    """Deliver each alert transition to several sinks (the webhook
    :class:`~mmlspark_tpu_torch.serving.slo.AlertNotifier` and the
    :class:`IncidentManager`). One sink raising never starves another;
    ``status()`` merges the children so ``GET /slo`` keeps working."""

    def __init__(self, *sinks: Any):
        self.sinks = [s for s in sinks if s is not None]

    def notify(self, event: Dict[str, Any]) -> None:
        for sink in self.sinks:
            try:
                sink.notify(event)
            except Exception:
                logger.exception("alert sink %r failed",
                                 type(sink).__name__)

    def status(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {"sinks": len(self.sinks)}
        for sink in self.sinks:
            st = getattr(sink, "status", None)
            if callable(st):
                try:
                    out[type(sink).__name__] = st()
                except Exception:
                    pass
        return out


class IncidentManager:
    """Capture one evidence bundle per firing alert, bounded and
    rate-limited. Dependencies are injected (store / tracer / profiler
    / log ring / stats callback) so tests exercise the capture path
    without a server."""

    def __init__(self, base_dir: str, *,
                 tsdb: Any = None,
                 tracer: Any = None,
                 profiler: Any = None,
                 log_ring: Any = None,
                 stats_fn: Optional[Callable[[], Dict[str, Any]]] = None,
                 related_exprs: Sequence[str] = (),
                 cooldown_s: float = 300.0,
                 max_incidents: int = 16,
                 profile_pre_s: float = 60.0,
                 profile_post_s: float = 30.0,
                 lookback_s: float = 600.0,
                 series_step_s: float = 10.0,
                 max_traces: int = 8,
                 queue_cap: int = 64,
                 clock: Clock = SYSTEM_CLOCK):
        self.base_dir = str(base_dir)
        self.tsdb = tsdb
        self.tracer = tracer
        self.profiler = profiler
        self.log_ring = log_ring
        self.stats_fn = stats_fn
        self.related_exprs = list(related_exprs)
        self.cooldown_s = float(cooldown_s)
        self.max_incidents = int(max_incidents)
        self.profile_pre_s = float(profile_pre_s)
        self.profile_post_s = float(profile_post_s)
        self.lookback_s = float(lookback_s)
        self.series_step_s = float(series_step_s)
        self.max_traces = int(max_traces)
        self.clock = clock
        self._queue: "queue.Queue" = queue.Queue(maxsize=int(queue_cap))
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._busy = False
        self._lock = threading.Lock()
        self._last_capture: Dict[str, float] = {}  # policy -> mono ts
        self._seq = 0
        self._recent: List[Dict[str, Any]] = []    # last transitions
        self.n_captured = 0
        self.n_suppressed = 0
        self.n_dropped = 0
        self.n_evicted = 0
        self.n_failed = 0
        self.last_id: Optional[str] = None
        os.makedirs(self.base_dir, exist_ok=True)

    # -- the notifier-channel contract --------------------------------

    def notify(self, event: Dict[str, Any]) -> None:
        """Alert-transition sink. Called under the emitting engine's
        evaluation lock — MUST NOT block: firing transitions are
        enqueued for the capture thread, resolved transitions only
        update the recent-transitions log."""
        with self._lock:
            self._recent.append({k: event.get(k) for k in
                                 ("type", "policy", "slo_kind",
                                  "at_unix")})
            del self._recent[:-32]
        if event.get("type") != "firing":
            return
        try:
            self._queue.put_nowait(dict(event))
        except queue.Full:
            self.n_dropped += 1

    # -- lifecycle ----------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="incident-capture")
        self._thread.start()

    def stop(self) -> None:
        t = self._thread
        if t is None:
            return
        self._stop.set()
        try:
            self._queue.put_nowait(None)       # wake the worker
        except queue.Full:
            pass
        t.join(timeout=10.0)
        self._thread = None

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                event = self._queue.get(timeout=0.5)
            except queue.Empty:
                continue
            if event is None:
                continue
            self._busy = True
            try:
                self.capture(event)
            except Exception:
                self.n_failed += 1
                logger.exception("incident capture failed")
            finally:
                self._busy = False

    def wait_idle(self, timeout: float = 10.0) -> bool:
        """Block (REAL time) until the queue is drained and no capture
        is in flight — test/drill synchronization, not a prod API."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self._queue.empty() and not self._busy:
                return True
            time.sleep(0.005)
        return False

    # -- capture ------------------------------------------------------

    def capture(self, event: Dict[str, Any]) -> Optional[str]:
        """Capture one bundle for a firing transition; returns the
        incident id, or None when suppressed by the cooldown. Runs on
        the capture thread (or synchronously from tests)."""
        policy = str(event.get("policy", "unknown"))
        now = self.clock.now()
        last = self._last_capture.get(policy)
        if last is not None and (now - last) < self.cooldown_s:
            self.n_suppressed += 1
            return None
        # stamp BEFORE the (slow) capture so a burst of transitions
        # inside one cooldown window cannot double-capture
        self._last_capture[policy] = now

        at_mono = float(event.get("at_mono", now))
        at_unix = float(event.get("at_unix", time.time()))
        self._seq += 1
        inc_id = (f"inc-{int(at_unix * 1000):013d}-{self._seq:03d}-"
                  f"{_slug(policy)}")
        inc_dir = os.path.join(self.base_dir, inc_id)
        os.makedirs(inc_dir, exist_ok=True)

        def _write_json(name: str, payload: Any) -> None:
            with open(os.path.join(inc_dir, name), "w") as f:
                json.dump(payload, f, indent=1, default=str)

        # 1) immediate evidence — snapshot while it still exists
        _write_json("alert.json", event)
        _write_json("series.json", self._capture_series(event, at_mono))
        _write_json("traces.json", self._capture_traces())
        _write_json("logs.json", self._capture_logs())
        _write_json("stats.json", self._capture_stats())
        # 2) the profile window [firing - pre, firing + post]: wait for
        # the post-window to elapse so the bundle shows the regression
        # *in progress*, then dump
        self._wait_until(at_mono + self.profile_post_s)
        self._capture_profile(inc_dir, at_mono)
        # 3) manifest LAST — digests over everything above; a bundle
        # without one is detectably incomplete
        files: Dict[str, Dict[str, Any]] = {}
        for name in sorted(os.listdir(inc_dir)):
            path = os.path.join(inc_dir, name)
            if name == "manifest.json" or not os.path.isfile(path):
                continue
            files[name] = {"sha256": _sha256(path),
                           "bytes": os.path.getsize(path)}
        manifest = {
            "id": inc_id,
            "trigger": {k: event.get(k) for k in
                        ("type", "policy", "slo_kind", "objective",
                         "expr", "value", "z", "direction", "at_unix",
                         "at_mono") if k in event},
            "at_unix": at_unix,
            "at_mono": at_mono,
            "profile_window": {"start": at_mono - self.profile_pre_s,
                               "end": at_mono + self.profile_post_s},
            "files": files,
            "complete": True,
        }
        tmp = os.path.join(inc_dir, ".manifest.tmp")
        with open(tmp, "w") as f:
            json.dump(manifest, f, indent=1, default=str)
        os.replace(tmp, os.path.join(inc_dir, "manifest.json"))
        self.n_captured += 1
        self.last_id = inc_id
        logger.warning("incident %s captured (policy=%s, %d files)",
                       inc_id, policy, len(files))
        self._evict()
        return inc_id

    def _wait_until(self, t: float) -> None:
        """Wait (stoppably) until the injected clock reaches ``t`` —
        polls so a ManualClock advanced by a test thread releases it."""
        while not self._stop.is_set() and self.clock.now() < t:
            self._stop.wait(0.005)

    def _capture_series(self, event: Dict[str, Any],
                        at_mono: float) -> Dict[str, Any]:
        if self.tsdb is None:
            return {"series": {}, "note": "no tsdb configured"}
        exprs = list(self.related_exprs)
        own = event.get("expr")
        if own and own not in exprs:
            exprs.append(own)
        out: Dict[str, Any] = {}
        # clamp: a small monotonic timestamp (ManualClock starting at
        # 0) must not go negative — query_range reads negative start
        # as end-relative
        start = max(0.0, at_mono - self.lookback_s)
        for expr in exprs:
            try:
                out[expr] = self.tsdb.query_range(
                    expr, start=start, end=None,
                    step=self.series_step_s)
            except Exception as exc:
                out[expr] = {"error": str(exc)}
        return {"lookback_s": self.lookback_s, "series": out}

    def _capture_traces(self) -> Dict[str, Any]:
        if self.tracer is None:
            return {"traces": []}
        from mmlspark_tpu_torch.core.tracing import to_perfetto
        summaries = self.tracer.traces(slow_only=False)
        # errors first, then slowest — the traces an operator opens
        summaries.sort(key=lambda s: (s.get("status") == "ok",
                                      -float(s.get("duration_ms", 0))))
        picked = summaries[:self.max_traces]
        out = []
        for s in picked:
            entry: Dict[str, Any] = {"summary": s}
            raw = self.tracer.get_trace(s.get("trace_id"))
            if raw is not None:
                try:
                    entry["perfetto"] = to_perfetto(raw)
                except Exception as exc:
                    entry["perfetto_error"] = str(exc)
            out.append(entry)
        return {"retained": len(summaries), "traces": out}

    def _capture_logs(self) -> Dict[str, Any]:
        if self.log_ring is None:
            return {"records": []}
        return {"status": self.log_ring.status(),
                "records": self.log_ring.records()}

    def _capture_stats(self) -> Dict[str, Any]:
        if self.stats_fn is None:
            return {}
        try:
            return self.stats_fn()
        except Exception as exc:
            return {"error": str(exc)}

    def _capture_profile(self, inc_dir: str, at_mono: float) -> None:
        if self.profiler is None:
            return
        t0 = at_mono - self.profile_pre_s
        t1 = at_mono + self.profile_post_s
        counts = self.profiler.collapsed_between(t0, t1)
        lines = [f"{stack} {n}" for stack, n in
                 sorted(counts.items(), key=lambda kv: (-kv[1], kv[0]))]
        with open(os.path.join(inc_dir, "profile.collapsed"), "w") as f:
            f.write("\n".join(lines) + ("\n" if lines else ""))
        with open(os.path.join(inc_dir, "profile.trace.json"),
                  "w") as f:
            json.dump(self.profiler.chrome_trace_between(t0, t1), f)
        with open(os.path.join(inc_dir, "profile.json"), "w") as f:
            json.dump(self.profiler.profile_between(t0, t1), f,
                      indent=1)

    def _evict(self) -> None:
        """Drop the oldest bundles beyond ``max_incidents`` (ids are
        unix-millisecond-prefixed, so name order is capture order)."""
        try:
            dirs = sorted(d for d in os.listdir(self.base_dir)
                          if os.path.isdir(
                              os.path.join(self.base_dir, d)))
        except OSError:
            return
        while len(dirs) > self.max_incidents:
            victim = dirs.pop(0)
            shutil.rmtree(os.path.join(self.base_dir, victim),
                          ignore_errors=True)
            self.n_evicted += 1

    # -- read side ----------------------------------------------------

    def list(self) -> List[Dict[str, Any]]:
        """Bundle inventory, newest first. A bundle without a manifest
        (capture in flight, or interrupted) reports
        ``complete: false``."""
        out: List[Dict[str, Any]] = []
        try:
            dirs = sorted((d for d in os.listdir(self.base_dir)
                           if os.path.isdir(
                               os.path.join(self.base_dir, d))),
                          reverse=True)
        except OSError:
            return out
        for d in dirs:
            manifest = self._read_manifest(d)
            if manifest is None:
                out.append({"id": d, "complete": False})
                continue
            files = manifest.get("files", {})
            out.append({
                "id": d,
                "policy": manifest.get("trigger", {}).get("policy"),
                "slo_kind": manifest.get("trigger", {}).get("slo_kind"),
                "at_unix": manifest.get("at_unix"),
                "complete": bool(manifest.get("complete")),
                "n_files": len(files),
                "bytes": sum(int(v.get("bytes", 0))
                             for v in files.values()),
            })
        return out

    def get(self, inc_id: str) -> Optional[Dict[str, Any]]:
        """Manifest + on-disk file inventory for one bundle, or None
        for an unknown / path-hostile id."""
        inc_dir = self._safe_dir(inc_id)
        if inc_dir is None:
            return None
        manifest = self._read_manifest(inc_id)
        present = sorted(f for f in os.listdir(inc_dir)
                         if os.path.isfile(os.path.join(inc_dir, f))
                         and not f.startswith("."))
        return {"id": inc_id,
                "complete": bool(manifest and manifest.get("complete")),
                "manifest": manifest, "present": present}

    def artifact(self, inc_id: str, name: str
                 ) -> Optional[Dict[str, Any]]:
        """One raw bundle file (whitelisted names only); ``None`` when
        the bundle or artifact doesn't exist."""
        if name not in BUNDLE_FILES:
            return None
        inc_dir = self._safe_dir(inc_id)
        if inc_dir is None:
            return None
        path = os.path.join(inc_dir, name)
        if not os.path.isfile(path):
            return None
        with open(path, "rb") as f:
            body = f.read()
        ctype = ("application/json" if name.endswith(".json")
                 else "text/plain; charset=utf-8")
        return {"body": body, "content_type": ctype}

    def _safe_dir(self, inc_id: str) -> Optional[str]:
        if (not inc_id or "/" in inc_id or "\\" in inc_id
                or inc_id.startswith(".")):
            return None
        inc_dir = os.path.join(self.base_dir, inc_id)
        return inc_dir if os.path.isdir(inc_dir) else None

    def _read_manifest(self, inc_id: str) -> Optional[Dict[str, Any]]:
        path = os.path.join(self.base_dir, inc_id, "manifest.json")
        try:
            with open(path) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def status(self) -> Dict[str, Any]:
        with self._lock:
            recent = list(self._recent[-8:])
        return {
            "dir": self.base_dir,
            "running": self._thread is not None,
            "captured": self.n_captured,
            "suppressed_cooldown": self.n_suppressed,
            "dropped_queue_full": self.n_dropped,
            "evicted": self.n_evicted,
            "failed": self.n_failed,
            "cooldown_s": self.cooldown_s,
            "max_incidents": self.max_incidents,
            "last_id": self.last_id,
            "recent_transitions": recent,
        }
