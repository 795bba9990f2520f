"""Profiling hooks: stage timing, device traces and device vitals (the
port's copy of ``mmlspark_tpu/core/profiling.py``).

Stage timing, process vitals, the compile ledger and the MFU meter are
the JAX package's. What the JAX module asks of ``jax.profiler`` and the
runtime allocator, the port asks of ``torch.profiler`` (a Chrome trace
under the capture's ``log_dir``: the card's kernels from every thread,
the host's operators from the thread that opened the window) and of
``torch.cuda``'s caching allocator.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Dict, Iterator, Optional

#: the file a capture writes under its ``log_dir``
TRACE_FILE = "trace.json"


def _activities() -> list:
    """The host's operators, and the card's kernels when CUDA is
    present."""
    import torch
    from torch.profiler import ProfilerActivity
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return acts


@contextlib.contextmanager
def device_trace(log_dir: str) -> Iterator[None]:
    """Capture a ``torch.profiler`` trace around a block and write it to
    ``<log_dir>/trace.json`` (Chrome ``trace_event`` JSON; loads in
    Perfetto and ``chrome://tracing``)::

        with device_trace("/tmp/trace"):
            scheduler_pass()
    """
    import torch
    from torch.profiler import profile
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=_activities()) as prof:
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


@contextlib.contextmanager
def timed_span(name: str, logger=None) -> Iterator[dict]:
    """Wall-clock span that also annotates the device trace.

    Yields a dict whose ``seconds`` key is filled on exit; logs through
    the framework logger when ``logger`` is None.
    """
    from torch.profiler import record_function
    out = {"name": name, "seconds": None}
    t0 = time.perf_counter()
    with record_function(name):
        yield out
    out["seconds"] = time.perf_counter() - t0
    if logger is None:
        from mmlspark_tpu_torch.core.logs import get_logger
        logger = get_logger("profiling")
    logger.info("%s: %.3fs", name, out["seconds"])


class StageTimings:
    """Thread-safe per-stage wall-clock accumulator for hot loops.

    Where :func:`timed_span` logs one span, this aggregates millions:
    each ``span(name)`` adds one sample to the named stage's running
    count/total, and :meth:`snapshot` returns a JSON-able summary —
    the backing store for the serving data plane's per-stage timings in
    ``GET /stats``. Pure python (no torch import) so it costs nothing on
    hosts that never touch a device, and cheap enough (~1 us/span) to
    leave on in production.

    Since the unified-telemetry work this is a thin view over a
    :class:`mmlspark_tpu_torch.core.telemetry.MetricsRegistry` histogram (one
    child per stage name, millisecond log-scale buckets): the SAME
    samples back both the ``GET /stats`` snapshot and the Prometheus
    ``GET /metrics`` exposition. Pass ``registry`` to land the spans in
    a shared registry (the serving plane passes its per-server one);
    the default is a private registry, preserving the standalone
    behavior.
    """

    def __init__(self, clock: Callable[[], float] = time.perf_counter,
                 registry=None, metric: str = "stage_duration_ms"):
        from mmlspark_tpu_torch.core.telemetry import MetricsRegistry
        self._clock = clock
        self.registry = registry if registry is not None \
            else MetricsRegistry()
        self._hist = self.registry.histogram(
            metric, "Per-stage wall-clock spans.", labels=("stage",))
        self._children: Dict[str, object] = {}   # stage -> histogram child

    def _child(self, name: str):
        child = self._children.get(name)     # atomic under the GIL
        if child is None:
            child = self._children[name] = self._hist.labels(name)
        return child

    @contextlib.contextmanager
    def span(self, name: str) -> Iterator[None]:
        t0 = self._clock()
        try:
            yield
        finally:
            self._child(name).observe((self._clock() - t0) * 1000.0)

    def snapshot(self) -> Dict[str, Dict[str, float]]:
        """``{stage: {count, total_ms, mean_ms, last_ms, max_ms}}``,
        JSON-able."""
        out: Dict[str, Dict[str, float]] = {}
        for key, child in self._hist.children():
            s = child.stats()
            n = s["count"]
            out[key[0]] = {
                "count": n,
                "total_ms": round(s["sum"], 3),
                "mean_ms": round(s["sum"] / n, 4) if n else 0.0,
                "last_ms": round(s["last"], 3),
                "max_ms": round(s["max"], 3),
            }
        return out

    def reset(self) -> None:
        """Zero every stage's accumulators (chaos drills diff snapshots
        across restarts; a long-soak harness resets between phases)."""
        for _, child in self._hist.children():
            child.reset()


# -- process vitals (exported via GET /stats so chaos drills can spot
# leaks and confirm restarts) ------------------------------------------------

_PROCESS_START_MONO = time.monotonic()


def process_uptime_s() -> float:
    """Seconds since this module first loaded — effectively process
    uptime; a restarted worker's counter visibly resets."""
    return time.monotonic() - _PROCESS_START_MONO


def process_rss_bytes() -> Optional[int]:
    """Current resident set size. Linux reads ``/proc/self/status``
    (current RSS); elsewhere falls back to ``ru_maxrss`` (PEAK RSS —
    still monotone evidence for leak spotting) or None."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) * 1024
    except (OSError, ValueError, IndexError):
        pass
    try:
        import resource
        import sys
        peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        return int(peak if sys.platform == "darwin" else peak * 1024)
    except Exception:  # noqa: BLE001 — vitals are best-effort
        return None


# ---------------------------------------------------------------------------
# On-demand device profiling + always-on compute accounting
# ---------------------------------------------------------------------------

def device_memory_stats() -> Dict[str, int]:
    """Memory accounting of card 0 from the caching allocator: live
    bytes, the high-water mark since process start (or the last
    ``torch.cuda.reset_peak_memory_stats``), and the card's total
    memory. Empty dict without CUDA — callers gauge 0s, they never
    fail."""
    import torch
    if not torch.cuda.is_available():
        return {}
    stats = torch.cuda.memory_stats(0)
    return {"bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
            "peak_bytes": int(stats.get("allocated_bytes.all.peak", 0)),
            "bytes_limit": int(torch.cuda.mem_get_info(0)[1])}


class ProfilerBusy(RuntimeError):
    """A capture window is already running (one at a time, by design:
    ``torch.profiler`` runs one session per process)."""


class DeviceProfiler:
    """Guarded one-at-a-time ``torch.profiler`` capture windows.

    ``start_window`` kicks off a background daemon thread that opens a
    profiler session, sleeps the requested window, closes it and writes
    ``<log_dir>/trace.json`` — the caller (a ``POST /profile`` handler
    on the event loop) returns immediately with the target directory. A
    second request while a window is open raises :class:`ProfilerBusy`
    (the route 409s). The card's kernels land in the trace whichever
    thread launched them; the host's operators, only from the window's
    own thread.
    """

    def __init__(self, base_dir: Optional[str] = None):
        import tempfile
        import threading
        self.base_dir = base_dir or os.path.join(
            tempfile.gettempdir(), "mmlspark_tpu_torch_profiles")
        self._lock = threading.Lock()
        self._active: Optional[Dict[str, object]] = None
        self.last: Optional[Dict[str, object]] = None
        self.n_captures = 0
        self.n_errors = 0

    def start_window(self, duration_s: float = 1.0,
                     log_dir: Optional[str] = None) -> Dict[str, object]:
        """Begin one capture window; returns ``{log_dir, duration_s,
        started_unix}``. Raises :class:`ProfilerBusy` while a prior
        window is open."""
        import threading
        duration_s = float(duration_s)
        with self._lock:
            if self._active is not None:
                raise ProfilerBusy(
                    f"capture already running: {self._active}")
            if log_dir is None:
                log_dir = os.path.join(
                    self.base_dir,
                    time.strftime("%Y%m%d-%H%M%S"))
            info: Dict[str, object] = {
                "log_dir": log_dir, "duration_s": duration_s,
                "started_unix": time.time()}
            self._active = info
        t = threading.Thread(target=self._run, args=(info,),
                             daemon=True, name="device-profile")
        t.start()
        return dict(info)

    def _run(self, info: Dict[str, object]) -> None:
        try:
            with device_trace(str(info["log_dir"])):
                time.sleep(float(info["duration_s"]))  # the window
            info["trace"] = os.path.join(str(info["log_dir"]), TRACE_FILE)
            info["ok"] = True
            with self._lock:
                self.n_captures += 1
        except Exception as exc:  # noqa: BLE001 — report, don't die
            info["ok"] = False
            info["error"] = f"{type(exc).__name__}: {exc}"
            with self._lock:
                self.n_errors += 1
            from mmlspark_tpu_torch.core.logs import get_logger
            get_logger("profiling").warning(
                "device trace capture failed", exc_info=True)
        finally:
            info["finished_unix"] = time.time()
            with self._lock:
                self.last = dict(info)
                self._active = None

    @property
    def busy(self) -> bool:
        with self._lock:
            return self._active is not None

    def status(self) -> Dict[str, object]:
        with self._lock:
            return {"busy": self._active is not None,
                    "active": dict(self._active) if self._active else None,
                    "last": dict(self.last) if self.last else None,
                    "n_captures": self.n_captures,
                    "n_errors": self.n_errors,
                    "base_dir": self.base_dir}


class CompileLedger:
    """Bounded ring of compile events (a new dispatch shape = a jit
    retrace). One ``note()`` per retrace — by construction off the
    steady-state hot path, since steady state means zero retraces."""

    def __init__(self, cap: int = 64):
        import collections
        import threading
        self._events: "collections.deque" = collections.deque(
            maxlen=int(cap))
        self._lock = threading.Lock()
        self.n_events = 0

    def note(self, kind: str, shape: str, duration_ms: float,
             **extra: object) -> None:
        ev = {"kind": kind, "shape": shape,
              "duration_ms": round(float(duration_ms), 3),
              "at_unix": round(time.time(), 3)}
        ev.update(extra)
        with self._lock:
            self._events.append(ev)
            self.n_events += 1

    def events(self) -> list:
        with self._lock:
            return list(self._events)

    def snapshot(self) -> Dict[str, object]:
        with self._lock:
            return {"n_events": self.n_events,
                    "events": list(self._events)}



#: peak dense bf16 TFLOP/s per card, by the name torch reports for it
#: (``torch.cuda.get_device_name``) — the MFU denominator (NVIDIA's data
#: sheet, SXM part, without sparsity; unknown kinds report flops/s
#: without a utilization ratio)
_PEAK_BF16_TFLOPS: Dict[str, float] = {
    "NVIDIA H100 80GB HBM3": 989.0,
}


class MfuMeter:
    """Always-on per-bucket MFU estimation.

    ``note(bucket, seconds, flops)`` accumulates dispatch wall-clock
    per shape bucket and, when the model exposes a flops count for the
    bucket (``dispatch_flops(df)`` hook or ``cost_analysis``), keeps an
    EWMA of achieved flops/s and its ratio to the card's peak. Without
    flops it still reports per-bucket seconds — the time side of the
    accounting is never conditional on the model cooperating.
    """

    def __init__(self, peak_tflops: Optional[float] = None,
                 alpha: float = 0.2):
        import threading
        self._lock = threading.Lock()
        self.alpha = float(alpha)
        self.peak_flops: Optional[float] = (
            peak_tflops * 1e12 if peak_tflops is not None else None)
        self.device_kind: Optional[str] = None
        if peak_tflops is None:
            try:
                from mmlspark_tpu_torch.core.environment import (
                    environment_info,
                )
                kind = environment_info().get("device_kind")
                self.device_kind = kind
                peak = _PEAK_BF16_TFLOPS.get(str(kind))
                if peak is not None:
                    self.peak_flops = peak * 1e12
            except Exception:  # noqa: BLE001 — accounting is optional
                pass
        self._buckets: Dict[object, Dict[str, float]] = {}

    def note(self, bucket: object, seconds: float,
             flops: Optional[float] = None) -> None:
        with self._lock:
            row = self._buckets.get(bucket)
            if row is None:
                row = self._buckets[bucket] = {
                    "count": 0, "seconds": 0.0, "flops_per_s": None}
            row["count"] += 1
            row["seconds"] += float(seconds)
            if flops and seconds > 0:
                achieved = float(flops) / float(seconds)
                prev = row["flops_per_s"]
                row["flops_per_s"] = (
                    achieved if prev is None
                    else prev + self.alpha * (achieved - prev))

    def snapshot(self) -> Dict[str, object]:
        with self._lock:
            buckets = {}
            for bucket, row in self._buckets.items():
                out = {"count": int(row["count"]),
                       "seconds": round(row["seconds"], 4)}
                fps = row["flops_per_s"]
                if fps is not None:
                    out["tflops_per_s"] = round(fps / 1e12, 3)
                    if self.peak_flops:
                        out["mfu"] = round(fps / self.peak_flops, 4)
                buckets[str(bucket)] = out
            return {"device_kind": self.device_kind,
                    "peak_tflops": (round(self.peak_flops / 1e12, 1)
                                    if self.peak_flops else None),
                    "buckets": buckets}
