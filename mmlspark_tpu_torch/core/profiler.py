"""Always-on sampling CPU profiler: the first half of the postmortem plane.

The port's copy of ``mmlspark_tpu/core/profiler.py``. The SLO engine and
the TSDB's anomaly watches are the *detectors*; this module captures the
*evidence*.
A background daemon thread samples ``sys._current_frames()`` at a
configurable rate (default 50 hz) into a bounded ring of collapsed
stacks, so that when something fires the CPU history around the firing
instant is already in memory — no "reproduce it with a profiler
attached" step.

Design constraints, in order:

* **Bounded and cheap.** Stacks are interned (each distinct collapsed
  stack is stored once; the ring holds small integer ids), the ring is
  a ``deque(maxlen=...)`` sized to ``hz * retention_s`` samples, and the
  intern table is capped — a pathological workload degrades to an
  ``<overflow>`` bucket, never to unbounded memory. The per-sample cost
  is perf-gated in ``tests/test_postmortem.py`` and the end-to-end rps
  overhead in ``bench.py profiler_overhead_v1`` (<3%).
* **Stage attribution.** The serving data plane names its threads
  (``serving-collector``, ``serving-executor``, ``serving-encoder-N``,
  ``decode-scheduler``, ``tsdb-recorder``, ...); samples are bucketed
  into pipeline *stages* by thread-name prefix, so a profile answers
  "which stage is burning CPU" before you read a single frame.
* **Windowed queries.** Every sample is timestamped by an injectable
  :class:`~mmlspark_tpu_torch.core.resilience.Clock`, so ``GET
  /profile/cpu?window_s=N`` aggregates exactly the last N seconds, the
  incident bundle can ask for [firing-60s, firing+30s], and tests
  drive a :class:`~mmlspark_tpu_torch.core.resilience.ManualClock` through
  deterministic goldens.
* **Differential profiles.** ``?baseline_s=M`` diffs the last
  ``window_s`` against the ``baseline_s`` immediately before it and
  ranks frames by how much *hotter* they got (share-of-samples delta) —
  the question an operator actually has during a regression is not
  "what is hot" but "what is hot *now* that wasn't".

Exports: collapsed flamegraph text (one ``stack count`` line per
distinct stack, the format every flamegraph renderer ingests), Chrome
``trace_event`` JSON (consecutive identical stacks coalesced into
duration slices per thread lane — load in Perfetto next to the request
traces from :mod:`mmlspark_tpu_torch.core.tracing`), and a JSON top-table for
terminals (``tools/trace_dump.py --profile``).
"""

from __future__ import annotations

import json
import sys
import threading
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

from mmlspark_tpu_torch.core.resilience import Clock, SYSTEM_CLOCK

# Thread-name prefix -> pipeline stage. Ordered: first match wins, so
# more specific prefixes go first. Anything unmatched lands in "other"
# (and the main thread in "main") — attribution degrades, never errors.
STAGE_PREFIXES: Tuple[Tuple[str, str], ...] = (
    ("serving-collector", "collector"),
    ("serving-executor", "dispatch"),
    ("serving-encoder", "encoder"),
    ("serving-journal", "journal"),
    ("decode-scheduler", "decode-step"),
    ("rollout-", "rollout"),
    ("tsdb-recorder", "recorder"),
    ("slo-notify", "alerting"),
    ("incident-capture", "incidents"),
    ("-frontend-", "frontend"),
    ("ThreadPoolExecutor", "pool"),
    ("MainThread", "main"),
)


def stage_for_thread(name: str) -> str:
    """Pipeline stage for a thread name (prefix/substring match against
    :data:`STAGE_PREFIXES`; unmatched names attribute to ``other``)."""
    for prefix, stage in STAGE_PREFIXES:
        if name.startswith(prefix) or (prefix[0] == "-" and prefix in name):
            return stage
    return "other"


def _frame_label(frame) -> str:
    """One collapsed-stack frame: ``<module-ish path>:<func>:<line>``.

    The path is trimmed to the last two components — enough to
    disambiguate (``serving/server.py`` vs ``core/tsdb.py``) without
    bloating the intern table with absolute prefixes.
    """
    code = frame.f_code
    fn = code.co_filename.replace("\\", "/")
    parts = fn.rsplit("/", 2)
    short = "/".join(parts[-2:]) if len(parts) >= 2 else fn
    return f"{short}:{code.co_name}:{frame.f_lineno}"


class SamplingProfiler:
    """Bounded ring of timestamped, interned, collapsed stacks.

    ``start()`` launches the sampling daemon; with a real clock each
    tick calls :meth:`sample_once`. Tests bypass the thread entirely
    and feed :meth:`record_stacks` under a ``ManualClock``.
    """

    def __init__(self, hz: float = 50.0, retention_s: float = 180.0,
                 max_depth: int = 48, max_stacks: int = 8192,
                 clock: Clock = SYSTEM_CLOCK):
        self.hz = max(0.5, float(hz))
        self.retention_s = float(retention_s)
        self.max_depth = int(max_depth)
        self.max_stacks = int(max_stacks)
        self.clock = clock
        self._lock = threading.Lock()
        # sample = (ts, ((tid, stack_id), ...))
        cap = max(16, int(self.hz * self.retention_s))
        self._ring: deque = deque(maxlen=cap)
        self._stack_ids: Dict[str, int] = {}      # collapsed str -> id
        self._stacks: List[str] = []              # id -> collapsed str
        self._thread_names: Dict[int, str] = {}   # ident -> last name
        self._overflow_id: Optional[int] = None
        self.n_samples = 0
        self.n_overflow = 0
        self.ewma_sample_ms = 0.0
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # -- capture ------------------------------------------------------

    def _intern(self, collapsed: str) -> int:
        sid = self._stack_ids.get(collapsed)
        if sid is not None:
            return sid
        if len(self._stacks) >= self.max_stacks:
            # Intern table full: every new distinct stack degrades to
            # one shared overflow bucket instead of growing memory.
            self.n_overflow += 1
            if self._overflow_id is None:
                self._overflow_id = len(self._stacks)
                self._stacks.append("<overflow>")
                self._stack_ids["<overflow>"] = self._overflow_id
            return self._overflow_id
        sid = len(self._stacks)
        self._stacks.append(collapsed)
        self._stack_ids[collapsed] = sid
        return sid

    def record_stacks(self, now: float,
                      stacks: Sequence[Tuple[int, str, Sequence[str]]]
                      ) -> None:
        """Append one sample: ``stacks`` is ``[(tid, thread_name,
        (root_frame, ..., leaf_frame)), ...]``. Public so tests can
        script deterministic timelines without a sampling thread."""
        with self._lock:
            entry = []
            for tid, name, frames in stacks:
                self._thread_names[tid] = name
                collapsed = ";".join(frames) if frames else "<idle>"
                entry.append((tid, self._intern(collapsed)))
            self._ring.append((now, tuple(entry)))
            self.n_samples += 1

    def sample_once(self) -> float:
        """Take one sample of every live thread; returns the sample
        cost in milliseconds (feeds the EWMA the perf gate reads)."""
        t0 = self.clock.now()
        me = threading.get_ident()
        names = {t.ident: t.name for t in threading.enumerate()
                 if t.ident is not None}
        stacks: List[Tuple[int, str, Sequence[str]]] = []
        for tid, frame in sys._current_frames().items():
            if tid == me:
                continue
            frames: List[str] = []
            depth = 0
            f = frame
            while f is not None and depth < self.max_depth:
                frames.append(_frame_label(f))
                f = f.f_back
                depth += 1
            frames.reverse()          # root-first, flamegraph order
            stacks.append((tid, names.get(tid, f"tid-{tid}"), frames))
        self.record_stacks(t0, stacks)
        cost_ms = (self.clock.now() - t0) * 1000.0
        self.ewma_sample_ms += 0.05 * (cost_ms - self.ewma_sample_ms)
        return cost_ms

    def _run(self) -> None:
        interval = 1.0 / self.hz
        while not self._stop.is_set():
            try:
                self.sample_once()
            except Exception:
                # Sampling must never take the process down; a corrupt
                # frame walk loses one tick, not the profiler.
                pass
            self._stop.wait(interval)

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="cpu-profiler")
        self._thread.start()

    def stop(self) -> None:
        t = self._thread
        if t is None:
            return
        self._stop.set()
        t.join(timeout=5.0)
        self._thread = None

    # -- queries ------------------------------------------------------

    def _window(self, t0: float, t1: float):
        """Samples with t0 <= ts <= t1 (snapshot under the lock)."""
        with self._lock:
            return [s for s in self._ring if t0 <= s[0] <= t1], \
                list(self._stacks), dict(self._thread_names)

    def _bounds(self, window_s: float, now: Optional[float]
                ) -> Tuple[float, float]:
        end = self.clock.now() if now is None else now
        return end - float(window_s), end

    def collapsed_between(self, t0: float, t1: float,
                          by_stage: bool = True) -> Dict[str, int]:
        """``{collapsed_stack: sample_count}`` over [t0, t1]. With
        ``by_stage`` each stack is prefixed ``<stage>;`` so flamegraphs
        show one lane per pipeline stage."""
        samples, stacks, names = self._window(t0, t1)
        counts: Dict[str, int] = {}
        for _, entries in samples:
            for tid, sid in entries:
                stack = stacks[sid]
                if by_stage:
                    stage = stage_for_thread(names.get(tid, ""))
                    stack = f"{stage};{stack}"
                counts[stack] = counts.get(stack, 0) + 1
        return counts

    def render_collapsed(self, window_s: float,
                         now: Optional[float] = None) -> str:
        """Folded flamegraph text: one ``stack count`` line per
        distinct stack, count-descending."""
        t0, t1 = self._bounds(window_s, now)
        counts = self.collapsed_between(t0, t1)
        lines = [f"{stack} {n}" for stack, n in
                 sorted(counts.items(), key=lambda kv: (-kv[1], kv[0]))]
        return "\n".join(lines) + ("\n" if lines else "")

    def profile_between(self, t0: float, t1: float,
                        top: int = 30) -> Dict:
        """Structured window summary: totals, per-stage sample counts,
        and the top collapsed stacks — the JSON shape ``GET
        /profile/cpu`` serves by default."""
        samples, stacks, names = self._window(t0, t1)
        stage_counts: Dict[str, int] = {}
        stack_counts: Dict[str, int] = {}
        total = 0
        for _, entries in samples:
            for tid, sid in entries:
                total += 1
                stage = stage_for_thread(names.get(tid, ""))
                stage_counts[stage] = stage_counts.get(stage, 0) + 1
                stack_counts[stacks[sid]] = stack_counts.get(
                    stacks[sid], 0) + 1
        top_stacks = sorted(stack_counts.items(),
                            key=lambda kv: (-kv[1], kv[0]))[:top]
        return {
            "window": {"start": t0, "end": t1,
                       "seconds": max(0.0, t1 - t0)},
            "hz": self.hz,
            "samples": len(samples),
            "thread_samples": total,
            "stages": dict(sorted(stage_counts.items(),
                                  key=lambda kv: -kv[1])),
            "top_stacks": [{"stack": s, "count": n,
                            "share": (n / total) if total else 0.0}
                           for s, n in top_stacks],
        }

    def profile(self, window_s: float, now: Optional[float] = None,
                top: int = 30) -> Dict:
        t0, t1 = self._bounds(window_s, now)
        return self.profile_between(t0, t1, top=top)

    # -- differential -------------------------------------------------

    def _frame_shares(self, t0: float, t1: float) -> Tuple[Dict[str, int],
                                                           int]:
        """Inclusive per-frame counts: a frame is counted once per
        thread-sample it appears in, so shares are comparable across
        windows regardless of stack depth."""
        samples, stacks, _ = self._window(t0, t1)
        counts: Dict[str, int] = {}
        total = 0
        for _, entries in samples:
            for _, sid in entries:
                total += 1
                for frame in set(stacks[sid].split(";")):
                    counts[frame] = counts.get(frame, 0) + 1
        return counts, total

    def diff(self, window_s: float, baseline_s: float,
             now: Optional[float] = None, top: int = 20) -> Dict:
        """Differential profile: the last ``window_s`` vs the
        ``baseline_s`` immediately before it. Frames ranked by
        share-of-samples delta — "which frames got hotter"."""
        end = self.clock.now() if now is None else now
        cur0, cur1 = end - float(window_s), end
        base0, base1 = cur0 - float(baseline_s), cur0
        cur, cur_total = self._frame_shares(cur0, cur1)
        base, base_total = self._frame_shares(base0, base1)
        rows = []
        for frame in set(cur) | set(base):
            cs = (cur.get(frame, 0) / cur_total) if cur_total else 0.0
            bs = (base.get(frame, 0) / base_total) if base_total else 0.0
            rows.append({"frame": frame,
                         "cur_count": cur.get(frame, 0),
                         "base_count": base.get(frame, 0),
                         "cur_share": cs, "base_share": bs,
                         "delta_share": cs - bs})
        rows.sort(key=lambda r: -r["delta_share"])
        return {
            "window": {"start": cur0, "end": cur1},
            "baseline": {"start": base0, "end": base1},
            "cur_samples": cur_total, "base_samples": base_total,
            "hotter": [r for r in rows if r["delta_share"] > 0][:top],
            "colder": [r for r in reversed(rows)
                       if r["delta_share"] < 0][:top],
        }

    # -- chrome trace-event export ------------------------------------

    def chrome_trace_between(self, t0: float, t1: float) -> Dict:
        """Chrome ``trace_event`` JSON: per-thread lanes, consecutive
        identical stacks coalesced into one duration slice named after
        the leaf frame (full stack in args). Loads in Perfetto /
        chrome://tracing next to the request traces."""
        samples, stacks, names = self._window(t0, t1)
        events: List[Dict] = []
        tick_us = 1e6 / self.hz
        # Per thread: run-length encode (stack_id) over time.
        open_slices: Dict[int, Dict] = {}  # tid -> {sid, start, last}
        seen_tids: Dict[int, bool] = {}

        def _close(tid: int) -> None:
            sl = open_slices.pop(tid, None)
            if sl is None:
                return
            stack = stacks[sl["sid"]]
            leaf = stack.rsplit(";", 1)[-1]
            events.append({
                "name": leaf, "ph": "X", "cat": "cpu",
                "ts": sl["start"] * 1e6,
                "dur": max(tick_us, (sl["last"] - sl["start"]) * 1e6
                           + tick_us),
                "pid": 1, "tid": tid,
                "args": {"stack": stack,
                         "stage": stage_for_thread(names.get(tid, ""))},
            })

        for ts, entries in samples:
            live = {}
            for tid, sid in entries:
                live[tid] = sid
                seen_tids[tid] = True
                sl = open_slices.get(tid)
                if sl is not None and sl["sid"] == sid:
                    sl["last"] = ts
                else:
                    if sl is not None:
                        _close(tid)
                    open_slices[tid] = {"sid": sid, "start": ts,
                                        "last": ts}
            for tid in [t for t in open_slices if t not in live]:
                _close(tid)
        for tid in list(open_slices):
            _close(tid)
        for tid in seen_tids:
            events.append({"name": "thread_name", "ph": "M", "pid": 1,
                           "tid": tid,
                           "args": {"name": names.get(tid,
                                                      f"tid-{tid}")}})
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def chrome_trace(self, window_s: float,
                     now: Optional[float] = None) -> Dict:
        t0, t1 = self._bounds(window_s, now)
        return self.chrome_trace_between(t0, t1)

    # -- introspection ------------------------------------------------

    def status(self) -> Dict:
        with self._lock:
            return {
                "running": self._thread is not None,
                "hz": self.hz,
                "retention_s": self.retention_s,
                "samples": self.n_samples,
                "ring_len": len(self._ring),
                "ring_cap": self._ring.maxlen,
                "distinct_stacks": len(self._stacks),
                "max_stacks": self.max_stacks,
                "overflow": self.n_overflow,
                "ewma_sample_ms": round(self.ewma_sample_ms, 4),
            }

    def render_json(self, payload: Dict) -> bytes:
        return json.dumps(payload).encode("utf-8")
