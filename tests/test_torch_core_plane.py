"""The port's core plane against the JAX package's on the same inputs:
resilience, logs, the sampling profiler, profiling, params, the
columnar frame, stage persistence, fs and the checkpoint digest.

Clocks are ``ManualClock``s wherever one is read, so retry delays,
breaker transitions and stage timings are deterministic. Logger roots
differ by design (``mmlspark_tpu`` and ``mmlspark_tpu_torch``), so log
lines are compared with the logger name and the wall stamp set aside.
``DeviceProfiler`` runs a CPU-only window here (its card window is
driven by ``chip_smoke.py``), and ``device_memory_stats`` is empty on
the CPU, as JAX's is.
"""

import json
import logging
import os
import threading
import time

import numpy as np
import pytest
import torch

from mmlspark_tpu.core import dataframe as JDF
from mmlspark_tpu.core import logs as JL
from mmlspark_tpu.core import params as JP
from mmlspark_tpu.core import profiler as JPF
from mmlspark_tpu.core import profiling as JPG
from mmlspark_tpu.core import resilience as JR
from mmlspark_tpu.core import stage as JS
from mmlspark_tpu.core import telemetry as JTM
from mmlspark_tpu.core import tracing as JTR
from mmlspark_tpu.io import checkpoint as JCK
from mmlspark_tpu_torch.core import dataframe as PDF
from mmlspark_tpu_torch.core import logs as PL
from mmlspark_tpu_torch.core import params as PP
from mmlspark_tpu_torch.core import profiler as PPF
from mmlspark_tpu_torch.core import profiling as PPG
from mmlspark_tpu_torch.core import registry as PREG
from mmlspark_tpu_torch.core import resilience as PR
from mmlspark_tpu_torch.core import stage as PS
from mmlspark_tpu_torch.core import telemetry as PTM
from mmlspark_tpu_torch.core import tracing as PTR
from mmlspark_tpu_torch.io import checkpoint as PCK
from mmlspark_tpu_torch.io import fs as PFS

torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# resilience


def _retry_delays(res, seed, **kw):
    clock = res.ManualClock()
    policy = res.RetryPolicy(seed=seed, clock=clock, **kw)
    sched = policy.schedule()
    delays = []
    while True:
        t0 = clock.now()
        if sched.give_up():
            return delays, sched.attempt
        delays.append(clock.now() - t0)


@pytest.mark.parametrize("kw", [
    dict(max_attempts=8, base=0.1, cap=2.0),
    dict(max_attempts=20, base=0.05, cap=1.0, budget=3.0),
    dict(backoffs=(0.5, 1.0, 1.5)),
])
def test_seeded_retry_delays_match(kw):
    for seed in (0, 7, 1234):
        assert _retry_delays(PR, seed, **kw) == _retry_delays(JR, seed, **kw)


def test_retry_policy_call_and_deadline():
    clock = PR.ManualClock()
    calls = []

    def flaky():
        calls.append(clock.now())
        if len(calls) < 3:
            raise OSError("transient")
        return "ok"

    policy = PR.RetryPolicy(max_attempts=5, base=0.1, seed=3, clock=clock)
    assert policy.call(flaky) == "ok" and len(calls) == 3
    assert policy.retryable_status(0) and not policy.retryable_status(404)
    short = PR.Deadline(0.05, clock=clock)
    sched = policy.schedule(deadline=short)
    assert sched.give_up() is True       # the retry could never finish


def _breaker_walk(res):
    clock = res.ManualClock()
    br = res.CircuitBreaker(failure_threshold=3, reset_timeout=5.0,
                            half_open_max=1, clock=clock, name="dep")
    seen = [br.state]
    for step in ("fail", "fail", "fail", "allow", "wait", "allow",
                 "allow", "fail", "wait", "allow", "ok", "allow"):
        if step == "fail":
            br.record_failure()
        elif step == "ok":
            br.record_success()
        elif step == "wait":
            clock.advance(5.0)
        else:
            seen.append(br.allow())
        seen.append(br.state)
    return seen, br.n_opened, br.n_rejected


def test_circuit_breaker_transitions_match():
    got = _breaker_walk(PR)
    assert got == _breaker_walk(JR)
    assert got[1] == 2 and "half_open" in got[0]


def test_breaker_board_and_call_and_metrics():
    board = PR.BreakerBoard(clock=PR.ManualClock(), failure_threshold=1,
                            reset_timeout=9.0)
    br = board.get("host-a")
    assert board.get("host-a") is br
    with pytest.raises(ZeroDivisionError):
        br.call(lambda: 1 / 0)
    with pytest.raises(PR.CircuitOpen):
        br.call(lambda: 1)
    assert board.states() == {"host-a": "open"}
    text = PTM.REGISTRY.render()
    assert 'breaker_transitions_total{breaker="host-a",to="open"}' in text
    assert 'breaker_state{breaker="host-a"} 2' in text
    with pytest.raises(PR.DeadlineExceeded):
        raise PR.DeadlineExceeded("x")


# ---------------------------------------------------------------------------
# logs


def _record(msg="served %d rows", args=(3,), level=logging.WARNING):
    return logging.LogRecord("x", level, __file__, 1, msg, args, None)


def test_json_log_lines_match_modulo_root():
    lines = {}
    for side, (logs, tel, tr) in {"jax": (JL, JTM, JTR),
                                  "port": (PL, PTM, PTR)}.items():
        fmt = logs.make_formatter("json")
        with tel.trace_context("trace-7"):
            with tr.Tracer().span("dispatch"):
                rec = _record()
                rec.name = f"{logs._ROOT}.serving"
                line = json.loads(fmt.format(rec))
        assert line.pop("logger") == f"{logs._ROOT}.serving"
        line.pop("ts")
        plain = logs.make_formatter("plain").format(_record())
        lines[side] = (line, plain.split(" ", 3)[3])
    assert lines["port"] == lines["jax"]
    assert lines["port"][0]["trace_id"] == "trace-7"
    assert lines["port"][0]["span"] == "dispatch"
    assert PL._ROOT == "mmlspark_tpu_torch"


def test_log_ring_records_and_filters():
    rings = {}
    for side, (logs, tel) in {"jax": (JL, JTM), "port": (PL, PTM)}.items():
        ring = logs.LogRing(capacity=3, level=logging.INFO)
        ring.emit(_record("b", (), logging.ERROR))
        ring.emit(_record("c", (), logging.WARNING))
        with tel.trace_context("t-a"):
            ring.emit(_record("a", (), logging.INFO))
        ring.emit(_record("d", (), logging.INFO))
        out = [(r["message"], r["level"], r["trace"])
               for r in ring.records()]
        rings[side] = (out, [r["message"] for r in
                             ring.records(level="warning")],
                       [r["message"] for r in ring.records(trace="t-a")],
                       ring.status())
    assert rings["port"] == rings["jax"]
    assert rings["port"][:3] == ([("c", "WARNING", "-"),
                                  ("a", "INFO", "t-a"), ("d", "INFO", "-")],
                                 ["c"], ["a"])


def test_installed_log_ring_and_reconfigure(monkeypatch):
    ring = PL.install_log_ring()
    assert PL.install_log_ring() is ring and PL.get_log_ring() is ring
    PL.get_logger("test.core_plane").warning("ring me %s", "now")
    assert ring.records(limit=1)[0]["message"] == "ring me now"
    monkeypatch.setenv("MMLSPARK_TPU_LOGGING_FORMAT", "json")
    PL.reconfigure()
    try:
        root = logging.getLogger("mmlspark_tpu_torch")
        stream = [h for h in root.handlers if not isinstance(h, PL.LogRing)]
        assert isinstance(stream[0].formatter, PL._JsonFormatter)
    finally:
        monkeypatch.delenv("MMLSPARK_TPU_LOGGING_FORMAT")
        PL.reconfigure()


# ---------------------------------------------------------------------------
# profilers


def _busy_marker_function(stop):
    x = 0
    while not stop.is_set():
        x += 1
    return x


def test_sampling_profiler_sees_a_busy_thread():
    stop = threading.Event()
    t = threading.Thread(target=_busy_marker_function, args=(stop,),
                         name="decode-scheduler", daemon=True)
    t.start()
    prof = PPF.SamplingProfiler(hz=200.0)
    try:
        for _ in range(20):
            prof.sample_once()
            time.sleep(0.002)
    finally:
        stop.set()
        t.join(5)
    assert not t.is_alive()
    counts = prof.collapsed_between(0.0, float("inf"))
    mine = {s: n for s, n in counts.items()
            if s.startswith("decode-step;")}
    assert sum(n for s, n in mine.items()
               if "_busy_marker_function" in s) >= 15
    out = prof.profile(window_s=1e9)
    assert out["stages"]["decode-step"] >= 15
    assert out["samples"] == 20


def test_sampling_profiler_scripted_timeline_matches_jax():
    got = {}
    for side, (mod, res) in {"jax": (JPF, JR), "port": (PPF, PR)}.items():
        clock = res.ManualClock(100.0)
        prof = mod.SamplingProfiler(hz=10.0, clock=clock)
        for i in range(30):
            clock.advance(0.1)
            hot = "core/tsdb.py:ingest:10" if i >= 20 else \
                "serving/decode.py:_run_step:5"
            prof.record_stacks(clock.now(), [
                (1, "decode-scheduler", ("a.py:main:1", hot)),
                (2, "tsdb-recorder", ("a.py:loop:2",))])
        got[side] = (prof.profile(1.0), prof.render_collapsed(3.0),
                     prof.diff(1.0, 1.0), prof.chrome_trace(3.0))
    assert got["port"] == got["jax"]


def test_stage_timings_and_mfu_meter_match():
    snaps = {}
    for side, mod in (("jax", JPG), ("port", PPG)):
        ticks = iter(np.arange(0.0, 10.0, 0.25).tolist())
        st = mod.StageTimings(clock=lambda: next(ticks))
        for name in ("encode", "dispatch", "encode"):
            with st.span(name):
                pass
        mfu = mod.MfuMeter(peak_tflops=989.0)
        for bucket, sec, flops in ((16, 0.5, 4e14), (16, 0.25, 1e14),
                                   (32, 1.0, None)):
            mfu.note(bucket, sec, flops)
        snaps[side] = (st.snapshot(), mfu.snapshot())
    assert snaps["port"] == snaps["jax"]
    assert snaps["port"][1]["buckets"]["16"]["mfu"] == pytest.approx(
        0.7279, abs=1e-4)
    # without a peak the meter reads the card from the environment:
    # none here, so flops/s and no MFU
    meter = PPG.MfuMeter()
    meter.note("b", 1.0, 1e12)
    snap = meter.snapshot()
    assert snap["device_kind"] == "cpu" and snap["peak_tflops"] is None
    assert "mfu" not in snap["buckets"]["b"]
    assert PPG._PEAK_BF16_TFLOPS["NVIDIA H100 80GB HBM3"] == 989.0


def test_device_profiler_cpu_window_and_busy(tmp_path):
    prof = PPG.DeviceProfiler(base_dir=str(tmp_path))
    info = prof.start_window(duration_s=0.3)
    with pytest.raises(PPG.ProfilerBusy):
        prof.start_window(duration_s=0.1)
    for _ in range(200):
        if not prof.busy:
            break
        time.sleep(0.05)
    st = prof.status()
    assert not st["busy"] and st["n_captures"] == 1 and st["n_errors"] == 0
    assert st["last"]["ok"] is True
    trace = os.path.join(info["log_dir"], PPG.TRACE_FILE)
    assert st["last"]["trace"] == trace
    with open(trace) as f:
        assert "traceEvents" in json.load(f)


def test_device_profiler_window_counts_from_recording(tmp_path):
    prof = PPG.DeviceProfiler(base_dir=str(tmp_path))
    prof.start_window(duration_s=0.3)
    seen = None
    for _ in range(2000):
        active = prof.status()["active"]
        if active is None or "recording_unix" in active:
            seen = active
            break
        time.sleep(0.005)
    assert seen is not None, "the window closed before it showed recording"
    for _ in range(200):
        if not prof.busy:
            break
        time.sleep(0.05)
    last = prof.status()["last"]
    assert last["ok"] is True
    assert (last["started_unix"] <= last["recording_unix"]
            == seen["recording_unix"] <= last["finished_unix"])
    assert (last["finished_unix"] - last["recording_unix"]
            >= last["duration_s"])


def test_device_trace_and_timed_span(tmp_path):
    with PPG.device_trace(str(tmp_path / "tr")):
        with PPG.timed_span("matmul-block", logger=logging.getLogger(
                "x")) as span:
            torch.ones(8, 8) @ torch.ones(8, 8)
    assert span["seconds"] >= 0.0
    with open(tmp_path / "tr" / PPG.TRACE_FILE) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "matmul-block" in names


def test_vitals_on_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("the CPU case: this host has a card")
    assert PPG.device_memory_stats() == JPG.device_memory_stats() == {}
    assert PPG.process_rss_bytes() > 0
    assert PPG.process_uptime_s() >= 0.0
    ledger = PPG.CompileLedger(cap=2)
    for i in range(3):
        ledger.note("retrace", f"b{i}", 1.0)
    assert ledger.snapshot()["n_events"] == 3
    assert [e["shape"] for e in ledger.events()] == ["b1", "b2"]


# ---------------------------------------------------------------------------
# params, the frame, stages


class _Scale(PS.Transformer):
    factor = PP.Param(2.0, "the multiplier", ptype=float,
                      validator=PP.in_range(0, 100))
    column = PP.Param("x", "the column", ptype=str)

    def transform(self, df):
        return df.with_column(self.column, df[self.column] * self.factor)


class _JScale(JS.Transformer):
    factor = JP.Param(2.0, "the multiplier", ptype=float,
                      validator=JP.in_range(0, 100))
    column = JP.Param("x", "the column", ptype=str)


def test_params_behave_as_jax():
    for cls in (_Scale, _JScale):
        s = cls(factor=3)
        assert s.factor == 3.0 and isinstance(s.factor, float)
        with pytest.raises(ValueError):
            s.set(factor=1000.0)
        with pytest.raises(TypeError):
            s.set(column=5)
        assert s.copy(column="y").column == "y" and s.column == "x"
    assert _Scale(factor=3).explain_params() == \
        _JScale(factor=3).explain_params()
    assert _Scale(factor=3).get_param_values(include_defaults=True) == \
        _JScale(factor=3).get_param_values(include_defaults=True)


def test_dataframe_matches_jax(tmp_path):
    data = {"x": np.arange(6, dtype=np.float32),
            "y": np.array(list("abcdef"), dtype=object),
            "v": np.arange(12, dtype=np.int64).reshape(6, 2)}
    frames = {}
    for side, mod in (("jax", JDF), ("port", PDF)):
        df = mod.DataFrame(data, metadata={"y": {"role": "label"}})
        df2 = (df.with_column("z", df["x"] * 2).filter(df["x"] > 1)
               .sort_by("x", ascending=False).head(3))
        df2.save(str(tmp_path / side))
        back = mod.DataFrame.load(str(tmp_path / side))
        frames[side] = (repr(back), back.get_metadata("y"),
                        [list(map(str, r.values())) for r in back.rows()],
                        [len(b) for b in df.iter_batches(4)])
    assert frames["port"] == frames["jax"]
    batch = PDF.DataFrame(data).device_batch(["x", "v"], device="cpu")
    assert batch["x"].dtype == torch.float32 and batch["v"].shape == (6, 2)
    assert batch["x"].device == torch.device("cpu")


def test_timer_stage_survives_save_and_load(tmp_path):
    df = PDF.DataFrame({"x": np.arange(4, dtype=np.float64)})
    timer = PS.Timer(stage=_Scale(factor=4.0))
    model = timer.fit(df)
    assert isinstance(model, PS.TimerModel)
    path = str(tmp_path / "timer")
    timer.save(path)
    assert PCK.verify_digest(path, strict=True) == (True, None)
    back = PS.PipelineStage.load(path)
    assert isinstance(back, PS.Timer)
    assert isinstance(back.stage, _Scale) and back.stage.factor == 4.0
    out = back.fit(df).transform(df)
    np.testing.assert_array_equal(out["x"], np.arange(4) * 4.0)
    hist = [f for f in PTM.REGISTRY.families()
            if f.name == "pipeline_stage_duration_ms"]
    assert hist and ("_Scale", "transform") in dict(hist[0].children())
    assert "mmlspark_tpu_torch.core.stage.Timer" in PREG.all_stages()
    with pytest.raises(KeyError, match="JAX package"):
        PREG.resolve("mmlspark_tpu.core.stage.Timer")
    assert all(k.startswith("mmlspark_tpu_torch.")
               for k in PREG.all_stages())


# ---------------------------------------------------------------------------
# fs and the checkpoint digest


def _tree(root):
    os.makedirs(os.path.join(root, "sub", "deeper"))
    for rel, body in (("metadata.json", b'{"a": 1}'),
                      ("arrays.npz", bytes(range(256)) * 40),
                      ("sub/metadata.json", b"{}"),
                      ("sub/deeper/w.bin", b"\x00" * 4097)):
        with open(os.path.join(root, rel), "wb") as f:
            f.write(body)


def test_digest_crosses_packages(tmp_path):
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    _tree(a)
    _tree(b)
    pm = PCK.write_digest(a)
    jm = JCK.write_digest(b)
    assert pm == jm
    with open(os.path.join(a, PCK.MANIFEST_FILE), "rb") as fa, \
            open(os.path.join(b, JCK.MANIFEST_FILE), "rb") as fb:
        assert fa.read() == fb.read()
    assert JCK.verify_digest(a, strict=True) == (True, None)
    assert PCK.verify_digest(b, strict=True) == (True, None)
    with open(os.path.join(a, "sub", "deeper", "w.bin"), "ab") as f:
        f.write(b"!")
    ok_p, why_p = PCK.verify_digest(a)
    ok_j, why_j = JCK.verify_digest(a)
    assert (ok_p, why_p) == (ok_j, why_j) and not ok_p
    assert "w.bin" in why_p
    os.remove(os.path.join(b, JCK.MANIFEST_FILE))
    assert PCK.verify_digest(b, strict=True)[0] is False
    assert PCK.verify_digest(b, strict=False)[0] is True


def test_fs_local_paths(tmp_path):
    root = str(tmp_path / "fs")
    PFS.makedirs(PFS.join(root, "x"))
    PFS.write_text(PFS.join(root, "x", "a.txt"), "hello")
    PFS.write_bytes(PFS.join(root, "b.bin"), b"\x01\x02")
    assert PFS.read_text("file://" + PFS.join(root, "x", "a.txt")) == "hello"
    assert PFS.read_bytes(PFS.join(root, "b.bin")) == b"\x01\x02"
    assert PFS.exists(root) and PFS.isfile(PFS.join(root, "b.bin"))
    assert not PFS.is_remote(root) and PFS.is_remote("gs://b/k")
    assert PFS.join("gs://b", "k", "v") == "gs://b/k/v"
    found = sorted(os.path.relpath(p, root) for p in PFS.find_files(root))
    assert found == ["b.bin", os.path.join("x", "a.txt")]
    dst = str(tmp_path / "copy")
    PFS.copy_tree(root, dst)
    assert sorted(r for r, _ in PFS.walk_rel_files(dst)) == \
        sorted(r for r, _ in PFS.walk_rel_files(root))
    PFS.rm_tree(dst)
    assert not PFS.exists(dst)
