"""The port's streaming plane (``mmlspark_tpu_torch/streaming/``,
``io/streaming.py``, ``NNLearner.fit_stream``) against the JAX
package's, on the CPU.

Each case of ``tests/test_streaming_engine.py`` runs in both packages on
the same rows (``ManualClock``s where time matters) and holds JAX's
assertions in each; what they observe — the emitted window rows, the
sink's calls, the planned offsets and the write-ahead log (each offset
and commit entry, less its wall-clock stamp) — must be equal across the
two. ``fit_stream`` from bridged weights reaches JAX's parameters within
1e-5 on the same captured traffic; a crash between the sink and the
commit is replayed and skipped exactly once. The retrain loop runs end
to end on the CPU: two servers behind a coordinator, one capturing,
background traffic throughout, ``fit_stream`` over the capture,
``RetrainLoop`` pushing the export through the canary rollout: zero bad
replies, and the fleet serves the export's scores.
"""

import json
import os
import threading
import time
import types

import jax
import numpy as np
import pytest
import torch

from mmlspark_tpu.core import resilience as JR
from mmlspark_tpu.core.dataframe import DataFrame as JDF
from mmlspark_tpu.io import streaming as JIO
from mmlspark_tpu.models.function import NNFunction as JF
from mmlspark_tpu.models.trainer import NNLearner as JL
from mmlspark_tpu.serving.capture import TrafficCapture as JCap
from mmlspark_tpu.streaming import engine as JE
from mmlspark_tpu.streaming.traffic import TrafficLogSource as JTLS
from mmlspark_tpu_torch.core import resilience as PR
from mmlspark_tpu_torch.core.dataframe import DataFrame as PDF
from mmlspark_tpu_torch.io import streaming as PIO
from mmlspark_tpu_torch.models.function import NNFunction as PF
from mmlspark_tpu_torch.models.trainer import NNLearner as PL
from mmlspark_tpu_torch.serving.capture import TrafficCapture as PCap
from mmlspark_tpu_torch.streaming import engine as PE
from mmlspark_tpu_torch.streaming.traffic import TrafficLogSource as PTLS

torch.set_num_threads(1)

J = types.SimpleNamespace(DF=JDF, E=JE, R=JR, IO=JIO, Cap=JCap, TLS=JTLS,
                          F=JF, L=JL, name="jax")
P = types.SimpleNamespace(DF=PDF, E=PE, R=PR, IO=PIO, Cap=PCap, TLS=PTLS,
                          F=PF, L=PL, name="port")


def both(scenario, tmp_path):
    """Run ``scenario(M, dir)`` in each package; their observations must
    be equal. Returns the port's."""
    got = {M.name: scenario(M, str(tmp_path / M.name)) for M in (J, P)}
    assert got["port"] == got["jax"]
    return got["port"]


def wal(ckpt):
    """The write-ahead log: every offset and commit entry, less its
    wall-clock stamp."""
    out = {}
    for kind in ("offsets", "commits"):
        d = os.path.join(ckpt, kind)
        for name in sorted(os.listdir(d)) if os.path.isdir(d) else []:
            with open(os.path.join(d, name)) as f:
                entry = json.load(f)
            out[f"{kind}/{name}"] = {k: v for k, v in entry.items()
                                     if not k.endswith("_unix")}
    return out


class RecordingSink:
    """Idempotent-by-batch-id sink with a crash hook: raises AFTER
    recording (the 'sink wrote, commit never landed' crash window)."""

    def __init__(self):
        self.seen = set()
        self.rows_by_batch = {}
        self.calls = []
        self.crash_on = None

    def process(self, bid, df):
        self.calls.append(bid)
        if bid not in self.seen:
            self.seen.add(bid)
            self.rows_by_batch[bid] = df.num_rows
        if self.crash_on == bid:
            self.crash_on = None
            raise RuntimeError("injected crash between sink and commit")


def _rows(n, t0=0.0):
    return [{"x": float(i), "t": t0 + float(i)} for i in range(n)]


# -- the engine ---------------------------------------------------------------

def test_batches_flow_and_wal_written(tmp_path):
    def run(M, d):
        src = M.E.MemoryStreamSource()
        sink = RecordingSink()
        q = M.E.StreamingQuery(src, sink, checkpoint_dir=d, name="basic",
                               max_batch_rows=4)
        src.add_rows(_rows(10))
        assert q.process_available() == 3
        assert sink.calls == [1, 2, 3]
        assert q.n_batches == 3 and q.n_rows == 10
        assert sorted(os.listdir(os.path.join(d, "offsets"))) == \
            sorted(os.listdir(os.path.join(d, "commits"))) == \
            [f"{i:08d}.json" for i in (1, 2, 3)]
        return {"rows": sink.rows_by_batch, "wal": wal(d)}
    out = both(run, tmp_path)
    assert out["wal"]["commits/00000003.json"]["batch_id"] == 3


def test_transform_empty_and_threaded(tmp_path):
    def run(M, d):
        src = M.E.MemoryStreamSource()
        got = []
        q = M.E.StreamingQuery(
            src, lambda bid, df: got.append(df["y"].tolist()),
            transform=lambda df: df.with_column(
                "y", np.asarray(df["x"]) * 2))
        src.add_rows(_rows(3))
        q.process_available()
        idle = M.E.StreamingQuery(M.E.MemoryStreamSource(), RecordingSink())
        assert idle.process_available() == 0 and idle.n_batches == 0
        src2, sink = M.E.MemoryStreamSource(), RecordingSink()
        t = M.E.StreamingQuery(src2, sink, checkpoint_dir=d,
                               trigger_interval_s=0.02, name="threaded")
        t.start()
        src2.add_rows(_rows(5))
        deadline = time.monotonic() + 5
        while time.monotonic() < deadline and t.n_rows < 5:
            time.sleep(0.01)
        t.stop()
        assert t.state == "terminated" and t.await_termination(1.0)
        return {"got": got, "rows": t.n_rows}
    assert both(run, tmp_path)["got"] == [[0.0, 2.0, 4.0]]


def test_crash_between_sink_and_commit_replays_batch(tmp_path):
    def run(M, d):
        src = M.E.MemoryStreamSource()
        src.add_rows(_rows(8))
        sink = RecordingSink()
        kw = dict(checkpoint_dir=d, max_batch_rows=4, name="crash",
                  retry_policy=M.R.RetryPolicy(max_attempts=1))
        q = M.E.StreamingQuery(src, sink, **kw)
        q.process_available(max_batches=1)
        sink.crash_on = 2
        with pytest.raises(RuntimeError, match="injected crash"):
            q.process_available()
        assert q.state == "failed"
        assert os.path.exists(os.path.join(d, "offsets", "00000002.json"))
        assert not os.path.exists(os.path.join(d, "commits",
                                               "00000002.json"))
        before = wal(d)
        src2 = M.E.MemoryStreamSource()
        src2.add_rows(_rows(8))
        q2 = M.E.StreamingQuery(src2, sink, **kw)
        q2.process_available()
        assert q2.n_replayed_batches == 1
        assert sink.calls.count(2) == 2
        assert sum(sink.rows_by_batch.values()) == 8
        return {"calls": sink.calls, "before": before, "after": wal(d)}
    both(run, tmp_path)


def test_recovery_reacks_committed_offsets(tmp_path):
    def run(M, d):
        src = M.E.MemoryStreamSource()
        src.add_rows(_rows(4))
        M.E.StreamingQuery(src, RecordingSink(), checkpoint_dir=d,
                           name="reack").process_available()
        src2 = M.E.MemoryStreamSource()
        src2.add_rows(_rows(4))
        sink2 = RecordingSink()
        q2 = M.E.StreamingQuery(src2, sink2, checkpoint_dir=d,
                                name="reack")
        assert q2.process_available() == 0
        return {"calls": sink2.calls, "wal": wal(d)}
    both(run, tmp_path)


def test_tumbling_window_golden(tmp_path):
    def run(M, d):
        clock = M.R.ManualClock()
        src = M.E.MemoryStreamSource()
        emitted = []

        def sink(bid, df):
            for i in range(df.num_rows):
                emitted.append((float(df["window_start"][i]),
                                float(df["window_end"][i]),
                                int(df["n"][i]), float(df["sx"][i])))

        q = M.E.StreamingQuery(
            src, sink, name="win", checkpoint_dir=d, event_time_col="t",
            watermark_delay_s=2.0,
            window=M.E.WindowSpec(5.0, aggs={"n": ("count", None),
                                             "sx": ("sum", "x")}),
            clock=clock)
        marks = []
        for rows in ([{"x": 1.0, "t": 1.0}, {"x": 2.0, "t": 4.0}],
                     [{"x": 3.0, "t": 6.0}, {"x": 4.0, "t": 8.5}],
                     [{"x": 100.0, "t": 3.0}],
                     [{"x": 5.0, "t": 12.5}]):
            src.add_rows(rows)
            q.process_available()
            marks.append((q.watermark, len(emitted)))
        assert marks[0] == (pytest.approx(2.0), 0)
        assert marks[1] == (pytest.approx(6.5), 1)
        assert q.n_late_rows == 1
        assert emitted == [(0.0, 5.0, 2, 3.0), (5.0, 10.0, 2, 7.0)]
        return {"emitted": emitted, "marks": marks, "wal": wal(d)}
    both(run, tmp_path)


def test_sliding_windows_and_watermark_recovery(tmp_path):
    def run(M, d):
        src = M.E.MemoryStreamSource()
        emitted = []

        def sink(bid, df):
            for i in range(df.num_rows):
                emitted.append((float(df["window_start"][i]),
                                int(df["n"][i])))

        q = M.E.StreamingQuery(
            src, sink, name="slide", event_time_col="t",
            window=M.E.WindowSpec(4.0, slide_s=2.0,
                                  aggs={"n": ("count", None)}))
        src.add_rows([{"t": 3.0}])
        q.process_available()
        src.add_rows([{"t": 10.0}])
        q.process_available()
        assert (0.0, 1) in emitted and (2.0, 1) in emitted
        src3 = M.E.MemoryStreamSource()
        kw = dict(checkpoint_dir=d, name="wm", event_time_col="t",
                  watermark_delay_s=1.0)
        q3 = M.E.StreamingQuery(src3, RecordingSink(), **kw)
        src3.add_rows([{"t": 10.0}])
        q3.process_available()
        src3.add_rows([{"t": 5.0}])
        q3.process_available()
        assert q3.watermark == pytest.approx(9.0)
        q4 = M.E.StreamingQuery(M.E.MemoryStreamSource(), RecordingSink(),
                                **kw)
        assert q4.watermark == pytest.approx(9.0)
        return {"emitted": sorted(emitted), "wal": wal(d)}
    both(run, tmp_path)


def test_window_state_survives_restart(tmp_path):
    def run(M, d):
        spec = M.E.WindowSpec(10.0, aggs={"n": ("count", None),
                                          "sx": ("sum", "x")})
        src = M.E.MemoryStreamSource()
        q = M.E.StreamingQuery(src, RecordingSink(), checkpoint_dir=d,
                               name="state", event_time_col="t",
                               window=spec)
        src.add_rows([{"x": 1.0, "t": 1.0}, {"x": 2.0, "t": 3.0}])
        q.process_available()
        emitted = []

        def sink(bid, df):
            emitted.append((int(df["n"][0]), float(df["sx"][0])))

        src2 = M.E.MemoryStreamSource()
        src2.add_rows([{"x": 1.0, "t": 1.0}, {"x": 2.0, "t": 3.0}])
        q2 = M.E.StreamingQuery(src2, sink, checkpoint_dir=d, name="state",
                                event_time_col="t", window=spec)
        src2.add_rows([{"x": 4.0, "t": 15.0}])
        q2.process_available()
        assert emitted == [(2, 3.0)]
        return {"emitted": emitted, "wal": wal(d)}
    both(run, tmp_path)


def test_backpressure_and_sink_retries(tmp_path):
    def run(M, d):
        clock = M.R.ManualClock()
        src = M.E.MemoryStreamSource()
        slow = {"ms": 1000.0}

        def sink(bid, df):
            clock.advance(slow["ms"] / 1000.0)

        q = M.E.StreamingQuery(src, sink, name="bp", max_batch_rows=64,
                               min_batch_rows=1, target_batch_ms=100.0,
                               clock=clock)
        limits = []
        for i in range(16):
            if i == 6:
                slow["ms"] = 1.0
            src.add_rows(_rows(64))
            q.process_available()
            limits.append(q.status()["rows_limit"])
        assert limits[5] < 64 and limits[-1] > limits[5]
        attempts = []

        def flaky(bid, df):
            attempts.append(bid)
            if len(attempts) < 3:
                raise IOError("transient")

        src2 = M.E.MemoryStreamSource()
        q2 = M.E.StreamingQuery(src2, flaky, name="retry",
                                retry_policy=M.R.RetryPolicy(
                                    max_attempts=4, base=0.001, cap=0.002))
        src2.add_rows(_rows(2))
        q2.process_available()
        assert attempts == [1, 1, 1] and q2.n_sink_retries == 2

        def dead(bid, df):
            raise IOError("sink down")

        src3 = M.E.MemoryStreamSource()
        q3 = M.E.StreamingQuery(src3, dead, name="dead",
                                retry_policy=M.R.RetryPolicy(
                                    max_attempts=2, base=0.001, cap=0.002))
        src3.add_rows(_rows(1))
        with pytest.raises(IOError):
            q3.process_available()
        assert q3.state == "failed" and q3.n_sink_failures == 1
        assert "sink down" in q3.status()["error"]
        with pytest.raises(Exception):
            q3.run_once()
        return {"limits": limits, "attempts": attempts}
    both(run, tmp_path)


# -- the file source ----------------------------------------------------------

def test_file_source_plan_read_ack_and_resume(tmp_path):
    def run(M, d):
        data = os.path.join(d, "data")
        os.makedirs(data)
        ckpt = os.path.join(d, "progress.json")
        def put(name, body):
            # a fixed mtime: file keys hold it, and both runs name alike
            with open(os.path.join(data, name), "wb") as f:
                f.write(body)
            os.utime(os.path.join(data, name), ns=(10 ** 18, 10 ** 18))

        put("a.bin", b"one")
        put("b.bin", b"two")
        src = M.IO.FileStreamSource(data, checkpoint_location=ckpt)
        sink = RecordingSink()
        q = M.E.StreamingQuery(src, sink,
                               checkpoint_dir=os.path.join(d, "wal"),
                               name="files")
        q.process_available()
        assert sum(sink.rows_by_batch.values()) == 2
        assert q.process_available() == 0
        put("c.bin", b"three")
        src2 = M.IO.FileStreamSource(data, checkpoint_location=ckpt)
        sink2 = RecordingSink()
        q2 = M.E.StreamingQuery(src2, sink2,
                                checkpoint_dir=os.path.join(d, "wal"),
                                name="files")
        q2.process_available()
        assert sum(sink2.rows_by_batch.values()) == 1
        assert q2.batch_id == 2
        log = wal(os.path.join(d, "wal"))
        # the offsets name the files by path under the run's own dir
        return {"batches": [sink.rows_by_batch, sink2.rows_by_batch],
                "wal": json.loads(json.dumps(log).replace(d, "<d>"))}
    both(run, tmp_path)


def test_transient_read_failure_reoffers_instead_of_losing(
        tmp_path, monkeypatch):
    data = tmp_path / "data"
    data.mkdir()
    (data / "a.bin").write_bytes(b"payload")
    src = PIO.FileStreamSource(str(data),
                               checkpoint_location=str(tmp_path / "p.json"))
    real_read = PIO.read_binary_files
    fail = {"n": 1}

    def flaky(path, **kw):
        if fail["n"] > 0:
            fail["n"] -= 1
            raise OSError("transient NFS blip")
        return real_read(path, **kw)

    monkeypatch.setattr(PIO, "read_binary_files", flaky)
    meta = src.plan()
    assert src.read(meta).num_rows == 0
    src.ack(meta)
    meta2 = src.plan()
    assert meta2 is not None
    df = src.read(meta2)
    assert df.num_rows == 1 and list(df["bytes"]) == [b"payload"]
    src.ack(meta2)
    assert src.plan() is None


# -- captured traffic as a source ---------------------------------------------

class _P:
    def __init__(self, i, payload=None):
        self.rid = f"r{i}"
        self.trace = f"trace{i}"
        self.payload = payload or {"x": [float(i)], "label": i % 2}
        self.reply = b'{"scores": [0.25]}'


def _frame_rows(df):
    return [{c: df[c][i] if not isinstance(df[c][i], np.generic)
             else df[c][i].item() for c in df.columns}
            for i in range(df.num_rows)]


def test_capture_round_trip_and_cursor(tmp_path):
    def run(M, d):
        cap = M.Cap(os.path.join(d, "w"))
        cap.offer("v1", [_P(i) for i in range(5)])
        cap.stop()
        src = M.TLS(os.path.join(d, "w"))
        meta = src.plan(2)
        first = _frame_rows(src.read(meta))
        src.ack(meta)
        src2 = M.TLS(os.path.join(d, "w"))
        rest = _frame_rows(src2.read(src2.plan()))
        assert len(first) == 2 and len(rest) == 3
        assert first[0]["rid"] == "r0" and rest[0]["trace_id"] == "trace2"
        assert rest[1]["x"] == [3.0] and first[0]["scores"] == [0.25]
        # the event time is the capture's wall clock: not compared
        for r in first + rest:
            r.pop("event_time")
        return {"rows": first + rest, "meta": meta}
    both(run, tmp_path)


def test_torn_tail_and_shadow_rows(tmp_path):
    def run(M, d):
        os.makedirs(d)
        seg = os.path.join(d, "segment-000001.jsonl")
        good = json.dumps({"kind": "traffic", "t": 1.0, "rid": "a",
                           "request": {"x": 1}}).encode()
        with open(seg, "wb") as f:
            f.write(good + b"\n" + b'{"kind": "traffic", "t"')
        src = M.TLS(d)
        meta = src.plan()
        assert src.read(meta).num_rows == 1
        src.ack(meta)
        with open(seg, "ab") as f:
            f.write(b': 2.0, "rid": "b", "request": {"x": 2}}\n')
        tail = _frame_rows(src.read(src.plan()))
        assert [r["rid"] for r in tail] == ["b"]
        sd = os.path.join(d, "shadow")
        cap = M.Cap(sd, shadow_rows_per_batch=2)
        df = M.DF({"x": [1.0, 2.0, 3.0]})
        cap.offer_shadow("v1", "v2", df,
                         df.with_column("scores", [0.1, 0.2, 0.3]),
                         df.with_column("scores", [0.1, 0.9, 0.3]))
        cap.stop()
        assert cap.n_shadow_rows == 2
        live_only = M.TLS(sd)
        assert live_only.read(live_only.plan()).num_rows == 0
        both_kinds = M.TLS(sd, kinds=("traffic", "shadow"),
                           cursor_path=os.path.join(d, "c2.json"))
        rows = _frame_rows(both_kinds.read(both_kinds.plan()))
        assert rows[0]["kind"] == "shadow"
        assert rows[1]["live_scores"] == 0.2
        assert rows[1]["shadow_scores"] == 0.9
        for r in rows:
            r.pop("event_time")
        return {"tail": tail, "shadow": rows}
    both(run, tmp_path)


# -- fit_stream ---------------------------------------------------------------

ARCH = {"builder": "mlp", "hidden": [4], "num_outputs": 1}
START = PF.init(ARCH, (2,), seed=5).params


def _learner(M, ckpt_dir, **kw):
    return M.L(arch=dict(ARCH), model=M.F(arch=dict(ARCH), params=START),
               features_col="x", label_col="label", loss="squared_error",
               optimizer="adam", learning_rate=0.02, batch_size=16,
               checkpoint_dir=ckpt_dir, log_every=0,
               **(dict(device="cpu") if M is P else {}), **kw)


def _seed_traffic(M, capdir, n, seed=0):
    rng = np.random.default_rng(seed)

    class Req:
        def __init__(self, i):
            x = rng.normal(size=2)
            self.rid = f"seed-{seed}-{i}"
            self.trace = f"t{i}"
            self.payload = {"x": x.tolist(), "label": float(x.sum())}
            self.reply = b'{"scores": [0.0]}'

    cap = M.Cap(capdir)
    cap.offer("v1", [Req(i) for i in range(n)])
    cap.stop()


def _params_of(model):
    return jax.tree.map(np.asarray, model.model.params)


def test_fit_stream_from_bridged_weights_is_jaxs(tmp_path):
    from mmlspark_tpu_torch.io.checkpoint import verify_digest
    out = {}
    for M in (J, P):
        d = str(tmp_path / M.name)
        capdir = os.path.join(d, "cap")
        _seed_traffic(M, capdir, 48)
        fit = _learner(M, os.path.join(d, "train")).fit_stream(
            M.TLS(capdir), export_dir=os.path.join(d, "exp"),
            export_every_batches=1, checkpoint_dir=os.path.join(d, "wal"),
            max_batch_rows=16, min_batch_rows=16)   # batches of 16 rows
        fit.query.process_available()
        st = fit.status()["trainer"]
        assert st["n_batches_trained"] == 3 and st["n_rows_trained"] == 48
        assert st["n_exports"] == 3
        for path in fit.exports:
            assert verify_digest(path, strict=True) == (True, None)
        out[M.name] = (_params_of(fit.model()), st["last_loss"],
                       wal(os.path.join(d, "wal")))
    (jp, jl, jw), (pp, pl, pw) = out["jax"], out["port"]
    for a, b in zip(jax.tree.leaves(jp), jax.tree.leaves(pp)):
        assert float(np.abs(a - b).max()) < 1e-5
    assert abs(pl - jl) <= 1e-5 * max(1.0, abs(jl))
    assert pw == jw
    # the export loads and scores on the CPU
    from mmlspark_tpu_torch.core.stage import PipelineStage
    exp = os.path.join(str(tmp_path / "port"), "exp")
    m = PipelineStage.load(os.path.join(exp, sorted(os.listdir(exp))[-1]),
                           device="cpu")
    assert m.transform(PDF({"x": np.zeros((2, 2), np.float32)}))[
        "scores"].shape[0] == 2


@pytest.mark.parametrize("export_every", [1, 100], ids=["each", "sparse"])
def test_crash_mid_loop_replay_is_skipped_exactly_once(tmp_path,
                                                       export_every):
    capdir = str(tmp_path / "cap")
    _seed_traffic(P, capdir, 48)
    wal_dir, train = str(tmp_path / "wal"), str(tmp_path / "train")

    def make():
        return _learner(P, train).fit_stream(
            PTLS(capdir), export_dir=str(tmp_path / "exp"),
            export_every_batches=export_every, checkpoint_dir=wal_dir,
            max_batch_rows=16,
            retry_policy=PR.RetryPolicy(max_attempts=1))

    fit = make()
    inner = fit.query.sink

    class Crasher:                    # crash AFTER sink-side effects
        def process(self, bid, df):
            inner.process(bid, df)
            if bid == 2:
                raise RuntimeError("injected kill")

    fit.query.sink = Crasher()
    with pytest.raises(RuntimeError, match="injected kill"):
        fit.query.process_available()
    assert fit.query.state == "failed"
    run1 = inner.status()
    assert run1["last_trained_batch"] == 2
    fit2 = make()
    fit2.query.process_available()
    st = fit2.status()
    assert st["query"]["n_replayed_batches"] == 1
    assert st["trainer"]["n_replays_skipped"] == 1
    assert run1["n_rows_trained"] + st["trainer"]["n_rows_trained"] == 48


def test_unlabeled_rows_never_kill_the_retrain_query(tmp_path):
    def run(M, d):
        capdir = os.path.join(d, "cap")
        cap = M.Cap(capdir)

        class Req:
            def __init__(self, payload):
                self.rid = None
                self.trace = "t"
                self.payload = payload
                self.reply = b'{"scores": [0.0]}'

        cap.offer("v1", [Req({"x": [0.1, 0.2]}) for _ in range(4)])
        cap.flush()
        cap.offer("v1", [Req({"x": [0.1, 0.2], "label": 1.0}),
                         Req({"x": [0.3, 0.4]}),
                         Req({"x": [0.5, 0.6], "label": "oops"}),
                         Req({"x": [0.7, 0.8], "label": 2.0})])
        cap.stop()
        fit = _learner(M, os.path.join(d, "train")).fit_stream(
            M.TLS(capdir), max_batch_rows=4,
            checkpoint_dir=os.path.join(d, "wal"))
        fit.query.process_available()
        st = fit.status()
        assert st["query"]["state"] != "failed"
        tr = st["trainer"]
        assert tr["n_rows_trained"] == 2 and tr["n_rows_unlabeled"] == 6
        assert tr["n_batches_trained"] == 1
        return {k: tr[k] for k in ("n_rows_trained", "n_rows_unlabeled",
                                   "n_batches_trained", "global_step")}
    both(run, tmp_path)


def test_jax_train_state_warm_starts_the_port_stream(tmp_path):
    """A stream JAX trained (its train-state checkpoint holds the
    high-water batch id) continues in the port: replayed batches are
    skipped, new ones train from JAX's state."""
    capdir = str(tmp_path / "cap")
    _seed_traffic(J, capdir, 32)
    train = str(tmp_path / "train")
    jfit = _learner(J, train).fit_stream(
        JTLS(capdir, cursor_path=str(tmp_path / "jc.json")),
        max_batch_rows=16, min_batch_rows=16)
    jfit.query.process_available()
    _seed_traffic(J, os.path.join(capdir, "more"), 16, seed=1)
    pfit = _learner(P, train).fit_stream(
        PTLS(capdir, cursor_path=str(tmp_path / "pc.json")),
        max_batch_rows=16, min_batch_rows=16)
    pfit.query.process_available()
    st = pfit.status()["trainer"]
    assert st["n_replays_skipped"] == 2 and st["n_batches_trained"] == 1
    assert st["global_step"] == 3
    # JAX continues the same way from the same checkpoint
    jfit2 = _learner(J, str(tmp_path / "train_j")).fit_stream(
        JTLS(capdir, cursor_path=str(tmp_path / "jc2.json")),
        max_batch_rows=16, min_batch_rows=16)
    jfit2.query.process_available()
    for a, b in zip(jax.tree.leaves(_params_of(jfit2.model())),
                    jax.tree.leaves(_params_of(pfit.model()))):
        assert float(np.abs(a - b).max()) < 1e-5


# -- the retrain -> redeploy loop ---------------------------------------------

def test_end_to_end_retrain_loop(tmp_path, monkeypatch):
    import requests
    from mmlspark_tpu_torch.core import serialize
    from mmlspark_tpu_torch.core.stage import PipelineStage
    from mmlspark_tpu_torch.models.nn import NNModel
    from mmlspark_tpu_torch.serving import (
        ServingCoordinator, ServingServer, TrafficCapture)
    from mmlspark_tpu_torch.streaming import RetrainLoop, TrafficLogSource

    # stages the rollout loads land on the CPU, as a CPU worker's do
    monkeypatch.setattr(serialize, "_DEFAULT_LOAD_DEVICE", "cpu")
    fn = PF(arch=dict(ARCH), params=START)
    v1_dir = str(tmp_path / "v1")
    NNModel(model=fn, input_col="x", output_col="scores",
            device="cpu").save(v1_dir)
    capdir = str(tmp_path / "cap")
    warm = {"x": [0.0, 0.0], "label": 0.0}
    cap = TrafficCapture(capdir)
    workers = []
    coord = ServingCoordinator().start()
    stop = threading.Event()
    results = {"ok": 0, "bad": []}
    try:
        for i in range(2):
            srv = ServingServer(
                PipelineStage.load(v1_dir, device="cpu"), max_batch_size=4,
                max_latency_ms=1, model_version="v1",
                capture=cap if i == 0 else None, slow_trace_ms=None)
            srv.warmup(warm)
            srv.start()
            ServingCoordinator.register_worker(
                f"http://{coord.host}:{coord.port}", srv.host, srv.port)
            workers.append(srv)
        rng = np.random.default_rng(7)

        def traffic():
            i = 0
            while not stop.is_set():
                x = rng.normal(size=2)
                srv = workers[i % 2]
                try:
                    r = requests.post(
                        srv.address, json={"x": x.tolist(),
                                           "label": float(x.sum())},
                        headers={"X-Request-Id": f"e2e-{i}"}, timeout=10)
                    body = r.json()
                    if r.status_code == 200 and "scores" in body:
                        results["ok"] += 1
                    else:
                        results["bad"].append((i, r.status_code, body))
                except Exception as e:  # noqa: BLE001
                    results["bad"].append((i, "exc", str(e)))
                i += 1
                time.sleep(0.005)

        t = threading.Thread(target=traffic, daemon=True)
        t.start()
        fit = _learner(P, str(tmp_path / "train")).fit_stream(
            TrafficLogSource(capdir), export_dir=str(tmp_path / "exp"),
            export_every_batches=2, checkpoint_dir=str(tmp_path / "wal"),
            max_batch_rows=16)
        # one batch a poll: under steady traffic the source is never
        # idle, so draining it would not return
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline and not fit.exports:
            fit.query.process_available(max_batches=1)
            time.sleep(0.05)
        assert fit.exports, "fit_stream never exported a checkpoint"
        # the canary is judged on 50 requests, as chip_smoke.py's phase
        # 28 judges it: a host stall of tens of ms lands on any dispatch
        # (before the flip as after it), and out of 4 requests one such
        # is the p95
        loop = RetrainLoop(
            str(tmp_path / "exp"), f"http://{coord.host}:{coord.port}",
            warmup_payload=warm, poll_interval_s=0.1,
            rollout={"canary": True, "canary_min_requests": 50,
                     "canary_window_s": 15.0,
                     "stage_timeout_s": 60.0}).start()
        deadline = time.monotonic() + 90
        while time.monotonic() < deadline and loop.n_completed == 0 \
                and loop.n_failed == 0 and loop.n_rolled_back == 0:
            time.sleep(0.1)
        loop.stop()
        stop.set()
        t.join(timeout=10)
        status = loop.status()
        assert loop.n_completed == 1, status
        new_version = status["history"][-1]["version"]
        assert new_version.startswith("r")
        for srv in workers:
            v = requests.get(f"http://{srv.host}:{srv.port}/version",
                             timeout=5).json()
            assert v["active"]["version"] == new_version
            assert v["active"]["state"] == "active"
        # the fleet serves the export's function
        export = PipelineStage.load(os.path.join(str(tmp_path / "exp"),
                                                 new_version), device="cpu")
        probe = np.array([[0.5, -1.0], [2.0, 0.25]], np.float32)
        want = np.asarray(export.transform(PDF({"x": probe}))["scores"])
        for srv in workers:
            for row, w in zip(probe, want):
                r = requests.post(srv.address, json={"x": row.tolist()},
                                  timeout=10)
                got = np.asarray(r.json()["scores"], np.float64)
                assert np.abs(got - w).max() <= 1e-5 * max(
                    1.0, float(np.abs(w).max()))
        assert results["bad"] == []
        assert results["ok"] > 0
        assert status["history"][-1]["state"] == "completed"
    finally:
        stop.set()
        for srv in workers:
            srv.stop()
        coord.stop()
