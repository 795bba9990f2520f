"""The port's serving modules against the JAX package's on the same
inputs: the adaptive batcher, tenancy's buckets, registry and key
extraction, the SLO engine, incident bundles, the wire quantizer, the
bucket ladder at ``multiple`` > 1, the HTTP client's retries and
breaker, the model-version manager, traffic capture and the metrics
pusher. Clocks are ``ManualClock``s wherever a module takes one, so both
sides see the same times. And ``import mmlspark_tpu_torch.serving``
without ``requests``.
"""

import json
import logging
import os
import subprocess
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

from mmlspark_tpu.core import logs as JL
from mmlspark_tpu.core import profiler as JPROF
from mmlspark_tpu.core import resilience as JR
from mmlspark_tpu.core import telemetry as JTM
from mmlspark_tpu.core import tsdb as JTS
from mmlspark_tpu.io import http as JH
from mmlspark_tpu.parallel import sharding as JSH
from mmlspark_tpu.serving import capture as JCAP
from mmlspark_tpu.serving import incident as JINC
from mmlspark_tpu.serving import policy as JPOL
from mmlspark_tpu.serving import quant as JQ
from mmlspark_tpu.serving import slo as JSLO
from mmlspark_tpu.serving import tenancy as JTEN
from mmlspark_tpu_torch.core import logs as PL
from mmlspark_tpu_torch.core import profiler as PPROF
from mmlspark_tpu_torch.core import resilience as PR
from mmlspark_tpu_torch.core import telemetry as PTM
from mmlspark_tpu_torch.core import tsdb as PTS
from mmlspark_tpu_torch.core.params import Param
from mmlspark_tpu_torch.core.stage import Transformer
from mmlspark_tpu_torch.io import http as PH
from mmlspark_tpu_torch.parallel import sharding as PSH
from mmlspark_tpu_torch.serving import capture as PCAP
from mmlspark_tpu_torch.serving import incident as PINC
from mmlspark_tpu_torch.serving import policy as PPOL
from mmlspark_tpu_torch.serving import quant as PQ
from mmlspark_tpu_torch.serving import rollout as PRO
from mmlspark_tpu_torch.serving import slo as PSLO
from mmlspark_tpu_torch.serving import tenancy as PTEN

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---------------------------------------------------------------------------
# the adaptive batcher


def _hist_stats(per_bucket):
    """Synthetic per-bucket dispatch histograms: every sample in the
    bucket that contains its service time."""
    edges = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0)

    def counts(ms, n):
        out = [0] * (len(edges) + 1)
        for i, e in enumerate(edges):
            if ms <= e:
                out[i] = n
                return out
        out[-1] = n
        return out

    return lambda: [(b, edges, counts(ms, n))
                    for b, (ms, n) in per_bucket.items()]


def _policy_trace(pol_mod, clock_mod):
    clock = clock_mod.ManualClock()
    stats = _hist_stats({1: (1.5, 40), 2: (1.6, 40), 4: (2.5, 40),
                         8: (3.5, 40)})
    pol = pol_mod.AdaptiveBatchPolicy(stats, [1, 2, 4, 8],
                                      ceiling_ms=10.0, min_count=32,
                                      max_gap_s=5.0, clock=clock)
    pol.refresh()
    rng = np.random.default_rng(0)
    out = [pol.decide_wait_ms(1)]
    for gap_lo, gap_hi, n in ((4e-4, 6e-4, 200), (2e-3, 4e-3, 60),
                              (0.04, 0.06, 50)):
        for _ in range(n):
            clock.advance(float(rng.uniform(gap_lo, gap_hi)))
            pol.note_arrival()
        out.append((pol.rate_per_s,
                    [pol.decide_wait_ms(k) for k in (1, 2, 4, 8)]))
    clock.advance(60.0)
    pol.note_arrival()
    out.append(pol.rate_per_s)
    return out


def test_adaptive_batch_policy_decisions_match():
    assert _policy_trace(PPOL, PR) == _policy_trace(JPOL, JR)


def test_priority_shed_policy_matches():
    for hw in (0.0, 0.5, 0.8, 1.0):
        jp = JPOL.PriorityShedPolicy(high_water=hw)
        pp = PPOL.PriorityShedPolicy(high_water=hw)
        for prio in JPOL.PRIORITY_CLASSES + ("unknown",):
            assert pp.threshold(prio) == jp.threshold(prio)
            for depth in range(0, 40, 3):
                assert pp.should_shed(depth, 32, prio) == \
                    jp.should_shed(depth, 32, prio)


# ---------------------------------------------------------------------------
# tenancy


class _D(dict):
    def get(self, k, d=None):
        return dict.get(self, k, d)


@pytest.mark.parametrize("headers", [
    {}, {"X-Api-Key": "ka"}, {"Authorization": "Bearer kb"},
    {"X-Api-Key": "ka", "Authorization": "Bearer kb"},
    {"Authorization": "bearer   kc  "}, {"Authorization": "Basic zz"},
    {"X-Api-Key": "  "}, {"Authorization": "Bearer"},
])
def test_extract_api_key_matches(headers):
    assert PTEN.extract_api_key(_D(headers)) == \
        JTEN.extract_api_key(_D(headers))


def _bucket_trace(ten, clock_mod):
    clock = clock_mod.ManualClock()
    b = ten.TokenBucket(rate_per_s=2.0, burst=3, clock=clock)
    out = []
    for dt in (0.0, 0.0, 0.0, 0.0, 0.1, 0.4, 1.7, 0.0, 0.0, 10.0):
        clock.advance(dt)
        out.append((b.try_acquire(), round(b.retry_after(), 9)))
    return out


def test_token_bucket_matches():
    assert _bucket_trace(PTEN, PR) == _bucket_trace(JTEN, JR)


_REG_CFG = {"tenants": [
    {"id": "alice", "priority": "interactive", "api_keys": ["ka"],
     "max_inflight": 2, "weight": 2.0},
    {"id": "bob", "priority": "background", "api_keys": ["kb"],
     "rate_per_s": 0.5, "burst": 1, "max_cache_pages": 4},
]}


def _registry_trace(ten, clock_mod, policy):
    clock = clock_mod.ManualClock()
    reg = ten.TenantRegistry.from_value(
        dict(_REG_CFG, unknown_key_policy=policy), clock=clock)
    out = []
    held = []
    for key, dt in (("ka", 0), ("ka", 0), ("ka", 0), ("kb", 0),
                    ("kb", 0.5), ("kb", 2.1), (None, 0), ("zz", 0)):
        clock.advance(dt)
        tenant = reg.resolve(PTEN.extract_api_key(
            _D({"X-Api-Key": key} if key else {})))
        if tenant is None:
            out.append("reject")
            continue
        res = reg.admit(tenant)
        out.append((tenant.id, res))
        if res is None:
            held.append(tenant.id)
    out.append(sorted((r["id"], r["inflight"], r["n_requests"],
                       r["n_shed_rate"], r["n_shed_concurrency"])
                      for r in reg.stats()["tenants"]))
    for t in held:
        reg.release(t)
    out.append(sorted((r["id"], r["inflight"])
                      for r in reg.stats()["tenants"]))
    return out


@pytest.mark.parametrize("policy", ["anonymous", "reject"])
def test_tenant_registry_admission_matches(policy):
    assert _registry_trace(PTEN, PR, policy) == \
        _registry_trace(JTEN, JR, policy)


def test_tenant_registry_from_env_matches(monkeypatch):
    monkeypatch.setenv("MMLSPARK_TENANTS", json.dumps(_REG_CFG))
    j, p = JTEN.TenantRegistry.from_env(), PTEN.TenantRegistry.from_env()
    assert sorted(p.tenants) == sorted(j.tenants)
    for tid in j.tenants:
        assert p.tenants[tid].to_dict() == j.tenants[tid].to_dict()


# ---------------------------------------------------------------------------
# the SLO engine

_FAST = ((60.0, 10.0, 2.0),)


def _slo_trace(slo, tm, clock_mod):
    clock = clock_mod.ManualClock()
    m = tm.MetricsRegistry(clock=clock)
    total = m.counter("req_total", "t.")
    bad = m.counter("err_total", "e.")
    lat = m.histogram("lat_ms", "l.", buckets=(5.0, 10.0, 50.0, 100.0))
    events = []

    class _N:
        def notify(self, ev):
            events.append({k: v for k, v in ev.items()
                           if k not in ("at_unix",)})

    eng = slo.SLOEngine(m, [
        slo.SLOPolicy("avail", "availability", 0.9,
                      total_metric="req_total", bad_metric="err_total",
                      windows=_FAST, for_s=0.0, resolve_after_s=20.0),
        slo.SLOPolicy("lat", "latency", 0.9, metric="lat_ms",
                      threshold_ms=10.0, windows=_FAST,
                      resolve_after_s=20.0)],
        clock=clock, notifier=_N())
    reps = [eng.evaluate()]
    script = [(100, 0, 3.0)] * 3 + [(100, 60, 80.0)] * 2 + \
        [(100, 0, 3.0)] * 12
    for n, nbad, ms in script:
        clock.advance(5.0)
        total.labels().inc(n)
        bad.labels().inc(nbad)
        for _ in range(10):
            lat.labels().observe(ms)
        reps.append(eng.evaluate())
    rows = [[(p["policy"], p["state"], p["violated"],
              [(round(w["burn_long"], 9), round(w["burn_short"], 9))
               for w in p["windows"]]) for p in r["policies"]]
            for r in reps]
    return rows, events, sorted(eng.alerts())


def test_slo_engine_burn_rates_and_transitions_match():
    p = _slo_trace(PSLO, PTM, PR)
    j = _slo_trace(JSLO, JTM, JR)
    assert p == j
    assert any(e["type"] == "firing" for e in p[1])
    assert any(e["type"] == "resolved" for e in p[1])


# ---------------------------------------------------------------------------
# incident bundles

_STACK = ("app/main.py:serve:10", "core/pipe.py:encode:33",
          "np/dense.py:dot:7")


def _firing(at=100.0):
    return {"type": "firing", "policy": "p95-regression",
            "slo_kind": "anomaly", "expr": "chaos:p95", "at_mono": at,
            "at_unix": 1754000000.0 + at, "value": 42.0, "z": 9.0,
            "direction": "high"}


def _bundle(directory, inc, ts, prof, logs, clock_mod):
    clock = clock_mod.ManualClock()
    clock.advance(100.0)
    store = ts.TimeSeriesStore()
    for t in range(0, 101, 10):
        store.write(float(t), "chaos:p95", {}, float(t), kind="g")
    sp = prof.SamplingProfiler(hz=1.0, retention_s=300.0, clock=clock)
    for t in range(0, 101):
        sp.record_stacks(float(t), [(1, "MainThread", _STACK)])
    ring = logs.LogRing(capacity=64)
    ring.handle(logging.LogRecord("serving.test", logging.WARNING,
                                  __file__, 1, "p95 regression observed",
                                  (), None))
    mgr = inc.IncidentManager(
        directory, tsdb=store, tracer=None, profiler=sp, log_ring=ring,
        stats_fn=lambda: {"n_requests": 7}, related_exprs=["chaos:p95"],
        clock=clock, cooldown_s=30.0, profile_pre_s=20.0,
        profile_post_s=0.0, lookback_s=200.0, series_step_s=10.0)
    inc_id = mgr.capture(_firing())
    inc_dir = os.path.join(directory, inc_id)
    files = {}
    for name in sorted(os.listdir(inc_dir)):
        with open(os.path.join(inc_dir, name), "rb") as f:
            files[name] = f.read()
    suppressed = mgr.capture(_firing(at=110.0))
    return files, suppressed


def _scrub(obj):
    """A bundle file's JSON without its wall-clock and path fields."""
    drop = ("created_unix", "at_unix", "sha256", "bytes", "path", "dir",
            "created", "ts", "time", "pid", "thread", "lineno",
            "pathname", "filename", "module", "id", "logger", "name")
    if isinstance(obj, dict):
        return {k: _scrub(v) for k, v in obj.items() if k not in drop}
    if isinstance(obj, list):
        return [_scrub(v) for v in obj]
    return obj


def test_incident_bundle_contents_match(tmp_path):
    pf, ps = _bundle(str(tmp_path / "p"), PINC, PTS, PPROF, PL, PR)
    jf, js = _bundle(str(tmp_path / "j"), JINC, JTS, JPROF, JL, JR)
    assert ps is None and js is None     # the cooldown holds on both
    assert sorted(pf) == sorted(jf) == sorted(PINC.BUNDLE_FILES)
    for name in pf:
        if name.endswith(".json"):
            assert _scrub(json.loads(pf[name])) == \
                _scrub(json.loads(jf[name])), name
        else:
            assert pf[name] == jf[name], name


# ---------------------------------------------------------------------------
# the wire quantizer and the bucket ladder


@pytest.mark.parametrize("cfg", [
    {"wire_dtype": "uint8"},
    {"wire_dtype": "int8", "scale": 0.5, "zero_point": -3.0},
    {"wire_dtype": "uint8", "columns": ["x"],
     "compute": {"activation_dtype": "float32", "tolerance": 0.1}},
])
def test_quantize_column_byte_equal(cfg):
    rng = np.random.default_rng(3)
    arr = np.concatenate([rng.normal(0, 200, 64), [-1e9, 1e9, 0.5, -0.5,
                                                   255.5, -128.5]])
    jq, pq = JQ.QuantizationConfig.from_value(cfg), \
        PQ.QuantizationConfig.from_value(cfg)
    assert pq.to_dict() == jq.to_dict()
    for a in (arr, arr.astype(np.float32), arr.reshape(2, -1),
              np.array(["a", "b"], dtype=object)):
        jo, po = jq.quantize_column(a), pq.quantize_column(a)
        assert po.dtype == jo.dtype and po.shape == jo.shape
        assert po.tobytes() == jo.tobytes() if po.dtype != object \
            else list(po) == list(jo)


@pytest.mark.parametrize("bad", [
    {"wire_dtype": "float16"}, {"wire_dtype": "uint8", "scale": 0},
    {"wire_dtype": "uint8", "zero_point": float("nan")},
    {"wire_dtype": "uint8", "compute": {"weight_dtype": "int4"}},
    {"wire_dtype": "none", "scale": 0.5}, {"nope": 1},
])
def test_quantization_config_refusals_match(bad):
    with pytest.raises(ValueError) as je:
        JQ.QuantizationConfig.from_value(bad)
    with pytest.raises(ValueError) as pe:
        PQ.QuantizationConfig.from_value(bad)
    assert str(pe.value) == str(je.value)


@pytest.mark.parametrize("multiple", [1, 2, 3, 8, 200])
def test_bucket_ladder_at_multiples_matches(multiple):
    for cap in (1, 7, 8, 100, 1024):
        assert PSH.bucket_ladder(cap, multiple) == \
            JSH.bucket_ladder(cap, multiple)
        for n in range(0, 2 * cap + 3):
            assert PSH.bucket_target(n, cap, multiple) == \
                JSH.bucket_target(n, cap, multiple)
    assert PSH.bucket_target(5, 64) == JSH.bucket_target(5, 64)
    rng = np.random.default_rng(multiple)
    for n in (0, 1, 5, 9, 130):
        arr = rng.normal(size=(n, 3))
        for mode in ("constant", "edge"):
            jp, jn = JSH.pad_to_bucket(arr, cap=16, pad_mode=mode,
                                       multiple=multiple)
            pp, pn = PSH.pad_to_bucket(arr, cap=16, pad_mode=mode,
                                       multiple=multiple)
            assert pn == jn and np.array_equal(pp, jp)
        jp, jn = JSH.padded_device_batch(arr, 16, bucket=True,
                                         multiple=multiple)
        pp, pn = PSH.padded_device_batch(arr, 16, bucket=True,
                                         multiple=multiple)
        assert isinstance(pp, np.ndarray) and np.array_equal(pp, jp)
        assert np.array_equal(PSH.unpad(pp, pn), arr)


def test_padded_device_batch_places_a_tensor():
    import torch
    t, n = PSH.padded_device_batch(np.ones((3, 2), np.float32), 4,
                                   placement="cpu")
    assert isinstance(t, torch.Tensor) and tuple(t.shape) == (4, 2)
    assert n == 3 and float(t[3].abs().sum()) == 0.0


# ---------------------------------------------------------------------------
# the HTTP client against a stdlib server


class _Recorder(BaseHTTPRequestHandler):
    """Answers 503 to the first ``fail_first`` POSTs of its server
    (``always_fail`` for every one), 200 with the body echoed
    otherwise; records every POST."""

    def do_POST(self):  # noqa: N802 — the stdlib's name
        srv = self.server
        body = self.rfile.read(int(self.headers.get("Content-Length", 0)))
        with srv.lock:
            srv.seen.append((self.path, dict(self.headers), body))
            fail = srv.always_fail or len(srv.seen) <= srv.fail_first
        code = 503 if fail else 200
        out = b'{"error": "busy"}' if fail else body
        self.send_response(code)
        if fail:
            self.send_header("Retry-After", "0")
        self.send_header("Content-Length", str(len(out)))
        self.end_headers()
        self.wfile.write(out)

    def log_message(self, *args):
        pass


def _recording_server(fail_first=0, always_fail=False):
    srv = ThreadingHTTPServer(("127.0.0.1", 0), _Recorder)
    srv.seen, srv.lock = [], threading.Lock()
    srv.fail_first, srv.always_fail = fail_first, always_fail
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


def _client_trace(h, r):
    out = []
    for fail_first, always in ((2, False), (0, True)):
        srv = _recording_server(fail_first, always)
        try:
            url = f"http://127.0.0.1:{srv.server_address[1]}/x"
            client = h.HTTPClient(
                policy=r.RetryPolicy(max_attempts=3, base=0.001,
                                     cap=0.002, seed=0),
                breakers=r.BreakerBoard(failure_threshold=2,
                                        reset_timeout=60.0),
                timeout=5.0)
            reqs = [h.HTTPRequestData.post_json(url, {"i": i})
                    for i in range(3)] + [None]
            resps = client.send(reqs)
            out.append([(x.status_code, x.body,
                         x.reason.split(":")[0] if x.status_code == 0
                         else None) if x is not None else None
                        for x in resps])
            out.append([(p, json.loads(b)) for p, _, b in srv.seen])
            client.close()
        finally:
            srv.shutdown()
            srv.server_close()
    return out


def test_http_client_retries_and_breaker_match():
    p, j = _client_trace(PH, PR), _client_trace(JH, JR)
    assert p == j
    # the breaker opened after two failed sends: the third never left
    assert p[2][2] == (0, None, "circuit open")


# ---------------------------------------------------------------------------
# the metrics pusher


def test_metrics_pusher_pushes_through_the_port_client():
    srv = _recording_server()
    try:
        url = f"http://127.0.0.1:{srv.server_address[1]}/metrics/job/t"
        bodies = {}
        for name, tm, r in (("port", PTM, PR), ("jax", JTM, JR)):
            reg = tm.MetricsRegistry()
            reg.counter("push_test_total", "pushes.").inc(7)
            reg.gauge("push_test_depth", "depth.").set(3)
            before = len(srv.seen)
            p = tm.MetricsPusher(url, registries=(reg,), interval_s=0.05,
                                 policy=r.RetryPolicy(max_attempts=2,
                                                      base=0.001))
            p.start()
            t_end = time.monotonic() + 10
            while len(srv.seen) - before < 2 and time.monotonic() < t_end:
                time.sleep(0.01)
            n_periodic = len(srv.seen) - before
            p.stop()                     # the final flush
            assert n_periodic >= 2
            assert len(srv.seen) - before >= n_periodic + 1
            assert p.n_errors == 0 and p.last_status == 200
            bodies[name] = {b for path, _, b in srv.seen[before:]}
        assert bodies["port"] == bodies["jax"]
        (body,) = bodies["port"]
        assert b"push_test_total 7" in body
    finally:
        srv.shutdown()
        srv.server_close()


# ---------------------------------------------------------------------------
# the model-version manager with a port stage


class ScaleX(Transformer):
    """``y = x * scale``: a persistable port stage, the versionable
    model of these tests."""

    scale = Param(1.0, "multiplier", ptype=float)

    def transform(self, df):
        return df.with_column(
            "y", np.asarray(df["x"], dtype=np.float64) * float(self.scale))


def test_version_manager_stage_flip_rollback(tmp_path):
    import requests
    from mmlspark_tpu_torch.serving import ServingServer
    v2 = str(tmp_path / "v2")
    ScaleX(scale=3.0).save(v2)
    with ServingServer(ScaleX(scale=2.0), port=0, max_batch_size=8,
                       max_latency_ms=1, slow_trace_ms=None) as srv:
        base = f"http://{srv.host}:{srv.port}"
        r1 = requests.post(base + "/predict", json={"x": 5.0},
                           headers={"X-Request-Id": "swap-rid"},
                           timeout=10)
        assert r1.json() == {"y": 10.0}
        srv.versions.stage(source=v2, version="v2", sync=True)
        mv = srv.versions.staged
        assert mv.state == "staged" and mv.digest_verified is True
        srv.versions.flip(version="v2")
        assert requests.post(base + "/predict", json={"x": 5.0},
                             timeout=10).json() == {"y": 15.0}
        r3 = requests.post(base + "/predict", json={"x": 5.0},
                           headers={"X-Request-Id": "swap-rid"},
                           timeout=10)
        assert r3.content == r1.content
        assert r3.headers.get("X-Replayed") == "1"
        assert srv.versions.previous.version == "v1"
        srv.versions.rollback()
        assert srv.versions.active.version == "v1"
        assert srv.versions.n_rollbacks == 1
        assert requests.post(base + "/predict", json={"x": 5.0},
                             timeout=10).json() == {"y": 10.0}
        with pytest.raises(PRO.RolloutError):
            srv.versions.rollback()


def test_version_manager_refuses_a_jax_stage(tmp_path):
    from mmlspark_tpu.stages import ScaleColumn
    from mmlspark_tpu_torch.serving import ServingServer
    v2 = str(tmp_path / "jax-v2")
    ScaleColumn(input_col="x", output_col="y", scale=3.0).save(v2)
    with ServingServer(ScaleX(scale=2.0), port=0,
                       max_latency_ms=1, slow_trace_ms=None) as srv:
        srv.versions.stage(source=v2, version="v2", sync=True)
        assert srv.versions.staged.state == "error"
        assert "JAX package" in srv.versions.staged.error


# ---------------------------------------------------------------------------
# traffic capture


class _P:
    def __init__(self, i):
        self.rid = f"r{i}"
        self.trace = f"trace{i}"
        self.payload = {"x": [float(i)], "label": i % 2}
        self.reply = b'{"scores": [0.25]}'


def _capture_rows(cap_mod, frame, directory):
    cap = cap_mod.TrafficCapture(directory, max_segment_bytes=1024,
                                 max_segments=3, shadow_rows_per_batch=2)
    x = np.array([1.0, 2.0, 3.0])
    df = frame({"x": x})
    live, shadow = frame({"x": x, "y": x * 2}), frame({"x": x, "y": x * 3})
    for i in range(40):
        cap.offer("v1", [_P(i), _P(i + 100)])
        if i % 5 == 0:
            cap.offer_shadow("v1", "v2", df, live, shadow)
        cap.flush()
    cap.stop()
    segs = sorted(n for n in os.listdir(directory) if n.endswith(".jsonl"))
    rows = []
    for name in segs:
        with open(os.path.join(directory, name)) as f:
            rows += [{k: v for k, v in json.loads(ln).items() if k != "t"}
                     for ln in f if ln.strip()]
    return segs, rows, {k: v for k, v in vars(cap).items()
                        if k.startswith("n_")}


def test_traffic_capture_segments_match(tmp_path):
    from mmlspark_tpu.core.dataframe import DataFrame as JDF
    from mmlspark_tpu_torch.core.dataframe import DataFrame as PDF
    p = _capture_rows(PCAP, PDF, str(tmp_path / "p"))
    j = _capture_rows(JCAP, JDF, str(tmp_path / "j"))
    assert p == j
    assert len(p[0]) == 3 and p[2]["n_segments_pruned"] > 0
    assert any(r["kind"] == "shadow" for r in p[1])


# ---------------------------------------------------------------------------
# the import surface


def test_serving_imports_without_requests():
    """``import mmlspark_tpu_torch.serving`` must not need ``requests``
    (the card machine may lack it): a finder that refuses ``requests``
    runs ahead of the import."""
    code = (
        "import sys\n"
        "class _Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] == 'requests':\n"
        "            raise ImportError('requests is blocked')\n"
        "sys.meta_path.insert(0, _Block())\n"
        "import mmlspark_tpu_torch.serving as S\n"
        "from mmlspark_tpu_torch.io.http import HTTPClient\n"
        "assert 'requests' not in sys.modules\n"
        "print(len(S.__all__))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "27"   # the JAX list, in full
