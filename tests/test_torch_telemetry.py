"""The port's telemetry (``mmlspark_tpu_torch.core.telemetry``) against
the JAX package's on the same operations.

One script of counter, gauge and histogram operations (labels, a
``BoundedLabelSet`` past its cap, exemplars under a bound trace id,
function-backed children, a ``Histogram.time`` span on a
``ManualClock``) runs on a registry of each package. The exposition
(classic and OpenMetrics), the parsed and merged scrapes, the
remote-write protobuf, the quantile estimates and the snapshot files
must be equal byte for byte; exemplar timestamps are wall-clock and are
normalised first. ``serving_build_info`` differs by design: torch, CUDA
and the card's name take the place of jax and jaxlib.
"""

import re

import pytest
import torch

from mmlspark_tpu.core import resilience as JR
from mmlspark_tpu.core import telemetry as JTM
from mmlspark_tpu_torch.core import resilience as PR
from mmlspark_tpu_torch.core import telemetry as PTM

torch.set_num_threads(1)

SIDES = {"jax": (JTM, JR), "port": (PTM, PR)}
_EXEMPLAR_TS = re.compile(r"(# \{trace_id=\"[^\"]*\"\} \S+) \S+")


def drive(tm, res):
    """The same operations on a fresh registry of one package; returns
    the registry and the function-backed value's holder."""
    clock = res.ManualClock(100.0)
    m = tm.MetricsRegistry(clock=clock)
    req = m.counter("requests_total", 'Requests "served"\nby route.',
                    labels=("route", "code"))
    req.labels("/predict", 200).inc()
    req.labels("/predict", 200).inc(2.5)
    req.labels("/generate", 429).inc()
    req.labels('we"ird\\path\n', 500).inc(7)
    m.counter("plain_total", "No labels.").inc(3)
    held = {"v": 11}
    m.counter("fn_total", "Function-backed.").set_function(
        lambda: held["v"])
    g = m.gauge("depth", "Queue depth.", labels=("queue",))
    g.labels("a").set(5)
    g.labels("a").inc(2)
    g.labels("a").dec(0.5)
    g.labels("b").set(float("inf"))
    m.gauge("slots", "Function gauge.").set_function(lambda: 4)
    bounded = tm.BoundedLabelSet(cap=2)
    over = m.counter("tenant_total", "Per tenant.", labels=("tenant",))
    for t in ("t1", "t2", "t3", "t1", "t4"):
        key, _ = bounded.key(t)
        over.labels(key).inc()
    h = m.histogram("lat_ms", "Latency.", labels=("bucket",))
    for v in (0.05, 0.3, 0.3, 7.0, 99.0, 12000.0):
        h.labels("16").observe(v)
    with tm.trace_context("trace-abc"):
        h.labels("32").observe(3.0)
        h.labels("32").observe(3000.0)
    with h.labels("64").time():
        clock.advance(0.0125)
    toks = m.histogram("tokens", "Tokens.", buckets=(1.0, 2.0, 4.0, 8.0))
    for v in (1, 3, 3, 9):
        toks.observe(float(v))
    return m, held, bounded


@pytest.fixture(scope="module")
def driven():
    return {side: drive(*mods) for side, mods in SIDES.items()}


def test_exposition_is_byte_equal(driven):
    (jm, jheld, jb), (pm, pheld, pb) = driven["jax"], driven["port"]
    assert pm.render() == jm.render()
    jheld["v"] = pheld["v"] = 12
    assert pm.render() == jm.render()
    assert "fn_total 12" in pm.render()
    assert pb.n_overflowed == jb.n_overflowed == 2
    assert pb.values() == jb.values()


def test_openmetrics_exemplars_are_byte_equal(driven):
    jm, pm = driven["jax"][0], driven["port"][0]
    jtext = _EXEMPLAR_TS.sub(r"\1 TS", jm.render(exemplars=True))
    ptext = _EXEMPLAR_TS.sub(r"\1 TS", pm.render(exemplars=True))
    assert ptext == jtext
    assert '# {trace_id="trace-abc"} 3 TS' in ptext


def test_parse_merge_and_remote_write_are_equal(driven):
    jm, pm = driven["jax"][0], driven["port"][0]
    jtext, ptext = jm.render(), pm.render()
    assert PTM.parse_prometheus(ptext) == JTM.parse_prometheus(jtext)
    jmerged = JTM.merge_prometheus([jtext, jtext])
    pmerged = PTM.merge_prometheus([ptext, ptext])
    assert pmerged == jmerged
    assert PTM.render_samples(pmerged) == JTM.render_samples(jmerged)
    extra = (("worker", "w0"),)
    assert PTM.encode_write_request(pm, ts_ms=1234, extra_labels=extra) \
        == JTM.encode_write_request(jm, ts_ms=1234, extra_labels=extra)
    assert PTM.collect_samples(pm) == JTM.collect_samples(jm)
    assert PTM.snappy_available() == JTM.snappy_available()


def _children(reg, name):
    (fam,) = [f for f in reg.families() if f.name == name]
    return fam.buckets, sorted(fam.children())


@pytest.mark.parametrize("q", [0.0, 0.1, 0.5, 0.9, 0.99, 1.0])
def test_quantile_from_buckets(driven, q):
    edges = JTM.DEFAULT_LATENCY_BUCKETS_MS
    counts = [0, 3, 1, 0, 0, 4, 2, 0, 0, 0, 0, 0, 0, 1, 0, 0, 5]
    assert PTM.quantile_from_buckets(edges, counts, q) == \
        JTM.quantile_from_buckets(edges, counts, q)
    jedges, jh = _children(driven["jax"][0], "lat_ms")
    pedges, ph = _children(driven["port"][0], "lat_ms")
    assert pedges == jedges and [k for k, _ in ph] == [k for k, _ in jh]
    for (_, jc), (_, pc) in zip(jh, ph):
        js, ps = jc.stats(), pc.stats()
        assert ps == js
        assert PTM.quantile_from_buckets(pedges, ps["buckets"], q) == \
            JTM.quantile_from_buckets(jedges, js["buckets"], q)
    assert PTM.log_buckets(0.2, 700.0) == JTM.log_buckets(0.2, 700.0)


def test_write_snapshot_names_and_contents(driven, tmp_path):
    jm, pm = driven["jax"][0], driven["port"][0]
    files = {}
    for side, tm, reg in (("jax", JTM, jm), ("port", PTM, pm)):
        d = tmp_path / side
        for step in range(4):
            tm.snapshot_registries(str(d), tag=f"step{step:08d}",
                                   registries=(reg,), keep=3)
        tm.write_snapshot(str(d), "x 1\n", tag="other", prefix="extra")
        files[side] = {p.name: p.read_text() for p in sorted(d.iterdir())}
    assert files["port"] == files["jax"]
    assert sorted(files["port"]) == [
        "extra-other.prom", "metrics-step00000001.prom",
        "metrics-step00000002.prom", "metrics-step00000003.prom"]


def test_trace_ids_and_headers():
    for raw in ("abc-123", "a b=c;d", "", None, "x" * 200):
        assert PTM.sanitize_trace_id(raw) == JTM.sanitize_trace_id(raw)
    assert PTM.trace_id_from_headers({"X-Trace-Id": "ok.1"}) == "ok.1"
    with PTM.trace_context("t-1") as tid:
        assert PTM.current_trace_id() == tid == "t-1"
    assert PTM.current_trace_id() is None
    assert PTM.CONTENT_TYPE == JTM.CONTENT_TYPE
    assert PTM.OPENMETRICS_CONTENT_TYPE == JTM.OPENMETRICS_CONTENT_TYPE


def test_build_info_labels_differ_as_designed():
    jm, pm = JTM.MetricsRegistry(), PTM.MetricsRegistry()
    jinfo = JTM.register_build_info(jm, frontend="threaded")
    pinfo = PTM.register_build_info(pm, frontend="threaded")
    (jfam,), (pfam,) = jm.families(), pm.families()
    assert pfam.name == jfam.name == "serving_build_info"
    assert pfam.help == jfam.help and pfam.kind == jfam.kind
    assert jfam.label_names == ("version", "jax", "jaxlib", "device_kind",
                                "frontend")
    assert pfam.label_names == ("version", "torch", "cuda", "device_kind",
                                "frontend")
    assert set(pinfo) - set(jinfo) == {"torch", "cuda"}
    assert set(jinfo) - set(pinfo) == {"jax", "jaxlib"}
    assert pinfo["torch"] == torch.__version__
    if not torch.cuda.is_available():
        assert pinfo["cuda"] == pinfo["device_kind"] == "none"
    (key, child), = pfam.children()
    assert child.value == 1.0 and key[-1] == "threaded"


def test_metrics_pusher_is_refused_by_name():
    """The pusher is built now that the port has its HTTP client (its
    pushes are held against JAX's in ``test_torch_serving_modules.py``);
    what it still refuses by name is an unknown wire format, with JAX's
    message."""
    p = PTM.MetricsPusher("http://localhost:1/metrics/job/x")
    assert p.format == "text" and p.n_pushes == 0
    with pytest.raises(ValueError) as pe:
        PTM.MetricsPusher("http://localhost:1/metrics/job/x",
                          format="json")
    with pytest.raises(ValueError) as je:
        JTM.MetricsPusher("http://localhost:1/metrics/job/x",
                          format="json")
    assert str(pe.value) == str(je.value)
