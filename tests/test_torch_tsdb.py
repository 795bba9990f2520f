"""The port's metrics TSDB (``mmlspark_tpu_torch.core.tsdb``) against the
JAX package's on the same scrapes.

A registry of each package takes the same updates (requests by route,
a latency histogram by bucket, decode tokens, per-tenant device time, a
gauge) tick by tick; each tick a ``Recorder`` of its own package
scrapes it at the same ``ManualClock`` time, runs the stock serving
recording rules and an anomaly detector with the stock decode watches
plus one level watch. Mid-run the registry resets (a worker restart).
The same list of instant and range queries (selectors, matchers,
``rate``, ``increase``, ``quantile``, recorded series) must give equal
results, the malformed ones (an aggregation the grammar does not have
among them) the same ``QueryError``, and the detectors the same firing
sequence.
"""

import pytest
import torch

from mmlspark_tpu.core import resilience as JR
from mmlspark_tpu.core import telemetry as JTM
from mmlspark_tpu.core import tsdb as JTS
from mmlspark_tpu_torch.core import resilience as PR
from mmlspark_tpu_torch.core import telemetry as PTM
from mmlspark_tpu_torch.core import tsdb as PTS

torch.set_num_threads(1)

SIDES = {"jax": (JTM, JTS, JR), "port": (PTM, PTS, PR)}
TIERS = ((0.0, 30.0), (5.0, 120.0), (30.0, 900.0))
N_TICKS = 60
RESET_AT = 35
EXPRS = [
    "serving_requests_total",
    'serving_requests_total{route="/a"}',
    'serving_requests_total{route!="/a"}',
    'serving_requests_total{route=~"/(a|b)"}',
    'serving_requests_total{route!~"/a.*"}',
    "rate(serving_requests_total[10s])",
    'rate(serving_requests_total{route="/b"}[30s])',
    "increase(serving_requests_total[60s])",
    "quantile(0.95, serving_dispatch_latency_ms[60s])",
    'quantile(0.5, serving_dispatch_latency_ms{bucket="16"}[20s])',
    "rate(serving_decode_tokens_total[2s])",
    "serving:requests:rate1m",
    "serving:decode_tokens:rate1m",
    "serving:tenant_device_ms:rate5m",
    "serving:dispatch_latency_ms:p95",
    "inflight",
    "missing_metric",
]
BAD = ["sum by (route) (rate(serving_requests_total[10s]))",
       "rate(serving_requests_total)", 'x{a="b"', "quantile(2, x[5s])",
       "rate(x[5q])"]


class _Notifier:
    def __init__(self):
        self.events = []

    def notify(self, event):
        self.events.append({k: event[k] for k in
                            ("type", "policy", "labels")})


def run(tm, ts, res):
    clock = res.ManualClock(0.0)
    m = tm.MetricsRegistry(clock=clock)
    req = m.counter("serving_requests_total", "req", labels=("route",))
    lat = m.histogram("serving_dispatch_latency_ms", "lat",
                      labels=("bucket",), buckets=(1.0, 5.0, 25.0, 100.0))
    tok = m.counter("serving_decode_tokens_total", "tokens")
    dev = m.counter("serving_tenant_device_ms_total", "device",
                    labels=("tenant",))
    gauge = m.gauge("inflight", "cur")
    watches = ts.default_serving_watches(has_decoder=True) + [
        ts.AnomalyWatch("inflight_level", "inflight", min_samples=10,
                        z_threshold=4.0, min_abs=5.0, alpha=0.2,
                        resolve_after_s=3.0)]
    store = ts.TimeSeriesStore(tiers=TIERS)
    notifier = _Notifier()
    det = ts.AnomalyDetector(store, watches, clock=clock,
                             notifier=notifier)
    rec = ts.Recorder([m], store=store, clock=clock,
                      rules=ts.default_serving_rules(has_decoder=True,
                                                     has_tenancy=True),
                      detector=det)
    transitions = []
    for t in range(1, N_TICKS + 1):
        clock.advance(1.0)
        if t == RESET_AT:
            m.reset()
        req.labels("/a").inc(3 + t % 4)
        req.labels("/b").inc(t % 3)
        if t % 5 == 0:
            req.labels("/c").inc()
        lat.labels("16").observe(0.5 + (t * 7) % 30)
        lat.labels("32").observe(2.0 + (t * 3) % 90)
        tok.inc(8 * (1 + t % 2))
        dev.labels("acme").inc(1.25 * t)
        dev.labels("anonymous").inc(0.5)
        gauge.set(100.0 if not 40 <= t < 48 else 250.0)
        out = rec.record_now()
        transitions.append([(e["type"], e["policy"], e["labels"])
                            for e in out["transitions"]])
    return store, notifier.events, transitions, rec


@pytest.fixture(scope="module")
def runs():
    return {side: run(*mods) for side, mods in SIDES.items()}


@pytest.mark.parametrize("expr", EXPRS)
def test_instant_queries_match(runs, expr):
    jstore, pstore = runs["jax"][0], runs["port"][0]
    for at in (None, 20.0, float(RESET_AT), 50.5):
        assert pstore.query(expr, at=at) == jstore.query(expr, at=at)


@pytest.mark.parametrize("expr", EXPRS)
def test_range_queries_match(runs, expr):
    jstore, pstore = runs["jax"][0], runs["port"][0]
    for start, end, step in ((None, None, 2.0), (-30.0, None, 0.5),
                             (5.0, 45.0, 3.0)):
        assert pstore.query_range(expr, start, end, step) == \
            jstore.query_range(expr, start, end, step)


def test_the_runs_have_content(runs):
    pstore = runs["port"][0]
    assert pstore.query("serving:requests:rate1m")["results"]
    rate = pstore.query("rate(serving_decode_tokens_total[2s])")
    assert rate["results"][0]["value"] == pytest.approx(12.0)
    inc = pstore.query("increase(serving_requests_total[60s])")
    assert all(r["value"] > 0 for r in inc["results"])


@pytest.mark.parametrize("expr", BAD)
def test_malformed_queries_raise_alike(runs, expr):
    for side, mod in (("jax", JTS), ("port", PTS)):
        with pytest.raises(mod.QueryError) as exc:
            runs[side][0].query(expr)
        msg = str(exc.value)
        if side == "jax":
            want = msg
    assert msg == want


def test_anomaly_firing_sequence_matches(runs):
    (_, jev, jtr, jrec), (_, pev, ptr, prec) = runs["jax"], runs["port"]
    assert pev == jev
    assert ptr == jtr
    assert [e["type"] for e in pev] == ["firing", "resolved"]
    assert pev[0]["policy"] == "inflight_level"
    js, ps = jrec.status(), prec.status()
    for key in ("n_scrapes", "n_points", "n_rule_errors", "n_rules",
                "store"):
        assert ps[key] == js[key]
    assert ps["anomalies"] == js["anomalies"]


def test_scrape_render_and_rows_match():
    regs = {}
    for side, (tm, ts, res) in SIDES.items():
        m = tm.MetricsRegistry(clock=res.ManualClock())
        m.counter("a_total", "a", labels=("x",)).labels("1").inc(2)
        m.histogram("h_ms", "h", buckets=(1.0, 2.0)).observe(1.5)
        m.gauge("g", "g").set(-3)
        scrape = ts.take_scrape(m, at=7.0)
        regs[side] = (scrape.render(), sorted(scrape.rows()),
                      tm.render_registries(m))
    assert regs["port"] == regs["jax"]
    assert regs["port"][0] == regs["port"][2]
    assert PTS.parse_duration("150ms") == JTS.parse_duration("150ms")
