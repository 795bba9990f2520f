"""The port's tracing (``mmlspark_tpu_torch.core.tracing``) against the
JAX package's on the same span sequences.

Each package's ``Tracer`` runs on its own ``ManualClock`` through one
script of scoped spans, explicit ``add`` children, instant events, an
error span and a remote-parented worker root. Span ids are random per
process and per package, and capture stamps are wall-clock, so both are
normalised (ids to their order of appearance) before the captured
traces, their ``span_tree`` and their ``to_perfetto`` export are held
equal. The span-context headers cross both ways: the port injects and
JAX extracts, and the reverse, and ``merge_traces`` stitches a client
part of one package with a worker part of the other. ``AdaptiveThreshold``
must install the same thresholds from the same histogram counts.
"""

import json

import pytest
import torch

from mmlspark_tpu.core import resilience as JR
from mmlspark_tpu.core import telemetry as JTM
from mmlspark_tpu.core import tracing as JTR
from mmlspark_tpu_torch.core import resilience as PR
from mmlspark_tpu_torch.core import telemetry as PTM
from mmlspark_tpu_torch.core import tracing as PTR

torch.set_num_threads(1)

SIDES = {"jax": (JTR, JR), "port": (PTR, PR)}
_WALL = ("captured_at", "origin_unix")


def script(tr_mod, res, trace_id="trace-1"):
    """One request's spans on a fresh tracer; returns the tracer and the
    captured trace."""
    clock = res.ManualClock(50.0)
    tr = tr_mod.Tracer(clock=clock, default_slow_ms=None)
    tr.set_threshold("generate", 0.0)
    with tr.span("request", trace_id=trace_id, route="generate") as root:
        clock.advance(0.002)
        with tr.span("admit", queue=3):
            clock.advance(0.001)
        t0 = clock.now()
        clock.advance(0.004)
        tr.add("prefill", t0, clock.now(), parent=root, slot=1,
               prompt_len=280)
        tr.event("first_token", clock.now(), parent=root, ttft_ms=7.0)
        for i in range(3):
            t0 = clock.now()
            clock.advance(0.003)
            tr.add("spec_round", t0, clock.now(), parent=root, proposed=4,
                   accepted=i, emitted=i + 1)
        try:
            with tr.span("encode"):
                clock.advance(0.0005)
                raise ValueError("boom")
        except ValueError:
            pass
        root.set_attr("n_tokens", 9)
    return tr, tr.get_trace(trace_id)


def normalise(obj, ids=None):
    """Span ids to their order of first appearance; wall stamps out."""
    ids = {} if ids is None else ids

    def sid(v):
        if v is None:
            return None
        return ids.setdefault(v, len(ids))

    if isinstance(obj, list):
        return [normalise(x, ids) for x in obj]
    if isinstance(obj, dict):
        out = {}
        for k, v in obj.items():
            if k in _WALL:
                continue
            if k in ("span_id", "parent_id"):
                out[k] = sid(v)
            else:
                out[k] = normalise(v, ids)
        return out
    return obj


@pytest.fixture(scope="module")
def traces():
    return {side: script(*mods)[1] for side, mods in SIDES.items()}


def test_captured_trace_is_equal(traces):
    j, p = traces["jax"], traces["port"]
    assert p is not None and j is not None
    assert normalise(p) == normalise(j)
    names = [sp["name"] for sp in p["spans"]]
    assert names == ["request", "admit", "prefill", "first_token",
                     "spec_round", "spec_round", "spec_round", "encode"]
    assert p["reason"] == "slow" and p["duration_ms"] == 16.5


def test_span_tree_is_equal(traces):
    jt = JTR.span_tree(traces["jax"])
    pt = PTR.span_tree(traces["port"])
    assert normalise(pt) == normalise(jt)
    assert pt["name"] == "request" and len(pt["children"]) == 7
    assert [c["status"] for c in pt["children"]][-1] == "error"


def test_to_perfetto_is_equal(traces):
    jp = JTR.to_perfetto(traces["jax"])
    pp = PTR.to_perfetto(traces["port"])
    assert normalise(pp) == normalise(jp)
    ev = [e for e in pp["traceEvents"] if e["ph"] == "X"]
    assert [e["name"] for e in ev][:2] == ["request", "admit"]
    json.dumps(pp)


def test_dump_perfetto_writes_the_export(traces, tmp_path):
    path = PTR.dump_perfetto(traces["port"], str(tmp_path / "t" / "p.json"))
    with open(path) as f:
        assert json.load(f) == json.loads(json.dumps(
            PTR.to_perfetto(traces["port"])))


@pytest.mark.parametrize("caller,callee", [("port", "jax"),
                                           ("jax", "port")])
def test_span_context_crosses_packages(caller, callee):
    """The caller's egress span rides the headers; the callee adopts it
    as the remote parent of its root, and the merged trace nests the
    callee's root under the caller's egress span."""
    c_tr, c_res = SIDES[caller]
    w_tr, w_res = SIDES[callee]
    clock = c_res.ManualClock(10.0)
    client = c_tr.Tracer(clock=clock, default_slow_ms=None)
    client.set_threshold("client", 0.0)
    with client.span("call", trace_id="x-9", route="client") as root:
        with client.span("egress") as eg:
            headers = c_tr.inject_span_context({"Accept": "*/*"}, eg)
            clock.advance(0.01)
    assert headers["X-Trace-Id"] == "x-9"
    assert headers["X-Parent-Span-Id"] == c_tr.format_span_id(eg.span_id)
    tid, parent = w_tr.extract_span_context(headers)
    assert (tid, parent) == ("x-9", eg.span_id)
    wclock = w_res.ManualClock(3.0)
    worker = w_tr.Tracer(clock=wclock, default_slow_ms=None)
    worker.set_threshold("request", 0.0)
    sp = worker.start("request", trace_id=tid, remote_parent=parent)
    wclock.advance(0.004)
    worker.finish(sp)
    merged = c_tr.merge_traces([("client", client.get_trace("x-9")),
                                ("worker", worker.get_trace("x-9"))])
    tree = c_tr.span_tree(merged)
    assert tree["span_id"] == root.span_id
    (egress,) = tree["children"]
    assert [c["name"] for c in egress["children"]] == ["request"]
    assert merged["workers"] == ["client", "worker"]
    # the other package's merge of the same parts is the same trace
    other = w_tr.merge_traces([("client", client.get_trace("x-9")),
                               ("worker", worker.get_trace("x-9"))])
    assert normalise(other) == normalise(merged)


def test_span_id_wire_format():
    for raw in ("1f", "  2a ", "zz", "", None, "0", "1" * 17):
        assert PTR.parse_span_id(raw) == JTR.parse_span_id(raw)
    assert PTR.format_span_id(255) == JTR.format_span_id(255) == "ff"
    for h in ({"X-Capture": "1"}, {"X-Capture": "yes"}, None):
        assert PTR.capture_hint(h) == JTR.capture_hint(h)
    assert PTR.PARENT_SPAN_HEADER == JTR.PARENT_SPAN_HEADER


def test_adaptive_threshold_matches():
    edges = JTM.DEFAULT_LATENCY_BUCKETS_MS
    feeds = [[0] * 17, [0, 0, 0, 0, 0, 10, 20, 10, 5, 2, 1, 0, 0, 0, 0, 0, 0],
             [0, 0, 0, 0, 0, 10, 20, 10, 5, 2, 1, 0, 0, 0, 0, 0, 30],
             [0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 90]]
    got = {}
    for side, (tr_mod, _) in SIDES.items():
        tr = tr_mod.Tracer(default_slow_ms=250.0)
        state = {"i": 0}
        ad = tr_mod.AdaptiveThreshold(
            tr, "predict", lambda: [(edges, feeds[state["i"]])],
            min_count=40, refresh_every=2)
        seq = []
        for i in range(len(feeds)):
            state["i"] = i
            seq.append((ad.tick(), ad.tick(), tr.threshold("predict")))
        got[side] = (seq, ad.n_refreshes)
    assert got["port"] == got["jax"]
    assert got["port"][1] == 3


def test_ambient_tracer_and_current_span():
    tr = PTR.Tracer()
    assert PTR.current_span() is None
    with tr.span("outer") as sp:
        assert PTR.current_span() is sp
        assert PTR.current_span_name() == "outer"
        assert PTR.ambient_tracer() is tr
        assert PTM.current_trace_id() == sp.trace_id
    assert PTR.ambient_tracer() is PTR.TRACER
