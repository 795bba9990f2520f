"""The port's decode scheduler registers and feeds the JAX scheduler's
metric families, spans and token timelines on the same run (the port's
counterpart of ``tests/test_serving_slo.py::TestDecodeTimelines``, run
side by side with the JAX scheduler).

The same payloads go through each package's ``DecodeScheduler``, each
with its own ``MetricsRegistry`` and ``Tracer`` on a ``ManualClock``.
The loop body is driven by hand, so admissions and steps interleave the
same way on both sides, and each decoder call advances the clock by a
fixed amount, so latencies, TTFT/TPOT and the device time charged to
tenants are equal too. Held equal: the families' names, types, help
texts, label names and buckets; every counter and gauge; every
histogram child; each request's span names, in order; with the
speculative pair of ``tests/test_torch_speculative.py``, the spec
counters and the ``spec_round`` spans. ``bind()`` to a stub server
takes the server's registry, tracer, clock, commit path and tenancy.
"""

import json
import threading

import numpy as np
import pytest
import torch

from mmlspark_tpu.core import resilience as JR
from mmlspark_tpu.core import telemetry as JTM
from mmlspark_tpu.core import tracing as JTR
from mmlspark_tpu.serving import decode as JD
from mmlspark_tpu_torch.core import resilience as PR
from mmlspark_tpu_torch.core import telemetry as PTM
from mmlspark_tpu_torch.core import tracing as PTR
from mmlspark_tpu_torch.serving import decode as D
from test_torch_decode import CFG, JCFG, JPARAMS, NPARAMS, _payloads
from test_torch_speculative import (
    CFG as SCFG, DCFG, JCFG as SJCFG, JDCFG, JDP, JP, NP_TREE, _np,
)

torch.set_num_threads(1)

SIDES = {"jax": (JTM, JTR, JR, JD), "port": (PTM, PTR, PR, D)}
#: seconds each decoder call takes on the manual clock
CALL_S = {"prefill_logits": 0.004, "prefill_prefix_logits": 0.002,
          "step_logits": 0.001, "propose": 0.0015,
          "draft_step_logits": 0.0005, "verify_logits": 0.002}
#: families whose values depend on the clock, not on the run's counts
TIMED = ("serving_prefill_latency_ms", "serving_decode_step_latency_ms",
         "serving_decode_spec_round_latency_ms",
         "serving_decode_queue_wait_ms", "serving_decode_ttft_ms",
         "serving_decode_tpot_ms")


class _Pending:

    def __init__(self, payload, rid, span):
        self.payload = payload
        self.rid = rid
        self.deadline = None
        self.event = threading.Event()
        self.callbacks = []
        self.reply = None
        self.status = None
        self.span = span


def _timed(dec, clock):
    """Each decoder call advances the scheduler's clock by CALL_S."""
    for name, secs in CALL_S.items():
        fn = getattr(dec, name)

        def call(*a, _fn=fn, _s=secs, **kw):
            clock.advance(_s)
            return _fn(*a, **kw)
        setattr(dec, name, call)
    return dec


def drive(side, make_decoder, payloads, cancel_after=None, **sched_kw):
    """Serve ``payloads`` through one package's scheduler, the loop body
    by hand; ``cancel_after=(n, i)`` cancels request ``i`` after ``n``
    loop passes."""
    tm, tr_mod, res, dmod = SIDES[side]
    clock = res.ManualClock(100.0)
    registry = tm.MetricsRegistry(clock=clock)
    tracer = tr_mod.Tracer(clock=clock, default_slow_ms=None)
    tracer.set_threshold("request", 0.0)
    sched = dmod.DecodeScheduler(_timed(make_decoder(), clock),
                                 clock=clock, registry=registry,
                                 tracer=tracer, **sched_kw)
    pend = [_Pending(p, f"r{i}", tracer.start("request", trace_id=f"r{i}"))
            for i, p in enumerate(payloads)]
    for p in pend:
        sched.submit(p)
        clock.advance(0.0003)
    n = 0
    while sched._waiting or sched._active:
        sched._reap_waiting()
        sched._admit_waiting()
        if sched._active:
            sched._run_step()
        n += 1
        if cancel_after is not None and n == cancel_after[0]:
            assert sched.cancel(pend[cancel_after[1]].rid)
    for p in pend:
        assert p.event.is_set()
        tracer.finish(p.span)
    spans = {p.rid: [s["name"] for s in tracer.get_trace(p.rid)["spans"]]
             for p in pend}
    traces = {p.rid: tracer.get_trace(p.rid) for p in pend}
    return dict(sched=sched, registry=registry, spans=spans,
                traces=traces, replies=[json.loads(p.reply) for p in pend])


def _families(registry):
    return {f.name: f for f in registry.families()}


def _values(fam):
    if fam.kind == "histogram":
        return {k: c.stats() for k, c in fam.children()}
    return {k: c.value for k, c in fam.children()}


def assert_same_metrics(jreg, preg):
    jf, pf = _families(jreg), _families(preg)
    assert sorted(pf) == sorted(jf)
    for name, j in jf.items():
        p = pf[name]
        assert (p.kind, p.help, p.label_names) == \
            (j.kind, j.help, j.label_names), name
        if j.kind == "histogram":
            assert p.buckets == j.buckets, name
        pv, jv = _values(p), _values(j)
        assert sorted(pv) == sorted(jv), name
        for key in jv:
            if j.kind == "histogram" and name in TIMED:
                # clock-fed: equal counts; sums to float rounding
                assert pv[key]["count"] == jv[key]["count"], (name, key)
                assert pv[key]["buckets"] == jv[key]["buckets"], (name, key)
                assert pv[key]["sum"] == pytest.approx(jv[key]["sum"],
                                                       rel=1e-9), name
            else:
                assert pv[key] == jv[key], (name, key)


def _plain_payloads():
    out = _payloads()
    out.append({"prompt": [5, 6, 7, 8], "max_new_tokens": 40})
    return out


@pytest.fixture(scope="module")
def plain_runs():
    payloads = _plain_payloads()
    return {
        "port": drive("port", lambda: D.TransformerDecoder(
            NPARAMS, CFG, n_slots=4, max_len=64, page_size=8,
            device="cpu"), payloads, cancel_after=(4, 5)),
        "jax": drive("jax", lambda: JD.TransformerDecoder(
            JPARAMS, JCFG, n_slots=4, max_len=64, page_size=8),
            payloads, cancel_after=(4, 5))}


@pytest.fixture(scope="module")
def spec_runs():
    payloads = [{"prompt": p, "max_new_tokens": n, **extra}
                for p, n, extra in (
                    ([3, 9, 27, 17, 51], 12, {}),
                    ([2, 4, 8, 16, 32, 63, 1], 9,
                     {"temperature": 0.9, "seed": 77, "speculative": True}),
                    ([7, 7, 1], 11, {}),
                    ([5, 4, 3, 2, 1, 60, 61, 62], 10, {}))]
    return {
        "port": drive("port", lambda: D.TransformerDecoder(
            NP_TREE, SCFG, n_slots=3, max_len=64, page_size=8,
            draft_params=_np(JDP), draft_cfg=DCFG, device="cpu"),
            payloads),
        "jax": drive("jax", lambda: JD.TransformerDecoder(
            JP, SJCFG, n_slots=3, max_len=64, page_size=8,
            draft_params=JDP, draft_cfg=JDCFG, attn_impl="dense"),
            payloads)}


def test_plain_run_registers_and_counts_as_jax(plain_runs):
    port, jax_ = plain_runs["port"], plain_runs["jax"]
    assert [r["tokens"] for r in port["replies"]] == \
        [r["tokens"] for r in jax_["replies"]]
    reasons = [r["finish_reason"] for r in port["replies"]]
    assert reasons == [r["finish_reason"] for r in jax_["replies"]]
    assert reasons.count("cancelled") == 1
    assert_same_metrics(jax_["registry"], port["registry"])
    st = port["sched"].stats()
    text = port["registry"].render()
    for name, want in (("serving_decode_requests_total", st["n_requests"]),
                       ("serving_decode_steps_total", st["n_steps"]),
                       ("serving_decode_tokens_total", st["n_tokens"]),
                       ("serving_decode_prefills_total", st["n_prefills"])):
        assert f"{name} {want}\n" in text
    hits = st["prefix_cache"]["hits"]
    assert hits > 0 and \
        f'serving_decode_prefix_lookups_total{{result="hit"}} {hits}' in text
    assert (f"serving_decode_kv_pool_bytes "
            f"{port['sched'].decoder.pool_bytes()}\n") in text


def test_timelines_and_charges(plain_runs):
    fams = _families(plain_runs["port"]["registry"])
    sched = plain_runs["port"]["sched"]
    ttft = _values(fams["serving_decode_ttft_ms"])
    produced = [r for r in plain_runs["port"]["replies"] if r["n_tokens"]]
    assert sum(s["count"] for s in ttft.values()) == len(produced) > 0
    tpr = _values(fams["serving_decode_tokens_per_request"])
    assert sum(s["sum"] for s in tpr.values()) == sched.n_tokens
    assert set(tpr) == {("length",), ("cancelled",)}
    step = _values(fams["serving_decode_step_latency_ms"])[()]
    assert step["count"] == sched.n_steps
    assert step["sum"] == pytest.approx(sched.n_steps * 1.0)
    prefill = _values(fams["serving_prefill_latency_ms"])
    assert sum(s["count"] for s in prefill.values()) == sched.n_prefills
    charged = sum(_values(fams["serving_tenant_device_ms_total"]).values())
    spent = sum(s["sum"] for name in (
        "serving_prefill_latency_ms", "serving_decode_step_latency_ms")
        for s in _values(fams[name]).values())
    assert charged == pytest.approx(spent, rel=1e-9)


def test_span_names_in_jax_order(plain_runs):
    port, jax_ = plain_runs["port"], plain_runs["jax"]
    assert port["spans"] == jax_["spans"]
    for reply, names in zip(port["replies"], port["spans"].values()):
        own = [n for n in names if n != "request"]
        assert own == (["queue_wait", "prefill", "first_token", "decode"]
                       if reply["n_tokens"] else [])


def test_speculative_counters_and_spans(spec_runs):
    port, jax_ = spec_runs["port"], spec_runs["jax"]
    assert [r["tokens"] for r in port["replies"]] == \
        [r["tokens"] for r in jax_["replies"]]
    assert_same_metrics(jax_["registry"], port["registry"])
    assert port["spans"] == jax_["spans"]
    sched = port["sched"]
    assert sched.n_spec_rounds > 0
    fams = _families(port["registry"])
    rounds = _values(fams["serving_decode_spec_round_latency_ms"])[()]
    assert rounds["count"] == sched.n_spec_rounds
    proposed = accepted = 0
    for trace in port["traces"].values():
        for sp in trace["spans"]:
            if sp["name"] == "spec_round":
                proposed += sp["attrs"]["proposed"]
                accepted += sp["attrs"]["accepted"]
    assert (proposed, accepted) == (sched.n_spec_proposed,
                                    sched.n_spec_accepted)
    st = sched.stats()["speculative"]
    text = port["registry"].render()
    for key in ("rounds", "proposed", "accepted"):
        assert f"serving_decode_spec_{key}_total {st[key]}\n" in text


class _Tenancy:
    """The slice of the serving tenancy registry the scheduler reads."""

    class _T:
        def __init__(self, tid, pages):
            self.id = tid
            self.max_cache_pages = pages

    def __init__(self):
        self.tenants = {"acme": self._T("acme", 6), "zed": self._T("zed",
                                                                   None)}
        self.fair_share = True
        self.tokens = {}

    def weight_of(self, tid):
        return 1.0

    def label_of(self, tid):
        return tid

    def note_tokens(self, tid, n):
        self.tokens[tid] = self.tokens.get(tid, 0) + n

    def note_goodput_tokens(self, tid, n):
        pass


class _Server:

    def __init__(self, side):
        tm, tr_mod, res, _ = SIDES[side]
        self.clock = res.ManualClock(5.0)
        self.registry = tm.MetricsRegistry(clock=self.clock)
        self.tracer = tr_mod.Tracer(clock=self.clock)
        self.tenancy = _Tenancy()
        self.committed = []

    def _commit(self, p):
        self.committed.append(p.rid)
        p.event.set()


@pytest.mark.parametrize("side", ["port", "jax"])
def test_bind_to_a_stub_server(side):
    srv = _Server(side)
    dec = (D.TransformerDecoder(NPARAMS, CFG, n_slots=2, max_len=32,
                                page_size=8, device="cpu")
           if side == "port" else
           JD.TransformerDecoder(JPARAMS, JCFG, n_slots=2, max_len=32,
                                 page_size=8))
    sched = SIDES[side][3].DecodeScheduler(dec)
    sched.bind(srv)
    assert sched.clock is srv.clock and sched.tracer is srv.tracer
    assert sched.prefix._quotas == {"acme": 6}
    p = _Pending({"prompt": [1, 2, 3], "max_new_tokens": 3}, "b0", None)
    p.tenant = "acme"
    sched.submit(p)
    sched._admit_waiting()
    while sched._active:
        sched._run_step()
    assert srv.committed == ["b0"] and srv.tenancy.tokens == {"acme": 3}
    fams = _families(srv.registry)
    assert "serving_decode_steps_total" in fams
    ttft = _values(fams["serving_decode_ttft_ms"])
    assert list(ttft) == [("decode", "acme")]
