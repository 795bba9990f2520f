"""The port's fault injection (``mmlspark_tpu_torch/testing/faults.py``)
against the JAX package's, on the CPU: the same scripts and the same
seeded rates give the same faults call for call, and each wrapper
(``FaultySession``, ``FaultyModel``, ``FaultyCheckpointManager``,
``step_fault``) raises, stalls or passes through as JAX's does, on
``ManualClock``s.
"""

import pytest

from mmlspark_tpu.core.resilience import ManualClock as JClock
from mmlspark_tpu.testing import faults as J
from mmlspark_tpu_torch.core.dataframe import DataFrame
from mmlspark_tpu_torch.core.resilience import ManualClock as PClock
from mmlspark_tpu_torch.io import checkpoint as PC
from mmlspark_tpu_torch.testing import faults as P


def _outcome(plan, site, clock):
    """What one ``raise_at`` did: the exception type's name, or the
    clock's advance."""
    t0 = clock.now()
    try:
        plan.raise_at(site, clock=clock)
    except Exception as e:  # noqa: BLE001 — the outcome under test
        return type(e).__name__
    return round(clock.now() - t0, 9)


@pytest.mark.parametrize("spec", ["ok", "drop", "reset", "fail", "kill",
                                  "503", "429", "delay:0.25"])
def test_fault_parse_is_jaxs(spec):
    j, p = J.Fault.parse(spec), P.Fault.parse(spec)
    assert (p.kind, p.status, p.delay, p.retry_after) == \
        (j.kind, j.status, j.delay, j.retry_after)


def test_unknown_spec_raises():
    for mod in (J, P):
        with pytest.raises(ValueError, match="unknown fault spec"):
            mod.Fault.parse("explode")


def test_scripted_sites_replay_as_jaxs():
    script = {"http": ["drop", "503", "ok", "reset", "delay:0.5"],
              "model": ["fail", "ok", "kill"]}
    jp, pp = J.FaultPlan(script=script), P.FaultPlan(script=script)
    jc, pc = JClock(), PClock()
    got = [(_outcome(pp, s, pc), _outcome(jp, s, jc))
           for s in ["http", "model"] * 6 + ["other"]]
    assert [g for g, _ in got] == [w for _, w in got]
    assert pp.summary() == jp.summary()


@pytest.mark.parametrize("seed", [0, 7, 123])
def test_seeded_rates_draw_as_jaxs(seed):
    rates = {"http": {"drop": 0.1, "status": 0.05, "delay": 0.2},
             "model": {"fail": 0.3}}
    jp = J.FaultPlan(rates=rates, seed=seed, status=429, delay=0.01)
    pp = P.FaultPlan(rates=rates, seed=seed, status=429, delay=0.01)
    sites = ["http", "model", "http", "http"] * 50
    assert [pp.at(s) == P.Fault(**vars(jp.at(s))) for s in sites] \
        == [True] * len(sites)
    assert pp.summary() == jp.summary()


def test_step_fault_hook():
    pp = P.FaultPlan(script={"train_step": ["ok", "fail"]})
    hook = pp.step_fault()
    hook(1)
    with pytest.raises(P.InjectedFault):
        hook(2)
    hook(3)
    assert pp.summary()["calls"] == {"train_step": 3}


def test_faulty_session_replies_as_jaxs():
    script = {"http": ["drop", "reset", "503", "delay:0.2", "ok"]}
    out = []
    for mod, clock in ((J, JClock()), (P, PClock())):
        s = mod.FaultySession(plan=mod.FaultPlan(script=script),
                              clock=clock)
        seen = []
        for _ in range(5):
            try:
                r = s.request("POST", "http://x/predict", data=b"{}")
                seen.append((r.status_code, r.reason, clock.now()))
            except Exception as e:  # noqa: BLE001
                seen.append(type(e).__name__)
        out.append((seen, s.n_sent))
    assert out[1] == out[0]
    assert out[1][0][:3] == ["ConnectionError", "ConnectionResetError",
                             (503, "injected 503", 0.0)]


def test_faulty_model_fails_and_stalls_on_schedule():
    class Echo:
        def transform(self, df):
            return df
    clock = PClock()
    m = P.FaultyModel(Echo(), P.FaultPlan(
        script={"model": ["fail", "delay:1.5", "ok"]}), clock=clock)
    df = DataFrame({"x": [1.0, 2.0]})
    with pytest.raises(P.InjectedFault):
        m.transform(df)
    assert m.transform(df) is df and clock.now() == pytest.approx(1.5)
    assert m.transform(df) is df
    assert m.n_transforms == 2


def test_faulty_checkpoint_manager_fails_saves_only(tmp_path):
    import numpy as np
    plan = P.FaultPlan(script={"checkpoint": ["fail", "ok"]})
    mngr = P.FaultyCheckpointManager(PC.manager(str(tmp_path)), plan)
    tree = {"x": np.arange(4, dtype=np.float32)}
    with pytest.raises(P.InjectedFault):
        mngr.save(1, tree)
    assert mngr.latest_step() is None        # proxied
    mngr.save(2, tree)
    assert mngr.all_steps() == [2]
    assert plan.summary()["injected"] == {"checkpoint": {"fail": 1}}
