"""``mmlspark_tpu_torch.tools.chaos_serving`` and ``chaos_streaming`` on
the CPU, real worker processes (``MMLSPARK_TPU_SERVING_CPU=1``), at
small counts: the kill/restart, keep-alive, rollout and prefix-cache
drills, and the retrain-to-redeploy loop, each with the JAX drill's
pass conditions. The four drills that pass or fail on latency windows
(tenancy, SLO, regression, postmortem) run in ``slow`` tests only."""

from __future__ import annotations

import json

import pytest
import torch

from mmlspark_tpu_torch.tools import chaos_serving as CS
from mmlspark_tpu_torch.tools import chaos_streaming as CST

torch.set_num_threads(1)

OFF = ["--tenancy-requests", "0", "--slo-alerts-requests", "0",
       "--regression-requests", "0", "--postmortem-requests", "0"]


def _report(capsys) -> dict:
    out = capsys.readouterr().out
    return json.loads(out[out.index("{"):out.rindex("}") + 1])


def test_kill_keepalive_rollout_and_prefix_drills(capsys):
    rc = CS.main(["--device", "cpu", "--requests", "30", "--kill-at", "8",
                  "--restart-after", "8", "--burst-threads", "4",
                  "--burst-requests", "6", "--prefix-requests", "8", *OFF])
    rep = _report(capsys)
    assert rc == 0, json.dumps(rep)[-3000:]
    st = rep["stats"]
    assert st["n_ok"] == 30 and st["n_wrong"] == 0 and not st["failed_rids"]
    assert st["killed_at"] == 8 and st["restarted_at"] == 16
    assert st["fleet_traces_ok"]
    assert rep["workers"][0]["journal_recovered"] > 0
    assert rep["burst"]["ok"] and rep["burst"]["n_failovers"] > 0
    assert rep["rollout"]["ok"]
    assert rep["rollout"]["fleet_versions"] == ["v2"]
    pre = rep["prefix"]
    assert pre["ok"] and pre["wrong_tokens"] == 0 and pre["ledger_clean"]
    assert pre["hit_tokens"] > 0 and pre["device"] == "cpu"
    # on the CPU the decode worker's wrappers run their plain versions
    assert set(pre["launches"].values()) == {0}


def test_retrain_loop_with_a_worker_killed(tmp_path):
    rep = CST.retrain_loop_drill(str(tmp_path), 0, n_workers=3,
                                 device="cpu")
    assert rep["ok"], json.dumps(rep, default=str)[-3000:]
    assert rep["killed_during"] in ("staging", "shadow", "canary",
                                    "flipping")
    assert rep["exactly_once"] and rep["traffic"]["n_wrong"] == 0
    assert rep["traffic"]["n_dropped"] == 0 and rep["n_responding"] == 2


def test_the_drills_need_the_card_or_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CS.main(["--prefix-only"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CST.main([])


@pytest.mark.slow
def test_tenancy_drill(tmp_path):
    CS.DEVICE = "cpu"
    rep = CS.tenancy_drill(str(tmp_path), 0, n_requests=120)
    assert rep["ok"], json.dumps(rep)[-3000:]


@pytest.mark.slow
def test_slo_alerts_drill(tmp_path):
    CS.DEVICE = "cpu"
    rep = CS.slo_alerts_drill(str(tmp_path), 0, n_requests=8)
    assert rep["ok"], json.dumps(rep)[-3000:]


@pytest.mark.slow
def test_regression_drill(tmp_path):
    rep = CS.regression_drill(str(tmp_path), 0, n_requests=40)
    assert rep["ok"], json.dumps(rep, default=str)[-3000:]


@pytest.mark.slow
def test_postmortem_drill(tmp_path):
    rep = CS.postmortem_drill(str(tmp_path), 0, n_requests=40)
    assert rep["ok"], json.dumps(rep, default=str)[-3000:]
