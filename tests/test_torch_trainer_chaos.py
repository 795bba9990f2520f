"""``NNLearner``'s step checkpoints and bounded restarts in the port
(``mmlspark_tpu_torch/models/trainer.py``) against the JAX package's, on
the CPU.

* ``tests/test_resilience.py``'s ``TestTrainerChaos`` in the port: an
  injected step fault resumes to the uninterrupted fit's parameters
  (< 1e-6), restarts stop at ``max_restarts``, a fit without
  checkpoints fails fast, a failed checkpoint write rides the restart
  path; ``NotImplementedError`` is never retried; the restart counter
  and the save/restore histograms move, a telemetry snapshot lands
  under ``<checkpoint_dir>/telemetry``.
* A checkpoint JAX's fit wrote (the fit then failed) resumes in the port
  to JAX's uninterrupted fit within 1e-5, and the port's resumes in JAX
  to the port's within 1e-5: adam (its count), momentum at a constant
  rate (no count: the step is the count) and clipped adamw under a
  schedule.
* A hosted ``{"data": 2, "model": 2}`` fit restarts through its
  ``Shards``, and a data-only checkpoint resumes on that mesh; two gloo
  processes save one rank-0-written checkpoint and resume from it to
  the hosted run's parameters.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from mmlspark_tpu.core.dataframe import DataFrame as JDF
from mmlspark_tpu.models import trainer as JT
from mmlspark_tpu.models.function import NNFunction as JF
from mmlspark_tpu.parallel.topology import single_device_scope
from mmlspark_tpu.testing import faults as JFaults
from mmlspark_tpu_torch.core.dataframe import DataFrame as PDF
from mmlspark_tpu_torch.io import checkpoint as PC
from mmlspark_tpu_torch.models import trainer as PT
from mmlspark_tpu_torch.models.function import NNFunction as PF
from mmlspark_tpu_torch.testing import learner_fit
from mmlspark_tpu_torch.testing.faults import (
    FaultPlan, FaultyCheckpointManager, InjectedFault,
)

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
TOL = 1e-6
CROSS_TOL = 1e-5


def _blobs():
    rng = np.random.default_rng(42)
    n = 64
    x0 = rng.normal(loc=-2.0, size=(n, 4)).astype(np.float32)
    x1 = rng.normal(loc=+2.0, size=(n, 4)).astype(np.float32)
    x = np.concatenate([x0, x1])
    y = np.concatenate([np.zeros(n), np.ones(n)]).astype(np.int64)
    perm = rng.permutation(len(x))
    return {"features": x[perm], "label": y[perm]}


BLOBS = _blobs()


def _cfg(**kw):
    cfg = dict(arch={"builder": "mlp", "hidden": [8], "num_outputs": 2},
               optimizer="adam", learning_rate=0.01, epochs=3,
               batch_size=64, seed=11, log_every=0)
    cfg.update(kw)
    return cfg


def _fit(**kw):
    return PT.NNLearner(device="cpu", **_cfg(**kw)).fit(PDF(dict(BLOBS)))


def _max_diff(a, b) -> float:
    return max(float(np.abs(np.asarray(x) - np.asarray(y)).max())
               for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b),
                               strict=True))


@pytest.fixture(scope="module")
def clean_params():
    """The uninterrupted port run (3 epochs x 2 steps = 6 steps)."""
    return _fit().model.params


def _once_at(step):
    fired = {"n": 0}

    def fault(global_step):
        if global_step == step and fired["n"] == 0:
            fired["n"] += 1
            raise InjectedFault(f"simulated preemption at step {step}")
    fault.fired = fired
    return fault


def _hist_count(name) -> int:
    return int(PT._metrics()[name].stats()["count"])


def test_injected_step_fault_resumes_to_identical_params(clean_params,
                                                         tmp_path):
    restarts = PT._metrics()["restarts"].value
    saves, restores = _hist_count("ckpt_save_ms"), \
        _hist_count("ckpt_restore_ms")
    fault = _once_at(5)
    ck = str(tmp_path / "ck")
    chaotic = _fit(checkpoint_dir=ck, checkpoint_every=2, max_restarts=2,
                   fault_injector=fault)
    assert fault.fired["n"] == 1
    assert _max_diff(clean_params, chaotic.model.params) < TOL
    assert PT._metrics()["restarts"].value == restarts + 1
    # saves at steps 2, 4, then 6 (every 2nd) and the final one at 6
    assert _hist_count("ckpt_save_ms") - saves == 4
    assert _hist_count("ckpt_restore_ms") - restores == 1
    assert PC.manager(ck).all_steps() == [2, 4, 6]
    assert os.listdir(os.path.join(ck, "telemetry"))


def test_fault_plan_hook_and_restart_exhaustion(tmp_path):
    plan = FaultPlan(script={"train_step": ["ok", "ok", "fail", "ok",
                                            "ok", "fail", "fail",
                                            "fail", "fail"]})
    with pytest.raises(InjectedFault):
        _fit(checkpoint_dir=str(tmp_path / "ck2"), checkpoint_every=2,
             max_restarts=1, fault_injector=plan.step_fault())
    assert plan.summary()["injected"]["train_step"]["fail"] >= 2


def test_no_checkpointing_means_fail_fast():
    calls = []

    def fault(global_step):
        calls.append(global_step)
        raise InjectedFault("boom")

    with pytest.raises(InjectedFault):
        _fit(max_restarts=5, fault_injector=fault)
    assert calls == [1]


def test_checkpoint_write_fault_rides_the_restart_path(
        clean_params, tmp_path, monkeypatch):
    plan = FaultPlan(script={"checkpoint": ["ok", "fail"]})
    orig = PT.NNLearner._checkpoint_manager

    def faulty_mngr(self):
        mngr = orig(self)
        return FaultyCheckpointManager(mngr, plan) \
            if mngr is not None else None

    monkeypatch.setattr(PT.NNLearner, "_checkpoint_manager", faulty_mngr)
    chaotic = _fit(checkpoint_dir=str(tmp_path / "ck3"), checkpoint_every=2,
                   max_restarts=2)
    assert plan.summary()["injected"]["checkpoint"] == {"fail": 1}
    assert _max_diff(clean_params, chaotic.model.params) < TOL


def test_not_implemented_is_never_retried(tmp_path):
    calls = []

    def gap(global_step):
        calls.append(global_step)
        if global_step == 3:
            raise NotImplementedError("a capability gap")

    with pytest.raises(NotImplementedError):
        _fit(checkpoint_dir=str(tmp_path / "ck"), checkpoint_every=1,
             max_restarts=5, fault_injector=gap)
    assert calls == [1, 2, 3]


def test_a_checkpointed_fit_takes_the_host_loop(clean_params, tmp_path):
    with pytest.warns(UserWarning, match="checkpointing=True"):
        m = _fit(checkpoint_dir=str(tmp_path / "ck"), checkpoint_every=2,
                 device_resident=True, augment="flip_crop")
    assert _max_diff(clean_params, m.model.params) < TOL


# -- checkpoints across the packages ------------------------------------------

CROSS = {
    "adam": dict(optimizer="adam"),
    "momentum_const": dict(optimizer="momentum", cosine_decay=False,
                           learning_rate=0.05),
    "adamw_clip": dict(optimizer="adamw", clip_norm=0.5, warmup_steps=2),
}


def _jax_fit(**kw):
    with single_device_scope():
        return JT.NNLearner(**_cfg(**kw)).fit(JDF(dict(BLOBS)))


@pytest.mark.parametrize("case", sorted(CROSS))
def test_jax_checkpoint_resumes_in_the_port(case, tmp_path):
    kw = CROSS[case]
    ck = str(tmp_path / "ck")
    fn = PF.init(kw.get("arch", _cfg()["arch"]), (4,), seed=3)
    start = dict(model=JF(arch=dict(fn.arch), params=fn.params))
    ref = _jax_fit(**kw, **start).model.params
    # JAX's fit dies at step 5 with checkpoints at steps 2 and 4 on disk
    fault = JFaults.FaultPlan(script={"train_step": ["ok"] * 4 + ["fail"]})
    with pytest.raises(JFaults.InjectedFault):
        _jax_fit(**kw, **start, checkpoint_dir=ck, checkpoint_every=2,
                 max_restarts=0, fault_injector=fault.step_fault())
    assert PC.manager(ck).latest_step() == 4
    resumed = _fit(**kw, checkpoint_dir=ck, checkpoint_every=2)
    assert _max_diff(ref, resumed.model.params) < CROSS_TOL


@pytest.mark.parametrize("case", sorted(CROSS))
def test_port_checkpoint_resumes_in_jax(case, tmp_path):
    kw = CROSS[case]
    ck = str(tmp_path / "ck")
    ref = _fit(**kw).model.params
    with pytest.raises(InjectedFault):
        _fit(**kw, checkpoint_dir=ck, checkpoint_every=2, max_restarts=0,
             fault_injector=_once_at(5))
    assert PC.manager(ck).latest_step() == 4
    # JAX's own manager lists it and its fit resumes from it
    from mmlspark_tpu.io import checkpoint as JC
    assert JC.manager(ck).latest_step() == 4
    resumed = _jax_fit(**kw, checkpoint_dir=ck, checkpoint_every=2)
    assert _max_diff(ref, resumed.model.params) < CROSS_TOL


# -- meshes -------------------------------------------------------------------

def test_hosted_model_axis_restarts_through_its_shards(tmp_path):
    mesh = {"data": 2, "model": 2}
    clean = _fit(mesh_shape=mesh).model.params
    ck = str(tmp_path / "ck")
    chaotic = _fit(mesh_shape=mesh, checkpoint_dir=ck, checkpoint_every=2,
                   fault_injector=_once_at(5))
    assert _max_diff(clean, chaotic.model.params) < TOL
    # the split kernel was written one file per model slice
    index = PC.read_index(PC.manager(ck)._step_dir(6))
    kernel = [n for n in index["leaves"]
              if n.endswith("params.params.layers_0_1.kernel")]
    assert len(index["leaves"][kernel[0]]["shards"]) == 2


def test_data_only_checkpoint_resumes_on_a_model_axis(clean_params,
                                                      tmp_path):
    ck = str(tmp_path / "ck")
    with pytest.raises(InjectedFault):
        _fit(checkpoint_dir=ck, checkpoint_every=2, max_restarts=0,
             fault_injector=_once_at(5))
    resumed = _fit(mesh_shape={"data": 1, "model": 2}, checkpoint_dir=ck,
                   checkpoint_every=2)
    assert _max_diff(clean_params, resumed.model.params) < TOL


def _gloo_fit(tmp_path, tag, data, cfg):
    rdv = tmp_path / f"rdv_{tag}"
    procs = [subprocess.Popen(
        [sys.executable, "-m", "mmlspark_tpu_torch.testing.learner_fit",
         "--init", f"file://{rdv}", "--world", "2", "--rank", str(r),
         "--data", data, "--cfg", json.dumps(cfg), "--device", "cpu",
         "--out", str(tmp_path / f"{tag}{r}.npz")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=dict(os.environ, PYTHONPATH=str(ROOT)), cwd=str(ROOT))
        for r in range(2)]
    for p in procs:
        try:
            out = p.communicate(timeout=120)[0]
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        assert p.returncode == 0, out[-3000:]
    return [dict(np.load(tmp_path / f"{tag}{r}.npz")) for r in range(2)]


def test_per_process_data_axis_checkpoints_and_resumes(tmp_path):
    data = str(tmp_path / "fit.npz")
    learner_fit.save_inputs(data, BLOBS["features"], BLOBS["label"],
                            PF.init(_cfg()["arch"], (4,), seed=3))
    ck = str(tmp_path / "ck")
    base = {k: v for k, v in _cfg(cosine_decay=False).items()
            if k not in ("arch",)}
    # two processes fit 2 epochs, checkpointing (rank 0 writes) ...
    _gloo_fit(tmp_path, "a", data, dict(base, epochs=2, checkpoint_dir=ck,
                                        checkpoint_every=3))
    assert PC.manager(ck).all_steps() == [3, 4]
    assert PC.verify_digest(PC.manager(ck)._step_dir(4), strict=True)[0]
    # ... then resume to 3 epochs from step 4
    ranks = _gloo_fit(tmp_path, "b", data, dict(base, epochs=3,
                                                checkpoint_dir=ck))
    want = learner_fit.run(data, {"data": 2}, dict(base, epochs=3),
                           device="cpu")
    keys = [k for k in want if k.startswith("params/")]
    for got in ranks:
        for k in keys:
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=TOL)
