"""The port's serving examples (``mmlspark_tpu_torch.examples``
``serving_demo`` and ``serving_distributed``) end to end on the CPU,
worker processes included, against the JAX scripts' data and the same
GBDT composed from the JAX package."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import torch

from mmlspark_tpu.core.dataframe import DataFrame as JDF

from mmlspark_tpu_torch.examples import (
    _common, serving_demo, serving_distributed)

from test_torch_examples_gbdt import (
    ROOT, assert_columns_equal, jax_example_frames)
from test_torch_gbdt import assert_same_fit

torch.set_num_threads(1)


def test_demo_frame_is_the_jax_scripts(monkeypatch):
    ref, = jax_example_frames(monkeypatch, "serving_demo")
    X, y = serving_demo.make_data()
    assert_columns_equal({"features": X, "label": y}, ref)


def test_demo_serves_jaxs_fit():
    import mmlspark_tpu.gbdt as JG
    out = serving_demo.run(device="cpu", n_requests=16, num_iterations=8)
    assert out["served_vs_local"] == 0.0
    assert out["_served"].shape == (16,)
    X, y = serving_demo.make_data()
    jm = JG.GBDTRegressor(num_iterations=8, num_leaves=15).fit(
        JDF({"features": X, "label": y}))
    compared, tie = assert_same_fit(jm.booster, out["_model"].booster, X, X)
    assert compared == 8
    if tie is None:
        ref = np.asarray(jm.transform(JDF({"features": X[:16]}))
                         ["prediction"])
        np.testing.assert_allclose(out["_served"], ref, rtol=1e-4,
                                   atol=1e-5)


def test_distributed_fleet_end_to_end():
    """Three worker processes on the CPU (``MMLSPARK_TPU_SERVING_CPU=1``),
    one SIGKILLed, the replayed reply: the JAX script's asserts."""
    out = serving_distributed.run(device="cpu", n_requests=10,
                                  num_iterations=6)
    assert out["served_vs_local"] < 1e-6
    assert out["n_dead"] == 1 and out["replayed"]
    assert out["lines"][-1] == "OK"


def test_worker_env_asks_for_the_cpu_or_the_card(monkeypatch):
    env = _common.worker_env("cpu")
    assert env[_common.SERVING_CPU_ENV] == "1"
    assert env["PYTHONPATH"].split(":")[0] == str(ROOT)
    monkeypatch.setenv(_common.SERVING_CPU_ENV, "1")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert _common.SERVING_CPU_ENV not in _common.worker_env("cuda")


def test_demo_runs_as_a_module():
    """``python -m mmlspark_tpu_torch.examples.serving_demo --device cpu
    --json``: its result line, then one JSON line."""
    p = subprocess.run(
        [sys.executable, "-m", "mmlspark_tpu_torch.examples.serving_demo",
         "--device", "cpu", "--json"], capture_output=True, text=True,
        cwd=str(ROOT), timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    lines = p.stdout.strip().splitlines()
    assert lines[0].startswith("served 32 concurrent requests in ")
    rec = json.loads(lines[-1])
    assert rec["example"] == "serving_demo" and rec["device"] == "cpu"
    assert rec["served_vs_local"] == 0.0 and rec["n_requests"] == 32


def test_without_cuda_the_module_raises():
    env = {"CUDA_VISIBLE_DEVICES": ""}
    p = subprocess.run(
        [sys.executable, "-m", "mmlspark_tpu_torch.examples.serving_demo"],
        capture_output=True, text=True, cwd=str(ROOT), timeout=300,
        env={**os.environ, **env})
    assert p.returncode != 0
    assert "no CUDA device" in p.stderr
