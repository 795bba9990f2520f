"""``python -m mmlspark_tpu_torch.tools.launch_multiprocess --smoke
--device cpu``: two gloo processes, one mesh rank each, against the
single-process runs (the JAX drill's four phases: psum, fit, pipe,
checkpoint), and the two processes' checkpoint restored bit for bit by
the port and by the JAX package's ``restore_sharded``."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from mmlspark_tpu_torch.tools import launch_multiprocess as LM

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def drill(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("dcn"))
    return LM.run_drill(timeout=240.0, smoke=True, device="cpu",
                        workdir=work), work


def test_all_four_phases_pass(drill):
    out, _ = drill
    assert out["passed"], json.dumps(out, default=str)[-3000:]
    ph = out["phases"]
    assert ph["psum"]["value"] == ph["psum"]["expected"] == 24.0
    assert ph["psum"]["n_local_rows"] == 4
    assert ph["fit"]["max_score_diff"] <= 1e-6
    assert ph["pipe"]["max_loss_diff"] <= 1e-6
    assert ph["pipe"]["stage_leaves_local"]
    assert out["checkpoint_restore"] == {"digest_verified": True,
                                         "restored_exact": True, "ok": True}


def test_the_two_process_save_restores_in_jax(drill):
    from mmlspark_tpu.io import checkpoint as JC
    _, work = drill
    tree = LM._ckpt_tree()
    mngr = JC.manager(os.path.join(work, "ckpt"), create=False)
    ok, _ = JC.verify_digest(mngr._step_dir(1), strict=True)
    assert ok
    got = mngr.restore(1, tree, strict_digest=True)
    for k in tree:
        np.testing.assert_array_equal(np.asarray(got[k]), tree[k])


def test_one_card_refuses_a_world_of_two(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="NCCL puts no two ranks"):
        LM.run_drill(device=None)


def test_without_cuda_the_drill_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LM.run_drill()


def test_the_module_runs_the_drill():
    p = subprocess.run(
        [sys.executable, "-m", "mmlspark_tpu_torch.tools.launch_multiprocess",
         "--smoke", "--device", "cpu", "--json"], capture_output=True,
        text=True, cwd=ROOT, timeout=300)
    assert p.returncode == 0, (p.stdout + p.stderr)[-3000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["passed"] and out["world"] == 2 and out["device"] == "cpu"
