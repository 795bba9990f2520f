"""Checkpoints, resumable training and the streaming fit on the card,
held against the port's own CPU path on the same inputs.

Every test here is marked ``gpu`` and skips without a CUDA card; the
file imports nothing of JAX. Run it on the card with::

    MMLSPARK_TPU_TEST_TPU=1 python -m pytest tests/test_torch_checkpoint_gpu.py

A checkpoint restores bit for bit between the card and the CPU (f32,
int32, bf16 leaves, whole and as ``Shards``); the transformer's resumed
steps equal the uninterrupted ones within 1e-6 (relative loss);
``NNLearner``'s restart reaches the clean fit's parameters bit for bit
under deterministic algorithms; ``fit_stream`` on the card within 1e-4
x max(1, |ref|) of the CPU's parameters (the card's and the CPU's sums
part by rounding only, TF32 off).
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from mmlspark_tpu_torch.core.dataframe import DataFrame
from mmlspark_tpu_torch.io import checkpoint as PC
from mmlspark_tpu_torch.models import NNFunction, NNLearner
from mmlspark_tpu_torch.models import transformer as T
from mmlspark_tpu_torch.models.function import flatten_params
from mmlspark_tpu_torch.parallel import dist as PD
from mmlspark_tpu_torch.parallel.topology import MeshSpec, build_mesh
from mmlspark_tpu_torch.streaming import MemoryStreamSource
from mmlspark_tpu_torch.testing.faults import FaultPlan

pytestmark = pytest.mark.gpu

ARCH = {"builder": "cifar_resnet", "depth": 8, "width": 8,
        "num_classes": 5}
CFG = T.TransformerConfig(vocab=512, d_model=64, n_heads=4, d_head=16,
                          d_ff=128, layers_per_stage=2)


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _bits(t):
    t = PD.gathered(t).detach().cpu().contiguous()
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def test_card_and_cpu_restore_each_others_checkpoints(dev, tmp_path):
    g = torch.Generator().manual_seed(0)
    tree = {"w": torch.randn(64, 32, generator=g),
            "i": torch.randint(-9, 9, (16, 8), generator=g,
                               dtype=torch.int32),
            "wb": torch.randn(8, 8, generator=g).to(torch.bfloat16)}
    mesh = build_mesh(MeshSpec.from_dict({"data": 2, "model": 2}), dev)
    on_card = PD.shard_state({k: v.to(dev) for k, v in tree.items()}, mesh)
    PC.save_sharded(str(tmp_path / "card"), on_card)
    PC.save_sharded(str(tmp_path / "cpu"), tree)
    for src in ("card", "cpu"):
        back = PC.restore_sharded(str(tmp_path / src), on_card, mesh=mesh,
                                  strict_digest=True)
        host = PC.restore_sharded(str(tmp_path / src), tree)
        for k in tree:
            leaf = back[k]
            parts = leaf.parts if isinstance(leaf, PD.Shards) else [leaf]
            assert all(p.device.type == "cuda" for p in parts)
            assert torch.equal(_bits(leaf), _bits(tree[k]))
            assert torch.equal(_bits(host[k]), _bits(tree[k]))
    with open(tmp_path / "card" / "index.json", "rb") as a, \
            open(tmp_path / "cpu" / "index.json", "rb") as b:
        assert a.read() != b.read()          # the card's leaves were split
    assert os.path.exists(tmp_path / "card" / PC.MANIFEST_FILE)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_resumed_train_steps_equal_the_uninterrupted(dev, tmp_path, dtype):
    cfg = dataclasses.replace(CFG, dtype=dtype)
    batch = T.make_batch(np.random.default_rng(0), cfg, 2, 128, dev)
    p = T.params_from_jax(T.init_params_np(cfg), dev)
    v = T.init_velocity(p)
    step = T.build_train_step(cfg, 0.01, 0.9, device=dev)
    for _ in range(2):
        step(p, v, *batch)
    T.save_train_state(str(tmp_path), p, v, step=2)
    ref = [float(step(p, v, *batch)[2]) for _ in range(2)]
    rp, rv, at = T.restore_train_state(str(tmp_path), cfg)
    assert at == 2 and rp["embed"].device.type == "cuda"
    got = [float(step(rp, rv, *batch)[2]) for _ in range(2)]
    assert max(abs(a - b) / abs(b) for a, b in zip(got, ref)) <= 1e-6
    assert got[0] == ref[0]


def _frame(n=96):
    rng = np.random.default_rng(1)
    return DataFrame({"features": rng.uniform(0, 1, (n, 16, 16, 3))
                      .astype(np.float32),
                      "label": rng.integers(0, 5, n)})


def test_learner_restart_is_bit_exact_under_deterministic_algorithms(
        dev, tmp_path):
    fn = NNFunction.init(ARCH, (16, 16, 3), seed=2)
    kw = dict(model=fn, epochs=2, batch_size=16, learning_rate=0.01,
              log_every=0)
    plan = FaultPlan(script={"train_step": ["ok"] * 6 + ["fail"]})
    env = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True)
    try:
        clean = NNLearner(**kw).fit(_frame())
        faulted = NNLearner(**kw, checkpoint_dir=str(tmp_path),
                            checkpoint_every=4,
                            fault_injector=plan.step_fault()).fit(_frame())
    finally:
        torch.use_deterministic_algorithms(False)
        if env is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = env
    assert plan.summary()["injected"] == {"train_step": {"fail": 1}}
    a, b = flatten_params(clean.model.params), \
        flatten_params(faulted.model.params)
    assert all(np.array_equal(a[k], b[k]) for k in a)


def test_fit_stream_on_the_card_matches_the_cpu(dev):
    fn = NNFunction.init(ARCH, (16, 16, 3), seed=3)
    df = _frame(48)
    rows = [{"features": df["features"][i], "label": int(df["label"][i])}
            for i in range(df.num_rows)]
    out = {}
    for device in (None, "cpu"):
        src = MemoryStreamSource()
        src.add_rows(rows)
        fit = NNLearner(model=fn, batch_size=16, learning_rate=0.01,
                        log_every=0, device=device).fit_stream(
            src, max_batch_rows=16, min_batch_rows=16)
        assert fit.query.process_available() == 3
        out[device or "cuda"] = flatten_params(fit.model().model.params)
    for k, ref in out["cpu"].items():
        err = np.abs(out["cuda"][k] - ref).max() / max(1.0,
                                                       np.abs(ref).max())
        assert err <= 1e-4, (k, err)
