"""The model and pipe axes on the frame plane, and the pjit train step, on
the card, held against the port's own CPU path on the same inputs.

Every test here is marked ``gpu`` and skips without a CUDA card; the
file imports nothing of JAX. Run it on the card with::

    MMLSPARK_TPU_TEST_TPU=1 python -m pytest tests/test_torch_model_axes_gpu.py

Tolerances, ``max |got - ref| <= tol x max(1, max |ref|)``: f32 scores
(TF32 off) 1e-5 between the card's modes, 1e-4 against the CPU;
``NNLearner`` on the model axis 1e-4 (the card's and the CPU's sums part
by rounding only); the pjit step's fused CE within 1e-4 of its dense CE.
"""

import dataclasses

import numpy as np
import pytest
import torch

from mmlspark_tpu_torch.core.dataframe import DataFrame
from mmlspark_tpu_torch.models import NNFunction, NNLearner
from mmlspark_tpu_torch.models import transformer as T
from mmlspark_tpu_torch.models.function import flatten_params
from mmlspark_tpu_torch.models.nn import NNModel
from mmlspark_tpu_torch.ops import fused_ce as FC
from mmlspark_tpu_torch.parallel import cuda_attention as CA
from mmlspark_tpu_torch.parallel.topology import MeshSpec, build_mesh

pytestmark = pytest.mark.gpu

ARCH = {"builder": "cifar_resnet", "depth": 8, "width": 8,
        "num_classes": 5}


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _err(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / max(1.0, np.abs(ref).max()))


@pytest.mark.parametrize("mode", [{"tensor_parallel": 2},
                                  {"pipeline_parallel": 2},
                                  {"pipeline_parallel": 3,
                                   "tensor_parallel": 2}])
def test_parallel_scores_equal_the_single_device_and_cpu(dev, mode):
    fn = NNFunction.init(ARCH, (16, 16, 3), seed=2)
    x = np.random.default_rng(0).uniform(0, 1, (70, 16, 16, 3)).astype(
        np.float32)
    df = DataFrame({"x": x})
    single = NNModel(model=fn, input_col="x", batch_size=32).transform(df)
    got = NNModel(model=fn, input_col="x", batch_size=32,
                  **mode).transform(df)
    cpu = NNModel(model=fn, input_col="x", batch_size=32, device="cpu",
                  **mode).transform(df)
    assert _err(got["scores"], single["scores"]) <= 1e-5
    assert _err(got["scores"], cpu["scores"]) <= 1e-4


def test_pipeline_streams_overlap_safely_across_frames(dev):
    """Many frames back to back through the stage streams: every frame's
    scores equal its single-device scores (a boundary buffer reused too
    early would corrupt a later micro-batch)."""
    fn = NNFunction.init(ARCH, (16, 16, 3), seed=3)
    m = NNModel(model=fn, input_col="x", batch_size=64,
                pipeline_parallel=2, pipeline_microbatches=8)
    single = NNModel(model=fn, input_col="x", batch_size=64)
    rng = np.random.default_rng(1)
    for n in (64, 200, 7, 128):
        df = DataFrame({"x": rng.uniform(0, 1, (n, 16, 16, 3)).astype(
            np.float32)})
        assert _err(m.transform(df)["scores"],
                    single.transform(df)["scores"]) <= 1e-5
    rep = m.pipeline_report()
    assert rep["stage_probe_valid"] and rep["n_frames"] >= 4
    assert all(s["service_ms"] > 0 for s in rep["stages"])


def test_model_axis_fit_equals_the_cpu_and_data_only_fits(dev):
    fn = NNFunction.init({"builder": "mlp", "hidden": [64, 32],
                          "num_outputs": 3}, (10,), seed=1)
    rng = np.random.default_rng(2)
    df = DataFrame({"features": rng.normal(size=(96, 10)).astype(
        np.float32), "label": rng.integers(0, 3, 96)})
    fits = {}
    for name, device, shape in (("card", None, {"data": 2, "model": 2}),
                                ("cpu", "cpu", {"data": 2, "model": 2}),
                                ("data1", None, {"data": 1})):
        learner = NNLearner(model=fn, epochs=2, batch_size=32,
                            optimizer="adam", learning_rate=0.01,
                            log_every=0, device=device, mesh_shape=shape)
        model = learner.fit(df)
        fits[name] = (np.concatenate(learner.losses),
                      flatten_params(model.model.params))
    for other in ("cpu", "data1"):
        assert _err(fits["card"][0], fits[other][0]) <= 1e-4
        for k, v in fits[other][1].items():
            assert _err(fits["card"][1][k], v) <= 1e-4, k


def test_pjit_fused_ce_launches_k4_and_k6_once_a_step(dev):
    """On one rank and on ``{"data": 2, "model": 2}``: the fused CE over
    the global batch once a step, no K7, the losses within 1e-4 of the
    plain CE's."""
    cfg = T.TransformerConfig(vocab=1024, d_model=64, n_heads=4, d_head=16,
                              d_ff=128, layers_per_stage=2, ce_impl="cuda")
    tree = T.init_params_np(cfg, seed=0)
    batch = T.make_batch(np.random.default_rng(0), cfg, 4, 256, dev)
    for shape in ({"data": 1}, {"data": 2, "model": 2}):
        mesh = build_mesh(MeshSpec.from_dict(shape), dev)
        out = {}
        for ce in ("cuda", "dense"):
            c = dataclasses.replace(cfg, ce_impl=ce)
            params = T.shard_params(tree, c, mesh)
            vel = T.init_velocity(params)
            step = T.build_spmd_train_step(c, mesh, 0.01, 0.9, impl="pjit")
            CA.reset_launch_counts()
            FC.reset_launch_counts()
            losses = [float(step(params, vel, *batch)[2]) for _ in range(2)]
            out[ce] = (losses, {**CA.LAUNCHES, **FC.LAUNCHES})
        launches = out["cuda"][1]
        assert launches["fused_softmax_xent_train"] == 2, shape
        assert launches["fused_ce_dh"] == 2, shape
        assert launches["fused_ce_dw"] == 2, shape
        assert launches["attention_fwd"] == 0, shape
        assert not any(out["dense"][1].values()), shape
        np.testing.assert_allclose(out["cuda"][0], out["dense"][0],
                                   rtol=1e-4, err_msg=str(shape))
