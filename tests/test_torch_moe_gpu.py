"""MoE training and MoE and int8 decode on the card, held against the
port's own CPU path on the same inputs.

Every test here is marked ``gpu`` and skips without a CUDA card; the
file imports nothing of JAX. Run it on the card with::

    MMLSPARK_TPU_TEST_TPU=1 python -m pytest tests/test_torch_moe_gpu.py

Tolerances: the f32 train steps (TF32 off; the card's attention and CE
kernels run 3xTF32) 1e-4 relative on every loss and 1e-4 on every
parameter after the steps; greedy decode tokens equal (the small model's
top-2 logit gaps stand far above the card's rounding); the card's
``_q_matmul`` within 1e-5 of its f32-widened form relative to the
output's largest magnitude (exact products, f32 sums in another order).
"""

import numpy as np
import pytest
import torch

from mmlspark_tpu_torch.models import transformer as T
from mmlspark_tpu_torch.models.function import ieee_f32
from mmlspark_tpu_torch.parallel.topology import MeshSpec, build_mesh
from mmlspark_tpu_torch.serving.decode import TransformerDecoder

pytestmark = pytest.mark.gpu

KW = dict(vocab=256, d_model=64, n_heads=4, d_head=16, d_ff=128,
          layers_per_stage=2, n_experts=4, moe_top_k=2,
          moe_capacity_factor=1.25, moe_aux_weight=0.01,
          moe_zloss_weight=1e-3)
TOL = 1e-4


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _steps(cfg, shape, device, n):
    mesh = build_mesh(MeshSpec.from_dict(shape), device)
    params = T.shard_params(T.init_params_np(cfg, seed=0), cfg, mesh)
    vel = T.init_velocity(params)
    step = T.build_spmd_train_step(cfg, mesh, 0.05, 0.9)
    batch = T.make_batch(np.random.default_rng(0), cfg, 4, 64, device)
    with ieee_f32():
        losses = [float(step(params, vel, *batch)[2]) for _ in range(n)]
    return np.array(losses), T.params_to_numpy(params)


@pytest.mark.parametrize("shape,n,dispatch", [
    ({"data": 1}, 3, "sort"), ({"data": 1}, 1, "scatter"),
    ({"data": 2, "expert": 2}, 1, "sort")],
    ids=["data1_sort", "data1_scatter", "data2_expert2"])
def test_moe_steps_card_vs_cpu(dev, shape, n, dispatch):
    cfg = T.TransformerConfig(**KW, moe_dispatch=dispatch)
    (lc, pc), (lr, pr) = (_steps(cfg, shape, d, n) for d in (dev, "cpu"))
    assert np.abs(lc - lr).max() <= TOL * np.abs(lr).max()
    for a, b in zip(T._leaves(pc), T._leaves(pr)):
        assert np.abs(a - b).max() <= TOL


@pytest.mark.parametrize("router", ["dense", "expert_choice"])
def test_other_routes_card_vs_cpu(dev, router):
    kw = dict(KW, moe_capacity_factor=0.0) if router == "dense" else dict(
        KW, moe_router="expert_choice", moe_capacity_factor=1.0)
    cfg = T.TransformerConfig(**kw)
    (lc, _), (lr, _) = (_steps(cfg, {"data": 1}, d, 1) for d in (dev, "cpu"))
    assert np.abs(lc - lr).max() <= TOL * np.abs(lr).max()


def _greedy(tree, cfg, device, **kw):
    dec = TransformerDecoder(tree, cfg, n_slots=2, max_len=64, page_size=8,
                             device=device, **kw)
    rng = np.random.default_rng(3)
    out = []
    for slot in range(2):
        prompt = rng.integers(1, cfg.vocab, size=9 + 5 * slot).astype(
            np.int32)
        tok = dec.prefill(slot, prompt)
        toks, pos = [tok], len(prompt)
        for _ in range(12):
            cur = np.zeros(2, np.int32)
            p = np.zeros(2, np.int32)
            cur[slot], p[slot] = toks[-1], pos
            toks.append(int(dec.step(cur, p)[slot]))
            pos += 1
        out.append(toks)
    return out


def test_moe_decode_card_vs_cpu(dev):
    cfg = T.TransformerConfig(**dict(KW, moe_capacity_factor=0.0))
    tree = T.init_params_np(cfg, seed=1)
    assert _greedy(tree, cfg, None) == _greedy(tree, cfg, "cpu")


def test_int8_decode_card_vs_cpu(dev):
    cfg = T.TransformerConfig(**dict(KW, n_experts=0))
    tree = T.init_params_np(cfg, seed=2)
    assert _greedy(tree, cfg, None, quantized_ffn=True) == \
        _greedy(tree, cfg, "cpu", quantized_ffn=True)


def test_q_matmul_card_route_vs_widened(dev):
    rng = np.random.default_rng(0)
    x = torch.tensor(rng.normal(size=(8, 512)), dtype=torch.float32,
                     device=dev)
    w_q = torch.tensor(rng.integers(-127, 128, size=(512, 2048)),
                       dtype=torch.int8, device=dev)
    w_s = torch.tensor(rng.uniform(1e-3, 1e-2, size=2048),
                       dtype=torch.float32, device=dev)
    got = T._q_matmul(x, w_q, w_s)
    ref = x.bfloat16().float() @ w_q.float() * w_s
    assert got.dtype == torch.float32
    assert float((got - ref).abs().max()) <= 1e-5 * float(ref.abs().max())
