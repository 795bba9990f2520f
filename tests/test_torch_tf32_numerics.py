"""K2's arithmetic, emulated in plain PyTorch on the CPU.

The cold-prefill attention kernel (``csrc/flash_prefill_attention.cu``)
computes QK^T and PV on the tensor cores in 3xTF32: each f32 operand is
split into big = tf32(x) and small = tf32(x - big) (``cvt.rna``: to
nearest, ties away from zero, on a 10-bit mantissa), and a product sums
a.small b.big + a.big b.small + a.big b.big in f32. The emulation below
repeats that on causal attention at the decode path's prompt shape
(B 1, S 512, 8 heads x 64) and holds it within 1e-5 x max(1, |ref|) of
the f32 plain version, ten times inside the kernels' 1e-4 tolerance,
while one tf32 product (plain TF32) misses 1e-4. The card runs the
kernel itself against the same plain version in
``tests/test_torch_kernels_gpu.py`` and ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

from mmlspark_tpu_torch.parallel import cuda_attention as CA

B, S, H, DH = 1, 512, 8, 64


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32``: half of the dropped ulp added to the
    magnitude, then the low 13 mantissa bits cleared (an f32's bits are
    sign and magnitude, so the integer add rounds away from zero)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def mm_3xtf32(a, b):
    a_big, b_big = tf32(a), tf32(b)
    a_small, b_small = tf32(a - a_big), tf32(b - b_big)
    return (a_small @ b_big + a_big @ b_small) + a_big @ b_big


def mm_tf32(a, b):
    return tf32(a) @ tf32(b)


def emulated_attention(q, k, v, mm):
    """Causal softmax attention over [B, S, H, Dh] with both products
    through ``mm`` and the softmax in f32, as the kernel runs it."""
    qh, kh, vh = (x.permute(0, 2, 1, 3) for x in (q, k, v))
    s = mm(qh, kh.transpose(-1, -2)) * DH ** -0.5
    causal = torch.ones(S, S, dtype=torch.bool).tril()
    s = torch.where(causal, s, torch.tensor(-1e30))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    o = mm(p, vh) / p.sum(-1, keepdim=True).clamp_min(1e-30)
    return o.permute(0, 2, 1, 3)


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.normal(size=(B, S, H, DH))
                                .astype(np.float32)) for _ in range(3))
    return q, k, v, CA.flash_prefill_attention_plain(q, k, v)


def _scaled_error(got, ref):
    return float(((got - ref).abs() / ref.abs().clamp_min(1.0)).max())


def test_tf32_rounds_to_nearest_away_from_zero():
    ulp = 2.0 ** -10
    x = torch.tensor([1.0, 1 + ulp / 2, 1 + ulp / 2 - 2 ** -23,
                      -(1 + ulp / 2), 1 + 3 * ulp / 2, 3.0e-3],
                     dtype=torch.float32)
    got = tf32(x)
    assert got.tolist()[:5] == [1.0, 1 + ulp, 1.0, -(1 + ulp), 1 + 2 * ulp]
    # 10 mantissa bits kept, the rest zero; within half a tf32 ulp
    assert not (got.view(torch.int32) & 0x1FFF).any()
    assert abs(got[5] - x[5]) <= x[5] * 2.0 ** -11


def test_3xtf32_attention_keeps_f32_accuracy(case):
    q, k, v, ref = case
    err = _scaled_error(emulated_attention(q, k, v, mm_3xtf32), ref)
    assert err <= 1e-5, err


def test_single_tf32_attention_misses_the_kernel_tolerance(case):
    q, k, v, ref = case
    err = _scaled_error(emulated_attention(q, k, v, mm_tf32), ref)
    assert err > 1e-4, err
