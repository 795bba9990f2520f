"""The port's differentiable attention (K7 ``flash_attention_folded``, K5
through ``flash_attention``'s backward, and ``dense_attention``) against
the JAX package's (``flash_attention`` under both JAX ``bwd_impl``s).

On the CPU the autograd Functions run the kernels' plain versions (the
forward with its lse, the FlashAttention-2 backward as einsums). They are
held, on the same numpy inputs, against the JAX Pallas kernels in
interpret mode, by value and by ``jax.grad`` of ``sum(out * w)``.
Tolerances: f32 value 2e-5 and grads 5e-5 absolute, the JAX folded
test's own (``tests/test_transformer.py``); bf16 value exact (both round
``p`` before ``p @ v`` at the same max: S = 128 is one JAX tile) and
grads within 4e-3 absolute, one bf16 ulp at their magnitude (about 2):
the grads are rounded to bf16 from f32 sums taken in another order.
The kernels against these plain versions need the card:
``test_torch_kernels_gpu.py`` and ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmlspark_tpu.parallel import pallas_attention as JPA
from mmlspark_tpu.parallel.ring_attention import dense_attention as jdense
from mmlspark_tpu_torch.parallel import cuda_attention as CA

torch.set_num_threads(1)

F32_VALUE, F32_GRAD = 2e-5, 5e-5
BF16_GRAD = 4e-3


def _inputs(shape_q, shape_k, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=shape_q).astype(np.float32)
    k = rng.normal(size=shape_k).astype(np.float32)
    v = rng.normal(size=shape_k).astype(np.float32)
    w = rng.normal(size=shape_q).astype(np.float32)
    return q, k, v, w


def _port_value_and_grads(fn, q, k, v, w, dtype):
    tq, tk, tv = (torch.tensor(x).to(dtype).requires_grad_()
                  for x in (q, k, v))
    out = fn(tq, tk, tv)
    assert out.dtype == dtype and out.shape == tq.shape
    (out.float() * torch.tensor(w)).sum().backward()
    return (out.detach().float().numpy(),
            [t.grad.float().numpy() for t in (tq, tk, tv)])


def _jax_value_and_grads(fn, q, k, v, w, dtype):
    args = [jnp.asarray(x, dtype) for x in (q, k, v)]

    def loss(*a):
        return jnp.sum(fn(*a).astype(jnp.float32) * w)

    out = fn(*args)
    grads = jax.grad(loss, argnums=(0, 1, 2))(*args)
    return (np.asarray(out.astype(jnp.float32)),
            [np.asarray(g.astype(jnp.float32)) for g in grads])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_folded_matches_jax_interpret(causal, dtype):
    shape = (2, 128, 2, 16)
    q, k, v, w = _inputs(shape, shape, seed=7 + causal)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    got, got_g = _port_value_and_grads(
        lambda a, b, c: CA.flash_attention_folded(a, b, c, causal),
        q, k, v, w, tdt)
    want, want_g = _jax_value_and_grads(
        lambda a, b, c: JPA.flash_attention_folded(a, b, c, causal, None,
                                                   True), q, k, v, w, jdt)
    value_tol, grad_tol = ((F32_VALUE, F32_GRAD) if dtype == "float32"
                           else (0.0, BF16_GRAD))
    np.testing.assert_allclose(got, want, atol=value_tol, rtol=0)
    for a, b, name in zip(got_g, want_g, "qkv"):
        np.testing.assert_allclose(a, b, atol=grad_tol, rtol=0,
                                   err_msg=f"d{name}")


# S unaligned to the JAX 128 tiles (its padding is the port's masking),
# and cross-attention Sq != Sk under the arange causal mask
@pytest.mark.parametrize("bwd_impl", ["xla", "pallas"])
@pytest.mark.parametrize("sq,sk,causal", [(48, 48, True), (48, 48, False),
                                          (48, 80, True)])
def test_flash_matches_jax_interpret(bwd_impl, sq, sk, causal):
    q, k, v, w = _inputs((2, sq, 2, 16), (2, sk, 2, 16), seed=sq + sk)
    got, got_g = _port_value_and_grads(
        lambda a, b, c: CA.flash_attention(a, b, c, causal,
                                           bwd_impl=bwd_impl),
        q, k, v, w, torch.float32)
    want, want_g = _jax_value_and_grads(
        lambda a, b, c: JPA.flash_attention(a, b, c, causal, None, True,
                                            bwd_impl),
        q, k, v, w, jnp.float32)
    np.testing.assert_allclose(got, want, atol=F32_VALUE, rtol=0)
    for a, b, name in zip(got_g, want_g, "qkv"):
        np.testing.assert_allclose(a, b, atol=F32_GRAD, rtol=0,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("compute_dtype", [None, "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_dense_attention_matches_jax(causal, compute_dtype):
    """f32 inputs, products in ``compute_dtype`` with f32 accumulation:
    both sides round the same inputs, so only the sums' order differs."""
    shape = (2, 40, 2, 16)
    q, k, v, w = _inputs(shape, shape, seed=3)
    tdt = getattr(torch, compute_dtype) if compute_dtype else None
    jdt = getattr(jnp, compute_dtype) if compute_dtype else None
    got, got_g = _port_value_and_grads(
        lambda a, b, c: CA.dense_attention(a, b, c, causal,
                                           compute_dtype=tdt),
        q, k, v, w, torch.float32)
    want, want_g = _jax_value_and_grads(
        lambda a, b, c: jdense(a, b, c, causal=causal, compute_dtype=jdt),
        q, k, v, w, jnp.float32)
    np.testing.assert_allclose(got, want, atol=F32_VALUE, rtol=0)
    for a, b in zip(got_g, want_g):
        np.testing.assert_allclose(a, b, atol=F32_GRAD, rtol=0)


def test_lse_and_flash_output_are_f32():
    """``attention_fwd``'s lse is ``m + log(l)`` per (b, h, row), the
    JAX ``lse_bh``; ``flash_attention`` keeps an f32 output for delta
    while the folded engine keeps the input dtype."""
    q, k, v, _ = _inputs((1, 20, 2, 8), (1, 20, 2, 8), seed=5)
    tq, tk, tv = (torch.tensor(x).to(torch.bfloat16) for x in (q, k, v))
    out, lse = CA.attention_fwd(tq, tk, tv, True, out_dtype=torch.float32)
    assert out.dtype == torch.float32 and lse.shape == (1, 2, 20)
    s = np.einsum("bqhd,bkhd->bhqk", *(x.float().numpy() for x in (tq, tk)))
    s = s * 8 ** -0.5 + np.where(np.tri(20, dtype=bool), 0, -np.inf)
    np.testing.assert_allclose(
        lse.numpy(), np.log(np.exp(s).sum(-1)), atol=1e-5, rtol=0)
    assert CA.attention_fwd(tq, tk, tv)[0].dtype == torch.bfloat16


def test_cpu_tensors_run_the_plain_versions_uncounted():
    shape = (1, 16, 2, 8)
    q, k, v, _ = _inputs(shape, shape, seed=9)
    args = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    before = dict(CA.LAUNCHES)
    CA.flash_attention_folded(*args).sum().backward()
    CA.flash_attention(*args, bwd_impl="pallas").sum().backward()
    assert CA.LAUNCHES == before


@pytest.mark.parametrize("case,exc,match", [
    ("cross", ValueError, "self-attention"),
    ("f16", TypeError, "q must be torch.float32 or torch.bfloat16"),
    ("mixed", TypeError, "k must be torch.bfloat16"),
    ("bwd_impl", ValueError, "unknown bwd_impl"),
    ("out_dtype", TypeError, "out_dtype"),
])
def test_refusals(case, exc, match):
    q = torch.zeros(1, 8, 2, 8)
    k = torch.zeros(1, 8, 2, 8)
    with pytest.raises(exc, match=match):
        if case == "cross":
            CA.flash_attention_folded(q, torch.zeros(1, 16, 2, 8),
                                      torch.zeros(1, 16, 2, 8))
        elif case == "f16":
            CA.flash_attention_folded(q.half(), k.half(), k.half())
        elif case == "mixed":
            CA.flash_attention_folded(q.bfloat16(), k, k)
        elif case == "bwd_impl":
            CA.flash_attention(q, k, k, bwd_impl="triton")
        else:
            CA.attention_fwd(q.bfloat16(), k.bfloat16(), k.bfloat16(),
                             out_dtype=torch.float16)


# the JAX shape rule, kept: cross-length, untileable S, Dh % 8, and the
# (H*Dh, tile) budget at wide heads
@pytest.mark.parametrize("sq,sk,d,h", [
    (1024, 1024, 64, 8), (1024, 512, 64, 8), (1000, 1000, 64, 8),
    (256, 256, 12, 2), (128, 128, 16, None), (4096, 4096, 64, 8),
    (2048, 2048, 128, 64), (384, 384, 64, 8)])
def test_folded_shape_rule_is_the_jax_rule(sq, sk, d, h):
    assert CA._folded_shape_ok(sq, sk, d, h) == JPA._folded_shape_ok(
        sq, sk, d, h)
    assert CA.folded_available(sq, sk, d, h) == (
        JPA._folded_shape_ok(sq, sk, d, h) and d <= CA.MAX_HEAD_DIM)


def _scaled_err(got, ref):
    """``chip_smoke.py``'s scaled error: max over elements of |got - ref|
    / (|ref| + RMS(ref)), the RMS at least 1e-3."""
    got, ref = got.float(), ref.float()
    rms = max(float(ref.square().mean().sqrt()), 1e-3)
    return float(((got - ref).abs() / (ref.abs() + rms)).max())


# chip_smoke.py's ONE_TILE_TOL: where S fits one 32-key tile the kernels
# round p and ds at the plain versions' values, so it holds them to this
ONE_TILE_TOL = 1e-3


@pytest.mark.parametrize("unrounded", ["p_fwd", "p_dv", "ds"])
def test_one_tile_limit_sees_a_missing_rounding(unrounded):
    """The plain bf16 forward and backward with one rounding point left
    out (p before p @ v, p before p^T @ do, or ds) read above the limit
    ``chip_smoke.py`` holds the attention kernels to at S = 17, so a
    kernel that skipped one would fail there."""
    shape = (1, 17, 8, 64)
    q, k, v, w = (torch.tensor(x).bfloat16()
                  for x in _inputs(shape, shape, seed=17))
    scale = 64 ** -0.5
    out, lse = CA.attention_fwd_plain(q, k, v, True, scale)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    p = torch.where(CA._causal_mask(17, 17, "cpu"), torch.exp(
        s - lse[..., None]), 0.0)
    if unrounded == "p_fwd":
        got = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
        assert _scaled_err(got.bfloat16(), out.bfloat16()) > ONE_TILE_TOL
        return
    do = w
    delta = (do.float() * out.bfloat16().float()).sum(-1).transpose(1, 2)
    dq, dk, dv = CA.attention_bwd_plain(q, k, v, do, lse, delta, True, scale)
    if unrounded == "p_dv":
        got = torch.einsum("bhqk,bqhd->bkhd", p, do.float())
        assert _scaled_err(got, dv) > ONE_TILE_TOL
        return
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    ds = p * (dp - delta[..., None])
    for got, want in ((torch.einsum("bhqk,bkhd->bqhd", ds, k.float()), dq),
                      (torch.einsum("bhqk,bqhd->bkhd", ds, q.float()), dk)):
        assert _scaled_err(got * scale, want) > ONE_TILE_TOL
