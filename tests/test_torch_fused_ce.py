"""The port's fused softmax cross-entropy (K4 forward, K6 backward,
``mmlspark_tpu_torch.ops.fused_ce``) against the JAX package's.

On the CPU the wrappers run their plain versions. They are held, on the
same numpy inputs, against the JAX Pallas kernels in interpret mode
(small tiles, so T and V are unaligned to them and padded) and against
the einsum + log-sum-exp reference. Tolerance 1e-5 absolute on per-token
CE values of order 5 and on their grads: f32 sums in another order,
nothing else. In bf16 both sides round the same values at the same
points (the inputs, the stored logits, ``d_l`` before each product, the
grads), so the grads are held to the same 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmlspark_tpu.ops.fused_ce import fused_softmax_xent as jax_fused_ce
from mmlspark_tpu_torch.ops import fused_ce as FC

torch.set_num_threads(1)

TOL = dict(atol=1e-5, rtol=1e-5)
T_TILE, V_TILE = 8, 128       # JAX interpret-mode tiles


def _inputs(t, d, v, seed):
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(t, d)).astype(np.float32)
    w = (0.3 * rng.normal(size=(d, v))).astype(np.float32)
    labels = rng.integers(0, v, size=t).astype(np.int32)
    return h, w, labels


def _reference(h, w, labels):
    """einsum + log-sum-exp in float64, gold by the one-hot rule."""
    logits = h.astype(np.float64) @ w.astype(np.float64)
    m = logits.max(-1)
    lse = m + np.log(np.exp(logits - m[:, None]).sum(-1))
    hit = np.arange(w.shape[1])[None, :] == labels[:, None]
    return lse - np.where(hit, logits, 0.0).sum(-1)


def _port(h, w, labels):
    return FC.fused_softmax_xent(torch.from_numpy(h), torch.from_numpy(w),
                                 torch.from_numpy(labels)).numpy()


# aligned, T and V unaligned to the JAX tiles, a single token
@pytest.mark.parametrize("t,d,v", [(16, 32, 256), (13, 24, 300),
                                   (1, 16, 129), (24, 64, 200)])
def test_matches_jax_kernel_and_reference(t, d, v):
    h, w, labels = _inputs(t, d, v, seed=t * v)
    got = _port(h, w, labels)
    want = np.asarray(jax_fused_ce(jnp.asarray(h), jnp.asarray(w),
                                   jnp.asarray(labels), interpret=True,
                                   t_tile=T_TILE, v_tile=V_TILE))
    assert got.shape == (t,) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, _reference(h, w, labels), **TOL)


def test_label_matching_no_column_gives_gold_zero():
    """Labels outside ``[0, V)`` meet no column: ``ce = lse``. (A label
    in the JAX kernel's pad columns ``[V, V_pad)`` would meet its -1e30
    sentinel instead, so the JAX comparison takes labels past the
    pad.)"""
    t, d, v = 6, 16, 300
    h, w, labels = _inputs(t, d, v, seed=1)
    v_pad = -(-v // V_TILE) * V_TILE
    labels[1], labels[4] = -1, v_pad + 5
    got = _port(h, w, labels)
    want = np.asarray(jax_fused_ce(jnp.asarray(h), jnp.asarray(w),
                                   jnp.asarray(labels), interpret=True,
                                   t_tile=T_TILE, v_tile=V_TILE))
    np.testing.assert_allclose(got, want, **TOL)
    logits = h.astype(np.float64) @ w
    lse = np.log(np.exp(logits).sum(-1))
    np.testing.assert_allclose(got[[1, 4]], lse[[1, 4]], **TOL)
    labels[2] = v                 # the first column past the vocab
    np.testing.assert_allclose(_port(h, w, labels)[2], lse[2], **TOL)


def test_plain_version_sums_every_matching_column():
    """The one-hot form, not a gather: gold is the masked SUM (here one
    column), and the CPU wrapper is the plain version, uncounted."""
    h, w, labels = _inputs(4, 8, 40, seed=2)
    args = tuple(torch.from_numpy(a) for a in (h, w, labels))
    before = dict(FC.LAUNCHES)
    np.testing.assert_array_equal(FC.fused_softmax_xent(*args).numpy(),
                                  FC.fused_softmax_xent_plain(*args).numpy())
    assert FC.LAUNCHES == before


@pytest.mark.parametrize("case,exc,match", [
    ("h_f64", TypeError, "h must be torch.float32"),
    ("labels_i64", TypeError, "labels must be torch.int32"),
    ("w_rows", ValueError, "w has shape"),
    ("labels_len", ValueError, "labels has shape"),
    ("h_strided", ValueError, "contiguous"),
    ("h_list", TypeError, "torch.Tensor"),
    ("v_zero", ValueError, "V=0"),
])
def test_wrapper_refuses_what_the_kernel_does_not_take(case, exc, match):
    h = torch.zeros(5, 8)
    w = torch.zeros(8, 12)
    lbl = torch.zeros(5, dtype=torch.int32)
    if case == "h_f64":
        h = h.double()
    elif case == "labels_i64":
        lbl = lbl.long()
    elif case == "w_rows":
        w = torch.zeros(9, 12)
    elif case == "labels_len":
        lbl = lbl[:4]
    elif case == "h_strided":
        h = torch.zeros(8, 5).t()
    elif case == "h_list":
        h = [[0.0] * 8] * 5
    elif case == "v_zero":
        w = torch.zeros(8, 0)
    with pytest.raises(exc, match=match):
        FC.fused_softmax_xent(h, w, lbl)


def _grads_port(h, w, labels, g, compute_dtype):
    th = torch.tensor(h, requires_grad=True)
    tw = torch.tensor(w, requires_grad=True)
    ce = FC.fused_softmax_xent(th, tw, torch.tensor(labels),
                               compute_dtype=compute_dtype)
    (ce * torch.tensor(g)).sum().backward()
    return ce.detach().numpy(), th.grad.numpy(), tw.grad.numpy()


def _grads_jax(h, w, labels, g, compute_dtype):
    def loss(h_, w_):
        ce = jax_fused_ce(h_, w_, jnp.asarray(labels),
                          compute_dtype=compute_dtype, interpret=True,
                          t_tile=T_TILE, v_tile=V_TILE)
        return jnp.sum(ce * g), ce

    (_, ce), (dh, dw) = jax.value_and_grad(loss, argnums=(0, 1),
                                           has_aux=True)(jnp.asarray(h),
                                                         jnp.asarray(w))
    return np.asarray(ce), np.asarray(dh), np.asarray(dw)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t,d,v", [(16, 32, 256), (13, 24, 300)])
def test_grads_match_jax_kernel(t, d, v, dtype):
    """ce, dh and dW through the autograd Function (K4's training
    variant and K6's plain versions) against ``jax.grad`` of the JAX
    kernel with the same ``compute_dtype``."""
    h, w, labels = _inputs(t, d, v, seed=t + v)
    g = np.random.default_rng(4).normal(size=t).astype(np.float32)
    got = _grads_port(h, w, labels, g, getattr(torch, dtype))
    want = _grads_jax(h, w, labels, g, getattr(jnp, dtype))
    for a, b, name in zip(got, want, ("ce", "dh", "dw")):
        assert a.dtype == np.float32, name
        np.testing.assert_allclose(a, b, err_msg=name, **TOL)


def test_backward_of_labels_matching_no_column():
    """A label outside ``[0, V)`` adds no one-hot to ``d_l``, so dh and
    dW are the softmax's alone — what the JAX backward gives for every
    such label, its pad columns included (their ``w`` columns are
    zero)."""
    t, d, v = 6, 16, 300
    h, w, labels = _inputs(t, d, v, seed=11)
    v_pad = -(-v // V_TILE) * V_TILE
    labels[0], labels[2], labels[5] = -1, v, v_pad + 5
    g = np.ones(t, np.float32)
    _, dh, dw = _grads_port(h, w, labels, g, None)
    _, jdh, jdw = _grads_jax(h, w, labels, g, None)
    np.testing.assert_allclose(dh, jdh, **TOL)
    np.testing.assert_allclose(dw, jdw, **TOL)
    logits = h.astype(np.float64) @ w
    p = np.exp(logits - logits.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    np.testing.assert_allclose(dh[[0, 2, 5]], (p @ w.T)[[0, 2, 5]], **TOL)


def test_logits_are_stored_only_for_a_backward(monkeypatch):
    """With grad enabled and a tensor that needs it, the forward stores
    the logits (the training variant); under ``no_grad``, or with no
    tensor needing grad, it stores nothing — the verify's K4 path."""
    stores = []
    forward = FC._forward

    def spy(h, w, labels, store):
        stores.append(store)
        return forward(h, w, labels, store)

    monkeypatch.setattr(FC, "_forward", spy)
    h, w, labels = (torch.from_numpy(a) for a in _inputs(5, 8, 40, seed=3))
    hg = h.clone().requires_grad_()
    FC.fused_softmax_xent(hg, w, labels).sum().backward()
    with torch.no_grad():
        FC.fused_softmax_xent(hg, w, labels)
    FC.fused_softmax_xent(h, w, labels)
    assert stores == [True, False, False]


def test_training_forward_stores_compute_dtype_logits_and_lse():
    h, w, labels = (torch.from_numpy(a) for a in _inputs(7, 8, 50, seed=6))
    hb, wb = h.bfloat16(), w.bfloat16()
    ce, logits, lse = FC._forward(hb, wb, labels, store=True)
    exact = hb.float() @ wb.float()
    assert logits.dtype == torch.bfloat16 and lse.dtype == torch.float32
    assert torch.equal(logits, exact.bfloat16())
    torch.testing.assert_close(lse, torch.logsumexp(exact, -1))
    torch.testing.assert_close(ce, FC.fused_softmax_xent(h, w, labels,
                                                         torch.bfloat16))
