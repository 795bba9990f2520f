"""The port's fused softmax cross-entropy (K4,
``mmlspark_tpu_torch.ops.fused_ce``) against the JAX package's.

On the CPU the wrapper runs its plain version. It is held, on the same
numpy inputs, against the JAX Pallas kernel in interpret mode (small
tiles, so T and V are unaligned to them and padded) and against the
einsum + log-sum-exp reference. Tolerance 1e-5 absolute on per-token
CE values of order 5: f32 sums in another order, nothing else.
"""

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
