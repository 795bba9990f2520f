"""K2's, the fused CE's and the f32 training attention's arithmetic,
emulated in plain PyTorch on the CPU.

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

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmlspark_tpu.ops.fused_ce import fused_softmax_xent as jax_fused_ce
from mmlspark_tpu.parallel import pallas_attention as JPA
from mmlspark_tpu_torch.ops import fused_ce as FC
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


# ---------------------------------------------------------------------------
# The fused CE's arithmetic (K4's forward, K6's dh and dW). Its kernels
# (csrc/fused_ce_forward.cu, csrc/fused_ce_backward.cu) split each f32
# operand by truncation (tf32_mma.cuh split_trunc): mma reads a .tf32
# operand's top 19 bits, so x's own bits act as big = trunc(x), and small
# = x - big is cut to tf32 the same way. The forward reduces each
# 128-column vocab slice to (max, sum of exp, gold) and merges the slices
# in order; the backward rebuilds d_l from the stored logits. Emulated at
# small widths (D 64-128, V about 1000, odd V, labels outside [0, V)) and
# held within 1e-5 x max(1, |ref|) of the f32 plain versions and of the
# JAX kernel run in interpret mode, ten times inside the kernels' 1e-4;
# one tf32 product (single TF32) lands at least ten times further off.

CE_SHAPES = [(7, 64, 1000), (24, 128, 1001), (24, 96, 999)]
V_TILE = 128  # the JAX interpret-mode vocab tile, and the port's slice


def trunc_tf32(x: torch.Tensor) -> torch.Tensor:
    """What mma reads of an f32 .tf32 operand: its low 13 mantissa bits
    cleared."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def mm_3xtf32_trunc(a, b):
    a_big, b_big = trunc_tf32(a), trunc_tf32(b)
    a_small, b_small = trunc_tf32(a - a_big), trunc_tf32(b - b_big)
    return (a_small @ b_big + a_big @ b_small) + a_big @ b_big


def mm_tf32_trunc(a, b):
    return trunc_tf32(a) @ trunc_tf32(b)


def emulated_ce(h, w, labels, mm):
    """Per-slice (m, s, gold) of the logits ``mm(h, w)``, merged over the
    slices in order: ce = m + log(s) - gold."""
    logits = mm(h, w)
    v = w.shape[1]
    cols = torch.arange(v)
    m = torch.full((h.shape[0],), -1e30)
    s = torch.zeros(h.shape[0])
    gold = torch.zeros(h.shape[0])
    for c0 in range(0, v, V_TILE):
        x = logits[:, c0:c0 + V_TILE]
        mj = x.amax(-1)
        sj = torch.exp(x - mj[:, None]).sum(-1)
        hit = cols[None, c0:c0 + V_TILE] == labels[:, None].long()
        gj = torch.where(hit, x, torch.zeros(())).sum(-1)
        big = torch.maximum(m, mj)
        s = s * torch.exp(m - big) + sj * torch.exp(mj - big)
        m, gold = big, gold + gj
    return m + torch.log(s) - gold, logits, m + torch.log(s)


def emulated_grads(h, w, labels, g, mm):
    """dh and dW from the emulated forward's logits and lse."""
    _, logits, lse = emulated_ce(h, w, labels, mm)
    onehot = (torch.arange(w.shape[1])[None, :]
              == labels[:, None].long()).float()
    d_l = (torch.exp(logits - lse[:, None]) - onehot) * g[:, None]
    return mm(d_l, w.T), mm(h.T, d_l)


@pytest.fixture(scope="module", params=CE_SHAPES,
                ids=lambda s: "T{}-D{}-V{}".format(*s))
def ce_case(request):
    """Inputs, the f32 plain versions' outputs and the JAX kernel's
    (interpret mode), labels -1 and past JAX's padded vocab at the ends."""
    t, d, v = request.param
    rng = np.random.default_rng(t * d + v)
    h = rng.normal(size=(t, d)).astype(np.float32)
    w = (0.3 * rng.normal(size=(d, v))).astype(np.float32)
    labels = rng.integers(0, v, size=t).astype(np.int32)
    labels[0], labels[-1] = -1, -(-v // V_TILE) * V_TILE + 5
    g = rng.normal(size=t).astype(np.float32)
    th, tw, tl, tg = (torch.from_numpy(a) for a in (h, w, labels, g))
    ce, logits, lse = FC._forward_plain(th, tw, tl)
    plain = {"ce": ce,
             "dh": FC.fused_ce_dh_plain(th, tw, tl, tg, logits, lse),
             "dw": FC.fused_ce_dw_plain(th, tw, tl, tg, logits, lse)}

    def loss(h_, w_):
        out = jax_fused_ce(h_, w_, jnp.asarray(labels), interpret=True,
                           t_tile=8, v_tile=V_TILE)
        return jnp.sum(out * g), out

    (_, jce), (jdh, jdw) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(jnp.asarray(h), jnp.asarray(w))
    ref_jax = {"ce": torch.from_numpy(np.array(jce)),
               "dh": torch.from_numpy(np.array(jdh)),
               "dw": torch.from_numpy(np.array(jdw))}
    return (th, tw, tl, tg), plain, ref_jax


def _emulated(inputs, mm):
    h, w, labels, g = inputs
    dh, dw = emulated_grads(h, w, labels, g, mm)
    return {"ce": emulated_ce(h, w, labels, mm)[0], "dh": dh, "dw": dw}


@pytest.mark.parametrize("out", ["ce", "dh", "dw"])
def test_3xtf32_ce_keeps_f32_accuracy(ce_case, out):
    inputs, plain, ref_jax = ce_case
    got = _emulated(inputs, mm_3xtf32_trunc)[out]
    err = _scaled_error(got, plain[out])
    assert err <= 1e-5, err
    assert _scaled_error(got, ref_jax[out]) <= 1e-5
    single = _scaled_error(_emulated(inputs, mm_tf32_trunc)[out],
                           plain[out])
    assert single >= 10 * err, (single, err)


# ---------------------------------------------------------------------------
# The f32 training attention's arithmetic (K7's backward, K8's partials and
# backward; csrc/attention_tf32.cuh). Its kernels split the block's own
# tiles and dp's operands (dout, v) by rounding (split: tf32(x), then
# tf32(x - big)) and every other operand by truncation (split_trunc, as
# the fused CE). Emulated on the algebra the kernels run: the forward's
# s = q k^T and p v, dq's s, dp = dout v^T and ds k, dk/dv's transposed
# s^T = k q^T and dp^T = v dout^T, then p^T dout and ds^T q. Held within
# 1e-4 x max(1, |ref|) of the f32 plain versions and of the JAX kernels
# in interpret mode, and one tf32 product (single TF32) lands at least
# ten times further off.


def split_mm(a, b, round_a, round_b):
    """a @ b in 3xTF32, each side split by rounding or by truncation."""
    ra = tf32 if round_a else trunc_tf32
    rb = tf32 if round_b else trunc_tf32
    a_big, b_big = ra(a), rb(b)
    a_small, b_small = ra(a - a_big), rb(b - b_big)
    return (a_small @ b_big + a_big @ b_small) + a_big @ b_big


def single_mm(a, b, round_a, round_b):
    return tf32(a) @ tf32(b)


def _heads(*xs):
    return [x.permute(0, 2, 1, 3) for x in xs]


def emulated_partials(q, k, v, vis, scale, mm):
    """K8's forward: (o [B, Sq, H, Dh] unnormalized, m, l [B, H, Sq]);
    a row that sees no key gives m = -1e30, l = 0, o = 0."""
    qh, kh, vh = _heads(q, k, v)
    s = torch.where(vis, mm(qh, kh.transpose(-1, -2), True, False) * scale,
                    torch.tensor(-1e30))
    m = s.amax(-1)
    p = torch.where(vis, torch.exp(s - m[..., None]), torch.zeros(()))
    o = mm(p, vh, False, False)
    return o.permute(0, 2, 1, 3), m, p.sum(-1)


def emulated_backward(q, k, v, do, lse, delta, vis, scale, mm):
    """(dq, dk, dv) as the dq and dk/dv kernels compute them."""
    qh, kh, vh, doh = _heads(q, k, v, do)
    p = torch.where(vis, torch.exp(
        mm(qh, kh.transpose(-1, -2), True, False) * scale - lse[..., None]),
        torch.zeros(()))
    dp = mm(doh, vh.transpose(-1, -2), True, True)
    dq = mm(p * (dp - delta[..., None]), kh, False, False) * scale
    vis_t = vis.transpose(-1, -2)
    p_t = torch.where(vis_t, torch.exp(
        mm(kh, qh.transpose(-1, -2), True, False) * scale
        - lse[..., None, :]), torch.zeros(()))
    dp_t = mm(vh, doh.transpose(-1, -2), True, True)
    dk = mm(p_t * (dp_t - delta[..., None, :]), qh, False, False) * scale
    dv = mm(p_t, doh, False, False)
    return [x.permute(0, 2, 1, 3) for x in (dq, dk, dv)]


def _abs_error(got, ref):
    """max |got - ref| over max(1, max |ref|): the f32 kernels' limit."""
    ref = torch.as_tensor(np.array(ref))
    return float((got - ref).abs().max() / max(1.0, float(ref.abs().max())))


def _draws(seed, shape, n):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=shape).astype(np.float32))
            for _ in range(n)]


# (S, heads, Dh, causal) at B 1: the backward of K7 (flash_attention_folded)
K7_CASES = [(256, 2, 64, True), (128, 4, 16, False), (128, 3, 32, True)]


@pytest.mark.parametrize("s,h,d,causal", K7_CASES,
                         ids=lambda x: str(x))
def test_3xtf32_attention_backward_keeps_f32_accuracy(s, h, d, causal):
    q, k, v, do = _draws(s + h + d, (1, s, h, d), 4)
    scale = d ** -0.5
    out, lse = CA.attention_fwd_plain(q, k, v, causal, scale)
    delta = (do * out).sum(-1).transpose(1, 2)
    vis = torch.ones(s, s, dtype=torch.bool)
    vis = vis.tril() if causal else vis
    plain = CA.attention_bwd_plain(q, k, v, do, lse, delta, causal, scale)
    jq, jk, jv = (jnp.asarray(x.numpy()) for x in (q, k, v))
    jgrads = jax.grad(
        lambda a, b, c: jnp.sum(JPA.flash_attention_folded(
            a, b, c, causal, None, True) * jnp.asarray(do.numpy())),
        argnums=(0, 1, 2))(jq, jk, jv)
    got = emulated_backward(q, k, v, do, lse, delta, vis, scale, split_mm)
    single = emulated_backward(q, k, v, do, lse, delta, vis, scale,
                               single_mm)
    for name, g, ref, jref, one in zip(("dq", "dk", "dv"), got, plain,
                                       jgrads, single):
        err = _abs_error(g, ref)
        assert err <= 1e-4, (name, err)
        assert _abs_error(g, jref) <= 1e-4, name
        assert _abs_error(one, ref) >= 10 * err, (name, err)


def _ring_positions(s, vis):
    """K8's block pair at B 1: the diagonal block, or its keys' positions
    in a seeded permutation with a fifth of them padded (positions the
    folded JAX twin is never handed: its flash twin takes them)."""
    q_pos = np.arange(s, dtype=np.int32)
    k_pos = q_pos.copy()
    if vis == "shuffled":
        rng = np.random.default_rng(s)
        k_pos = rng.permutation(k_pos)
        k_pos[rng.choice(s, s // 5, replace=False)] = CA.PAD_POS
    return q_pos, k_pos


# (S, heads, Dh, visibility, causal) at B 1
K8_CASES = [(128, 2, 64, "diagonal", True), (128, 4, 16, "shuffled", True),
            (256, 3, 32, "shuffled", False), (128, 2, 32, "diagonal", False)]


@pytest.mark.parametrize("s,h,d,vis,causal", K8_CASES,
                         ids=lambda x: str(x))
def test_3xtf32_ring_block_keeps_f32_accuracy(s, h, d, vis, causal):
    q, k, v, do = _draws(s * h + d, (1, s, h, d), 4)
    scale = d ** -0.5
    q_pos, k_pos = _ring_positions(s, vis)
    tq, tk = torch.from_numpy(q_pos)[None], torch.from_numpy(k_pos)[None]
    visible = CA._visible(tq, tk, causal)
    # the partials (o, m, l) against the plain version and JAX's twin
    o, m, l = emulated_partials(q, k, v, visible, scale, split_mm)
    po, pm, pl_ = CA.ring_block_fwd_plain(q, k, v, tq, tk, causal, scale)
    jfn = JPA.folded_block_attn if vis == "diagonal" else JPA.flash_block_attn
    jm, jl, jo = jfn(*(jnp.asarray(x.numpy()) for x in (q, k, v)), scale,
                     jnp.asarray(q_pos), jnp.asarray(k_pos), causal,
                     interpret=True)
    dead = pl_ == 0
    assert bool((l[dead] == 0).all()) and bool((m[dead] == -1e30).all())
    live_m = torch.where(dead, 0.0, m)
    so, sm, sl = emulated_partials(q, k, v, visible, scale, single_mm)
    for name, g, ref, jref, one in (
            ("o", o, po, jo, so), ("l", l, pl_, jl, sl),
            ("m", live_m, torch.where(dead, 0.0, pm),
             np.where(np.asarray(dead), 0.0, np.asarray(jm)),
             torch.where(dead, 0.0, sm))):
        err = _abs_error(g, ref)
        assert err <= 1e-4, (name, err)
        assert _abs_error(g, jref) <= 1e-4, name
        assert _abs_error(one, ref) >= 10 * err, (name, err)
    # the backward against the plain version and JAX's _fring_bwd_call,
    # on the ring's lse (+1e30 where no key is visible) and delta
    l_safe = pl_.clamp(min=1e-30)
    lse = torch.where(pl_ > 0, pm + torch.log(l_safe), 1e30)
    delta = (do * (po / l_safe.transpose(1, 2)[..., None])).sum(-1)
    delta = delta.transpose(1, 2).contiguous()
    plain = CA.ring_block_bwd_plain(q, k, v, do, lse, delta, tq, tk, causal,
                                    scale)
    fold = JPA._to_folded
    jgrads = JPA._fring_bwd_call(
        *(fold(jnp.asarray(x.numpy())) for x in (q, k, v, do)),
        jnp.asarray(lse.numpy()), jnp.asarray(delta.numpy()),
        jnp.asarray(q_pos)[None], jnp.asarray(k_pos)[:, None], h, scale,
        causal, True)
    got = emulated_backward(q, k, v, do, lse, delta, visible, scale,
                            split_mm)
    single = emulated_backward(q, k, v, do, lse, delta, visible, scale,
                               single_mm)
    for name, g, ref, jref, one in zip(("dq", "dk", "dv"), got, plain,
                                       jgrads, single):
        err = _abs_error(g, ref)
        assert err <= 1e-4, (name, err)
        assert _abs_error(g, JPA._from_folded(jref, h)) <= 1e-4, name
        assert _abs_error(one, ref) >= 10 * err, (name, err)
