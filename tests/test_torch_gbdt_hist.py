"""The port's GBDT building blocks (``mmlspark_tpu_torch.gbdt``) against
the JAX package's, on the same numpy inputs: the histogram (K9's plain
version), split finding, leaf renewal, the objectives, the device
metrics and the tree traversal, plus the histogram wrapper's refusals.

On the CPU the K9 wrapper runs its plain version, the reference's flat
scatter-add written with ``index_add_``. It is held against JAX
``tree.build_histogram`` and ``build_histogram_pallas`` in interpret
mode: counts exactly, grad and hess at rtol 1e-5 / atol 1e-4 (the JAX
test's own tolerance: the port's exact sums, rounded once, against f32
sums). Split finding is held
on one histogram fed to both sides: the integer fields of the packed
vector equal, gain and value within rtol 1e-5.
"""

import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmlspark_tpu.gbdt import device_metrics as JM
from mmlspark_tpu.gbdt import objectives as JO
from mmlspark_tpu.gbdt import tree as JT
from mmlspark_tpu.gbdt.pallas_hist import build_histogram_pallas, \
    prepare_bins_t as jax_prepare_bins_t
from mmlspark_tpu_torch.gbdt import cuda_hist as CH
from mmlspark_tpu_torch.gbdt import device_metrics as TM
from mmlspark_tpu_torch.gbdt import objectives as TO
from mmlspark_tpu_torch.gbdt import tree as TT

torch.set_num_threads(1)

HIST_TOL = dict(rtol=1e-5, atol=1e-4)


def _hist_inputs(n, f, b, mask_kind, seed):
    rng = np.random.default_rng(seed)
    bins = rng.integers(0, b, size=(n, f)).astype(np.int32)
    grad = rng.normal(size=n).astype(np.float32)
    hess = rng.uniform(0.1, 1, size=n).astype(np.float32)
    if mask_kind == "dense":
        mask = rng.uniform(size=n) < 0.7
    elif mask_kind == "empty":
        mask = np.zeros(n, bool)
    else:
        mask = np.zeros(n, bool)
        mask[n // 3] = True
    return bins, grad, hess, mask


def _port_hist(bins, grad, hess, mask, f, b):
    """The wrapper's int64 sums in the fixed point of these gradients,
    back in f32 (the grower's histograms, as the reference's)."""
    g, h = torch.from_numpy(grad), torch.from_numpy(hess)
    scale = CH.fixed_scale(g, h, len(grad))
    return CH.fixed_to_float(CH.build_histogram_cuda(
        CH.prepare_bins_t(torch.from_numpy(bins)), g, h,
        torch.from_numpy(mask), f, b, scale), scale).numpy()


# the JAX test's unaligned shape, and a full 255-bin one
@pytest.mark.parametrize("n,f,b", [(777, 11, 37), (1500, 6, 255)])
@pytest.mark.parametrize("mask_kind", ["dense", "empty", "one_row"])
def test_histogram_matches_jax(n, f, b, mask_kind):
    bins, grad, hess, mask = _hist_inputs(n, f, b, mask_kind, seed=n + b)
    got = _port_hist(bins, grad, hess, mask, f, b)
    args = (jnp.asarray(grad), jnp.asarray(hess), jnp.asarray(mask))
    ref = np.asarray(JT.build_histogram(jnp.asarray(bins), *args, f, b))
    pal = np.asarray(build_histogram_pallas(
        jax_prepare_bins_t(jnp.asarray(bins)), *args, f, b, interpret=True))
    assert got.shape == (f, b, 3) and got.dtype == np.float32
    for want in (ref, pal):
        np.testing.assert_array_equal(got[..., 2], want[..., 2])
        np.testing.assert_allclose(got[..., :2], want[..., :2], **HIST_TOL)
    assert got[..., 2].sum() == f * mask.sum()


def test_reference_layout_wrapper_equals_plain():
    bins, grad, hess, mask = _hist_inputs(300, 4, 20, "dense", seed=1)
    t = [torch.from_numpy(a) for a in (bins, grad, hess, mask)]
    scale = CH.fixed_scale(t[1], t[2], 300)
    np.testing.assert_array_equal(
        TT.build_histogram(*t, 4, 20).numpy(),
        CH.fixed_to_float(CH.build_histogram_plain(
            CH.prepare_bins_t(t[0]), *t[1:], 4, 20, scale), scale))


#: the most features a K9 block takes at a bin count, as the kernel
#: reports them on an H100 (``cuda_hist.max_feats``; the gpu-marked
#: ``test_gbdt_histogram_max_feats`` holds the kernel to these)
MAX_FEATS = {2: 32, 37: 32, 255: 22, 256: 22, 2048: 4}


def test_chunk_rows_fill_the_card_and_align():
    # 2^20 x 28 x 255 on a card that holds 16 clusters of 8: two feature
    # groups of 14 warps (int64 cells: 22 features a block at most), 8
    # clusters of 8 blocks of 16384 rows each, and the clusters' partials
    # (written and read) under a tenth of the uint8 bins
    plan = CH.hist_plan(1 << 20, 28, MAX_FEATS[255], max_clusters=16)
    assert (plan.feats, plan.groups, plan.row_blocks, plan.cluster,
            plan.chunk_rows) == (14, 2, 64, 8, 16384)
    assert plan.n_clusters == 8
    assert plan.partial_bytes(28, 255) < 0.1 * 28 * (1 << 20)
    # up to 8192 rows: one block, which writes the output itself
    for n in (777, 8192):
        small = CH.hist_plan(n, 11, MAX_FEATS[37], max_clusters=16)
        assert (small.row_blocks, small.cluster, small.n_clusters) == (
            1, 1, 1)
        assert small.partial_bytes(11, 37) == 0
    for n, f, b in [(33, 1, 2), (4096, 100, 255), (32768, 14, 256),
                    (70000, 3, 2048), (300001, 28, 256),
                    (10 ** 7, 300, 255)]:
        p = CH.hist_plan(n, f, MAX_FEATS[b], max_clusters=16)
        assert p.chunk_rows % 16 == 0 and p.row_blocks % p.cluster == 0
        assert p.cluster in (1, 2, 4, 8)
        assert p.row_blocks * p.chunk_rows >= n
        assert p.feats * p.groups >= f and p.feats <= MAX_FEATS[b]
        # no more groups than the features need
        assert (p.groups - 1) * MAX_FEATS[b] < f
        # every cluster of every feature group resident at once
        assert p.groups * p.n_clusters <= max(16, p.groups)


@pytest.mark.parametrize("n_bins,dtype", [
    (None, torch.int32), (2, torch.uint8), (255, torch.uint8),
    (256, torch.uint8), (257, torch.int32), (2048, torch.int32)])
def test_prepare_bins_t_picks_uint8_up_to_256_bins(n_bins, dtype):
    top = 300 if n_bins is None else n_bins
    bins = np.random.default_rng(top).integers(0, top, size=(50, 3))
    got = CH.prepare_bins_t(torch.from_numpy(bins.astype(np.int32)), n_bins)
    assert got.dtype == dtype and got.shape == (3, 50)
    assert got.is_contiguous()
    np.testing.assert_array_equal(got.numpy().astype(np.int64), bins.T)


# the uint8 layout through the wrapper (CPU tensors: its plain version)
# against JAX's kernel in interpret mode on the same int32 bins, and
# against the port's own int32 result exactly
@pytest.mark.parametrize("n,f,b", [(777, 11, 37), (1500, 6, 256)])
@pytest.mark.parametrize("mask_kind", ["dense", "empty", "one_row"])
def test_uint8_bins_match_jax_and_int32(n, f, b, mask_kind):
    bins, grad, hess, mask = _hist_inputs(n, f, b, mask_kind, seed=n + 3)
    g, h, m = (torch.from_numpy(a) for a in (grad, hess, mask))
    u8 = CH.prepare_bins_t(torch.from_numpy(bins), b)
    i32 = CH.prepare_bins_t(torch.from_numpy(bins))
    assert u8.dtype == torch.uint8 and i32.dtype == torch.int32
    scale = CH.fixed_scale(g, h, n)
    exact = CH.build_histogram_cuda(u8, g, h, m, f, b, scale)
    assert torch.equal(exact, CH.build_histogram_cuda(i32, g, h, m, f, b,
                                                      scale))
    got = CH.fixed_to_float(exact, scale).numpy()
    pal = np.asarray(build_histogram_pallas(
        jax_prepare_bins_t(jnp.asarray(bins)), jnp.asarray(grad),
        jnp.asarray(hess), jnp.asarray(mask), f, b, interpret=True))
    np.testing.assert_array_equal(got[..., 2], pal[..., 2])
    np.testing.assert_allclose(got[..., :2], pal[..., :2], **HIST_TOL)


def test_fit_from_uint8_bins_equals_fit_from_int32(monkeypatch):
    """Booster.train bins in uint8 at max_bin 255; forcing int32 bins
    gives the same trees."""
    from mmlspark_tpu_torch.gbdt import Booster, BoosterParams
    from mmlspark_tpu_torch.gbdt import booster as BM
    rng = np.random.default_rng(11)
    X = rng.normal(size=(1200, 5))
    X[:, 4] = rng.integers(0, 6, 1200)
    y = (X[:, 0] - 0.5 * X[:, 1] + 0.3 * (X[:, 4] > 2)
         + rng.logistic(size=1200) > 0).astype(float)
    p = BoosterParams(objective="binary", num_iterations=5, num_leaves=15)
    made = []

    def recording(bins, n_bins=None):
        made.append(CH.prepare_bins_t(bins, n_bins))
        return made[-1]

    monkeypatch.setattr(BM, "prepare_bins_t", recording)
    laid_out = Booster.train(p, X, y, device="cpu",
                             categorical_features=[4])
    assert [t.dtype for t in made] == [torch.uint8]
    monkeypatch.setattr(BM, "prepare_bins_t",
                        lambda bins, n_bins=None: CH.prepare_bins_t(bins))
    as_int32 = Booster.train(p, X, y, device="cpu",
                             categorical_features=[4])
    assert laid_out.model_to_string() == as_int32.model_to_string()


@pytest.mark.parametrize("bad", ["bins_dtype", "bins_shape", "grad_dtype",
                                 "mask_dtype", "mask_len", "n_bins",
                                 "not_tensor", "uint8_bins_past_256",
                                 "scale_dtype", "scale_shape"])
def test_histogram_wrapper_refuses(bad):
    bins, grad, hess, mask = _hist_inputs(64, 3, 8, "dense", seed=2)
    bt = CH.prepare_bins_t(torch.from_numpy(bins))
    g, h, m = (torch.from_numpy(a) for a in (grad, hess, mask))
    f, b = 3, 8
    scale = CH.fixed_scale(g, h, 64)
    if bad == "bins_dtype":
        bt = bt.to(torch.int64)
    elif bad == "bins_shape":
        f = 4
    elif bad == "grad_dtype":
        g = g.double()
    elif bad == "mask_dtype":
        m = m.float()
    elif bad == "mask_len":
        m = m[:-1]
    elif bad == "n_bins":
        b = CH.MAX_BINS + 1
    elif bad == "uint8_bins_past_256":
        bt, b = bt.to(torch.uint8), CH.U8_BINS + 1
    elif bad == "scale_dtype":
        scale = scale.float()
    elif bad == "scale_shape":
        scale = scale[:2]
    else:
        g = grad
    with pytest.raises((TypeError, ValueError)):
        CH.build_histogram_cuda(bt, g, h, m, f, b, scale)


# ---------------------------------------------------------------------------
# split finding


def _leaf_hist(seed, f=6, b=24, n=2000):
    bins, grad, hess, mask = _hist_inputs(n, f, b, "dense", seed)
    bins[::13, 1] = 0                        # missing values
    bins[:, 4] = bins[:, 4] % 7              # a categorical with 7 levels
    grad[bins[:, 4] == 3] += 1.5             # ... that carries signal
    return _port_hist(bins, grad, hess, mask, f, b)


_GROWTH = [JT.GrowthParams(min_data_in_leaf=20),
           JT.GrowthParams(min_data_in_leaf=5, lambda_l1=0.5, lambda_l2=2.0,
                           min_sum_hessian_in_leaf=1.0)]


@pytest.mark.parametrize("gp", _GROWTH, ids=["plain", "regularized"])
@pytest.mark.parametrize("cats", [(), (4,), (1, 4)], ids=str)
def test_split_finding_matches_jax(gp, cats):
    hist = _leaf_hist(seed=len(cats))
    f = hist.shape[0]
    is_cat = np.isin(np.arange(f), cats)
    tp = TT.GrowthParams(**vars(gp))
    j_both, j_order = JT.split_gain_matrix(jnp.asarray(hist),
                                           jnp.asarray(is_cat), gp)
    t_both, t_order = TT.split_gain_matrix(torch.from_numpy(hist),
                                           torch.from_numpy(is_cat), tp)
    j_both, t_both = np.asarray(j_both), t_both.numpy()
    np.testing.assert_array_equal(np.asarray(j_order), t_order.numpy())
    np.testing.assert_array_equal(np.isfinite(j_both), np.isfinite(t_both))
    fin = np.isfinite(j_both)
    scale = np.abs(j_both[fin]).max()
    np.testing.assert_allclose(t_both[fin], j_both[fin], rtol=1e-5,
                               atol=1e-5 * scale)
    for feat_mask in (None, np.arange(f) % 2 == 0):
        jp, _ = JT.eval_leaf(jnp.asarray(hist), jnp.asarray(is_cat), gp,
                             None if feat_mask is None
                             else jnp.asarray(feat_mask))
        tpk, _ = TT.eval_leaf(torch.from_numpy(hist),
                              torch.from_numpy(is_cat), tp,
                              None if feat_mask is None
                              else torch.from_numpy(feat_mask))
        jp, tpk = np.asarray(jp), tpk.numpy()
        ints = [TT.EV_FEATURE, TT.EV_CUT_POS, TT.EV_MISSING_LEFT,
                TT.EV_THRESHOLD_BIN, TT.EV_COUNT]
        np.testing.assert_array_equal(tpk[ints], jp[ints])
        np.testing.assert_allclose(tpk[[TT.EV_GAIN, TT.EV_VALUE, TT.EV_G,
                                        TT.EV_H]],
                                   jp[[TT.EV_GAIN, TT.EV_VALUE, TT.EV_G,
                                       TT.EV_H]], rtol=1e-5)
    best = TT.find_best_split(torch.from_numpy(hist),
                              torch.from_numpy(is_cat), tp)
    assert best["feature"] == int(jp[TT.EV_FEATURE])
    if not cats:   # None: every feature numeric, the same result
        none_both, none_order = TT.split_gain_matrix(torch.from_numpy(hist),
                                                     None, tp)
        np.testing.assert_array_equal(none_both.numpy(), t_both)
        np.testing.assert_array_equal(none_order.numpy(), t_order.numpy())


# ---------------------------------------------------------------------------
# leaf renewal, objectives, metrics, traversal


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("q", [0.5, 0.9])
def test_renew_leaf_values_matches_jax(weighted, q):
    rng = np.random.default_rng(3)
    n, max_nodes = 500, 9
    node = rng.integers(0, max_nodes - 1, n)         # the last leaf empty
    res = rng.normal(size=n).astype(np.float32)
    w = (rng.uniform(0.1, 2.0, n) if weighted else np.ones(n)
         ).astype(np.float32)
    sample = rng.random(n) < 0.8
    jv, jc = JT.renew_leaf_values(jnp.asarray(node, jnp.int32),
                                  jnp.asarray(res), jnp.asarray(w),
                                  jnp.asarray(sample), max_nodes, q)
    tv, tc = TT.renew_leaf_values(torch.from_numpy(node),
                                  torch.from_numpy(res), torch.from_numpy(w),
                                  torch.from_numpy(sample), max_nodes, q)
    jc, tc = np.asarray(jc), tc.numpy()
    np.testing.assert_array_equal(tc, jc)
    live = jc > 0
    assert not live[-1]
    np.testing.assert_allclose(tv.numpy()[live], np.asarray(jv)[live],
                               rtol=1e-5, atol=1e-6)


_OBJECTIVES = [("binary", {}), ("regression", {}), ("regression_l1", {}),
               ("quantile", {"alpha": 0.8}), ("poisson", {}),
               ("tweedie", {"tweedie_p": 1.3}),
               ("multiclass", {"num_class": 3})]


@pytest.mark.parametrize("name,kw", _OBJECTIVES, ids=[o for o, _ in
                                                      _OBJECTIVES])
def test_objectives_match_jax(name, kw):
    rng = np.random.default_rng(4)
    n = 64
    k = kw.get("num_class", 1) if name == "multiclass" else 1
    pred = rng.normal(size=(n, k) if k > 1 else n).astype(np.float32)
    if name == "multiclass":
        y = rng.integers(0, k, n).astype(np.float32)
    elif name == "binary":
        y = (rng.random(n) < 0.4).astype(np.float32)
    elif name in ("poisson", "tweedie"):
        y = rng.poisson(2.0, n).astype(np.float32)
    else:
        y = rng.normal(size=n).astype(np.float32)
    w = rng.uniform(0.5, 1.5, n).astype(np.float32)
    jo, to = JO.get_objective(name, **kw), TO.get_objective(name, **kw)
    assert (to.name, to.num_model_outputs, to.renew_quantile,
            to.is_classification) == (jo.name, jo.num_model_outputs,
                                      jo.renew_quantile, jo.is_classification)
    jg, jh = jo.grad_hess(jnp.asarray(pred), jnp.asarray(y), jnp.asarray(w))
    tg, th = to.grad_hess(torch.from_numpy(pred), torch.from_numpy(y),
                          torch.from_numpy(w))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(
        to.transform(torch.from_numpy(pred)).numpy(),
        np.asarray(jo.transform(jnp.asarray(pred))), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(to.init_score(y, w)),
                               np.asarray(jo.init_score(y, w)))


def test_get_objective_is_cached_and_refuses_unknown():
    assert TO.get_objective("binary") is TO.get_objective("binary")
    with pytest.raises(ValueError):
        TO.get_objective("hinge")


_METRICS = [("auc", "binary"), ("binary_logloss", "binary"),
            ("binary_error", "binary"), ("multi_logloss", "multiclass"),
            ("multi_error", "multiclass"), ("rmse", "regression"),
            ("l2", "regression"), ("l1", "regression"),
            ("quantile", "quantile"), ("poisson", "poisson"),
            ("tweedie", "tweedie")]


@pytest.mark.parametrize("metric,objective", _METRICS,
                         ids=[m for m, _ in _METRICS])
def test_device_metrics_match_jax(metric, objective):
    rng = np.random.default_rng(5)
    m, k = 90, 3 if objective == "multiclass" else 1
    # rounded raw scores: ties in the AUC ranks
    vraw = np.round(rng.normal(size=(m, k)), 1).astype(np.float32)
    if objective in ("binary",):
        vy = (rng.random(m) < 0.5).astype(np.float32)
    elif objective == "multiclass":
        vy = rng.integers(0, k, m).astype(np.float32)
    elif objective in ("poisson", "tweedie"):
        vy = rng.poisson(1.5, m).astype(np.float32)
    else:
        vy = rng.normal(size=m).astype(np.float32)
    kw = dict(num_class=k) if objective == "multiclass" else {}
    jfn, jhi = JM.get_device_metric(metric, JO.get_objective(objective, **kw),
                                    0.8, 1.4)
    tfn, thi = TM.get_device_metric(metric, TO.get_objective(objective, **kw),
                                    0.8, 1.4)
    assert thi == jhi
    np.testing.assert_allclose(
        float(tfn(torch.from_numpy(vraw), torch.from_numpy(vy))),
        float(jfn(jnp.asarray(vraw), jnp.asarray(vy))), rtol=1e-5)
    assert TM.get_device_metric("ndcg", TO.get_objective(objective, **kw),
                                0.8, 1.4) is None


def test_predict_tree_raw_matches_jax():
    """A hand-built tree with a numeric split (NaN left), a categorical
    split and values near the f32 threshold, routed by both."""
    tree = TT.Tree(
        feature=np.array([0, 1, -1, -1, -1], np.int32),
        threshold=np.array([0.1, 0.0, 0, 0, 0], np.float64),
        threshold_bin=np.zeros(5, np.int32),
        missing_left=np.array([True, False, False, False, False]),
        categorical=np.array([False, True, False, False, False]),
        cat_mask=np.array([[0, 0, 0, 0], [0, 1, 0, 1], [0] * 4, [0] * 4,
                           [0] * 4], bool),
        left=np.array([1, 3, 0, 0, 0], np.int32),
        right=np.array([2, 4, 0, 0, 0], np.int32),
        value=np.array([0, 0, 1.5, -2.0, 4.0], np.float32),
        gain=np.zeros(5, np.float32), n_nodes=5)
    X = np.array([[0.05, 1], [0.1, 2], [np.float32(0.1) + 1e-9, 3],
                  [np.nan, 1], [0.5, 0], [-1, 3]], np.float64)
    cat_bins = np.array([[0, 1], [0, 2], [0, 3], [0, 1], [0, 0], [0, 3]])
    j_arrs = {"feature": jnp.asarray(tree.feature),
              "threshold": jnp.asarray(tree.threshold, jnp.float32),
              "missing_left": jnp.asarray(tree.missing_left),
              "categorical": jnp.asarray(tree.categorical),
              "cat_mask": jnp.asarray(tree.cat_mask),
              "left": jnp.asarray(tree.left),
              "right": jnp.asarray(tree.right),
              "value": jnp.asarray(tree.value)}
    want = np.asarray(JT.predict_tree_raw(j_arrs, jnp.asarray(X),
                                          jnp.asarray(cat_bins, jnp.int32), 8))
    t_arrs = {k: torch.from_numpy(np.array(v)) for k, v in j_arrs.items()}
    for k in ("feature", "left", "right"):
        t_arrs[k] = t_arrs[k].long()
    got = TT.predict_tree_raw(t_arrs, torch.from_numpy(X.astype(np.float32)),
                              torch.from_numpy(cat_bins), 2).numpy()
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# host cost: the launches of one leaf split


_VIEWS = {"aten::select", "aten::reshape", "aten::unsqueeze", "aten::slice",
          "aten::expand", "aten::view", "aten::as_strided", "aten::t",
          "aten::lift_fresh", "aten::detach", "aten::alias",
          "aten::transpose", "aten::_reshape_alias", "aten::empty",
          "aten::empty_like", "aten::squeeze", "aten::unbind"}


def _ops_per_split(monkeypatch, is_categorical):
    """Operator calls per grower body, views left out: the host's
    launches per leaf split on the card. The histogram is stubbed to one
    op, as K9 is one launch there (its plain version is several)."""
    from torch.profiler import ProfilerActivity, profile
    n, f, b = 500, 6, 16
    rng = np.random.default_rng(6)
    bins_t = CH.prepare_bins_t(torch.from_numpy(
        rng.integers(0, b, size=(n, f)).astype(np.int32)))
    g = torch.from_numpy(rng.normal(size=n).astype(np.float32))
    scale = CH.fixed_scale(g, torch.ones(n), n)
    monkeypatch.setattr(TT, "build_histogram_cuda",
                        lambda *a: torch.zeros(f, b, 3, dtype=torch.int64))
    counts = []
    for leaves in (4, 8):
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            TT.grow_tree_device(bins_t, g, torch.ones(n),
                                torch.ones(n, dtype=torch.bool),
                                is_categorical, None,
                                TT.GrowthParams(num_leaves=leaves), f, b,
                                scale)
        counts.append(sum(e.name not in _VIEWS for e in prof.events()
                          if e.cpu_parent is None))
    return (counts[1] - counts[0]) / 4


def test_launches_per_split(monkeypatch):
    """The grower body's operator count, which sets a fit's host time on
    the card (each is a launch). All-numeric data skip the categorical
    ordering; these bounds catch a body that grows."""
    numeric = _ops_per_split(monkeypatch, None)
    categorical = _ops_per_split(monkeypatch, torch.arange(6) == 2)
    print(f"launches per split: numeric {numeric}, with a categorical "
          f"feature {categorical}")
    assert numeric <= 130
    assert numeric < categorical <= 160


class _YieldingCounts(dict):
    """A counting dict whose reads give up the interpreter (as a dict
    with Python hooks does, e.g. one that records the launching thread):
    an unguarded ``LAUNCHES[name] += 1`` then loses increments."""

    def __getitem__(self, key):
        value = dict.__getitem__(self, key)
        time.sleep(0)
        return value


def test_launch_count_is_exact_across_threads(monkeypatch):
    """Two fits on trial threads (``TuneHyperparameters`` on one card)
    launch K9 at once: every launch counts once."""
    import threading
    monkeypatch.setattr(CH, "LAUNCHES", _YieldingCounts(gbdt_histogram=0))
    per_thread = 2000
    start = threading.Barrier(2)

    def launch_many():
        start.wait()
        for _ in range(per_thread):
            CH.count_launch()
    threads = [threading.Thread(target=launch_many) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert CH.LAUNCHES["gbdt_histogram"] == 2 * per_thread
    CH.reset_launch_counts()
    assert CH.LAUNCHES["gbdt_histogram"] == 0
