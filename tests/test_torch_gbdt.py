"""Whole GBDT fits of the port (``mmlspark_tpu_torch.gbdt``, on the CPU)
against the JAX package's, tree for tree, on the same numpy inputs.

Both sides compute the same f32 function, in another summation order
(XLA's CPU reductions and scans against PyTorch's). Where two candidate
splits tie in exact arithmetic — near-duplicate features such as the
breast-cancer radius/perimeter/area, cut points with an empty bin
between them, the count-only gains of the quantile objective's constant
gradients, a pure leaf whose every cut has gain 0 — the rounding of each
side picks one, and the two fits may part there. So :func:`assert_same_fit`
compares the trees split by split in creation order and holds:

- every split before the first that differs equal (feature, threshold
  bin and raw threshold, missing direction, categorical mask, children,
  node count), and every leaf value of an equal tree within rtol 1e-4;
- the first differing split a tie: its two gains within ``TIE_GAP`` of
  the tree's root gain (the f32 rounding of a sum of this scale);
- after a tie, the trees still compared while each flipped tree gives
  the same value to every training row (rtol 1e-4), since the next
  iteration then sees the same gradients; after a tie that moves rows,
  the rest of the fit is held to the JAX test's quality gate instead.
  Renewal objectives (l1, quantile) stop at a tie or at the first leaf
  value not bitwise equal: their gradients are signs of residuals, and
  renewal puts rows exactly at their leaf's value;
- a fit without any differing split: predictions on held-out rows
  within rtol 1e-4 / atol 1e-5, as in ``tests/test_gbdt.py:337-347``.

Each config's JAX and port fits are made once per module.
"""

import numpy as np
import pytest
import torch

import mmlspark_tpu.gbdt as JG
import mmlspark_tpu_torch.gbdt as TG
from mmlspark_tpu.gbdt.booster import eval_metric
from mmlspark_tpu.gbdt.objectives import get_objective
from mmlspark_tpu_torch.gbdt import tree as TT

torch.set_num_threads(1)

TIE_GAP = 1e-5
STRUCTURE = ("feature", "threshold_bin", "threshold", "missing_left",
             "categorical", "cat_mask", "left", "right")
PRED_TOL = dict(rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# comparison


def _bodies(tree):
    """Each body's split in creation order: body j splits the parent of
    nodes 2j+1 and 2j+2. (leaf, feature, threshold bin, missing left,
    bins sent left by a categorical split) and the split's gain."""
    parent = {int(tree.left[i]): i for i in range(tree.n_nodes)
              if tree.feature[i] >= 0}
    out = []
    for j in range((tree.n_nodes - 1) // 2):
        p = parent[2 * j + 1]
        key = (p, int(tree.feature[p]), int(tree.threshold_bin[p]),
               bool(tree.missing_left[p]),
               tuple(np.flatnonzero(tree.cat_mask[p])))
        out.append((key, float(tree.gain[p])))
    return out


def _first_difference(a, b):
    """(body, gap over the root gain) of the first differing split, or
    None when the trees split alike."""
    ba, bb = _bodies(a), _bodies(b)
    scale = max(abs(ba[0][1]) if ba else 0.0, abs(bb[0][1]) if bb else 0.0,
                1e-30)
    for j in range(max(len(ba), len(bb))):
        ka, ga = ba[j] if j < len(ba) else (None, 0.0)
        kb, gb = bb[j] if j < len(bb) else (None, 0.0)
        if ka != kb:
            return j, abs(ga - gb) / scale
    return None


def _tree_values(booster, tree, X):
    """The tree's value for each row of X, through the port's traversal."""
    X_dev, cat_bins = booster._inputs(np.asarray(X, np.float64))
    return TT.predict_tree_raw(booster._tree_to_arrays(tree), X_dev,
                               cat_bins, tree.max_depth()).numpy()


def assert_same_fit(jax_b, port_b, X_train, X_eval, vote_ties=(),
                    as_port=None):
    """Hold the port's fit to the JAX fit (module docstring). Returns
    (trees compared, first tie as (iteration, output, body, gap) or
    None); the whole fit was compared when the count is the JAX fit's
    tree count. ``vote_ties``: (iteration, output, node) of leaves whose
    histogram a voting learner summed over a vote decided within a
    near-tie (:func:`mmlspark_tpu_torch.gbdt.learners.vote_places`); a
    split that differs at such a leaf is a tie whatever its gap.
    ``as_port``: the JAX fit's trees in the port's form (by default
    loaded from its model string), for a caller that names one known
    difference by patching it there."""
    assert port_b.num_total_iterations == jax_b.num_total_iterations or \
        jax_b.params.early_stopping_round > 0
    if as_port is None:
        as_port = TG.Booster.from_string(jax_b.model_to_string(),
                                         device="cpu")
    # renewal objectives (l1, quantile) take signs of residuals for their
    # gradients, and renewal puts rows exactly at their leaf's value: a
    # leaf value an ulp away flips such a row's gradient, so the next
    # tree may differ without a tie unless every leaf value is equal
    renewal = jax_b.obj.renew_quantile is not None
    first_tie, compared = None, 0
    for it, (ja, ta) in enumerate(zip(as_port.trees, port_b.trees)):
        moved = False
        for k, (a, b) in enumerate(zip(ja, ta)):
            diff = _first_difference(a, b)
            compared += 1
            if diff is None:
                assert a.n_nodes == b.n_nodes
                for f in STRUCTURE:
                    np.testing.assert_array_equal(
                        getattr(b, f), getattr(a, f),
                        err_msg=f"iteration {it} output {k}: {f}")
                np.testing.assert_allclose(b.value, a.value, rtol=1e-4,
                                           atol=1e-6)
                moved |= renewal and not np.array_equal(b.value, a.value)
                continue
            leaves = {key[0] for body in (_bodies(a), _bodies(b))
                      if diff[0] < len(body) for key in [body[diff[0]][0]]}
            assert diff[1] <= TIE_GAP or any(
                (it, k, leaf) in vote_ties for leaf in leaves), (
                f"iteration {it} output {k} body {diff[0]}: the splits "
                f"differ by {diff[1]:.2e} of the root gain, not a tie")
            first_tie = first_tie or (it, k, *diff)
            moved |= renewal or not np.allclose(
                _tree_values(port_b, b, X_train),
                _tree_values(as_port, a, X_train), **PRED_TOL)
        if moved:
            return compared, first_tie
    assert port_b.best_iteration == jax_b.best_iteration
    if first_tie is None:
        np.testing.assert_allclose(port_b.predict(X_eval),
                                   jax_b.predict(X_eval), **PRED_TOL)
    return compared, first_tie


# ---------------------------------------------------------------------------
# data and fits


def _split(d):
    rng = np.random.default_rng(0)
    perm = rng.permutation(len(d.data))
    X, y = d.data[perm], d.target[perm]
    n = int(0.8 * len(X))
    return X[:n], y[:n], X[n:], y[n:]


def _breast_cancer():
    from sklearn.datasets import load_breast_cancer
    return _split(load_breast_cancer())


def _diabetes():
    from sklearn.datasets import load_diabetes
    return _split(load_diabetes())


def _iris():
    from sklearn.datasets import load_iris
    d = load_iris()
    return d.data, d.target, d.data, d.target


def _categorical():
    """``tests/test_gbdt.py``'s categorical fixture: the label is the
    membership of a 10-level categorical."""
    rng = np.random.default_rng(42)
    cat = rng.integers(0, 10, size=600).astype(np.float64)
    noise = rng.normal(size=600)
    y = np.isin(cat, [1.0, 4.0, 7.0]).astype(float)
    X = np.stack([cat, noise], axis=1)
    return X, y, X, y


def _missing():
    """``tests/test_gbdt.py``'s NaN fixture: every 7th value of the
    informative feature missing."""
    rng = np.random.default_rng(42)
    X = rng.normal(size=(400, 2))
    y = (X[:, 0] > 0).astype(float)
    X[::7, 0] = np.nan
    return X, y, X, y


def _early_stopping(objective):
    """``TestFusedEarlyStopping``'s data: 450 rows to fit, 150 to stop on."""
    rng = np.random.default_rng(11)
    X = rng.normal(size=(600, 8))
    t = X[:, 0] * 2 - X[:, 1] + 0.5 * rng.normal(size=600)
    y = (t > 0).astype(np.float64) if objective == "binary" else t
    return X[:450], y[:450], X[450:], y[450:]


CONFIGS = {
    "bc_binary": (_breast_cancer, dict(
        objective="binary", num_iterations=30, num_leaves=15,
        min_data_in_leaf=5), {}),
    "diabetes_l2": (_diabetes, dict(
        objective="regression", num_iterations=40, num_leaves=15,
        min_data_in_leaf=10, learning_rate=0.08), {}),
    "diabetes_quantile": (_diabetes, dict(
        objective="quantile", alpha=0.9, num_iterations=30, num_leaves=15,
        min_data_in_leaf=10), {}),
    "iris_multiclass": (_iris, dict(
        objective="multiclass", num_class=3, num_iterations=15, num_leaves=7,
        min_data_in_leaf=5), {}),
    "categorical": (_categorical, dict(
        objective="binary", num_iterations=10, num_leaves=7,
        min_data_in_leaf=5), {"categorical_features": [0]}),
    "missing": (_missing, dict(
        objective="binary", num_iterations=20, num_leaves=7,
        min_data_in_leaf=5), {}),
    **{f"early_stop_{o}": (lambda o=o: _early_stopping(o), dict(
        objective=o, num_iterations=120, num_leaves=7,
        early_stopping_round=4, seed=0), {"valid": True})
       for o in ("binary", "regression", "quantile")},
}

_FITS = {}


def fit_pair(name):
    """(JAX booster, port booster, data) of a config, fitted once."""
    if name not in _FITS:
        data_fn, kw, extra = CONFIGS[name]
        Xtr, ytr, Xte, yte = data_fn()
        train_kw = {k: v for k, v in extra.items() if k != "valid"}
        if extra.get("valid"):
            train_kw["valid_sets"] = [(Xte, yte)]
        jb = JG.Booster.train(JG.BoosterParams(**kw), Xtr, ytr, **train_kw)
        tb = TG.Booster.train(TG.BoosterParams(**kw), Xtr, ytr,
                              device="cpu", **train_kw)
        _FITS[name] = (jb, tb, (Xtr, ytr, Xte, yte))
    return _FITS[name]


def _auc(y, p):
    return eval_metric("auc", y, p, get_objective("binary"))[0]


def _quality(name, booster, data):
    """The JAX test's quality gate for the config's data
    (``tests/test_gbdt.py``)."""
    Xtr, ytr, Xte, yte = data
    pred = booster.predict(Xte)
    if name == "bc_binary":
        return _auc(yte, pred) == pytest.approx(0.98, abs=0.02)
    if name == "diabetes_l2":
        rmse = eval_metric("rmse", yte, pred, get_objective("regression"))[0]
        return rmse < 0.85 * float(np.std(yte))
    if name == "diabetes_quantile":
        return 0.75 <= float(np.mean(yte <= pred)) <= 1.0
    if name == "iris_multiclass":
        return float((pred.argmax(1) == yte).mean()) > 0.95
    if name == "categorical":
        return float(((pred > 0.5) == (yte > 0.5)).mean()) > 0.98
    if name == "missing":
        clean = ~np.isnan(Xte[:, 0])
        return float(((pred[clean] > 0.5) == (yte[clean] > 0.5)).mean()) > 0.9
    if name == "early_stop_binary":
        return _auc(yte, pred) > 0.85
    return booster.num_total_iterations < 120     # it actually stopped


# ---------------------------------------------------------------------------
# tests


@pytest.mark.parametrize("name", list(CONFIGS))
def test_fit_matches_jax_tree_for_tree(name):
    jb, tb, (Xtr, _, Xte, _) = fit_pair(name)
    assert_same_fit(jb, tb, Xtr, Xte)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_fit_passes_the_jax_quality_gate(name):
    jb, tb, data = fit_pair(name)
    assert _quality(name, jb, data), "the JAX fit misses its own gate"
    assert _quality(name, tb, data)


@pytest.mark.parametrize("name", ["diabetes_l2", "missing",
                                  "early_stop_binary",
                                  "early_stop_regression"])
def test_tie_free_fits_are_equal_throughout(name):
    """These fits meet no tie: every tree equal, and the early-stopping
    fits stop at the same iteration."""
    jb, tb, (Xtr, _, Xte, _) = fit_pair(name)
    assert assert_same_fit(jb, tb, Xtr, Xte) == (
        jb.num_total_iterations, None)
    assert tb.num_total_iterations == jb.num_total_iterations


def _wide_counts():
    """Counts whose log mean spans +-10 over the rows: (X, {objective:
    y}). Fitted, the raw scores span about 18 units, so a hessian
    (``e^pred`` and its Tweedie kin) spans 2^22 to 2^28 over the rows,
    and leaves at the low end hold only rows far below the largest: the
    histograms' fixed point keeps less of such rows' bits than of the
    largest's (``cuda_hist.fixed_scale``)."""
    rng = np.random.default_rng(22)
    n = 600
    X = rng.uniform(-1, 1, size=(n, 3))
    mu = np.exp(10 * X[:, 0] + 0.3 * X[:, 1])
    y_poisson = rng.poisson(mu).astype(np.float64)
    y_tweedie = mu * rng.gamma(2.0, 0.5, n)
    return X, {"poisson": y_poisson, "tweedie": y_tweedie}


#: the wide-range fits' objectives
WIDE = {"poisson": dict(objective="poisson"),
        "tweedie": dict(objective="tweedie", tweedie_variance_power=1.2)}


@pytest.mark.parametrize("objective", list(WIDE))
def test_wide_range_count_fits_match_jax(objective):
    """Poisson and Tweedie fits whose hessians span more than 2^20: some
    tree has a leaf that holds only rows whose hessian (at the fitted
    scores) lies below 2^-18 of the largest, and the fits meet no tie,
    every tree equal."""
    X, ys = _wide_counts()
    y = ys[objective]
    kw = dict(WIDE[objective], num_iterations=80, num_leaves=7,
              min_data_in_leaf=10, learning_rate=0.5)
    jb = JG.Booster.train(JG.BoosterParams(**kw), X, y)
    tb = TG.Booster.train(TG.BoosterParams(**kw), X, y, device="cpu")
    raw = tb.predict_raw(X)[:, 0]
    assert raw.max() - raw.min() > 17
    _, h = tb.obj.grad_hess(torch.tensor(raw, dtype=torch.float32),
                            torch.tensor(y, dtype=torch.float32),
                            torch.ones(len(y)))
    h = h.numpy()
    low = 1.0
    for (tree,) in tb.trees:
        leaf_of = _tree_values(tb, tree, X)
        low = min(low, *(h[leaf_of == v].max() / h.max()
                         for v in np.unique(leaf_of)))
    print(f"{objective}: raw {raw.min():.3f} .. {raw.max():.3f}, the "
          f"lowest leaf's largest hessian {low:.3e} of the fit's")
    assert low < 2.0 ** -18
    assert assert_same_fit(jb, tb, X, X) == (80, None)


def test_the_comparison_catches_a_wrong_split():
    """A port tree with one split moved to another feature is not a tie."""
    jb, tb, (Xtr, _, Xte, _) = fit_pair("diabetes_l2")
    bad = TG.Booster.from_string(tb.model_to_string(), device="cpu")
    t = bad.trees[0][0]
    t.feature = t.feature.copy()
    t.feature[0] = (t.feature[0] + 1) % Xtr.shape[1]
    t.gain = t.gain.copy()
    t.gain[0] *= 0.9
    with pytest.raises(AssertionError, match="not a tie"):
        assert_same_fit(jb, bad, Xtr, Xte)


def test_first_difference_reads_creation_order():
    _, tb, _ = fit_pair("diabetes_l2")
    t = tb.trees[0][0]
    assert _first_difference(t, t) is None
    bodies = _bodies(t)
    assert len(bodies) == (t.n_nodes - 1) // 2 == 14
    assert bodies[0][0][0] == 0                    # the root splits first
    assert {key[0] for key, _ in bodies} == {
        i for i in range(t.n_nodes) if t.feature[i] >= 0}
