"""The port's GBDT booster beyond the fused fit: the per-iteration loop
(dart, rf, host-loop sampling), continuations and merges, the fused
sampling modes, model strings in both directions, LightGBM text, and
the refusals. On the CPU, against the JAX package where the two share a
random stream.

The per-iteration loop draws from ``np.random.default_rng(seed)`` on
both sides, so dart and rf are held tree for tree (``assert_same_fit``,
see ``tests/test_torch_gbdt.py``). The fused loop's bagging, GOSS and
feature fraction draw from a ``torch.Generator`` where JAX draws from
threefry: those fits are held to the JAX tests' quality gates
(``TestFusedSamplingModes``) and to determinism, not tree for tree.
"""

import numpy as np
import pytest
import torch

import mmlspark_tpu.gbdt as JG
import mmlspark_tpu_torch.gbdt as TG
from mmlspark_tpu_torch.gbdt import tree as TT
from test_gbdt import (LGBM_BINARY_MODEL, LGBM_CATEGORICAL_MODEL,
                       LGBM_MISSING_NAN_MODEL)
from test_torch_gbdt import _auc, _breast_cancer, _diabetes, \
    assert_same_fit

torch.set_num_threads(1)

STRING_TOL = dict(rtol=1e-6, atol=1e-7)


def _fit(kw, X, y, **train_kw):
    jb = JG.Booster.train(JG.BoosterParams(**kw), X, y, **train_kw)
    tb = TG.Booster.train(TG.BoosterParams(**kw), X, y, device="cpu",
                          **train_kw)
    return jb, tb


def _count_fused(monkeypatch):
    calls = []
    orig = TT.boost_loop_device

    def wrapped(*a, **k):
        calls.append(1)
        return orig(*a, **k)
    monkeypatch.setattr(TT, "boost_loop_device", wrapped)
    return calls


# ---------------------------------------------------------------------------
# the per-iteration loop: the numpy stream is shared


_HOST_LOOP = {
    "dart": (_breast_cancer, dict(
        objective="binary", boosting_type="dart", num_iterations=15,
        num_leaves=7, min_data_in_leaf=5, bagging_fraction=0.8,
        bagging_freq=1)),
    "rf": (_breast_cancer, dict(
        objective="binary", boosting_type="rf", num_iterations=10,
        num_leaves=7, min_data_in_leaf=5, bagging_fraction=0.8,
        bagging_freq=1)),
    "rf_l1": (_diabetes, dict(
        objective="regression_l1", boosting_type="rf", num_iterations=8,
        num_leaves=7, min_data_in_leaf=5, bagging_fraction=0.8,
        bagging_freq=1)),
    "feature_fraction_logged": (_breast_cancer, dict(
        objective="binary", num_iterations=10, num_leaves=7,
        min_data_in_leaf=5, feature_fraction=0.5, seed=3)),
}


@pytest.mark.parametrize("name", list(_HOST_LOOP))
def test_host_loop_matches_jax_tree_for_tree(name, monkeypatch):
    data_fn, kw = _HOST_LOOP[name]
    Xtr, ytr, Xte, yte = data_fn()
    calls = _count_fused(monkeypatch)
    train_kw = {"log_every": 1000} if name.endswith("logged") else {}
    jb, tb = _fit(kw, Xtr, ytr, **train_kw)
    assert calls == []                       # the per-iteration loop
    assert_same_fit(jb, tb, Xtr, Xte)
    if kw["objective"] == "binary":
        assert _auc(yte, tb.predict(Xte)) > 0.93


def test_host_loop_early_stopping_and_logging(capsys):
    rng = np.random.default_rng(7)
    X = rng.normal(size=(400, 5))
    y = (X[:, 0] + X[:, 1] + 1.2 * rng.normal(size=400) > 0).astype(float)
    kw = dict(objective="binary", num_iterations=60, num_leaves=7,
              early_stopping_round=6, seed=0)
    jb, tb = _fit(kw, X[:320], y[:320], valid_sets=[(X[320:], y[320:])],
                  log_every=5)
    out = capsys.readouterr().out
    assert "iter 5 valid auc" in out
    assert tb.num_total_iterations < 60
    assert_same_fit(jb, tb, X[:320], X[320:])


def test_init_model_continuation_matches_jax(monkeypatch):
    rng = np.random.default_rng(21)
    X = rng.normal(size=(600, 8))
    y = X[:, 0] * 2 - X[:, 1] + 0.2 * rng.normal(size=600)
    kw = dict(objective="regression", num_iterations=8, num_leaves=7, seed=0)
    jbase, tbase = _fit(kw, X, y)
    calls = _count_fused(monkeypatch)
    jb = JG.Booster.train(JG.BoosterParams(**kw), X, y, init_model=jbase)
    tb = TG.Booster.train(TG.BoosterParams(**kw), X, y, init_model=tbase,
                          device="cpu")
    assert calls == [1] and tb.num_total_iterations == 16
    assert_same_fit(jb, tb, X, X)


def test_merge_appends_trees():
    Xtr, ytr, Xte, _ = _breast_cancer()
    kw = dict(objective="binary", num_iterations=4, num_leaves=7,
              min_data_in_leaf=5)
    a = TG.Booster.train(TG.BoosterParams(**kw), Xtr[:200], ytr[:200],
                         device="cpu")
    b = TG.Booster.train(TG.BoosterParams(**kw), Xtr[200:], ytr[200:],
                         device="cpu")
    before = a.predict_raw(Xte) + b.predict_raw(Xte) - b.init_score
    a.merge(b)
    assert a.num_total_iterations == 8 and a.best_iteration == 7
    np.testing.assert_allclose(a.predict_raw(Xte), before, rtol=1e-5,
                               atol=1e-6)


def test_tie_broken_quantile_fits_spread():
    """``bench.py``'s quantile config (``bench_gbdt_quantile``) fitted by
    the JAX package and by the port, both on the CPU: its constant
    gradients make split gains count-only, so the fits part at a tie in
    the first tree, and two right fits then differ in pinball loss by
    more than 1e-3 relative. This spread is what the card-against-CPU
    check of the cell allows for (``chip_smoke.py``
    ``GBDT_METRIC_TOL``)."""
    rng = np.random.default_rng(0)
    X = rng.normal(size=(4096, 100))
    y = X[:, :5].sum(axis=1) + 0.3 * rng.normal(size=4096) + 5.0
    kw = dict(objective="quantile", alpha=0.9, num_iterations=40,
              num_leaves=15)
    jb, tb = _fit(kw, X, y)

    def pinball(b):
        d = y - b.predict(X)
        return float(np.mean(np.where(d >= 0, 0.9 * d, -0.1 * d)))
    rel = abs(pinball(jb) - pinball(tb)) / pinball(tb)
    print(f"quantile bench, JAX {pinball(jb):.6f} port {pinball(tb):.6f}: "
          f"{rel:.2e} relative")
    compared, tie = assert_same_fit(jb, tb, X, X)
    assert tie is not None and compared < 40        # a tie parts them
    assert 1e-3 < rel < 1e-2


# ---------------------------------------------------------------------------
# the fused sampling modes: quality and determinism


def _binary_data(seed=3, n=900):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 10))
    y = (X[:, 0] * 2 - X[:, 1] + X[:, 2] * 0.5
         + rng.logistic(size=n) * 0.5 > 0).astype(np.float64)
    cut = int(n * 0.75)
    return X[:cut], y[:cut], X[cut:], y[cut:]


_SAMPLING = {
    "goss_early_stop": (3, dict(boosting_type="goss", num_iterations=60,
                                early_stopping_round=5)),
    "bagging_early_stop": (5, dict(bagging_fraction=0.7, bagging_freq=2,
                                   num_iterations=60,
                                   early_stopping_round=5)),
    "feature_fraction": (7, dict(feature_fraction=0.7, num_iterations=40)),
}


@pytest.mark.parametrize("name", list(_SAMPLING))
def test_fused_sampling_modes_pass_the_jax_gates(name, monkeypatch):
    seed, extra = _SAMPLING[name]
    Xtr, ytr, Xv, yv = _binary_data(seed)
    p = TG.BoosterParams(objective="binary", num_leaves=7, seed=0, **extra)
    train_kw = ({"valid_sets": [(Xv, yv)]}
                if "early_stopping_round" in extra else {})
    calls = _count_fused(monkeypatch)
    b1 = TG.Booster.train(p, Xtr, ytr, device="cpu", **train_kw)
    b2 = TG.Booster.train(p, Xtr, ytr, device="cpu", **train_kw)
    assert calls == [1, 1]                   # each fit one fused loop
    assert _auc(yv, b1.predict(Xv)) > 0.85
    np.testing.assert_array_equal(b1.predict(Xv), b2.predict(Xv))
    if name == "feature_fraction":
        used = {int(f) for it in b1.trees for t in it
                for f in t.feature if f >= 0}
        assert len(used) > 7     # 7 of 10 per iteration, redrawn each


def test_goss_fused_quality_matches_host_loop():
    Xtr, ytr, Xv, yv = _binary_data(seed=9)
    p = TG.BoosterParams(objective="binary", boosting_type="goss",
                         num_iterations=40, num_leaves=7, seed=0)
    auc_fused = _auc(yv, TG.Booster.train(p, Xtr, ytr, device="cpu")
                     .predict(Xv))
    auc_host = _auc(yv, TG.Booster.train(p, Xtr, ytr, device="cpu",
                                         log_every=1000).predict(Xv))
    assert abs(auc_fused - auc_host) < 0.03, (auc_fused, auc_host)


def test_bagged_quantile_renewal_fused():
    rng = np.random.default_rng(13)
    X = rng.normal(size=(700, 8))
    y = X[:, 0] * 3 + X[:, 1] + 0.3 * rng.normal(size=700)
    p = TG.BoosterParams(objective="quantile", alpha=0.8,
                         bagging_fraction=0.8, bagging_freq=1,
                         num_iterations=30, num_leaves=7, seed=0)
    b = TG.Booster.train(p, X, y, device="cpu")
    assert 0.7 < float(np.mean(y <= b.predict(X))) < 0.92


def test_out_of_bag_rows_get_every_tree():
    """With bagging, every row's training-time raw score includes every
    tree: the fused fit's scores equal a fresh prediction."""
    rng = np.random.default_rng(2)
    X = rng.normal(size=(500, 4))
    y = X[:, 0] + 0.1 * rng.normal(size=500)
    p = TG.BoosterParams(objective="regression", num_iterations=6,
                         num_leaves=15, bagging_fraction=0.6,
                         bagging_freq=1, seed=0)
    b = TG.Booster.train(p, X, y, device="cpu")
    bins_t = TT.prepare_bins_t(torch.from_numpy(b.mapper.transform(X)))
    raw = torch.full((500, 1), float(b.init_score[0]))
    gen = torch.Generator().manual_seed(0)
    raw_out, _ = TT.boost_loop_device(
        bins_t, torch.tensor(y, dtype=torch.float32), torch.ones(500),
        torch.ones(500, dtype=torch.bool), raw, b.obj.grad_hess, 6, 1,
        p.growth(), torch.zeros(4, dtype=torch.bool), None, 4,
        b.mapper.max_bins_total, 0.1, None, generator=gen,
        bagging_fraction=0.6, bagging_freq=1, n_real=500)
    np.testing.assert_allclose(raw_out[:, 0].numpy(), b.predict_raw(X)[:, 0],
                               rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# weights carried across: model strings and LightGBM text


@pytest.fixture(scope="module")
def string_fits():
    Xtr, ytr, Xte, _ = _breast_cancer()
    Xtr = Xtr.copy()
    Xtr[::11, 3] = np.nan                     # missing values route too
    cat = np.random.default_rng(1).integers(0, 5, len(Xtr)).astype(float)
    Xtr = np.concatenate([Xtr, cat[:, None]], axis=1)
    Xte = np.concatenate([Xte, np.full((len(Xte), 1), 2.0)], axis=1)
    kw = dict(objective="binary", num_iterations=10, num_leaves=7,
              min_data_in_leaf=5)
    jb, tb = _fit(kw, Xtr, ytr, categorical_features=[30])
    return jb, tb, Xte


def test_jax_model_string_loads_in_the_port(string_fits):
    jb, _, Xte = string_fits
    s = jb.model_to_string()
    loaded = TG.Booster.from_string(s, device="cpu")
    np.testing.assert_allclose(loaded.predict(Xte), jb.predict(Xte),
                               **STRING_TOL)
    np.testing.assert_allclose(loaded.predict_raw(Xte), jb.predict_raw(Xte),
                               **STRING_TOL)
    assert loaded.model_to_string() == s


def test_port_model_string_loads_in_jax(string_fits):
    _, tb, Xte = string_fits
    loaded = JG.Booster.from_string(tb.model_to_string())
    np.testing.assert_allclose(loaded.predict(Xte), tb.predict(Xte),
                               **STRING_TOL)
    assert loaded.model_to_string() == tb.model_to_string()


def test_importances_and_truncated_predict_match_jax(string_fits):
    jb, _, Xte = string_fits
    loaded = TG.Booster.from_string(jb.model_to_string(), device="cpu")
    assert loaded.num_total_iterations == jb.num_total_iterations == 10
    for kind in ("split", "gain"):
        np.testing.assert_allclose(loaded.feature_importances(kind),
                                   jb.feature_importances(kind), rtol=1e-6)
    for k in (1, 4):
        np.testing.assert_allclose(loaded.predict(Xte, num_iteration=k),
                                   jb.predict(Xte, num_iteration=k),
                                   **STRING_TOL)


def test_lightgbm_export_equals_jax(string_fits):
    jb, tb, Xte = string_fits
    cats_free = TG.Booster.from_string(jb.model_to_string(), device="cpu")
    assert cats_free.to_lightgbm_string() == jb.to_lightgbm_string()
    # the port's own fit exports to text that JAX reads back
    text = tb.to_lightgbm_string()
    np.testing.assert_allclose(JG.Booster.from_string(text).predict(Xte),
                               tb.predict(Xte), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("model", [
    LGBM_BINARY_MODEL, LGBM_CATEGORICAL_MODEL,
    LGBM_MISSING_NAN_MODEL.replace("DTYPE", "10"),
    LGBM_MISSING_NAN_MODEL.replace("DTYPE", "6")], ids=[
        "binary", "categorical", "nan_default_left", "zero_missing"])
def test_lightgbm_text_import_matches_jax(model):
    jb = JG.Booster.from_string(model)
    tb = TG.Booster.from_string(model, device="cpu")
    n_feat = len(jb.feature_names)
    rng = np.random.default_rng(0)
    X = rng.integers(-1, 4, size=(64, n_feat)).astype(np.float64)
    X[::5, 0] = np.nan
    X[1::7, -1] = 0.0
    np.testing.assert_allclose(tb.predict(X), jb.predict(X), **STRING_TOL)
    assert tb.to_lightgbm_string() == jb.to_lightgbm_string()


# ---------------------------------------------------------------------------
# refusals and the histogram_impl field


def test_sharding_is_refused():
    Xtr, ytr, _, _ = _breast_cancer()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TG.Booster.train(TG.BoosterParams(num_iterations=1), Xtr, ytr,
                         sharding=object(), device="cpu")


def test_default_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    Xtr, ytr, _, _ = _breast_cancer()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TG.Booster.train(TG.BoosterParams(num_iterations=1), Xtr, ytr)
    with pytest.raises(RuntimeError):
        TG.Booster.from_string(LGBM_BINARY_MODEL)


@pytest.mark.parametrize("field,value,error", [
    ("histogram_impl", "mxu", ValueError),
    ("tree_learner", "gossip", ValueError)])
def test_unknown_values_are_refused(field, value, error):
    Xtr, ytr, _, _ = _breast_cancer()
    with pytest.raises(error):
        TG.Booster.train(TG.BoosterParams(num_iterations=1, **{field: value}),
                         Xtr, ytr, device="cpu")


def test_every_histogram_impl_gives_the_same_fit():
    """The JAX field chooses between two engines of one function; the
    port runs K9 on the card and its plain version on the CPU for each
    value, so every value gives the same trees."""
    Xtr, ytr, Xte, _ = _breast_cancer()
    preds = [TG.Booster.train(TG.BoosterParams(
        objective="binary", num_iterations=3, num_leaves=7,
        histogram_impl=impl), Xtr, ytr, device="cpu").predict(Xte)
        for impl in TG.booster.HISTOGRAM_IMPLS]
    for p in preds[1:]:
        np.testing.assert_array_equal(p, preds[0])
