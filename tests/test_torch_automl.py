"""The port's AutoML layer (``mmlspark_tpu_torch/automl/metrics.py``,
``best.py``, ``tune.py``) against the JAX package's, on the CPU.

* The metric functions and evaluators are host numpy in both packages:
  equal on the same inputs (ties in the scores included).
* ``FindBestModel`` and ``TuneHyperparameters`` over
  ``TrainClassifier(GBDTClassifier)``: the GBDT fits are held by
  ``tests/test_torch_gbdt.py``'s tie rule (``assert_same_fit``). A
  trial whose fold fits meet no tie has its mean metric within 1e-9 of
  JAX's; fits that part at a tie (two gains within 1e-5 of the root
  gain) may score otherwise, and are named, not compared.
* Per-trial cards: the round robin over a patched card list (the CPU
  stands in: ``cpu:i``), each trial in ``single_device_scope`` with its
  estimator placed; pinned trials give the unpinned history. With one
  card ``"auto"`` pins nothing (``tests/test_torch_long_tail_gpu.py``).

The classes of ``tests/test_automl.py`` are mirrored on the port, with
every GBDT stage on ``device="cpu"``.
"""

import threading

import numpy as np
import pytest
import torch

from mmlspark_tpu.automl import best as JBest
from mmlspark_tpu.automl import metrics as JM
from mmlspark_tpu.automl import train as JTrain
from mmlspark_tpu.automl import tune as JTune
from mmlspark_tpu.core.dataframe import DataFrame as JDF
from mmlspark_tpu.gbdt import stages as JG
from mmlspark_tpu_torch.automl import (
    TrainClassifier, TrainRegressor, ComputeModelStatistics,
    ComputePerInstanceStatistics, FindBestModel, TuneHyperparameters,
    HyperparamBuilder, DiscreteHyperParam, RangeHyperParam, GridSpace,
    RandomSpace,
)
from mmlspark_tpu_torch.automl import metrics as PM
from mmlspark_tpu_torch.automl import tune as PTune
from mmlspark_tpu_torch.automl.metrics import (
    classification_metrics, regression_metrics,
)
from mmlspark_tpu_torch.core import schema as S
from mmlspark_tpu_torch.core.dataframe import DataFrame
from mmlspark_tpu_torch.core.params import Param
from mmlspark_tpu_torch.core.stage import Estimator, Model, PipelineStage
from mmlspark_tpu_torch.gbdt.stages import GBDTClassifier, GBDTRegressor
from mmlspark_tpu_torch.parallel.topology import in_single_device_scope

from test_torch_gbdt import assert_same_fit

torch.set_num_threads(1)

#: a trial's mean metric against JAX's, where its fits meet no tie
HISTORY_TOL = 1e-9


def _binary_df(n=200, seed=0, frame=DataFrame):
    rng = np.random.default_rng(seed)
    x1 = rng.normal(size=n)
    x2 = rng.normal(size=n)
    label = np.where(x1 + 0.5 * x2 + 0.3 * rng.normal(size=n) > 0,
                     "good", "bad")
    return frame({"x1": x1, "x2": x2,
                  "color": rng.choice(["r", "g", "b"], size=n).tolist(),
                  "label": label.tolist()})


def _reg_df(n=200, seed=0):
    rng = np.random.default_rng(seed)
    x1 = rng.normal(size=n)
    x2 = rng.normal(size=n)
    y = 2.0 * x1 - x2 + 0.1 * rng.normal(size=n)
    return DataFrame({"x1": x1, "x2": x2, "y": y})


SMALL_GBDT = dict(num_iterations=20, num_leaves=7, min_data_in_leaf=5)


def _gbdt_cls(**kw):
    return GBDTClassifier(device="cpu", **{**SMALL_GBDT, **kw})


# -- tests/test_automl.py, on the port ---------------------------------------

class TestMetricFns:
    def test_classification_metrics(self):
        y = np.array([0, 0, 1, 1])
        pred = np.array([0, 1, 1, 1])
        score = np.array([0.1, 0.6, 0.7, 0.9])
        m = classification_metrics(y, pred, score)
        assert m["accuracy"] == 0.75
        assert m["confusion_matrix"].tolist() == [[1, 1], [0, 2]]
        assert m["AUC"] == 1.0

    def test_regression_metrics(self):
        y = np.array([1.0, 2.0, 3.0])
        m = regression_metrics(y, y)
        assert m["root_mean_squared_error"] == 0.0
        assert m["R^2"] == 1.0


class TestTrainClassifier:
    def test_end_to_end(self, tmp_path):
        df = _binary_df()
        model = TrainClassifier(model=_gbdt_cls(), label_col="label").fit(df)
        scored = model.transform(df)
        assert set(scored["prediction"]) <= {"good", "bad"}
        acc = np.mean(scored["prediction"] == np.asarray(df["label"]))
        assert acc > 0.85
        metrics = ComputeModelStatistics(label_col="label").evaluate(scored)
        assert float(metrics["accuracy"][0]) == pytest.approx(acc)
        assert float(metrics["AUC"][0]) > 0.9
        model.save(str(tmp_path / "tc"))
        loaded = PipelineStage.load(str(tmp_path / "tc"), device="cpu")
        scored2 = loaded.transform(df)
        assert list(scored2["prediction"]) == list(scored["prediction"])

    def test_per_instance(self):
        df = _binary_df()
        model = TrainClassifier(model=_gbdt_cls(), label_col="label").fit(df)
        scored = model.transform(df)
        out = ComputePerInstanceStatistics(label_col="label").evaluate(scored)
        assert "log_loss" in out.columns
        assert np.all(out["log_loss"] >= 0)


class TestTrainRegressor:
    def test_end_to_end(self):
        df = _reg_df()
        model = TrainRegressor(
            model=GBDTRegressor(device="cpu", **SMALL_GBDT),
            label_col="y").fit(df)
        scored = model.transform(df)
        metrics = ComputeModelStatistics(label_col="y").evaluate(scored)
        assert float(metrics["R^2"][0]) > 0.8
        out = ComputePerInstanceStatistics(label_col="y").evaluate(scored)
        assert "L1_loss" in out.columns and "L2_loss" in out.columns


class TestFindBestModel:
    def test_picks_better(self, tmp_path):
        df = _binary_df()
        weak = TrainClassifier(
            model=_gbdt_cls(num_iterations=1, num_leaves=2,
                            min_data_in_leaf=50),
            label_col="label").fit(df)
        strong = TrainClassifier(model=_gbdt_cls(),
                                 label_col="label").fit(df)
        best = FindBestModel(models=[weak, strong], label_col="label",
                             evaluation_metric="accuracy").fit(df)
        assert best.best_model is strong
        hist = best.get_all_model_metrics()
        assert hist.num_rows == 2
        assert best.get_roc_curve() is not None
        best.save(str(tmp_path / "best"))
        back = PipelineStage.load(str(tmp_path / "best"), device="cpu")
        assert list(back.transform(df)["prediction"]) == \
            list(best.transform(df)["prediction"])


class TestSpaces:
    def test_grid_space(self):
        space = (HyperparamBuilder()
                 .add_hyperparam("a", DiscreteHyperParam([1, 2]))
                 .add_hyperparam("b", DiscreteHyperParam(["x", "y"]))
                 .build())
        maps = list(GridSpace(space).param_maps())
        assert len(maps) == 4
        assert {"a": 1, "b": "y"} in maps

    def test_random_space(self):
        space = {"lr": RangeHyperParam(1e-3, 1e-1, log=True),
                 "n": RangeHyperParam(1, 10, is_int=True)}
        samples = list(RandomSpace(space, seed=1).sample(20))
        assert len(samples) == 20
        assert all(1e-3 <= s["lr"] <= 1e-1 for s in samples)
        assert all(isinstance(s["n"], int) and 1 <= s["n"] <= 10
                   for s in samples)


class TestTuneHyperparameters:
    def test_random_search_cv(self, tmp_path):
        df = _binary_df(150)
        space = {"num_leaves": DiscreteHyperParam([3, 7]),
                 "num_iterations": DiscreteHyperParam([5, 15])}
        tuned = TuneHyperparameters(
            models=[TrainClassifier(
                model=GBDTClassifier(min_data_in_leaf=5, device="cpu"),
                label_col="label")],
            param_space=space, evaluation_metric="accuracy",
            num_folds=2, num_runs=3, parallelism=2, seed=3).fit(df)
        assert tuned.best_metric > 0.7
        assert set(tuned.best_params) == {"num_leaves", "num_iterations"}
        hist = tuned.get_history()
        assert hist.num_rows == 3
        scored = tuned.transform(df)
        assert "prediction" in scored.columns
        tuned.save(str(tmp_path / "tuned"))
        back = PipelineStage.load(str(tmp_path / "tuned"), device="cpu")
        assert back.best_params == tuned.best_params
        assert list(back.transform(df)["prediction"]) == \
            list(scored["prediction"])


class _Recorder(Estimator):
    """Records, per fit, the device it was placed on, whether it ran in
    ``single_device_scope`` and on which thread."""

    num_leaves = Param(0, "searched dummy", ptype=int)
    device = Param(None, "where it was placed", ptype=str)
    seen = []
    lock = threading.Lock()

    def fit(self, df):
        with self.lock:
            self.seen.append((self.num_leaves, self.device,
                              in_single_device_scope(),
                              threading.get_ident()))
        return _ConstModel()


class _ConstModel(Model):
    def transform(self, df):
        return df.with_column("scores", np.zeros(df.num_rows)).with_column(
            "prediction", df["label"])


def _recorded_tune(**kw):
    _Recorder.seen.clear()
    df = DataFrame({"x": np.arange(60, dtype=np.float64),
                    "label": np.r_[np.zeros(30), np.ones(30)]})
    TuneHyperparameters(
        models=[_Recorder()],
        param_space={"num_leaves": DiscreteHyperParam(list(range(8)))},
        search_mode="grid", evaluation_metric="mean_squared_error",
        num_folds=2, parallelism=8, label_col="label", **kw).fit(df)
    return list(_Recorder.seen)


class TestTrialDevices:
    """Per-trial card assignment (SURVEY 2.9 row 6): JAX's
    ``test_trials_land_on_distinct_devices`` needs 8 devices; here the
    card list is patched to 8 indexed CPU devices."""

    CARDS = [f"cpu:{i}" for i in range(8)]

    def test_trials_land_on_distinct_devices(self, monkeypatch):
        monkeypatch.setattr(PTune, "trial_device_list", lambda: self.CARDS)
        seen = _recorded_tune(trial_devices=True)
        # 8 grid trials x 2 folds, trial i on card i % 8, both folds; the
        # winner's refit runs on the caller's thread, unpinned
        pinned = [r for r in seen if r[1] is not None]
        assert len(pinned) == 16 and len(seen) == 17
        assert seen[-1][1:3] == (None, False)
        assert {d for _, d, _, _ in pinned} == set(self.CARDS)
        for leaves, device, scoped, _ in pinned:
            assert device == self.CARDS[leaves % 8] and scoped
        # "auto" pins whenever the host has more than one card
        monkeypatch.setattr(PTune, "accelerator_count", lambda: 8)
        seen = _recorded_tune()
        assert {d for _, d, _, _ in seen} == set(self.CARDS) | {None}
        # and nothing with one card or none: every estimator keeps its own
        for n in (0, 1):
            monkeypatch.setattr(PTune, "accelerator_count", lambda: n)
            seen = _recorded_tune()
            assert {(d, s) for _, d, s, _ in seen} == {(None, False)}

    def test_pinning_without_a_card_raises(self, monkeypatch):
        monkeypatch.setattr(PTune, "trial_device_list", lambda: [])
        with pytest.raises(RuntimeError, match="CUDA card"):
            _recorded_tune(trial_devices=True)

    def test_device_parallel_matches_thread_pool(self, monkeypatch):
        df = _binary_df(150)
        space = {"num_leaves": DiscreteHyperParam([3, 7]),
                 "num_iterations": DiscreteHyperParam([5, 15])}

        def tune(**kw):
            return TuneHyperparameters(
                models=[TrainClassifier(
                    model=GBDTClassifier(min_data_in_leaf=5, device="cpu"),
                    label_col="label")],
                param_space=space, evaluation_metric="accuracy",
                num_folds=2, num_runs=3, seed=3, **kw).fit(df)

        a = tune(parallelism=2)
        monkeypatch.setattr(PTune, "trial_device_list",
                            lambda: ["cpu:0", "cpu:1"])
        b = tune(parallelism=2, trial_devices=True)
        assert a.best_params == b.best_params
        assert abs(a.best_metric - b.best_metric) < 1e-9
        assert a.get_history().to_dict().keys() == \
            b.get_history().to_dict().keys()

    def test_placement_reaches_the_inner_estimator(self):
        tc = TrainClassifier(model=GBDTClassifier(), label_col="label")
        placed = PTune._placed(tc, "cpu:3")
        assert placed.model.device == "cpu:3" and tc.model.device is None
        rec = PTune._placed(_Recorder(num_leaves=2), "cpu:1")
        assert (rec.device, rec.num_leaves) == ("cpu:1", 2)


class TestReviewRegressions:
    def test_auc_constant_scores_is_half(self):
        score = np.full(4, 0.5)
        assert PM._auc(np.array([1, 1, 0, 0]), score) == pytest.approx(0.5)
        assert PM._auc(np.array([0, 0, 1, 1]), score) == pytest.approx(0.5)

    def test_auc_ties_get_half_credit(self):
        y = np.array([0, 1, 1, 0])
        s = np.array([0.1, 0.5, 0.5, 0.5])
        assert PM._auc(y, s) == pytest.approx((2 * 1.0 + 2 * 0.5) / 4)

    def test_range_hyperparam_defaults_continuous(self):
        from mmlspark_tpu_torch.automl import IntRangeHyperParam
        rng = np.random.default_rng(0)
        samples = [RangeHyperParam(0, 1).sample(rng) for _ in range(10)]
        assert any(0 < v < 1 for v in samples)
        assert all(isinstance(v, float) for v in samples)
        assert all(isinstance(IntRangeHyperParam(1, 10).sample(rng), int)
                   for _ in range(5))
        with pytest.raises(TypeError):
            RangeHyperParam(False, True)

    def test_per_instance_levels_from_metadata(self):
        df = _binary_df()
        model = TrainClassifier(model=_gbdt_cls(), label_col="label").fit(df)
        scored = model.transform(df)
        only_good = scored.filter(
            np.array([v == "good" for v in scored["label"]]))
        out = ComputePerInstanceStatistics(label_col="label").evaluate(
            only_good)
        prob = np.stack([np.asarray(p) for p in only_good["probability"]])
        levels = only_good.get_metadata("probability")["levels"]
        expected = -np.log(np.clip(prob[:, levels.index("good")], 1e-15, 1))
        np.testing.assert_allclose(out["log_loss"], expected, rtol=1e-5)

    def test_per_instance_unseen_label_is_nan(self):
        df = _binary_df()
        model = TrainClassifier(model=_gbdt_cls(), label_col="label").fit(df)
        scored = model.transform(df.head(4))
        weird = scored.with_column(
            "label", np.array(["good", "UNSEEN", "bad", "good"],
                              dtype=object))
        out = ComputePerInstanceStatistics(label_col="label").evaluate(weird)
        loss = np.asarray(out["log_loss"], dtype=np.float64)
        assert np.isnan(loss[1]) and np.isfinite(loss[[0, 2, 3]]).all()


# -- parity with the JAX package on the same inputs --------------------------

def _scores(seed, n=300, ties=True):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 2, n)
    s = rng.random(n)
    if ties:
        s = np.round(s * 7) / 7          # many equal scores
    return y, s


def _same(a, b):
    if isinstance(b, dict):
        assert a.keys() == b.keys()
        for k in b:
            _same(a[k], b[k])
    elif isinstance(b, np.ndarray):
        assert np.asarray(a).dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b or (a != a and b != b), (a, b)


@pytest.mark.parametrize("seed,ties", [(0, True), (1, False), (2, True)])
def test_metric_functions_match_jax(seed, ties):
    y, s = _scores(seed, ties=ties)
    _same(PM._auc(y, s), JM._auc(y, s))
    _same(PM._roc_points(y, s), JM._roc_points(y, s))
    pred = (s > 0.5).astype(np.int64)
    _same(classification_metrics(y, pred, s),
          JM.classification_metrics(y, pred, s))
    labels = np.array(["a", "b", "c"])[np.random.default_rng(seed)
                                        .integers(0, 3, len(y))]
    _same(classification_metrics(labels, labels[::-1].copy()),
          JM.classification_metrics(labels, labels[::-1].copy()))
    _same(regression_metrics(s, y + 0.1 * s),
          JM.regression_metrics(s, y + 0.1 * s))


def _scored(frame, task):
    """A scored frame; a classification one carries the ML-role metadata
    a model stamps on its outputs (the evaluators find columns by it)."""
    rng = np.random.default_rng(7)
    n = 64
    p = rng.random(n)
    if task == S.REGRESSION:
        return frame({"label": rng.normal(size=n), "prediction": p})
    df = frame({"label": rng.integers(0, 2, n).astype(np.float64),
                "probability": np.stack([1 - p, p], axis=1),
                "raw": np.stack([-p, p], axis=1),
                "prediction": (p > 0.5).astype(np.float64)})
    for col, kind in (("prediction", S.SCORED_LABELS_KIND),
                      ("probability", S.SCORED_PROBABILITIES_KIND),
                      ("raw", S.SCORES_KIND)):
        df = df.with_metadata(col, S.make_role_meta(kind, "m", task))
    return df


@pytest.mark.parametrize("task,kw", [
    (S.CLASSIFICATION, {}),
    (S.CLASSIFICATION, {"scored_labels_col": "prediction",
                        "scores_col": "raw", "evaluation_metric": "AUC"}),
    (S.REGRESSION, {}),
    (S.REGRESSION, {"evaluation_metric": "R^2"}),
])
def test_evaluators_match_jax(task, kw):
    p = ComputeModelStatistics(label_col="label", **kw).evaluate(
        _scored(DataFrame, task))
    j = JM.ComputeModelStatistics(label_col="label", **kw).evaluate(
        _scored(JDF, task))
    assert p.columns == j.columns
    for c in j.columns:
        _same(p[c][0], j[c][0])
    pi = ComputePerInstanceStatistics(label_col="label").evaluate(
        _scored(DataFrame, task))
    ji = JM.ComputePerInstanceStatistics(label_col="label").evaluate(
        _scored(JDF, task))
    assert pi.columns == ji.columns
    for c in ji.columns:
        np.testing.assert_array_equal(pi[c], ji[c])


#: GBDT settings whose fits on ``_binary_df`` meet no tie in either
#: package (checked below by ``assert_same_fit``)
TIE_FREE = dict(num_leaves=3, num_iterations=5, min_data_in_leaf=5)


def test_find_best_model_matches_jax():
    jdf, pdf = _binary_df(frame=JDF), _binary_df()
    settings = (dict(num_iterations=1, num_leaves=2, min_data_in_leaf=50),
                TIE_FREE)
    jms = [JTrain.TrainClassifier(model=JG.GBDTClassifier(**kw),
                                  label_col="label").fit(jdf)
           for kw in settings]
    pms = [TrainClassifier(model=GBDTClassifier(device="cpu", **kw),
                           label_col="label").fit(pdf) for kw in settings]
    X = pms[0].featurizer.transform(pdf)[pms[0].features_col]
    for jm, pm in zip(jms, pms):
        compared, tie = assert_same_fit(jm.fitted.booster,
                                        pm.fitted.booster, X, X)
        assert tie is None
    for metric in ("accuracy", "AUC"):
        jb = JBest.FindBestModel(models=jms, label_col="label",
                                 evaluation_metric=metric).fit(jdf)
        pb = FindBestModel(models=pms, label_col="label",
                           evaluation_metric=metric).fit(pdf)
        assert pms.index(pb.best_model) == jms.index(jb.best_model)
        pa, ja = pb.get_all_model_metrics(), jb.get_all_model_metrics()
        assert list(pa["model"]) == list(ja["model"])
        np.testing.assert_allclose(pa[metric], ja[metric], rtol=0,
                                   atol=HISTORY_TOL)
        np.testing.assert_allclose(pb.get_roc_curve(), jb.get_roc_curve(),
                                   rtol=0, atol=HISTORY_TOL)


def _fold_ties(jdf, pdf, pm, folds, num_folds):
    """Each fold of one trial fitted by both packages: True when any fold
    fit parts from JAX's at a tie."""
    for f in range(num_folds):
        train = np.concatenate([folds[j] for j in range(num_folds)
                                if j != f])
        jm = JTrain.TrainClassifier(
            model=JG.GBDTClassifier(min_data_in_leaf=5, **pm),
            label_col="label").fit(jdf.take(train))
        m = TrainClassifier(
            model=GBDTClassifier(min_data_in_leaf=5, device="cpu", **pm),
            label_col="label").fit(pdf.take(train))
        X = m.featurizer.transform(pdf.take(train))[m.features_col]
        if assert_same_fit(jm.fitted.booster, m.fitted.booster, X, X)[1]:
            return True
    return False


@pytest.mark.parametrize("metric", ["accuracy", "AUC"])
def test_tune_history_matches_jax(metric):
    n, folds_n, seed = 150, 2, 3
    jdf, pdf = _binary_df(n, frame=JDF), _binary_df(n)
    grid = {"num_leaves": [3, 7], "num_iterations": [5, 15]}
    j = JTune.TuneHyperparameters(
        models=[JTrain.TrainClassifier(
            model=JG.GBDTClassifier(min_data_in_leaf=5), label_col="label")],
        param_space={k: JTune.DiscreteHyperParam(v) for k, v in grid.items()},
        evaluation_metric=metric, num_folds=folds_n, search_mode="grid",
        parallelism=2, seed=seed, trial_devices=False).fit(jdf)
    p = TuneHyperparameters(
        models=[TrainClassifier(
            model=GBDTClassifier(min_data_in_leaf=5, device="cpu"),
            label_col="label")],
        param_space={k: DiscreteHyperParam(v) for k, v in grid.items()},
        evaluation_metric=metric, num_folds=folds_n, search_mode="grid",
        parallelism=2, seed=seed).fit(pdf)
    jh, ph = j.get_history(), p.get_history()
    assert ph.columns == jh.columns
    for c in ("model", "num_leaves", "num_iterations"):
        assert list(ph[c]) == list(jh[c])
    folds = np.array_split(np.random.default_rng(seed).permutation(n),
                           folds_n)
    compared = 0
    for i in range(ph.num_rows):
        pm = {"num_leaves": int(ph["num_leaves"][i]),
              "num_iterations": int(ph["num_iterations"][i])}
        if _fold_ties(jdf, pdf, pm, folds, folds_n):
            continue
        assert abs(ph[metric][i] - jh[metric][i]) <= HISTORY_TOL, pm
        compared += 1
    # the 3-leaf trials meet no tie; the 7-leaf ones part at a gap of
    # about 1e-8 of the root gain in their first tree
    assert compared >= 2
    assert p.best_params == j.best_params


# -- udfs.py and plot.py ---------------------------------------------------------

def test_udfs_match_jax():
    from mmlspark_tpu import udfs as JU
    from mmlspark_tpu_torch import udfs as PU
    col = [[1, 2.5, 3], np.array([4.0, 5, 6]), (7, 8, 9)]
    np.testing.assert_array_equal(PU.to_vector(col), JU.to_vector(col))
    for i in (0, 2, -1):
        np.testing.assert_array_equal(PU.get_value_at(col, i),
                                      JU.get_value_at(col, i))


class _Axes:
    """Records every call a plot makes on its axes (no matplotlib)."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def record(*args, **kwargs):
            self.calls.append((name, _plain(args), _plain(kwargs)))
        return record


def _plain(v):
    if isinstance(v, np.ndarray):
        return v.tolist()
    if isinstance(v, (list, tuple)):
        return [_plain(x) for x in v]
    if isinstance(v, dict):
        return {k: _plain(x) for k, x in v.items()}
    return v


def test_plots_draw_what_jax_draws():
    """The same calls on the axes as JAX's plots (the caller's axes:
    matplotlib is imported only to find the current ones)."""
    from mmlspark_tpu import plot as JPl
    from mmlspark_tpu_torch import plot as PPl
    y, s = _scores(4, n=50)
    pred = (s > 0.4).astype(np.int64)
    for draw in (lambda m, ax: m.confusion_matrix(y, pred, ax=ax),
                 lambda m, ax: m.confusion_matrix(y, pred, labels=[1, 0],
                                                  ax=ax),
                 lambda m, ax: m.roc(y, s, ax=ax)):
        pa, ja = _Axes(), _Axes()
        assert draw(PPl, pa) is pa
        draw(JPl, ja)
        assert pa.calls == ja.calls
