"""The port's GBDT examples (``mmlspark_tpu_torch.examples``) against the
JAX package's scripts under ``examples/`` and the same pipelines composed
from the JAX package, on the CPU at small sizes.

- Each example's data generator gives the arrays the JAX script builds:
  the JAX script's ``main`` runs with ``DataFrame`` swapped for a
  recorder that stops it at the first frame (:func:`jax_example_frames`).
- Each pipeline's fit equals JAX's up to the first tie
  (``tests/test_torch_gbdt.py``'s ``assert_same_fit``); the numbers
  computed from it (coverage, accuracy, R^2, LIME weights) equal JAX's
  where the fits are tie-free; SAR's top-10 lists equal JAX's, ties
  aside (``tests/test_torch_recommend.py``'s rule).
"""

from __future__ import annotations

import importlib.util
import os
import sys

import numpy as np
import pytest
import torch

import mmlspark_tpu.core.dataframe as JD
from mmlspark_tpu.core.dataframe import DataFrame as JDF

from mmlspark_tpu_torch.examples import (
    EXAMPLES, adult_census_binary, drug_discovery_quantile,
    flight_delays_regression, hyperparam_tuning, interpret_lime,
    recommender_sar, text_classification)
from mmlspark_tpu_torch.examples import _common

from test_torch_explain import COEF_TOL, scaled_err
from test_torch_gbdt import assert_same_fit
from test_torch_recommend import same_top_k

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EX_DIR = os.path.join(ROOT, "examples")


class _Stop(Exception):
    pass


def jax_example(name: str):
    """The JAX script ``examples/<name>.py`` as a module (its ``_common``
    found on the path, as when it runs from a checkout)."""
    if EX_DIR not in sys.path:
        sys.path.insert(0, EX_DIR)
    spec = importlib.util.spec_from_file_location(
        f"jax_example_{name}", os.path.join(EX_DIR, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def jax_example_frames(monkeypatch, name: str, n: int = 1) -> list:
    """The column dicts of the first ``n`` frames the JAX script's
    ``main`` builds; the script stops at the ``n``-th."""
    seen = []

    class Recorder(JDF):
        def __init__(self, data=None, *a, **kw):
            seen.append(dict(data))
            if len(seen) == n:
                raise _Stop
            super().__init__(data, *a, **kw)

    mod = jax_example(name)
    with monkeypatch.context() as m:
        m.setattr(JD, "DataFrame", Recorder)
        with pytest.raises(_Stop):
            mod.main()
    return seen


def assert_columns_equal(got: dict, ref: dict) -> None:
    assert sorted(got) == sorted(ref)
    for k in ref:
        a, b = np.asarray(got[k]), np.asarray(ref[k])
        assert a.shape == b.shape, k
        if a.dtype.kind in "OUS":
            assert list(a) == list(b), k
        else:
            np.testing.assert_array_equal(a, b, err_msg=k)


# ---------------------------------------------------------------------------
# the generators


def test_every_example_has_a_counterpart():
    jax_names = sorted(f[:-3] for f in os.listdir(EX_DIR)
                       if f.endswith(".py") and not f.startswith("_"))
    assert sorted(EXAMPLES) == jax_names
    for name in EXAMPLES:
        mod = importlib.import_module(f"mmlspark_tpu_torch.examples.{name}")
        assert callable(mod.run) and callable(mod.main)


@pytest.mark.parametrize("name,port", [
    ("drug_discovery_quantile",
     lambda: dict(zip(("features", "label"),
                      drug_discovery_quantile.make_data()))),
    ("adult_census_binary",
     lambda: dict(zip(("features", "income"),
                      adult_census_binary.make_data()))),
    ("flight_delays_regression", flight_delays_regression.make_frame),
    ("text_classification",
     lambda: dict(zip(("text", "label"), text_classification.make_docs()))),
    ("recommender_sar", recommender_sar.make_events),
    ("interpret_lime",
     lambda: dict(zip(("features", "label"),
                      interpret_lime.make_data()[:2]))),
])
def test_generator_is_the_jax_scripts(monkeypatch, name, port):
    ref, = jax_example_frames(monkeypatch, name)
    assert_columns_equal(port(), ref)


def test_lime_images_are_the_jax_scripts(monkeypatch):
    """The images the JAX script explains: its GBDT, tabular LIME and
    network stubbed, its ``ImageLIME.fit`` records the frame."""
    import mmlspark_tpu.explain as JE
    import mmlspark_tpu.gbdt as JG
    import mmlspark_tpu.models.function as JFn
    import mmlspark_tpu.models.nn as JNN

    class Stub:
        def __init__(self, **kw):
            pass

        def fit(self, df):
            if "image" in df.columns:
                seen.append(np.asarray(df["image"]))
                raise _Stop
            return self

        def transform(self, df):
            return {"lime_weights": [np.zeros(8)]}

    seen = []
    monkeypatch.setattr(JG, "GBDTClassifier", Stub)
    monkeypatch.setattr(JE, "TabularLIME", Stub)
    monkeypatch.setattr(JE, "ImageLIME", Stub)
    monkeypatch.setattr(JNN, "NNModel", Stub)
    monkeypatch.setattr(JFn.NNFunction, "init",
                        staticmethod(lambda *a, **kw: None))
    with pytest.raises(_Stop):
        jax_example("interpret_lime").main()
    np.testing.assert_array_equal(interpret_lime.make_data()[2], seen[0])


def test_bundled_datasets_are_scikit_learns():
    from sklearn.datasets import load_breast_cancer, load_digits
    X, y = _common.load_breast_cancer()
    Xr, yr = load_breast_cancer(return_X_y=True)
    np.testing.assert_array_equal(X, Xr)
    np.testing.assert_array_equal(y, yr)
    d, dr = _common.load_digits(), load_digits()
    for k in ("data", "images", "target"):
        np.testing.assert_array_equal(d[k], dr[k])
        assert d[k].dtype == dr[k].dtype


def test_breast_cancer_split_is_the_jax_scripts(monkeypatch):
    ref, = jax_example_frames(monkeypatch, "hyperparam_tuning")
    Xtr, ytr, _, _ = hyperparam_tuning.make_split()
    assert_columns_equal({"features": Xtr, "label": ytr}, ref)


# ---------------------------------------------------------------------------
# the pipelines, against the same pipelines composed from the JAX package


def test_quantile_fit_is_jaxs():
    import mmlspark_tpu.gbdt as JG
    kw = dict(seed=3, n=600, f=20, num_iterations=6, num_leaves=15)
    out = drug_discovery_quantile.run(device="cpu", **kw)
    X, y = drug_discovery_quantile.make_data(3, 600, 20)
    jm = JG.GBDTRegressor(objective="quantile", alpha=0.9, num_iterations=6,
                          num_leaves=15).fit(JDF({"features": X, "label": y}))
    compared, tie = assert_same_fit(jm.booster, out["_model"].booster, X, X)
    assert compared >= 1
    if tie is None:
        ref = float((np.asarray(jm.transform(JDF({"features": X}))
                                ["prediction"]) >= y).mean())
        assert out["coverage"] == ref


def test_adult_fit_is_jaxs():
    import mmlspark_tpu.gbdt as JG
    out = adult_census_binary.run(device="cpu", n=1024, num_iterations=6,
                                  num_leaves=15)
    X, y = adult_census_binary.make_data(0, 1024)
    jm = JG.GBDTClassifier(label_col="income", num_iterations=6,
                           num_leaves=15, parallelism="data_parallel",
                           categorical_feature_indexes=[2, 3]).fit(
        JDF({"features": X, "income": y}))
    compared, tie = assert_same_fit(jm.booster, out["_model"].booster, X, X)
    assert compared == 6 and tie is None
    ref = np.asarray(jm.transform(JDF({"features": X}))["prediction"])
    np.testing.assert_array_equal(out["_prediction"], ref)


def test_flight_pipeline_is_jaxs():
    import mmlspark_tpu.gbdt as JG
    from mmlspark_tpu.automl.metrics import ComputeModelStatistics as JStats
    from mmlspark_tpu.automl.train import TrainRegressor as JTrain
    kw = dict(n=1200, n_train=1000, num_iterations=6, num_leaves=15)
    out = flight_delays_regression.run(device="cpu", **kw)
    df = JDF(flight_delays_regression.make_frame(0, 1200))
    train, test = df.head(1000), df.take(np.arange(1000, 1200))
    jm = JTrain(model=JG.GBDTRegressor(num_iterations=6, num_leaves=15,
                                       min_data_in_leaf=10),
                label_col="arr_delay").fit(train)
    pm = out["_model"]
    X = np.asarray(jm.featurizer.transform(train)[jm.features_col])
    compared, tie = assert_same_fit(jm.fitted.booster, pm.fitted.booster,
                                    X, X)
    assert compared >= 1
    if tie is None:
        stats = JStats(label_col="arr_delay").evaluate(jm.transform(test))
        assert abs(out["r2"] - float(stats["R^2"][0])) <= 1e-6


def test_tuning_is_jaxs():
    import mmlspark_tpu.gbdt as JG
    from mmlspark_tpu.automl.train import TrainClassifier as JTrain
    from mmlspark_tpu.automl.tune import (
        DiscreteHyperParam, HyperparamBuilder, RangeHyperParam,
        TuneHyperparameters)
    # seed 34 draws two 7-leaf, 15-iteration trials: JAX compiles each
    # fit's shapes, and the 31-leaf, 30-iteration ones take 6-15 s each
    kw = dict(n_train=160, num_folds=2, num_runs=2, parallelism=1,
              tune_seed=34, min_auc=0.9)
    out = hyperparam_tuning.run(device="cpu", **kw)
    Xtr, ytr, _, _ = hyperparam_tuning.make_split(0, 160)
    space = (HyperparamBuilder()
             .add_hyperparam("num_leaves", DiscreteHyperParam([7, 15, 31]))
             .add_hyperparam("num_iterations", DiscreteHyperParam([15, 30]))
             .add_hyperparam("learning_rate",
                             RangeHyperParam(0.03, 0.3, log=True))
             .build())
    jt = TuneHyperparameters(
        models=[JTrain(model=JG.GBDTClassifier(min_data_in_leaf=5),
                       label_col="label")],
        param_space=space, evaluation_metric="AUC", num_folds=2,
        num_runs=2, parallelism=1, seed=34, trial_devices=False).fit(
        JDF({"features": Xtr, "label": ytr}))
    pt = out["_model"]
    # the same draws from the same seed
    jh, ph = jt.get_history(), pt.get_history()
    assert ph.columns == jh.columns
    for c in ("model", "num_leaves", "num_iterations", "learning_rate"):
        assert list(ph[c]) == list(jh[c]), c
    # the winner's refit against JAX's fit of the same params (the
    # breast-cancer features tie often: the CV metrics, and so the
    # winner, may part at a tie, as tests/test_torch_automl.py shows)
    jb = JTrain(model=JG.GBDTClassifier(min_data_in_leaf=5,
                                        **out["best_params"]),
                label_col="label").fit(JDF({"features": Xtr, "label": ytr}))
    compared, tie = assert_same_fit(jb.fitted.booster,
                                    pt.best_model.fitted.booster, Xtr, Xtr)
    assert compared >= 1


def test_text_pipeline_is_jaxs():
    import mmlspark_tpu.gbdt as JG
    from mmlspark_tpu.automl.train import TrainClassifier as JTrain
    from mmlspark_tpu.featurize.text import TextFeaturizer as JText
    out = text_classification.run(device="cpu", n=200, num_iterations=6)
    docs, y = text_classification.make_docs(0, 200)
    df = JDF({"text": docs, "label": y})
    jf = JText(input_col="text", output_col="feats",
               num_features=256).fit(df).transform(df)
    got = np.stack(list(out["_feats"]["feats"]))
    ref = np.stack(list(jf["feats"]))
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)
    jm = JTrain(model=JG.GBDTClassifier(num_iterations=6, num_leaves=7),
                label_col="label").fit(jf.select(["feats", "label"]))
    X = np.asarray(jm.featurizer.transform(jf.select(["feats", "label"]))
                   [jm.features_col])
    compared, tie = assert_same_fit(jm.fitted.booster,
                                    out["_model"].fitted.booster, X, X)
    assert compared == 6
    if tie is None:
        ref = np.asarray(jm.transform(jf.select(["feats", "label"]))
                         ["prediction"])
        np.testing.assert_array_equal(out["_prediction"], ref)


def test_sar_recommendations_are_jaxs():
    from mmlspark_tpu.recommend import RecommendationIndexer as JIdx
    from mmlspark_tpu.recommend import SAR as JSAR
    kw = dict(n_users=60, n_items=20, n_events=800)
    out = recommender_sar.run(device="cpu", **kw)
    df = JDF(recommender_sar.make_events(0, **kw))
    idx = JIdx(user_input_col="user", item_input_col="item",
               user_output_col="user_idx", item_output_col="item_idx").fit(df)
    jm = JSAR(user_col="user_idx", item_col="item_idx", rating_col="rating",
              timestamp_col="timestamp",
              similarity_function="jaccard").fit(idx.transform(df))
    ref = jm.recommend_for_all_users(10)
    got = out["_recs"]
    assert got.num_rows == ref.num_rows == 60
    scores = np.asarray(jm._scores(np.arange(60), jm.remove_seen))
    same_top_k(list(got["recommendations"]), list(ref["recommendations"]),
               scores)


def test_lime_is_jaxs():
    import jax
    import mmlspark_tpu.gbdt as JG
    from mmlspark_tpu.explain import ImageLIME as JImageLIME
    from mmlspark_tpu.explain import TabularLIME as JTabLIME
    from mmlspark_tpu.models.function import NNFunction as JF
    from mmlspark_tpu.models.nn import NNModel as JNN
    from mmlspark_tpu_torch.models.function import NNFunction as PF

    arch = interpret_lime.CONVNET
    jf = JF.init(arch, input_shape=(32, 32, 3), seed=0)
    pf = PF(arch=dict(arch), params=jax.tree.map(np.asarray, jf.params))
    kw = dict(n=256, n_explained=6, n_samples=64, n_images=2,
              image_samples=16)
    out = interpret_lime.run(device="cpu", net=pf, **kw)
    X, y, images = interpret_lime.make_data(0, 256, 2)
    df = JDF({"features": X, "label": y})
    clf = JG.GBDTClassifier(num_iterations=20, num_leaves=7).fit(df)
    compared, tie = assert_same_fit(clf.booster, out["_gbdt"].booster, X, X)
    assert compared == 20 and tie is None
    lime = JTabLIME(model=clf, input_col="features",
                    predict_col="probability", n_samples=64).fit(df)
    ref = np.stack(list(lime.transform(df.head(6))["lime_weights"]))
    assert scaled_err(out["_weights"], ref) <= COEF_TOL
    scorer = JNN(model=jf, input_col="image", output_col="scores")
    idf = JDF({"image": images})
    jout = JImageLIME(model=scorer, input_col="image",
                      n_samples=16).fit(idf).transform(idf)
    for a, b in zip(out["_image_weights"], jout["lime_weights"]):
        assert scaled_err(a, b) <= COEF_TOL


# ---------------------------------------------------------------------------
# the command line


def test_the_card_by_default(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        drug_discovery_quantile.main([])


def test_json_line_counts_this_process(capsys):
    import json
    text_classification.main(["--device", "cpu", "--json"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("text classification: ")
    rec = json.loads(lines[-1])
    assert rec["example"] == "text_classification"
    assert rec["device"] == "cpu" and rec["card"] is None
    # the CPU runs K9's plain version: no kernel launch, none counted
    assert rec["launches"] == {} and rec["plain_on_card"] == {}
    assert rec["accuracy"] == 1.0 and rec["wall_s"] > 0
