"""The long tail's device work on the card (SAR's products, LIME's
batched solves, the tune trials), held against the port's own CPU path
on the same inputs.

Every test here is marked ``gpu`` and skips without a CUDA card; the
file imports nothing of JAX. Run it on the card with::

    MMLSPARK_TPU_TEST_TPU=1 python -m pytest tests/test_torch_long_tail_gpu.py

SAR: the similarity within 1e-6 relative, the scores within 1e-5, the
top-k equal but at ties (``chip_smoke.py`` phase 31's rules); the solves
and LIME's coefficients within 1e-4 x max(1, |ref|); K9 counted exactly
under two concurrent fits; one card leaves ``trial_devices="auto"`` off
and the history at 2 trial threads equals the one at 1.
"""

import threading

import numpy as np
import pytest
import torch

from mmlspark_tpu_torch.automl import (
    DiscreteHyperParam, TrainClassifier, TuneHyperparameters,
)
from mmlspark_tpu_torch.automl import tune as PTune
from mmlspark_tpu_torch.core.dataframe import DataFrame
from mmlspark_tpu_torch.core.params import Param
from mmlspark_tpu_torch.core.stage import Estimator, Model, Transformer
from mmlspark_tpu_torch.explain import TabularLIME, weighted_ridge_fits
from mmlspark_tpu_torch.gbdt import Booster, BoosterParams
from mmlspark_tpu_torch.gbdt import cuda_hist as CH
from mmlspark_tpu_torch.gbdt.stages import GBDTClassifier
from mmlspark_tpu_torch.parallel.topology import in_single_device_scope
from mmlspark_tpu_torch.recommend import SAR

pytestmark = pytest.mark.gpu

COEF_TOL = 1e-4


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def scaled_err(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float((np.abs(got - ref) / np.maximum(1.0, np.abs(ref))).max())


def rel_err(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    fin = np.isfinite(ref)
    assert np.array_equal(np.isfinite(got), fin)
    d = np.abs(got[fin] - ref[fin])
    return float((d / np.maximum(np.abs(ref[fin]), 1e-30)).max()) \
        if d.any() else 0.0


def _events(n_users=400, n_items=300, n=12000, seed=0):
    rng = np.random.default_rng(seed)
    pop = 1.0 / np.arange(1, n_items + 1)
    return DataFrame({
        "user_idx": rng.integers(0, n_users, n),
        "item_idx": rng.choice(n_items, n, p=pop / pop.sum()),
        "rating": rng.integers(1, 6, n).astype(np.float64),
        "ts": rng.uniform(9.5e8, 1.05e9, n)})


@pytest.mark.parametrize("metric", ["jaccard", "lift", "cooccurrence"])
def test_sar_on_the_card_matches_the_cpu(dev, metric):
    df = _events()
    kw = dict(similarity_function=metric, support_threshold=2,
              timestamp_col="ts")
    card = SAR(**kw).fit(df)
    cpu = SAR(device="cpu", **kw).fit(df)
    np.testing.assert_array_equal(card.affinity, cpu.affinity)
    assert rel_err(card.similarity, cpu.similarity) <= 1e-6
    n = card.affinity.shape[0]
    ref = cpu._scores(np.arange(n), True)
    assert rel_err(card._scores(np.arange(n), True), ref) <= 1e-5
    got = card.recommend_for_all_users(10)["recommendations"]
    want = cpu.recommend_for_all_users(10)["recommendations"]
    for u, (g, w) in enumerate(zip(got, want)):
        for a, b in zip(g, w):
            if a != b:
                sa, sb = ref[u, a], ref[u, b]
                assert abs(sa - sb) <= 1e-5 * max(abs(sa), abs(sb))


def test_batched_solve_on_the_card_matches_the_cpu(dev):
    rng = np.random.default_rng(1)
    X = rng.standard_normal((8, 512, 14))
    y = X @ rng.standard_normal(14) + rng.normal(size=(8, 512))
    w = np.exp(-rng.random((8, 512)))
    got = weighted_ridge_fits(X, y, w, 1e-3)
    assert scaled_err(got, weighted_ridge_fits(X, y, w, 1e-3,
                                               device="cpu")) <= COEF_TOL


class _Linear(Transformer):
    input_col = Param("features", "in")
    beta = Param(None, "weights", complex=True)

    def transform(self, df):
        X = np.stack([np.asarray(v, np.float64) for v in df[self.input_col]])
        return df.with_column("scores", X @ np.asarray(self.beta))


def test_tabular_lime_on_the_card_matches_the_cpu(dev):
    rng = np.random.default_rng(2)
    X = rng.standard_normal((40, 5))
    df = DataFrame({"features": list(X)})
    lime = TabularLIME(model=_Linear(beta=np.arange(5.0)),
                       predict_col="scores", n_samples=128).fit(df)
    got = np.stack(list(lime.transform(df.head(10))["lime_weights"]))
    ref = np.stack(list(lime.copy(device="cpu").transform(
        df.head(10))["lime_weights"]))
    assert scaled_err(got, ref) <= COEF_TOL


def _binary(n=2000, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 6))
    y = (X[:, 0] - X[:, 1] + 0.5 * rng.logistic(size=n) > 0).astype(float)
    return X, y


def test_k9_counts_exactly_under_concurrent_fits(dev):
    X, y = _binary()
    params = [BoosterParams(objective="binary", num_iterations=6,
                            num_leaves=nl) for nl in (7, 15)]
    boosters = [None, None]

    def fit(i):
        boosters[i] = Booster.train(params[i], X, y)
    torch.cuda.synchronize()
    CH.reset_launch_counts()
    threads = [threading.Thread(target=fit, args=(i,)) for i in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    torch.cuda.synchronize()
    want = sum(len(b.trees) * b.params.num_leaves for b in boosters)
    assert CH.LAUNCHES["gbdt_histogram"] == want
    for b, p in zip(boosters, params):
        alone = Booster.train(p, X, y)
        np.testing.assert_array_equal(b.predict(X), alone.predict(X))


class _Recorder(Estimator):
    num_leaves = Param(0, "searched dummy", ptype=int)
    device = Param(None, "where it was placed", ptype=str)
    seen = []
    lock = threading.Lock()

    def fit(self, df):
        with self.lock:
            self.seen.append((self.device, in_single_device_scope()))
        return _Const()


class _Const(Model):
    def transform(self, df):
        return df.with_column("scores", np.zeros(df.num_rows)).with_column(
            "prediction", df["label"])


def test_one_card_leaves_auto_off(dev):
    """On a host with one card ``"auto"`` pins no trial: the trials run
    on the estimator's own device (the card), outside the scope, and
    the history at 2 trial threads equals the one at 1."""
    if torch.cuda.device_count() != 1:
        pytest.skip("needs exactly one CUDA card")
    assert PTune.trial_device_list() == ["cuda:0"]
    _Recorder.seen.clear()
    TuneHyperparameters(
        models=[_Recorder()],
        param_space={"num_leaves": DiscreteHyperParam([1, 2, 3])},
        search_mode="grid", evaluation_metric="mean_squared_error",
        num_folds=2, parallelism=3, label_col="label").fit(
        DataFrame({"x": np.arange(20.0), "label": np.r_[np.zeros(10),
                                                        np.ones(10)]}))
    assert set(_Recorder.seen) == {(None, False)}
    X, y = _binary(600)
    df = DataFrame({**{f"x{j}": X[:, j] for j in range(6)}, "label": y})

    def tune(threads):
        return TuneHyperparameters(
            models=[TrainClassifier(model=GBDTClassifier(min_data_in_leaf=5),
                                    label_col="label")],
            param_space={"num_leaves": DiscreteHyperParam([3, 7]),
                         "num_iterations": DiscreteHyperParam([4, 8])},
            search_mode="grid", evaluation_metric="AUC", num_folds=2,
            parallelism=threads).fit(df)
    a, b = tune(2), tune(1)
    assert a.best_model.fitted.booster.device.type == "cuda"
    assert a.best_params == b.best_params
    np.testing.assert_array_equal(a.get_history()["AUC"],
                                  b.get_history()["AUC"])
