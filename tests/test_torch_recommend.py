"""The port's recommendation modules (``mmlspark_tpu_torch/recommend/``)
against the JAX package's, on the CPU.

SAR runs its two products on the stage's device (``device="cpu"``
here), in f32 with TF32 off, as JAX computes them with x64 off. The
rules are ``chip_smoke.py`` phase 31's:

* similarity within 1e-6 relative (the co-occurrence counts are exact
  integers in f32; equal is expected);
* scores within 1e-5 relative (f32 products summed in another order);
* every user's top-k list equal, except where two scores lie within
  1e-5 relative of each other: a tie, which the host's ``np.argsort``
  (introsort, not stable, as in JAX) may order either way. Zero and
  equal scores are common; the data is not reseeded to avoid them.

Weights cross by the bridge: the port's ``SARModel(affinity=...,
similarity=...)`` takes the JAX model's arrays. The indexer, the ranking
metrics, ``per_user_split`` and the adapters are host code and equal.
The classes of ``tests/test_recommend.py`` are mirrored on the port.
"""

import numpy as np
import pytest
import torch

from mmlspark_tpu.core.dataframe import DataFrame as JDF
from mmlspark_tpu.recommend import indexer as JI
from mmlspark_tpu.recommend import ranking as JR
from mmlspark_tpu.recommend import sar as JS
from mmlspark_tpu_torch.core.dataframe import DataFrame
from mmlspark_tpu_torch.core.stage import PipelineStage
from mmlspark_tpu_torch.recommend import (
    SAR, SARModel, AdvancedRankingMetrics, RankingAdapter,
    RankingEvaluator, RankingTrainValidationSplit, RecommendationIndexer,
    per_user_split,
)
from mmlspark_tpu_torch.recommend import sar as PS

torch.set_num_threads(1)

SIM_RTOL = 1e-6
SCORE_RTOL = 1e-5
TIE_RTOL = 1e-5


def _events(n_users=12, n_items=20, seed=0, frame=DataFrame):
    """Synthetic events with block structure: users prefer their cluster."""
    rng = np.random.default_rng(seed)
    rows = {"user": [], "item": [], "rating": [], "ts": []}
    for u in range(n_users):
        cluster = u % 2
        for _ in range(8):
            if rng.random() < 0.8:
                item = rng.integers(0, n_items // 2) + cluster * (n_items // 2)
            else:
                item = rng.integers(0, n_items)
            rows["user"].append(f"u{u}")
            rows["item"].append(f"i{item}")
            rows["rating"].append(float(rng.integers(1, 6)))
            rows["ts"].append(1.5e9 + float(rng.integers(0, 90)) * 86400)
    return frame(rows)


@pytest.fixture(scope="module")
def indexed():
    df = _events()
    model = RecommendationIndexer(user_input_col="user",
                                  item_input_col="item").fit(df)
    return model, model.transform(df)


def rel_err(got, ref) -> float:
    """max |got - ref| / max(|ref|, tiny) over finite entries; the
    infinite entries (seen items) must sit at the same places."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    fin = np.isfinite(ref)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    np.testing.assert_array_equal(got[~fin], ref[~fin])
    if not fin.any():
        return 0.0
    d = np.abs(got[fin] - ref[fin])
    return float((d / np.maximum(np.abs(ref[fin]), 1e-30)).max()) \
        if d.any() else 0.0


def near(a, b, rtol=TIE_RTOL) -> bool:
    return a == b or abs(a - b) <= rtol * max(abs(a), abs(b))


def same_top_k(got, ref, ref_scores) -> int:
    """Per user, the port's top-k list against the reference's, position
    by position: a differing item must score, in the reference's own
    scores, within ``TIE_RTOL`` of the reference's item at that position.
    Returns the number of such ties."""
    ties = 0
    assert len(got) == len(ref)
    for u, (g, r) in enumerate(zip(got, ref)):
        g, r = list(map(int, g)), list(map(int, r))
        assert len(g) == len(r), u
        for a, b in zip(g, r):
            if a != b:
                assert near(ref_scores[u, a], ref_scores[u, b]), (
                    f"user {u}: item {a} (score {ref_scores[u, a]}) where "
                    f"the reference has {b} ({ref_scores[u, b]})")
                ties += 1
    return ties


# -- tests/test_recommend.py, on the port ------------------------------------

class TestIndexer:
    def test_roundtrip(self, indexed, tmp_path):
        model, df = indexed
        assert df["user_idx"].dtype == np.int32
        assert df["item_idx"].max() < model.num_items
        model.save(str(tmp_path / "idx"))
        loaded = PipelineStage.load(str(tmp_path / "idx"))
        assert loaded.user_levels == model.user_levels

    def test_inverse_items(self, indexed):
        model, df = indexed
        recs = DataFrame({"user_idx": [0], "recommendations": [[0, 1]]})
        out = model.inverse_transform_items(recs, "recommendations")
        assert out["recommendations"][0] == [model.item_levels[0],
                                             model.item_levels[1]]

    def test_unseen_id_raises(self, indexed):
        model, _ = indexed
        with pytest.raises(KeyError):
            model.transform(DataFrame({"user": ["nope"], "item": ["i0"]}))


def _sar(**kw):
    return SAR(device="cpu", **kw)


class TestSAR:
    def test_fit_and_recommend(self, indexed):
        _, df = indexed
        model = _sar(timestamp_col="ts", support_threshold=1).fit(df)
        assert model.similarity.shape[0] == model.similarity.shape[1]
        np.testing.assert_allclose(model.similarity, model.similarity.T,
                                   atol=1e-5)
        recs = model.recommend_for_all_users(5)
        assert recs.num_rows == model.affinity.shape[0]
        assert len(recs["recommendations"][0]) == 5
        for u in range(model.affinity.shape[0]):
            seen = set(np.flatnonzero(model.affinity[u] > 0))
            assert not seen & set(int(i) for i in recs["recommendations"][u])

    def test_cluster_structure_recovered(self, indexed):
        idx_model, df = indexed
        model = _sar(timestamp_col="ts", support_threshold=1).fit(df)
        recs = model.recommend_for_all_users(4)
        n_items = model.affinity.shape[1]
        user_of = {i: name for i, name in enumerate(idx_model.user_levels)}
        hits = total = 0
        for u, items in zip(recs["user_idx"], recs["recommendations"]):
            cluster = int(user_of[int(u)][1:]) % 2
            for i in items:
                total += 1
                item_no = int(idx_model.item_levels[int(i)][1:])
                hits += (item_no // (n_items // 2)) == cluster
        assert hits / total > 0.6

    def test_similarity_metrics_differ(self, indexed):
        _, df = indexed
        sims = {m: _sar(similarity_function=m,
                        support_threshold=1).fit(df).similarity
                for m in ("jaccard", "lift", "cooccurrence")}
        assert sims["jaccard"].max() <= 1.0 + 1e-6
        assert sims["cooccurrence"].max() > 1.0
        assert not np.allclose(sims["jaccard"], sims["lift"])

    def test_support_threshold_zeroes(self, indexed):
        _, df = indexed
        lo = _sar(support_threshold=1).fit(df).similarity
        hi = _sar(support_threshold=10).fit(df).similarity
        assert (hi > 0).sum() < (lo > 0).sum()

    def test_time_decay_downweights_old(self):
        df = DataFrame({
            "user_idx": [0, 1], "item_idx": [0, 0],
            "rating": [5.0, 5.0],
            "ts": [0.0, 365.0 * 86400],
        })
        model = _sar(timestamp_col="ts", time_decay_half_life=30.0,
                     support_threshold=0).fit(df)
        assert model.affinity[0, 0] < model.affinity[1, 0]
        no_decay = _sar(timestamp_col="ts", time_decay_enabled=False,
                        support_threshold=0).fit(df)
        assert no_decay.affinity[0, 0] == no_decay.affinity[1, 0]

    def test_transform_scores_pairs(self, indexed):
        _, df = indexed
        model = _sar(support_threshold=1).fit(df)
        scored = model.transform(df.head(10))
        assert "prediction" in scored
        assert np.isfinite(scored["prediction"]).all()

    def test_save_load(self, indexed, tmp_path):
        _, df = indexed
        model = _sar(support_threshold=1).fit(df)
        model.save(str(tmp_path / "sar"))
        loaded = PipelineStage.load(str(tmp_path / "sar"), device="cpu")
        assert loaded.device == "cpu"
        np.testing.assert_allclose(loaded.similarity, model.similarity)
        a = model.recommend_for_all_users(3)
        b = loaded.recommend_for_all_users(3)
        assert [list(map(int, r)) for r in a["recommendations"]] == \
               [list(map(int, r)) for r in b["recommendations"]]


class TestRankingMetrics:
    def test_perfect_ranking(self):
        m = AdvancedRankingMetrics([[1, 2, 3]], [[1, 2, 3]], k=3)
        assert m.ndcg_at_k() == pytest.approx(1.0)
        assert m.precision_at_k() == pytest.approx(1.0)
        assert m.recall_at_k() == pytest.approx(1.0)
        assert m.map_metric() == pytest.approx(1.0)
        assert m.mrr() == pytest.approx(1.0)

    def test_no_hits(self):
        m = AdvancedRankingMetrics([[4, 5, 6]], [[1, 2, 3]], k=3)
        assert m.ndcg_at_k() == 0.0
        assert m.mrr() == 0.0
        assert m.recommended_fraction() == 0.0

    def test_partial(self):
        m = AdvancedRankingMetrics([[9, 1]], [[1]], k=2)
        assert m.precision_at_k() == pytest.approx(0.5)
        assert m.mrr() == pytest.approx(0.5)
        assert m.ndcg_at_k() == pytest.approx(1.0 / np.log2(3))

    def test_evaluator_stage(self):
        df = DataFrame({"recommendations": [[1, 2], [3, 4]],
                        "labels": [[1], [9]]})
        ev = RankingEvaluator(k=2, metric_name="precisionAtk")
        assert ev.evaluate(df) == pytest.approx(0.25)
        allm = ev.evaluate_all(df)
        assert set(allm.columns) >= {"map", "ndcgAt", "precisionAtk"}


class TestRankingAdapter:
    def test_adapter_and_split(self, indexed, tmp_path):
        _, df = indexed
        train, valid = per_user_split(df, "user_idx", 0.75, seed=1)
        assert train.num_rows + valid.num_rows == df.num_rows
        assert set(np.unique(train["user_idx"])) == \
               set(np.unique(df["user_idx"]))
        model = RankingAdapter(recommender=_sar(support_threshold=1),
                               k=5).fit(train)
        out = model.transform(valid)
        assert "recommendations" in out and "labels" in out
        score = RankingEvaluator(k=5, metric_name="recallAtK").evaluate(out)
        assert 0.0 <= score <= 1.0
        model.save(str(tmp_path / "adapter"))
        back = PipelineStage.load(str(tmp_path / "adapter"), device="cpu")
        assert back.recommender_model.device == "cpu"
        assert [list(r) for r in back.transform(valid)["recommendations"]] \
            == [list(r) for r in out["recommendations"]]

    def test_train_validation_split_picks_best(self, indexed):
        _, df = indexed
        tvs = RankingTrainValidationSplit(
            estimator=_sar(support_threshold=1),
            evaluator=RankingEvaluator(k=5, metric_name="ndcgAt"),
            param_maps=[{"similarity_function": "jaccard"},
                        {"similarity_function": "cooccurrence"}],
            seed=3)
        model = tvs.fit(df)
        assert len(model.validation_metrics) == 2
        assert model.best_params["similarity_function"] in (
            "jaccard", "cooccurrence")
        recs = model.recommend_for_all_users(3)
        assert recs.num_rows > 0


class TestReviewRegressions:
    def test_tvs_best_params_roundtrip(self, indexed, tmp_path):
        _, df = indexed
        tvs = RankingTrainValidationSplit(
            estimator=_sar(support_threshold=1),
            evaluator=RankingEvaluator(k=3),
            param_maps=[{"similarity_function": "jaccard"}])
        model = tvs.fit(df)
        model.save(str(tmp_path / "tvs"))
        loaded = PipelineStage.load(str(tmp_path / "tvs"), device="cpu")
        assert loaded.best_params == {"similarity_function": "jaccard"}

    def test_remove_seen_truncates_instead_of_minus_inf(self):
        df = DataFrame({"user_idx": [0, 0, 0], "item_idx": [0, 1, 2],
                        "rating": [1.0, 1.0, 1.0]})
        model = _sar(support_threshold=0, num_items=4).fit(df)
        recs = model.recommend_for_all_users(3)
        r = recs["recommendations"][0]
        assert list(r) == [3]
        assert np.isfinite(recs["ratings"][0]).all()


# -- the card by default -----------------------------------------------------

@pytest.mark.skipif(torch.cuda.is_available(), reason="a host without CUDA")
def test_sar_runs_on_the_card_by_default(indexed):
    _, df = indexed
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SAR(support_threshold=1).fit(df)
    model = SARModel(affinity=np.ones((2, 3), np.float32),
                     similarity=np.eye(3, dtype=np.float32))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.recommend_for_all_users(2)


def test_device_is_not_persisted(indexed, tmp_path):
    _, df = indexed
    model = _sar(support_threshold=1).fit(df)
    assert model.device == "cpu"
    model.save(str(tmp_path / "m"))
    assert "device" not in (tmp_path / "m" / "metadata.json").read_text()
    assert PipelineStage.load(str(tmp_path / "m")).device is None


# -- parity with the JAX package on the same inputs --------------------------

@pytest.fixture(scope="module")
def both_indexed():
    jdf, pdf = _events(n_users=40, n_items=30, seed=4, frame=JDF), \
        _events(n_users=40, n_items=30, seed=4)
    jm = JI.RecommendationIndexer(user_input_col="user",
                                  item_input_col="item").fit(jdf)
    pm = RecommendationIndexer(user_input_col="user",
                               item_input_col="item").fit(pdf)
    return jm, pm, jm.transform(jdf), pm.transform(pdf)


def test_indexer_matches_jax(both_indexed):
    jm, pm, jdf, pdf = both_indexed
    assert pm.user_levels == jm.user_levels
    assert pm.item_levels == jm.item_levels
    for c in ("user_idx", "item_idx"):
        np.testing.assert_array_equal(pdf[c], jdf[c])
        assert pdf[c].dtype == jdf[c].dtype
    recs = {"user_idx": [0, 1], "recommendations": [[2, 0], [1]]}
    got = pm.inverse_transform_items(DataFrame(dict(recs)),
                                     "recommendations")
    ref = jm.inverse_transform_items(JDF(dict(recs)), "recommendations")
    assert list(got["recommendations"]) == list(ref["recommendations"])


SAR_CASES = [
    dict(similarity_function="jaccard", support_threshold=1),
    dict(similarity_function="jaccard", support_threshold=2,
         timestamp_col="ts", time_decay_half_life=30.0),
    dict(similarity_function="lift", support_threshold=1),
    dict(similarity_function="cooccurrence", support_threshold=3,
         timestamp_col="ts", time_decay_enabled=False),
    dict(similarity_function="jaccard", support_threshold=0,
         rating_col=None),
]


@pytest.mark.parametrize("kw", SAR_CASES,
                         ids=lambda kw: "-".join(f"{k}={v}"
                                                 for k, v in kw.items()))
def test_sar_matches_jax(both_indexed, kw):
    _, _, jdf, pdf = both_indexed
    j = JS.SAR(**kw).fit(jdf)
    p = SAR(device="cpu", **kw).fit(pdf)
    np.testing.assert_array_equal(p.affinity, j.affinity)
    assert rel_err(p.similarity, j.similarity) <= SIM_RTOL
    n = j.affinity.shape[0]
    for remove_seen in (True, False):
        ref = j._scores(np.arange(n), remove_seen)
        assert rel_err(p._scores(np.arange(n), remove_seen), ref) \
            <= SCORE_RTOL
    ref_scores = j._scores(np.arange(n), True)
    for k in (3, 10):
        got = p.recommend_for_all_users(k)
        want = j.recommend_for_all_users(k)
        same_top_k(got["recommendations"], want["recommendations"],
                   ref_scores)
        for g, w in zip(got["ratings"], want["ratings"]):
            assert rel_err(g, w) <= SCORE_RTOL
    got = p.transform(pdf.head(25))["prediction"]
    assert rel_err(got, j.transform(jdf.head(25))["prediction"]) \
        <= SCORE_RTOL


def test_sar_model_bridge_takes_jax_arrays(both_indexed):
    """A port ``SARModel`` over the JAX model's arrays recommends what the
    JAX model does (tie rule), on the CPU."""
    _, _, jdf, _ = both_indexed
    j = JS.SAR(support_threshold=1, timestamp_col="ts").fit(jdf)
    p = SARModel(affinity=j.affinity, similarity=j.similarity, device="cpu")
    n = j.affinity.shape[0]
    ref = j._scores(np.arange(n), True)
    assert rel_err(p._scores(np.arange(n), True), ref) <= SCORE_RTOL
    same_top_k(p.recommend_for_all_users(10)["recommendations"],
               j.recommend_for_all_users(10)["recommendations"], ref)


def test_similarity_products_in_f32(both_indexed):
    """The counts are f32 products of 0/1 (exact), the threshold an f32
    scalar, and JAX's x64-off numerics are kept: the result is f32."""
    _, _, _, pdf = both_indexed
    p = SAR(device="cpu", support_threshold=1).fit(pdf)
    assert p.similarity.dtype == np.float32
    b = (p.affinity > 0).astype(np.float64)
    np.testing.assert_array_equal(
        PS._build_similarity(torch.from_numpy(p.affinity), "cooccurrence",
                             0).numpy(), b.T @ b)


def test_ties_are_counted_not_hidden():
    """Equal scores (here every item unseen scores 0 for a user with no
    co-occurring items) are ties: the rule accepts any order among them
    and counts them."""
    scores = np.array([[0.0, 0.0, 0.5, 0.0]])
    assert same_top_k([[2, 3, 0]], [[2, 0, 1]], scores) == 2
    with pytest.raises(AssertionError):
        same_top_k([[0, 2]], [[2, 0]], scores)


@pytest.mark.parametrize("k", [1, 3, 5])
def test_ranking_metrics_match_jax(k):
    rng = np.random.default_rng(k)
    pred = [list(rng.choice(20, size=rng.integers(0, 8), replace=False))
            for _ in range(30)]
    truth = [list(rng.choice(20, size=rng.integers(1, 6), replace=False))
             for _ in range(30)]
    p = AdvancedRankingMetrics(pred, truth, k).all_metrics()
    j = JR.AdvancedRankingMetrics(pred, truth, k).all_metrics()
    assert p == j
    cols = {"recommendations": pred, "labels": truth}
    for name in ("ndcgAt", "mapk", "fcp", "diversityAtK"):
        assert RankingEvaluator(k=k, metric_name=name).evaluate(
            DataFrame(dict(cols))) == JR.RankingEvaluator(
            k=k, metric_name=name).evaluate(JDF(dict(cols)))


def test_split_and_adapter_match_jax(both_indexed):
    _, _, jdf, pdf = both_indexed
    jt, jv = JR.per_user_split(jdf, "user_idx", 0.75, seed=2)
    pt, pv = per_user_split(pdf, "user_idx", 0.75, seed=2)
    for a, b in ((pt, jt), (pv, jv)):
        for c in b.columns:
            assert list(a[c]) == list(b[c])
    ja = JR.RankingAdapter(recommender=JS.SAR(support_threshold=1),
                           k=5).fit(jt)
    pa = RankingAdapter(recommender=SAR(device="cpu", support_threshold=1),
                        k=5).fit(pt)
    jo, po = ja.transform(jv), pa.transform(pv)
    assert list(po["user_idx"]) == list(jo["user_idx"])
    assert [list(x) for x in po["labels"]] == [list(x) for x in jo["labels"]]
    n = ja.recommender_model.affinity.shape[0]
    ref = ja.recommender_model._scores(np.arange(n), True)
    by_user = list(jo["user_idx"])
    ties = same_top_k(po["recommendations"], jo["recommendations"],
                      ref[by_user])
    if ties == 0:
        for name in ("ndcgAt", "mapk", "recallAtK"):
            assert RankingEvaluator(k=5, metric_name=name).evaluate(po) == \
                JR.RankingEvaluator(k=5, metric_name=name).evaluate(jo)


def test_train_validation_split_matches_jax(both_indexed, tmp_path):
    _, _, jdf, pdf = both_indexed
    maps = [{"similarity_function": "jaccard"},
            {"similarity_function": "lift"},
            {"similarity_function": "cooccurrence"}]
    j = JR.RankingTrainValidationSplit(
        estimator=JS.SAR(support_threshold=1),
        evaluator=JR.RankingEvaluator(k=5), param_maps=maps, seed=1).fit(jdf)
    p = RankingTrainValidationSplit(
        estimator=SAR(device="cpu", support_threshold=1),
        evaluator=RankingEvaluator(k=5), param_maps=maps, seed=1).fit(pdf)
    np.testing.assert_allclose(p.validation_metrics, j.validation_metrics,
                               rtol=0, atol=1e-12)
    assert p.best_params == j.best_params
    p.save(str(tmp_path / "tvs"))
    back = PipelineStage.load(str(tmp_path / "tvs"), device="cpu")
    assert back.best_params == j.best_params
    assert list(back.validation_metrics) == list(p.validation_metrics)
