"""Distributed GBDT of the port (``mmlspark_tpu_torch/gbdt/learners.py``,
the sharded ``Booster.train``) against the JAX package's, on the CPU.

* JAX's sharded fits on its 8 CPU devices (``batch_sharding(
  build_mesh())``, as ``tests/test_gbdt.py`` fits them) against the
  port's on a hosted ``{"data": 8}`` mesh, tree for tree under
  ``assert_same_fit``'s tie rule: the data, feature and voting learners;
  voting at ``2 * top_k >= F``, at a small ``top_k`` and on the
  high-index-signal data of ``test_voting_small_leaves_high_index_
  features`` (the shard-scaled vote gates).
* The vote's tie: duplicated columns give equal local gains, and the
  port's stable sort picks JAX's ``top_k`` members (the lowest indices).
* ``build_histogram_per_feature`` against JAX's.
* K9's calls per fit on a hosted ``{"data": 4}``: data iterations x
  leaves, feature iterations x (1 + splits), voting iterations x 4 x
  (1 + 2 x splits) (the formulas ``chip_smoke.py`` holds the card to).
* Two gloo processes, one rank each on ``{"data": 2}``: the data,
  feature and voting learners, a bagged fit, a GOSS fit and quantile
  fits (renewal over the gathered rows) equal to the hosted ``{"data":
  2}`` run within 1e-6, and the GBDT stage's mesh.

JAX's fits are made once per module. Sizes: at most 512 rows, 3
iterations, 7 leaves.
"""

import json
import os
import subprocess
import sys
from dataclasses import replace
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mmlspark_tpu.gbdt as JG
import mmlspark_tpu_torch.gbdt as TG
from mmlspark_tpu.gbdt import learners as JL
from mmlspark_tpu.gbdt.tree import GrowthParams as JGrowth
from mmlspark_tpu.parallel import batch_sharding
from mmlspark_tpu.parallel import build_mesh as jbuild_mesh
from mmlspark_tpu_torch.gbdt import cuda_hist as CH
from mmlspark_tpu_torch.gbdt import learners as PL
from mmlspark_tpu_torch.gbdt import tree as TT
from mmlspark_tpu_torch.parallel import topology as TP
from test_torch_gbdt import _breast_cancer, assert_same_fit

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
GLOO_TOL = 1e-6


def hosted(d):
    return TP.build_mesh(TP.MeshSpec.from_dict({"data": d}), "cpu")


def _bc():
    Xtr, ytr, Xte, _ = _breast_cancer()
    return Xtr[:450], ytr[:450], Xte


def _high_index():
    """``test_voting_small_leaves_high_index_features``'s data at 512
    rows: every signal column sits after 24 noise columns."""
    rng = np.random.default_rng(42)
    n = 512
    noise = rng.normal(size=(n, 24))
    signal = rng.normal(size=(n, 4))
    y = (signal.sum(axis=1) > 0).astype(int)
    X = np.concatenate([noise, signal], axis=1)
    return X, y, X


BASE = dict(objective="binary", num_iterations=3, num_leaves=7,
            min_data_in_leaf=5)
CONFIGS = {
    "data": (_bc, dict(BASE, tree_learner="data")),
    "feature": (_bc, dict(BASE, tree_learner="feature")),
    # 2 * top_k >= F (30): every feature voted
    "voting_all": (_bc, dict(BASE, tree_learner="voting", top_k=15)),
    "voting_small": (_bc, dict(BASE, tree_learner="voting", top_k=3)),
    "voting_high_index": (_high_index, dict(
        BASE, min_data_in_leaf=20, tree_learner="voting", top_k=3)),
}


class _VoteRecorder:
    """Wraps ``learners.vote_places`` during a fit: whether each vote
    (one a node, in the host grower's order: a tree's root, then each
    body's left and right child) was decided within a near-tie, i.e. on
    some rank a feature left out of the ``top_k`` has a best gain within
    the rank's near-tie width of the weakest member's (JAX's ``top_k``
    then takes whichever its f32 rounding puts first)."""

    def __init__(self, k):
        self.k, self.tied = k, []

    def __call__(self, per_feature, parent_score):
        places = VOTE_PLACES(per_feature, parent_score)
        width = TT.tie_width(per_feature.amax(dim=1), parent_score)
        voted = torch.sort(places, dim=1, stable=True).indices
        gains = torch.gather(per_feature, 1, voted)
        weakest = gains[:, self.k - 1]
        near = gains[:, self.k:] >= (weakest - width)[:, None]
        self.tied.append(bool((near & torch.isfinite(
            gains[:, self.k:])).any()))
        return places

    def nodes(self, booster):
        """(iteration, output, node) of each vote decided within a tie."""
        out, i = set(), 0
        for it, trees in enumerate(booster.trees):
            for k, tree in enumerate(trees):
                for node in range(tree.n_nodes):
                    if self.tied[i + node]:
                        out.add((it, k, node))
                i += tree.n_nodes
        assert i == len(self.tied)
        return out


VOTE_PLACES = PL.vote_places


@pytest.fixture(scope="module")
def fits():
    """config -> (JAX's 8-device fit, the port's hosted {"data": 8} fit,
    X, X_eval, the port's votes decided within a near-tie), made once."""
    jsharding = batch_sharding(jbuild_mesh())
    assert jsharding.mesh.shape["data"] == 8
    mesh = hosted(8)
    cache = {}

    def get(name):
        if name not in cache:
            data, kw = CONFIGS[name]
            X, y, X_eval = data()
            jb = JG.Booster.train(JG.BoosterParams(**kw), X, y,
                                  sharding=jsharding)
            rec = _VoteRecorder(kw.get("top_k", 0))
            PL.vote_places = rec
            try:
                pb = TG.Booster.train(TG.BoosterParams(**kw), X, y,
                                      sharding=mesh)
            finally:
                PL.vote_places = VOTE_PLACES
            ties = rec.nodes(pb) if rec.tied else set()
            cache[name] = (jb, pb, X, X_eval, ties)
        return cache[name]
    return get


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_hosted_fit_equals_jax_sharded_fit(fits, name):
    """Split for split up to the first tie: a split's own near-tie or,
    under voting, a leaf whose vote was decided within one (JAX's
    ``top_k`` takes the f32 order there, the port the lower index;
    ``voting_small``'s leaf 5 of the first tree is one: five of its eight
    ranks hold pure rows, every local gain within an ulp of 0)."""
    jb, pb, X, X_eval, ties = fits(name)
    compared, _ = assert_same_fit(jb, pb, X, X_eval, vote_ties=ties)
    assert compared >= 1
    assert pb.device == torch.device("cpu")
    if name == "voting_small":
        assert (0, 0, 5) in ties


def test_high_index_signal_wins_the_vote(fits):
    """The shard-scaled gates let small leaves vote for the signal
    columns: most splits land on them, as in JAX's fit."""
    jb, pb, X, _, _ = fits("voting_high_index")
    imp = pb.feature_importances("split")
    assert imp[24:].sum() > imp[:24].sum()
    np.testing.assert_array_equal(imp, jb.feature_importances("split"))


def test_voting_with_every_feature_equals_the_data_learner(fits):
    """At ``2 * top_k >= F`` every feature's histogram is summed, so the
    voting fit is the data learner's (built directly, not subtracted)."""
    _, vote, X, X_eval, _ = fits("voting_all")
    _, data, _, _, _ = fits("data")
    compared, _ = assert_same_fit(_as_jax(data), vote, X, X_eval)
    assert compared >= 1


def test_sharding_takes_a_mesh_with_a_data_axis():
    X, y, X_eval = _bc()
    p = TG.BoosterParams(**dict(BASE, tree_learner="voting", top_k=4))
    mesh = hosted(4)
    a = TG.Booster.train(p, X, y, sharding=mesh)
    b = TG.Booster.train(p, X, y, sharding=mesh, device="cpu")
    np.testing.assert_array_equal(a.predict(X_eval), b.predict(X_eval))
    assert a.device == mesh.device
    with pytest.raises(ValueError, match="data"):
        TG.Booster.train(p, X, y, sharding=TP.build_mesh(
            TP.MeshSpec.from_dict({"seq": 2}), "cpu"))
    with pytest.raises(TypeError, match="Mesh"):
        TG.Booster.train(p, X, y, sharding=object())


def _as_jax(booster):
    """A port booster as the JAX package's, for ``assert_same_fit``."""
    return JG.Booster.from_string(booster.model_to_string())


@pytest.mark.parametrize("impl", TG.booster.HISTOGRAM_IMPLS)
def test_every_histogram_impl_takes_the_same_path_sharded(impl, recwarn):
    """Every ``histogram_impl`` runs K9 (its plain version here) in a
    sharded fit, with no warning: JAX warns and takes XLA for a sharded
    ``pallas`` fit."""
    X, y, X_eval = _bc()
    p = TG.BoosterParams(**dict(BASE, tree_learner="voting", top_k=4))
    ref = TG.Booster.train(p, X, y, sharding=hosted(4))
    got = TG.Booster.train(replace(p, histogram_impl=impl), X, y,
                           sharding=hosted(4))
    assert [t.to_json() for it in got.trees for t in it] == \
        [t.to_json() for it in ref.trees for t in it]
    assert not [w for w in recwarn if "histogram" in str(w.message)]


@pytest.mark.parametrize("learner,kw", [
    ("data", dict(boosting_type="goss", top_rate=0.3, other_rate=0.2)),
    ("feature", dict(feature_fraction=0.5, seed=4)),
], ids=["data_goss", "feature_fraction"])
def test_per_iteration_loop_samples_the_real_rows(learner, kw, capsys):
    """The per-iteration loop (``log_every``) of a sharded fit draws
    JAX's numpy stream over the real rows and features: the fit with
    padded rows (453 on 8 ranks) or padded features (30 on 8 ranks)
    grows the single-device per-iteration fit's trees."""
    X, y, X_eval = _bc()
    X, y = X[:453], y[:453]
    p = TG.BoosterParams(**dict(BASE, tree_learner=learner, **kw))
    single = TG.Booster.train(p, X, y, log_every=1, device="cpu")
    sharded = TG.Booster.train(p, X, y, log_every=1, sharding=hosted(8))
    compared, _ = assert_same_fit(_as_jax(single), sharded, X, X_eval)
    assert compared == p.num_iterations
    assert "[gbdt] iter 3" in capsys.readouterr().out


def test_stage_shards_only_in_a_world_of_several_processes():
    stage = TG.GBDTClassifier(parallelism="voting_parallel", device="cpu")
    assert stage._sharding() is None
    assert TG.GBDTClassifier(parallelism="serial")._sharding() is None


# -- the vote -----------------------------------------------------------------

def test_vote_tie_picks_jaxs_members():
    """Three identical columns (8, 9, 10) tie on every rank's gain; with
    ``top_k`` 2 JAX's ``lax.top_k`` votes for the lower indices 8 and 9,
    and so must the port: ``torch.topk`` promises no order among ties
    (on the CPU it returns 8 and 10 here), and the other member would
    change the summed histograms and so the trees."""
    rng = np.random.default_rng(3)
    n, B, F = 512, 16, 12
    col = rng.integers(1, B, size=n)
    bins = rng.integers(1, B, size=(n, F)).astype(np.int32)
    bins[:, 8:11] = col[:, None]
    grad = (col / B - 0.5 + 0.1 * rng.normal(size=n)).astype(np.float32)
    hess = np.ones(n, np.float32)
    in_leaf = rng.random(n) < 0.9
    growth = dict(num_leaves=7, min_data_in_leaf=5)
    jfn = JL.make_voting_hist(jbuild_mesh(), JGrowth(**growth),
                              jnp.zeros(F, bool), F, B, 2)
    want = np.asarray(jfn(jnp.asarray(bins), jnp.asarray(grad),
                          jnp.asarray(hess), jnp.asarray(in_leaf),
                          jnp.ones(F, bool)))
    axis = PL.DataAxis(hosted(8))
    vote = PL.VotingHist(axis, TT.GrowthParams(**growth), None, F, B, 2)
    bins_t = CH.prepare_bins_t(torch.from_numpy(bins), B)
    args = (axis.row_blocks(bins_t), torch.from_numpy(grad),
            torch.from_numpy(hess), torch.from_numpy(in_leaf))
    scale = PL.fit_scale(args[1], args[2], args[3], n, axis)
    got = CH.fixed_to_float(vote(*args, scale), scale).numpy()
    kept = np.flatnonzero(np.abs(want).sum(axis=(1, 2)))
    # the tied winners 8 and 9, then the lowest unvoted indices
    assert kept.tolist() == [0, 1, 8, 9]
    np.testing.assert_array_equal(
        np.flatnonzero(np.abs(got).sum(axis=(1, 2))), kept)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)
    # every rank's local best is a tie between columns 8, 9 and 10
    gains = TT._gains(vote.local(*args, scale), scale, None,
                      vote.local_growth)[0]
    per = torch.amax(gains, dim=(1, 3))
    assert torch.equal(per[:, 8], per[:, 9])
    assert torch.equal(per[:, 8], per[:, 10])
    assert bool((per[:, 8] > per[:, :8].amax(dim=1)).all())


def test_build_histogram_per_feature_matches_jax():
    rng = np.random.default_rng(7)
    n, F, B = 777, 11, 37
    bins = rng.integers(0, B, size=(n, F)).astype(np.int32)
    grad = rng.normal(size=n).astype(np.float32)
    hess = rng.uniform(0.1, 1, size=n).astype(np.float32)
    mask = rng.uniform(size=n) < 0.7
    want = np.asarray(JL.build_histogram_per_feature(
        jnp.asarray(bins), jnp.asarray(grad), jnp.asarray(hess),
        jnp.asarray(mask), B))
    got = PL.build_histogram_per_feature(
        torch.from_numpy(bins), torch.from_numpy(grad),
        torch.from_numpy(hess), torch.from_numpy(mask), B).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)


# -- K9's calls per fit -------------------------------------------------------

def _splits(booster):
    return sum((t.n_nodes - 1) // 2 for it in booster.trees for t in it)


@pytest.mark.parametrize("learner", ["data", "feature", "voting"])
def test_histogram_calls_per_fit(monkeypatch, learner):
    """The wrapper's calls a hosted {"data": 4} fit makes: K9's launches
    on the card, where each call launches once."""
    calls = []
    real = CH.build_histogram_cuda

    def counting(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    for mod in (TT, PL):
        monkeypatch.setattr(mod, "build_histogram_cuda", counting)
    X, y, _ = _bc()
    p = TG.BoosterParams(**dict(BASE, tree_learner=learner, top_k=3))
    b = TG.Booster.train(p, X, y, sharding=hosted(4))
    it, splits = p.num_iterations, _splits(b)
    want = {"data": it * p.num_leaves, "feature": it + splits,
            "voting": 4 * (it + 2 * splits)}[learner]
    assert len(calls) == want


# -- one rank per process -----------------------------------------------------

GLOO = {
    "data": dict(BASE, tree_learner="data"),
    "feature": dict(BASE, tree_learner="feature"),
    "voting": dict(BASE, tree_learner="voting", top_k=3),
    "data_bagged": dict(BASE, bagging_fraction=0.7, bagging_freq=1,
                        seed=2),
    "data_goss": dict(BASE, boosting_type="goss", top_rate=0.3,
                      other_rate=0.2),
    "data_quantile": dict(BASE, objective="quantile", alpha=0.7),
    "voting_quantile": dict(BASE, objective="quantile", alpha=0.7,
                            tree_learner="voting", top_k=3),
}


def _gloo_data(name):
    """453 rows (the data axis pads them) of the breast-cancer split; a
    continuous target for the quantile fits."""
    X, y, X_eval = _bc()
    X, y = X[:453], y[:453]
    if "quantile" in name:
        y = X[:, 0] + 3.0 * y
    return X, y.astype(np.float64), X_eval


_WORKER = r"""
import json, sys
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
rank, init, data, out = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
dist.init_process_group("gloo", init_method=init, world_size=2, rank=rank)
import mmlspark_tpu_torch.gbdt as TG
from mmlspark_tpu_torch.parallel import topology as TP
mesh = TP.build_mesh(TP.MeshSpec.from_dict({"data": 2}), "cpu")
assert not mesh.hosted
arrays = np.load(data)
models = {}
for name, kw in json.loads(sys.argv[5]).items():
    models[name] = TG.Booster.train(
        TG.BoosterParams(**kw), arrays[name + ".X"], arrays[name + ".y"],
        sharding=mesh).model_to_string()
stage = TG.GBDTClassifier(parallelism="voting_parallel", device="cpu")
sm = stage._sharding()
models["stage_mesh"] = [dict(sm.shape), sm.hosted, str(sm.device)]
with open(out, "w") as f:
    json.dump(models, f)
dist.destroy_process_group()
"""


def test_gloo_ranks_equal_the_hosted_fit(tmp_path):
    init = f"file://{tmp_path / 'rdv'}"
    data = str(tmp_path / "data.npz")
    arrays = {}
    for name in GLOO:
        X, y, _ = _gloo_data(name)
        arrays[name + ".X"], arrays[name + ".y"] = X, y
    np.savez(data, **arrays)
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, str(r), init, data,
         str(tmp_path / f"r{r}.json"), json.dumps(GLOO)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, cwd=str(tmp_path)) for r in range(2)]
    try:
        outs = [p.communicate(timeout=120)[0] for p in procs]
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("the gloo ranks did not finish within 120 s")
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out[-3000:]}"
    got = [json.load(open(tmp_path / f"r{r}.json")) for r in range(2)]
    assert got[0] == got[1]                   # every rank, the same model
    assert got[0]["stage_mesh"] == [{"data": 2}, False, "cpu"]
    mesh = hosted(2)
    for name, kw in GLOO.items():
        X, y, X_eval = _gloo_data(name)
        want = TG.Booster.train(TG.BoosterParams(**kw), X, y, sharding=mesh)
        rank = TG.Booster.from_string(got[0][name], device="cpu")
        assert len(rank.trees) == len(want.trees), name
        for ta, tb in zip(rank.trees, want.trees):
            for a, b in zip(ta, tb):
                for f in ("feature", "threshold_bin", "left", "right",
                          "missing_left", "cat_mask"):
                    np.testing.assert_array_equal(
                        getattr(a, f), getattr(b, f), err_msg=name)
                np.testing.assert_allclose(a.value, b.value, rtol=GLOO_TOL,
                                           atol=GLOO_TOL, err_msg=name)
        np.testing.assert_allclose(rank.predict(X_eval), want.predict(X_eval),
                                   rtol=GLOO_TOL, atol=GLOO_TOL,
                                   err_msg=name)
