"""The near-tie rule of the port's split search (``gbdt/tree.py``
``TIE_ULPS``): among candidate splits whose gains lie within a leaf's
near-tie width of the best, the first in flat order wins (missing left
before missing right, then the lower feature, then the lower cut), the
split gate counts as a candidate, and of leaves within their widths of
the best the first splits. So splits that tie in exact arithmetic are
chosen alike whatever the summation order of the histograms (K9 on the
card, the plain scatter-add on the CPU, a reordering of the rows).
"""

import numpy as np
import pytest
import torch

import mmlspark_tpu_torch.gbdt as TG
from mmlspark_tpu_torch.gbdt import learners as PL
from mmlspark_tpu_torch.gbdt import tree as TT
from mmlspark_tpu_torch.parallel import topology as TP

torch.set_num_threads(1)


def _tied_hist():
    """(1, F 3, B 8, 3): features 0 and 2 are the same column, feature 1
    noise, so the best cut of feature 0 and of feature 2 tie exactly."""
    rng = np.random.default_rng(5)
    col = np.stack([rng.normal(size=8), rng.uniform(1, 2, size=8),
                    rng.integers(5, 20, size=8)], axis=-1)
    col[:, 0] -= col[:, 0].mean() * 0.5
    noise = col.copy()
    noise[:, 0] = rng.permutation(noise[:, 0]) * 0.1
    return torch.tensor(np.stack([col, noise, col])[None], dtype=torch.float32)


def _gains(hist):
    return TT._gains(*TT.fixed_hist(hist), None,
                     TT.GrowthParams(min_data_in_leaf=1))


def _eval(hist, params):
    """The leaves' packed split records from f32 histograms, through the
    fixed point split finding reads (``tree.fixed_hist``)."""
    return TT.eval_leaves(*TT.fixed_hist(hist), None, params)


@pytest.mark.parametrize("nudged", [0, 2])
def test_a_near_tie_goes_to_the_first_candidate(nudged):
    """Exactly tied candidates, then each nudged up by a few ulps of its
    gain terms in turn: the split is feature 0's both ways (the f32
    argmax took the nudged one)."""
    params = TT.GrowthParams(min_data_in_leaf=1)
    hist = _tied_hist()
    both, _, _, ps = _gains(hist)
    best = both[0].reshape(2, 3, -1).amax(dim=(0, 2))
    assert best[0] == best[2] and best[0] > best[1]
    packed = _eval(hist, params)[0][0]
    assert int(packed[TT.EV_FEATURE]) == 0

    # scale the nudged feature's gradients: its gains move by ~2 eps
    h = hist.clone()
    h[0, nudged, :, 0] *= 1 + 2 ** -22
    gains = _gains(h)[0][0].reshape(2, 3, -1).amax(dim=(0, 2))
    width = float(TT.tie_width(gains.max(), ps[0]))
    gap = float(gains[nudged] - gains[2 - nudged])
    assert 0 < gap < width                     # a near tie, not a tie
    assert int(torch.argmax(_gains(h)[0][0].reshape(-1))) // 8 % 3 \
        == nudged                              # what the argmax takes
    packed = _eval(h, params)[0][0]
    assert int(packed[TT.EV_FEATURE]) == 0
    assert float(packed[TT.EV_TIE_WIDTH]) == pytest.approx(width)


def test_a_gain_clearly_ahead_still_wins():
    """Outside the width the rule is the argmax."""
    params = TT.GrowthParams(min_data_in_leaf=1)
    h = _tied_hist()
    h[0, 2, :, 0] *= 1.01
    packed = _eval(h, params)[0][0]
    assert int(packed[TT.EV_FEATURE]) == 2


def test_the_vote_puts_the_lower_index_first_among_near_ties():
    """``vote_places``: the strict order outside the width, the lower
    index first within it."""
    per = torch.tensor([[1.0, 3.0, 3.0 + 2 ** -21, 2.0, 3.0 - 2 ** -21]])
    ps = torch.tensor([0.0])
    places = PL.vote_places(per, ps)
    assert places.tolist() == [[4, 0, 1, 3, 2]]
    per = torch.tensor([[1.0, 3.0, 3.5, 2.0]])
    assert PL.vote_places(per, ps).tolist() == [[3, 1, 0, 2]]


def _pairwise_places(per_feature, parent_score):
    """``vote_places`` by its definition, over every pair of features:
    g beats f when ``gain_g > gain_f + width``, or when g < f and
    ``gain_g >= gain_f - width``."""
    F = per_feature.shape[1]
    width = TT.tie_width(per_feature.amax(dim=1), parent_score)
    mine = per_feature[:, :, None]
    other = per_feature[:, None, :]
    w = width[:, None, None]
    idx = torch.arange(F)
    lower = idx[None, :] < idx[:, None]
    return ((other > mine + w) | ((other >= mine - w) & lower)).sum(dim=2)


@pytest.mark.parametrize("F", [1, 2, 3, 17, 64, 1000, 3000])
def test_the_vote_places_are_the_pairwise_count(F):
    """The sorted-block count equals the pairwise definition, on gains
    with exact ties, near ties a few ulps apart and -inf (features the
    sample leaves out), at widths up to a few thousand features."""
    g = torch.Generator().manual_seed(F)
    R = 4
    per = torch.randn(R, F, generator=g)
    steps = torch.randint(0, 20, (R, F), generator=g).float() / 4
    per = torch.where(torch.rand(R, F, generator=g) < 0.5, steps, per)
    per = per + torch.randint(-3, 4, (R, F), generator=g) \
        * 2.0 ** -22 * per.abs()
    per[torch.rand(R, F, generator=g) < 0.1] = -float("inf")
    ps = torch.rand(R, generator=g) * 3
    np.testing.assert_array_equal(PL.vote_places(per, ps),
                                  _pairwise_places(per, ps))


def test_a_wide_voting_fit_votes_as_the_pairwise_count(monkeypatch):
    """A voting fit at 2048 features on a hosted ``{"data": 4}`` mesh,
    features 1000-1007 copies of 0-7: the same trees with the
    sorted-block vote as with the pairwise one (which needs an (R, F, F)
    table a node)."""
    rng = np.random.default_rng(11)
    n, F = 256, 2048
    X = rng.normal(size=(n, F))
    X[:, 1000:1008] = X[:, :8]                 # features that tie exactly
    y = (X[:, 3] + X[:, 1500] - 0.5 * X[:, 7] > 0).astype(np.float64)
    kw = dict(objective="binary", num_iterations=2, num_leaves=4,
              min_data_in_leaf=5, max_bin=16, tree_learner="voting",
              top_k=6)
    mesh = TP.build_mesh(TP.MeshSpec.from_dict({"data": 4}), "cpu")
    fast = TG.Booster.train(TG.BoosterParams(**kw), X, y, sharding=mesh)
    monkeypatch.setattr(PL, "vote_places", _pairwise_places)
    slow = TG.Booster.train(TG.BoosterParams(**kw), X, y, sharding=mesh)
    assert fast.model_to_string() == slow.model_to_string()
    # the signal's columns, each copy's tie gone to the lower index
    assert {int(f) for trees in fast.trees for t in trees
            for f in t.feature[:t.n_nodes] if f >= 0} == {3, 7, 1500}


@pytest.fixture(scope="module")
def transfer_features():
    """``examples.multiclass_image_transfer``'s training embeddings at
    the JAX script's size, made on the CPU."""
    from mmlspark_tpu_torch.core.dataframe import DataFrame
    from mmlspark_tpu_torch.examples import _zoo
    from mmlspark_tpu_torch.examples.multiclass_image_transfer import \
        make_images
    from mmlspark_tpu_torch.models.featurizer import ImageFeaturizer
    images, y = make_images(0, 1200, "cpu")
    _, backbone = _zoo.load("digits32_resnet14")
    feats = ImageFeaturizer(model=backbone, input_col="image",
                            output_col="embedding", cut_output_layers=1,
                            device="cpu").transform(
        DataFrame({"image": images[:600]}))
    return np.stack(list(feats["embedding"])).astype(np.float64), y[:600]


def test_transfer_first_trees_do_not_hang_on_row_order(transfer_features):
    """The example's first iteration (one tree a class) fitted from its
    rows in two orders: the histograms sum in another order, and the
    trees are the same. Under the f32 argmax, class 0's tree took a
    split of gain ~2e-6 (a pure leaf's 0, rounded up) in one order and
    not in the other."""
    X, y = transfer_features
    kw = dict(objective="multiclass", num_class=10, num_iterations=1,
              num_leaves=7, min_data_in_leaf=5)
    perm = np.random.default_rng(5).permutation(len(y))
    a = TG.Booster.train(TG.BoosterParams(**kw), X, y, device="cpu")
    b = TG.Booster.train(TG.BoosterParams(**kw), X[perm], y[perm],
                         device="cpu")
    for ta, tb in zip(a.trees[0], b.trees[0]):
        assert ta.n_nodes == tb.n_nodes
        for f in ("feature", "threshold_bin", "missing_left", "left",
                  "right"):
            np.testing.assert_array_equal(getattr(tb, f), getattr(ta, f))
