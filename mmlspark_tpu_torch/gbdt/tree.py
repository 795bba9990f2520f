"""Histograms, split finding, and leaf-wise tree growth.

The port of ``mmlspark_tpu/gbdt/tree.py`` (LightGBM's serial tree
learner, and the growers its distributed learners run in
:mod:`.learners`): histograms are
K9 (:mod:`.cuda_hist`) on the card and its plain scatter-add on the CPU;
split finding is a vectorized cumsum scan over every (feature, bin) at
once, with L1/L2 regularization, min-child constraints, missing-bin
default directions and G/H-sorted categorical subset splits; growth is
leaf-wise (split the globally best leaf until ``num_leaves``) with the
parent-minus-child histogram subtraction trick.

The reference grows a tree as one ``lax.while_loop`` with its stop test
on the device. Here :func:`grow_tree_device` runs the body a fixed
``num_leaves - 1`` times with every state update predicated on
``active = (n_leaves < L) & isfinite(max(fr_gain))``: an inactive body
changes nothing, so the trees equal the while loop's, and no body reads
a value back to the host. A tree therefore launches K9 exactly
``num_leaves`` times (the root and one child per body) and never
synchronizes; the cost is the histograms of the bodies after an early
stop.

Everything that decides a split or a leaf value is exact or computed
alike on every device, so a fit on the card equals the fit on the CPU
bit for bit, whatever the order of the rows: the gradients go through
the objectives' device-identical ``exp``; histograms are int64 fixed
point (:func:`.cuda_hist.fixed_scale`, one scale an iteration and
output), integer sums in K9 and in its plain version, and stay integers
through the parent-minus-child subtraction and the cut sums of
:func:`_gains`, which reach f32 once (:func:`.cuda_hist.fixed_to_float`);
the leaf renewal's cumulative weights are fixed point too; sorts are
stable, and the rest is elementwise IEEE arithmetic and order-free
reductions (max, min).

The feature and voting learners keep the reference's per-leaf host
loop (:meth:`TreeGrower._grow_host`): one device pass and one host read
a split, K9 once for the root and once for each split's left child
(both children under voting, whose histograms are exact only on the
voted features).

Trees are stored as flat arrays (feature/threshold/children/value per
node) in the reference's JSON form. Bins live on the device in K9's
(F, n) layout (:func:`.cuda_hist.prepare_bins_t`), which the grower also
reads to route rows.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from mmlspark_tpu_torch.gbdt.binning import MISSING_BIN
from mmlspark_tpu_torch.gbdt.cuda_hist import (
    build_histogram_cuda, fixed_grid, fixed_scale, fixed_to_float,
    prepare_bins_t, to_fixed,
)

_INF = float("inf")

#: The near-tie rule's width, in f32 ulps of the gain's own terms. A
#: gain is ``score(left) + score(right) - score(parent)``, three f32
#: terms of size up to ``|gain| + 2 score(parent)``. Splits that tie in
#: exact arithmetic (cuts with empty bins between them, features that
#: part the rows alike, a pure leaf's zero gain) come out a few such ulps
#: apart under f32 rounding. The port's own histograms are exact, so its
#: fits on the card and on the CPU pick alike without the rule; the JAX
#: package's are f32 sums in XLA's order, and the port's gains part from
#: its by a few ulps (5.4e-7 of the root gain, 4.5 ulps, on the
#: multiclass transfer example's first tree). Among candidates within
#: this width of the best, the first wins, as LightGBM's scan keeps the
#: first of equal gains, so both packages pick the same split at such a
#: tie. 8 ulps covers those with room; a wider width takes the port off
#: JAX's splits where JAX's gains really differ by a few tens of ulps
#: (the LIME example's fit). 8 ulps of a root whose parent score is ~0 is
#: 9.5e-7 of its gain, below the 1e-5 of the root gain that the tests
#: against JAX call a tie.
TIE_ULPS = 8
#: :data:`TIE_ULPS` as a fraction of the terms' size
TIE_WIDTH = TIE_ULPS * float(np.finfo(np.float32).eps)


def _at(x, i):
    """``x[i]`` for a 0-d index tensor ``i`` without a device sync
    (indexing with a 0-d tensor converts it to a Python int)."""
    return torch.index_select(x, 0, i.reshape(1))[0]


@dataclasses.dataclass(frozen=True)
class GrowthParams:
    num_leaves: int = 31
    max_depth: int = -1  # -1 = unlimited (bounded by num_leaves)
    min_data_in_leaf: int = 20
    min_sum_hessian_in_leaf: float = 1e-3
    lambda_l1: float = 0.0
    lambda_l2: float = 0.0
    min_gain_to_split: float = 0.0


# ---------------------------------------------------------------------------
# Histograms
# ---------------------------------------------------------------------------

def build_histogram(bins, grad, hess, in_leaf, n_features: int, n_bins: int):
    """Per-(feature, bin) sums of grad/hess/count for rows where ``in_leaf``.

    bins: (n, F) int32 (the reference's layout); grad/hess: (n,) f32;
    in_leaf: (n,) bool. Returns (F, B, 3) float32: [sum_grad, sum_hess,
    count] — K9 for CUDA tensors, its plain version for CPU ones, the
    exact fixed-point sums (on the grid of these gradients) rounded once
    to f32. The grower keeps the transposed bins and calls K9 directly,
    in fixed point.
    """
    scale = fixed_scale(grad, hess, grad.shape[0])
    return fixed_to_float(build_histogram_cuda(
        prepare_bins_t(bins), grad, hess, in_leaf, n_features, n_bins,
        scale), scale)


def fixed_hist(hist):
    """An f32 (..., 3) histogram (the reference's form) -> (int64
    histogram, (3,) f64 scale) in the fixed point that split finding
    reads: each channel on the grid of its largest ``|v|`` with room for
    a sum over the bins (:func:`.cuda_hist.fixed_scale`), counts as
    integers. The public split helpers take f32 histograms through it."""
    B = hist.shape[-2]
    scale = fixed_scale(hist[..., 0], hist[..., 1], B)
    return torch.stack([to_fixed(hist[..., 0], scale[0]),
                        to_fixed(hist[..., 1], scale[1]),
                        torch.round(hist[..., 2]).to(torch.int64)],
                       dim=-1), scale


# ---------------------------------------------------------------------------
# Split finding
# ---------------------------------------------------------------------------

def _regularized(g, h, l1, l2):
    """``(sign(g) * max(|g| - l1, 0), h + l2 + 1e-12)``, the reference's
    terms; without L1 the first is ``g`` itself and without L2 the
    second is one add (the same values, fewer launches)."""
    g_reg = g if l1 == 0 else \
        torch.sign(g) * torch.clamp(torch.abs(g) - l1, min=0.0)
    return g_reg, (h + 1e-12 if l2 == 0 else h + l2 + 1e-12)


def _leaf_value(g, h, l1, l2):
    g_reg, denom = _regularized(g, h, l1, l2)
    return -g_reg / denom


def _split_score(g, h, l1, l2):
    g_reg, denom = _regularized(g, h, l1, l2)
    return torch.square(g_reg) / denom


def _gains(hist, scale, is_categorical, params: GrowthParams):
    """Every candidate split of M leaves at once: hist (M, F, B, 3) int64
    in the fixed point ``scale`` (K9's) -> (gains (M, 2, F, B), order
    (M, F, B), totals (M, 3) of the row-count-richest feature, the
    parents' scores (M,)). Slot 0 of the second axis sends the missing
    bin left, slot 1 sends it right. ``is_categorical`` None: every
    feature numeric (no sort).

    The cut sums (the cumulative sums over the bins, and the right sides
    as totals less them) are int64, exact on every device, and reach f32
    in one conversion (:func:`.cuda_hist.fixed_to_float`); the scores
    are f32 from there, as the reference's. The left and right sums
    reach f32 together (a fit's seconds follow its launches)."""
    M, F, B, _ = hist.shape
    l1, l2 = params.lambda_l1, params.lambda_l2
    dev = hist.device

    # numeric: bin order; categorical: non-empty bins sorted by G/H
    bin_ids = torch.arange(B, device=dev)
    # the last cut position leaves the right side empty
    invalid = bin_ids == B - 1
    if is_categorical is None:
        order, hist_ord = bin_ids.expand(M, F, B), hist
    else:
        hf = fixed_to_float(hist, scale)
        ratio = hf[..., 0] / (hf[..., 1] + 1e-12)
        cat_key = torch.where(hist[..., 2] < 0.5, _INF, ratio)  # empty last
        cat_order = torch.argsort(cat_key, dim=-1, stable=True)
        order = torch.where(is_categorical[:, None], cat_order, bin_ids)
        hist_ord = torch.gather(hist, 2,
                                order[..., None].expand(M, F, B, 3))
        # categorical splits use only the left variant (missing treated
        # as a level)
        variant = torch.arange(2, device=dev)[:, None, None]
        invalid = ((variant == 1) & is_categorical[:, None]) | invalid

    # cut after each ordered bin; the second variant leaves the first
    # (missing) bin out of the left sums, routing it right
    first = (bin_ids == 0)[:, None]
    both = torch.stack([hist_ord, torch.where(first, 0, hist_ord)], dim=1)
    sums = torch.empty((2, M, 2, F, B, 3), dtype=torch.int64, device=dev)
    torch.cumsum(both, dim=3, out=sums[0])              # left
    torch.sub(sums[0, :, 0, None, :, -1:], sums[0], out=sums[1])  # right
    left, right = fixed_to_float(sums, scale)
    tot = left[:, 0, :, -1]                              # (M, F, 3)
    # parent stats are per-leaf constants; take the row-count-richest
    # feature as the source of truth, as the reference does
    src = torch.argmax(tot[..., 2], dim=1)
    ptot = torch.gather(tot, 1, src[:, None, None].expand(M, 1, 3))[:, 0]
    parent_score = _split_score(ptot[:, 0], ptot[:, 1], l1, l2)
    gain = (_split_score(left[..., 0], left[..., 1], l1, l2)
            + _split_score(right[..., 0], right[..., 1], l1, l2)
            - parent_score[:, None, None, None])
    ok = ((left[..., 2] >= params.min_data_in_leaf)
          & (right[..., 2] >= params.min_data_in_leaf)
          & (left[..., 1] >= params.min_sum_hessian_in_leaf)
          & (right[..., 1] >= params.min_sum_hessian_in_leaf))
    gain = torch.where(ok & ~invalid, gain, -_INF)
    return gain, order, ptot, parent_score


def tie_width(best_gain, parent_score):
    """A leaf's near-tie width: :data:`TIE_WIDTH` of the size of its gain
    terms, ``gain + 2 score(parent)``. A leaf without a valid split (best
    gain -inf) or with a negative best counts its parent's score alone,
    so its width stays finite; such a leaf never passes the split gate,
    so its own width only orders candidates that are never taken."""
    return torch.add(torch.clamp(best_gain, min=0.0), parent_score,
                     alpha=2.0) * TIE_WIDTH


def first_near_best(x, best, width):
    """The index of the first entry of ``x`` (..., n) within ``width`` of
    ``best`` (its max over the last dim; both broadcast against ``x``):
    the near-tie rule over candidates in their flat order."""
    near = x >= best - width
    # max's index is the first of equal values, on the CPU and on CUDA
    return torch.max(near, dim=-1).indices


def split_gain_matrix(hist, is_categorical, params: GrowthParams):
    """All candidate-split gains of one leaf: ((2, F, B) gains, (F, B) order).

    Slot 0 of the first axis sends the missing bin left, slot 1 sends it
    right. Numeric features cut in bin order; categorical ones in the
    G/H order of their non-empty bins (stable sort, empty bins last).
    ``hist`` (F, B, 3) f32, taken into fixed point (:func:`fixed_hist`).
    """
    fixed, scale = fixed_hist(hist)
    gain, order = _gains(fixed[None], scale, is_categorical, params)[:2]
    return gain[0], order[0]


def find_best_split(hist, is_categorical, params: GrowthParams,
                    feat_mask=None):
    """Best split over all (feature, bin) cut points of one leaf, as a
    host dict (a convenience view over :func:`eval_leaf`)."""
    packed_dev, order = eval_leaf(hist, is_categorical, params, feat_mask)
    packed = packed_dev.cpu().numpy()
    feat = int(packed[EV_FEATURE])
    return {
        "gain": float(packed[EV_GAIN]),
        "feature": feat,
        "cut_pos": int(packed[EV_CUT_POS]),
        "missing_left": bool(packed[EV_MISSING_LEFT]),
        "order": order[feat],
        "threshold_bin": int(packed[EV_THRESHOLD_BIN]),
        "leaf_value": float(packed[EV_VALUE]),
        "stats": (float(packed[EV_G]), float(packed[EV_H]),
                  float(packed[EV_COUNT])),
    }


# packed layout of eval_leaf's scalar vector; EV_TIE_WIDTH is the leaf's
# near-tie width (:func:`tie_width`), which the leaf pick and the split
# gate read
EV_GAIN, EV_FEATURE, EV_CUT_POS, EV_MISSING_LEFT, EV_THRESHOLD_BIN, \
    EV_G, EV_H, EV_COUNT, EV_VALUE, EV_TIE_WIDTH = range(10)


def eval_leaves(hist, scale, is_categorical, params: GrowthParams,
                feat_mask=None):
    """:func:`eval_leaf` of M leaves at once, on the grower's histograms:
    hist (M, F, B, 3) int64 in the fixed point ``scale`` (:func:`_gains`)
    -> (packed (M, 10) f32, order (M, F, B) int64), with the same
    arithmetic per leaf (the grower evaluates both children of a split
    in one go).

    The split is the first of the flattened (2, F, B) candidates —
    missing left before missing right, then the lower feature, then the
    lower cut — whose gain lies within the leaf's :func:`tie_width` of the
    best (the near-tie rule, :data:`TIE_ULPS`)."""
    M, F, B, _ = hist.shape
    both, order, ptot, parent_score = _gains(hist, scale, is_categorical,
                                             params)
    if feat_mask is not None:
        both = torch.where(feat_mask[:, None], both, -_INF)
    flat = both.reshape(M, 2 * F * B)
    best = torch.amax(flat, dim=1)
    width = tie_width(best, parent_score)
    best_idx = first_near_best(flat, best[:, None], width[:, None])  # (M,)
    rem = best_idx % (F * B)
    g, h, c = ptot[:, 0], ptot[:, 1], ptot[:, 2]
    value = _leaf_value(g, h, params.lambda_l1, params.lambda_l2)
    f32 = torch.float32
    packed = torch.stack([
        torch.gather(flat, 1, best_idx[:, None])[:, 0],
        (rem // B).to(f32),                              # feature
        (rem % B).to(f32),                               # cut position
        (best_idx < F * B).to(f32),                      # missing left
        torch.gather(order.reshape(M, F * B), 1,
                     rem[:, None])[:, 0].to(f32),        # threshold bin
        g, h, c, value, width,
    ], dim=1)
    return packed, order


def eval_leaf(hist, is_categorical, params: GrowthParams, feat_mask=None):
    """Everything the grower needs about one leaf: best split
    (gain/feature/cut/missing-direction/threshold-bin), leaf totals and
    the leaf value, and the leaf's near-tie width, packed into a 10-float
    f32 vector on the device.

    ``hist`` (F, B, 3) f32 (the reference's form), taken into fixed
    point (:func:`fixed_hist`); the growers call :func:`eval_leaves` on
    their own fixed point. Returns (packed (10,) f32, order (F, B)
    int64).
    """
    fixed, scale = fixed_hist(hist)
    packed, order = eval_leaves(fixed[None], scale, is_categorical, params,
                                feat_mask)
    return packed[0], order[0]


# ---------------------------------------------------------------------------
# Tree structure
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Tree:
    """Flat-array decision tree (numeric thresholds + categorical masks)."""

    feature: np.ndarray        # (N,) int32; -1 for leaves
    threshold: np.ndarray      # (N,) float64 raw-value threshold
    threshold_bin: np.ndarray  # (N,) int32 bin-space threshold
    missing_left: np.ndarray   # (N,) bool: NaN/unseen routed left?
    categorical: np.ndarray    # (N,) bool: membership split?
    cat_mask: np.ndarray       # (N, B) bool: bins going LEFT for cat splits
    left: np.ndarray           # (N,) int32 child ids
    right: np.ndarray
    value: np.ndarray          # (N,) float32 leaf outputs (post-shrinkage)
    gain: np.ndarray           # (N,) float32 split gains (importance)
    n_nodes: int

    def to_json(self) -> Dict[str, Any]:
        d = {f.name: getattr(self, f.name) for f in dataclasses.fields(self)}
        return {k: (v.tolist() if isinstance(v, np.ndarray) else v)
                for k, v in d.items()}

    @staticmethod
    def from_json(d: Dict[str, Any]) -> "Tree":
        dtypes = {"feature": np.int32, "threshold": np.float64,
                  "threshold_bin": np.int32, "missing_left": bool,
                  "categorical": bool, "cat_mask": bool,
                  "left": np.int32, "right": np.int32,
                  "value": np.float32, "gain": np.float32}
        kw = {k: (np.asarray(v, dtype=dtypes[k]) if k in dtypes else v)
              for k, v in d.items()}
        return Tree(**kw)

    def max_depth(self) -> int:
        depth = np.zeros(self.n_nodes, dtype=np.int32)
        out = 0
        for i in range(self.n_nodes):
            if self.feature[i] >= 0:
                for ch in (self.left[i], self.right[i]):
                    depth[ch] = depth[i] + 1
                    out = max(out, int(depth[ch]))
        return out


def predict_tree_raw(tree_arrays, X, cat_bins, max_depth: int):
    """Batched raw-feature traversal: X (n, F) f32 -> (n,) leaf values.

    ``tree_arrays``: tensors mirroring Tree fields on X's device
    (``threshold`` f32, node ids int64); ``cat_bins``: (n, F) int64
    bin-space values of categorical features (zeros elsewhere). Every
    row takes ``max_depth + 1`` steps; a row at a leaf stays there. X
    and the thresholds are f32, so rows route as the reference's (which
    uploads both as f32) do.
    """
    feature = tree_arrays["feature"]
    threshold = tree_arrays["threshold"]
    missing_left = tree_arrays["missing_left"]
    categorical = tree_arrays["categorical"]
    cat_mask = tree_arrays["cat_mask"]
    left, right = tree_arrays["left"], tree_arrays["right"]
    width = cat_mask.shape[1]

    node = torch.zeros(X.shape[0], dtype=torch.int64, device=X.device)
    for _ in range(max_depth + 1):
        feat = feature[node]
        is_leaf = feat < 0
        f = torch.clamp(feat, min=0)[:, None]
        xv = torch.gather(X, 1, f)[:, 0]
        go_left_num = torch.where(torch.isnan(xv), missing_left[node],
                                  xv <= threshold[node])
        # out-of-range bins clamp, as the reference's gathers do
        bv = torch.clamp(torch.gather(cat_bins, 1, f)[:, 0], 0, width - 1)
        go_left_cat = cat_mask[node, bv]
        go_left = torch.where(categorical[node], go_left_cat, go_left_num)
        nxt = torch.where(go_left, left[node], right[node])
        node = torch.where(is_leaf, node, nxt)
    return tree_arrays["value"][node]


# ---------------------------------------------------------------------------
# Leaf-wise grower — on-device program
# ---------------------------------------------------------------------------

def grow_tree_device(bins_t, grad, hess, sample_mask, is_categorical,
                     feat_mask, params: GrowthParams, n_features: int,
                     n_bins: int, scale, hist_reduce=None
                     ) -> Dict[str, torch.Tensor]:
    """Grow one whole tree on the device with no host synchronization.

    bins_t (F, n) uint8 or int32 (K9's layout); grad/hess (n,) f32;
    sample_mask (n,) bool; is_categorical (F,) bool, or None when no
    feature is categorical; feat_mask (F,) bool or None.
    The frontier — per-node split records, a histogram slot pool with
    the parent-minus-child subtraction trick, and the row -> node
    assignment — lives in device tensors. The body runs ``num_leaves -
    1`` times, each update predicated on ``active`` (see the module
    docstring), so K9 runs ``num_leaves`` times per tree.

    ``hist_reduce`` (the data learner one rank per process) sums each
    K9 histogram over the processes of the data axis, so every process
    holds the global histogram and grows the same tree over its rows.
    ``scale`` is the histograms' fixed point
    (:func:`.learners.fit_scale`), and the histograms stay int64
    throughout.

    Returns the final state (node arrays sized ``2*num_leaves-1``, the
    ``n_nodes`` count and the per-row assignment ``node_of_row``).
    """
    L = params.num_leaves
    max_nodes = 2 * L - 1
    B, F = n_bins, n_features
    dev = grad.device
    i64, f32 = torch.int64, torch.float32

    def hist_fn(in_leaf):
        h = build_histogram_cuda(bins_t, grad, hess, in_leaf, F, B, scale)
        return h if hist_reduce is None else hist_reduce(h)

    gate = max(params.min_gain_to_split, 0.0)

    def eligible(packed, depth_val):
        ok = packed[..., EV_COUNT] >= 2 * params.min_data_in_leaf
        if params.max_depth >= 0:
            ok = ok & (depth_val < params.max_depth)
        # the gate is a candidate too: a gain within the leaf's near-tie
        # width of it does not pass
        return ok & (packed[..., EV_GAIN] - packed[..., EV_TIE_WIDTH]
                     > gate)

    def split_gain(packed, depth_val):
        """A leaf's (or a stack of leaves') gain where it may split, else
        -inf."""
        return torch.where(eligible(packed, depth_val), packed[..., EV_GAIN],
                           -_INF)

    # ALL rows are routed through the tree (their raw scores must receive
    # every tree's contribution); only sampled rows enter histograms
    n = grad.shape[0]
    node_of_row = torch.zeros(n, dtype=i64, device=dev)
    root_hist = hist_fn(sample_mask)
    root_packed = eval_leaves(root_hist[None], scale, is_categorical,
                              params, feat_mask)[0][0]

    nodes = torch.arange(max_nodes, device=dev)
    bin_ids = torch.arange(B, device=dev)
    feature = torch.full((max_nodes,), -1, dtype=i64, device=dev)
    threshold_bin = torch.zeros(max_nodes, dtype=i64, device=dev)
    missing_left = torch.zeros(max_nodes, dtype=torch.bool, device=dev)
    categorical = torch.zeros(max_nodes, dtype=torch.bool, device=dev)
    cat_mask = torch.zeros(max_nodes, B, dtype=torch.bool, device=dev)
    left = torch.zeros(max_nodes, dtype=i64, device=dev)
    right = torch.zeros(max_nodes, dtype=i64, device=dev)
    at_root = nodes == 0
    value = torch.where(at_root, root_packed[EV_VALUE],
                        torch.zeros((), dtype=f32, device=dev))
    gain = torch.zeros(max_nodes, dtype=f32, device=dev)
    depth = torch.zeros(max_nodes, dtype=i64, device=dev)
    fr_packed = torch.where(at_root[:, None], root_packed,
                            torch.zeros((), dtype=f32, device=dev))
    fr_gain = torch.where(at_root, split_gain(root_packed, 0), -_INF)
    slot = torch.zeros(max_nodes, dtype=i64, device=dev)
    pool = torch.zeros(L, F, B, 3, dtype=i64, device=dev)
    pool[0] = root_hist
    n_nodes = torch.ones((), dtype=i64, device=dev)
    n_leaves = torch.ones((), dtype=i64, device=dev)

    for _ in range(L - 1):
        best_gain = torch.amax(fr_gain)
        active = (n_leaves < L) & torch.isfinite(best_gain)
        # the near-tie rule over the frontier: the first leaf (in node
        # order) within its own width of the best
        leaf = first_near_best(fr_gain, best_gain,
                               fr_packed[:, EV_TIE_WIDTH])
        packed = _at(fr_packed, leaf)
        feat = packed[EV_FEATURE].to(i64)
        cut_pos = packed[EV_CUT_POS].to(i64)
        thr_bin = packed[EV_THRESHOLD_BIN].to(i64)
        m_left = packed[EV_MISSING_LEFT] > 0.5
        pslot = _at(slot, leaf)
        phist = _at(pool, pslot)
        li = n_nodes
        ri = n_nodes + 1

        bins_col = _at(bins_t, feat).to(i64)   # (F, n): one feature's row
        go_left = torch.where(bins_col == MISSING_BIN, m_left,
                              (bins_col <= thr_bin)
                              & (bins_col != MISSING_BIN))
        if is_categorical is not None:
            # ordering of the split feature's bins (_gains': G/H sorted,
            # empty bins last)
            is_cat = _at(is_categorical, feat)
            hrow = _at(phist, feat)                          # (B, 3)
            hrow_f = fixed_to_float(hrow, scale)
            ratio = hrow_f[:, 0] / (hrow_f[:, 1] + 1e-12)
            cat_key = torch.where(hrow[:, 2] < 0.5, _INF, ratio)
            order_row = torch.where(is_cat, torch.argsort(cat_key,
                                                          stable=True),
                                    bin_ids)
            pos_of_bin = torch.empty_like(order_row).scatter_(0, order_row,
                                                              bin_ids)
            cat_row = pos_of_bin <= cut_pos      # bins going LEFT (cat)
            go_left = torch.where(is_cat, cat_row[bins_col], go_left)
        in_leaf = (node_of_row == leaf) & active
        node_of_row = torch.where(in_leaf & go_left, li,
                                  torch.where(in_leaf, ri, node_of_row))

        # child histograms: build left, subtract for right (exact)
        lhist = hist_fn((node_of_row == li) & sample_mask)
        rhist = phist - lhist
        children = eval_leaves(torch.stack([lhist, rhist]), scale,
                               is_categorical, params, feat_mask)[0]
        lp, rp = children
        dch = _at(depth, leaf) + 1
        rslot = n_leaves  # slots allocated sequentially: one per leaf

        at_leaf = (nodes == leaf) & active
        at_l = (nodes == li) & active
        at_r = (nodes == ri) & active
        at_child = at_l | at_r
        feature = torch.where(at_leaf, feat, feature)
        threshold_bin = torch.where(at_leaf, thr_bin, threshold_bin)
        missing_left = torch.where(at_leaf, m_left, missing_left)
        if is_categorical is not None:
            categorical = torch.where(at_leaf, is_cat, categorical)
            cat_mask = torch.where(at_leaf[:, None],
                                   (cat_row & is_cat)[None, :], cat_mask)
        left = torch.where(at_leaf, li, left)
        right = torch.where(at_leaf, ri, right)
        value = torch.where(at_l, lp[EV_VALUE],
                            torch.where(at_r, rp[EV_VALUE], value))
        gain = torch.where(at_leaf, packed[EV_GAIN], gain)
        depth = torch.where(at_child, dch, depth)
        fr_packed = torch.where(at_l[:, None], lp,
                                torch.where(at_r[:, None], rp, fr_packed))
        child_gain = split_gain(children, dch)
        fr_gain = torch.where(
            at_l, child_gain[0],
            torch.where(at_r, child_gain[1],
                        torch.where(at_leaf, -_INF, fr_gain)))
        slot = torch.where(at_l, pslot, torch.where(at_r, rslot, slot))
        # pool[pslot] = lhist, pool[rslot] = rhist when active; else each
        # slot gets its own value back (rslot clamped into the pool)
        rslot_c = torch.clamp(rslot, max=L - 1)
        pool.index_copy_(0, torch.stack([pslot, rslot_c]), torch.stack([
            torch.where(active, lhist, phist),
            torch.where(active, rhist, _at(pool, rslot_c))]))
        n_nodes = n_nodes + 2 * active
        n_leaves = n_leaves + active.to(i64)

    return dict(feature=feature, threshold_bin=threshold_bin,
                missing_left=missing_left, categorical=categorical,
                cat_mask=cat_mask, left=left, right=right, value=value,
                gain=gain, depth=depth, node_of_row=node_of_row,
                n_nodes=n_nodes, n_leaves=n_leaves)


def to_host(tensors: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """Copy a dict of device tensors to numpy with one synchronization:
    every copy is queued first, then the device is waited for once."""
    out = {k: t.to("cpu", non_blocking=True) for k, t in tensors.items()}
    if any(t.device.type == "cuda" for t in tensors.values()):
        torch.cuda.synchronize()
    return {k: t.numpy() for k, t in out.items()}


# ---------------------------------------------------------------------------
# Leaf-wise grower
# ---------------------------------------------------------------------------

def _route_left(bins_col, threshold_bin: int, missing_left: bool,
                is_cat: bool, order, cut_pos: int):
    """Which rows of a split leaf go left, in bin space: a categorical
    split sends the bins at positions ``<= cut_pos`` of its G/H ``order``
    left; a numeric one the bins ``<= threshold_bin``, and the missing
    bin by ``missing_left``."""
    bins_col = bins_col.to(torch.int64)
    if is_cat:
        pos_of_bin = torch.empty_like(order).scatter_(
            0, order, torch.arange(order.shape[0], device=order.device))
        return pos_of_bin[bins_col] <= cut_pos
    return torch.where(bins_col == MISSING_BIN, missing_left,
                       (bins_col <= threshold_bin)
                       & (bins_col != MISSING_BIN))


class TreeGrower:
    """Grows one tree leaf-wise over binned data living on the device.

    ``tree_learner`` is ``data``, ``feature`` or ``voting``; ``mesh`` (a
    :class:`~mmlspark_tpu_torch.parallel.topology.Mesh` with a ``data``
    axis) makes the fit sharded over that axis (:mod:`.learners`): the
    data learner sums its histograms over the axis, the feature learner
    builds each rank's feature slice, the voting learner votes. The
    ``data`` learner grows a whole tree in :func:`grow_tree_device` (no
    host read until the tree is done); ``feature`` and ``voting`` keep
    the reference's per-leaf host loop (:meth:`_grow_host`).

    ``n_rows`` is the fit's real row count (every process's rows, the
    pads of a sharded fit left out), which sets the histograms' fixed
    point (:func:`.learners.fit_scale`), so a fit spread over any data
    axis scales as the fit on one device does."""

    def __init__(self, bin_mapper, params: GrowthParams, n_features: int,
                 n_bins: int, n_rows: int,
                 device: Optional[torch.device] = None,
                 tree_learner: str = "data", mesh=None, top_k: int = 20):
        self.mapper = bin_mapper
        self.params = params
        self.n_features = n_features
        self.n_bins = n_bins
        self.n_rows = n_rows
        # n_features may exceed the mapper's count (the feature learner
        # pads the feature dim to the data axis); pads are numeric
        cats = list(bin_mapper.categorical)
        cats += [False] * (n_features - len(cats))
        # None: every feature numeric, and split finding skips the sorts
        self.is_categorical = (torch.tensor(cats, dtype=torch.bool,
                                            device=device)
                               if any(cats) else None)
        self.tree_learner = tree_learner
        self.axis = None
        self._voting = None
        self._bins_src = None          # identity key of the cached
        self._bins_parts = None        # per-rank layout of the bins
        if mesh is not None:
            from mmlspark_tpu_torch.gbdt.learners import DataAxis, VotingHist
            self.axis = DataAxis(mesh)
            if tree_learner == "voting":
                self._voting = VotingHist(self.axis, params,
                                          self.is_categorical, n_features,
                                          n_bins, top_k)

    @property
    def row_axis(self):
        """The data axis when this process holds a block of the rows
        (the data and voting learners of a sharded fit), else None."""
        return None if self.tree_learner == "feature" else self.axis

    # voting histograms are exact only on the voted feature subset, which
    # differs between a parent and its children: the parent-minus-child
    # subtraction is unsound there, so both children build directly
    @property
    def _no_subtract(self) -> bool:
        return self._voting is not None

    def gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """Every process's rows of ``x`` joined in rank order (``x``
        itself unless each process holds a block of the rows)."""
        axis = self.row_axis
        return x if axis is None else axis.gather(x)

    def hist_reduce(self):
        """The device grower's per-histogram reduction: the sum over the
        data axis's processes, or None."""
        axis = self.row_axis
        return axis.all_reduce if axis is not None and axis.distributed \
            else None

    def _parts(self, bins_t):
        """The bins as the learner's ranks read them, made once a fit
        (identity-keyed): the voting ranks' row blocks, or this
        process's feature slice."""
        if self._bins_src is not bins_t:
            self._bins_parts = (self.axis.row_blocks(bins_t)
                                if self._voting is not None
                                else self.axis.feature_slice(bins_t))
            self._bins_src = bins_t
        return self._bins_parts

    def _hist(self, bins_t, grad, hess, in_leaf, scale, feat_mask=None):
        """One leaf's (F, B, 3) int64 histogram in the fixed point
        ``scale`` by the learner's pattern; K9 on the card for every one
        of them."""
        if self._voting is not None:
            return self._voting(self._parts(bins_t), grad, hess, in_leaf,
                                scale, feat_mask)
        if self.tree_learner == "feature" and self.axis is not None:
            from mmlspark_tpu_torch.gbdt.learners import feature_histogram
            return feature_histogram(self.axis, self._parts(bins_t), grad,
                                     hess, in_leaf, self.n_features,
                                     self.n_bins, scale)
        h = build_histogram_cuda(bins_t, grad, hess, in_leaf,
                                 self.n_features, self.n_bins, scale)
        reduce = self.hist_reduce()
        return h if reduce is None else reduce(h)

    def _renew(self, node_of_row, renew, sample_mask, max_nodes: int):
        """Leaf renewal over the fit's global rows (gathered once a tree
        when each process holds a block of them)."""
        from mmlspark_tpu_torch.gbdt.learners import renewal_rows
        return renew_leaf_values(
            *renewal_rows(self.row_axis, node_of_row, renew["residual"],
                          renew["weights"], sample_mask),
            max_nodes, renew["q"], self.n_rows)

    def grow(self, bins_t, grad, hess, sample_mask, shrinkage: float,
             feat_mask=None, renew=None
             ) -> Tuple[Tree, torch.Tensor, torch.Tensor]:
        """Returns (tree, per-row raw value of the new tree, row->node ids).

        ``bins_t`` (F, n) uint8 or int32 in K9's layout; grad/hess (n,)
        f32; sample_mask (n,) bool: this process's rows (every row for
        the feature learner and on a hosted mesh). ``renew``: optional
        ``{"q", "residual", "weights"}`` — L1/quantile leaf-output
        renewal (:func:`renew_leaf_values`) inside the grower, so a
        device-grown tree still costs one host fetch. The histograms'
        fixed point is taken from grad and hess over the sampled rows
        (:func:`.learners.fit_scale`).
        """
        from mmlspark_tpu_torch.gbdt.learners import fit_scale
        scale = fit_scale(grad, hess, sample_mask, self.n_rows,
                          self.row_axis)
        if self.tree_learner == "data" and self._voting is None:
            return self._grow_device(bins_t, grad, hess, sample_mask,
                                     shrinkage, scale, feat_mask, renew)
        return self._grow_host(bins_t, grad, hess, sample_mask,
                               shrinkage, scale, feat_mask, renew)

    def _grow_device(self, bins_t, grad, hess, sample_mask,
                     shrinkage: float, scale, feat_mask=None, renew=None
                     ) -> Tuple[Tree, torch.Tensor, torch.Tensor]:
        p = self.params
        s = grow_tree_device(bins_t, grad, hess, sample_mask,
                             self.is_categorical, feat_mask, p,
                             self.n_features, self.n_bins,
                             hist_reduce=self.hist_reduce(), scale=scale)
        val_dev = s["value"]
        if renew is not None:
            rv, rc = self._renew(s["node_of_row"], renew, sample_mask,
                                 2 * p.num_leaves - 1)
            val_dev = torch.where((s["feature"] < 0) & (rc > 0), rv, val_dev)
        # ONE host fetch for the whole tree (renewed values included)
        host = to_host({k: s[k] for k in (
            "feature", "threshold_bin", "missing_left", "categorical",
            "cat_mask", "left", "right", "gain", "n_nodes")}
            | {"value": val_dev})
        value_arr = (host["value"] * shrinkage).astype(np.float32)
        tree = tree_from_arrays(
            self.mapper, host["feature"], host["threshold_bin"],
            host["missing_left"], host["categorical"], host["cat_mask"],
            host["left"], host["right"], value_arr, host["gain"],
            int(host["n_nodes"]))
        node_of_row = s["node_of_row"]
        row_vals = (val_dev * shrinkage)[node_of_row]
        return tree, row_vals, node_of_row

    def _grow_host(self, bins_t, grad, hess, sample_mask,
                   shrinkage: float, scale, feat_mask=None, renew=None
                   ) -> Tuple[Tree, torch.Tensor, torch.Tensor]:
        """The reference's per-leaf host loop: each split routes the
        leaf's rows, builds its children's histograms (both directly
        under voting), evaluates both in one device pass and reads the
        two packed vectors back in one fetch; the leaf with the best
        gain is split next."""
        p = self.params
        max_nodes = 2 * p.num_leaves - 1
        B = self.n_bins
        n_mapped = len(self.mapper.categorical)

        feature = np.full(max_nodes, -1, np.int32)
        threshold = np.zeros(max_nodes, np.float64)
        threshold_bin = np.zeros(max_nodes, np.int32)
        missing_left = np.zeros(max_nodes, bool)
        categorical = np.zeros(max_nodes, bool)
        cat_mask = np.zeros((max_nodes, B), bool)
        left = np.zeros(max_nodes, np.int32)
        right = np.zeros(max_nodes, np.int32)
        value = np.zeros(max_nodes, np.float32)
        gain_arr = np.zeros(max_nodes, np.float32)
        depth = np.zeros(max_nodes, np.int32)

        # ALL rows are routed (every row's raw score receives the tree's
        # contribution); only rows in sample_mask enter the histograms
        node_of_row = torch.zeros(bins_t.shape[1], dtype=torch.int64,
                                  device=grad.device)

        def hist(mask):
            return self._hist(bins_t, grad, hess, mask, scale, feat_mask)

        root_hist = hist(sample_mask)
        root_dev, root_order = (x[0] for x in eval_leaves(
            root_hist[None], scale, self.is_categorical, p, feat_mask))
        root_packed = root_dev.cpu().numpy()
        value[0] = root_packed[EV_VALUE]

        # frontier: leaf id -> (hist, packed scalars, device order)
        frontier: Dict[int, Dict[str, Any]] = {}

        def consider(leaf_id, h, packed, order):
            if packed[EV_COUNT] < 2 * p.min_data_in_leaf:
                return
            if 0 <= p.max_depth <= depth[leaf_id]:
                return
            if packed[EV_GAIN] - packed[EV_TIE_WIDTH] > max(
                    p.min_gain_to_split, 0.0):
                frontier[leaf_id] = {"hist": h, "packed": packed,
                                     "order": order}

        consider(0, root_hist, root_packed, root_order)
        n_nodes = 1
        n_leaves = 1

        while n_leaves < p.num_leaves and frontier:
            # split the leaf with the best gain (leaf-wise); the first in
            # insertion order (node order) within its own near-tie width
            # of the best, as the fused grower's pick
            best_gain = max(e["packed"][EV_GAIN] for e in frontier.values())
            leaf_id = next(k for k, e in frontier.items()
                           if e["packed"][EV_GAIN]
                           >= best_gain - e["packed"][EV_TIE_WIDTH])
            entry = frontier.pop(leaf_id)
            packed = entry["packed"]
            feat = int(packed[EV_FEATURE])
            cut_pos = int(packed[EV_CUT_POS])
            is_cat = bool(self.mapper.categorical[feat]) \
                if feat < n_mapped else False

            li, ri = n_nodes, n_nodes + 1
            n_nodes += 2
            n_leaves += 1

            feature[leaf_id] = feat
            threshold_bin[leaf_id] = int(packed[EV_THRESHOLD_BIN])
            missing_left[leaf_id] = bool(packed[EV_MISSING_LEFT])
            categorical[leaf_id] = is_cat
            gain_arr[leaf_id] = packed[EV_GAIN]
            left[leaf_id], right[leaf_id] = li, ri
            depth[li] = depth[ri] = depth[leaf_id] + 1
            order_row = entry["order"][feat]          # device (B,)
            if is_cat:
                # the only path that copies an order row to the host
                order_np = order_row.cpu().numpy()
                cat_mask[leaf_id, order_np[:cut_pos + 1]] = True
            else:
                threshold[leaf_id] = self.mapper.threshold_value(
                    feat, int(threshold_bin[leaf_id]))

            go_left = _route_left(bins_t[feat], int(threshold_bin[leaf_id]),
                                  bool(missing_left[leaf_id]), is_cat,
                                  order_row, cut_pos)
            in_leaf = node_of_row == leaf_id
            node_of_row = torch.where(in_leaf & go_left, li,
                                      torch.where(in_leaf, ri, node_of_row))

            # child histograms: the left built, the right subtracted
            # (built too under voting)
            lhist = hist((node_of_row == li) & sample_mask)
            rhist = (hist((node_of_row == ri) & sample_mask)
                     if self._no_subtract else entry["hist"] - lhist)
            # both children evaluated before either is read: one
            # round-trip a split
            both, orders = eval_leaves(torch.stack([lhist, rhist]), scale,
                                       self.is_categorical, p, feat_mask)
            lpacked, rpacked = both.cpu().numpy()
            value[li] = lpacked[EV_VALUE]
            value[ri] = rpacked[EV_VALUE]
            consider(li, lhist, lpacked, orders[0])
            consider(ri, rhist, rpacked, orders[1])

        if renew is not None:
            rv, rc = self._renew(node_of_row, renew, sample_mask, max_nodes)
            host = to_host({"rv": rv, "rc": rc})
            is_leaf = (feature < 0) & (host["rc"] > 0)
            value = np.where(is_leaf, host["rv"], value)
        value_arr = (value * shrinkage).astype(np.float32)
        tree = Tree(feature=feature[:n_nodes], threshold=threshold[:n_nodes],
                    threshold_bin=threshold_bin[:n_nodes],
                    missing_left=missing_left[:n_nodes],
                    categorical=categorical[:n_nodes],
                    cat_mask=cat_mask[:n_nodes],
                    left=left[:n_nodes], right=right[:n_nodes],
                    value=value_arr[:n_nodes], gain=gain_arr[:n_nodes],
                    n_nodes=n_nodes)
        # the tree's training-time prediction: gather the leaf values
        row_vals = torch.as_tensor(value_arr, device=grad.device)[node_of_row]
        return tree, row_vals, node_of_row


# ---------------------------------------------------------------------------
# Leaf-output renewal (L1 / quantile objectives)
# ---------------------------------------------------------------------------

def renew_leaf_values(node_of_row, residual, weights, sample_mask,
                      max_nodes: int, q: float,
                      n_rows: Optional[int] = None):
    """Per-leaf weighted ``q``-quantile of residuals, on the device.

    LightGBM renews L1/quantile leaf outputs to the residual percentile
    over the leaf's bagged rows before shrinkage (`RenewTreeOutput`).
    The reference's rule, step for step: rows sorted by residual, then
    stably regrouped by leaf (zero-weight rows to each segment's tail);
    within-leaf cumulative weights from the global cumsum minus each
    segment's base; the first row reaching ``q`` times the leaf's weight,
    linearly interpolated toward its predecessor in cumulative-weight
    space. Returns ``(values (max_nodes,) f32, counts (max_nodes,) f32)``;
    leaves with zero sampled rows keep their caller-side value
    (count == 0 flags them).

    The reference sums each leaf's weight and count with a scatter-add;
    here they are the within-leaf cumulative sums at each segment's end,
    taken with an order-free ``amax`` (the cumulative sums only grow
    within a segment). The weights enter those sums in int64 fixed point
    (:func:`.cuda_hist.fixed_grid` of the largest sampled weight over
    ``n_rows``, the fit's real rows: these rows when not given), so
    every cumulative weight is exact, the same on every device, and
    reaches f32 in one conversion.
    """
    n = residual.shape[0]
    dev = residual.device
    w = torch.where(sample_mask, weights, 0.0).to(torch.float32)
    by_res = torch.argsort(residual, stable=True)
    zero_tail = (w[by_res] <= 0.0).to(node_of_row.dtype)
    regroup = torch.argsort(node_of_row[by_res] * 2 + zero_tail, stable=True)
    order = by_res[regroup]
    sorted_leaf = node_of_row[order]
    sorted_w = w[order]
    sorted_res = residual[order].to(torch.float32)

    starts = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                        sorted_leaf[1:] != sorted_leaf[:-1]])

    def within_leaf_cumsum(x):
        cum = torch.cumsum(x, dim=0)                    # nondecreasing
        prev = torch.cat([torch.zeros(1, dtype=cum.dtype, device=dev),
                          cum[:-1]])
        # the cumsum just before each segment, forward-filled (cummax
        # forward-fills because cum is nondecreasing)
        base = torch.cummax(torch.where(starts, prev, 0), dim=0).values
        return cum - base

    def leaf_total(cw):
        return torch.zeros(max_nodes, dtype=torch.float32, device=dev
                           ).scatter_reduce_(0, sorted_leaf, cw, "amax",
                                             include_self=True)

    w_grid = fixed_grid(torch.amax(w), n if n_rows is None else n_rows)
    cw_in = fixed_to_float(within_leaf_cumsum(to_fixed(sorted_w, w_grid)),
                           w_grid)                      # within-leaf cumsum
    tot = leaf_total(cw_in)
    target_leaf = torch.clamp(q * tot, min=1e-12)
    pos = torch.arange(n, device=dev)
    full_n = torch.full((max_nodes,), n, dtype=torch.int64, device=dev)
    idx = full_n.clone().scatter_reduce_(
        0, sorted_leaf, torch.where(cw_in >= target_leaf[sorted_leaf], pos, n),
        "amin", include_self=True)
    first = full_n.scatter_reduce_(0, sorted_leaf, pos, "amin",
                                   include_self=True)
    idx_c = torch.clamp(idx, max=n - 1)
    v_hi = sorted_res[idx_c]
    # interpolate toward the previous order statistic when the target
    # falls between the two rows' cumulative weights; the segment's
    # first row has no predecessor and is returned as-is
    prev = torch.clamp(idx_c - 1, min=0)
    has_prev = idx_c > first
    cw_lo = torch.where(has_prev, cw_in[prev], 0.0)
    v_lo = torch.where(has_prev, sorted_res[prev], v_hi)
    denom = torch.clamp(cw_in[idx_c] - cw_lo, min=1e-12)
    bias = torch.clamp((target_leaf - cw_lo) / denom, 0.0, 1.0)
    values = v_lo + bias * (v_hi - v_lo)
    counts = leaf_total(within_leaf_cumsum(
        (sorted_w > 0).to(torch.int64)).to(torch.float32))
    return values, counts


def tree_from_arrays(mapper, feature, threshold_bin, missing_left,
                     categorical, cat_mask, left, right, value, gain,
                     n_nodes: int) -> Tree:
    """Assemble a :class:`Tree` from fetched node arrays, mapping numeric
    threshold bins to raw-value thresholds (f64, on the host)."""
    n_mapped = len(mapper.categorical)
    threshold = np.zeros(len(feature), np.float64)
    for i in range(n_nodes):
        if feature[i] >= 0 and not categorical[i] and feature[i] < n_mapped:
            threshold[i] = mapper.threshold_value(int(feature[i]),
                                                  int(threshold_bin[i]))
    return Tree(feature=np.asarray(feature[:n_nodes], np.int32),
                threshold=threshold[:n_nodes],
                threshold_bin=np.asarray(threshold_bin[:n_nodes], np.int32),
                missing_left=np.asarray(missing_left[:n_nodes], bool),
                categorical=np.asarray(categorical[:n_nodes], bool),
                cat_mask=np.asarray(cat_mask[:n_nodes], bool),
                left=np.asarray(left[:n_nodes], np.int32),
                right=np.asarray(right[:n_nodes], np.int32),
                value=np.asarray(value[:n_nodes], np.float32),
                gain=np.asarray(gain[:n_nodes], np.float32),
                n_nodes=n_nodes)


# ---------------------------------------------------------------------------
# Whole-fit device loop
# ---------------------------------------------------------------------------

EMIT_KEYS = ("feature", "threshold_bin", "missing_left", "categorical",
             "cat_mask", "left", "right", "gain", "n_nodes")


def boost_loop_device(bins_t, y, w, valid_mask, init_raw, grad_hess,
                      n_iters: int, n_outputs: int, params: GrowthParams,
                      is_categorical, feat_mask, n_features: int,
                      n_bins: int, shrinkage: float,
                      renew_q: Optional[float],
                      n_valid: int = 0, metric_fn=None,
                      generator: Optional[torch.Generator] = None,
                      bagging_fraction: float = 1.0, bagging_freq: int = 0,
                      goss: bool = False, top_rate: float = 0.2,
                      other_rate: float = 0.1,
                      feature_fraction: float = 1.0,
                      n_real: Optional[int] = None, it_offset: int = 0,
                      axis=None):
    """The whole boosting fit as one loop of device work, with no host
    synchronization until the caller fetches the result.

    Per iteration: gradients from the carried ``(n, K)`` raw scores, one
    :func:`grow_tree_device` tree per model output (K trees for
    multiclass) with its histograms' fixed point taken from that
    output's gradients, optional L1/quantile leaf renewal, raw update. Returns
    ``(final raw, stacked)`` with ``stacked`` the per-iteration node
    arrays as ``(n_iters, K, ...)`` device tensors (and ``"metric"``
    ``(n_iters,)`` with a validation set).

    Sampling draws from ``generator`` (a ``torch.Generator`` on the
    device), so sampled fits match the reference in distribution and
    quality, not tree for tree:

    - ``bagging_fraction < 1`` with ``bagging_freq > 0``: a per-row
      Bernoulli mask redrawn every ``freq`` iterations and at the
      loop's first, held between redraws (no reweighting);
    - ``goss=True``: from absolute iteration 1, the ``int(top_rate *
      n_real)`` rows with the largest summed |gradient| plus
      ``int(other_rate * n_real)`` uniformly drawn others, the others'
      grad/hess amplified by ``(1 - top_rate) / other_rate``;
    - ``feature_fraction < 1``: exactly ``max(int(feature_fraction *
      F), 1)`` columns per iteration, without replacement, applied at
      split finding.

    Validation rows are the LAST ``n_valid`` rows with ``valid_mask``
    False: out of histograms, sampling and renewal, but routed, so
    ``metric_fn(raw[-n_valid:], y[-n_valid:])`` is evaluated on the
    device every iteration. ``it_offset`` is the absolute iteration of
    the first (continuations). ``n_real`` is the fit's real row count
    (every process's rows, pads left out; by default the rows of
    ``valid_mask`` less the validation rows): GOSS's counts and the
    histograms' fixed point (:func:`.learners.fit_scale`) read it.

    ``axis`` (a :class:`~.learners.DataAxis`, the data learner of a fit
    sharded one rank per process) holds this process's block of the
    rows: histograms are summed over the axis, the sampling masks are
    drawn over the global rows on every process from the same generator
    (GOSS over the gathered gradients) and each process takes its block,
    and leaf renewal runs over the gathered rows.
    """
    K = n_outputs
    max_nodes = 2 * params.num_leaves - 1
    n_total = bins_t.shape[1]
    dev = y.device
    vy = y[n_total - n_valid:] if n_valid else None
    bagging = bagging_fraction < 1.0 and bagging_freq > 0 and not goss
    raw = init_raw.clone()
    bag_mask = valid_mask
    emits = {k: [] for k in (*EMIT_KEYS, "value")}
    metrics = []

    def uniform(size):
        return torch.rand(size, generator=generator, device=dev)

    from mmlspark_tpu_torch.gbdt.learners import fit_scale, renewal_rows
    distributed = axis is not None and axis.distributed
    hist_reduce = axis.all_reduce if distributed else None
    local = axis.local if distributed else (lambda x: x)
    gather = axis.gather if distributed else (lambda x: x)
    valid_all = gather(valid_mask)     # the global rows' mask
    n_all = valid_all.shape[0]
    if n_real is None:
        n_real = n_all - n_valid

    for it in range(n_iters):
        pred = raw[:, 0] if K == 1 else raw
        g, h = grad_hess(pred, y, w)
        g = g if g.dim() == 2 else g[:, None]
        h = h if h.dim() == 2 else h[:, None]

        amp = None
        if goss:
            g_abs = gather(torch.where(
                valid_mask, torch.sum(torch.abs(g), dim=1), -_INF))
            n_top = int(top_rate * n_real)
            n_other = int(other_rate * n_real)
            order = torch.argsort(-g_abs, stable=True)
            top_mask = torch.zeros(n_all, dtype=torch.bool, device=dev)
            top_mask[order[:n_top]] = True
            top_mask &= valid_all
            r = torch.where(valid_all & ~top_mask, uniform(n_all), _INF)
            other_order = torch.argsort(r, stable=True)
            other_mask = torch.zeros(n_all, dtype=torch.bool, device=dev)
            other_mask[other_order[:n_other]] = True
            other_mask &= valid_all & ~top_mask
            top_mask, other_mask = local(top_mask), local(other_mask)
            if it + it_offset >= 1:   # LightGBM: full first iteration
                sample = top_mask | other_mask
                amp = torch.where(
                    other_mask, (1.0 - top_rate) / max(other_rate, 1e-12),
                    1.0).to(torch.float32)
            else:
                sample = valid_mask
        elif bagging:
            # redraw on the freq schedule AND at the loop's first
            # iteration (a continuation starting mid-cycle opens with a
            # fresh bag)
            if (it + it_offset) % bagging_freq == 0 or it == 0:
                bag_mask = valid_mask & local(uniform(n_all)
                                              < bagging_fraction)
            sample = bag_mask
        else:
            sample = valid_mask

        fm = feat_mask
        if feature_fraction < 1.0:
            k_keep = max(int(feature_fraction * n_features), 1)
            keep = torch.zeros(n_features, dtype=torch.bool, device=dev)
            keep[torch.argsort(uniform(n_features), stable=True)[:k_keep]] = \
                True
            fm = keep if feat_mask is None else keep & feat_mask

        for k in range(K):  # one tree per model output
            gk, hk = g[:, k].contiguous(), h[:, k].contiguous()
            if amp is not None:
                gk, hk = gk * amp, hk * amp
            s = grow_tree_device(bins_t, gk, hk, sample, is_categorical, fm,
                                 params, n_features, n_bins,
                                 scale=fit_scale(gk, hk, sample, n_real,
                                                 axis),
                                 hist_reduce=hist_reduce)
            val = s["value"]
            if renew_q is not None:  # renewal objectives are all K == 1
                rv, rc = renew_leaf_values(
                    *renewal_rows(axis, s["node_of_row"], y - raw[:, 0], w,
                                  sample), max_nodes, renew_q, n_real)
                val = torch.where((s["feature"] < 0) & (rc > 0), rv, val)
            shrunk = (val * shrinkage).to(torch.float32)
            raw[:, k] += shrunk[s["node_of_row"]]
            for key in EMIT_KEYS:
                emits[key].append(s[key])
            emits["value"].append(shrunk)
        if n_valid:
            metrics.append(metric_fn(raw[n_total - n_valid:], vy))

    stacked = {k: torch.stack(v).reshape(n_iters, K, *v[0].shape)
               for k, v in emits.items()}
    if n_valid:
        stacked["metric"] = torch.stack(metrics)
    return raw, stacked
