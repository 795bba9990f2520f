"""Histograms, split finding, and leaf-wise tree growth on one device.

The port of the single-device parts of ``mmlspark_tpu/gbdt/tree.py``
(LightGBM's serial tree learner, `tree_learner=data`): histograms are
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
stop. Everything that decides a split or a leaf value is deterministic
on the card: K9 has no float atomics, sorts are stable, and segment sums
go through ``cumsum`` and order-free ``scatter_reduce`` (amin/amax), not
``index_add_``.

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
    build_histogram_cuda, prepare_bins_t,
)

_INF = float("inf")


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
    count] — K9 for CUDA tensors, its plain version for CPU ones. The
    grower keeps the transposed bins and calls K9 directly.
    """
    return build_histogram_cuda(prepare_bins_t(bins), grad, hess, in_leaf,
                                n_features, n_bins)


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


def _gains(hist, is_categorical, params: GrowthParams):
    """Every candidate split of M leaves at once: hist (M, F, B, 3) ->
    (gains (M, 2, F, B), order (M, F, B), totals (M, 3) of the
    row-count-richest feature). Slot 0 of the second axis sends the
    missing bin left, slot 1 sends it right. ``is_categorical`` None:
    every feature numeric (no sort)."""
    M, F, B, _ = hist.shape
    l1, l2 = params.lambda_l1, params.lambda_l2
    dev = hist.device

    tot = torch.sum(hist, dim=2)                         # (M, F, 3)
    # parent stats are per-leaf constants; take the row-count-richest
    # feature as the source of truth, as the reference does
    src = torch.argmax(tot[..., 2], dim=1)
    ptot = torch.gather(tot, 1, src[:, None, None].expand(M, 1, 3))[:, 0]
    parent_score = _split_score(ptot[:, 0], ptot[:, 1], l1, l2)

    # numeric: bin order; categorical: non-empty bins sorted by G/H
    bin_ids = torch.arange(B, device=dev)
    # the last cut position leaves the right side empty
    invalid = bin_ids == B - 1
    if is_categorical is None:
        order, hist_ord = bin_ids.expand(M, F, B), hist
    else:
        ratio = hist[..., 0] / (hist[..., 1] + 1e-12)
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
    both = torch.stack([hist_ord, torch.where(first, 0.0, hist_ord)], dim=1)
    left = torch.cumsum(both, dim=3)                     # (M, 2, F, B, 3)
    right = tot[:, None, :, None, :] - left
    gain = (_split_score(left[..., 0], left[..., 1], l1, l2)
            + _split_score(right[..., 0], right[..., 1], l1, l2)
            - parent_score[:, None, None, None])
    ok = ((left[..., 2] >= params.min_data_in_leaf)
          & (right[..., 2] >= params.min_data_in_leaf)
          & (left[..., 1] >= params.min_sum_hessian_in_leaf)
          & (right[..., 1] >= params.min_sum_hessian_in_leaf))
    gain = torch.where(ok & ~invalid, gain, -_INF)
    return gain, order, ptot


def split_gain_matrix(hist, is_categorical, params: GrowthParams):
    """All candidate-split gains of one leaf: ((2, F, B) gains, (F, B) order).

    Slot 0 of the first axis sends the missing bin left, slot 1 sends it
    right. Numeric features cut in bin order; categorical ones in the
    G/H order of their non-empty bins (stable sort, empty bins last).
    """
    gain, order, _ = _gains(hist[None], is_categorical, params)
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


# packed layout of eval_leaf's scalar vector
EV_GAIN, EV_FEATURE, EV_CUT_POS, EV_MISSING_LEFT, EV_THRESHOLD_BIN, \
    EV_G, EV_H, EV_COUNT, EV_VALUE = range(9)


def eval_leaves(hist, is_categorical, params: GrowthParams, feat_mask=None):
    """:func:`eval_leaf` of M leaves at once: hist (M, F, B, 3) ->
    (packed (M, 9) f32, order (M, F, B) int64), with the same arithmetic
    per leaf (the grower evaluates both children of a split in one go)."""
    M, F, B, _ = hist.shape
    both, order, ptot = _gains(hist, is_categorical, params)
    if feat_mask is not None:
        both = torch.where(feat_mask[:, None], both, -_INF)
    flat = both.reshape(M, 2, F * B)
    best_flat = torch.argmax(flat, dim=2)                # (M, 2)
    best_gain_lr = torch.gather(flat, 2, best_flat[..., None])[..., 0]
    direction = torch.argmax(best_gain_lr, dim=1)        # 0: missing left
    pick = direction[:, None]
    best_idx = torch.gather(best_flat, 1, pick)[:, 0]
    g, h, c = ptot[:, 0], ptot[:, 1], ptot[:, 2]
    value = _leaf_value(g, h, params.lambda_l1, params.lambda_l2)
    f32 = torch.float32
    packed = torch.stack([
        torch.gather(best_gain_lr, 1, pick)[:, 0],
        (best_idx // B).to(f32),                         # feature
        (best_idx % B).to(f32),                          # cut position
        (direction == 0).to(f32),
        torch.gather(order.reshape(M, F * B), 1,
                     best_idx[:, None])[:, 0].to(f32),   # threshold bin
        g, h, c, value,
    ], dim=1)
    return packed, order


def eval_leaf(hist, is_categorical, params: GrowthParams, feat_mask=None):
    """Everything the grower needs about one leaf: best split
    (gain/feature/cut/missing-direction/threshold-bin), leaf totals and
    the leaf value, packed into a 9-float f32 vector on the device.

    Returns (packed (9,) f32, order (F, B) int64).
    """
    packed, order = eval_leaves(hist[None], is_categorical, params,
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
                     n_bins: int) -> Dict[str, torch.Tensor]:
    """Grow one whole tree on the device with no host synchronization.

    bins_t (F, n) uint8 or int32 (K9's layout); grad/hess (n,) f32;
    sample_mask (n,) bool; is_categorical (F,) bool, or None when no
    feature is categorical; feat_mask (F,) bool or None.
    The frontier — per-node split records, a histogram slot pool with
    the parent-minus-child subtraction trick, and the row -> node
    assignment — lives in device tensors. The body runs ``num_leaves -
    1`` times, each update predicated on ``active`` (see the module
    docstring), so K9 runs ``num_leaves`` times per tree.

    Returns the final state (node arrays sized ``2*num_leaves-1``, the
    ``n_nodes`` count and the per-row assignment ``node_of_row``).
    """
    L = params.num_leaves
    max_nodes = 2 * L - 1
    B, F = n_bins, n_features
    dev = grad.device
    i64, f32 = torch.int64, torch.float32

    def hist_fn(in_leaf):
        return build_histogram_cuda(bins_t, grad, hess, in_leaf, F, B)

    gate = max(params.min_gain_to_split, 0.0)

    def eligible(packed, depth_val):
        ok = packed[EV_COUNT] >= 2 * params.min_data_in_leaf
        if params.max_depth >= 0:
            ok = ok & (depth_val < params.max_depth)
        return ok & (packed[EV_GAIN] > gate)

    def split_gain(packed, depth_val):
        return torch.where(eligible(packed, depth_val), packed[EV_GAIN],
                           -_INF)

    # ALL rows are routed through the tree (their raw scores must receive
    # every tree's contribution); only sampled rows enter histograms
    n = grad.shape[0]
    node_of_row = torch.zeros(n, dtype=i64, device=dev)
    root_hist = hist_fn(sample_mask)
    root_packed = eval_leaf(root_hist, is_categorical, params, feat_mask)[0]

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
    pool = torch.zeros(L, F, B, 3, dtype=f32, device=dev)
    pool[0] = root_hist
    n_nodes = torch.ones((), dtype=i64, device=dev)
    n_leaves = torch.ones((), dtype=i64, device=dev)

    for _ in range(L - 1):
        active = (n_leaves < L) & torch.isfinite(torch.amax(fr_gain))
        leaf = torch.argmax(fr_gain)
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
            ratio = hrow[:, 0] / (hrow[:, 1] + 1e-12)
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

        # child histograms: build left, subtract for right
        lhist = hist_fn((node_of_row == li) & sample_mask)
        rhist = phist - lhist
        lp, rp = eval_leaves(torch.stack([lhist, rhist]), is_categorical,
                             params, feat_mask)[0]
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
        fr_gain = torch.where(
            at_l, split_gain(lp, dch),
            torch.where(at_r, split_gain(rp, dch),
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

class TreeGrower:
    """Grows one tree leaf-wise over binned data living on one device:
    the reference's ``data`` learner (its ``feature`` and ``voting``
    learners and their per-leaf host loop belong to the multi-GPU
    slice)."""

    def __init__(self, bin_mapper, params: GrowthParams, n_features: int,
                 n_bins: int, device: Optional[torch.device] = None):
        self.mapper = bin_mapper
        self.params = params
        self.n_features = n_features
        self.n_bins = n_bins
        cats = list(bin_mapper.categorical)
        cats += [False] * (n_features - len(cats))
        # None: every feature numeric, and split finding skips the sorts
        self.is_categorical = (torch.tensor(cats, dtype=torch.bool,
                                            device=device)
                               if any(cats) else None)

    def grow(self, bins_t, grad, hess, sample_mask, shrinkage: float,
             feat_mask=None, renew=None
             ) -> Tuple[Tree, torch.Tensor, torch.Tensor]:
        """Returns (tree, per-row raw value of the new tree, row->node ids).

        ``bins_t`` (F, n) uint8 or int32 in K9's layout; grad/hess (n,)
        f32; sample_mask (n,) bool. ``renew``: optional ``{"q", "residual",
        "weights"}`` — L1/quantile leaf-output renewal
        (:func:`renew_leaf_values`) inside the grower, so a tree still
        costs one host fetch.
        """
        p = self.params
        s = grow_tree_device(bins_t, grad, hess, sample_mask,
                             self.is_categorical, feat_mask, p,
                             self.n_features, self.n_bins)
        val_dev = s["value"]
        if renew is not None:
            rv, rc = renew_leaf_values(
                s["node_of_row"], renew["residual"], renew["weights"],
                sample_mask, 2 * p.num_leaves - 1, renew["q"])
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


# ---------------------------------------------------------------------------
# Leaf-output renewal (L1 / quantile objectives)
# ---------------------------------------------------------------------------

def renew_leaf_values(node_of_row, residual, weights, sample_mask,
                      max_nodes: int, q: float):
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
    within a segment), so no float atomics touch them on the card. With
    integer weights (the unweighted fit) both are exact and equal.
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
        base = torch.cummax(torch.where(starts, prev, 0.0), dim=0).values
        return cum - base

    def leaf_total(cw):
        return torch.zeros(max_nodes, dtype=torch.float32, device=dev
                           ).scatter_reduce_(0, sorted_leaf, cw, "amax",
                                             include_self=True)

    cw_in = within_leaf_cumsum(sorted_w)                # within-leaf cumsum
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
    counts = leaf_total(within_leaf_cumsum((sorted_w > 0).to(torch.float32)))
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
                      n_real: int = 0, it_offset: int = 0):
    """The whole boosting fit as one loop of device work, with no host
    synchronization until the caller fetches the result.

    Per iteration: gradients from the carried ``(n, K)`` raw scores, one
    :func:`grow_tree_device` tree per model output (K trees for
    multiclass), optional L1/quantile leaf renewal, raw update. Returns
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
    the first (continuations).
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

    for it in range(n_iters):
        pred = raw[:, 0] if K == 1 else raw
        g, h = grad_hess(pred, y, w)
        g = g if g.dim() == 2 else g[:, None]
        h = h if h.dim() == 2 else h[:, None]

        amp = None
        if goss:
            g_abs = torch.where(valid_mask, torch.sum(torch.abs(g), dim=1),
                                -_INF)
            n_top = int(top_rate * n_real)
            n_other = int(other_rate * n_real)
            order = torch.argsort(-g_abs, stable=True)
            top_mask = torch.zeros(n_total, dtype=torch.bool, device=dev)
            top_mask[order[:n_top]] = True
            top_mask &= valid_mask
            r = torch.where(valid_mask & ~top_mask, uniform(n_total), _INF)
            other_order = torch.argsort(r, stable=True)
            other_mask = torch.zeros(n_total, dtype=torch.bool, device=dev)
            other_mask[other_order[:n_other]] = True
            other_mask &= valid_mask & ~top_mask
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
                bag_mask = valid_mask & (uniform(n_total) < bagging_fraction)
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
                                 params, n_features, n_bins)
            val = s["value"]
            if renew_q is not None:  # renewal objectives are all K == 1
                rv, rc = renew_leaf_values(
                    s["node_of_row"], y - raw[:, 0], w, sample, max_nodes,
                    renew_q)
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
