"""Import and export genuine LightGBM text-format model files.

The port's copy of ``mmlspark_tpu/gbdt/lgbm_compat.py`` (numpy only),
with its imports pointed at the port; a loaded model lands on the
``device`` the caller names (``None``: the card).

Migration path for users of the reference: a model trained there is
saved with ``LightGBMBooster.saveNativeModel``
(`LightGBMBooster.scala:104` → LightGBM's ``SaveModelToString`` text
dump) and loads here unchanged. This parses the documented v2/v3 text
layout — header key=value lines, then per-tree blocks::

    Tree=0
    num_leaves=3
    split_feature=1 0
    threshold=0.5 1.25
    decision_type=2 0
    left_child=1 -1
    right_child=-1 -2
    leaf_value=0.1 -0.2 0.3

Node encoding: internal nodes are 0..num_leaves-2; a negative child
``c`` is leaf ``~c``. ``decision_type`` bit 0 = categorical split,
bit 1 = default-left, bits 2-3 = missing_type (0 = None, 1 = Zero,
2 = NaN). Numerical rule: ``x <= threshold`` goes left. Leaf values
already include shrinkage, and there is no separate init score
(LightGBM bakes boost-from-average into the leaves).

Parity scope: models with any missing_type (None / Zero / NaN) and any
``sigmoid`` coefficient reproduce ``PredictForMat`` outputs on finite
and NaN inputs. ``missing_type=Zero`` (``zero_as_missing=true``) is
handled the way LightGBM's predictor handles it — values with
``|x| <= 1e-35`` on those features are treated as missing and routed to
the default side (`Booster.zero_missing_features`). Categorical
(many-vs-many bitset) splits import and export: the bitset maps onto
the framework's per-node ``cat_mask`` with the identity level map
``category value v <-> bin v + 1`` (values beyond the bitset, negative,
or NaN fall to bin 0 and route right, exactly LightGBM's
``CategoricalDecision``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from mmlspark_tpu_torch.gbdt.binning import BinMapper
from mmlspark_tpu_torch.gbdt.tree import Tree

_OBJECTIVE_MAP = {
    "binary": "binary",
    "regression": "regression",
    "regression_l2": "regression",
    "l2": "regression",
    "mean_squared_error": "regression",
    "regression_l1": "regression_l1",
    "l1": "regression_l1",
    "mae": "regression_l1",
    "multiclass": "multiclass",
    "softmax": "multiclass",
    "quantile": "quantile",
    "poisson": "poisson",
    "tweedie": "tweedie",
}


def is_lightgbm_text(s: str) -> bool:
    head = s.lstrip()[:64]
    return head.startswith("tree") and "Tree=" in s


def _parse_blocks(s: str) -> (Dict[str, str], List[Dict[str, str]]):
    header: Dict[str, str] = {}
    trees: List[Dict[str, str]] = []
    current = header
    for line in s.splitlines():
        line = line.strip()
        if not line or line in ("tree", "end of trees") \
                or line.startswith(("pandas_categorical", "parameters",
                                    "feature_importances")):
            continue
        if "=" not in line:
            if line == "average_output":  # rf marker: a bare header line
                header["average_output"] = "1"
            continue
        key, _, value = line.partition("=")
        if key == "Tree":
            current = {}
            trees.append(current)
            continue
        current[key] = value
    return header, trees


def _ints(v: str) -> np.ndarray:
    return np.array([int(x) for x in v.split()], dtype=np.int32)


def _floats(v: str) -> np.ndarray:
    return np.array([float(x) for x in v.split()], dtype=np.float64)


_BITS_PER_WORD = 32


def _bitset_values(words: np.ndarray) -> List[int]:
    """Category values whose bit is set in a LightGBM uint32 bitset."""
    out = []
    for wi, w in enumerate(words):
        w = int(w) & 0xFFFFFFFF
        for b in range(_BITS_PER_WORD):
            if w >> b & 1:
                out.append(wi * _BITS_PER_WORD + b)
    return out


def _convert_tree(blk: Dict[str, str], cat_width: Dict[int, int],
                  zero_features: set) -> Tree:
    """Build one :class:`Tree`; records per-feature categorical bitset
    widths in ``cat_width`` and Zero-missing features in
    ``zero_features`` (both shared across the file's trees)."""
    n_leaves = int(blk["num_leaves"])
    leaf_value = _floats(blk["leaf_value"])
    n_internal = n_leaves - 1
    n_nodes = n_internal + n_leaves

    feature = np.full(n_nodes, -1, np.int32)
    threshold = np.zeros(n_nodes, np.float64)
    missing_left = np.zeros(n_nodes, bool)
    categorical = np.zeros(n_nodes, bool)
    left = np.zeros(n_nodes, np.int32)
    right = np.zeros(n_nodes, np.int32)
    value = np.zeros(n_nodes, np.float32)
    value[n_internal:] = leaf_value.astype(np.float32)
    cat_left: Dict[int, List[int]] = {}   # node -> category values left

    if n_internal:
        split_feature = _ints(blk["split_feature"])
        thr = _floats(blk["threshold"])
        decision = _ints(blk["decision_type"])
        lc = _ints(blk["left_child"])
        rc = _ints(blk["right_child"])
        n_cat = int(blk.get("num_cat", "0"))
        cat_boundaries = (_ints(blk["cat_boundaries"]) if n_cat
                          else np.zeros(1, np.int32))
        cat_words = (np.array([int(x) for x in
                               blk["cat_threshold"].split()],
                              dtype=np.int64) if n_cat
                     else np.zeros(0, np.int64))

        def node_id(c: int) -> int:
            return c if c >= 0 else n_internal + (~c)

        for i in range(n_internal):
            feature[i] = split_feature[i]
            if decision[i] & 1:
                # categorical: threshold holds the index into
                # cat_boundaries; the bitset lists the values going LEFT.
                # Values beyond the bitset / negative / NaN go right —
                # LightGBM's CategoricalDecision — which the identity
                # level map reproduces via the missing bin (right).
                categorical[i] = True
                ci = int(thr[i])
                words = cat_words[cat_boundaries[ci]:cat_boundaries[ci + 1]]
                vals = _bitset_values(words)
                cat_left[i] = vals
                f = int(split_feature[i])
                width = len(words) * _BITS_PER_WORD
                cat_width[f] = max(cat_width.get(f, 0), width)
            else:
                missing_type = (int(decision[i]) >> 2) & 3
                threshold[i] = thr[i]
                if missing_type == 0:
                    # None: LightGBM coerces NaN to 0.0 at predict time,
                    # then applies the numerical rule — route NaN where
                    # 0.0 goes
                    missing_left[i] = bool(0.0 <= thr[i])
                elif missing_type == 1:
                    # Zero: |x| <= 1e-35 AND NaN are missing, routed to
                    # the default side; the booster pre-maps zeros to
                    # NaN on these features at predict time
                    zero_features.add(int(split_feature[i]))
                    missing_left[i] = bool(decision[i] & 2)
                else:  # NaN: missing goes to the default-left side
                    missing_left[i] = bool(decision[i] & 2)
            left[i] = node_id(int(lc[i]))
            right[i] = node_id(int(rc[i]))

    # cat_mask over bin space with the identity level map: value v is
    # bin v + 1 (bin 0 = missing/unseen, never in a left set => right)
    mask_width = 1 + max(cat_width.values(), default=0)
    cat_mask = np.zeros((n_nodes, max(mask_width, 1)), bool)
    for node, vals in cat_left.items():
        for v in vals:
            cat_mask[node, v + 1] = True

    return Tree(feature=feature, threshold=threshold,
                threshold_bin=np.zeros(n_nodes, np.int32),
                missing_left=missing_left,
                categorical=categorical,
                cat_mask=cat_mask,
                left=left, right=right, value=value,
                gain=np.zeros(n_nodes, np.float32), n_nodes=n_nodes)


def from_lightgbm_text(s: str, device=None):
    """Parse a LightGBM model dump into a scoring-ready :class:`Booster`
    on ``device``."""
    from mmlspark_tpu_torch.gbdt.booster import Booster, BoosterParams
    from mmlspark_tpu_torch.gbdt.objectives import get_objective, sigmoid

    header, blocks = _parse_blocks(s)
    obj_spec = header.get("objective", "regression").split()
    obj_name = _OBJECTIVE_MAP.get(obj_spec[0])
    if obj_name is None:
        raise ValueError(f"unsupported LightGBM objective {obj_spec[0]!r}")
    num_class = int(header.get("num_class", "1"))
    per_iter = int(header.get("num_tree_per_iteration", "1"))
    n_features = int(header["max_feature_idx"]) + 1
    names = header.get("feature_names", "").split() \
        or [f"f{j}" for j in range(n_features)]

    alpha, tweedie_p = 0.9, 1.5
    for tok in obj_spec[1:]:
        if tok.startswith("alpha:"):
            alpha = float(tok.split(":", 1)[1])
        elif tok.startswith("tweedie_variance_power:"):
            tweedie_p = float(tok.split(":", 1)[1])
    params = BoosterParams(objective=obj_name,
                           num_class=max(num_class, 2)
                           if obj_name == "multiclass" else 2,
                           alpha=alpha, tweedie_variance_power=tweedie_p,
                           boosting_type="rf" if "average_output" in header
                           else "gbdt")
    obj = get_objective(obj_name, max(num_class, 2), alpha, tweedie_p)
    k_sig = 1.0
    if obj_name == "binary":
        # the objective spec line carries the trained sigmoid coefficient,
        # e.g. "objective=binary sigmoid:1"; predict = 1/(1+exp(-k*raw))
        for tok in obj_spec[1:]:
            if tok.startswith("sigmoid:"):
                k_sig = float(tok.split(":", 1)[1])
        if k_sig != 1.0:
            obj = dataclasses.replace(
                obj, transform=lambda raw, k=k_sig: sigmoid(k * raw))
    cat_width: Dict[int, int] = {}
    zero_features: set = set()
    trees = [_convert_tree(b, cat_width, zero_features) for b in blocks]
    # identity level map for imported categorical features: category
    # value v <-> bin v + 1, so the trees' bitset masks index directly
    mapper = BinMapper(
        max_bin=255,
        upper_bounds=[np.zeros(0)] * n_features,
        categorical=[j in cat_width for j in range(n_features)],
        cat_levels={j: np.arange(w, dtype=np.float64)
                    for j, w in cat_width.items()})
    booster = Booster(params, mapper, obj, names, device=device)
    booster.init_score = np.zeros(obj.num_model_outputs)
    if obj_name == "binary":
        booster.lgbm_sigmoid = k_sig  # preserved on re-export
    booster.zero_missing_features = frozenset(zero_features)

    booster.trees = [trees[i:i + per_iter]
                     for i in range(0, len(trees), per_iter)]
    booster.best_iteration = len(booster.trees) - 1
    return booster


def _cat_left_values(tree: Tree, node: int, levels: np.ndarray) -> List[int]:
    """Nonneg-int category values routed left by ``node``'s cat_mask."""
    mask = tree.cat_mask[node]
    if mask.shape[0] > 0 and bool(mask[0]):
        raise NotImplementedError(
            "this categorical split routes MISSING left, which LightGBM's "
            "categorical decision cannot express (NaN always goes right "
            "there); use save_native_model(path, format='json') for "
            "exact persistence of this model")
    vals = []
    for b in np.flatnonzero(mask[1:1 + len(levels)]):
        v = float(levels[int(b)])
        if v < 0 or v != int(v):
            raise ValueError(
                f"categorical level {v!r} is not a nonnegative integer; "
                "LightGBM bitsets index categories by nonneg int value "
                "(the reference passes integer-coded categoricals "
                "straight through, `LightGBMBase.scala:54-58`)")
        vals.append(int(v))
    return vals


def _export_tree(tree: Tree, idx: int, init_shift: float,
                 cat_levels: Optional[Dict[int, np.ndarray]] = None,
                 zero_features: frozenset = frozenset()) -> str:
    """One ``Tree=`` block in LightGBM's node encoding (internal nodes
    indexed 0.., leaves referenced as ``~leaf_idx``)."""
    internal: List[int] = []
    leaves: List[int] = []
    order: List[int] = [0]
    while order:  # preorder: root gets internal index 0
        n = order.pop()
        if tree.feature[n] < 0:
            leaves.append(n)
        else:
            internal.append(n)
            order.append(int(tree.right[n]))
            order.append(int(tree.left[n]))
    int_idx = {n: i for i, n in enumerate(internal)}
    leaf_idx = {n: i for i, n in enumerate(leaves)}

    def child_ref(c: int) -> int:
        return int_idx[c] if tree.feature[c] >= 0 else ~leaf_idx[c]

    # categorical nodes: threshold = index into cat_boundaries; bitsets
    # of the LEFT category values, 32-bit words
    cat_boundaries = [0]
    cat_words: List[int] = []
    thr_str: List[str] = []
    dt: List[int] = []
    n_cat = 0
    for n in internal:
        f = int(tree.feature[n])
        if bool(tree.categorical[n]):
            levels = (cat_levels or {}).get(f, np.zeros(0))
            vals = _cat_left_values(tree, n, levels)
            width_words = (max(vals) // _BITS_PER_WORD + 1) if vals else 1
            words = [0] * width_words
            for v in vals:
                words[v // _BITS_PER_WORD] |= 1 << (v % _BITS_PER_WORD)
            cat_words.extend(words)
            cat_boundaries.append(cat_boundaries[-1] + width_words)
            thr_str.append(str(n_cat))
            n_cat += 1
            dt.append(1)
        else:
            thr_str.append(f"{float(tree.threshold[n]):.17g}")
            if f in zero_features:
                # preserve an imported Zero missing_type on re-export
                dt.append(4 | (2 if tree.missing_left[n] else 0))
            else:
                # bit1=default-left, bits 2-3 = missing_type NaN (2) —
                # our missing bin holds NaN
                dt.append(8 | (2 if tree.missing_left[n] else 0))

    lines = [f"Tree={idx}",
             f"num_leaves={len(leaves)}",
             f"num_cat={n_cat}"]
    if internal:
        lines += [
            "split_feature=" + " ".join(str(int(tree.feature[n]))
                                        for n in internal),
            "split_gain=" + " ".join(f"{float(tree.gain[n]):.17g}"
                                     for n in internal),
            "threshold=" + " ".join(thr_str),
            "decision_type=" + " ".join(str(d) for d in dt),
            "left_child=" + " ".join(str(child_ref(int(tree.left[n])))
                                     for n in internal),
            "right_child=" + " ".join(str(child_ref(int(tree.right[n])))
                                      for n in internal),
        ]
        if n_cat:
            lines += [
                "cat_boundaries=" + " ".join(str(b) for b in cat_boundaries),
                "cat_threshold=" + " ".join(str(w) for w in cat_words),
            ]
    lines += [
        "leaf_value=" + " ".join(f"{float(tree.value[n]) + init_shift:.17g}"
                                 for n in leaves),
        "shrinkage=1",
        "",
    ]
    return "\n".join(lines)


def to_lightgbm_text(booster) -> str:
    """Export a trained :class:`Booster` as a LightGBM text model dump.

    The reverse of :func:`from_lightgbm_text` — the reference's
    ``saveNativeModel`` direction (`LightGBMBooster.scala:104`): a model
    trained here can be loaded by LightGBM tooling (and by this
    importer). LightGBM files carry no separate init score, so the
    booster's init score is folded into the first tree's leaf values,
    exactly how LightGBM bakes boost-from-average into leaves.
    """
    params = booster.params
    obj = booster.obj
    K = obj.num_model_outputs
    sigmoid = getattr(booster, "lgbm_sigmoid", 1.0)
    spec = {
        "binary": f"binary sigmoid:{sigmoid:g}",
        "regression": "regression",
        "regression_l1": "regression_l1",
        "quantile": f"quantile alpha:{params.alpha}",
        "poisson": "poisson",
        "tweedie":
            f"tweedie tweedie_variance_power:{params.tweedie_variance_power}",
        "multiclass": f"multiclass num_class:{K}",
    }.get(obj.name)
    if spec is None:
        raise ValueError(f"objective {obj.name!r} has no LightGBM "
                         f"text-format spelling")
    n_features = len(booster.feature_names)
    head = [
        "tree",
        "version=v3",
        # rf boosters average tree outputs; LightGBM records this so
        # scoring sums become means on reload
        *(["average_output"] if params.boosting_type == "rf" else []),
        f"num_class={K if obj.name == 'multiclass' else 1}",
        f"num_tree_per_iteration={K}",
        "label_index=0",
        f"max_feature_idx={n_features - 1}",
        f"objective={spec}",
        "feature_names=" + " ".join(booster.feature_names),
        "feature_infos=" + " ".join(["none"] * n_features),
        "",
    ]
    init = np.asarray(booster.init_score, dtype=np.float64)
    # export only the trees predict() uses: early-stopped models must
    # reload (here or in LightGBM tooling) with identical predictions
    n_iters = (booster.best_iteration + 1
               if booster.best_iteration >= 0 else len(booster.trees))
    is_rf = params.boosting_type == "rf"
    cat_levels = booster.mapper.cat_levels or {}
    zero_features = frozenset(
        getattr(booster, "zero_missing_features", frozenset()))
    blocks = []
    for it, iter_trees in enumerate(booster.trees[:n_iters]):
        for k, tree in enumerate(iter_trees):
            # gbdt: fold the init score into the FIRST tree's leaves
            # (how LightGBM bakes boost-from-average); rf: scores are
            # AVERAGED, so the init must ride every tree to survive
            # the division
            shift = 0.0
            if k < len(init) and (is_rf or it == 0):
                shift = float(init[k])
            blocks.append(_export_tree(tree, it * K + k, shift,
                                       cat_levels, zero_features))
    return "\n".join(head) + "\n" + "\n".join(blocks) + "\nend of trees\n"
