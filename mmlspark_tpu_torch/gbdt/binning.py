"""Quantile binning: raw features -> small integer bins.

The port's own copy of ``mmlspark_tpu/gbdt/binning.py`` (numpy only):
features are discretized once into at most ``max_bin`` quantile bins,
so tree growth only ever touches small integers. Bins are int32, and
the JSON form is the reference's, so a mapper written by either
package loads in the other.

NaN handling: missing values get dedicated bin 0; trees learn a default
direction for it like LightGBM's ``use_missing``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

MISSING_BIN = 0  # bin index reserved for NaN in every feature


@dataclasses.dataclass
class BinMapper:
    """Per-feature quantile bin edges + categorical level maps."""

    max_bin: int = 255
    upper_bounds: Optional[List[np.ndarray]] = None  # per feature, ascending
    categorical: Optional[List[bool]] = None
    cat_levels: Optional[Dict[int, np.ndarray]] = None  # feat -> level values

    @property
    def n_features(self) -> int:
        return len(self.upper_bounds or [])

    def n_bins(self, feature: int) -> int:
        if self.categorical[feature]:
            return len(self.cat_levels[feature]) + 1  # + missing bin
        # numeric values land in 1..len(bounds)+1 (searchsorted can return
        # len(bounds)), plus the missing bin 0
        return len(self.upper_bounds[feature]) + 2

    @property
    def max_bins_total(self) -> int:
        return max((self.n_bins(j) for j in range(self.n_features)), default=1)

    # -- fit ----------------------------------------------------------------

    def fit(self, X: np.ndarray,
            categorical_features: Sequence[int] = ()) -> "BinMapper":
        n, f = X.shape
        cats = set(int(c) for c in categorical_features)
        self.categorical = [j in cats for j in range(f)]
        self.upper_bounds = []
        self.cat_levels = {}
        for j in range(f):
            col = X[:, j].astype(np.float64)
            finite = col[~np.isnan(col)]
            if self.categorical[j]:
                levels = np.unique(finite)
                if len(levels) > self.max_bin - 1:
                    raise ValueError(
                        f"categorical feature {j} has {len(levels)} levels "
                        f"> max_bin-1={self.max_bin - 1}")
                self.cat_levels[j] = levels
                self.upper_bounds.append(np.zeros(0))
                continue
            uniq = np.unique(finite)
            if len(uniq) <= self.max_bin - 1:
                # one bin per distinct value; boundaries at midpoints
                bounds = (uniq[:-1] + uniq[1:]) / 2.0 if len(uniq) > 1 \
                    else np.zeros(0)
            else:
                qs = np.quantile(finite,
                                 np.linspace(0, 1, self.max_bin)[1:-1])
                bounds = np.unique(qs)
            self.upper_bounds.append(bounds.astype(np.float64))
        return self

    # -- transform ----------------------------------------------------------

    def transform(self, X: np.ndarray) -> np.ndarray:
        """Raw (n, F) floats -> (n, F) int32 bins (0 = missing)."""
        n, f = X.shape
        out = np.zeros((n, f), dtype=np.int32)
        for j in range(f):
            col = X[:, j].astype(np.float64)
            nan = np.isnan(col)
            if self.categorical[j]:
                idx = np.searchsorted(self.cat_levels[j], col)
                idx = np.clip(idx, 0, len(self.cat_levels[j]) - 1)
                hit = ~nan & (self.cat_levels[j][idx] == col)
                # unseen levels -> missing bin (consistent with LightGBM's
                # other-category handling at predict time)
                out[:, j] = np.where(hit, idx + 1, MISSING_BIN)
            else:
                bins = np.searchsorted(self.upper_bounds[j], col, side="left")
                out[:, j] = np.where(nan, MISSING_BIN, bins + 1)
        return out

    def threshold_value(self, feature: int, threshold_bin: int) -> float:
        """Raw-value threshold for 'bin <= threshold_bin' numeric splits."""
        bounds = self.upper_bounds[feature]
        b = int(threshold_bin) - 1  # shift for missing bin
        if b < 0:
            return -np.inf
        if b >= len(bounds):
            return np.inf
        return float(bounds[b])

    # -- persistence --------------------------------------------------------

    def to_json(self) -> Dict[str, Any]:
        return {
            "max_bin": self.max_bin,
            "upper_bounds": [b.tolist() for b in self.upper_bounds],
            "categorical": list(self.categorical),
            "cat_levels": {str(k): v.tolist() for k, v in self.cat_levels.items()},
        }

    @staticmethod
    def from_json(d: Dict[str, Any]) -> "BinMapper":
        return BinMapper(
            max_bin=d["max_bin"],
            upper_bounds=[np.asarray(b, dtype=np.float64)
                          for b in d["upper_bounds"]],
            categorical=list(d["categorical"]),
            cat_levels={int(k): np.asarray(v, dtype=np.float64)
                        for k, v in d["cat_levels"].items()},
        )
