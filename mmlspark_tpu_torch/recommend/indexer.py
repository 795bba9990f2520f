"""User/item string <-> contiguous-index codec for recommenders (the
port's copy of ``mmlspark_tpu/recommend/indexer.py``).

Parity: `recommendation/src/main/scala/RecommendationIndexer.scala:16`
(a two-column StringIndexer whose model can also invert predictions back
to original ids). Contiguous int32 indices are what lets the SAR math be
dense device matrices.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from mmlspark_tpu_torch.core.dataframe import DataFrame, obj_col, py_scalar
from mmlspark_tpu_torch.core.params import Param
from mmlspark_tpu_torch.core.stage import Estimator, Model


class RecommendationIndexer(Estimator):
    """Fit categorical maps for the user and item columns."""

    user_input_col = Param("user", "raw user id column")
    item_input_col = Param("item", "raw item id column")
    user_output_col = Param("user_idx", "indexed user column")
    item_output_col = Param("item_idx", "indexed item column")
    rating_col = Param(None, "optional rating column passed through")

    def fit(self, df: DataFrame) -> "RecommendationIndexerModel":
        users = sorted({py_scalar(v) for v in df[self.user_input_col]},
                       key=str)
        items = sorted({py_scalar(v) for v in df[self.item_input_col]},
                       key=str)
        return RecommendationIndexerModel(
            user_input_col=self.user_input_col,
            item_input_col=self.item_input_col,
            user_output_col=self.user_output_col,
            item_output_col=self.item_output_col,
            user_levels=users, item_levels=items)


class RecommendationIndexerModel(Model):
    user_input_col = Param("user", "raw user id column")
    item_input_col = Param("item", "raw item id column")
    user_output_col = Param("user_idx", "indexed user column")
    item_output_col = Param("item_idx", "indexed item column")
    user_levels = Param(None, "ordered distinct user ids", complex=True)
    item_levels = Param(None, "ordered distinct item ids", complex=True)

    def _lookup(self, levels: List, values) -> np.ndarray:
        table: Dict = {v: i for i, v in enumerate(levels)}
        out = np.empty(len(values), dtype=np.int32)
        for i, v in enumerate(values):
            v = py_scalar(v)
            if v not in table:
                raise KeyError(f"unseen id {v!r}")
            out[i] = table[v]
        return out

    def transform(self, df: DataFrame) -> DataFrame:
        out = df.with_column(
            self.user_output_col,
            self._lookup(self.user_levels, df[self.user_input_col]))
        out = out.with_column(
            self.item_output_col,
            self._lookup(self.item_levels, df[self.item_input_col]))
        return out

    def inverse_transform_items(self, df: DataFrame,
                                col: str) -> DataFrame:
        """Map an indexed item column (scalar or list per row) back to ids."""
        items = self.item_levels
        vals = []
        for v in df[col]:
            if np.ndim(v) > 0:
                vals.append([items[int(i)] for i in np.asarray(v).ravel()])
            else:
                vals.append(items[int(v)])
        return df.with_column(col, obj_col(vals))

    @property
    def num_users(self) -> int:
        return len(self.user_levels)

    @property
    def num_items(self) -> int:
        return len(self.item_levels)

    def _save_extra(self, path, arrays):
        arrays["user_levels"] = obj_col(self.user_levels)
        arrays["item_levels"] = obj_col(self.item_levels)

    def _load_extra(self, path, arrays):
        self.user_levels = [py_scalar(v) for v in arrays["user_levels"]]
        self.item_levels = [py_scalar(v) for v in arrays["item_levels"]]
