"""SLIC superpixel clustering + superpixel utilities (the port's copy of
``mmlspark_tpu/explain/superpixel.py``).

Capability parity with `image-featurizer/src/main/scala/Superpixel.scala:141`
(SLIC clustering used by ImageLIME) and `SuperpixelTransformer`. The
reference clusters per image on the JVM; here the iterative assignment step
is vectorized numpy per image (images are small and cluster count is tiny;
the device's win in LIME comes from batching the *masked inference*, not the
segmentation).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from mmlspark_tpu_torch.core.dataframe import DataFrame, obj_col
from mmlspark_tpu_torch.core.params import (
    Param, HasInputCol, HasOutputCol, in_range,
)
from mmlspark_tpu_torch.core.stage import Transformer


def slic_segments(image: np.ndarray, cell_size: float = 16.0,
                  modifier: float = 130.0, max_iter: int = 10) -> np.ndarray:
    """SLIC: k-means over (l*color_weight, x, y) with grid-seeded centers.

    Returns an int32 (H, W) label map with contiguous labels [0, K).
    ``cell_size``/``modifier`` mirror the reference Superpixel params
    (`Superpixel.scala:141`): cell edge in pixels, and the color-vs-space
    tradeoff (higher modifier -> spatial proximity dominates).
    """
    img = np.asarray(image, dtype=np.float64)
    if img.ndim == 2:
        img = img[..., None]
    h, w, _ = img.shape
    step = max(int(round(cell_size)), 2)
    ys = np.arange(step // 2, h, step)
    xs = np.arange(step // 2, w, step)
    if len(ys) == 0:
        ys = np.array([h // 2])
    if len(xs) == 0:
        xs = np.array([w // 2])
    # color distance scaled relative to spatial distance (SLIC compactness):
    # dist = ||color||^2 * (modifier/cell)^2-ish; we follow the standard
    # formulation dist = d_color^2 + (d_xy * m / S)^2 with m=modifier/10.
    m = max(modifier, 1e-6) / 10.0
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    centers = []
    for cy in ys:
        for cx in xs:
            centers.append((img[cy, cx], float(cy), float(cx)))
    n_c = len(centers)
    c_color = np.stack([c[0] for c in centers])           # (K, C)
    c_pos = np.array([[c[1], c[2]] for c in centers])     # (K, 2)

    pix_color = img.reshape(-1, img.shape[-1])            # (HW, C)
    pix_pos = np.stack([yy.ravel(), xx.ravel()], axis=1).astype(np.float64)

    labels = np.zeros(h * w, dtype=np.int64)
    for _ in range(max_iter):
        # (HW, K) distances; images are small so the dense form is fine
        d_color = ((pix_color[:, None, :] - c_color[None]) ** 2).sum(-1)
        d_pos = ((pix_pos[:, None, :] - c_pos[None]) ** 2).sum(-1)
        dist = d_color + d_pos * (m / step) ** 2
        new_labels = dist.argmin(axis=1)
        if np.array_equal(new_labels, labels):
            break
        labels = new_labels
        for k in range(n_c):
            mask = labels == k
            if mask.any():
                c_color[k] = pix_color[mask].mean(axis=0)
                c_pos[k] = pix_pos[mask].mean(axis=0)
    # compact to contiguous labels
    uniq, labels = np.unique(labels, return_inverse=True)
    return labels.reshape(h, w).astype(np.int32)


def segment_masks(labels: np.ndarray) -> np.ndarray:
    """(K, H, W) boolean mask per superpixel from a label map."""
    k = int(labels.max()) + 1 if labels.size else 0
    return np.stack([labels == i for i in range(k)]) if k else \
        np.zeros((0,) + labels.shape, dtype=bool)


def apply_state(image: np.ndarray, labels: np.ndarray,
                state: np.ndarray, background: float = 0.0) -> np.ndarray:
    """Censor the superpixels whose ``state`` bit is off.

    Parity: Superpixel.scala's CensoredBufferedImage — off superpixels are
    replaced with ``background``.
    """
    keep = np.asarray(state, dtype=bool)[labels]          # (H, W)
    img = np.asarray(image, dtype=np.float32)
    if img.ndim == 3:
        keep = keep[..., None]
    return np.where(keep, img, np.float32(background))


class SuperpixelTransformer(Transformer, HasInputCol, HasOutputCol):
    """Attach a SLIC label map column for each image row.

    Parity: `image-featurizer` SuperpixelTransformer.
    """

    input_col = Param("image", "image column (HWC float arrays)")
    output_col = Param("superpixels", "label-map output column")
    cell_size = Param(16.0, "superpixel cell edge, px", in_range(lo=2))
    modifier = Param(130.0, "spatial-vs-color weight", in_range(lo=0))

    def transform(self, df: DataFrame) -> DataFrame:
        labels = [slic_segments(img, self.cell_size, self.modifier)
                  for img in df[self.input_col]]
        return df.with_column(self.output_col, obj_col(labels))
