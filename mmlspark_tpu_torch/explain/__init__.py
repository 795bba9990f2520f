"""Model interpretation: LIME (tabular + image) and SLIC superpixels
(``mmlspark_tpu/explain``'s names).

Capability parity with the interpretation half of `src/image-featurizer/`
(`LIME.scala`, `Superpixel.scala`): perturbed samples are scored in
batched calls of the explained model, and the per-row surrogate fits
are batched solves on the card.
"""

from mmlspark_tpu_torch.explain.superpixel import (
    SuperpixelTransformer, slic_segments, segment_masks, apply_state,
)
from mmlspark_tpu_torch.explain.lime import (
    LIMEBase, TabularLIME, TabularLIMEModel, ImageLIME, ImageLIMEModel,
    weighted_ridge_fits,
)

__all__ = [
    "SuperpixelTransformer", "slic_segments", "segment_masks", "apply_state",
    "LIMEBase", "TabularLIME", "TabularLIMEModel", "ImageLIME",
    "ImageLIMEModel", "weighted_ridge_fits",
]
