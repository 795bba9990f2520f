"""Pipeline stages: the image stages (``mmlspark_tpu/stages``'s image
names, less ``UnrollBinaryImage``, which waits for **the long tail**
with the rest of ``stages/``)."""

from mmlspark_tpu_torch.stages.image import (
    ImageTransformer, ResizeImageTransformer, UnrollImage,
    ImageSetAugmenter,
)

__all__ = ["ImageTransformer", "ResizeImageTransformer", "UnrollImage",
           "ImageSetAugmenter"]
