"""Image pipeline stages: the OpenCV-Transformer replacement.

The port of ``mmlspark_tpu/stages/image.py``. Rows are bucketed by
image shape, each bucket is stacked into an NHWC batch and pushed
through the op chain of :mod:`mmlspark_tpu_torch.ops.image` in one call
on the stage's device (the card unless ``device="cpu"``), then
scattered back to rows; columns come back as numpy, as in JAX.
``UnrollBinaryImage`` decodes on the host (``io/images``, PIL), then
resizes and unrolls on the stage's device.

Capability parity with `image-transformer/src/main/scala/
ImageTransformer.scala` (stage-list transformer), `ResizeImageTransformer.
scala`, `UnrollImage.scala`, and `ImageSetAugmenter.scala`.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from mmlspark_tpu_torch.core.dataframe import DataFrame
from mmlspark_tpu_torch.core.environment import resolve_device
from mmlspark_tpu_torch.core.params import (
    HasDevice, HasInputCol, HasOutputCol, Param,
)
from mmlspark_tpu_torch.core.stage import Transformer
from mmlspark_tpu_torch.ops import image as ops


def _bucket_by_shape(images: Sequence[np.ndarray]
                     ) -> Dict[Tuple[int, ...], List[int]]:
    buckets: Dict[Tuple[int, ...], List[int]] = {}
    for i, im in enumerate(images):
        buckets.setdefault(tuple(np.asarray(im).shape), []).append(i)
    return buckets


def _on_device(fn: Callable[[torch.Tensor], torch.Tensor],
               batch: np.ndarray, device: torch.device) -> np.ndarray:
    """One call of ``fn`` on a stacked f32 batch, on ``device``."""
    x = torch.from_numpy(np.ascontiguousarray(batch, np.float32))
    with torch.no_grad():
        return fn(x.to(device)).cpu().numpy()


def _apply_bucketed(images: Sequence[np.ndarray],
                    fn: Callable[[torch.Tensor], torch.Tensor],
                    device: torch.device) -> List[np.ndarray]:
    """Stack same-shape rows, run one call per shape, scatter back."""
    out: List[Optional[np.ndarray]] = [None] * len(images)
    for shape, idxs in _bucket_by_shape(images).items():
        batch = np.stack([np.asarray(images[i], dtype=np.float32)
                          for i in idxs])
        result = _on_device(fn, batch, device)
        for j, i in enumerate(idxs):
            out[i] = result[j]
    return out  # type: ignore[return-value]


class ImageTransformer(Transformer, HasInputCol, HasOutputCol, HasDevice):
    """Applies a configured chain of image ops to an image column.

    Fluent stage list mirroring the reference API::

        ImageTransformer().resize(32, 32).flip().normalize(...)

    Parity: ImageTransformer.scala:22-207,237,266.
    """

    input_col = Param("image", "image column", ptype=str)
    output_col = Param("image", "output column", ptype=str)
    stages = Param(None, "list of (op, kwargs) image stages", ptype=list)

    def _stages(self) -> List[Tuple[str, Dict[str, Any]]]:
        return list(self.stages or [])

    def _add(self, op: str, **kwargs) -> "ImageTransformer":
        self.stages = self._stages() + [(op, kwargs)]
        return self

    # fluent builders (names mirror the reference's stage names)
    def resize(self, height: int, width: int) -> "ImageTransformer":
        return self._add("resize", height=height, width=width)

    def crop(self, x: int, y: int, height: int, width: int
             ) -> "ImageTransformer":
        return self._add("crop", x0=x, y0=y, height=height, width=width)

    def center_crop(self, height: int, width: int) -> "ImageTransformer":
        return self._add("center_crop", height=height, width=width)

    def color_format(self, fmt: str) -> "ImageTransformer":
        return self._add("color_format", fmt=fmt)

    def blur(self, height: int, width: int) -> "ImageTransformer":
        return self._add("box_blur", kh=int(height), kw=int(width))

    def threshold(self, threshold: float, max_val: float = 255.0,
                  threshold_type: int = ops.THRESH_BINARY
                  ) -> "ImageTransformer":
        return self._add("threshold", thresh=threshold, max_val=max_val,
                         threshold_type=threshold_type)

    def gaussian_kernel(self, apperture_size: int, sigma: float
                        ) -> "ImageTransformer":
        return self._add("gaussian_blur", radius=int(apperture_size),
                         sigma=sigma)

    def flip(self, flip_code: int = ops.FLIP_HORIZONTAL
             ) -> "ImageTransformer":
        return self._add("flip", flip_code=flip_code)

    def normalize(self, mean: Sequence[float], std: Sequence[float],
                  scale: float = 1.0) -> "ImageTransformer":
        return self._add("normalize", mean=list(mean), std=list(std),
                         scale=scale)

    # execution: each stage's op is looked up in ops/image by name when
    # the chain runs
    _OPS = ("resize", "crop", "center_crop", "color_format", "box_blur",
            "threshold", "gaussian_blur", "flip", "normalize")

    def _chain(self) -> Callable[[torch.Tensor], torch.Tensor]:
        stages = self._stages()
        for op, _ in stages:
            if op not in self._OPS:
                raise ValueError(f"unknown image op {op!r}")

        def apply(batch):
            for op, kwargs in stages:
                batch = getattr(ops, op)(batch, **kwargs)
            return batch
        return apply

    def transform(self, df: DataFrame) -> DataFrame:
        dev = resolve_device(self.device)
        col = df[self.input_col]
        if col.dtype == np.dtype("O"):
            out = _apply_bucketed(list(col), self._chain(), dev)
            shapes = {o.shape for o in out}
            if len(shapes) == 1:
                return df.with_column(self.output_col, np.stack(out))
            return df.with_column(self.output_col,
                                  np.array(out, dtype=object))
        # already a stacked NHWC tensor column: one call
        return df.with_column(self.output_col,
                              _on_device(self._chain(), col, dev))


class ResizeImageTransformer(Transformer, HasInputCol, HasOutputCol,
                             HasDevice):
    """Resize-only transformer (parity: ResizeImageTransformer.scala:17,54)."""

    input_col = Param("image", "image column", ptype=str)
    output_col = Param("image", "output column", ptype=str)
    height = Param(None, "target height", ptype=int)
    width = Param(None, "target width", ptype=int)

    def transform(self, df: DataFrame) -> DataFrame:
        return ImageTransformer(
            input_col=self.input_col, output_col=self.output_col,
            device=self.device,
        ).resize(self.height, self.width).transform(df)


class UnrollImage(Transformer, HasInputCol, HasOutputCol, HasDevice):
    """Image column -> flat CHW feature-vector column.

    Parity: UnrollImage.scala:21,25,84 (CHW unroll to DenseVector).
    """

    input_col = Param("image", "image column", ptype=str)
    output_col = Param("features", "output vector column", ptype=str)

    def transform(self, df: DataFrame) -> DataFrame:
        col = df[self.input_col]
        if col.dtype == np.dtype("O"):
            col = np.stack([np.asarray(v, dtype=np.float32) for v in col])
        out = _on_device(ops.unroll, col, resolve_device(self.device))
        return df.with_column(self.output_col, out)


class UnrollBinaryImage(Transformer, HasInputCol, HasOutputCol, HasDevice):
    """Encoded image bytes -> flat CHW vector, decoding host-side, then
    resizing and unrolling on the stage's device.

    Parity: UnrollBinaryImage (UnrollImage.scala:122).
    """

    input_col = Param("bytes", "binary image column", ptype=str)
    output_col = Param("features", "output vector column", ptype=str)
    height = Param(None, "optional resize height", ptype=int)
    width = Param(None, "optional resize width", ptype=int)

    def transform(self, df: DataFrame) -> DataFrame:
        from mmlspark_tpu_torch.io.images import decode_image
        images = [decode_image(b) for b in df[self.input_col]]
        bad = [i for i, im in enumerate(images) if im is None]
        if bad:
            raise ValueError(f"undecodable images at rows {bad[:10]}")
        work = df.with_column("__img", np.array(images, dtype=object))
        if self.height is not None and self.width is not None:
            work = ResizeImageTransformer(
                input_col="__img", output_col="__img", height=self.height,
                width=self.width, device=self.device).transform(work)
        out = UnrollImage(input_col="__img", output_col=self.output_col,
                          device=self.device).transform(work)
        return out.drop("__img")


class ImageSetAugmenter(Transformer, HasInputCol, HasOutputCol, HasDevice):
    """Expand a dataset with flipped copies (parity:
    ImageSetAugmenter.scala)."""

    input_col = Param("image", "image column", ptype=str)
    output_col = Param("image", "output column", ptype=str)
    flip_left_right = Param(True, "add horizontally flipped copies",
                            ptype=bool)
    flip_up_down = Param(False, "add vertically flipped copies", ptype=bool)

    def transform(self, df: DataFrame) -> DataFrame:
        base = df if self.input_col == self.output_col else \
            df.with_column(self.output_col, df[self.input_col])
        frames = [base]
        for enabled, code in ((self.flip_left_right, ops.FLIP_HORIZONTAL),
                              (self.flip_up_down, ops.FLIP_VERTICAL)):
            if enabled:
                flipper = ImageTransformer(
                    input_col=self.input_col, output_col=self.output_col,
                    device=self.device).flip(code)
                frames.append(flipper.transform(df))
        return DataFrame.concat(frames)
