"""Image reading and host-side codecs (the port's copy of
``mmlspark_tpu/io/images.py``).

Capability parity with the reference's image FileFormat + ImageUtils
(`io/image/src/main/scala/PatchedImageFileFormat.scala:23`,
`ImageUtils.scala:25`): read a directory of images into rows, decode to
arrays, with subsampling and zip support inherited from the binary reader.

Decode/encode run host-side (PIL); all subsequent compute happens on
the stage's device via :mod:`mmlspark_tpu_torch.ops.image`. Framework
convention is RGB HWC uint8 (the reference stores OpenCV BGR; use
ops.image.swap_rb for BGR models).
"""

from __future__ import annotations

import io as _io
import os
from typing import Optional

import numpy as np

from mmlspark_tpu_torch.core.dataframe import DataFrame
from mmlspark_tpu_torch.io.binary import read_binary_files, PATH_COL, BYTES_COL

IMAGE_COL = "image"
IMAGE_EXTENSIONS = (".jpg", ".jpeg", ".png", ".bmp", ".gif", ".webp")


def decode_image(data: bytes) -> Optional[np.ndarray]:
    """Decode encoded bytes to RGB HWC uint8; None if undecodable."""
    from PIL import Image
    try:
        with Image.open(_io.BytesIO(data)) as img:
            return np.asarray(img.convert("RGB"), dtype=np.uint8)
    except Exception:
        return None


def encode_image(array: np.ndarray, format: str = "PNG") -> bytes:
    from PIL import Image
    arr = np.asarray(array)
    if arr.dtype != np.uint8:
        arr = np.clip(arr, 0, 255).astype(np.uint8)
    if arr.ndim == 3 and arr.shape[-1] == 1:
        arr = arr[..., 0]
    buf = _io.BytesIO()
    Image.fromarray(arr).save(buf, format=format)
    return buf.getvalue()


def read_images(path: str,
                recursive: bool = True,
                sample_ratio: float = 1.0,
                inspect_zip: bool = True,
                drop_invalid: bool = True,
                seed: int = 0) -> DataFrame:
    """Read images under ``path`` into ``path``/``image`` columns.

    ``image`` is an object column of RGB HWC uint8 arrays (shapes may
    differ per row; ImageTransformer shape-buckets before device work).
    Undecodable files become None rows unless ``drop_invalid``.
    """
    raw = read_binary_files(path, recursive=recursive,
                            sample_ratio=sample_ratio,
                            inspect_zip=inspect_zip, seed=seed)
    keep = [i for i, p in enumerate(raw[PATH_COL])
            if str(p).lower().endswith(IMAGE_EXTENSIONS)] if raw.num_rows else []
    raw = raw.take(keep)
    images = [decode_image(b) for b in raw[BYTES_COL]]
    df = DataFrame({
        PATH_COL: raw[PATH_COL],
        IMAGE_COL: np.array(images, dtype=object),
    })
    if drop_invalid:
        mask = np.array([im is not None for im in images], dtype=bool)
        df = df.filter(mask)
    return df
