"""The I/O tail's device work on the card (``UnrollBinaryImage`` and the
image chain of ``examples/opencv_image_pipeline.py``), held against the
port's own CPU path on the same inputs, and a native read on the card's
machine.

Every test here is marked ``gpu`` and skips without a CUDA card; the
file imports nothing of JAX. Run it on the card with::

    MMLSPARK_TPU_TEST_TPU=1 python -m pytest tests/test_torch_io_tail_gpu.py

Device outputs are held within 1e-5 x max(1, max |ref|) of the CPU's
(f32, reassociation only).
"""

import zipfile

import numpy as np
import pytest
import torch

from mmlspark_tpu_torch.core.dataframe import DataFrame
from mmlspark_tpu_torch.io.binary import read_binary_files
from mmlspark_tpu_torch.io.images import (
    decode_image, encode_image, read_images,
)
from mmlspark_tpu_torch.stages import (
    ImageTransformer, UnrollBinaryImage, UnrollImage,
)

pytestmark = pytest.mark.gpu

TOL = 1e-5


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def err(got, ref) -> float:
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.abs(got - ref).max() / max(1.0, np.abs(ref).max()))


@pytest.fixture
def image_dir(tmp_path):
    """24 PNGs at sides 20-40, a third of them in a zip."""
    rng = np.random.default_rng(0)
    with zipfile.ZipFile(tmp_path / "z.zip", "w") as zf:
        for i in range(24):
            side = int(rng.integers(20, 40))
            data = encode_image(rng.integers(0, 256, (side, side, 3),
                                             dtype=np.uint8))
            if i % 3 == 0:
                zf.writestr(f"im{i:02d}.png", data)
            else:
                (tmp_path / f"im{i:02d}.png").write_bytes(data)
    return tmp_path


def test_native_read_equals_python(dev, image_dir):
    """The C++ reader builds on the card's machine and reads what the
    Python reader reads; ``read_images`` (``auto``, so the C++ reader)
    decodes those bytes."""
    nat = read_binary_files(str(image_dir), engine="native")
    py = read_binary_files(str(image_dir), engine="python")
    assert nat.num_rows == 24
    assert list(nat["path"]) == list(py["path"])
    assert list(nat["bytes"]) == list(py["bytes"])
    df = read_images(str(image_dir))
    assert list(df["path"]) == list(nat["path"])
    for a, b in zip(df["image"], nat["bytes"]):
        np.testing.assert_array_equal(a, decode_image(b))


def test_image_chain_on_the_card(dev, image_dir):
    df = read_images(str(image_dir))

    def chain(device):
        return (ImageTransformer(input_col="image", output_col="p",
                                 device=device)
                .resize(40, 40).center_crop(32, 32).gaussian_kernel(3, 1.0)
                .flip().normalize(mean=[127.5] * 3, std=[127.5] * 3))
    got = chain(None).transform(df)["p"]
    want = chain("cpu").transform(df)["p"]
    assert got.shape == (24, 32, 32, 3)
    assert err(got, want) <= TOL
    un = UnrollImage(input_col="p", output_col="f")
    a = un.copy(device=None).transform(DataFrame({"p": got}))["f"]
    b = un.copy(device="cpu").transform(DataFrame({"p": want}))["f"]
    assert a.shape == (24, 32 * 32 * 3) and err(a, b) <= TOL


@pytest.mark.parametrize("hw", [(None, None), (32, 32), (24, 40)])
def test_unroll_binary_image_on_the_card(dev, image_dir, hw):
    raw = read_binary_files(str(image_dir))
    if hw[0] is None:   # one shape: the rows must stack without a resize
        raw = read_binary_files(str(image_dir), pattern="*.png",
                                sample_ratio=1.0).head(1)
    h, w = hw
    got = UnrollBinaryImage(height=h, width=w).transform(raw)["features"]
    want = UnrollBinaryImage(height=h, width=w, device="cpu").transform(
        raw)["features"]
    assert np.isfinite(got).all() and err(got, want) <= TOL
