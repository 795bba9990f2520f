"""The port's image reading and codec (``mmlspark_tpu_torch/io/images.py``)
and ``UnrollBinaryImage`` against the JAX package's, on the CPU.

Both packages decode and encode through PIL: the codec's outputs must be
equal byte for byte and pixel for pixel, on PNGs that PIL writes in each
colour type (gray, RGB, palette with and without ``tRNS``, gray with
alpha, RGBA) and on BMPs; undecodable or truncated bytes give ``None``;
``decode_image(encode_image(x)) == x`` in both packages' decoders.
``read_images`` gives JAX's paths and arrays with and without the C++
reader.
``UnrollBinaryImage`` resizes on the stage's device: within 1e-5 x
max(1, max |ref|) of JAX's (f32, reassociation only).
"""

import io
import zipfile

import numpy as np
import pytest
import torch
from PIL import Image

from mmlspark_tpu.core.dataframe import DataFrame as JDF
from mmlspark_tpu.io import images as JI
from mmlspark_tpu.stages.image import UnrollBinaryImage as JUnroll
from mmlspark_tpu_torch.core.dataframe import DataFrame
from mmlspark_tpu_torch.core.stage import PipelineStage
from mmlspark_tpu_torch.io import images as PI
from mmlspark_tpu_torch.io.binary import read_binary_files
from mmlspark_tpu_torch.stages import UnrollBinaryImage

torch.set_num_threads(1)

TOL = 1e-5


def err(got, ref) -> float:
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.abs(got - ref).max() / max(1.0, np.abs(ref).max()))


def pil_bytes(mode: str, size=(13, 9), seed=0, fmt="PNG", **save) -> bytes:
    """An image PIL writes in ``mode`` (a palette image gets 16 colours,
    and ``transparency`` puts a ``tRNS`` chunk in the PNG)."""
    rng = np.random.default_rng(seed)
    w, h = size
    if mode == "P":
        img = Image.fromarray(rng.integers(0, 16, (h, w), dtype=np.uint8),
                              "P")
        img.putpalette(rng.integers(0, 256, 48, dtype=np.uint8).tolist())
    else:
        bands = len(mode)
        arr = rng.integers(0, 256, (h, w, bands), dtype=np.uint8)
        img = Image.fromarray(arr[..., 0] if bands == 1 else arr, mode)
    buf = io.BytesIO()
    img.save(buf, format=fmt, **save)
    return buf.getvalue()


CODEC_INPUTS = {
    "gray": pil_bytes("L"),
    "rgb": pil_bytes("RGB"),
    "palette": pil_bytes("P"),
    "palette_trns_index": pil_bytes("P", transparency=3),
    "palette_trns_table": pil_bytes("P",
                                    transparency=bytes(range(0, 256, 16))),
    "gray_alpha": pil_bytes("LA"),
    "rgba": pil_bytes("RGBA"),
    "gray_trns": pil_bytes("L", transparency=7),
    "rgb_trns": pil_bytes("RGB", transparency=(1, 2, 3)),
    "interlaced": pil_bytes("RGB", interlace=1),
    "bmp24": pil_bytes("RGB", fmt="BMP"),
    "bmp32": pil_bytes("RGBA", fmt="BMP"),
    "bmp_gray": pil_bytes("L", fmt="BMP"),
    "jpeg": pil_bytes("RGB", fmt="JPEG", quality=90),
    "gif": pil_bytes("P", fmt="GIF"),
}


@pytest.mark.parametrize("name", sorted(CODEC_INPUTS))
def test_decode_matches_jax(name):
    data = CODEC_INPUTS[name]
    got, want = PI.decode_image(data), JI.decode_image(data)
    assert got.dtype == np.uint8 and got.shape == (9, 13, 3)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("data", [
    b"", b"not an image", CODEC_INPUTS["rgb"][:40],
    CODEC_INPUTS["rgb"][:len(CODEC_INPUTS["rgb"]) // 2],
    CODEC_INPUTS["bmp24"][:30], b"\x89PNG\r\n\x1a\n" + b"\x00" * 30],
    ids=["empty", "text", "png_header_only", "png_half", "bmp_header",
         "png_signature_zeros"])
def test_undecodable_bytes_give_none(data):
    assert PI.decode_image(data) is None
    assert JI.decode_image(data) is None


@pytest.mark.parametrize("shape,dtype", [
    ((9, 13, 3), np.uint8), ((9, 13), np.uint8), ((9, 13, 1), np.uint8),
    ((5, 4, 3), np.float32), ((1, 1, 3), np.uint8)])
@pytest.mark.parametrize("fmt", ["PNG", "BMP"])
def test_encode_matches_jax_and_round_trips(shape, dtype, fmt):
    rng = np.random.default_rng(1)
    x = rng.uniform(-20, 280, shape).astype(dtype) if dtype != np.uint8 \
        else rng.integers(0, 256, shape, dtype=np.uint8)
    data = PI.encode_image(x, format=fmt)
    assert data == JI.encode_image(x, format=fmt)
    want = np.clip(x, 0, 255).astype(np.uint8)
    if want.ndim == 3 and want.shape[-1] == 1:
        want = want[..., 0]
    if want.ndim == 2:
        want = np.repeat(want[..., None], 3, axis=-1)
    for decode in (PI.decode_image, JI.decode_image):
        np.testing.assert_array_equal(decode(data), want)


def test_constants_are_jaxs():
    assert PI.IMAGE_COL == JI.IMAGE_COL == "image"
    assert PI.IMAGE_EXTENSIONS == JI.IMAGE_EXTENSIONS


@pytest.fixture
def image_dir(tmp_path):
    """PNGs of assorted sizes in nested dirs, a zip holding more, a BMP,
    a text file (not an image) and a .png that does not decode."""
    rng = np.random.default_rng(5)
    (tmp_path / "sub").mkdir()
    for i in range(12):
        side = int(rng.integers(8, 20))
        x = rng.integers(0, 256, (side, side + i % 3, 3), dtype=np.uint8)
        where = tmp_path / ("sub" if i % 2 else ".") / f"im{i:02d}.png"
        where.write_bytes(PI.encode_image(x))
    with zipfile.ZipFile(tmp_path / "more.zip", "w") as zf:
        for i in range(4):
            zf.writestr(f"z{i}.PNG", PI.encode_image(
                rng.integers(0, 256, (6, 7), dtype=np.uint8)))
        zf.writestr("notes.txt", b"text")
    (tmp_path / "b.bmp").write_bytes(CODEC_INPUTS["bmp24"])
    (tmp_path / "readme.txt").write_bytes(b"not an image")
    (tmp_path / "broken.png").write_bytes(b"\x89PNG broken")
    return tmp_path


def same_images(got, want):
    assert got.columns == want.columns == ["path", "image"]
    assert list(got["path"]) == list(want["path"])
    for a, b in zip(got["image"], want["image"]):
        if b is None:
            assert a is None
        else:
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("reader", ["built", "unbuilt"])
@pytest.mark.parametrize("kw", [{}, {"drop_invalid": False},
                                {"recursive": False},
                                {"sample_ratio": 0.5, "seed": 3},
                                {"inspect_zip": False}])
def test_read_images_matches_jax(image_dir, reader, kw, monkeypatch):
    """``read_images`` reads through ``read_binary_files``' ``auto``:
    the C++ reader where it builds, else (``unbuilt``: both packages'
    loaders hold a failed build) the Python reader."""
    if reader == "unbuilt":
        from mmlspark_tpu.native import loader as jax_loader
        from mmlspark_tpu_torch.native import loader as port_loader
        for loader in (port_loader, jax_loader):
            monkeypatch.setitem(loader._cache, "mmlbinary",
                                RuntimeError("no g++"))
    got = PI.read_images(str(image_dir), **kw)
    same_images(got, JI.read_images(str(image_dir), **kw))
    if not kw:
        assert got.num_rows == 12 + 4 + 1
    if kw.get("drop_invalid") is False:
        assert sum(im is None for im in got["image"]) == 1


def test_read_images_default_engine_is_jaxs(image_dir):
    kw = {"sample_ratio": 0.6, "seed": 11}
    same_images(PI.read_images(str(image_dir), **kw),
                JI.read_images(str(image_dir), **kw))


def test_read_images_exported():
    from mmlspark_tpu_torch import io as pio
    assert pio.read_images is PI.read_images
    assert pio.decode_image is PI.decode_image
    assert pio.encode_image is PI.encode_image


def _bytes_frame(frame, sizes, seed=2, col="bytes"):
    rng = np.random.default_rng(seed)
    blobs = [PI.encode_image(rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
             for h, w in sizes]
    cells = np.empty(len(blobs), dtype=object)
    cells[:] = blobs
    return frame({col: cells, "id": np.arange(len(blobs))})


@pytest.mark.parametrize("sizes,hw", [
    ([(16, 16)] * 3, (None, None)),
    ([(16, 16), (20, 11), (16, 16), (9, 30)], (12, 10)),
    ([(32, 32)] * 2, (48, 40)),
])
def test_unroll_binary_image_matches_jax(sizes, hw):
    h, w = hw
    got = UnrollBinaryImage(height=h, width=w, device="cpu").transform(
        _bytes_frame(DataFrame, sizes))
    want = JUnroll(height=h, width=w).transform(_bytes_frame(JDF, sizes))
    assert got.columns == want.columns == ["bytes", "id", "features"]
    assert got["features"].dtype == np.float32
    assert err(got["features"], want["features"]) <= TOL


def test_unroll_binary_image_over_read_binary_files(image_dir):
    raw = read_binary_files(str(image_dir), pattern="im*.png")
    got = UnrollBinaryImage(height=8, width=8, device="cpu").transform(raw)
    from mmlspark_tpu.io.binary import read_binary_files as jax_read
    want = JUnroll(height=8, width=8).transform(
        jax_read(str(image_dir), pattern="im*.png"))
    assert got["features"].shape == (12, 8 * 8 * 3)
    assert err(got["features"], want["features"]) <= TOL


def test_unroll_binary_image_refuses_undecodable_rows():
    for stage, frame in ((UnrollBinaryImage(device="cpu"), DataFrame),
                         (JUnroll(), JDF)):
        df = _bytes_frame(frame, [(8, 8)])
        bad = np.empty(2, dtype=object)
        bad[:] = [df["bytes"][0], b"junk"]
        with pytest.raises(ValueError, match=r"rows \[1\]"):
            stage.transform(frame({"bytes": bad}))


def test_unroll_binary_image_params_and_persistence(tmp_path):
    assert sorted(UnrollBinaryImage.params()) == sorted(
        [*JUnroll.params(), "device"])
    for k, p in JUnroll.params().items():
        assert UnrollBinaryImage.params()[k].default == p.default
    stage = UnrollBinaryImage(input_col="b", output_col="f", height=6,
                              width=5, device="cpu")
    stage.save(str(tmp_path / "u"))
    loaded = PipelineStage.load(str(tmp_path / "u"), device="cpu")
    assert type(loaded) is UnrollBinaryImage and loaded.device == "cpu"
    assert (loaded.height, loaded.width, loaded.input_col) == (6, 5, "b")
    df = _bytes_frame(DataFrame, [(9, 9), (7, 12)], col="b")
    np.testing.assert_array_equal(loaded.transform(df)["f"],
                                  stage.transform(df)["f"])


@pytest.mark.skipif(torch.cuda.is_available(), reason="CUDA present")
def test_unroll_binary_image_takes_the_card_by_default():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        UnrollBinaryImage().transform(_bytes_frame(DataFrame, [(8, 8)]))
