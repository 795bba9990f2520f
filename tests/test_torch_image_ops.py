"""The port's image ops and image stages (``mmlspark_tpu_torch``
``ops/image.py``, ``stages/image.py``) against the JAX package's on the
same numpy inputs, on the CPU.

Every op and stage is held at 1e-5 x max(1, max |ref|): f32 in both,
reassociation only (``resize`` contracts JAX's own weight matrices in
another order; the blurs sum a window in another order).
"""

import numpy as np
import pytest
import torch

from mmlspark_tpu.core.dataframe import DataFrame as JDF
from mmlspark_tpu.ops import image as JO
from mmlspark_tpu.stages import image as JS
from mmlspark_tpu_torch.core.dataframe import DataFrame as PDF
from mmlspark_tpu_torch.core.stage import PipelineStage
from mmlspark_tpu_torch.ops import image as PO
from mmlspark_tpu_torch.stages import (
    ImageSetAugmenter, ImageTransformer, ResizeImageTransformer, UnrollImage,
)

torch.set_num_threads(1)

TOL = 1e-5


def err(got, ref) -> float:
    got = np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.abs(got - ref).max() / max(1.0, np.abs(ref).max()))


def images(shape=(3, 12, 17, 3), seed=0) -> np.ndarray:
    return np.random.default_rng(seed).uniform(0, 255, shape).astype(
        np.float32)


def port(fn, x, *args, **kw) -> np.ndarray:
    return fn(torch.from_numpy(np.asarray(x)), *args, **kw).numpy()


METHODS = ["nearest", "linear", "bilinear", "cubic", "lanczos3", "lanczos5"]
SIZES = [(24, 34), (36, 51), (6, 8), (4, 5), (7, 23), (12, 17), (17, 9)]


@pytest.mark.parametrize("antialias", [True, False])
@pytest.mark.parametrize("method", METHODS)
def test_resize_matches_jax_at_up_down_and_odd_scales(method, antialias):
    x = images()
    for h, w in SIZES:
        ref = np.asarray(JO.resize(x, h, w, method, antialias))
        got = port(PO.resize, x, h, w, method, antialias)
        assert err(got, ref) <= TOL, (method, antialias, h, w)


def test_resize_of_one_image_and_of_uint8():
    x = images((12, 17, 3))
    assert err(port(PO.resize, x, 5, 30), JO.resize(x, 5, 30)) <= TOL
    u8 = x.astype(np.uint8)
    assert err(port(PO.resize, u8, 20, 9), JO.resize(u8, 20, 9)) <= TOL


def test_resize_weights_are_jaxs_matrix():
    from jax._src.image import scale as jscale
    for m, n in ((17, 5), (5, 17), (12, 12), (9, 4)):
        for method, kernel in (("linear", jscale._fill_triangle_kernel),
                               ("cubic", jscale._fill_keys_cubic_kernel)):
            for aa in (True, False):
                ref = np.asarray(jscale.compute_weight_mat(
                    m, n, n / m, 0.0, kernel, aa))
                got = PO.resize_weights(m, n, method, aa).numpy()
                assert err(got, ref) <= 1e-6, (m, n, method, aa)


def test_unknown_resize_method_raises():
    with pytest.raises(ValueError, match="Unknown resize method"):
        PO.resize(torch.zeros(1, 4, 4, 3), 2, 2, "area")


@pytest.mark.parametrize("args", [(2, 3, 5, 6), (0, 0, 12, 17),
                                  (10, 8, 9, 9)])
def test_crop_matches_jax(args):
    x = images()
    assert err(port(PO.crop, x, *args), JO.crop(x, *args)) == 0.0


@pytest.mark.parametrize("hw", [(5, 6), (12, 17), (20, 30), (1, 1)])
def test_center_crop_matches_jax(hw):
    x = images()
    assert err(port(PO.center_crop, x, *hw), JO.center_crop(x, *hw)) == 0.0


@pytest.mark.parametrize("code", [PO.FLIP_VERTICAL, PO.FLIP_HORIZONTAL,
                                  PO.FLIP_BOTH])
def test_flip_matches_jax(code):
    x = images()
    assert err(port(PO.flip, x, code), JO.flip(x, code)) == 0.0
    with pytest.raises(ValueError):
        PO.flip(torch.zeros(1, 2, 2, 1), 7)


@pytest.mark.parametrize("kh,kw", [(3, 3), (1, 5), (4, 2), (5, 5)])
def test_box_blur_matches_jax_at_the_borders(kh, kw):
    x = images()
    ref = np.asarray(JO.box_blur(x, kh, kw))
    got = port(PO.box_blur, x, kh, kw)
    assert err(got, ref) <= TOL
    # the border rows and columns, where the replicate pad decides
    for sl in (np.s_[:, :2], np.s_[:, -2:], np.s_[:, :, :2], np.s_[:, :, -2:]):
        assert err(got[sl], ref[sl]) <= TOL


@pytest.mark.parametrize("radius,sigma", [(1, 0.8), (2, 1.5), (3, 0.5)])
def test_gaussian_kernel_and_blur_match_jax(radius, sigma):
    x = images()
    assert err(PO.gaussian_kernel(radius, sigma).numpy(),
               JO.gaussian_kernel(radius, sigma)) <= 1e-6
    ref = np.asarray(JO.gaussian_blur(x, radius, sigma))
    got = port(PO.gaussian_blur, x, radius, sigma)
    assert err(got, ref) <= TOL
    assert err(got[:, :radius], ref[:, :radius]) <= TOL


def test_blur_keeps_a_constant_image_constant():
    x = torch.full((1, 6, 7, 2), 42.0)
    np.testing.assert_allclose(PO.box_blur(x, 3, 3).numpy(), 42.0,
                               rtol=1e-6)
    np.testing.assert_allclose(PO.gaussian_blur(x, 2, 1.0).numpy(), 42.0,
                               rtol=1e-6)


@pytest.mark.parametrize("mode", [PO.THRESH_BINARY, PO.THRESH_BINARY_INV,
                                  PO.THRESH_TRUNC, PO.THRESH_TOZERO,
                                  PO.THRESH_TOZERO_INV])
def test_threshold_modes_match_jax(mode):
    x = images()
    ref = np.asarray(JO.threshold(x, 100.5, 200.0, mode))
    got = PO.threshold(torch.from_numpy(x), 100.5, 200.0, mode)
    assert got.dtype == torch.float32 and ref.dtype == np.float32
    assert err(got.numpy(), ref) == 0.0
    u8 = x.astype(np.uint8)
    assert err(port(PO.threshold, u8, 100, 255.0, mode),
               JO.threshold(u8, 100, 255.0, mode)) == 0.0


def test_bad_threshold_mode_raises():
    with pytest.raises(ValueError):
        PO.threshold(torch.zeros(1, 2, 2, 1), 1.0, 2.0, 9)


@pytest.mark.parametrize("fmt", ["gray", "grayscale", "bgr", "swap_rb",
                                 "rgb", "identity"])
def test_color_formats_match_jax(fmt):
    x = images()
    assert err(port(PO.color_format, x, fmt),
               JO.color_format(x, fmt)) <= TOL
    with pytest.raises(ValueError):
        PO.color_format(torch.zeros(1, 2, 2, 3), "hsv")


def test_normalize_matches_jax():
    x = images()
    args = ([120.0, 110.5, 100.0], [50.0, 60.0, 70.5], 0.5)
    assert err(port(PO.normalize, x, *args), JO.normalize(x, *args)) <= TOL


def test_unroll_and_reroll_match_jax():
    x = images()
    ref = np.asarray(JO.unroll(x))
    got = port(PO.unroll, x)
    assert err(got, ref) == 0.0
    assert err(port(PO.unroll, x[0]), JO.unroll(x[0])) == 0.0
    back = PO.reroll(torch.from_numpy(got), 12, 17, 3).numpy()
    assert err(back, JO.reroll(ref, 12, 17, 3)) == 0.0
    np.testing.assert_array_equal(back, x)
    np.testing.assert_array_equal(
        PO.reroll(torch.from_numpy(got[0]), 12, 17, 3).numpy(), x[0])


def test_ops_refuse_a_flat_array():
    with pytest.raises(ValueError, match="HWC or NHWC"):
        PO.flip(torch.zeros(4, 4))


# -- stages -------------------------------------------------------------------

def chains():
    return [
        lambda t: t.resize(9, 11),
        lambda t: t.resize(24, 20).blur(3, 3).threshold(100.0),
        lambda t: t.crop(1, 2, 6, 7).flip(PO.FLIP_BOTH)
        .gaussian_kernel(1, 1.0),
        lambda t: t.center_crop(8, 8).color_format("gray")
        .normalize([100.0], [50.0], 1.0),
        lambda t: t.color_format("bgr").threshold(
            90.0, 180.0, PO.THRESH_TRUNC).resize(5, 5),
    ]


@pytest.mark.parametrize("i", range(5))
def test_image_transformer_on_a_stacked_column(i):
    x = images((4, 12, 17, 3), seed=i)
    build = chains()[i]
    ref = build(JS.ImageTransformer(input_col="im", output_col="out")) \
        .transform(JDF({"im": x}))["out"]
    got = build(ImageTransformer(input_col="im", output_col="out",
                                 device="cpu")).transform(
        PDF({"im": x}))["out"]
    assert isinstance(got, np.ndarray) and got.dtype == np.float32
    assert err(got, ref) <= TOL


@pytest.mark.parametrize("i", range(5))
def test_image_transformer_on_a_ragged_column(i):
    rng = np.random.default_rng(i)
    shapes = [(12, 17, 3), (10, 10, 3), (12, 17, 3), (15, 9, 3)]
    rows = [rng.uniform(0, 255, s).astype(np.float32) for s in shapes]

    def col():
        c = np.empty(len(rows), dtype=object)
        c[:] = rows
        return c
    build = chains()[i]
    ref = build(JS.ImageTransformer(input_col="im", output_col="out")) \
        .transform(JDF({"im": col()}))["out"]
    got = build(ImageTransformer(input_col="im", output_col="out",
                                 device="cpu")).transform(
        PDF({"im": col()}))["out"]
    assert got.dtype == ref.dtype
    for g, r in zip(got, ref):
        assert err(g, r) <= TOL


def test_resize_image_transformer_matches_jax():
    x = images((3, 20, 14, 3))
    ref = JS.ResizeImageTransformer(height=7, width=33).transform(
        JDF({"image": x}))["image"]
    got = ResizeImageTransformer(height=7, width=33, device="cpu") \
        .transform(PDF({"image": x}))["image"]
    assert err(got, ref) <= TOL


def test_unroll_image_matches_jax_stacked_and_ragged():
    x = images((3, 5, 6, 3))
    ref = JS.UnrollImage().transform(JDF({"image": x}))["features"]
    got = UnrollImage(device="cpu").transform(PDF({"image": x}))["features"]
    assert err(got, ref) == 0.0
    col = np.empty(3, dtype=object)
    col[:] = list(x)
    got = UnrollImage(device="cpu").transform(PDF({"image": col}))["features"]
    assert err(got, ref) == 0.0


@pytest.mark.parametrize("lr,ud", [(True, False), (True, True),
                                   (False, True), (False, False)])
def test_image_set_augmenter_matches_jax(lr, ud):
    x = images((2, 6, 5, 3))
    ref = JS.ImageSetAugmenter(output_col="aug", flip_left_right=lr,
                               flip_up_down=ud).transform(
        JDF({"image": x, "k": np.arange(2)}))
    got = ImageSetAugmenter(output_col="aug", flip_left_right=lr,
                            flip_up_down=ud, device="cpu").transform(
        PDF({"image": x, "k": np.arange(2)}))
    assert got.columns == ref.columns and got.num_rows == ref.num_rows
    assert err(got["aug"], ref["aug"]) == 0.0
    np.testing.assert_array_equal(got["k"], ref["k"])


def test_image_stages_round_trip(tmp_path):
    x = images((2, 12, 17, 3))
    df = PDF({"image": x})
    stages = [
        ImageTransformer(output_col="o", device="cpu").resize(6, 7)
        .blur(2, 2).normalize([1.0, 2.0, 3.0], [4.0, 5.0, 6.0]),
        ResizeImageTransformer(output_col="o", height=5, width=9,
                               device="cpu"),
        UnrollImage(output_col="o", device="cpu"),
        ImageSetAugmenter(output_col="o", flip_up_down=True, device="cpu"),
    ]
    for i, stage in enumerate(stages):
        path = str(tmp_path / f"s{i}")
        stage.save(path)
        loaded = PipelineStage.load(path, device="cpu")
        assert type(loaded) is type(stage) and loaded.device == "cpu"
        np.testing.assert_array_equal(loaded.transform(df)["o"],
                                      stage.transform(df)["o"])


def test_image_stages_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    df = PDF({"image": images((1, 4, 4, 3))})
    for stage in (ImageTransformer().flip(), UnrollImage(),
                  ResizeImageTransformer(height=2, width=2),
                  ImageSetAugmenter()):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            stage.transform(df)
