"""The port's interpretation modules (``mmlspark_tpu_torch/explain/``)
against the JAX package's, on the CPU.

* SLIC, the masks and ``apply_state`` are host numpy: equal.
* ``weighted_ridge_fits`` solves the same f32 normal equations as JAX's
  vmapped ``jnp.linalg.solve`` (x64 off), batched with
  ``torch.linalg.solve`` on the stage's device (``"cpu"`` here): within
  1e-4 x max(1, |ref|) (f32 products and LU in another order).
* ``TabularLIME`` and ``ImageLIME`` draw their perturbations from the
  same numpy stream in both packages; over a host scorer, a GBDT model
  (JAX's model string loaded into the port's stage) and a network
  (``NNFunction`` weights bridged as numpy): the coefficients within
  1e-4 x max(1, |ref|), the superpixels equal. ``TabularLIMEModel``
  takes the JAX model's ``feature_means`` and ``feature_stds``.

The classes of ``tests/test_explain.py`` are mirrored on the port.
"""

import jax
import numpy as np
import pytest
import torch

from mmlspark_tpu.core.dataframe import DataFrame as JDF
from mmlspark_tpu.core.params import Param as JParam
from mmlspark_tpu.core.stage import Transformer as JTransformer
from mmlspark_tpu.explain import lime as JL
from mmlspark_tpu.explain import superpixel as JSP
from mmlspark_tpu.gbdt import stages as JG
from mmlspark_tpu.models.function import NNFunction as JF
from mmlspark_tpu.models.nn import NNModel as JNN
from mmlspark_tpu_torch.core.dataframe import DataFrame
from mmlspark_tpu_torch.core.params import Param
from mmlspark_tpu_torch.core.stage import PipelineStage, Transformer
from mmlspark_tpu_torch.explain import (
    SuperpixelTransformer, slic_segments, segment_masks, apply_state,
    TabularLIME, TabularLIMEModel, ImageLIME, weighted_ridge_fits,
)
from mmlspark_tpu_torch.gbdt import Booster
from mmlspark_tpu_torch.gbdt import stages as PG
from mmlspark_tpu_torch.models.function import NNFunction as PF
from mmlspark_tpu_torch.models.nn import NNModel

torch.set_num_threads(1)

#: coefficients and solves against JAX: x max(1, |ref|)
COEF_TOL = 1e-4


def scaled_err(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float((np.abs(got - ref) / np.maximum(1.0, np.abs(ref))).max())


class LinearScorer(Transformer):
    """Deterministic model: score = x @ beta (vector input)."""

    input_col = Param("features", "in")
    beta = Param(None, "weights", complex=True)

    def transform(self, df):
        X = np.stack([np.asarray(v, dtype=np.float64)
                      for v in df[self.input_col]])
        return df.with_column("scores", X @ np.asarray(self.beta))

    def _save_extra(self, path, arrays):
        arrays["beta"] = np.asarray(self.beta)

    def _load_extra(self, path, arrays):
        self.beta = arrays["beta"]


class PatchScorer(Transformer):
    """Image model: score = mean brightness of the top-left quadrant."""

    input_col = Param("image", "in")

    def transform(self, df):
        scores = []
        for img in df[self.input_col]:
            img = np.asarray(img, dtype=np.float64)
            h, w = img.shape[:2]
            scores.append(img[: h // 2, : w // 2].mean())
        return df.with_column("scores", np.asarray(scores))


class JLinearScorer(JTransformer):
    """``LinearScorer`` on the JAX package's stage classes."""

    input_col = JParam("features", "in")
    beta = JParam(None, "weights", complex=True)

    def transform(self, df):
        X = np.stack([np.asarray(v, dtype=np.float64)
                      for v in df[self.input_col]])
        return df.with_column("scores", X @ np.asarray(self.beta))


class JPatchScorer(JTransformer):
    input_col = JParam("image", "in")

    def transform(self, df):
        return df.with_column("scores", np.asarray(
            [np.asarray(i, np.float64)[: i.shape[0] // 2,
                                       : i.shape[1] // 2].mean()
             for i in df[self.input_col]]))


# -- tests/test_explain.py, on the port --------------------------------------

class TestSlic:
    def test_label_map_shape_and_contiguity(self):
        img = np.random.default_rng(0).random((32, 32, 3)).astype(np.float32)
        labels = slic_segments(img, cell_size=8)
        assert labels.shape == (32, 32)
        uniq = np.unique(labels)
        assert uniq[0] == 0 and uniq[-1] == len(uniq) - 1
        assert 4 <= len(uniq) <= 32

    def test_segments_respect_color_blocks(self):
        img = np.zeros((16, 16, 3), dtype=np.float32)
        img[:, 8:] = 1.0
        labels = slic_segments(img, cell_size=8, modifier=10.0)
        left = set(np.unique(labels[:, :7]))
        right = set(np.unique(labels[:, 9:]))
        assert not left & right

    def test_masks_and_apply_state(self):
        img = np.ones((8, 8, 3), dtype=np.float32)
        labels = slic_segments(img, cell_size=4)
        masks = segment_masks(labels)
        assert masks.sum(axis=0).max() == 1
        state = np.zeros(masks.shape[0], dtype=bool)
        censored = apply_state(img, labels, state, background=0.0)
        assert censored.sum() == 0.0
        state[:] = True
        np.testing.assert_array_equal(apply_state(img, labels, state), img)

    def test_transformer_stage(self):
        rng = np.random.default_rng(1)
        df = DataFrame({"image": [rng.random((16, 16, 3), )
                                  for _ in range(3)]})
        out = SuperpixelTransformer(cell_size=8).transform(df)
        assert out["superpixels"][0].shape == (16, 16)


class TestWeightedRidge:
    def test_recovers_linear_model(self):
        rng = np.random.default_rng(0)
        X = rng.standard_normal((3, 200, 4))
        beta = np.array([1.0, -2.0, 0.5, 0.0])
        y = X @ beta + 3.0
        w = np.ones((3, 200))
        fit = weighted_ridge_fits(X, y, w, reg=1e-6, device="cpu")
        np.testing.assert_allclose(fit[:, :4], np.tile(beta, (3, 1)),
                                   atol=1e-3)
        np.testing.assert_allclose(fit[:, 4], 3.0, atol=1e-3)

    def test_weights_localize(self):
        X = np.concatenate([np.linspace(-1, 1, 50)[:, None],
                            np.linspace(5, 6, 50)[:, None]])[None]
        y = np.concatenate([2 * np.linspace(-1, 1, 50),
                            -np.ones(50)])[None]
        w = np.concatenate([np.ones(50), 1e-9 * np.ones(50)])[None]
        fit = weighted_ridge_fits(X, y, w, reg=1e-6, device="cpu")
        assert fit[0, 0] == pytest.approx(2.0, abs=1e-2)


class TestTabularLIME:
    def test_explains_linear_model(self):
        rng = np.random.default_rng(0)
        X = rng.standard_normal((64, 3))
        beta = np.array([2.0, -1.0, 0.0])
        df = DataFrame({"features": list(X)})
        lime = TabularLIME(model=LinearScorer(beta=beta),
                           predict_col="scores", n_samples=256,
                           kernel_width=5.0, device="cpu")
        model = lime.fit(df)
        out = model.transform(df.head(6))
        W = np.stack(list(out["lime_weights"]))
        assert W.shape == (6, 3)
        np.testing.assert_allclose(W.mean(axis=0), beta, atol=0.15)

    def test_save_load(self, tmp_path):
        rng = np.random.default_rng(0)
        df = DataFrame({"features": list(rng.standard_normal((32, 3)))})
        lime = TabularLIME(model=LinearScorer(beta=np.ones(3)),
                           predict_col="scores", n_samples=64, device="cpu")
        model = lime.fit(df)
        model.save(str(tmp_path / "lime"))
        loaded = PipelineStage.load(str(tmp_path / "lime"), device="cpu")
        assert loaded.device == "cpu"
        a = model.transform(df.head(2))["lime_weights"]
        b = loaded.transform(df.head(2))["lime_weights"]
        np.testing.assert_allclose(np.stack(list(a)), np.stack(list(b)))


class TestImageLIME:
    def test_highlights_informative_quadrant(self):
        rng = np.random.default_rng(0)
        img = rng.random((16, 16, 3)).astype(np.float32) * 0.5 + 0.5
        df = DataFrame({"image": [img]})
        lime = ImageLIME(model=PatchScorer(), predict_col="scores",
                         n_samples=128, cell_size=8, modifier=500.0,
                         kernel_width=2.0, device="cpu").fit(df)
        out = lime.transform(df)
        weights = out["lime_weights"][0]
        labels = out["superpixels"][0]
        best = int(np.argmax(weights))
        ys, xs = np.nonzero(labels == best)
        assert ys.mean() < 8 and xs.mean() < 8

    def test_precomputed_superpixels_used(self):
        img = np.ones((8, 8, 3), dtype=np.float32)
        labels = np.zeros((8, 8), dtype=np.int32)
        labels[:, 4:] = 1
        df = DataFrame({"image": [img], "superpixels": [labels]})
        lime = ImageLIME(model=PatchScorer(), predict_col="scores",
                         n_samples=32, device="cpu").fit(df)
        out = lime.transform(df)
        assert len(out["lime_weights"][0]) == 2


# -- the card by default -----------------------------------------------------

@pytest.mark.skipif(torch.cuda.is_available(), reason="a host without CUDA")
def test_solves_run_on_the_card_by_default():
    X = np.zeros((1, 8, 2))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        weighted_ridge_fits(X, np.zeros((1, 8)), np.ones((1, 8)))
    df = DataFrame({"features": list(np.eye(3))})
    model = TabularLIME(model=LinearScorer(beta=np.ones(3)),
                        n_samples=8).fit(df)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.transform(df)


# -- parity with the JAX package on the same inputs --------------------------

@pytest.mark.parametrize("shape,reg", [((3, 200, 4), 1e-3),
                                       ((8, 64, 14), 1e-3),
                                       ((1, 512, 16), 0.0)])
def test_weighted_ridge_matches_jax(shape, reg):
    rng = np.random.default_rng(sum(shape))
    X = rng.standard_normal(shape)
    if reg == 0.0:
        X = (X > 0).astype(np.float64)      # ImageLIME's binary states
    y = X @ rng.standard_normal(shape[-1]) + rng.normal(size=shape[:2])
    w = np.exp(-rng.random(shape[:2]))
    got = weighted_ridge_fits(X, y, w, reg, device="cpu")
    ref = JL.weighted_ridge_fits(X, y, w, reg)
    assert got.dtype == np.float32 == ref.dtype
    assert scaled_err(got, ref) <= COEF_TOL


@pytest.mark.parametrize("cell,modifier", [(8.0, 130.0), (4.0, 10.0),
                                           (16.0, 500.0)])
def test_superpixels_match_jax(cell, modifier):
    rng = np.random.default_rng(int(cell))
    img = rng.random((24, 20, 3)).astype(np.float32)
    labels = slic_segments(img, cell, modifier)
    np.testing.assert_array_equal(labels, JSP.slic_segments(img, cell,
                                                            modifier))
    np.testing.assert_array_equal(segment_masks(labels),
                                  JSP.segment_masks(labels))
    state = rng.random(labels.max() + 1) > 0.5
    np.testing.assert_array_equal(apply_state(img, labels, state, 0.25),
                                  JSP.apply_state(img, labels, state, 0.25))


def test_tabular_lime_matches_jax():
    rng = np.random.default_rng(3)
    X = rng.standard_normal((24, 4))
    beta = np.array([1.5, -0.5, 0.0, 2.0])
    kw = dict(predict_col="scores", n_samples=128, kernel_width=2.0,
              sample_batch=5, seed=4)
    jm = JL.TabularLIME(model=JLinearScorer(beta=beta), **kw).fit(
        JDF({"features": list(X)}))
    pm = TabularLIME(model=LinearScorer(beta=beta), device="cpu",
                     **kw).fit(DataFrame({"features": list(X)}))
    np.testing.assert_array_equal(pm.feature_means, jm.feature_means)
    np.testing.assert_array_equal(pm.feature_stds, jm.feature_stds)
    got = np.stack(list(pm.transform(DataFrame(
        {"features": list(X[:11])}))["lime_weights"]))
    ref = np.stack(list(jm.transform(JDF(
        {"features": list(X[:11])}))["lime_weights"]))
    assert scaled_err(got, ref) <= COEF_TOL


def _gbdt_frames():
    rng = np.random.default_rng(5)
    X = rng.normal(size=(400, 5))
    y = (X[:, 0] - 0.7 * X[:, 2] + 0.3 * rng.normal(size=400) > 0) \
        .astype(np.float64)
    return X, y


def test_tabular_lime_over_gbdt_matches_jax():
    """The JAX fit's model string in the port's GBDT stage; the port's
    ``TabularLIMEModel`` takes the JAX model's column statistics."""
    X, y = _gbdt_frames()
    jfit = JG.GBDTClassifier(num_iterations=10, num_leaves=7).fit(
        JDF({"features": X, "label": y}))
    pfit = PG.GBDTClassificationModel(
        booster=Booster.from_string(jfit.booster.model_to_string(),
                                    device="cpu"),
        classes=list(jfit.classes), device="cpu")
    kw = dict(predict_col="probability", class_index=1, n_samples=256,
              sample_batch=8, kernel_width=0.75, seed=1)
    jm = JL.TabularLIME(model=jfit, **kw).fit(JDF({"features": list(X)}))
    pm = TabularLIMEModel(model=pfit, device="cpu",
                          feature_means=jm.feature_means,
                          feature_stds=jm.feature_stds, **kw)
    got = np.stack(list(pm.transform(DataFrame(
        {"features": list(X[:16])}))["lime_weights"]))
    ref = np.stack(list(jm.transform(JDF(
        {"features": list(X[:16])}))["lime_weights"]))
    assert scaled_err(got, ref) <= COEF_TOL


def test_image_lime_matches_jax():
    rng = np.random.default_rng(6)
    imgs = [rng.random((16, 16, 3)).astype(np.float32) for _ in range(2)]
    kw = dict(predict_col="scores", n_samples=64, cell_size=8,
              modifier=200.0, kernel_width=1.0, seed=2)
    jout = JL.ImageLIME(model=JPatchScorer(), **kw).fit(
        JDF({"image": imgs})).transform(JDF({"image": imgs}))
    pout = ImageLIME(model=PatchScorer(), device="cpu", **kw).fit(
        DataFrame({"image": imgs})).transform(DataFrame({"image": imgs}))
    for a, b in zip(pout["superpixels"], jout["superpixels"]):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(pout["lime_weights"], jout["lime_weights"]):
        assert scaled_err(a, b) <= COEF_TOL


def test_image_lime_over_a_network_matches_jax():
    """A bridged ``NNFunction`` (f32) scored by each package's
    ``NNModel``; class 2's logit explained."""
    arch = {"builder": "cifar_convnet", "num_classes": 4}
    jf = JF.init(arch, (16, 16, 3), seed=0)
    pf = PF(arch=dict(arch), params=jax.tree.map(np.asarray, jf.params))
    rng = np.random.default_rng(8)
    imgs = [rng.random((16, 16, 3)).astype(np.float32) for _ in range(2)]
    kw = dict(predict_col="scores", class_index=2, n_samples=64,
              cell_size=8, seed=3)
    jout = JL.ImageLIME(model=JNN(model=jf, input_col="image",
                                  batch_size=64), **kw).fit(
        JDF({"image": imgs})).transform(JDF({"image": imgs}))
    pout = ImageLIME(model=NNModel(model=pf, input_col="image",
                                   batch_size=64, device="cpu"),
                     device="cpu", **kw).fit(
        DataFrame({"image": imgs})).transform(DataFrame({"image": imgs}))
    for a, b in zip(pout["superpixels"], jout["superpixels"]):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(pout["lime_weights"], jout["lime_weights"]):
        assert scaled_err(a, b) <= COEF_TOL
