"""LIME model interpretation: tabular + image (the port of
``mmlspark_tpu/explain/lime.py``).

Capability parity with `image-featurizer/src/main/scala/LIME.scala:27,165,250`
(`LIMEBase` / `TabularLIME` / `ImageLIME`): explain any fitted model's
prediction per row by fitting a local weighted linear surrogate over
perturbed samples.

The reference distributes one least-squares fit per row over Spark
partitions; here every row's perturbed samples are scored in a single
batched ``model.transform`` (the explained model computes on its own
device), and the per-row weighted ridge solves are one batched
``torch.linalg.solve`` over the f32 normal equations on the LIME
stage's device (the card unless ``device="cpu"``): (rows, d, d) batched
solves instead of row-at-a-time Breeze fits. JAX solves the same f32
systems (x64 off) with a vmapped ``jnp.linalg.solve``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from mmlspark_tpu_torch.core.dataframe import DataFrame, obj_col
from mmlspark_tpu_torch.core.environment import DeviceLike, resolve_device
from mmlspark_tpu_torch.core.params import (
    HasDevice, Param, HasInputCol, HasOutputCol, in_range,
)
from mmlspark_tpu_torch.core.stage import (
    Estimator, Model, PipelineStage, Transformer,
)
from mmlspark_tpu_torch.explain.superpixel import (
    apply_state, slic_segments,
)
from mmlspark_tpu_torch.models.function import ieee_f32


def weighted_ridge_fits(X: np.ndarray, y: np.ndarray, w: np.ndarray,
                        reg: float = 1e-3,
                        device: DeviceLike = None) -> np.ndarray:
    """Batched weighted ridge regressions on ``device`` (the card unless
    ``"cpu"``).

    X: (R, S, D) perturbation designs, y: (R, S) model outputs,
    w: (R, S) locality weights -> (R, D+1) f32 [coefs..., intercept] per
    row. The designs are cast to f32 and the (D+1, D+1) normal matrices
    ``Xw^T X + reg I`` are solved in one batched call, TF32 off.
    """
    dev = resolve_device(device)
    f32 = torch.float32
    with torch.no_grad(), ieee_f32():
        Xi = torch.as_tensor(np.asarray(X), dtype=f32).to(dev)
        Xb = torch.cat([Xi, torch.ones(Xi.shape[:2] + (1,), dtype=f32,
                                       device=dev)], dim=-1)
        yb = torch.as_tensor(np.asarray(y), dtype=f32).to(dev)
        wb = torch.as_tensor(np.asarray(w), dtype=f32).to(dev)
        Xw = Xb * wb[..., None]
        A = Xw.mT @ Xb + torch.tensor(np.float32(reg), device=dev) \
            * torch.eye(Xb.shape[-1], dtype=f32, device=dev)
        b = Xw.mT @ yb[..., None]
        return torch.linalg.solve(A, b)[..., 0].cpu().numpy()


def _model_scores(model: Transformer, df: DataFrame, input_col: str,
                  predict_col: str, class_index: Optional[int]) -> np.ndarray:
    """Run the inner model and pull a scalar score per row."""
    out = model.transform(df)
    col = out[predict_col]
    if col.dtype == np.dtype("O"):
        col = np.stack([np.asarray(v, dtype=np.float64) for v in col])
    col = np.asarray(col, dtype=np.float64)
    if col.ndim == 2:
        idx = class_index if class_index is not None else col.shape[1] - 1
        return col[:, idx]
    return col


class LIMEBase(Estimator, HasInputCol, HasOutputCol, HasDevice):
    """Shared LIME params (parity: LIME.scala:27 LIMEParams). ``device``
    is where the ridge solves run; the explained model keeps its own."""

    model = Param(None, "the fitted model to explain", complex=True)
    predict_col = Param("scores", "model output column to explain")
    class_index = Param(None, "which output class to explain (default last)")
    n_samples = Param(512, "perturbed samples per row", in_range(lo=8))
    kernel_width = Param(0.75, "locality kernel width", in_range(lo=1e-6))
    regularization = Param(1e-3, "ridge regularization", in_range(lo=0.0))
    sample_batch = Param(8, "rows explained per device batch",
                         in_range(lo=1))
    seed = Param(0, "perturbation seed")

    def _save_extra(self, path, arrays):
        import os
        if self.model is not None:
            self.model.save(os.path.join(path, "inner"))

    def _load_extra(self, path, arrays):
        import os
        inner = os.path.join(path, "inner")
        if os.path.isdir(inner):
            self.model = PipelineStage.load(inner)


class TabularLIME(LIMEBase):
    """Explain feature-vector rows via Gaussian perturbation.

    Parity: `LIME.scala:165` (TabularLIME fit collects per-column
    mean/std; its model perturbs around each row with those stats).
    ``fit`` learns column statistics; the model emits one coefficient
    vector per row in ``output_col``.
    """

    input_col = Param("features", "feature-vector column")
    output_col = Param("lime_weights", "per-feature coefficients out")

    def fit(self, df: DataFrame) -> "TabularLIMEModel":
        X = np.stack([np.asarray(v, dtype=np.float64)
                      for v in df[self.input_col]])
        means = X.mean(axis=0)
        stds = X.std(axis=0)
        stds = np.where(stds > 0, stds, 1.0)
        return TabularLIMEModel(
            **self.get_param_values(),
            feature_means=means, feature_stds=stds)


class TabularLIMEModel(TabularLIME, Model):
    feature_means = Param(None, "per-feature means", complex=True)
    feature_stds = Param(None, "per-feature stds", complex=True)

    def _save_extra(self, path, arrays):
        super()._save_extra(path, arrays)
        arrays["feature_means"] = np.asarray(self.feature_means)
        arrays["feature_stds"] = np.asarray(self.feature_stds)

    def _load_extra(self, path, arrays):
        super()._load_extra(path, arrays)
        self.feature_means = arrays["feature_means"]
        self.feature_stds = arrays["feature_stds"]

    def transform(self, df: DataFrame) -> DataFrame:
        rng = np.random.default_rng(self.seed)
        X = np.stack([np.asarray(v, dtype=np.float64)
                      for v in df[self.input_col]])
        n_rows, d = X.shape
        S = self.n_samples
        coefs = np.zeros((n_rows, d), dtype=np.float64)

        for start in range(0, n_rows, self.sample_batch):
            rows = X[start:start + self.sample_batch]
            r = len(rows)
            noise = rng.standard_normal((r, S, d))
            samples = rows[:, None, :] + noise * self.feature_stds
            flat = samples.reshape(r * S, d)
            scores = _model_scores(
                self.model, DataFrame({self.input_col: obj_col(list(flat))}),
                self.input_col, self.predict_col, self.class_index
            ).reshape(r, S)
            # locality weight in standardized space
            z = (samples - rows[:, None, :]) / self.feature_stds
            dist = np.sqrt((z ** 2).sum(-1)) / np.sqrt(d)
            w = np.exp(-(dist ** 2) / self.kernel_width ** 2)
            # fit on standardized offsets so coefs are per-feature effects
            fit = weighted_ridge_fits(z, scores, w, self.regularization,
                                      device=self.device)
            coefs[start:start + r] = fit[:, :d] / self.feature_stds
        return df.with_column(self.output_col, obj_col(list(coefs)))


class ImageLIME(LIMEBase):
    """Explain image predictions per superpixel.

    Parity: `LIME.scala:250` (ImageLIME = SLIC superpixels + random
    binary state sampling + censored scoring + per-superpixel linear
    fit). ``fit`` is stateless (superpixels are per-image); provided for
    API symmetry with the reference's Estimator.
    """

    input_col = Param("image", "image column (HWC float arrays)")
    output_col = Param("lime_weights", "per-superpixel coefficients out")
    superpixel_col = Param("superpixels", "label-map column (made if absent)")
    cell_size = Param(16.0, "superpixel cell edge, px", in_range(lo=2))
    modifier = Param(130.0, "spatial-vs-color weight", in_range(lo=0))
    censor_fraction = Param(0.3, "P(superpixel off) per sample",
                            in_range(lo=0.0, hi=1.0))
    background = Param(0.0, "fill value for censored superpixels")

    def fit(self, df: DataFrame) -> "ImageLIMEModel":
        return ImageLIMEModel(**self.get_param_values())


class ImageLIMEModel(ImageLIME, Model):

    def transform(self, df: DataFrame) -> DataFrame:
        rng = np.random.default_rng(self.seed)
        images = [np.asarray(v, dtype=np.float32)
                  for v in df[self.input_col]]
        have_sp = self.superpixel_col in df
        out_weights = []
        out_labels = []
        S = self.n_samples
        for i, img in enumerate(images):
            labels = (np.asarray(df[self.superpixel_col][i])
                      if have_sp else
                      slic_segments(img, self.cell_size, self.modifier))
            k = int(labels.max()) + 1
            states = rng.random((S, k)) >= self.censor_fraction
            states[0] = True  # include the unperturbed image
            masked = np.stack([
                apply_state(img, labels, s, self.background)
                for s in states])
            scores = _model_scores(
                self.model,
                DataFrame({self.input_col: obj_col(list(masked))}),
                self.input_col, self.predict_col, self.class_index)
            frac_on = states.mean(axis=1)
            w = np.exp(-((1.0 - frac_on) ** 2) / self.kernel_width ** 2)
            fit = weighted_ridge_fits(
                states[None].astype(np.float64), scores[None], w[None],
                self.regularization, device=self.device)[0]
            out_weights.append(fit[:k])
            out_labels.append(labels)
        out = df.with_column(self.output_col, obj_col(out_weights))
        if not have_sp:
            out = out.with_column(self.superpixel_col, obj_col(out_labels))
        return out
