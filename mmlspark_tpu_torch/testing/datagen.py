"""Synthetic frame generation for property tests.

The port's copy of ``mmlspark_tpu/testing/datagen.py`` (numpy only, no
JAX in it), over the port's :class:`~mmlspark_tpu_torch.core.dataframe.
DataFrame`: the same draws from the same seed give the same frames.

Parity: `core/test/datagen/src/main/scala/GenerateDataset.scala` +
``DatasetOptions`` — random DataFrames with constrained schemas and
controlled missing values, so stage property tests can sweep input
shapes without hand-writing fixtures.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional, Sequence

import numpy as np

from mmlspark_tpu_torch.core.dataframe import DataFrame, obj_col


@dataclasses.dataclass
class ColumnOptions:
    """Constraints for one generated column."""

    kind: str = "double"        # double | int | bool | string | vector | categorical
    missing_ratio: float = 0.0  # NaN (numeric) / None (object) injection
    low: float = -100.0
    high: float = 100.0
    dim: int = 4                # vector width
    levels: Sequence[str] = ("a", "b", "c")
    string_len: int = 8


def generate_column(rng: np.random.Generator, n: int,
                    opt: ColumnOptions) -> np.ndarray:
    if opt.missing_ratio > 0 and opt.kind in ("int", "bool", "vector"):
        raise ValueError(
            f"missing_ratio is not representable for kind={opt.kind!r} "
            f"(use 'double'/'string'/'categorical', which carry NaN/None)")
    if opt.kind == "double":
        col = rng.uniform(opt.low, opt.high, n)
        if opt.missing_ratio > 0:
            col[rng.random(n) < opt.missing_ratio] = np.nan
        return col
    if opt.kind == "int":
        return rng.integers(int(opt.low), int(opt.high) + 1, n)
    if opt.kind == "bool":
        return rng.random(n) < 0.5
    if opt.kind == "vector":
        return rng.normal(size=(n, opt.dim))
    if opt.kind == "categorical":
        vals = rng.choice(list(opt.levels), size=n)
        out = obj_col(list(vals))
    elif opt.kind == "string":
        letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
        out = obj_col(["".join(rng.choice(letters, opt.string_len))
                       for _ in range(n)])
    else:
        raise ValueError(f"unknown column kind {opt.kind!r}")
    if opt.missing_ratio > 0:
        mask = rng.random(n) < opt.missing_ratio
        out[mask] = None
    return out


def generate_dataframe(schema: Dict[str, ColumnOptions], n_rows: int,
                       seed: int = 0,
                       rng: Optional[np.random.Generator] = None
                       ) -> DataFrame:
    """A random frame matching ``schema`` (name -> ColumnOptions)."""
    rng = rng or np.random.default_rng(seed)
    return DataFrame({name: generate_column(rng, n_rows, opt)
                      for name, opt in schema.items()})


def basic_mixed_frame(n_rows: int = 64, seed: int = 0,
                      missing_ratio: float = 0.0) -> DataFrame:
    """A ready-made mixed-type frame (the GenerateDataset default)."""
    return generate_dataframe({
        "doubles": ColumnOptions("double", missing_ratio=missing_ratio),
        "ints": ColumnOptions("int", low=0, high=50),
        "bools": ColumnOptions("bool"),
        "strings": ColumnOptions("string", missing_ratio=missing_ratio),
        "cats": ColumnOptions("categorical", missing_ratio=missing_ratio),
        "vecs": ColumnOptions("vector", dim=3),
    }, n_rows, seed=seed)


# ---------------------------------------------------------------------------
# CIFAR-shaped synthetic image classification (zoo training data)
# ---------------------------------------------------------------------------
#
# The reference's zoo serves nets trained on real image corpora
# (`ModelDownloader.scala:54,124`). This build environment has zero
# network egress and no CIFAR-10 files on disk, so the committed zoo
# model trains on this DETERMINISTIC procedural surrogate: 32x32x3 uint8
# images in 12 parametric pattern families (random orientation, scale,
# position, colors, contrast, pixel noise) — hard enough that a linear
# model fails and a trained ResNet is genuinely transferable, and fully
# reproducible from this code alone. `tools/train_zoo_models.py` uses
# real CIFAR-10 instead whenever its files are present (see
# `load_cifar10_batches`). Families 10-11 are reserved as *unseen*
# classes for the transfer-learning example.

SYNTH_CIFAR_CLASSES = 12


def synth_cifar(n: int, seed: int = 0, classes=tuple(range(10))):
    """``(images uint8 (n, 32, 32, 3), labels int64 (n,))``; labels are
    indices into ``classes`` (0..len(classes)-1)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:32, 0:32].astype(np.float32)
    xx = (xx - 15.5) / 16.0
    yy = (yy - 15.5) / 16.0
    labels = rng.integers(0, len(classes), n)
    images = np.empty((n, 32, 32, 3), np.uint8)
    for li, fam in enumerate(classes):
        idx = np.flatnonzero(labels == li)
        if len(idx):
            images[idx] = _synth_family(rng, len(idx), fam, xx, yy)
    return images, labels.astype(np.int64)


def _synth_family(rng, m, fam, xx, yy):
    r1 = lambda lo, hi: rng.uniform(lo, hi, (m, 1, 1)).astype(np.float32)
    d2 = lambda cx, cy: (xx[None] - cx) ** 2 + (yy[None] - cy) ** 2
    cx, cy = r1(-0.4, 0.4), r1(-0.4, 0.4)

    def rot(theta_lo, theta_hi):
        th = np.deg2rad(rng.uniform(theta_lo, theta_hi, (m, 1, 1))
                        ).astype(np.float32)
        return np.cos(th) * xx[None] + np.sin(th) * yy[None]

    def stripes(theta_lo, theta_hi):
        u = rot(theta_lo, theta_hi)
        return np.sin(np.pi * r1(2.5, 7.5) * u + r1(0, 6.28)) > 0

    if fam == 0:                                   # ~horizontal stripes
        v = stripes(70, 110)
    elif fam == 1:                                 # ~vertical stripes
        v = stripes(-20, 20)
    elif fam == 2:                                 # ~diagonal stripes
        v = stripes(35, 55)
    elif fam == 3:                                 # checkerboard
        s = rng.uniform(3, 8, (m, 1, 1)).astype(np.float32) / 16.0
        ox, oy = r1(0, 1), r1(0, 1)
        v = (np.floor((xx[None] + 1 + ox) / s)
             + np.floor((yy[None] + 1 + oy) / s)) % 2 > 0.5
    elif fam == 4:                                 # filled disk
        v = d2(cx, cy) < r1(0.25, 0.65) ** 2
    elif fam == 5:                                 # ring / annulus
        r_in = r1(0.2, 0.4)
        v = (d2(cx, cy) > r_in ** 2) & (d2(cx, cy) < (r_in + 0.25) ** 2)
    elif fam == 6:                                 # axis-aligned rectangle
        v = (np.abs(xx[None] - cx) < r1(0.2, 0.5)) \
            & (np.abs(yy[None] - cy) < r1(0.2, 0.5))
    elif fam == 7:                                 # plus / cross
        t = r1(0.08, 0.2)
        v = (np.abs(xx[None] - cx) < t) | (np.abs(yy[None] - cy) < t)
    elif fam == 8:                                 # concentric rings
        v = np.sin(np.pi * r1(3, 8) * np.sqrt(d2(cx, cy) + 1e-6)
                   + r1(0, 6.28)) > 0
    elif fam == 9:                                 # gaussian blobs
        v = np.zeros((m, 32, 32), np.float32)
        for _ in range(3):
            bx, by = r1(-0.6, 0.6), r1(-0.6, 0.6)
            v += np.exp(-d2(bx, by) / (2 * r1(0.08, 0.2) ** 2))
        v = v > 0.6
    elif fam == 10:                                # V / triangle wedge
        v = (yy[None] - cy) > r1(0.8, 2.0) * np.abs(xx[None] - cx) - 0.3
    elif fam == 11:                                # diagonal X cross
        t = r1(0.08, 0.2)
        v = (np.abs(rot(40, 50)) < t) | (np.abs(rot(-50, -40)) < t)
    else:
        raise ValueError(f"unknown family {fam}")

    v = v.astype(np.float32)[..., None]            # (m, 32, 32, 1)
    fg = rng.uniform(0, 255, (m, 1, 1, 3)).astype(np.float32)
    bg = np.mod(fg + 128 + rng.uniform(-64, 64, (m, 1, 1, 3)), 256)
    img = bg * (1 - v) + fg * v
    img *= rng.uniform(0.7, 1.2, (m, 1, 1, 1))     # brightness jitter
    img += rng.normal(0, rng.uniform(5, 18, (m, 1, 1, 1)),
                      img.shape)                   # pixel noise
    return np.clip(img, 0, 255).astype(np.uint8)


def load_cifar10_batches(data_dir: str):
    """Real CIFAR-10 from the standard python pickle batches
    (``cifar-10-batches-py``), if present — the zoo trainer prefers this
    over :func:`synth_cifar` when the files exist. Returns
    ``(Xtr, ytr, Xte, yte)`` with uint8 NHWC images."""
    import pickle

    def batch(name):
        with open(os.path.join(data_dir, name), "rb") as f:
            d = pickle.load(f, encoding="bytes")
        x = d[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
        return x.astype(np.uint8), np.asarray(d[b"labels"], np.int64)

    parts = [batch(f"data_batch_{i}") for i in range(1, 6)]
    Xtr = np.concatenate([p[0] for p in parts])
    ytr = np.concatenate([p[1] for p in parts])
    Xte, yte = batch("test_batch")
    return Xtr, ytr, Xte, yte
