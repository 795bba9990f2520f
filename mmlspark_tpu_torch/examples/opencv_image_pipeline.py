"""Image-ops pipeline: read files -> chained transforms -> unroll -> fit.

Counterpart of ``examples/opencv_image_pipeline.py``: PNG files on disk
(two visual classes at assorted sizes) read by ``read_images``, an
``ImageTransformer`` chain (resize, crop, blur, flip, normalize) on the
card, bucketed by shape, ``UnrollImage`` to feature vectors and a
``TrainClassifier`` over the port's GBDT.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np

from mmlspark_tpu_torch.examples._common import run_main, timed


def write_sample_images(root, rng, n=48):
    """PNG files on disk: two visual classes (bright disk vs dark bars)
    at assorted sizes, so the read->transform->unroll->fit path is real."""
    from mmlspark_tpu_torch.io.images import encode_image
    labels = []
    for i in range(n):
        side = int(rng.integers(48, 96))
        y = int(i % 2)
        img = rng.integers(0, 60, (side, side, 3))
        if y:  # bright disk
            yy, xx = np.mgrid[0:side, 0:side]
            m = (yy - side / 2) ** 2 + (xx - side / 2) ** 2 < (side / 3) ** 2
            img[m] = rng.integers(180, 255, 3)
        else:  # dark horizontal bars
            img[:: max(side // 6, 1)] = rng.integers(120, 200, 3)
        path = os.path.join(root, f"img_{i:03d}_{y}.png")
        with open(path, "wb") as f:
            f.write(encode_image(img.astype(np.uint8)))
        labels.append(y)
    return np.asarray(labels, dtype=np.int64)


def chain(device=None):
    """The reference notebook's chain: resize -> crop -> blur -> flip ->
    normalize, one fluent transformer."""
    from mmlspark_tpu_torch.stages.image import ImageTransformer
    return (ImageTransformer(input_col="image", output_col="processed",
                             device=device)
            .resize(40, 40)
            .center_crop(32, 32)
            .gaussian_kernel(3, 1.0)
            .flip()
            .normalize(mean=[127.5] * 3, std=[127.5] * 3))


def run(device=None, seed: int = 0, n_images: int = 48,
        num_iterations: int = 20) -> dict:
    from mmlspark_tpu_torch.core.dataframe import DataFrame
    from mmlspark_tpu_torch.io.images import read_images
    from mmlspark_tpu_torch.stages.image import UnrollImage
    from mmlspark_tpu_torch.automl.train import TrainClassifier
    from mmlspark_tpu_torch.automl.metrics import ComputeModelStatistics
    from mmlspark_tpu_torch.gbdt import GBDTClassifier

    rng = np.random.default_rng(seed)
    with tempfile.TemporaryDirectory() as root:
        labels = write_sample_images(root, rng, n_images)
        df = read_images(root)
        assert df.num_rows == len(labels)
        # filenames sort deterministically; recover labels from paths
        order = np.argsort([str(p) for p in df["path"]])
        df = df.take(order)
        y = np.array([int(str(p).rsplit("_", 1)[1][0])
                      for p in df["path"]], dtype=np.int64)
        with timed() as t:
            out = chain(device).transform(df)
        proc = np.stack(list(out["processed"]))
        lines = [f"transformed {df.num_rows} variable-size images -> "
                 f"{proc.shape[1:]} in {t.seconds:.2f}s "
                 f"(shape-bucketed ops on the device)"]
        unrolled = UnrollImage(input_col="processed", output_col="features",
                               device=device).transform(out)
        features = np.stack(list(unrolled["features"]))
        train = DataFrame({"features": unrolled["features"], "label": y})
        with timed() as tf:
            model = TrainClassifier(
                model=GBDTClassifier(num_iterations=num_iterations,
                                     num_leaves=7, min_data_in_leaf=3,
                                     device=device),
                label_col="label").fit(train)
        stats = ComputeModelStatistics(label_col="label").evaluate(
            model.transform(train))
        acc = float(stats["accuracy"][0])
    lines.append(f"unroll -> TrainClassifier on pixel features: "
                 f"train accuracy={acc:.3f}")
    assert acc > 0.9, acc
    return {"name": "opencv_image_pipeline", "transform_s": t.seconds,
            "fit_s": tf.seconds, "accuracy": acc, "_processed": proc,
            "_features": features, "lines": lines}


def main(argv=None) -> dict:
    return run_main(__doc__, run, argv)


if __name__ == "__main__":
    main()
