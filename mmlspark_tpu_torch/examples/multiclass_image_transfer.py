"""Multi-class image transfer learning with a REAL-data pretrained net.

Counterpart of ``examples/multiclass_image_transfer.py``: the zoo's
``digits32_resnet14`` (trained on scikit-learn's real digits upscaled to
32x32, classes 0-7 only) featurizes the FULL 10-class problem through
``ImageFeaturizer`` (head cut), and a multiclass GBDT fits the
embeddings; classes 8 and 9 were never seen by the backbone.
"""

from __future__ import annotations

import numpy as np
import torch

from mmlspark_tpu_torch.examples import _zoo
from mmlspark_tpu_torch.examples._common import load_digits, run_main, timed


def make_images(seed: int = 0, n: int = 1200, device=None):
    """The digits upscaled to 32x32 (``ops.image.resize``, on
    ``device``), a seeded subset of ``n``."""
    from mmlspark_tpu_torch.ops.image import resize
    d = load_digits()
    images = (d["images"] / 16.0).astype(np.float32)[..., None]
    images = resize(torch.as_tensor(images, device=device), 32, 32)
    images = images.cpu().numpy().astype(np.float32)
    y = d["target"].astype(np.int64)
    order = np.random.default_rng(seed).permutation(len(images))[:n]
    return images[order], y[order]


def classifier(num_iterations: int = 15, device=None):
    """The example's classifier: a multiclass GBDT behind
    ``TrainClassifier``, on ``device``."""
    from mmlspark_tpu_torch.automl.train import TrainClassifier
    from mmlspark_tpu_torch.gbdt import GBDTClassifier
    return TrainClassifier(
        model=GBDTClassifier(objective="multiclass",
                             num_iterations=num_iterations, num_leaves=7,
                             min_data_in_leaf=5, device=device),
        label_col="label")


def run(device=None, seed: int = 0, n: int = 1200,
        num_iterations: int = 15) -> dict:
    from mmlspark_tpu_torch.core.dataframe import DataFrame
    from mmlspark_tpu_torch.models.featurizer import ImageFeaturizer

    images, y = make_images(seed, n, device)
    n_tr = len(images) // 2
    train = DataFrame({"image": images[:n_tr], "label": y[:n_tr]})
    test = DataFrame({"image": images[n_tr:], "label": y[n_tr:]})
    meta, backbone = _zoo.load("digits32_resnet14")
    lines = [f"backbone {meta.name} trained on {meta.dataset} "
             f"(classes 8/9 unseen)"]
    featurizer = ImageFeaturizer(model=backbone, input_col="image",
                                 output_col="embedding",
                                 cut_output_layers=1, device=device)
    clf = classifier(num_iterations, device)
    with timed() as t:
        feats = featurizer.transform(train)
        model = clf.fit(feats.select(["embedding", "label"]))
    test_feats = featurizer.transform(test).select(["embedding", "label"])
    scored = model.transform(test_feats)
    pred = np.asarray(scored["prediction"])
    acc = float((pred == y[n_tr:]).mean())
    unseen = y[n_tr:] >= 8
    acc_unseen = float((pred[unseen] == y[n_tr:][unseen]).mean())
    lines.append(f"10-class transfer accuracy {acc:.4f} (unseen classes "
                 f"8/9: {acc_unseen:.4f}; fit {t.seconds:.1f}s)")
    if n >= 1200:   # the JAX script's gates, at its size
        assert acc > 0.9, acc
        assert acc_unseen > 0.75, acc_unseen
    return {"name": "multiclass_image_transfer", "fit_s": t.seconds,
            "accuracy": acc, "accuracy_unseen": acc_unseen,
            "_features": np.stack(list(feats["embedding"])),
            "_train": feats.select(["embedding", "label"]),
            "_test": test_feats,
            "_booster": model.fitted.booster, "lines": lines}


def main(argv=None) -> dict:
    return run_main(__doc__, run, argv)


if __name__ == "__main__":
    main()
