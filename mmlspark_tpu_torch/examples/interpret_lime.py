"""LIME model interpretation: tabular + image with SLIC superpixels.

Counterpart of ``examples/interpret_lime.py``: explain a GBDT's
predictions feature by feature (only features 0 and 3 matter), then a
small convnet's superpixel by superpixel. The weighted ridge solves run
batched on the card.
"""

from __future__ import annotations

import numpy as np

from mmlspark_tpu_torch.examples._common import run_main, timed

CONVNET = {"builder": "cifar_convnet"}


def make_data(seed: int = 0, n: int = 512, n_images: int = 4):
    rng = np.random.default_rng(seed)
    # tabular: only features 0 and 3 matter — LIME should find them
    X = rng.normal(size=(n, 8))
    y = ((X[:, 0] + X[:, 3]) > 0).astype(int)
    images = rng.uniform(0, 1, (n_images, 32, 32, 3)).astype(np.float32)
    return X, y, images


def run(device=None, seed: int = 0, n: int = 512, n_explained: int = 16,
        n_samples: int = 200, n_images: int = 4, image_samples: int = 40,
        net=None) -> dict:
    """``net``: the image model's ``NNFunction`` (default: the convnet
    drawn from seed 0)."""
    from mmlspark_tpu_torch.core.dataframe import DataFrame
    from mmlspark_tpu_torch.explain import ImageLIME, TabularLIME
    from mmlspark_tpu_torch.gbdt import GBDTClassifier
    from mmlspark_tpu_torch.models.function import NNFunction
    from mmlspark_tpu_torch.models.nn import NNModel

    X, y, images = make_data(seed, n, n_images)
    df = DataFrame({"features": X, "label": y})
    clf = GBDTClassifier(num_iterations=20, num_leaves=7,
                         device=device).fit(df)
    with timed() as t:
        lime = TabularLIME(model=clf, input_col="features",
                           predict_col="probability", n_samples=n_samples,
                           device=device).fit(df)
        out = lime.transform(df.head(n_explained))
    weights = np.stack(out["lime_weights"])
    w = np.abs(weights).mean(axis=0)
    top2 = sorted(int(i) for i in np.argsort(-w)[:2])
    lines = [f"tabular LIME: {t.seconds:.1f}s, top features {top2} "
             f"(truth: [0, 3])"]

    # image: superpixel attribution over a small convnet
    if net is None:
        net = NNFunction.init(CONVNET, input_shape=(32, 32, 3), seed=0)
    scorer = NNModel(model=net, input_col="image", output_col="scores",
                     device=device)
    idf = DataFrame({"image": images})
    with timed() as ti:
        ilime = ImageLIME(model=scorer, input_col="image",
                          n_samples=image_samples, device=device).fit(idf)
        iout = ilime.transform(idf)
    n_sp = len(iout["lime_weights"][0])
    lines.append(f"image LIME: {ti.seconds:.1f}s, {n_sp} superpixel "
                 f"weights/image")
    return {"name": "interpret_lime", "tabular_s": t.seconds,
            "image_s": ti.seconds, "top_features": top2,
            "n_superpixels": n_sp, "_gbdt": clf, "_weights": weights,
            "_image_weights": [np.asarray(v) for v in iout["lime_weights"]],
            "lines": lines}


def main(argv=None) -> dict:
    return run_main(__doc__, run, argv)


if __name__ == "__main__":
    main()
