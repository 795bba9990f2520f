"""BASELINE config 4: ImageFeaturizer + TrainClassifier transfer learning.

Counterpart of ``examples/transfer_learning.py``: the zoo's
``digits_resnet8`` (trained on scikit-learn's real digits, classes 0-7
only) featurizes digits 8 vs 9, classes it never saw, and a linear
softmax head (``NNLearner``) fits the embeddings; a random-init backbone
of the same architecture must not beat it. Then the same with the zoo's
``cifar10s_resnet20`` on pattern families 10 and 11, which its training
never saw.
"""

from __future__ import annotations

import numpy as np

from mmlspark_tpu_torch.examples import _zoo
from mmlspark_tpu_torch.examples._common import load_digits, run_main, timed

HEAD = {"builder": "mlp", "hidden": [], "num_outputs": 2}


def digits_8_vs_9(seed: int = 0):
    """Digits 8 and 9 (label 1 for a 9), shuffled, as (n, 8, 8, 1)."""
    d = load_digits()
    keep = d["target"] >= 8
    images = (d["images"][keep] / 16.0).astype(np.float32)[..., None]
    y = (d["target"][keep] == 9).astype(np.int64)
    order = np.random.default_rng(seed).permutation(len(images))
    return images[order], y[order]


def head_probe(fn, train, test, y_test, device, epochs: int, head=None):
    """Featurize with ``fn`` (head cut), fit the linear head, score the
    test rows: ``(accuracy, seconds, fitted model, train features)``.
    ``head``: the head's initial ``NNFunction`` (default: drawn from the
    learner's seed, 0)."""
    from mmlspark_tpu_torch.automl.train import TrainClassifier
    from mmlspark_tpu_torch.models.featurizer import ImageFeaturizer
    from mmlspark_tpu_torch.models.trainer import NNLearner
    featurizer = ImageFeaturizer(model=fn, input_col="image",
                                 output_col="embedding", cut_output_layers=1,
                                 device=device)
    # linear softmax head = the reference's LogisticRegression role
    clf = TrainClassifier(
        model=NNLearner(arch=HEAD, model=head, epochs=epochs, batch_size=64,
                        learning_rate=0.2, log_every=0, device=device),
        label_col="label")
    feats = featurizer.transform(train)
    with timed() as t:
        model = clf.fit(feats.select(["embedding", "label"]))
    scored = model.transform(featurizer.transform(test)
                             .select(["embedding", "label"]))
    pred = np.asarray(scored["scores"]).argmax(axis=1)
    return (float((pred == y_test).mean()), t.seconds, model,
            np.stack(list(feats["embedding"])))


def run(device=None, seed: int = 0, epochs: int = 60,
        n_cifar: int = 800, heads=None, random_backbones=None,
        gate: bool = True) -> dict:
    """``heads``: ``{"digits": fn, "cifar": fn}``, the heads' initial
    ``NNFunction`` on each backbone's features (default: drawn from the
    learner's seed, 0); ``random_backbones``: ``(digits, cifar)``
    random-init backbones (default: drawn from seed 3, as the JAX script
    does)."""
    heads = heads or {}
    from mmlspark_tpu_torch.core.dataframe import DataFrame
    from mmlspark_tpu_torch.models.function import NNFunction
    from mmlspark_tpu_torch.testing.datagen import synth_cifar

    images, y = digits_8_vs_9(seed)
    n_tr = len(images) // 2
    train = DataFrame({"image": images[:n_tr], "label": y[:n_tr]})
    test = DataFrame({"image": images[n_tr:], "label": y[n_tr:]})
    _, backbone = _zoo.load("digits_resnet8")
    _, cifar_bb = _zoo.load("cifar10s_resnet20")
    if random_backbones is None:
        random_backbones = (
            NNFunction.init(backbone.arch, input_shape=(8, 8, 1), seed=3),
            NNFunction.init(cifar_bb.arch, input_shape=(32, 32, 3), seed=3))

    lines, out = [], {"name": "transfer_learning"}
    runs = {}
    for tag, fn in (("pretrained", backbone),
                    ("random", random_backbones[0])):
        runs[tag] = head_probe(fn, train, test, y[n_tr:], device, epochs,
                               heads.get("digits"))
    acc_pre, acc_rand = runs["pretrained"][0], runs["random"][0]
    lines.append(f"pretrained zoo backbone (8 vs 9): accuracy={acc_pre:.3f} "
                 f"({runs['pretrained'][1]:.2f}s)")
    lines.append(f"random-init backbone    (8 vs 9): "
                 f"accuracy={acc_rand:.3f} ({runs['random'][1]:.2f}s)")
    if gate:
        assert acc_pre >= acc_rand, "pretrained features should win"
    lines.append(f"transfer lift: +{(acc_pre - acc_rand) * 100:.1f} points "
                 f"over random features")

    # CIFAR-scale transfer: the zoo's TRAINED ResNet-20 backbone on
    # pattern families 10/11, which its training never saw
    Xc, yc = synth_cifar(n_cifar, seed=42, classes=(10, 11))
    Xc = Xc.astype(np.float32) / 255.0
    nc = len(Xc) // 2
    ctrain = DataFrame({"image": Xc[:nc], "label": yc[:nc]})
    ctest = DataFrame({"image": Xc[nc:], "label": yc[nc:]})
    for tag, fn in (("cifar_pretrained", cifar_bb),
                    ("cifar_random", random_backbones[1])):
        runs[tag] = head_probe(fn, ctrain, ctest, yc[nc:], device, epochs,
                               heads.get("cifar"))
    acc_c_pre, acc_c_rand = runs["cifar_pretrained"][0], \
        runs["cifar_random"][0]
    lines.append(f"cifar zoo backbone   (unseen families): "
                 f"accuracy={acc_c_pre:.3f}")
    lines.append(f"random-init backbone (unseen families): "
                 f"accuracy={acc_c_rand:.3f}")
    if gate:
        assert acc_c_pre >= acc_c_rand, "pretrained features should win"
    lines.append(f"cifar transfer lift: +{(acc_c_pre - acc_c_rand) * 100:.1f}"
                 f" points over random features")
    out.update({f"accuracy_{k}": v[0] for k, v in runs.items()})
    out.update({f"fit_s_{k}": v[1] for k, v in runs.items()})
    out["_runs"] = runs
    out["lines"] = lines
    return out


def main(argv=None) -> dict:
    return run_main(__doc__, run, argv)


if __name__ == "__main__":
    main()
