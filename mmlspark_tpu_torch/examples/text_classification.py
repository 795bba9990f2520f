"""Text analytics pipeline: TextFeaturizer -> TrainClassifier.

Counterpart of ``examples/text_classification.py``: tokenize, hash and
weigh the documents (``TextFeaturizer``), then a ``TrainClassifier``
over the port's GBDT.
"""

from __future__ import annotations

import numpy as np

from mmlspark_tpu_torch.examples._common import run_main, timed

POS_WORDS = ["great", "excellent", "love", "wonderful", "amazing"]
NEG_WORDS = ["terrible", "awful", "hate", "broken", "waste"]
FILLER = ["the", "product", "it", "was", "very", "quite", "device"]


def make_docs(seed: int = 0, n: int = 400):
    rng = np.random.default_rng(seed)

    def doc(label):
        src = POS_WORDS if label else NEG_WORDS
        words = list(rng.choice(FILLER, 6)) + list(rng.choice(src, 3))
        rng.shuffle(words)
        return " ".join(words)

    y = rng.integers(0, 2, n)
    return [doc(int(l)) for l in y], y


def run(device=None, seed: int = 0, n: int = 400, num_features: int = 256,
        num_iterations: int = 20, num_leaves: int = 7) -> dict:
    from mmlspark_tpu_torch.core.dataframe import DataFrame
    from mmlspark_tpu_torch.featurize.text import TextFeaturizer
    from mmlspark_tpu_torch.automl.train import TrainClassifier
    from mmlspark_tpu_torch.gbdt import GBDTClassifier

    docs, y = make_docs(seed, n)
    df = DataFrame({"text": docs, "label": y})
    with timed() as t:
        feats_model = TextFeaturizer(input_col="text", output_col="feats",
                                     num_features=num_features,
                                     device=device).fit(df)
        feats = feats_model.transform(df)
        model = TrainClassifier(
            model=GBDTClassifier(num_iterations=num_iterations,
                                 num_leaves=num_leaves, device=device),
            label_col="label").fit(feats.select(["feats", "label"]))
    scored = model.transform(feats.select(["feats", "label"]))
    pred = np.asarray(scored["prediction"])
    acc = float((pred == y).mean())
    return {"name": "text_classification", "fit_s": t.seconds,
            "accuracy": acc, "_feats": feats, "_model": model,
            "_prediction": pred,
            "lines": [f"text classification: {t.seconds:.1f}s, "
                      f"accuracy={acc:.3f}"]}


def main(argv=None) -> dict:
    return run_main(__doc__, run, argv)


if __name__ == "__main__":
    main()
