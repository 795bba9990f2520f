"""BASELINE config 3: CIFAR10 ResNet scoring throughput (the bench metric).

Counterpart of ``examples/cifar10_resnet_scoring.py``: the zoo's TRAINED
``cifar10s_resnet20`` (hash-verified fetch) through ``NNModel`` on the
card, raw uint8 images normalized on the device, scored on a fresh draw
of the corpus it was trained on; the example reports real accuracy.
"""

from __future__ import annotations

import numpy as np

from mmlspark_tpu_torch.examples import _zoo
from mmlspark_tpu_torch.examples._common import run_main, timed

#: the JAX script's draw: the full 10k on a chip, 2048 on the CPU
N_CARD, N_CPU = 10_240, 2048


def run(device=None, n=None, seed: int = 123_456,
        batch_size: int = 1024) -> dict:
    from mmlspark_tpu_torch.core.dataframe import DataFrame
    from mmlspark_tpu_torch.models.nn import NNModel
    from mmlspark_tpu_torch.testing.datagen import synth_cifar

    meta, fn = _zoo.load("cifar10s_resnet20")
    lines = [f"zoo model {meta.name} (trained on {meta.dataset}, "
             f"hash {meta.hash[:12]}...)"]
    if n is None:
        n = N_CPU if str(device) == "cpu" else N_CARD
    images, labels = synth_cifar(n, seed=seed)   # fresh draw
    df = DataFrame({"image": images})
    scorer = NNModel(model=fn, input_col="image", output_col="scores",
                     batch_size=batch_size, input_dtype=meta.input_dtype,
                     device=device)
    scorer.transform(df.head(min(batch_size, n)))  # warm
    with timed() as t:
        out = scorer.transform(df)
    scores = np.asarray(out["scores"])
    assert scores.shape == (n, 10), scores.shape
    acc = float((scores.argmax(1) == labels).mean())
    rate = n / t.seconds
    synth = meta.dataset.startswith("synth")
    caveat = (" [on the procedural SURROGATE corpus — not real CIFAR-10; "
              "republish via mmlspark_tpu_torch.tools.train_zoo_models when "
              "real files exist]" if synth else "")
    lines.append(f"resnet20 scoring: {rate:.0f} images/sec/chip "
                 f"(1 device(s)), accuracy={acc:.4f}{caveat}")
    if synth:   # gate matches the corpus
        assert acc > 0.85, acc
    return {"name": "cifar10_resnet_scoring", "n": n, "score_s": t.seconds,
            "images_per_s": rate, "accuracy": acc, "_scores": scores,
            "lines": lines}


def main(argv=None) -> dict:
    return run_main(__doc__, run, argv)


if __name__ == "__main__":
    main()
