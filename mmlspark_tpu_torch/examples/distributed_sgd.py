"""BASELINE config 5: distributed data-parallel SGD training.

Counterpart of ``examples/distributed_sgd.py``: ``NNLearner`` trains a
ResNet-8 with the batch over a ``{"data": -1}`` mesh. In one process the
mesh is hosted on the one device (one rank on the card); the gradient
is the global batch's, as JAX's all-reduce makes it.
"""

from __future__ import annotations

import numpy as np

from mmlspark_tpu_torch.examples._common import run_main, timed

ARCH = {"builder": "cifar_resnet", "depth": 8, "width": 8}


def make_data(seed: int = 0, n: int = 4096, side: int = 16):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 10, n)
    X = (rng.normal(size=(n, side, side, 3)) * 0.1
         + (y / 10.0)[:, None, None, None]).astype(np.float32)
    return X, y


def run(device=None, seed: int = 0, n: int = 4096, epochs: int = 4,
        batch_size: int = 256, learning_rate: float = 0.05,
        init=None) -> dict:
    """``init``: the network's initial ``NNFunction`` (default: drawn
    from the learner's seed, 0)."""
    from mmlspark_tpu_torch.core.dataframe import DataFrame
    from mmlspark_tpu_torch.models.trainer import NNLearner

    X, y = make_data(seed, n)
    df = DataFrame({"features": X, "label": y})
    learner = NNLearner(arch=ARCH, model=init, epochs=epochs,
                        batch_size=batch_size, learning_rate=learning_rate,
                        mesh_shape={"data": -1}, device=device)
    with timed() as t:
        model = learner.fit(df)
    scores = np.asarray(model.transform(df)["scores"])
    acc = float((scores.argmax(axis=1) == y).mean())
    losses = np.concatenate(learner.losses)
    return {"name": "distributed_sgd", "fit_s": t.seconds,
            "train_accuracy": acc, "final_loss": float(losses[-1]),
            "_losses": losses, "_model": model,
            "lines": [f"data-parallel SGD over 1 device(s): "
                      f"{t.seconds:.1f}s, train accuracy={acc:.3f}"]}


def main(argv=None) -> dict:
    return run_main(__doc__, run, argv)


if __name__ == "__main__":
    main()
