"""BASELINE config 2: binary GBDT with the data-parallel tree learner.

Counterpart of ``examples/adult_census_binary.py``: a synthetic
census-shaped table (mixed numeric and categorical columns) through
``GBDTClassifier(parallelism="data_parallel")``. In one process the
stage fits on one device (``gbdt/stages._sharding``); the histograms are
the port's kernel on the card.
"""

from __future__ import annotations

import numpy as np

from mmlspark_tpu_torch.examples._common import run_main, timed


def make_data(seed: int = 0, n: int = 8192):
    rng = np.random.default_rng(seed)
    age = rng.integers(17, 90, n).astype(np.float64)
    hours = rng.integers(1, 99, n).astype(np.float64)
    edu = rng.integers(0, 16, n).astype(np.float64)      # categorical
    occ = rng.integers(0, 14, n).astype(np.float64)      # categorical
    gain = rng.exponential(600, n)
    logit = 0.04 * (age - 38) + 0.05 * (hours - 40) + 0.25 * (edu - 9) \
        + 0.001 * gain + 0.3 * np.isin(occ, [3, 9, 11])
    y = (logit + rng.logistic(size=n) > 1.0).astype(np.int64)
    X = np.stack([age, hours, edu, occ, gain], axis=1)
    return X, y


def run(device=None, seed: int = 0, n: int = 8192,
        num_iterations: int = 60, num_leaves: int = 31) -> dict:
    from mmlspark_tpu_torch.core.dataframe import DataFrame
    from mmlspark_tpu_torch.gbdt import GBDTClassifier

    X, y = make_data(seed, n)
    df = DataFrame({"features": X, "income": y})
    clf = GBDTClassifier(label_col="income", num_iterations=num_iterations,
                         num_leaves=num_leaves, parallelism="data_parallel",
                         categorical_feature_indexes=[2, 3], device=device)
    with timed() as t:
        model = clf.fit(df)
    pred = np.asarray(model.transform(df)["prediction"])
    acc = float((pred == y).mean())
    return {"name": "adult_census_binary", "fit_s": t.seconds,
            "accuracy": acc, "_model": model, "_prediction": pred,
            "lines": [f"binary fit, rows sharded over 1 device(s): "
                      f"{t.seconds:.2f}s, train accuracy={acc:.3f}"]}


def main(argv=None) -> dict:
    return run_main(__doc__, run, argv)


if __name__ == "__main__":
    main()
