"""BASELINE config 1: quantile-regression GBDT fit (drug-discovery shape).

Counterpart of ``examples/drug_discovery_quantile.py``: the same stage,
``GBDTRegressor(objective='quantile')``, over a synthetic descriptor
matrix with the notebook's shape, fitted by the port's histogram kernel
on the card.
"""

from __future__ import annotations

import numpy as np

from mmlspark_tpu_torch.examples._common import run_main, timed


def make_data(seed: int = 0, n: int = 4096, f: int = 100):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, f))
    y = X[:, :5].sum(axis=1) + 0.3 * rng.normal(size=n) + 5.0
    return X, y


def run(device=None, seed: int = 0, n: int = 4096, f: int = 100,
        num_iterations: int = 40, num_leaves: int = 15) -> dict:
    from mmlspark_tpu_torch.core.dataframe import DataFrame
    from mmlspark_tpu_torch.gbdt import GBDTRegressor

    X, y = make_data(seed, n, f)
    df = DataFrame({"features": X, "label": y})
    reg = GBDTRegressor(objective="quantile", alpha=0.9,
                        num_iterations=num_iterations,
                        num_leaves=num_leaves, device=device)
    with timed() as t:
        model = reg.fit(df)
    pred = np.asarray(model.transform(df)["prediction"])
    coverage = float((pred >= y).mean())
    return {"name": "drug_discovery_quantile", "fit_s": t.seconds,
            "coverage": coverage, "_model": model,
            "lines": [f"quantile fit on 1 device(s): {t.seconds:.2f}s, "
                      f"P90 coverage={coverage:.3f} (target ~0.9)"]}


def main(argv=None) -> dict:
    return run_main(__doc__, run, argv)


if __name__ == "__main__":
    main()
