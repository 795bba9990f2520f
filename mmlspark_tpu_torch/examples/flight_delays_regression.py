"""Plain-regression pipeline: Featurize -> TrainRegressor -> statistics.

Counterpart of ``examples/flight_delays_regression.py``: a synthetic
flight-delays-shaped frame (carrier/origin/dest categoricals and
schedule numerics), ``TrainRegressor`` over the port's GBDT (value
indexing and assembly inside it), then ``ComputeModelStatistics`` and
``ComputePerInstanceStatistics`` on the held-out predictions.
"""

from __future__ import annotations

import numpy as np

from mmlspark_tpu_torch.examples._common import run_main, timed


def make_frame(seed: int = 0, n: int = 6000) -> dict:
    rng = np.random.default_rng(seed)
    carriers = np.array(["AA", "DL", "UA", "WN", "B6"])
    airports = np.array([f"AP{i}" for i in range(12)])
    carrier = rng.choice(carriers, n)
    origin = rng.choice(airports, n)
    dest = rng.choice(airports, n)
    dep_hour = rng.integers(5, 23, n).astype(np.float64)
    distance = rng.uniform(150, 2500, n)
    day_of_week = rng.integers(1, 8, n).astype(np.float64)
    # delays: evening rush + long-haul + carrier effects + noise
    delay = (4.0 * np.maximum(dep_hour - 15, 0)
             + 0.006 * distance
             + 10.0 * (carrier == "B6")
             + 5.0 * np.isin(day_of_week, [5, 7])
             + rng.gamma(2.0, 4.0, n) - 8.0)
    return {"carrier": carrier, "origin": origin, "dest": dest,
            "dep_hour": dep_hour, "distance": distance,
            "day_of_week": day_of_week, "arr_delay": delay}


def run(device=None, seed: int = 0, n: int = 6000, n_train: int = 5000,
        num_iterations: int = 60, num_leaves: int = 31) -> dict:
    from mmlspark_tpu_torch.core.dataframe import DataFrame
    from mmlspark_tpu_torch.gbdt import GBDTRegressor
    from mmlspark_tpu_torch.automl.train import TrainRegressor
    from mmlspark_tpu_torch.automl.metrics import (
        ComputeModelStatistics, ComputePerInstanceStatistics)

    df = DataFrame(make_frame(seed, n))
    train, test = df.head(n_train), df.take(np.arange(n_train, n))
    reg = TrainRegressor(
        model=GBDTRegressor(num_iterations=num_iterations,
                            num_leaves=num_leaves, min_data_in_leaf=10,
                            device=device),
        label_col="arr_delay")
    with timed() as t:
        model = reg.fit(train)
    scored = model.transform(test)

    stats = ComputeModelStatistics(label_col="arr_delay").evaluate(scored)
    row = {c: float(stats[c][0]) for c in stats.columns}
    per_row = ComputePerInstanceStatistics(
        label_col="arr_delay").evaluate(scored)
    worst = float(np.sort(per_row["L1_loss"])[-10:].mean())
    mean_err = float(np.mean(per_row["L1_loss"]))
    assert row["R^2"] > 0.5, row["R^2"]
    return {"name": "flight_delays_regression", "fit_s": t.seconds,
            "rmse": row["root_mean_squared_error"], "r2": row["R^2"],
            "mean_abs_err": mean_err, "worst10_abs_err": worst,
            "_model": model,
            "lines": [f"fit {train.num_rows} flights in {t.seconds:.2f}s; "
                      f"test RMSE={row['root_mean_squared_error']:.2f} min, "
                      f"R^2={row['R^2']:.3f}, mean|err|={mean_err:.2f}, "
                      f"10-worst|err|={worst:.1f}"]}


def main(argv=None) -> dict:
    return run_main(__doc__, run, argv)


if __name__ == "__main__":
    main()
