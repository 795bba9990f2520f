"""Serve a fitted pipeline as a web service (Spark Serving parity).

Counterpart of ``examples/serving_demo.py``: requests become rows, the
port's GBDT scores micro-batches on the card, replies route back per
request, with 32 concurrent clients sharing one batched dispatch.
"""

from __future__ import annotations

import json
import threading
import urllib.request

import numpy as np

from mmlspark_tpu_torch.examples._common import run_main, timed


def make_data(seed: int = 0, n: int = 1024):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 6))
    y = X @ np.arange(1, 7) + 0.1 * rng.normal(size=n)
    return X, y


def run(device=None, seed: int = 0, n_requests: int = 32,
        num_iterations: int = 30) -> dict:
    from mmlspark_tpu_torch.core.dataframe import DataFrame
    from mmlspark_tpu_torch.gbdt import GBDTRegressor
    from mmlspark_tpu_torch.serving import ServingServer

    X, y = make_data(seed)
    model = GBDTRegressor(num_iterations=num_iterations, num_leaves=15,
                          device=device).fit(
        DataFrame({"features": X, "label": y}))
    local = np.asarray(model.transform(
        DataFrame({"features": X[:n_requests]}))["prediction"])

    with ServingServer(model, max_batch_size=64,
                       max_latency_ms=20.0) as server:
        results = [None] * n_requests

        def hit(i):
            req = urllib.request.Request(
                server.address,
                data=json.dumps({"features": X[i].tolist()}).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=30) as resp:
                results[i] = json.loads(resp.read())["prediction"]

        with timed() as t:
            threads = [threading.Thread(target=hit, args=(i,))
                       for i in range(n_requests)]
            for th in threads:
                th.start()
            for th in threads:
                th.join()
    served = np.asarray(results, dtype=np.float64)
    err = float(np.abs(served - y[:n_requests]).mean())
    served_vs_local = float(np.abs(served - local).max())
    return {"name": "serving_demo", "serve_s": t.seconds,
            "n_requests": n_requests, "mean_abs_err": err,
            "served_vs_local": served_vs_local, "_served": served,
            "_model": model,
            "lines": [f"served {n_requests} concurrent requests in "
                      f"{t.seconds:.2f}s, mean abs err vs train labels "
                      f"{err:.2f}"]}


def main(argv=None) -> dict:
    return run_main(__doc__, run, argv)


if __name__ == "__main__":
    main()
