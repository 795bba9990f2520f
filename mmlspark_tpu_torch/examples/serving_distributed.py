"""Distributed serving: worker fleet + coordinator + failover client.

Counterpart of ``examples/serving_distributed.py``: three worker
processes each serve the same fitted GBDT (on the card, or on the CPU
under ``--device cpu``), register with a coordinator, and a
``ServingClient`` round-robins requests across them with idempotent
request ids. One worker is killed mid-stream; every request is still
answered, and a re-submitted request id returns the journaled reply
without re-running inference.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import urllib.request

import numpy as np

from mmlspark_tpu_torch.examples._common import (
    build_kernels, run_main, timed, worker_env)

WORKER = """
import os, sys, time
if os.environ.get("MMLSPARK_TPU_SERVING_CPU") == "1":
    from mmlspark_tpu_torch.core.serialize import set_default_load_device
    set_default_load_device("cpu")
from mmlspark_tpu_torch.core.stage import PipelineStage
from mmlspark_tpu_torch.serving.server import ServingServer, ServingCoordinator

model = PipelineStage.load(sys.argv[2])       # the fitted pipeline
srv = ServingServer(model, max_latency_ms=2.0).start()
ServingCoordinator.register_worker(sys.argv[1], srv.host, srv.port)
print(srv.port, flush=True)
while True:
    time.sleep(1)
"""


def run(device=None, seed: int = 0, n_workers: int = 3,
        n_requests: int = 30, num_iterations: int = 20) -> dict:
    from mmlspark_tpu_torch.core.dataframe import DataFrame
    from mmlspark_tpu_torch.gbdt import GBDTRegressor
    from mmlspark_tpu_torch.serving.server import (
        ServingClient, ServingCoordinator)

    rng = np.random.default_rng(seed)
    X = rng.normal(size=(1024, 6))
    y = X @ np.arange(1, 7) + 0.1 * rng.normal(size=1024)
    model = GBDTRegressor(num_iterations=num_iterations, num_leaves=15,
                          device=device).fit(
        DataFrame({"features": X, "label": y}))
    # the workers load the kernels the parent built
    build_kernels(device)
    env = worker_env(device)
    lines = []
    out = {"name": "serving_distributed"}
    with tempfile.TemporaryDirectory() as td:
        model_dir = os.path.join(td, "model")
        model.save(model_dir)

        with ServingCoordinator() as coord:
            base = f"http://{coord.host}:{coord.port}"
            procs = [subprocess.Popen(
                [sys.executable, "-c", WORKER, base, model_dir],
                stdout=subprocess.PIPE, env=env, text=True)
                for _ in range(n_workers)]
            try:
                for p in procs:
                    if not p.stdout.readline():  # up + registered
                        raise RuntimeError(f"a worker died on start "
                                           f"(rc={p.wait()})")
                client = ServingClient(base)
                lines.append(f"{n_workers} workers registered: "
                             f"{client._workers}")

                local = np.asarray(model.transform(
                    DataFrame({"features": X[:n_requests]}))["prediction"])
                diff = 0.0
                with timed() as t:
                    for i in range(n_requests):
                        r = client.predict(
                            {"features": list(map(float, X[i]))})
                        diff = max(diff, abs(r["prediction"] - local[i]))
                        assert abs(r["prediction"] - local[i]) < 1e-6
                lines.append(f"{n_requests} requests round-robined in "
                             f"{t.seconds:.2f}s; served == local "
                             f"predictions")

                procs[0].kill()
                procs[0].wait()
                for i in range(n_requests, 2 * n_requests):
                    client.predict({"features": list(map(float, X[i]))})
                lines.append(f"worker killed mid-stream; {n_requests} more "
                             f"requests OK ({len(client._dead)} marked "
                             f"dead)")

                # exactly-once: re-submitting a request id replays the
                # journaled reply instead of re-running inference
                worker = [w for w in client._workers
                          if w not in client._dead][0]
                req = urllib.request.Request(
                    worker, json.dumps(
                        {"features": list(map(float, X[0]))}).encode(),
                    {"Content-Type": "application/json",
                     "X-Request-Id": "req-0"})
                body1 = urllib.request.urlopen(req, timeout=10).read()
                second = urllib.request.urlopen(req, timeout=10)
                assert second.read() == body1
                replayed = second.headers.get("X-Replayed")
                assert replayed == "1", replayed
                lines.append("re-submitted request id replayed the "
                             "committed reply (X-Replayed: 1)")
                out.update(served_vs_local=diff, round_robin_s=t.seconds,
                           n_dead=len(client._dead), replayed=True)
            finally:
                for p in procs:
                    p.kill()
                    p.wait()
    lines.append("OK")
    out["lines"] = lines
    return out


def main(argv=None) -> dict:
    return run_main(__doc__, run, argv)


if __name__ == "__main__":
    main()
