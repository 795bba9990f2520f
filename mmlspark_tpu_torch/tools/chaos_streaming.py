"""Chaos-drive the retrain->redeploy loop: a live fleet serves
idempotent traffic, its own committed request/reply rows journal into
the traffic capture, a ``fit_stream`` query retrains the model from
them, and a ``RetrainLoop`` pushes the resulting digest-manifested
checkpoint through the coordinator's canary rollout — while one worker
is SIGKILLed in the middle of the loop.

Counterpart of ``tools/chaos_streaming.py`` through the port: the
workers serve an ``NNModel`` on the card (on the CPU under ``--device
cpu``, which hands them ``MMLSPARK_TPU_SERVING_CPU=1``), and the trainer
and the loop run on the same device.

The multi-process companion to ``tests/test_streaming_engine.py``
(which pins the same loop in-process): real OS worker processes (the
``ServingServer`` the k8s pods run, each with its own
``TrafficCapture`` directory under one shared parent the driver's
``TrafficLogSource`` merges), a real coordinator, and a
``ServingClient`` pushing traffic with labels throughout.

Pass (exit 0) iff:
  * the rollout the loop pushed ends ``completed`` — the survivors
    finish the flip despite the kill;
  * ``GET /fleet`` reports ONE coherent (retrained) version across the
    responding workers;
  * ZERO client requests were dropped or answered malformed at any
    point (zero downtime, zero wrong replies);
  * the trainer's exactly-once counters are clean: every micro-batch
    id trained at most once (no replay double-trained).

    python -m mmlspark_tpu_torch.tools.chaos_streaming  # defaults: 3 workers
    python -m mmlspark_tpu_torch.tools.chaos_streaming --workers 4 --seed 7
"""

import argparse
import json
import os
import signal
import sys
import tempfile
import threading
import time

from mmlspark_tpu_torch.tools import chaos_serving
from mmlspark_tpu_torch.tools.chaos_serving import spawn_worker

STREAM_WORKER_SCRIPT = """
import os, sys, time
if os.environ.get("MMLSPARK_TPU_SERVING_CPU") == "1":
    from mmlspark_tpu_torch.core.serialize import set_default_load_device
    set_default_load_device("cpu")
from mmlspark_tpu_torch.serving.server import ServingServer, ServingCoordinator
from mmlspark_tpu_torch.serving.capture import TrafficCapture
from mmlspark_tpu_torch.core.stage import PipelineStage

# argv: coord_url, model_dir, capture_dir, journal
model = PipelineStage.load(sys.argv[2])
srv = ServingServer(model, max_latency_ms=1, max_batch_size=4,
                    journal_path=sys.argv[4], model_version="v1",
                    capture=TrafficCapture(sys.argv[3]),
                    slow_trace_ms=None)
srv.warmup({"x": [0.0, 0.0], "label": 0.0})
srv.start()
ServingCoordinator.register_worker(sys.argv[1], srv.host, srv.port)
print(srv.port, flush=True)
while True:
    time.sleep(1)
"""


def retrain_loop_drill(tmp: str, seed: int, n_workers: int = 3,
                       device=None) -> dict:
    import numpy as np
    import requests

    from mmlspark_tpu_torch.models.function import NNFunction
    from mmlspark_tpu_torch.models.nn import NNModel
    from mmlspark_tpu_torch.models.trainer import NNLearner
    from mmlspark_tpu_torch.serving.server import (
        ServingClient, ServingCoordinator)
    from mmlspark_tpu_torch.streaming import RetrainLoop, TrafficLogSource

    # v1: an untrained tiny MLP, digest-manifested
    v1_dir = os.path.join(tmp, "model_v1")
    fn = NNFunction.init({"builder": "mlp", "hidden": [4],
                          "num_outputs": 1}, (2,), seed=seed)
    NNModel(model=fn, input_col="x", output_col="scores",
            device=device).save(v1_dir)
    capdir = os.path.join(tmp, "capture")
    warm = {"x": [0.0, 0.0], "label": 0.0}

    coord = ServingCoordinator().start()
    coord_url = f"http://{coord.host}:{coord.port}"
    workers = [
        spawn_worker(coord_url, os.path.join(tmp, f"j{i}.jsonl"),
                     STREAM_WORKER_SCRIPT, v1_dir,
                     os.path.join(capdir, f"w{i}"))
        for i in range(n_workers)]

    stats = {"n_ok": 0, "n_wrong": 0, "dropped": [],
             "killed_during": None}
    stop = threading.Event()
    client = ServingClient(coord_url, timeout=10)
    rng = np.random.default_rng(seed)

    def traffic() -> None:
        i = 0
        while not stop.is_set():
            i += 1
            x = rng.normal(size=2)
            rid = f"stream-{seed}-{i}"
            try:
                out = client.predict(
                    {"x": x.tolist(), "label": float(x.sum())},
                    request_id=rid)
            except Exception as e:  # noqa: BLE001 — a dropped request
                stats["dropped"].append({"rid": rid, "error": str(e)})
                continue
            # versions flip mid-traffic, so scores change — a correct
            # reply is a well-formed scores vector, from ANY version
            if isinstance(out.get("scores"), list) and out["scores"]:
                stats["n_ok"] += 1
            else:
                stats["n_wrong"] += 1

    t = threading.Thread(target=traffic)
    t.start()
    final = fleet = None
    loop = fit = None
    try:
        # -- stream the fleet's own traffic into the trainer
        learner = NNLearner(
            arch={"builder": "mlp", "hidden": [4], "num_outputs": 1},
            features_col="x", label_col="label", loss="squared_error",
            optimizer="adam", learning_rate=0.02, batch_size=16,
            checkpoint_dir=os.path.join(tmp, "train"), device=device)
        fit = learner.fit_stream(
            TrafficLogSource(capdir),
            export_dir=os.path.join(tmp, "exports"),
            export_every_batches=2,
            checkpoint_dir=os.path.join(tmp, "wal"),
            max_batch_rows=32, trigger_interval_s=0.05)
        fit.query.start()
        deadline = time.perf_counter() + 90
        while time.perf_counter() < deadline and not fit.exports:
            time.sleep(0.1)
        if not fit.exports:
            raise RuntimeError("fit_stream produced no export in 90s "
                               f"(query: {fit.query.status()})")

        # -- the loop pushes it through the canary; canary_min_requests
        # sized so the kill lands mid-rollout
        loop = RetrainLoop(
            os.path.join(tmp, "exports"), coord_url,
            warmup_payload=warm, poll_interval_s=0.05,
            rollout={"canary": True, "canary_min_requests": 120,
                     "canary_window_s": 10.0, "stage_timeout_s": 60.0,
                     "poll_interval_s": 0.05}).start()

        deadline = time.perf_counter() + 30
        state = "pending"
        while time.perf_counter() < deadline:
            st = requests.get(coord_url + "/rollout", timeout=10).json()
            state = st.get("state", "idle")
            if state in ("canary", "flipping", "completed",
                         "rolled_back", "failed"):
                break
            time.sleep(0.05)
        # SIGKILL a NON-canary worker (the orchestrator canaries the
        # first registered) in the middle of the loop's rollout
        stats["killed_during"] = state
        os.kill(workers[-1].pid, signal.SIGKILL)
        workers[-1].wait()

        deadline = time.perf_counter() + 90
        while time.perf_counter() < deadline \
                and loop.n_completed == 0 and loop.n_failed == 0 \
                and loop.n_rolled_back == 0:
            time.sleep(0.1)
        loop.stop()
        fit.query.stop()
        # the loop may have pushed a newer export before stop() landed:
        # wait for the coordinator's in-flight rollout to reach a
        # terminal state before judging fleet coherence
        deadline = time.perf_counter() + 60
        while time.perf_counter() < deadline:
            st = requests.get(coord_url + "/rollout", timeout=10).json()
            if st.get("state") in ("idle", "completed", "rolled_back",
                                   "failed"):
                break
            time.sleep(0.1)
        final = loop.status()
        if st.get("state") == "completed":
            final["history"].append(
                {"version": st["version"], "state": "completed"})
        fleet = requests.get(coord_url + "/fleet", timeout=10).json()
        trainer = fit.status()["trainer"]
    finally:
        stop.set()
        t.join()
        if loop is not None:
            loop.stop()
        if fit is not None:
            fit.query.stop()
        for w in workers:
            if w.poll() is None:
                w.kill()
                w.wait()
        coord.stop()

    completed = [h["version"] for h in (final["history"] if final else [])
                 if h.get("state") == "completed"]
    # a trailing rolled-back push leaves the fleet on the last
    # COMPLETED version — that is the coherence target
    new_version = completed[-1] if completed else None
    # exactly-once evidence: batch ids trained once each — the count of
    # trained batches equals the high-water id minus replays skipped
    exactly_once = (trainer["n_batches_trained"]
                    + trainer["n_replays_skipped"]
                    <= trainer["last_trained_batch"]
                    and trainer["n_batches_trained"] > 0) if final \
        else False
    ok = (final is not None
          and new_version is not None
          and stats["killed_during"] in ("staging", "shadow", "canary",
                                         "flipping")
          and fleet is not None
          and fleet.get("model_versions") == [new_version]
          and fleet.get("version_coherent")
          and fleet.get("n_responding") == n_workers - 1
          and stats["n_wrong"] == 0 and not stats["dropped"]
          and stats["n_ok"] > 0
          and exactly_once)
    return {
        "what": "retrain->redeploy loop with a worker SIGKILLed "
                "mid-loop; survivors must serve the retrained version",
        "n_workers": n_workers,
        "killed_during": stats["killed_during"],
        "loop": {"n_pushed": final["n_pushed"] if final else 0,
                 "history": final["history"][-3:] if final else []},
        "fleet_versions": fleet.get("model_versions") if fleet else None,
        "version_coherent": fleet.get("version_coherent")
        if fleet else None,
        "n_responding": fleet.get("n_responding") if fleet else None,
        "trainer": trainer if final else None,
        "exactly_once": exactly_once,
        "traffic": {"n_ok": stats["n_ok"], "n_wrong": stats["n_wrong"],
                    "n_dropped": len(stats["dropped"]),
                    "dropped": stats["dropped"][:5]},
        "ok": ok,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workers", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cpu, or the card (the default; raises without "
                         "CUDA)")
    args = ap.parse_args(argv)
    from mmlspark_tpu_torch.core.environment import resolve_device
    device = str(resolve_device(args.device))
    chaos_serving.DEVICE = "cpu" if device == "cpu" else None
    with tempfile.TemporaryDirectory(prefix="chaos_streaming_") as tmp:
        report = retrain_loop_drill(tmp, args.seed,
                                    n_workers=args.workers, device=device)
    print(json.dumps(report, indent=2, default=str))
    print(f"\n[chaos_streaming] {'PASS' if report['ok'] else 'FAIL'}")
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
