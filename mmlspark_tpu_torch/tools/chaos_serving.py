"""Chaos-drive a serving fleet: kill/restart a worker mid-traffic under
a seeded FaultPlan and report recovery stats.

Counterpart of ``tools/chaos_serving.py``, the same eight drills through
the port's serving stack. Every worker process imports
``mmlspark_tpu_torch`` only. The decode worker of the prefix-cache drill
serves on the card (K1-K3, the paged decode, prefill and prefix-prefill
kernels) and reports the launches it counted; under ``--device cpu``
every worker gets ``MMLSPARK_TPU_SERVING_CPU=1`` and serves on the CPU.
The other workers serve host-side stages.

The multi-process companion to ``tests/test_resilience.py``: real OS
worker processes (the same ``ServingServer`` the k8s pods run), a real
coordinator, and a ``ServingClient`` pushing idempotent traffic while
the plan SIGKILLs a worker and later restarts it — the pod-crash drill,
reproducible from a seed. Exit code 0 iff every request was answered
correctly and no request was computed more than once per accepted
execution (journals verified via each worker's ``GET /status``).

    python -m mmlspark_tpu_torch.tools.chaos_serving    # defaults: 120 reqs
    python -m mmlspark_tpu_torch.tools.chaos_serving --requests 300 \
        --kill-at 40 --restart-after 30 --seed 7

After the kill/restart drill, a second phase drives a concurrent
KEEP-ALIVE burst (N client threads sharing one ``ServingClient``, whose
pooled session holds a persistent connection per worker) and SIGKILLs a
worker mid-burst: the drill asserts the failover path retries every
affected request onto the survivors with ZERO dropped requests — the
in-flight requests already accepted by the surviving worker all
complete — and that the survivor's frontend counters prove the burst
actually rode kept-alive connections. ``--burst-threads 0`` skips the
phase.

A third phase drills the ZERO-DOWNTIME ROLLOUT machinery
(docs/serving.md "Zero-downtime rollout"): a fresh fleet of workers
serving a persisted v1 checkpoint, idempotent client traffic, then a
coordinator-orchestrated ``POST /rollout`` to a v2 checkpoint with
canary enabled — and one worker SIGKILLed in the middle of it. The
drill asserts the rollout still ends ``completed`` (survivors finish
the flip), ``GET /fleet`` reports ONE coherent version set across the
responding workers, and no logical client request was dropped or
answered wrongly at any point. ``--rollout-workers 0`` skips the phase.

A fourth phase drills the decode plane's CROSS-REQUEST PREFIX CACHE
(docs/serving.md "Prefix cache"): a live decode worker serves a
shared-prefix burst twice — pass 1 cold (prompt pages publish into
the radix index), pass 2 the same prompts under fresh rids (cached
pages attach, only suffixes prefill) — and the drill asserts hit
rate > 0, ZERO wrong tokens (pass 2 token-for-token equals pass 1),
and a clean refcount ledger on drain. ``--prefix-requests 0`` skips
it; ``--prefix-only`` runs JUST this phase (the fast smoke mode).

A fifth phase is the NOISY-NEIGHBOR drill (docs/serving.md "Tenancy &
overload control"): a two-worker tenancy-enabled fleet, a background
tenant flooding keep-alive connections at both workers while an
interactive tenant sends steady idempotent traffic through a
SIGKILL + journal-replay restart of one worker. Pass iff the
interactive tenant's error rate is ZERO (every logical request
answered correctly through the kill), its flooded p99 stays within
2x its quiet baseline (floored against dev-box jitter), the flood
tenant is actually shed (429s on the wire and ``n_shed_overload`` in
its ledger rows), every tenant ledger drains clean (inflight 0, no
release underflow), the restarted worker replayed a non-empty
journal, and the coordinator's ``GET /fleet`` merges both tenants'
rows. ``--tenancy-requests 0`` skips the phase.

A sixth phase drills the fleet SLO plane (docs/observability.md
"SLO engine"): a two-worker fleet behind a coordinator running fast
burn-rate windows, steady traffic proving ZERO false-positive alerts,
then one worker SIGKILLed — the drill asserts ``GET /fleet/alerts``
FIRES the ``fleet_availability`` policy with the victim (and only the
victim) in the per-worker attribution, and that after a replacement
worker heartbeats in the alert RESOLVES and the healed fleet stays
quiet. ``--slo-alerts-requests 0`` skips the phase.

A seventh phase drills the RETROSPECTIVE PLANE's baseline-relative
regression detection (docs/observability.md "The retrospective
plane"): an in-process worker with an embedded TSDB running a fast
recording rule over dispatch-latency p95 and an anomaly watch on the
rule's series. Steady traffic establishes the EWMA+MAD baseline
(ZERO false positives allowed); then the model is made 80 ms slower
mid-traffic and the drill asserts the ``dispatch_p95_regression``
anomaly FIRES on ``GET /alerts`` with per-bucket attribution; then
the slowdown is reverted, the short quantile window drains, and the
alert must RESOLVE and stay quiet. ``--regression-requests 0`` skips
the phase.

Phases 1-2 need no model artifact (workers serve an inline doubler);
phase 3 persists real ``ScaleColumn`` checkpoints.
"""

import argparse
import json
import os
import signal
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
#: where the workers run: None = the card, "cpu" = the CPU (set by main)
DEVICE = None

WORKER_SCRIPT = """
import sys, time
from mmlspark_tpu_torch.serving.server import ServingServer, ServingCoordinator
from mmlspark_tpu_torch.core.stage import Transformer
import numpy as np

class Doubler(Transformer):
    def transform(self, df):
        return df.with_column("y", np.asarray(df["x"], dtype=np.float64) * 2)

srv = ServingServer(Doubler(), max_latency_ms=1,
                    journal_path=sys.argv[2],
                    slow_trace_ms=0.0).start()
ServingCoordinator.register_worker(sys.argv[1], srv.host, srv.port)
print(srv.port, flush=True)
while True:
    time.sleep(1)
"""


DECODE_WORKER_SCRIPT = """
import json, os, sys, time
from mmlspark_tpu_torch.models import transformer as T
from mmlspark_tpu_torch.serving import DecodeScheduler, ServingServer, \\
    TransformerDecoder
from mmlspark_tpu_torch.core.stage import Transformer
from mmlspark_tpu_torch.parallel import cuda_attention as CA

class Identity(Transformer):
    def transform(self, df):
        return df

# argv: unused, launches_path, journal
device = "cpu" if os.environ.get("MMLSPARK_TPU_SERVING_CPU") == "1" else None
cfg = T.TransformerConfig(vocab=128, d_model=32, n_heads=2, d_head=16,
                          d_ff=64, n_stages=1, layers_per_stage=2)
dec = TransformerDecoder(T.init_params_np(cfg, seed=0), cfg, n_slots=4,
                         max_len=64, page_size=8, device=device)
sched = DecodeScheduler(dec)
srv = ServingServer(Identity(), port=0, decoder=sched,
                    max_latency_ms=1, journal_path=sys.argv[3],
                    verify_checkpoints=False).start()
dec.warmup()
CA.reset_launch_counts()      # the drill's traffic's launches only
print(srv.port, flush=True)
while True:
    # the kernels this process launched, for the drill to read
    with open(sys.argv[2] + ".tmp", "w") as f:
        json.dump(dict(CA.LAUNCHES), f)
    os.replace(sys.argv[2] + ".tmp", sys.argv[2])
    time.sleep(0.2)
"""


ROLLOUT_WORKER_SCRIPT = """
import os, sys, time
if os.environ.get("MMLSPARK_TPU_SERVING_CPU") == "1":
    from mmlspark_tpu_torch.core.serialize import set_default_load_device
    set_default_load_device("cpu")
from mmlspark_tpu_torch.serving.server import ServingServer, ServingCoordinator
from mmlspark_tpu_torch.core.stage import PipelineStage

model = PipelineStage.load(sys.argv[2])
srv = ServingServer(model, max_latency_ms=1, max_batch_size=8,
                    journal_path=sys.argv[3], model_version="v1",
                    slow_trace_ms=None)
srv.warmup({"x": 0.0})
srv.start()
ServingCoordinator.register_worker(sys.argv[1], srv.host, srv.port)
print(srv.port, flush=True)
while True:
    time.sleep(1)
"""


TENANCY_WORKER_SCRIPT = """
import sys, time
from mmlspark_tpu_torch.serving.server import ServingServer, ServingCoordinator
from mmlspark_tpu_torch.core.stage import Transformer
import numpy as np

class SlowDoubler(Transformer):
    # a fixed 2 ms per-batch cost: the worker, not the shared-host
    # client fleet, is the bottleneck, so the flood builds real queue
    # depth for the shed/fair-share machinery to act on
    def transform(self, df):
        time.sleep(0.002)
        return df.with_column("y", np.asarray(df["x"], dtype=np.float64) * 2)

srv = ServingServer(SlowDoubler(), max_latency_ms=2, max_batch_size=8,
                    max_queue=32, tenancy=sys.argv[2],
                    journal_path=sys.argv[3],
                    slow_trace_ms=None).start()
ServingCoordinator.register_worker(sys.argv[1], srv.host, srv.port)
print(srv.port, flush=True)
while True:
    time.sleep(1)
"""


SLO_WORKER_SCRIPT = """
import sys, time
from mmlspark_tpu_torch.serving.server import ServingServer, ServingCoordinator
from mmlspark_tpu_torch.core.stage import Transformer
import numpy as np

class Doubler(Transformer):
    def transform(self, df):
        return df.with_column("y", np.asarray(df["x"], dtype=np.float64) * 2)

srv = ServingServer(Doubler(), max_latency_ms=1,
                    journal_path=sys.argv[2],
                    slow_trace_ms=None).start()
print(srv.port, flush=True)
while True:
    # heartbeat: re-register every 0.5 s so the coordinator's
    # stale_after prunes the SIGKILLed worker but never a live one —
    # the same contract `python -m mmlspark_tpu_torch.serving worker`
    # keeps
    ServingCoordinator.register_worker(sys.argv[1], srv.host, srv.port)
    time.sleep(0.5)
"""


def spawn_worker(coord_url: str, journal: str,
                 script: str = WORKER_SCRIPT, *extra) -> "subprocess.Popen":
    from mmlspark_tpu_torch.examples._common import worker_env
    env = worker_env(DEVICE, REPO)
    p = subprocess.Popen(
        [sys.executable, "-c", script, coord_url, *extra, journal],
        stdout=subprocess.PIPE, env=env, text=True)
    port = p.stdout.readline().strip()
    if not port:
        raise RuntimeError(f"worker died on spawn (rc={p.poll()})")
    p.port = int(port)  # type: ignore[attr-defined]
    return p


def worker_status(port: int) -> dict:
    import requests
    try:
        return requests.get(f"http://127.0.0.1:{port}/status",
                            timeout=5).json()
    except Exception:  # noqa: BLE001 — dead worker has no status
        return {}


def keepalive_burst_drill(coord_url: str, workers: list,
                          kill_index: int, n_threads: int,
                          per_thread: int, seed: int) -> dict:
    """Phase 2: concurrent keep-alive burst, one worker killed mid-way.

    ``n_threads`` client threads share ONE ServingClient (pooled
    session = persistent connection per worker); after each thread has
    finished ~1/3 of its requests, worker ``kill_index`` is SIGKILLed.
    Every logical request must still return the right answer — the
    attempts in flight on the dead worker fail over, and the requests
    the SURVIVORS had already accepted all complete (zero drops)."""
    import threading

    import requests

    from mmlspark_tpu_torch.serving.server import ServingClient

    client = ServingClient(coord_url, timeout=10)
    survivor_port = workers[1 - kill_index].port
    reuses_before = requests.get(
        f"http://127.0.0.1:{survivor_port}/stats", timeout=5
    ).json()["frontend"].get("keepalive_reuses_total", 0)
    results: dict = {}
    errors: list = []
    kill_gate = threading.Barrier(n_threads + 1)

    def burst(ti: int) -> None:
        for j in range(per_thread):
            if j == per_thread // 3:
                kill_gate.wait()      # every thread is mid-burst here
            rid = f"burst-{seed}-{ti}-{j}"
            x = float(ti * per_thread + j)
            try:
                results[rid] = client.predict({"x": x},
                                              request_id=rid)
            except Exception as e:  # noqa: BLE001 — a dropped request
                errors.append({"rid": rid, "error": str(e)})

    threads = [threading.Thread(target=burst, args=(ti,))
               for ti in range(n_threads)]
    for t in threads:
        t.start()
    kill_gate.wait()                  # all threads in flight
    os.kill(workers[kill_index].pid, signal.SIGKILL)
    workers[kill_index].wait()
    for t in threads:
        t.join()

    def expected(rid: str) -> dict:
        _, _, ti, j = rid.rsplit("-", 3)
        return {"y": 2.0 * (int(ti) * per_thread + int(j))}

    n_wrong = sum(1 for rid, out in results.items()
                  if out != expected(rid))
    survivor = requests.get(
        f"http://127.0.0.1:{survivor_port}/stats", timeout=5).json()
    reuses_during = survivor["frontend"].get(
        "keepalive_reuses_total", 0) - reuses_before
    total = n_threads * per_thread
    return {
        "what": "keep-alive burst with a mid-burst worker kill",
        "n_threads": n_threads, "per_thread": per_thread,
        "total_requests": total,
        "n_ok": len(results) - n_wrong, "n_wrong": n_wrong,
        "n_dropped": len(errors), "dropped": errors[:5],
        "n_failovers": client.n_failovers,
        "survivor_keepalive_reuses": reuses_during,
        "ok": (len(results) == total and n_wrong == 0
               and not errors and client.n_failovers > 0
               and reuses_during > 0),
    }


def rollout_drill(tmp: str, seed: int, n_workers: int = 3) -> dict:
    """Phase 3: kill a worker in the middle of a canary rollout.

    A fresh fleet serves a persisted v1 ``ScaleColumn`` checkpoint;
    idempotent client traffic runs throughout; the coordinator
    orchestrates ``POST /rollout`` to a v2 checkpoint (canary on); one
    NON-canary worker is SIGKILLed once the rollout is under way. Pass
    iff the rollout ends ``completed``, ``GET /fleet`` shows one
    coherent version set (``["v2"]``) across responding workers, and
    every logical client request was answered correctly (v1 or v2
    output — the flip is mid-traffic — but never an error or a drop).
    """
    import threading

    import requests

    from mmlspark_tpu_torch.serving.server import (
        ServingClient, ServingCoordinator)
    from mmlspark_tpu_torch.stages import ScaleColumn

    v1_dir = os.path.join(tmp, "model_v1")
    v2_dir = os.path.join(tmp, "model_v2")
    ScaleColumn(input_col="x", output_col="y", scale=2.0).save(v1_dir)
    ScaleColumn(input_col="x", output_col="y", scale=3.0).save(v2_dir)

    coord = ServingCoordinator().start()
    coord_url = f"http://{coord.host}:{coord.port}"
    workers = [
        spawn_worker(coord_url,
                     os.path.join(tmp, f"r{i}.jsonl"),
                     ROLLOUT_WORKER_SCRIPT, v1_dir)
        for i in range(n_workers)]
    stats = {"n_ok": 0, "n_wrong": 0, "dropped": [],
             "killed_during": None}
    stop = threading.Event()
    client = ServingClient(coord_url, timeout=10)

    def traffic() -> None:
        i = 0
        while not stop.is_set():
            i += 1
            rid = f"rollout-{seed}-{i}"
            x = float(i)
            try:
                out = client.predict({"x": x}, request_id=rid)
            except Exception as e:  # noqa: BLE001 — a dropped request
                stats["dropped"].append({"rid": rid, "error": str(e)})
                continue
            # the flip is mid-traffic: v1 (2x) and v2 (3x) replies are
            # both correct; anything else is a wrong answer
            if out.get("y") in (2.0 * x, 3.0 * x):
                stats["n_ok"] += 1
            else:
                stats["n_wrong"] += 1

    t = threading.Thread(target=traffic)
    t.start()
    try:
        # canary_min_requests is sized so the canary phase lasts long
        # enough (roughly a second under this traffic) for the kill to
        # land genuinely mid-rollout, not after it
        r = requests.post(coord_url + "/rollout", json={
            "path": v2_dir, "version": "v2", "canary": True,
            "warmup_payload": {"x": 0.0},
            "canary_window_s": 8.0, "canary_min_requests": 150,
            "poll_interval_s": 0.05}, timeout=10)
        assert r.status_code == 202, r.text
        # kill a NON-canary worker (the orchestrator canaries the
        # first registered) once the rollout is past staging
        deadline = time.perf_counter() + 30
        state = "pending"
        while time.perf_counter() < deadline:
            state = requests.get(coord_url + "/rollout",
                                 timeout=10).json()["state"]
            if state in ("canary", "flipping", "completed",
                         "rolled_back", "failed"):
                break
            time.sleep(0.05)
        stats["killed_during"] = state
        os.kill(workers[-1].pid, signal.SIGKILL)
        workers[-1].wait()
        # wait for the rollout to reach a terminal state
        deadline = time.perf_counter() + 60
        final = None
        while time.perf_counter() < deadline:
            final = requests.get(coord_url + "/rollout",
                                 timeout=10).json()
            if final["state"] in ("completed", "rolled_back", "failed"):
                break
            time.sleep(0.1)
        fleet = requests.get(coord_url + "/fleet", timeout=10).json()
    finally:
        stop.set()
        t.join()
        for w in workers:
            if w.poll() is None:
                w.kill()
                w.wait()
        coord.stop()
    ok = (final is not None and final["state"] == "completed"
          and stats["killed_during"] in ("canary", "flipping")
          and fleet["model_versions"] == ["v2"]
          and fleet["version_coherent"]
          and fleet["n_responding"] == n_workers - 1
          and stats["n_wrong"] == 0 and not stats["dropped"]
          and stats["n_ok"] > 0)
    return {
        "what": "kill one worker mid-canary-rollout; survivors must "
                "finish the flip",
        "n_workers": n_workers,
        "rollout": {"state": final["state"] if final else None,
                    "decision": final.get("decision") if final else None,
                    "workers": final.get("workers") if final else None},
        "killed_during": stats["killed_during"],
        "fleet_versions": fleet["model_versions"],
        "version_coherent": fleet["version_coherent"],
        "n_responding": fleet["n_responding"],
        "traffic": {"n_ok": stats["n_ok"], "n_wrong": stats["n_wrong"],
                    "n_dropped": len(stats["dropped"]),
                    "dropped": stats["dropped"][:5]},
        "ok": ok,
    }


def prefix_drill(tmp: str, seed: int, n_requests: int = 16) -> dict:
    """Phase 4 (smoke-fast, CPU-only): a shared-prefix decode burst
    through a LIVE decode worker — the cross-request prefix cache
    drill (docs/serving.md "Prefix cache").

    Pass 1 sends ``n_requests`` shared-prefix prompts cold (their
    prompt pages publish into the radix index on finish); pass 2
    replays the SAME prompts under fresh request ids, so they attach
    the cached pages and prefill only their suffixes. Asserts: the
    worker's ``/decode/stats`` shows a hit rate > 0, pass 2's tokens
    match pass 1's token-for-token (ZERO wrong tokens — cached pages
    served exactly what cold prefill computed), and on drain the
    refcount ledger is clean (free + cached == claimable,
    ``ledger_clean``)."""
    import requests

    from mmlspark_tpu_torch.testing.decode_load import make_workload

    launches_path = os.path.join(tmp, "decode_launches.json")
    w = spawn_worker("unused", os.path.join(tmp, "decode.jsonl"),
                     DECODE_WORKER_SCRIPT, launches_path)
    url = f"http://127.0.0.1:{w.port}"
    jobs = make_workload(128, n_requests=n_requests, seed=seed,
                         mean_gap_ms=0.0, prompt_lens=(3, 5),
                         max_new=(4, 6), prefix_share=0.75,
                         prefix_len=24, prefix_pool=2)
    try:
        passes = []
        for pi in range(2):
            toks, errors = [], 0
            for i, job in enumerate(jobs):
                r = requests.post(
                    url + "/generate",
                    json={"prompt": [int(t) for t in job.prompt],
                          "max_new_tokens": int(job.max_new)},
                    headers={"X-Request-Id":
                             f"prefix-{seed}-{pi}-{i}"},
                    timeout=30)
                if r.status_code != 200:
                    errors += 1
                    toks.append(None)
                else:
                    toks.append(r.json()["tokens"])
            passes.append({"tokens": toks, "errors": errors})
        stats = requests.get(url + "/decode/stats",
                             timeout=10).json()
        pc = stats["prefix_cache"]
        pages = stats["pages"]
        wrong = sum(1 for a, b in zip(passes[0]["tokens"],
                                      passes[1]["tokens"]) if a != b)
        ledger_clean = (pc["ledger_clean"]
                        and pages["free"] + pages["cached"]
                        == pages["n_pages"])
        # the worker rewrites its counts every 0.2 s: read them settled
        time.sleep(0.5)
        with open(launches_path) as f:
            launches = json.load(f)
        # on the card the drill's traffic runs K1-K3: paged decode,
        # cold prefill (pass 1) and prefix prefill (pass 2's hits)
        kernels = ("paged_decode_attention", "flash_prefill_attention",
                   "paged_prefix_prefill_attention")
        card_ok = DEVICE == "cpu" or all(launches.get(k, 0) > 0
                                         for k in kernels)
        ok = (passes[0]["errors"] == passes[1]["errors"] == 0
              and wrong == 0
              and (pc["hit_rate"] or 0) > 0
              and pc["hit_tokens"] > 0
              and ledger_clean and card_ok)
        return {"n_requests": n_requests, "n_passes": 2,
                "errors": [p["errors"] for p in passes],
                "wrong_tokens": wrong,
                "hit_rate": pc["hit_rate"],
                "hit_tokens": pc["hit_tokens"],
                "cached_pages": pc["cached_pages"],
                "evicted_pages": pc["evicted_pages"],
                "ledger_clean": ledger_clean,
                "device": DEVICE or "cuda",
                "launches": {k: launches.get(k, 0) for k in kernels},
                "ok": ok}
    finally:
        if w.poll() is None:
            w.kill()
            w.wait()


def tenancy_drill(tmp: str, seed: int, n_requests: int = 300) -> dict:
    """Phase 5: noisy neighbor vs. interactive tenant, through a kill.

    A two-worker tenancy-enabled fleet (API-key admission, priority
    shed at ``high_water=0.5``, deficit-weighted fair-share). Tenant
    ``bob`` (background) floods keep-alive connections at BOTH
    workers; tenant ``alice`` (interactive) sends steady idempotent
    traffic through a ``ServingClient`` the whole time — including a
    SIGKILL of worker 0 mid-flood and its journal-replay restart.

    Pass iff alice's error rate is ZERO (every logical request
    answered, correctly), her flooded steady-state p99 holds within
    2x her quiet baseline (floored at 50 ms against shared-host
    jitter; the handful of requests that rode the kill's failover
    schedule are reported as ``kill_spikes_ms`` and gated by the
    zero-drop check, not the p99), bob is actually shed (429s on his
    wire AND
    ``n_shed_overload`` in his ledger rows), every tenant ledger
    drains clean (inflight 0, zero release underflow, zero per-IP
    underflow), the restarted worker replayed a non-empty journal,
    and ``GET /fleet`` merges both tenants' rows."""
    import threading

    import requests

    from mmlspark_tpu_torch.serving.server import (
        ServingClient, ServingCoordinator)
    from mmlspark_tpu_torch.testing.load import drive_keepalive

    tenancy_path = os.path.join(tmp, "tenants.json")
    with open(tenancy_path, "w", encoding="utf-8") as f:
        json.dump({
            "unknown_key_policy": "reject",
            "high_water": 0.5,
            "fair_share": True,
            "tenants": [
                {"id": "alice", "priority": "interactive",
                 "api_keys": ["drill-alice"], "weight": 8.0},
                {"id": "bob", "priority": "background",
                 "api_keys": ["drill-bob"], "weight": 1.0},
            ],
        }, f)

    coord = ServingCoordinator().start()
    coord_url = f"http://{coord.host}:{coord.port}"
    workers = [
        spawn_worker(coord_url, os.path.join(tmp, f"t{i}.jsonl"),
                     TENANCY_WORKER_SCRIPT, tenancy_path)
        for i in range(2)]
    client = ServingClient(coord_url, timeout=10,
                           api_key="drill-alice")
    stats = {"killed_at": None, "restarted_at": None,
             "n_ok": 0, "n_wrong": 0, "failed_rids": []}
    flood: dict = {}

    def flood_worker(name: str, port: int, dur: float) -> None:
        flood[name] = drive_keepalive(
            "127.0.0.1", port, "/predict", b'{"x": 1.0}',
            n_connections=30, duration_s=dur,
            extra_headers=[("X-Api-Key", "drill-bob")])

    def pct99(lat: list) -> float:
        if not lat:
            return 0.0
        s = sorted(lat)
        return s[min(int(0.99 * len(s)), len(s) - 1)] * 1000.0

    try:
        # alice's quiet baseline: the fleet all to herself
        quiet_lat = []
        for i in range(max(60, n_requests // 4)):
            t0 = time.perf_counter()
            out = client.predict({"x": float(i)},
                                 request_id=f"tq-{seed}-{i}")
            quiet_lat.append(time.perf_counter() - t0)
            if out != {"y": 2.0 * i}:
                stats["n_wrong"] += 1

        # bob floods both workers while alice keeps her steady loop
        # running THROUGH worker 0's SIGKILL and restart
        flood_s = 15.0
        threads = [
            threading.Thread(target=flood_worker,
                             args=(f"w{i}", w.port, flood_s))
            for i, w in enumerate(workers)]
        for t in threads:
            t.start()
        flooded_lat = []
        kill_spikes = []
        kill_at, restart_at = n_requests // 3, 2 * n_requests // 3
        for i in range(n_requests):
            if i == kill_at:
                os.kill(workers[0].pid, signal.SIGKILL)
                workers[0].wait()
                stats["killed_at"] = i
            if i == restart_at:
                workers[0] = spawn_worker(
                    coord_url, os.path.join(tmp, "t0.jsonl"),
                    TENANCY_WORKER_SCRIPT, tenancy_path)
                client.refresh()
                stats["restarted_at"] = i
            rid = f"tf-{seed}-{i}"
            x = float(1000 + i)
            f0 = client.n_failovers
            t0 = time.perf_counter()
            try:
                out = client.predict({"x": x}, request_id=rid)
            except Exception as e:  # noqa: BLE001 — a dropped request
                stats["failed_rids"].append({"rid": rid,
                                             "error": str(e)})
                continue
            dt = time.perf_counter() - t0
            # the few requests that rode the kill's failover schedule
            # carry recovery latency (phase-1 territory, gated by the
            # zero-drop check); the tenancy p99 gate is about QUEUEING
            # isolation, so it reads the steady-state requests
            if client.n_failovers == f0:
                flooded_lat.append(dt)
            else:
                kill_spikes.append(dt)
            if out == {"y": 2.0 * x}:
                stats["n_ok"] += 1
            else:
                stats["n_wrong"] += 1
        for t in threads:
            t.join()
        time.sleep(0.5)   # let shed replies and closes drain

        per_worker = []
        for w in workers:
            try:
                per_worker.append(requests.get(
                    f"http://127.0.0.1:{w.port}/stats",
                    timeout=5).json())
            except Exception:  # noqa: BLE001 — dead worker
                per_worker.append({})
        fleet = requests.get(coord_url + "/fleet", timeout=10).json()
        recovered = (worker_status(workers[0].port)
                     .get("journal_recovered") or 0)
    finally:
        for w in workers:
            if w.poll() is None:
                w.kill()
                w.wait()
        coord.stop()

    rows = [r for s in per_worker
            for r in ((s.get("tenancy") or {}).get("tenants") or [])]
    bob_shed = sum(r["n_shed_overload"] + r["n_shed_rate"]
                   for r in rows if r["id"] == "bob")
    bob_429 = sum(f["http_errors"] for f in flood.values())
    ledger_clean = (
        rows
        and all(r["inflight"] == 0 and r["n_release_underflow"] == 0
                for r in rows)
        and all((s.get("frontend") or {})
                .get("per_ip_underflow_total", 0) == 0
                for s in per_worker if s))
    fleet_ids = {r["id"] for r in (fleet.get("tenants") or [])}
    quiet_p99 = pct99(quiet_lat)
    flooded_p99 = pct99(flooded_lat)
    p99_bound = max(2.0 * quiet_p99, 50.0)
    ok = (stats["n_ok"] == n_requests
          and stats["n_wrong"] == 0
          and not stats["failed_rids"]
          and flooded_p99 <= p99_bound
          and bob_429 > 0 and bob_shed > 0
          and ledger_clean
          and recovered > 0
          and {"alice", "bob"} <= fleet_ids)
    return {
        "what": "background flood vs. steady interactive tenant, "
                "through a worker SIGKILL + journal-replay restart",
        "n_requests": n_requests,
        "killed_at": stats["killed_at"],
        "restarted_at": stats["restarted_at"],
        "alice": {"n_ok": stats["n_ok"], "n_wrong": stats["n_wrong"],
                  "n_dropped": len(stats["failed_rids"]),
                  "dropped": stats["failed_rids"][:5],
                  "quiet_p99_ms": round(quiet_p99, 3),
                  "flooded_p99_ms": round(flooded_p99, 3),
                  "p99_bound_ms": round(p99_bound, 3),
                  "kill_spikes_ms": [round(s * 1000.0, 3)
                                     for s in kill_spikes],
                  "n_failovers": client.n_failovers},
        "bob": {"wire_429s": bob_429, "shed_total": bob_shed,
                "rps": [f["rps"] for f in flood.values()]},
        "ledger_clean": bool(ledger_clean),
        "journal_recovered": recovered,
        "fleet_tenants": sorted(fleet_ids),
        "ok": ok,
    }


def slo_alerts_drill(tmp: str, seed: int, n_requests: int = 16) -> dict:
    """Phase 6: the SLO availability-burn drill (docs/observability.md
    "SLO engine").

    A two-worker fleet behind a coordinator whose fleet SLO plane runs
    fast burn windows. Steady-state traffic + ``GET /fleet/alerts``
    polls must stay QUIET (zero false positives); then worker 0 is
    SIGKILLed and the drill asserts the ``fleet_availability`` policy
    FIRES with the victim — and only the victim — in the per-worker
    attribution; then a replacement worker heartbeats in, the dead
    registration ages out of ``stale_after``, the burn decays, and the
    alert must RESOLVE and stay quiet.
    """
    import requests
    from mmlspark_tpu_torch.serving.server import ServingClient, \
        ServingCoordinator

    # fast windows so the drill runs in seconds: objective 0.9 means a
    # 1-dead-of-2 fleet (50% poll failures) burns 5x budget — well
    # over the 1.0 threshold — while a healthy fleet burns 0.
    coord = ServingCoordinator(
        stale_after=6.0,
        slo={"objective": 0.9,
             "windows": ((15.0, 3.0, 1.0),),
             "for_s": 0.0,
             "resolve_after_s": 2.0}).start()
    coord_url = f"http://{coord.host}:{coord.port}"
    workers = [spawn_worker(coord_url, os.path.join(tmp, f"slo{i}.jsonl"),
                            SLO_WORKER_SCRIPT)
               for i in range(2)]
    out: dict = {"what": "SIGKILL one of two workers; fleet_availability "
                         "must fire with victim attribution, then "
                         "resolve after a replacement heartbeats in"}

    def fleet_alerts():
        return requests.get(coord_url + "/fleet/alerts",
                            timeout=10).json()

    def availability_alert(view):
        for alert in (view.get("fleet") or {}).get("alerts") or []:
            if alert.get("policy") == "fleet_availability":
                return alert
        return None

    try:
        # wait for both heartbeats to land before judging quiet
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline:
            svcs = requests.get(coord_url + "/services",
                                timeout=10).json()
            if len(svcs) >= 2:
                break
            time.sleep(0.1)
        client = ServingClient(coord_url, timeout=10)
        victim = f"127.0.0.1:{workers[0].port}"
        survivor = f"127.0.0.1:{workers[1].port}"

        # -- steady state: traffic + alert polls, ZERO firing allowed
        false_firing = 0
        for i in range(max(n_requests, 4)):
            client.predict({"x": i}, request_id=f"slo-{seed}-{i}")
            if fleet_alerts()["firing"]:
                false_firing += 1
            time.sleep(0.15)
        out["steady_polls"] = max(n_requests, 4)
        out["steady_false_firing"] = false_firing

        # -- kill: poll until the availability policy fires
        os.kill(workers[0].pid, signal.SIGKILL)
        workers[0].wait()
        fired = attributed = False
        survivor_blamed = False
        deadline = time.monotonic() + 30.0
        while time.monotonic() < deadline:
            alert = availability_alert(fleet_alerts())
            if alert is not None and alert["state"] == "firing":
                fired = True
                blamed = {row["labels"].get("worker")
                          for row in alert.get("attribution") or []}
                attributed = victim in blamed
                survivor_blamed = survivor in blamed
                break
            time.sleep(0.25)
        out["fired"] = fired
        out["victim_attributed"] = attributed
        out["survivor_blamed"] = survivor_blamed

        # -- restart: replacement heartbeats in; the dead registration
        # ages out of stale_after; failures stop; the short window
        # drains; the alert must resolve within the quiet period
        workers[0] = spawn_worker(
            coord_url, os.path.join(tmp, "slo0b.jsonl"),
            SLO_WORKER_SCRIPT)
        resolved = False
        deadline = time.monotonic() + 45.0
        while time.monotonic() < deadline:
            view = fleet_alerts()
            alert = availability_alert(view)
            state = alert["state"] if alert is not None else "ok"
            if view["firing"] == 0 and state in ("ok", "resolved"):
                resolved = True
                break
            time.sleep(0.5)
        out["resolved"] = resolved

        # -- post-resolve: the healed fleet must stay quiet
        post_false = 0
        for _ in range(4):
            if fleet_alerts()["firing"]:
                post_false += 1
            time.sleep(0.25)
        out["post_resolve_false_firing"] = post_false
        out["ok"] = (false_firing == 0 and fired and attributed
                     and not survivor_blamed and resolved
                     and post_false == 0)
        return out
    finally:
        for w in workers:
            try:
                w.kill()
            except Exception:  # noqa: BLE001 — already dead
                pass
        coord.stop()


def regression_drill(tmp: str, seed: int, n_requests: int = 60) -> dict:
    """Phase 7: the latency-regression anomaly drill
    (docs/observability.md "The retrospective plane").

    One in-process worker whose embedded TSDB runs a FAST recording
    rule (``chaos:dispatch_p95`` = p95 of dispatch latency over a 4 s
    window, 0.1 s scrape cadence) and an anomaly watch on that rule's
    series. Steady traffic warms the EWMA+MAD baseline and must stay
    QUIET (zero false positives); then the model is made 80 ms slower
    mid-traffic — the watch must FIRE on ``GET /alerts`` with the
    dispatch histogram's per-bucket labels as attribution; then the
    slowdown is reverted, the 4 s window drains the slow
    observations, and the alert must RESOLVE within the quiet period
    and stay quiet after."""
    import numpy as np
    import requests

    from mmlspark_tpu_torch.core.stage import Transformer
    from mmlspark_tpu_torch.serving import ServingServer

    class SlowableDoubler(Transformer):
        delay_s = 0.0

        def transform(self, df):
            if self.delay_s:
                time.sleep(self.delay_s)
            return df.with_column(
                "y", np.asarray(df["x"], dtype=np.float64) * 2)

    model = SlowableDoubler()
    # the rule's 4 s quantile window is what lets the drill resolve in
    # seconds: after the revert, the slow observations age out of the
    # window and the p95 series comes back to baseline. min_abs=10ms
    # floors the z-score against a near-zero steady MAD (dispatch of
    # a doubler is sub-millisecond), so only the injected regression
    # can violate.
    tsdb_cfg = {
        "interval_s": 0.1,
        "rules": [{"record": "chaos:dispatch_p95",
                   "expr":
                       "quantile(0.95, serving_dispatch_latency_ms[4s])"}],
        "watches": [{"name": "dispatch_p95_regression",
                     "expr": "chaos:dispatch_p95",
                     "direction": "high", "z_threshold": 4.0,
                     "min_samples": 20, "min_abs": 10.0,
                     "for_s": 0.3, "resolve_after_s": 1.0}],
    }
    out: dict = {"what": "inject an 80ms model slowdown mid-traffic; "
                         "the dispatch-p95 anomaly watch must fire "
                         "with bucket attribution, then resolve on "
                         "revert"}

    with ServingServer(model, max_batch_size=4, max_latency_ms=5,
                       tsdb=tsdb_cfg) as srv:
        base = srv.address.rsplit("/", 1)[0]

        def anomaly(view):
            for alert in view.get("anomalies") or []:
                if alert.get("watch") == "dispatch_p95_regression":
                    return alert
            return None

        def pump(stop_fn, max_s, gap_s=0.03):
            """Send traffic until ``stop_fn`` returns truthy or the
            deadline passes; returns (stop_fn result, n_firing_polls,
            n_requests_sent)."""
            i = 0
            firing_polls = 0
            deadline = time.monotonic() + max_s
            while time.monotonic() < deadline:
                requests.post(srv.address,
                              json={"x": float(i % 7)}, timeout=10)
                i += 1
                if i % 4 == 0:
                    view = requests.get(base + "/alerts",
                                        timeout=10).json()
                    if view["firing"]:
                        firing_polls += 1
                    got = stop_fn(view)
                    if got:
                        return got, firing_polls, i
                time.sleep(gap_s)
            return None, firing_polls, i

        # -- steady state: warm the baseline well past min_samples
        # (20 ticks at 0.1 s) and prove the watch stays quiet
        warm = max(n_requests, 40)
        steady_end = time.monotonic() + max(warm * 0.05, 5.0)
        _, false_polls, n_sent = pump(
            lambda view: time.monotonic() >= steady_end,
            max_s=max(warm * 0.05, 5.0) + 5.0)
        out["steady_requests"] = n_sent
        out["steady_false_firing"] = false_polls

        # -- inject: 80 ms regression; the watch must fire with the
        # dispatch histogram's bucket label as attribution
        model.delay_s = 0.08
        alert, _, _ = pump(
            lambda view: (a := anomaly(view)) is not None
            and a["state"] == "firing" and a, max_s=25.0)
        out["fired"] = alert is not None
        out["attributed"] = bool(
            alert and "bucket" in (alert.get("labels") or {}))
        out["fired_value_ms"] = alert and alert.get("value")
        out["baseline_ms"] = alert and alert.get("baseline")

        # -- revert: the window drains, the alert must resolve
        model.delay_s = 0.0
        resolved, _, _ = pump(
            lambda view: view["firing"] == 0
            and (a := anomaly(view)) is not None
            and a["state"] in ("ok", "resolved") and a, max_s=30.0)
        out["resolved"] = resolved is not None

        # -- post-resolve: healed traffic must stay quiet
        _, post_false, _ = pump(lambda view: False, max_s=2.0)
        out["post_resolve_false_firing"] = post_false
        out["recorder"] = {
            k: srv.recorder.status()[k]
            for k in ("n_scrapes", "ewma_ingest_ms", "n_over_budget",
                      "n_rule_errors")}
        out["ok"] = (false_polls == 0 and out["fired"]
                     and out["attributed"] and out["resolved"]
                     and post_false == 0
                     and out["recorder"]["n_rule_errors"] == 0)
        return out


def postmortem_drill(tmp: str, seed: int, n_requests: int = 40) -> dict:
    """Phase 8: the incident-capture drill (docs/observability.md
    "The postmortem plane").

    The phase-7 latency regression, re-run against a worker with the
    always-on sampling profiler and an IncidentManager wired to the
    anomaly notifier. Steady traffic must produce ZERO bundles; the
    injected 80 ms slowdown must (a) fire the anomaly, (b) land one
    COMPLETE on-disk bundle containing a non-empty profile, at least
    one retained trace, and the violated series range, and (c) show
    the injected-delay frame (this drill's ``transform``) in the
    differential profile's top hotter-frames table; the revert must
    resolve the alert; a second regression inside the cooldown must
    be suppressed (no duplicate bundle)."""
    import numpy as np
    import requests

    from mmlspark_tpu_torch.core.stage import Transformer
    from mmlspark_tpu_torch.serving import ServingServer

    class SlowableDoubler(Transformer):
        delay_s = 0.0

        def transform(self, df):
            if self.delay_s:
                time.sleep(self.delay_s)
            return df.with_column(
                "y", np.asarray(df["x"], dtype=np.float64) * 2)

    model = SlowableDoubler()
    # phase 7's fast detector (4 s rule window, 0.1 s cadence,
    # min_abs=10ms floor) plus the postmortem plane: tight incident
    # knobs so the drill runs in seconds (a short profile post-window,
    # a 30 s series lookback at 0.5 s resolution) and a 60 s cooldown
    # long enough that the second injection below MUST be suppressed.
    tsdb_cfg = {
        "interval_s": 0.1,
        "rules": [{"record": "chaos:dispatch_p95",
                   "expr":
                       "quantile(0.95, serving_dispatch_latency_ms[4s])"}],
        "watches": [{"name": "dispatch_p95_regression",
                     "expr": "chaos:dispatch_p95",
                     "direction": "high", "z_threshold": 4.0,
                     "min_samples": 20, "min_abs": 10.0,
                     "for_s": 0.3, "resolve_after_s": 1.0}],
    }
    inc_dir = os.path.join(tmp, "incidents")
    incidents_cfg = {"dir": inc_dir, "cooldown_s": 60.0,
                     "profile_pre_s": 8.0, "profile_post_s": 0.5,
                     "lookback_s": 30.0, "series_step_s": 0.5}
    out: dict = {"what": "phase-7 regression with incident capture: "
                         "firing must snapshot a complete bundle "
                         "(profile + traces + series + logs + stats), "
                         "steady state must write nothing, a repeat "
                         "inside the cooldown must be suppressed"}

    with ServingServer(model, max_batch_size=4, max_latency_ms=5,
                       tsdb=tsdb_cfg, incidents=incidents_cfg,
                       slow_trace_ms=40.0,
                       adaptive_slow_trace=False) as srv:
        base = srv.address.rsplit("/", 1)[0]

        def anomaly(view):
            for alert in view.get("anomalies") or []:
                if alert.get("watch") == "dispatch_p95_regression":
                    return alert
            return None

        def pump(stop_fn, max_s, gap_s=0.03):
            i = 0
            deadline = time.monotonic() + max_s
            while time.monotonic() < deadline:
                requests.post(srv.address,
                              json={"x": float(i % 7)}, timeout=10)
                i += 1
                if i % 4 == 0:
                    view = requests.get(base + "/alerts",
                                        timeout=10).json()
                    got = stop_fn(view)
                    if got:
                        return got
                time.sleep(gap_s)
            return None

        # -- steady state: warm the baseline; nothing may be captured
        warm_s = max(max(n_requests, 40) * 0.05, 5.0)
        steady_end = time.monotonic() + warm_s
        pump(lambda view: time.monotonic() >= steady_end,
             max_s=warm_s + 5.0)
        steady = requests.get(base + "/incidents", timeout=10).json()
        out["steady_bundles"] = steady["status"]["captured"]

        # -- inject: the watch fires AND the incident manager captures
        model.delay_s = 0.08
        t_inject = time.monotonic()
        alert = pump(
            lambda view: (a := anomaly(view)) is not None
            and a["state"] == "firing" and a, max_s=25.0)
        out["fired"] = alert is not None

        # differential profile WHILE the regression runs: the injected
        # delay (this drill's ``transform``, parked in time.sleep)
        # must top the hotter-frames table
        time.sleep(1.0)        # let the hot window accumulate samples
        window_s = max(time.monotonic() - t_inject, 2.0)
        diff = requests.get(
            base + f"/profile/cpu?window_s={window_s:.1f}"
                   f"&baseline_s=8", timeout=10).json()
        hot = [r["frame"] for r in (diff.get("hotter") or [])[:10]]
        out["diff_top_hotter"] = hot[:5]
        out["diff_names_delay_frame"] = any(
            ":transform:" in f for f in hot)

        # the bundle: wait for the capture thread (profile post-window
        # is 0.5 s), then verify completeness + contents over HTTP —
        # exactly what an operator's tooling would read
        srv.incidents.wait_idle(timeout=20.0)
        listing = requests.get(base + "/incidents", timeout=10).json()
        out["bundles_after_fire"] = listing["status"]["captured"]
        bundle_ok = profile_ok = traces_ok = series_ok = False
        if listing["incidents"]:
            inc = listing["incidents"][0]
            inc_id = inc["id"]
            out["incident_id"] = inc_id
            info = requests.get(base + f"/incidents/{inc_id}",
                                timeout=10).json()
            bundle_ok = info["complete"] and all(
                f in info["present"] for f in
                ("alert.json", "series.json", "traces.json",
                 "logs.json", "stats.json", "profile.collapsed",
                 "manifest.json"))
            prof = requests.get(
                base + f"/incidents/{inc_id}/profile.collapsed",
                timeout=10).text
            profile_ok = len(prof.strip()) > 0
            traces = requests.get(
                base + f"/incidents/{inc_id}/traces.json",
                timeout=10).json()
            traces_ok = len(traces.get("traces") or []) >= 1
            series = requests.get(
                base + f"/incidents/{inc_id}/series.json",
                timeout=10).json()
            own = (series.get("series") or {}).get("chaos:dispatch_p95",
                                                   {})
            vals = [p[1] for s in own.get("series") or []
                    for p in s.get("points") or []
                    if p[1] is not None]
            # the violated range: the regressed p95 (>= the watch's
            # 10 ms min_abs floor; steady state is sub-millisecond)
            series_ok = bool(vals) and max(vals) >= 10.0
            out["series_max_ms"] = max(vals) if vals else None
        out["bundle_complete"] = bundle_ok
        out["profile_nonempty"] = profile_ok
        out["traces_retained"] = traces_ok
        out["series_violated_range"] = series_ok

        # -- revert: the alert must resolve, and resolving must NOT
        # write another bundle
        model.delay_s = 0.0
        resolved = pump(
            lambda view: view["firing"] == 0
            and (a := anomaly(view)) is not None
            and a["state"] in ("ok", "resolved") and a, max_s=30.0)
        out["resolved"] = resolved is not None

        # -- duplicate suppression: a second regression inside the
        # 60 s cooldown fires again but must NOT produce a new bundle
        model.delay_s = 0.08
        refired = pump(
            lambda view: (a := anomaly(view)) is not None
            and a["state"] == "firing" and a, max_s=25.0)
        model.delay_s = 0.0
        srv.incidents.wait_idle(timeout=20.0)
        status = requests.get(base + "/incidents",
                              timeout=10).json()["status"]
        out["refired"] = refired is not None
        out["bundles_after_refire"] = status["captured"]
        out["suppressed_by_cooldown"] = status["suppressed_cooldown"]

        out["ok"] = (out["steady_bundles"] == 0
                     and out["fired"]
                     and out["bundles_after_fire"] == 1
                     and bundle_ok and profile_ok and traces_ok
                     and series_ok
                     and out["diff_names_delay_frame"]
                     and out["resolved"]
                     and out["refired"]
                     and out["bundles_after_refire"] == 1
                     and out["suppressed_by_cooldown"] >= 1)
        return out


def main(argv=None) -> int:
    global DEVICE
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cpu, or the card (the default; raises without "
                         "CUDA): where the decode worker serves")
    ap.add_argument("--requests", type=int, default=120)
    ap.add_argument("--kill-at", type=int, default=30,
                    help="SIGKILL worker 0 after this many requests")
    ap.add_argument("--restart-after", type=int, default=30,
                    help="restart it this many requests later")
    ap.add_argument("--seed", type=int, default=0,
                    help="FaultPlan seed (request-id stream)")
    ap.add_argument("--burst-threads", type=int, default=8,
                    help="phase-2 keep-alive burst client threads "
                         "(0 skips the phase)")
    ap.add_argument("--burst-requests", type=int, default=15,
                    help="requests per burst thread")
    ap.add_argument("--rollout-workers", type=int, default=3,
                    help="phase-3 kill-mid-rollout drill fleet size "
                         "(0 skips the phase; needs >= 3 so a "
                         "non-canary worker can die)")
    ap.add_argument("--prefix-requests", type=int, default=16,
                    help="phase-4 shared-prefix decode burst size "
                         "(0 skips the phase)")
    ap.add_argument("--prefix-only", action="store_true",
                    help="run ONLY the phase-4 prefix-cache drill "
                         "(the fast smoke mode)")
    ap.add_argument("--tenancy-requests", type=int, default=300,
                    help="phase-5 noisy-neighbor drill: interactive "
                         "requests through the flood (0 skips the "
                         "phase)")
    ap.add_argument("--slo-alerts-requests", type=int, default=16,
                    help="phase-6 SLO availability-burn drill: steady-"
                         "state requests before the SIGKILL (0 skips "
                         "the phase)")
    ap.add_argument("--regression-requests", type=int, default=60,
                    help="phase-7 latency-regression anomaly drill: "
                         "steady-state requests before the injected "
                         "slowdown (0 skips the phase)")
    ap.add_argument("--postmortem-requests", type=int, default=40,
                    help="phase-8 incident-capture drill: steady-state "
                         "requests before the injected regression that "
                         "must land a complete on-disk incident bundle "
                         "(0 skips the phase)")
    args = ap.parse_args(argv)
    from mmlspark_tpu_torch.core.environment import resolve_device
    DEVICE = "cpu" if resolve_device(args.device).type == "cpu" else None
    if DEVICE is None and args.prefix_requests > 0:
        # the decode worker loads the kernel library this process builds
        from mmlspark_tpu_torch.native import cuda_build
        cuda_build.build()

    if args.prefix_only:
        tmp = tempfile.mkdtemp(prefix="chaos_prefix_")
        drill = prefix_drill(tmp, args.seed,
                             n_requests=args.prefix_requests or 16)
        print(json.dumps({"what": "prefix-cache drill (smoke)",
                          "prefix": drill}, indent=2))
        print("RESULT:", "PASS" if drill["ok"] else "FAIL")
        return 0 if drill["ok"] else 1

    from mmlspark_tpu_torch.serving.server import (
        ServingClient, ServingCoordinator)
    from mmlspark_tpu_torch.testing.faults import FaultPlan

    # the plan is bookkeeping here: it records the kill/restart schedule
    # so the run's chaos is part of its report (and a future
    # rate-driven schedule stays seeded)
    plan = FaultPlan(seed=args.seed,
                     script={"proc": ["ok"] * args.kill_at + ["kill"]})

    tmp = tempfile.mkdtemp(prefix="chaos_serving_")
    coord = ServingCoordinator().start()
    coord_url = f"http://{coord.host}:{coord.port}"
    workers = [spawn_worker(coord_url, os.path.join(tmp, f"w{i}.jsonl"))
               for i in range(2)]
    stats = {"killed_at": None, "restarted_at": None, "n_ok": 0,
             "n_wrong": 0, "failed_rids": [],
             "first_ok_after_kill": None}
    t0 = time.perf_counter()
    try:
        client = ServingClient(coord_url, timeout=10)
        restart_at = None
        for i in range(args.requests):
            fault = plan.at("proc")
            if fault.kind == "kill" and stats["killed_at"] is None:
                os.kill(workers[0].pid, signal.SIGKILL)
                workers[0].wait()
                stats["killed_at"] = i
                restart_at = i + args.restart_after
            if restart_at is not None and i == restart_at:
                # with worker 0 still dead, the coordinator's fleet
                # trace view must DEGRADE, not fail: the dead worker
                # becomes an error entry and the survivors' captures
                # (every request — the workers trace everything) are
                # still listed with worker attribution
                import requests
                ft = requests.get(coord_url + "/fleet/traces",
                                  timeout=10).json()
                live_workers = {t["worker"] for t in ft["traces"]}
                stats["fleet_dead_errors"] = len(ft["errors"])
                stats["fleet_live_captures"] = len(ft["traces"])
                stats["fleet_traces_ok"] = (
                    len(ft["errors"]) >= 1
                    and f"127.0.0.1:{workers[1].port}" in live_workers)
                workers[0] = spawn_worker(
                    coord_url, os.path.join(tmp, "w0.jsonl"))
                client.refresh()
                stats["restarted_at"] = i
            rid = f"chaos-{args.seed}-{i}"
            try:
                out = client.predict({"x": i}, request_id=rid)
            except Exception as e:  # noqa: BLE001 — report, don't crash
                stats["failed_rids"].append({"rid": rid, "error": str(e)})
                continue
            if out == {"y": 2.0 * i}:
                stats["n_ok"] += 1
                if stats["killed_at"] is not None \
                        and stats["first_ok_after_kill"] is None:
                    stats["first_ok_after_kill"] = i
            else:
                stats["n_wrong"] += 1
        burst = None
        if args.burst_threads > 0:
            # phase 2: kill worker 1 (worker 0 was already killed and
            # restarted above) in the middle of a concurrent keep-alive
            # burst, then bring a replacement up so the fleet ends the
            # drill whole
            burst = keepalive_burst_drill(
                coord_url, workers, kill_index=1,
                n_threads=args.burst_threads,
                per_thread=args.burst_requests, seed=args.seed)
            workers[1] = spawn_worker(
                coord_url, os.path.join(tmp, "w1.jsonl"))
        rollout = None
        if args.rollout_workers > 0:
            rollout = rollout_drill(tmp, args.seed,
                                    n_workers=max(args.rollout_workers,
                                                  3))
        prefix = None
        if args.prefix_requests > 0:
            prefix = prefix_drill(tmp, args.seed,
                                  n_requests=args.prefix_requests)
        tenancy = None
        if args.tenancy_requests > 0:
            tenancy = tenancy_drill(tmp, args.seed,
                                    n_requests=args.tenancy_requests)
        slo_alerts = None
        if args.slo_alerts_requests > 0:
            slo_alerts = slo_alerts_drill(
                tmp, args.seed, n_requests=args.slo_alerts_requests)
        regression = None
        if args.regression_requests > 0:
            regression = regression_drill(
                tmp, args.seed, n_requests=args.regression_requests)
        postmortem = None
        if args.postmortem_requests > 0:
            postmortem = postmortem_drill(
                tmp, args.seed, n_requests=args.postmortem_requests)
        wall = time.perf_counter() - t0

        per_worker = [worker_status(w.port) for w in workers]
        report = {
            "what": "serving chaos drill: kill/restart worker 0 under "
                    "idempotent client traffic",
            "args": {"requests": args.requests, "kill_at": args.kill_at,
                     "restart_after": args.restart_after,
                     "seed": args.seed},
            "plan": plan.summary(),
            "stats": stats,
            "client": {"n_failovers": client.n_failovers,
                       "breakers": client.breakers.states()},
            "workers": [{k: s.get(k) for k in
                         ("n_requests", "n_replayed", "n_shed",
                          "journal_recovered")} for s in per_worker],
            **({"burst": burst} if burst is not None else {}),
            **({"rollout": rollout} if rollout is not None else {}),
            **({"prefix": prefix} if prefix is not None else {}),
            **({"tenancy": tenancy} if tenancy is not None else {}),
            **({"slo_alerts": slo_alerts}
               if slo_alerts is not None else {}),
            **({"regression": regression}
               if regression is not None else {}),
            **({"postmortem": postmortem}
               if postmortem is not None else {}),
            "wall_s": round(wall, 3),
        }
        print(json.dumps(report, indent=2))
        # the restarted worker committed replies before the kill, so a
        # correct restart MUST have replayed a non-empty journal; 0
        # means the durable-journal story is broken
        recovered = stats["restarted_at"] is None or \
            (per_worker[0].get("journal_recovered") or 0) > 0
        ok = (stats["n_ok"] == args.requests
              and stats["n_wrong"] == 0
              and not stats["failed_rids"]
              and recovered
              and stats.get("fleet_traces_ok", True)
              and (burst is None or burst["ok"])
              and (rollout is None or rollout["ok"])
              and (prefix is None or prefix["ok"])
              and (tenancy is None or tenancy["ok"])
              and (slo_alerts is None or slo_alerts["ok"])
              and (regression is None or regression["ok"])
              and (postmortem is None or postmortem["ok"]))
        print("RESULT:", "PASS" if ok else "FAIL")
        return 0 if ok else 1
    finally:
        for w in workers:
            if w.poll() is None:
                w.kill()
                w.wait()
        coord.stop()


if __name__ == "__main__":
    sys.exit(main())
