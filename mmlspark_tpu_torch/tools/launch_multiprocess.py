#!/usr/bin/env python
"""2-process drill: real cross-process collectives over
``torch.distributed``, two processes of four hosted mesh ranks each.

Counterpart of ``tools/launch_multiprocess.py``, on JAX's meshes: it
spawns **two OS processes**, each hosting four ranks of an 8-rank mesh
(the mixed form, JAX's two processes of four devices), joins them in
one gloo process group over a ``file://`` rendezvous, and runs four
phases, each a genuine cross-process collective:

* **psum** — a ``dist.put_batch``-placed batch on a ``{"data": 8}`` mesh
  (each process its own rows, one a hosted rank) summed across the
  process boundary; the analytic total for the world proves the bytes
  crossed.
* **fit** — a 2-process ``NNLearner`` fit (``mesh_shape={"data": 8}``,
  each process the rows of its four data ranks, the gradient
  all-reduced) whose scores must match the single-process reference
  fit to <= 1e-6.
* **pipe** — the pjit train step on a ``{"pipe": 2, "data": 4}`` mesh
  whose pipe axis IS the process boundary (stage 0's weights live
  wholly on process 0, stage 1's on process 1, the data ranks hosted in
  each); two steps' losses must match the same step on the hosted mesh
  to <= 1e-6 (JAX's drill allows 5e-2 there, a jaxlib workaround).
* **checkpoint** — both processes cooperatively save ONE sharded
  checkpoint directory from a ``{"data": 4, "model": 2}`` mesh, each
  slice written by the lowest process holding it; the parent restores
  it in one process and compares bit for bit.

Both processes compute on the card (``cuda:0`` with one card: they meet
over gloo, which stages CUDA tensors through the host), or with
``--device cpu`` on the CPU.

Usage::

    python -m mmlspark_tpu_torch.tools.launch_multiprocess --smoke --device cpu
    python -m mmlspark_tpu_torch.tools.launch_multiprocess --json
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

WORLD = 2
#: mesh ranks each process hosts (JAX's drill: 4 devices a process)
HOSTED = 4
_FIT_KW = dict(arch={"builder": "mlp", "hidden": [16], "num_outputs": 2},
               optimizer="adam", learning_rate=0.01, batch_size=64,
               log_every=0, seed=3)
#: parity of the 2-process runs against the single-process ones: the
#: same arithmetic on the same device type, summed across processes
#: where one process sums hosted ranks
TOL = 1e-6
PIPE_MESH = {"pipe": WORLD, "data": HOSTED}
FIT_MESH = {"data": WORLD * HOSTED}
CKPT_MESH = {"data": HOSTED, "model": WORLD}


def _fit_frame():
    from mmlspark_tpu_torch.core.dataframe import DataFrame
    rng = np.random.default_rng(42)
    n = 256
    x = np.concatenate([rng.normal(-2.0, size=(n, 4)),
                        rng.normal(2.0, size=(n, 4))]).astype(np.float32)
    y = np.concatenate([np.zeros(n), np.ones(n)]).astype(np.int64)
    perm = rng.permutation(len(x))
    return DataFrame({"features": x[perm], "label": y[perm]}), x[perm]


def _pipe_setup(device):
    from mmlspark_tpu_torch.models import transformer as T
    cfg = T.TransformerConfig(vocab=64, d_model=16, n_heads=4, d_head=8,
                              d_ff=32, n_stages=2, layers_per_stage=1)
    params = T.init_params_np(cfg, seed=0)
    tokens, labels, mask = T.make_batch(np.random.default_rng(5), cfg, 8,
                                        16, device=device)
    return cfg, params, tokens, labels, mask


def _ckpt_tree():
    rng = np.random.default_rng(7)
    return {"w": rng.normal(size=(64, 32)).astype(np.float32),
            "b": rng.normal(size=(32,)).astype(np.float32),
            "moment": rng.normal(size=(64, 32)).astype(np.float32)}


def _pipe_losses(cfg, mesh, params, tokens, labels, mask) -> list:
    from mmlspark_tpu_torch.models import transformer as T
    step = T.build_spmd_train_step(cfg, mesh, 0.1, 0.9, impl="pjit")
    sp = T.shard_params(params, cfg, mesh)
    sv = T.init_velocity(sp)
    losses = []
    for _ in range(2):
        sp, sv, loss = step(sp, sv, tokens, labels, mask)
        losses.append(float(loss))
    return losses, sp


# ---------------------------------------------------------------------------
# the reference: one process, hosted meshes


def run_reference(epochs: int, device) -> dict:
    from mmlspark_tpu_torch.models.trainer import NNLearner
    from mmlspark_tpu_torch.parallel import MeshSpec, build_mesh

    df, x = _fit_frame()
    model = NNLearner(mesh_shape={"data": 1}, epochs=epochs, device=device,
                      **_FIT_KW).fit(df)
    scores = model.model.apply(x, device=device).cpu().numpy()
    cfg, params, tokens, labels, mask = _pipe_setup(device)
    mesh = build_mesh(MeshSpec.from_dict(PIPE_MESH), device)
    losses, _ = _pipe_losses(cfg, mesh, params, tokens, labels, mask)
    return {"scores": scores.astype(np.float64), "pipe_losses": losses}


# ---------------------------------------------------------------------------
# a rank: one process of the world


def run_worker(rank: int, init: str, out_path: str, ref_path: str,
               ckpt_dir: str, epochs: int, device: str) -> None:
    import torch.distributed as tdist
    from mmlspark_tpu_torch.io import checkpoint as ckpt
    from mmlspark_tpu_torch.models.trainer import NNLearner
    from mmlspark_tpu_torch.parallel import MeshSpec, build_mesh, dist
    from mmlspark_tpu_torch.parallel.topology import distributed_init

    dev = rank_device(rank, device)
    if dev != "cpu":
        torch.cuda.set_device(torch.device(dev))
    # gloo on the card too: two processes may share it
    distributed_init(init, num_processes=WORLD, process_id=rank,
                     backend="gloo")
    assert tdist.get_world_size() == WORLD
    results = {}

    # -- psum: each process's rows, summed across the boundary
    mesh = build_mesh(MeshSpec.from_dict(FIT_MESH), dev)
    local = np.full((HOSTED, 2), float(rank + 1), np.float32)
    placed, n_true = dist.put_batch({"x": local}, mesh)
    from mmlspark_tpu_torch.parallel.collectives import all_reduce
    got = float(all_reduce(placed["x"].sum()))
    expected = float(sum(HOSTED * 2 * (r + 1) for r in range(WORLD)))
    results["psum"] = {"value": got, "expected": expected,
                       "n_local_rows": int(n_true),
                       "n_hosted": mesh.n_hosted, "ok": got == expected}

    # -- fit: the 2-process NNLearner against the single-process fit
    ref = np.load(ref_path)
    df, x = _fit_frame()
    model = NNLearner(mesh_shape=FIT_MESH, epochs=epochs, device=dev,
                      **_FIT_KW).fit(df)
    scores = model.model.apply(x, device=dev).cpu().numpy().astype(
        np.float64)
    fit_diff = float(np.abs(scores - ref["scores"]).max())
    results["fit"] = {"max_score_diff": fit_diff, "tolerance": TOL,
                      "ok": fit_diff <= TOL}

    # -- pipe: the stages split across the processes, the data ranks
    # hosted in each
    cfg, params, tokens, labels, mask = _pipe_setup(dev)
    pipe_mesh = build_mesh(MeshSpec.from_dict(PIPE_MESH), dev)
    losses, sp = _pipe_losses(cfg, pipe_mesh, params, tokens, labels, mask)
    ref_losses = [float(v) for v in ref["pipe_losses"]]
    pipe_diff = max(abs(a - b) for a, b in zip(losses, ref_losses))
    # this process holds its own stage's block leaves only, and its
    # ranks are stage `rank`'s
    own_stage = all(v.shape[0] == cfg.n_stages // WORLD
                    for bp in sp["blocks"] for v in bp.values())
    stage_ranks = {pipe_mesh.coords(r)[0] for r in pipe_mesh.ranks}
    results["pipe"] = {"losses": losses, "ref_losses": ref_losses,
                       "max_loss_diff": pipe_diff, "tolerance": TOL,
                       "stage_leaves_local": bool(own_stage),
                       "stage_of_ranks": sorted(stage_ranks),
                       "ok": pipe_diff <= TOL and bool(own_stage)
                       and stage_ranks == {rank}}

    # -- checkpoint: one directory, saved by both processes
    tree = _ckpt_tree()
    ck_mesh = dist.train_mesh(CKPT_MESH, dev)
    ckpt.manager(ckpt_dir).save(1, dist.shard_state(tree, ck_mesh),
                                specs=dist.state_specs(tree, ck_mesh),
                                mesh=ck_mesh)
    results["checkpoint"] = {"saved": True, "dir": ckpt_dir,
                             "n_hosted": ck_mesh.n_hosted}

    if rank == 0:
        results["passed"] = all(v.get("ok", True) for v in results.values()
                                if isinstance(v, dict))
        with open(out_path, "w") as f:
            json.dump(results, f)
    tdist.barrier()
    tdist.destroy_process_group()
    print(f"RANK{rank}_DONE", flush=True)


# ---------------------------------------------------------------------------
# the parent: the reference, the world, the single-process restore


def run_restore(ckpt_dir: str) -> dict:
    from mmlspark_tpu_torch.io import checkpoint as ckpt
    tree = _ckpt_tree()
    mngr = ckpt.manager(ckpt_dir, create=False)
    ok_digest, _ = ckpt.verify_digest(mngr._step_dir(1), strict=True)
    restored = mngr.restore(1, tree, strict_digest=True)
    exact = all(np.array_equal(restored[k].numpy(), tree[k]) for k in tree)
    return {"digest_verified": bool(ok_digest), "restored_exact": bool(exact),
            "ok": bool(ok_digest and exact)}


def rank_device(rank: int, device: str) -> str:
    """Where a rank's process computes: the CPU, or the cards in turn
    (every process on ``cuda:0`` with one card)."""
    if device == "cpu":
        return "cpu"
    return f"cuda:{rank % torch.cuda.device_count()}"


def _check_device(device) -> str:
    from mmlspark_tpu_torch.core.environment import resolve_device
    return resolve_device(device).type


def run_drill(timeout: float = 300.0, smoke: bool = False, device=None,
              workdir=None) -> dict:
    """The whole drill -> its report (``passed``). ``workdir`` keeps the
    reference, the worker outputs and the checkpoint there (default: a
    temp directory, removed at the end)."""
    device = _check_device(device)
    epochs = 2 if smoke else 5
    tmp = workdir or tempfile.mkdtemp(prefix="dcn_drill_")
    os.makedirs(tmp, exist_ok=True)
    ref_path = os.path.join(tmp, "ref.npz")
    out_path = os.path.join(tmp, "out.json")
    ckpt_dir = os.path.join(tmp, "ckpt")
    out = {"metricname": "multiprocess_dcn_v1", "smoke": smoke,
           "device": device, "world": WORLD, "hosted_ranks": HOSTED}

    t0 = time.time()
    ref = run_reference(epochs, "cpu" if device == "cpu" else "cuda:0")
    np.savez(ref_path, **ref)
    out["reference"] = {"elapsed_s": round(time.time() - t0, 1),
                        "pipe_losses": ref["pipe_losses"]}

    if device == "cuda":
        # the ranks load the kernel library this process builds
        from mmlspark_tpu_torch.native import cuda_build
        cuda_build.build()
    env = dict(os.environ)
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env["PYTHONPATH"] = root + (os.pathsep + env["PYTHONPATH"]
                                if env.get("PYTHONPATH") else "")
    init = f"file://{os.path.join(tmp, 'rdv')}"
    procs = []
    t0 = time.time()
    for rank in range(WORLD):
        # own session per worker: a timeout kill reaps the whole group
        # (a collective peer blocks forever once its twin dies)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "mmlspark_tpu_torch.tools."
             "launch_multiprocess", "--worker", str(rank), "--init", init,
             "--out", out_path, "--ref", ref_path, "--ckpt-dir", ckpt_dir,
             "--epochs", str(epochs), "--device", device],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env, cwd=root, start_new_session=True))
    tails, timed_out = [], False
    try:
        for p in procs:
            try:
                remain = max(timeout - (time.time() - t0), 5.0)
                o, _ = p.communicate(timeout=remain)
                tails.append(o[-1500:])
            except subprocess.TimeoutExpired:
                timed_out = True
                tails.append("timed out")
    finally:
        for p in procs:
            if p.poll() is None:
                try:
                    os.killpg(os.getpgid(p.pid), signal.SIGKILL)
                except (ProcessLookupError, PermissionError):
                    p.kill()
                try:
                    p.wait(timeout=5)
                except subprocess.TimeoutExpired:
                    pass
    failed = timed_out or any(p.returncode for p in procs)
    out["workers"] = {"rcs": [p.returncode for p in procs],
                      "elapsed_s": round(time.time() - t0, 1),
                      "timeout": timed_out,
                      "tails": tails if failed else None}
    if failed or not os.path.exists(out_path):
        out["passed"] = False
        return out
    with open(out_path) as f:
        out["phases"] = json.load(f)

    # one process restores the two processes' save, bit for bit
    out["checkpoint_restore"] = run_restore(ckpt_dir)
    out["passed"] = bool(out["phases"].get("passed")
                         and out["checkpoint_restore"]["ok"])
    if workdir is None:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--worker", default=None, help="internal: <rank>")
    ap.add_argument("--init", default=None)
    ap.add_argument("--out", default=None)
    ap.add_argument("--ref", default=None)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--epochs", type=int, default=5)
    ap.add_argument("--device", default=None,
                    help="cpu, or the card (the default; raises without "
                         "CUDA): both processes over gloo")
    ap.add_argument("--timeout", type=float, default=300.0,
                    help="the world's subprocess timeout (s)")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)

    if args.worker is not None:
        run_worker(int(args.worker), args.init, args.out, args.ref,
                   args.ckpt_dir, args.epochs, args.device)
        return {}
    out = run_drill(timeout=args.timeout, smoke=args.smoke,
                    device=args.device)
    print(json.dumps(out, indent=None if args.json else 2, default=float))
    if not out.get("passed"):
        sys.exit(1)
    return out


if __name__ == "__main__":
    main()
