"""The port's forms over processes, one process of a ``torch.distributed``
world at a time: tensor-parallel decode, ``NNModel`` tensor-parallel
scoring, an ``NNLearner`` fit and a cooperative checkpoint, each on a
mesh spread over the world (one rank per process, or several hosted by
each).

Each process of a world runs::

    python -m mmlspark_tpu_torch.testing.process_world --init file:///tmp/rdv \\
        --world 2 --rank 0 --case tp_decode --device cpu --out r0.json

which joins the process group over gloo (processes that share one card
meet over gloo too: each computes on its device, and only the exchanges
cross the host), runs the case with ``--args`` (JSON) and writes its
result as JSON. ``--case a+b`` runs several cases in one world, ``--args``
then holding each case's args by name, and the result each case's.
:func:`spawn` starts a whole world and gathers the results. Without
``--device`` every process computes on ``cuda:0``; on a card each
process also counts the calls its kernel wrappers make to their plain
versions on CUDA tensors (``plain_on_card``, which must stay empty).

* ``tp_decode`` — greedy decode of seeded prompts on a ``{"data": d,
  "model": t}`` decoder (:func:`greedy_lockstep`: every process steps
  alike), a prefix hit included; the tokens and the process's K1-K3
  launches.
* ``nn_tp`` — ``NNModel(tensor_parallel=t)`` scores of a seeded MLP on
  seeded rows, beside the single-device scores of the same process.
* ``learner`` — ``NNLearner(mesh_shape=...)`` on seeded rows; its losses
  and scores.
* ``checkpoint`` — a seeded tree placed on ``mesh`` by ``shard_state``
  and saved by every process into one directory;
* ``train_step`` — steps of ``build_spmd_train_step`` for each of
  ``runs`` (mesh, config, impl) from the tree in ``tree`` (an ``.npz``
  of :func:`flat_tree`'s keys); the losses and the whole parameters
  after the steps;
* ``collectives`` — ``ring_permute`` both ways, ``allreduce_sum`` and
  ``all_to_all`` of seeded per-rank tensors on ``mesh``, and the
  gradient of a ring permute; this process's ranks' results;
* ``gbdt`` — ``Booster.train`` with each of ``fits`` (``BoosterParams``
  fields) sharded over ``mesh`` on the arrays in ``data`` (an ``.npz``
  of ``<name>.X`` and ``<name>.y``); the model strings.
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
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

#: the small dense decode config of ``tests/test_torch_tp_decode.py``
DECODE_CFG = dict(vocab=64, d_model=32, n_heads=4, d_head=8, d_ff=64,
                  n_stages=1, layers_per_stage=2)
DECODE_KW = dict(n_slots=4, max_len=64, page_size=8)


def greedy_lockstep(decoder, prompts: Sequence[Sequence[int]],
                    max_new: int, hit_len: int = 0) -> List[List[int]]:
    """Greedy decode of each prompt in a slot of its own, every slot
    stepped together, with no scheduler: a loop that every process of a
    decoder over processes runs alike (its collectives meet step for
    step). With ``hit_len`` (page-aligned) every prompt after the first
    shares the first's first ``hit_len`` tokens and reads them from its
    pages (the prefix prefill, K3 on the card) instead of prefilling
    them. Returns each prompt's ``max_new`` tokens."""
    n_slots = decoder.n_slots
    if len(prompts) > n_slots:
        raise ValueError(f"{len(prompts)} prompts for {n_slots} slots")
    tables = None
    if decoder.paged:
        tables = decoder._identity_tables.copy()
    out: List[List[int]] = []
    tok = np.zeros(n_slots, np.int32)
    pos = np.zeros(n_slots, np.int32)
    for s, prompt in enumerate(prompts):
        prompt = np.asarray(prompt, np.int32)
        if s and hit_len:
            if not np.array_equal(prompt[:hit_len],
                                  np.asarray(prompts[0][:hit_len])):
                raise ValueError("a prefix hit needs the first prompt's "
                                 "first hit_len tokens")
            shared = hit_len // decoder.page_size
            tables[s, :shared] = tables[0, :shared]
            first = decoder.prefill_prefix_logits(s, prompt, hit_len,
                                                  tables[s])[0]
        else:
            first = decoder.prefill(
                s, prompt, None if tables is None else tables[s])
        out.append([int(first)])
        tok[s], pos[s] = first, len(prompt)
    for _ in range(max_new - 1):
        nxt = decoder.step(tok, pos, tables)
        for s in range(len(prompts)):
            out[s].append(int(nxt[s]))
        tok[:len(prompts)] = nxt[:len(prompts)]
        pos[:len(prompts)] += 1
    return out


def decode_prompts(seed: int = 1, n: int = 3, length: int = 20,
                   vocab: int = 64) -> List[List[int]]:
    """``n`` seeded prompts that share their first 16 tokens."""
    rng = np.random.default_rng(seed)
    head = rng.integers(1, vocab, size=16)
    return [np.concatenate([head, rng.integers(1, vocab,
                                               size=length - 16)]).tolist()
            for _ in range(n)]


def _kernel_launches() -> Dict[str, int]:
    from mmlspark_tpu_torch.parallel import cuda_attention as CA
    return {k: CA.LAUNCHES[k] for k in ("paged_decode_attention",
                                        "flash_prefill_attention",
                                        "paged_prefix_prefill_attention")}


def tp_decode_case(device: str, args: Dict[str, Any]) -> Dict[str, Any]:
    from mmlspark_tpu_torch.models import transformer as T
    from mmlspark_tpu_torch.parallel import cuda_attention as CA
    from mmlspark_tpu_torch.parallel.dist import train_mesh
    from mmlspark_tpu_torch.serving.decode import TransformerDecoder
    cfg = T.TransformerConfig(**args.get("cfg", DECODE_CFG))
    tree = T.init_params_np(cfg, seed=int(args.get("seed", 0)))
    mesh = train_mesh(args.get("mesh", {"data": 1, "model": 2}), device)
    dec = TransformerDecoder(tree, cfg, mesh=mesh,
                             **args.get("decoder", DECODE_KW))
    prompts = args.get("prompts") or decode_prompts(vocab=cfg.vocab)
    CA.reset_launch_counts()
    t0 = time.perf_counter()
    tokens = greedy_lockstep(dec, prompts, int(args.get("max_new", 8)),
                             int(args.get("hit_len", 16)))
    if dec.device.type == "cuda":
        torch.cuda.synchronize(dec.device)
    return {"tokens": tokens, "launches": _kernel_launches(),
            "seconds": time.perf_counter() - t0,
            "attn_impl": dec.attn_impl,
            "pool_heads": int(dec.cache["k"].shape[-2]),
            "placement": dec.placement()}


def seeded_mlp(args: Dict[str, Any]):
    """The ``nn_tp`` case's network (``arch``, an MLP by default, from
    ``NNFunction.init`` at ``seed``) and its seeded rows of
    ``input_shape``."""
    from mmlspark_tpu_torch.models.function import NNFunction
    shape = tuple(args.get("input_shape", (16,)))
    fn = NNFunction.init(args.get("arch", {"builder": "mlp",
                                           "hidden": [64, 32],
                                           "num_outputs": 4}),
                         shape, seed=int(args.get("seed", 1)))
    x = np.random.default_rng(int(args.get("seed", 1))).normal(
        size=(int(args.get("rows", 64)), *shape))
    return fn, x.astype(np.float32)


def nn_tp_case(device: str, args: Dict[str, Any]) -> Dict[str, Any]:
    from mmlspark_tpu_torch.core.dataframe import DataFrame
    from mmlspark_tpu_torch.models.nn import NNModel
    fn, x = seeded_mlp(args)
    if device != "cpu":
        torch.cuda.synchronize()
    tp = int(args.get("tensor_parallel", 2))
    model = NNModel(model=fn, input_col="x", device=device,
                    tensor_parallel=tp, batch_size=int(args.get("batch", 32)))
    t0 = time.perf_counter()
    scores = np.stack(list(model.transform(DataFrame({"x": x}))["scores"]))
    seconds = time.perf_counter() - t0
    single = NNModel(model=fn, input_col="x", device=device)
    want = np.stack(list(single.transform(DataFrame({"x": x}))["scores"]))
    return {"scores": scores.tolist(), "single": want.tolist(),
            "max_abs_diff": float(np.abs(scores - want).max()),
            "seconds": seconds, "placement": model.placement()}


#: the ``learner`` case's fit (``tools/launch_multiprocess.py``'s)
LEARNER_ARCH = {"builder": "mlp", "hidden": [16], "num_outputs": 2}
LEARNER_KW = dict(epochs=2, batch_size=64, log_every=0, seed=3,
                  optimizer="adam", learning_rate=0.01)


def learner_rows(seed: int = 42, n: int = 128):
    """Two seeded blobs of ``n`` rows each, shuffled: (x, y)."""
    rng = np.random.default_rng(seed)
    x = np.concatenate([rng.normal(-2.0, size=(n, 4)),
                        rng.normal(2.0, size=(n, 4))]).astype(np.float32)
    y = np.concatenate([np.zeros(n), np.ones(n)]).astype(np.int64)
    perm = rng.permutation(len(x))
    return x[perm], y[perm]


def learner_case(device: str, args: Dict[str, Any]) -> Dict[str, Any]:
    from mmlspark_tpu_torch.core.dataframe import DataFrame
    from mmlspark_tpu_torch.models.function import (
        NNFunction, unflatten_params,
    )
    from mmlspark_tpu_torch.models.trainer import NNLearner
    x, y = learner_rows()
    fn = None
    if "start" in args:
        with np.load(args["start"]) as z:
            fn = NNFunction(arch=dict(LEARNER_ARCH), params=unflatten_params(
                {k: z[k] for k in z.files}))
    learner = NNLearner(model=fn, arch=LEARNER_ARCH, mesh_shape=args["mesh"],
                        device=device, **LEARNER_KW)
    model = learner.fit(DataFrame({"features": x, "label": y}))
    scores = model.model.apply(x, device=device).cpu().numpy()
    return {"losses": np.concatenate(learner.losses).tolist(),
            "scores": scores.tolist()}


def checkpoint_tree(seed: int = 7) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=(64, 32)).astype(np.float32),
            "b": rng.normal(size=(32,)).astype(np.float32),
            "moment": rng.normal(size=(64, 32)).astype(np.float32)}


def checkpoint_case(device: str, args: Dict[str, Any]) -> Dict[str, Any]:
    from mmlspark_tpu_torch.io import checkpoint as ckpt
    from mmlspark_tpu_torch.parallel import dist
    tree = checkpoint_tree()
    mesh = dist.train_mesh(args["mesh"], device)
    ckpt.save_sharded(args["dir"], dist.shard_state(tree, mesh),
                      extra={"step": 1}, specs=dist.state_specs(tree, mesh),
                      mesh=mesh)
    return {"n_hosted": mesh.n_hosted, "ranks": mesh.ranks}


def flat_tree(tree) -> Dict[str, np.ndarray]:
    """A transformer tree as flat ``embed``/``head``/``final_norm``/
    ``blocks/<i>/<leaf>`` arrays (an ``.npz``'s keys)."""
    out = {k: np.asarray(tree[k]) for k in ("embed", "head", "final_norm")}
    for i, bp in enumerate(tree["blocks"]):
        out.update({f"blocks/{i}/{k}": np.asarray(v) for k, v in bp.items()})
    return out


def unflat_tree(flat: Dict[str, np.ndarray]) -> Dict[str, Any]:
    n = 1 + max(int(k.split("/")[1]) for k in flat if k.startswith("b"))
    blocks = [{k.split("/")[2]: v for k, v in flat.items()
               if k.startswith(f"blocks/{i}/")} for i in range(n)]
    return {**{k: flat[k] for k in ("embed", "head", "final_norm")},
            "blocks": blocks}


def train_step_case(device: str, args: Dict[str, Any]) -> Dict[str, Any]:
    from mmlspark_tpu_torch.models import transformer as T
    from mmlspark_tpu_torch.parallel.topology import MeshSpec, build_mesh
    out = {}
    for key, run in args["runs"].items():
        cfg = T.TransformerConfig(**run["cfg"])
        with np.load(run["tree"]) as z:
            tree = unflat_tree({k: z[k] for k in z.files})
        mesh = build_mesh(MeshSpec.from_dict(run["mesh"]), device)
        params = T.shard_params(tree, cfg, mesh)
        velocity = T.init_velocity(params)
        batch = T.make_batch(np.random.default_rng(int(run.get(
            "batch_seed", 7))), cfg, int(run.get("batch", 8)),
            int(run.get("seq", 16)), device)
        step = T.build_spmd_train_step(cfg, mesh, float(run.get("lr", 0.1)),
                                       float(run.get("momentum", 0.9)),
                                       impl=run.get("impl", "auto"))
        losses = [float(step(params, velocity, *batch)[2])
                  for _ in range(int(run.get("steps", 3)))]
        out[key] = {"losses": losses, "n_hosted": mesh.n_hosted,
                    "params": {k: v.tolist() for k, v in flat_tree(
                        T.params_to_numpy(params, cfg, mesh)).items()}}
    return out


def collectives_case(device: str, args: Dict[str, Any]) -> Dict[str, Any]:
    from mmlspark_tpu_torch.parallel import collectives as C
    from mmlspark_tpu_torch.parallel.topology import MeshSpec, build_mesh
    mesh = build_mesh(MeshSpec.from_dict(args["mesh"]), device)
    axis = mesh.axis(args["axis"])
    full = torch.from_numpy(np.random.default_rng(3).normal(
        size=(mesh.size, 8, 6)).astype(np.float32))
    x = full[mesh.ranks].to(mesh.device)
    g = x.clone().requires_grad_(True)
    (C.ring_permute(g, axis, 1) * torch.arange(
        6, dtype=torch.float32, device=mesh.device)).sum().backward()
    return {k: v.cpu().tolist() for k, v in {
        "ring_fwd": C.ring_permute(x, axis, 1),
        "ring_back": C.ring_permute(x, axis, -1),
        "sum": C.allreduce_sum(x, axis),
        "a2a": C.all_to_all(x, axis, 0, 1),
        "ring_grad": g.grad}.items()}


def gbdt_case(device: str, args: Dict[str, Any]) -> Dict[str, Any]:
    import mmlspark_tpu_torch.gbdt as G
    from mmlspark_tpu_torch.parallel.topology import MeshSpec, build_mesh
    mesh = build_mesh(MeshSpec.from_dict(args["mesh"]), device)
    with np.load(args["data"]) as z:
        arrays = {k: z[k] for k in z.files}
    return {name: G.Booster.train(G.BoosterParams(**kw),
                                  arrays[name + ".X"], arrays[name + ".y"],
                                  sharding=mesh).model_to_string()
            for name, kw in args["fits"].items()}


CASES = {"tp_decode": tp_decode_case, "nn_tp": nn_tp_case,
         "learner": learner_case, "checkpoint": checkpoint_case,
         "train_step": train_step_case, "collectives": collectives_case,
         "gbdt": gbdt_case}


def spawn(case: str, world: int, args: Dict[str, Any],
          device: Optional[str] = None, timeout: float = 300.0,
          workdir: Optional[str] = None) -> List[Dict[str, Any]]:
    """Run ``case`` in a world of ``world`` fresh processes (a
    ``file://`` rendezvous under ``workdir``, a temp directory by
    default) -> each process's result, by rank. Raises with the
    processes' output tails when one fails or the world outlasts
    ``timeout``."""
    tmp = workdir or tempfile.mkdtemp(prefix="process_world_")
    os.makedirs(tmp, exist_ok=True)
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = root + (os.pathsep + env["PYTHONPATH"]
                                if env.get("PYTHONPATH") else "")
    init = f"file://{os.path.join(tmp, f'rdv_{case}_{time.time_ns()}')}"
    outs = [os.path.join(tmp, f"{case}_{r}.json") for r in range(world)]
    cmd = [sys.executable, "-m", "mmlspark_tpu_torch.testing.process_world",
           "--init", init, "--world", str(world), "--case", case,
           "--args", json.dumps(args)]
    if device is not None:
        cmd += ["--device", device]
    procs = [subprocess.Popen(cmd + ["--rank", str(r), "--out", outs[r]],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, env=env,
                              cwd=root, start_new_session=True)
             for r in range(world)]
    try:
        tails = _communicate(procs, timeout)
        if any(p.returncode for p in procs):
            raise RuntimeError(f"process_world {case}: exit codes "
                               f"{[p.returncode for p in procs]}:\n"
                               + "\n---\n".join(tails))
        results = []
        for path in outs:
            with open(path) as f:
                results.append(json.load(f))
        return results
    finally:
        if workdir is None:
            shutil.rmtree(tmp, ignore_errors=True)


def _communicate(procs, timeout: float) -> List[str]:
    """Each process's output tail once all have ended; any still running
    after ``timeout`` is killed with its process group."""
    tails, t0 = [], time.time()
    try:
        for p in procs:
            try:
                o, _ = p.communicate(
                    timeout=max(timeout - (time.time() - t0), 5.0))
                tails.append(o[-3000:])
            except subprocess.TimeoutExpired:
                tails.append("timed out")
    finally:
        for p in procs:
            if p.poll() is None:
                try:
                    os.killpg(os.getpgid(p.pid), signal.SIGKILL)
                except (ProcessLookupError, PermissionError):
                    p.kill()
                p.wait()
    return tails


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--init", required=True,
                    help="torch.distributed init method (file:// or tcp://)")
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--case", required=True,
                    help=f"one of {sorted(CASES)}, or several joined by +")
    ap.add_argument("--args", default="{}", help="the case's args as JSON")
    ap.add_argument("--device", default="cuda:0",
                    help="cpu, or the card every process computes on "
                         "(default cuda:0)")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    from mmlspark_tpu_torch.parallel.topology import distributed_init
    if args.device != "cpu":
        from mmlspark_tpu_torch.core.environment import resolve_device
        torch.cuda.set_device(resolve_device(args.device))
    distributed_init(args.init, args.world, args.rank, backend="gloo")
    cases, given = args.case.split("+"), json.loads(args.args)
    if args.device != "cpu":
        from mmlspark_tpu_torch.examples._common import count_plain_on_card
        count_plain_on_card()
    if len(cases) == 1:
        out = CASES[cases[0]](args.device, given)
    else:
        out = {c: CASES[c](args.device, given.get(c, {})) for c in cases}
    if args.device != "cpu":
        from mmlspark_tpu_torch.examples._common import PLAIN_ON_CARD
        out["plain_on_card"] = dict(PLAIN_ON_CARD)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    with open(args.out, "w") as f:
        json.dump(out, f, default=float)


if __name__ == "__main__":
    main()
