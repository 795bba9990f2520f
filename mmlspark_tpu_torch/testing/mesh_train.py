"""A few steps of the transformer train step over a (data, seq) mesh, for
a hosted mesh in this process or one rank of a ``torch.distributed``
process mesh.

Each rank of a process mesh runs::

    python -m mmlspark_tpu_torch.testing.mesh_train --init file:///tmp/rdv \\
        --world 2 --rank 0 --mesh seq=2 --mesh data=2 --out rank0.npz

which joins the process group (gloo on the CPU), then for each
``--mesh`` builds the mesh, seeded weights (:func:`init_params_np`) and
one seeded global batch (``make_batch``), takes ``--steps`` steps of
:func:`build_spmd_train_step` and saves the losses and the parameters
after the last step (``<mesh>/loss``, ``<mesh>/<leaf path>``). Called
without ``--world``, the same runs on hosted meshes in one process.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from typing import Dict, List

import numpy as np
import torch

from mmlspark_tpu_torch.models import transformer as T
from mmlspark_tpu_torch.parallel.topology import (
    MeshSpec, build_mesh, distributed_init,
)

#: the small dense config of the JAX package's SPMD tests
SMALL = dict(vocab=64, d_model=16, n_heads=4, d_head=8, d_ff=32,
             layers_per_stage=2)


def mesh_key(shape: Dict[str, int]) -> str:
    return ",".join(f"{a}={n}" for a, n in shape.items())


def run(cfg: T.TransformerConfig, meshes: List[Dict[str, int]],
        steps: int = 2, batch: int = 8, seq: int = 16, seed: int = 0,
        lr: float = 0.1, momentum: float = 0.9,
        device: str = "cpu") -> Dict[str, np.ndarray]:
    """For each mesh shape: the losses of ``steps`` steps and the
    parameters after them, as ``{"<mesh>/loss": ..., "<mesh>/<leaf>":
    ...}`` numpy arrays."""
    out: Dict[str, np.ndarray] = {}
    tree = T.init_params_np(cfg, seed=seed)
    for shape in meshes:
        mesh = build_mesh(MeshSpec.from_dict(shape), device)
        params = T.shard_params(tree, cfg, mesh)
        velocity = T.init_velocity(params)
        tokens, labels, mask = T.make_batch(np.random.default_rng(seed + 1),
                                            cfg, batch, seq, device)
        step = T.build_spmd_train_step(cfg, mesh, lr, momentum)
        key = mesh_key(shape)
        out[f"{key}/loss"] = np.array(
            [float(step(params, velocity, tokens, labels, mask)[2])
             for _ in range(steps)])
        named = T.params_to_numpy(params)
        for name in ("embed", "head", "final_norm"):
            out[f"{key}/{name}"] = named[name]
        for i, bp in enumerate(named["blocks"]):
            for k, v in bp.items():
                out[f"{key}/blocks/{i}/{k}"] = v
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--init", required=True,
                    help="torch.distributed init method (file:// or tcp://)")
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--mesh", action="append", required=True,
                    help="axis=size[,axis=size]; repeat for several meshes")
    ap.add_argument("--cfg", default=json.dumps(SMALL),
                    help="TransformerConfig fields as JSON")
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    distributed_init(args.init, args.world, args.rank, backend="gloo")
    cfg = dataclasses.replace(T.TransformerConfig(), **json.loads(args.cfg))
    meshes = [{a: int(n) for a, n in (kv.split("=") for kv in m.split(","))}
              for m in args.mesh]
    np.savez(args.out, **run(cfg, meshes, steps=args.steps))
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
