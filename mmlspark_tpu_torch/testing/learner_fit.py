"""One ``NNLearner`` fit on a mesh, for one rank of a ``torch.distributed``
process mesh or for a hosted mesh in this process.

Each rank of a process mesh runs::

    python -m mmlspark_tpu_torch.testing.learner_fit --init file:///tmp/rdv \\
        --world 2 --rank 0 --data fit.npz --out rank0.npz

which joins the process group and fits an ``NNLearner`` with
``mesh_shape={"data": world}`` over the frame in ``--data``: its
``features`` and ``label`` arrays, and the warm-start weights as flat
``params/...`` keys beside an ``arch`` JSON string. The fit runs on the
card ``cuda:<rank>`` over NCCL, or with ``--device cpu`` on the CPU over
gloo. ``--cfg`` gives the learner's other params as JSON. It saves
the fit's step losses (``losses``), its weights (flat ``params/...``
keys) and the fitted model's scores on the frame (``scores``). Called
without ``--world``, :func:`run` fits the same on a hosted mesh.
"""

from __future__ import annotations

import argparse
import json
from typing import Any, Dict, Optional

import numpy as np
import torch

from mmlspark_tpu_torch.core.dataframe import DataFrame
from mmlspark_tpu_torch.models.function import (
    NNFunction, flatten_params, unflatten_params,
)
from mmlspark_tpu_torch.models.trainer import NNLearner
from mmlspark_tpu_torch.parallel.topology import distributed_init


def save_inputs(path: str, features: np.ndarray, label: np.ndarray,
                fn: NNFunction) -> None:
    """Write the frame and the warm-start function for :func:`run`."""
    np.savez(path, features=features, label=label,
             arch=np.array(json.dumps(fn.arch)),
             **flatten_params(fn.params))


def run(data: str, mesh_shape: Dict[str, int],
        cfg: Optional[Dict[str, Any]] = None,
        device: Optional[str] = None) -> Dict[str, np.ndarray]:
    """Fit on ``device`` (``None``: the card) from the inputs at ``data``
    -> ``{"losses": ..., "scores": ..., "params/...": ...}``."""
    with np.load(data) as npz:
        arrays = {k: npz[k] for k in npz.files}
    fn = NNFunction(arch=json.loads(str(arrays.pop("arch"))),
                    params=unflatten_params({k: v for k, v in arrays.items()
                                             if k.startswith("params/")}))
    df = DataFrame({"features": arrays["features"],
                    "label": arrays["label"]})
    learner = NNLearner(model=fn, mesh_shape=mesh_shape, device=device,
                        **(cfg or {}))
    model = learner.fit(df)
    return {"losses": np.concatenate(learner.losses),
            "scores": np.asarray(model.transform(df)["scores"]),
            **flatten_params(model.model.params)}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--init", required=True,
                    help="torch.distributed init method (file:// or tcp://)")
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--data", required=True)
    ap.add_argument("--cfg", default="{}",
                    help="NNLearner params as JSON")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card cuda:<rank>, NCCL) or cpu (gloo)")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    on_cpu = args.device == "cpu"
    device = "cpu" if on_cpu else f"cuda:{args.rank}"
    distributed_init(args.init, args.world, args.rank,
                     backend="gloo" if on_cpu else "nccl")
    np.savez(args.out, **run(args.data, {"data": args.world},
                             json.loads(args.cfg), device))
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
