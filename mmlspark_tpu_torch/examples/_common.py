"""Shared plumbing of the port's examples: the device, timing, the
bundled datasets, the kernel launches counted in this process and the
result line.

Counterpart of ``examples/_common.py``. The JAX scripts read
``MMLSPARK_TPU_EXAMPLE_CPU=1`` to move onto a virtual CPU mesh; the
port's take ``--device cpu`` instead, and without it run on the card,
raising where there is no CUDA device: nothing falls back to the CPU.
"""

from __future__ import annotations

import argparse
import csv
import gzip
import json
import os
import sys
import time
from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np
import torch

from mmlspark_tpu_torch.core.environment import DeviceLike, resolve_device

DATA_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
#: the environment switch the port's serving workers read for the CPU
SERVING_CPU_ENV = "MMLSPARK_TPU_SERVING_CPU"


class timed:
    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.seconds = time.perf_counter() - self.t0


def example_device(device: DeviceLike = None) -> str:
    """The device an example runs on: ``None`` is the card (raising
    without CUDA), ``"cpu"`` the CPU. Returned as the string every
    stage's ``device`` param takes."""
    return str(resolve_device(device))


def build_kernels(device: DeviceLike) -> None:
    """On the card, build the kernel library before any worker process
    starts, so every worker loads the cached build and none compiles
    it beside another."""
    if resolve_device(device).type == "cuda":
        from mmlspark_tpu_torch.native import cuda_build
        cuda_build.build()


def worker_env(device: DeviceLike, repo_root: Optional[str] = None
               ) -> Dict[str, str]:
    """The environment of a worker process: the repo on ``PYTHONPATH``,
    and ``MMLSPARK_TPU_SERVING_CPU=1`` when the parent runs on the CPU
    (a worker otherwise serves on the card)."""
    root = repo_root or os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = root + (os.pathsep + env["PYTHONPATH"]
                                if env.get("PYTHONPATH") else "")
    if resolve_device(device).type == "cpu":
        env[SERVING_CPU_ENV] = "1"
    else:
        env.pop(SERVING_CPU_ENV, None)
    return env


# ---------------------------------------------------------------------------
# the datasets scikit-learn bundles, read from copies in ``data/`` (BSD-3,
# see data/COPYING.scikit-learn): the card's machine has no scikit-learn


def load_digits() -> Dict[str, np.ndarray]:
    """scikit-learn's ``load_digits()``: ``images`` (1797, 8, 8) and
    ``data`` (1797, 64) as float64 in 0..16, ``target`` (1797,) int."""
    with gzip.open(os.path.join(DATA_DIR, "digits.csv.gz"), "rt") as f:
        table = np.loadtxt(f, delimiter=",")
    data = table[:, :-1]
    return {"data": data, "images": data.reshape(-1, 8, 8),
            "target": table[:, -1].astype(int)}


def load_breast_cancer(return_X_y: bool = True):
    """scikit-learn's ``load_breast_cancer(return_X_y=True)``: ``X``
    (569, 30) float64 and ``y`` (569,) int."""
    with open(os.path.join(DATA_DIR, "breast_cancer.csv"),
              encoding="utf-8") as f:
        rows = csv.reader(f)
        head = next(rows)
        n, n_feat = int(head[0]), int(head[1])
        X = np.empty((n, n_feat))
        y = np.empty((n,), dtype=int)
        for i, row in enumerate(rows):
            X[i] = np.asarray(row[:-1], dtype=np.float64)
            y[i] = int(row[-1])
    return X, y


# ---------------------------------------------------------------------------
# the kernels launched in this process

#: the modules whose wrappers dispatch to a plain version (through the
#: module's globals, so a counting wrapper installed there sees the call)
_WRAPPER_MODULES = ("mmlspark_tpu_torch.gbdt.cuda_hist",
                    "mmlspark_tpu_torch.ops.fused_ce",
                    "mmlspark_tpu_torch.parallel.cuda_attention")
PLAIN_ON_CARD: Dict[str, int] = {}


def _on_card(args, kwargs) -> bool:
    return any(isinstance(a, torch.Tensor) and a.is_cuda
               for a in (*args, *kwargs.values()))


def count_plain_on_card() -> None:
    """Count in :data:`PLAIN_ON_CARD` every call that a kernel's wrapper
    makes to its plain version on a CUDA tensor (a wrapper launches its
    kernel there, so the count must stay 0). Calls from other modules
    are not counted: the transformer's full-context oracle,
    ``reference_logits``, is dense attention by design. Idempotent."""
    import importlib
    for mod_name in _WRAPPER_MODULES:
        mod = importlib.import_module(mod_name)
        for name in [n for n in vars(mod) if n.endswith("_plain")]:
            fn = getattr(mod, name)
            if getattr(fn, "_counts_card_calls", False):
                continue

            def wrapped(*a, _fn=fn, _mod=mod_name, _key=f"{mod_name}.{name}",
                        **kw):
                if (sys._getframe(1).f_globals.get("__name__") == _mod
                        and _on_card(a, kw)):
                    PLAIN_ON_CARD[_key] = PLAIN_ON_CARD.get(_key, 0) + 1
                return _fn(*a, **kw)

            wrapped._counts_card_calls = True
            setattr(mod, name, wrapped)


def launches() -> Dict[str, int]:
    """The kernel launches counted in this process so far: K9's, K4's
    and K6's, and the attention kernels' (K1-K3, K5, K7, K8)."""
    from mmlspark_tpu_torch.gbdt import cuda_hist as CH
    from mmlspark_tpu_torch.ops import fused_ce as FC
    from mmlspark_tpu_torch.parallel import cuda_attention as CA
    return {**CH.LAUNCHES, **FC.LAUNCHES, **CA.LAUNCHES}


# ---------------------------------------------------------------------------
# the command line


def parser(doc: str) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=doc.strip().splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cpu, or a CUDA device (default: the card; "
                         "raises without CUDA)")
    ap.add_argument("--json", action="store_true",
                    help="also print one JSON line: the numbers, wall "
                         "seconds and this process's kernel launches")
    return ap


def run_main(doc: str, run: Callable[..., Dict[str, Any]],
             argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    """An example's ``main``: parse ``argv``, resolve the device (before
    anything else, so a missing card raises first), call
    ``run(device=...)``, print its ``lines`` and, under
    ``--json``, one JSON object of its numbers (keys that start with
    ``_`` hold objects for callers and are left out), the wall seconds,
    the device and the launches."""
    args = parser(doc).parse_args(argv)
    device = example_device(args.device)
    count_plain_on_card()
    with timed() as t:
        out = run(device=device)
    for line in out.pop("lines", []):
        print(line)
    if args.json:
        numbers = {k: v for k, v in out.items()
                   if k != "name" and not k.startswith("_")}
        print(json.dumps({"example": out["name"], **numbers,
                          "wall_s": t.seconds, "device": device,
                          "card": (torch.cuda.get_device_name(0)
                                   if device.startswith("cuda") else None),
                          "launches": {k: v for k, v in launches().items()
                                       if v},
                          "plain_on_card": dict(PLAIN_ON_CARD)},
                         default=float))
    sys.stdout.flush()
    return out
