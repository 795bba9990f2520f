"""The repo's model zoo, read by the examples through the port's
``ModelDownloader`` into a temporary cache (nothing is written outside
the process's temp directory)."""

from __future__ import annotations

import os
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
ZOO = os.path.join(REPO, "zoo")


def load(name: str):
    """``(meta, NNFunction)`` of a zoo model, hash-verified."""
    from mmlspark_tpu_torch.models.zoo import ModelDownloader
    with tempfile.TemporaryDirectory(prefix="mmlspark_zoo_") as cache:
        d = ModelDownloader(cache, repo=ZOO)
        return d.list_models()[name], d.load(name)
