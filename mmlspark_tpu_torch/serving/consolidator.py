"""PartitionConsolidator: funnel concurrent callers through few workers.

Capability parity with `io/http/src/main/scala/PartitionConsolidator.scala:103,17`
— the reference funnels rows from many Spark partitions into one worker
per executor so rate-limited services see bounded concurrency. The
columnar equivalent: a Transformer wrapper that caps how many transform
calls run at once process-wide (callers queue on a semaphore), so N
threads scoring against a rate-limited HTTP service behave like the
consolidated single channel.
"""

from __future__ import annotations

import threading
from typing import Dict

from mmlspark_tpu_torch.core.dataframe import DataFrame
from mmlspark_tpu_torch.core.params import Param, in_range
from mmlspark_tpu_torch.core.stage import Transformer

# process-level channels keyed by consolidation group
# (parity: SharedSingleton keyed by uid, SharedVariable.scala:18,37)
_channels: Dict[str, threading.Semaphore] = {}
_channels_lock = threading.Lock()


def _channel(key: str, slots: int) -> threading.Semaphore:
    with _channels_lock:
        if key not in _channels:
            _channels[key] = threading.Semaphore(slots)
        return _channels[key]


class PartitionConsolidator(Transformer):
    """Cap process-wide concurrency of an inner transformer."""

    stage = Param(None, "the transformer to consolidate", complex=True)
    group = Param("default", "consolidation group key", ptype=str)
    max_concurrency = Param(1, "simultaneous transform calls",
                            in_range(lo=1))

    def transform(self, df: DataFrame) -> DataFrame:
        sem = _channel(self.group, self.max_concurrency)
        with sem:
            return self.stage.transform(df)

    def _save_extra(self, path, arrays):
        import os
        self.stage.save(os.path.join(path, "inner"))

    def _load_extra(self, path, arrays):
        import os
        from mmlspark_tpu_torch.core.stage import PipelineStage
        self.stage = PipelineStage.load(os.path.join(path, "inner"))
