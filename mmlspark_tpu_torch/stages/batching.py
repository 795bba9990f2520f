"""Minibatching: row streams <-> batch rows, plus iterator batchers (the
port's copy of ``mmlspark_tpu/stages/batching.py``).

Capability parity with `io/http/src/main/scala/MiniBatchTransformer.scala`
(FixedMiniBatchTransformer / DynamicMiniBatchTransformer / FlattenBatch)
and the iterator batchers in `Batchers.scala:12,65,117,131`
(DynamicBufferedBatcher, FixedBatcher, TimeIntervalBatcher) used by the
HTTP/serving layer to trade latency for batch efficiency.

In the columnar world a "batch row" is a row whose cells are lists/arrays
of the original cell type.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Any, Iterable, Iterator, List, Optional, Sequence

import numpy as np

from mmlspark_tpu_torch.core.dataframe import DataFrame
from mmlspark_tpu_torch.core.params import Param
from mmlspark_tpu_torch.core.stage import Transformer


# ---------------------------------------------------------------------------
# Iterator batchers (host-side; serving hot path)
# ---------------------------------------------------------------------------

class FixedBatcher:
    """Group an iterator into lists of exactly ``batch_size`` (last may be short)."""

    def __init__(self, batch_size: int):
        self.batch_size = batch_size

    def __call__(self, it: Iterable[Any]) -> Iterator[List[Any]]:
        batch: List[Any] = []
        for x in it:
            batch.append(x)
            if len(batch) >= self.batch_size:
                yield batch
                batch = []
        if batch:
            yield batch


class DynamicBufferedBatcher:
    """Background-thread buffering: each batch is whatever is ready.

    Parity: DynamicBufferedBatcher (`Batchers.scala:12`) — a producer
    thread fills a bounded queue; the consumer drains everything
    currently available into one batch, so slow consumers get bigger
    batches instead of backpressure.
    """

    _DONE = object()

    def __init__(self, max_buffer_size: int = 1000):
        self.max_buffer_size = max_buffer_size

    def __call__(self, it: Iterable[Any]) -> Iterator[List[Any]]:
        q: "queue.Queue[Any]" = queue.Queue(maxsize=self.max_buffer_size)
        error: List[BaseException] = []

        def produce():
            try:
                for x in it:
                    q.put(x)
            except BaseException as e:  # propagate to consumer
                error.append(e)
            finally:
                q.put(self._DONE)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        done = False
        while not done:
            batch = [q.get()]  # block for at least one element
            while True:
                try:
                    batch.append(q.get_nowait())
                except queue.Empty:
                    break
            if batch and batch[-1] is self._DONE:
                batch.pop()
                done = True
            if batch:
                yield batch
        if error:
            raise error[0]


class BucketBatcher:
    """Group an iterator along the power-of-two bucket ladder:
    1, 2, 4, ... up to ``cap``, then ``cap`` forever (final partial batch
    as-is).

    The streaming companion of the serving data plane's shape buckets
    (:func:`mmlspark_tpu_torch.parallel.sharding.bucket_target` — the same
    ladder): pushing a stream through it dispatches every compiled
    bucket shape exactly once on the way up, so it doubles as the
    warm-up schedule for bucketed scorers and servers
    (``tools/bench_serving_pipeline.py`` warms its workers with it).
    """

    def __init__(self, cap: int = 1024):
        from mmlspark_tpu_torch.parallel.sharding import bucket_target
        self.cap = max(int(cap), 1)
        self._target = bucket_target

    def __call__(self, it: Iterable[Any]) -> Iterator[List[Any]]:
        size = 1
        batch: List[Any] = []
        for x in it:
            batch.append(x)
            if len(batch) >= size:
                yield batch
                batch = []
                size = min(self._target(size + 1, self.cap), self.cap)
        if batch:
            yield batch


class TimeIntervalBatcher:
    """Emit a batch at most every ``interval`` seconds (parity: Batchers.scala:131)."""

    def __init__(self, interval: float, max_batch_size: int = 10 ** 9):
        self.interval = interval
        self.max_batch_size = max_batch_size

    def __call__(self, it: Iterable[Any]) -> Iterator[List[Any]]:
        batch: List[Any] = []
        deadline = time.monotonic() + self.interval
        for x in it:
            batch.append(x)
            if len(batch) >= self.max_batch_size or time.monotonic() >= deadline:
                yield batch
                batch = []
                deadline = time.monotonic() + self.interval
        if batch:
            yield batch


# ---------------------------------------------------------------------------
# DataFrame-level batch/flatten stages
# ---------------------------------------------------------------------------

def _group_column(col: np.ndarray, bounds: Sequence[int]) -> np.ndarray:
    out = []
    for i in range(len(bounds) - 1):
        chunk = col[bounds[i]:bounds[i + 1]]
        out.append(list(chunk) if col.dtype == np.dtype("O") else np.asarray(chunk))
    return np.array(out, dtype=object)


class FixedMiniBatchTransformer(Transformer):
    """Group every ``batch_size`` rows into one batch row.

    Parity: FixedMiniBatchTransformer (`MiniBatchTransformer.scala:40`).
    """

    batch_size = Param(10, "rows per batch", ptype=int)
    max_buffer_size = Param(None, "unused; API parity", ptype=int)

    def transform(self, df: DataFrame) -> DataFrame:
        n = df.num_rows
        bounds = list(range(0, n, self.batch_size)) + [n]
        return DataFrame({name: _group_column(df[name], bounds)
                          for name in df.columns})


class DynamicMiniBatchTransformer(Transformer):
    """Single-batch grouping of whatever rows are present.

    Parity: DynamicMiniBatchTransformer (`MiniBatchTransformer.scala`) —
    in batch mode all available rows form one minibatch; streaming uses
    DynamicBufferedBatcher at the iterator level.
    """

    max_batch_size = Param(2 ** 31 - 1, "cap on rows per batch", ptype=int)

    def transform(self, df: DataFrame) -> DataFrame:
        return FixedMiniBatchTransformer(
            batch_size=min(self.max_batch_size, max(df.num_rows, 1))
        ).transform(df)


class FlattenBatch(Transformer):
    """Inverse of minibatching: explode batch rows back to scalar rows.

    Parity: FlattenBatch (`MiniBatchTransformer.scala:160`).
    """

    def transform(self, df: DataFrame) -> DataFrame:
        if df.num_rows == 0:
            return df
        cols = {name: [] for name in df.columns}
        for row in df.rows():
            lengths = {len(v) for v in row.values()}
            if len(lengths) != 1:
                raise ValueError(f"ragged batch row: lengths {lengths}")
            for name, v in row.items():
                cols[name].extend(list(v))
        return DataFrame({name: cols[name] for name in df.columns})
