"""Streaming file source: watch a directory, emit new files as frames
(the port of ``mmlspark_tpu/io/streaming.py``; it uses no device).

Parity: the reference's binary/image FileFormats are structured-streaming
capable (`BinaryFileFormat.scala:114` is used by ``readStream`` in the
serving docs), with ``checkpointLocation`` giving resumable progress.
Here the same capability over a local or NFS filesystem: a poller
tracks (path, mtime, size) of matching files, yields each batch of
newly-arrived files as a ``(path, bytes)`` DataFrame (through
:func:`~mmlspark_tpu_torch.io.binary.read_binary_files`), and
optionally journals processed
paths so a restarted stream resumes where it left off.
"""

from __future__ import annotations

import json
import os
import threading
import time
import zipfile
import zlib
from typing import Callable, Iterator, Optional, Set

from mmlspark_tpu_torch.core.dataframe import DataFrame
from mmlspark_tpu_torch.io.binary import read_binary_files


class FileStreamSource:
    """Poll ``path`` for new files; yield them as frames.

    ``checkpoint_location``: optional JSON journal of processed files —
    the ``checkpointLocation`` parity (`docs/mmlspark-serving.md:52`);
    a fresh instance pointed at the same journal skips old files.
    """

    def __init__(self, path: str, pattern: Optional[str] = None,
                 poll_interval: float = 0.5,
                 inspect_zip: bool = True,
                 engine: str = "auto",
                 checkpoint_location: Optional[str] = None):
        self.path = path
        self.pattern = pattern
        self.poll_interval = poll_interval
        self.inspect_zip = inspect_zip
        self.engine = engine
        self.checkpoint_location = checkpoint_location
        self._seen: Set[str] = set()
        self._planned: Set[str] = set()   # engine-mode plan/ack window
        self._read_retry: Set[str] = set()  # transient engine-read fails
        self._fail_counts: dict = {}
        self._quarantined: Set[str] = set()
        self.max_read_failures = 3
        self._stop = threading.Event()
        if checkpoint_location and os.path.exists(checkpoint_location):
            with open(checkpoint_location) as f:
                self._seen = set(json.load(f))
            # dead entries may have accumulated across earlier runs
            # (pre-compaction journals): drop them on the way in
            self._seen = self._compacted(self._seen)

    def stop(self) -> None:
        self._stop.set()

    @staticmethod
    def _key_path(key: str) -> str:
        """The path component of a ``path:mtime_ns:size`` journal key
        (paths may themselves contain colons — split from the right)."""
        return key.rsplit(":", 2)[0]

    @staticmethod
    def _path_gone(path: str) -> bool:
        """True only for GENUINE deletion: a transient stat failure
        (NFS blip, momentary EACCES) must never evict a live file's
        journal key — the next scan would re-offer it as new data."""
        try:
            os.stat(path)
            return False
        except (FileNotFoundError, NotADirectoryError):
            return True
        except OSError:
            return False

    def _compacted(self, keys: Set[str]) -> Set[str]:
        """Drop keys whose file no longer exists on disk: resume
        semantics only need keys a future scan could re-offer, and
        without compaction the set (and its JSON journal) grows by one
        entry per file FOREVER under rolling producers."""
        return {k for k in keys if not self._path_gone(self._key_path(k))}

    #: checkpoints between compaction passes on LARGE journals
    #: (compaction stats every journal key — fine occasionally, or on
    #: small sets, but not per committed batch at thousands of keys)
    _COMPACT_EVERY = 16
    _COMPACT_INLINE_MAX = 256

    def _checkpoint(self) -> None:
        if not self.checkpoint_location:
            return
        self._ckpt_count = getattr(self, "_ckpt_count", 0) + 1
        if len(self._seen) <= self._COMPACT_INLINE_MAX \
                or self._ckpt_count % self._COMPACT_EVERY == 0:
            self._seen = self._compacted(self._seen)
        tmp = f"{self.checkpoint_location}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(sorted(self._seen), f)
        os.replace(tmp, self.checkpoint_location)

    def _scan(self):
        import fnmatch
        out = []
        for root, _, files in os.walk(self.path):
            for name in files:
                if self.pattern and not fnmatch.fnmatch(name, self.pattern):
                    continue
                full = os.path.join(root, name)
                try:
                    st = os.stat(full)
                except OSError:
                    continue
                key = f"{full}:{st.st_mtime_ns}:{st.st_size}"
                if key not in self._seen \
                        and key not in self._quarantined \
                        and key not in self._planned:
                    out.append((full, key))
        return out

    def batches(self, max_batches: Optional[int] = None,
                idle_timeout: Optional[float] = None) -> Iterator[DataFrame]:
        """Yield a frame per poll cycle that found new files.

        ``idle_timeout``: stop after this many seconds without new files
        (None = run until :meth:`stop`). ``max_batches`` bounds the
        number of yielded frames.
        """
        yielded = 0
        last_new = time.monotonic()
        while not self._stop.is_set():
            fresh = self._scan()
            frames, keys = [], []
            for full, key in fresh:
                try:
                    frames.append(read_binary_files(
                        full, inspect_zip=self.inspect_zip,
                        engine=self.engine))
                except OSError:
                    # vanished between scan and read (write-then-move
                    # producers) or transient I/O (EACCES/EIO while a
                    # producer settles): not counted, re-examined next
                    # poll — the sleep below keeps this from spinning
                    continue
                except (zipfile.BadZipFile, zlib.error) as exc:
                    # corrupt content. Retried a few polls — a partial
                    # write heals once complete — then quarantined IN
                    # MEMORY so one bad file can't wedge the stream.
                    # Not journaled: a restart retries it.
                    n = self._fail_counts.get(key, 0) + 1
                    self._fail_counts[key] = n
                    if n >= self.max_read_failures:
                        from mmlspark_tpu_torch.core.logs import get_logger
                        get_logger("io.streaming").warning(
                            "quarantining %s after %d failed reads: %s",
                            full, n, exc)
                        self._quarantined.add(key)
                    continue
                # the file may have been mid-write at scan time (stat
                # caught size 0 / an old mtime, the read then saw the
                # settled content): journaling the STALE key would make
                # the next poll re-process the same file under its
                # settled key — a duplicate batch. A file whose stat
                # CHANGED across the read is dropped and re-examined
                # next poll; a file that VANISHED is delivered as read
                # (read-then-archive producers delete immediately, and
                # the gone file can never be re-examined — dropping it
                # would be silent data loss).
                try:
                    st = os.stat(full)
                    settled = f"{full}:{st.st_mtime_ns}:{st.st_size}"
                except OSError:
                    settled = key     # vanished: the read is final
                if settled != key:
                    frames.pop()      # drop the unverified read
                    continue
                keys.append(key)
            # drop stale fail counts (rewritten files get fresh keys every
            # poll; without pruning the dict grows without bound)
            live = {key for _, key in fresh}
            self._fail_counts = {k: v for k, v in self._fail_counts.items()
                                 if k in live and k not in self._quarantined}
            if frames:
                batch = DataFrame.concat(frames) if len(frames) > 1 \
                    else frames[0]
                yield batch
                # journal only AFTER the consumer finished the batch (it
                # asked for the next one): at-least-once on crash, like
                # Spark's checkpointLocation
                self._seen.update(keys)
                self._checkpoint()
                yielded += 1
                last_new = time.monotonic()
                if max_batches is not None and yielded >= max_batches:
                    return
                continue
            # no batch this cycle (nothing new, or every read failed):
            # honor idle_timeout, then wait out the poll interval
            if (idle_timeout is not None
                    and time.monotonic() - last_new > idle_timeout):
                return
            self._stop.wait(self.poll_interval)

    # -- micro-batch engine source protocol ---------------------------------
    # (mmlspark_tpu_torch.streaming.engine.StreamingQuery: plan/read/ack.
    # ``batches()``/``foreach_batch`` above remain the standalone
    # poller surface; the engine drives these instead, with ITS offset
    # log providing crash replay and this source's journal providing
    # the committed cursor.)

    def plan(self, limit_rows: Optional[int] = None) -> Optional[dict]:
        """Claim newly-arrived files as one batch descriptor. This
        source's planning unit is the FILE (row counts are unknowable
        before reading), so the engine's adaptive budget bounds files
        per batch, not rows — its rate adaptation still converges, in
        file units, off the same sink-latency signal. Claimed files
        stay out of later plans until :meth:`ack` journals them (the
        engine replays unacked plans from its own offset log after a
        crash)."""
        fresh = self._scan()
        if limit_rows:
            fresh = fresh[:max(int(limit_rows), 1)]
        if not fresh:
            return None
        self._planned.update(key for _, key in fresh)
        return {"files": [[full, key] for full, key in fresh]}

    def read(self, meta: dict) -> DataFrame:
        """Materialize a planned batch. Deterministic for settled
        files. Failure classes mirror :meth:`batches`: a VANISHED file
        (FileNotFoundError) is skipped for good — its bytes are
        unrecoverable; a TRANSIENT error (NFS blip, EACCES while a
        producer settles) or corrupt content marks the key for
        re-offer — :meth:`ack` will NOT journal it, so a later plan
        retries it, with :attr:`max_read_failures` bounding retries
        before quarantine (one bad file can never wedge the stream OR
        silently lose a healthy one)."""
        from mmlspark_tpu_torch.core.logs import get_logger
        frames = []
        for full, key in meta["files"]:
            try:
                frames.append(read_binary_files(
                    full, inspect_zip=self.inspect_zip,
                    engine=self.engine))
                self._fail_counts.pop(key, None)
            except FileNotFoundError as exc:
                get_logger("io.streaming").warning(
                    "planned file %s vanished before read (%s); its "
                    "rows are lost", full, exc)
            except (OSError, zipfile.BadZipFile, zlib.error) as exc:
                n = self._fail_counts.get(key, 0) + 1
                self._fail_counts[key] = n
                if n >= self.max_read_failures:
                    get_logger("io.streaming").warning(
                        "quarantining %s after %d failed reads: %s",
                        full, n, exc)
                    self._quarantined.add(key)
                    self._fail_counts.pop(key, None)
                else:
                    get_logger("io.streaming").warning(
                        "planned file %s unreadable at read time "
                        "(attempt %d/%d: %s); will re-offer", full, n,
                        self.max_read_failures, exc)
                    self._read_retry.add(key)
        if not frames:
            return DataFrame({})
        return DataFrame.concat(frames) if len(frames) > 1 else frames[0]

    def ack(self, meta: dict) -> None:
        """Journal a committed batch's files (idempotent — the engine
        re-acks committed offsets during recovery). Keys whose read
        failed transiently are released for re-planning instead of
        journaled — journaling an unread file would be silent data
        loss on the first I/O blip."""
        keys = [key for _, key in meta["files"]]
        # quarantined keys stay un-journaled too (in-memory only, like
        # the poller path: a restart retries them)
        self._seen.update(k for k in keys
                          if k not in self._read_retry
                          and k not in self._quarantined)
        self._planned.difference_update(keys)
        self._read_retry.difference_update(keys)
        self._checkpoint()

    def backlog(self) -> int:
        """Unplanned new-file count (the engine's lag gauge)."""
        return len(self._scan())

    def foreach_batch(self, fn: Callable[[DataFrame], None],
                      **kwargs) -> "ForeachBatchHandle":
        """Run :meth:`batches` on a daemon thread, calling ``fn`` per
        frame (the ``writeStream.foreachBatch`` shape).

        An exception from ``fn`` is TERMINAL for the stream, never
        silent: it is logged, counted, and surfaced on the returned
        handle (``handle.state == "failed"``, ``handle.error``) — the
        thread used to die quietly and the stream just stopped with no
        trace. The batch that failed is NOT journaled, so a restarted
        stream re-offers it (at-least-once, like every other batch).
        """
        handle = ForeachBatchHandle(self, fn, kwargs)
        handle.start()
        return handle


class ForeachBatchHandle(threading.Thread):
    """The ``foreach_batch`` daemon thread plus its terminal state
    (still a :class:`threading.Thread`, so existing ``join()`` callers
    keep working). ``state``: ``running`` -> ``terminated`` (source
    stopped / limits reached) | ``failed`` (``fn`` raised — see
    ``error``)."""

    def __init__(self, source: FileStreamSource, fn, kwargs):
        super().__init__(daemon=True, name="file-stream-foreach")
        self._source = source
        self._fn = fn
        self._kwargs = kwargs
        self.state = "running"
        self.error: "Optional[BaseException]" = None
        self.n_batches = 0
        self.n_errors = 0

    def status(self) -> dict:
        return {"state": self.state,
                "error": (f"{type(self.error).__name__}: {self.error}"
                          if self.error is not None else None),
                "n_batches": self.n_batches,
                "n_errors": self.n_errors}

    def run(self) -> None:
        from mmlspark_tpu_torch.core.logs import get_logger
        try:
            for batch in self._source.batches(**self._kwargs):
                try:
                    self._fn(batch)
                except Exception as e:  # noqa: BLE001 — the consumer
                    # failed: count + log + terminal state, never a
                    # silently-dead daemon thread
                    self.n_errors += 1
                    self.error = e
                    self.state = "failed"
                    get_logger("io.streaming").error(
                        "foreach_batch consumer raised on batch %d; "
                        "stream stopped (batch not journaled — a "
                        "restart re-offers it): %s", self.n_batches + 1,
                        e, exc_info=True)
                    return
                self.n_batches += 1
            self.state = "terminated"
        except Exception as e:  # noqa: BLE001 — a source-side failure
            self.n_errors += 1
            self.error = e
            self.state = "failed"
            get_logger("io.streaming").error(
                "file stream poller failed: %s", e, exc_info=True)
