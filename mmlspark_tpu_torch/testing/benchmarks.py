"""Committed-CSV quality-regression gates.

The port's copy of ``mmlspark_tpu/testing/benchmarks.py`` (stdlib only,
no JAX in it).

Parity: `core/test/benchmarks/src/main/scala/Benchmarks.scala:35-113` —
metric values are compared against a committed
``benchmarks_<name>.csv`` within per-entry precision; on drift the
harness writes ``new_benchmarks_<name>.csv`` next to it (so an accepted
change is a one-file copy) and raises with the full delta list.

CSV format (one header line)::

    name,value,precision
    breast_cancer_gbdt_auc,0.9871,0.02
"""

from __future__ import annotations

import csv
import os
from typing import Dict, List, Tuple


class Benchmarks:
    """Collects metric values and verifies them against the committed CSV."""

    def __init__(self, resource_dir: str, name: str):
        self.resource_dir = resource_dir
        self.name = name
        self.entries: List[Tuple[str, float]] = []

    @property
    def csv_path(self) -> str:
        return os.path.join(self.resource_dir, f"benchmarks_{self.name}.csv")

    @property
    def new_csv_path(self) -> str:
        return os.path.join(self.resource_dir,
                            f"new_benchmarks_{self.name}.csv")

    def add(self, entry: str, value: float) -> None:
        self.entries.append((entry, float(value)))

    def _committed(self) -> Dict[str, Tuple[float, float]]:
        out: Dict[str, Tuple[float, float]] = {}
        with open(self.csv_path, newline="") as f:
            for row in csv.DictReader(f):
                out[row["name"]] = (float(row["value"]),
                                    float(row["precision"]))
        return out

    def _write_new(self, precisions: Dict[str, float]) -> None:
        with open(self.new_csv_path, "w", newline="") as f:
            # csv defaults to \r\n; committed fixtures stay LF like the
            # rest of the repo
            w = csv.writer(f, lineterminator="\n")
            w.writerow(["name", "value", "precision"])
            for entry, value in self.entries:
                # entries without a committed precision get a
                # scale-relative default (5%), not an absolute one — a
                # copied-over gate must tolerate normal numeric jitter
                # on any metric scale
                default = max(abs(value) * 0.05, 1e-3)
                w.writerow([entry, f"{value:.6g}",
                            f"{precisions.get(entry, default):.4g}"])

    def verify(self) -> None:
        """Raise AssertionError on drift; write ``new_benchmarks_*.csv``.

        Missing committed file => first run: the new CSV is written and
        an error tells the author to commit it (the reference behaves
        the same for a fresh benchmark suite).
        """
        if not os.path.exists(self.csv_path):
            self._write_new({})
            raise AssertionError(
                f"no committed benchmark file {self.csv_path}; wrote "
                f"{self.new_csv_path} — review and commit it as the gate")
        committed = self._committed()
        precisions = {k: v[1] for k, v in committed.items()}
        failures = []
        seen = set()
        for entry, value in self.entries:
            seen.add(entry)
            if entry not in committed:
                failures.append(f"{entry}: no committed value "
                                f"(measured {value:.6g})")
                continue
            expect, prec = committed[entry]
            if abs(value - expect) > prec:
                failures.append(f"{entry}: {value:.6g} vs committed "
                                f"{expect:.6g} (precision {prec})")
        for entry in committed:
            if entry not in seen:
                failures.append(f"{entry}: committed but not measured")
        if failures:
            self._write_new(precisions)
            raise AssertionError(
                "benchmark drift (new values written to "
                f"{self.new_csv_path}):\n  " + "\n  ".join(failures))
