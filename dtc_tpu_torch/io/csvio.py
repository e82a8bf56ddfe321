"""Column CSV writer and reader, and the per-timestep checkpoint writer.

A copy of ``write_columns``, ``read_columns`` and ``RealtimeCSVWriter``
from ``dtc_tpu/io/csvio.py``. The bytes written are the reference's: a
header of column names, then one row per index with floats as
``repr(float(v))`` and integers as ``str(int(v))`` (``tests/test_torch_io.py``
compares them).
"""

from __future__ import annotations

import os
from typing import Mapping, Sequence

import numpy as np


def write_columns(path: str, columns: Mapping[str, Sequence]):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    keys = list(columns)
    arrs = [np.asarray(columns[k]) for k in keys]
    n = len(arrs[0])
    for k, a in zip(keys, arrs):
        if len(a) != n:
            raise ValueError(f"column {k!r} length {len(a)} != {n}")
    with open(path, "w") as f:
        f.write(",".join(keys) + "\n")
        for i in range(n):
            vals = []
            for a in arrs:
                v = a[i]
                if isinstance(v, (np.floating, float)):
                    vals.append(repr(float(v)))
                elif isinstance(v, (np.integer, int)):
                    vals.append(str(int(v)))
                else:
                    vals.append(str(v))
            f.write(",".join(vals) + "\n")


def read_columns(path: str) -> dict:
    with open(path) as f:
        lines = [ln.rstrip("\n") for ln in f if ln.strip()]
    keys = lines[0].split(",")
    cols = {k: [] for k in keys}
    for ln in lines[1:]:
        for k, v in zip(keys, ln.split(",")):
            try:
                cols[k].append(float(v))
            except ValueError:
                cols[k].append(v)
    return {k: np.asarray(v) for k, v in cols.items()}


class RealtimeCSVWriter:
    """Append-per-timestep checkpoint writer: header on first write, one
    flushed row per completed timestep, so an interrupted sweep keeps its
    finished rows and can resume (see resume_index)."""

    def __init__(self, path: str, fieldnames: Sequence[str], *,
                 resume: bool = True):
        """resume=True appends after rows already on disk (the caller skips
        the first resume_index() rows); resume=False truncates — for loops
        that always recompute from t=0 (e.g. the adaptive controller)."""
        self.path = path
        self.fieldnames = list(fieldnames)
        self.resume = resume
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._f = None

    def resume_index(self) -> int:
        """Number of data rows already on disk (0 if absent/corrupt header)."""
        if not os.path.exists(self.path):
            return 0
        with open(self.path) as f:
            lines = [ln.rstrip("\n") for ln in f if ln.strip()]
        if not lines or lines[0].split(",") != self.fieldnames:
            return 0
        return len(lines) - 1

    def _open(self, append: bool):
        self._f = open(self.path, "a" if append else "w")
        if not append:
            self._f.write(",".join(self.fieldnames) + "\n")
            self._f.flush()

    def write_row(self, row: Mapping):
        if self._f is None:
            self._open(append=self.resume and self.resume_index() > 0)
        self._f.write(",".join(
            repr(float(row[k])) if isinstance(row[k], (float, np.floating))
            else str(row[k]) for k in self.fieldnames) + "\n")
        self._f.flush()

    def close(self):
        if self._f is not None:
            self._f.close()
            self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
