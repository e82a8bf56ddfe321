"""Column CSV writer and reader.

A copy of ``write_columns`` and ``read_columns`` from
``dtc_tpu/io/csvio.py``. The bytes written are the reference's: a header of
column names, then one row per index with floats as ``repr(float(v))`` and
integers as ``str(int(v))`` (``tests/test_torch_io.py`` compares them).
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
