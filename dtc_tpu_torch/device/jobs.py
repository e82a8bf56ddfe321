"""Hardware job-record post-processing: merge, decode, count.

A copy of ``dtc_tpu/device/jobs.py`` (pure Python): merge the raw job
records of a hardware run keeping only completed jobs, sort them by
creation stamp, group a fixed number of jobs per disorder instance, decode
the per-shot measurement bit arrays under keys like "c_1_0_0" into counts,
and reduce counts to <Z>.

job record: {"id": str, "created": iso-or-sortable str, "status": str,
             "measurements": {key: [[bit,...] per shot] }}
"""

from __future__ import annotations

import json
import os
from typing import Iterable, Sequence


def counts_to_z_expectation(counts: dict, num_qubits: int) -> list[float]:
    """(p0 - p1)/shots per qubit from a bitstring->count histogram.

    Bitstrings are little-endian (qubit 0 = rightmost character), matching
    the reference's reversal (fast.py:101).

    An empty histogram (a 'completed' job record whose runner returned no
    shots) yields NaN per qubit instead of ZeroDivisionError: campaign
    ingest fills unmeasured points with NaN, so a shotless record reads
    as not-yet-measured and the resumable-ingest contract survives.
    """
    total = sum(counts.values())
    if total == 0:
        return [float("nan")] * num_qubits
    out = []
    for q in range(num_qubits):
        diff = 0
        for bits, c in counts.items():
            bit = bits[::-1][q]
            diff += c if bit == "0" else -c
        out.append(diff / total)
    return out


def measurement_bits_to_counts(shots_bits: Sequence[Sequence[int]]) -> dict:
    """Per-shot bit arrays -> {bitstring: count} (first array element =
    qubit 0 -> rightmost bitstring character)."""
    counts: dict[str, int] = {}
    for shot in shots_bits:
        key = "".join(str(int(b)) for b in reversed(shot))
        counts[key] = counts.get(key, 0) + 1
    return counts


def is_completed(rec: dict) -> bool:
    """Two conventions: a 'status' field (== completed/done), or a
    'completed' timestamp field (non-null) — merge.py:41 / fix.py:47."""
    if "status" in rec:
        return rec["status"] in ("completed", "DONE", "done")
    return rec.get("completed") not in (None, "None", "")


def merge_job_records(records: Iterable[dict], *, completed_only: bool = True,
                      sort_key: str = "created") -> list[dict]:
    out = [r for r in records if (not completed_only) or is_completed(r)]
    return sorted(out, key=lambda r: r.get(sort_key, ""))


def load_job_files(paths: Iterable[str]) -> list[dict]:
    recs = []
    for p in paths:
        with open(p) as f:
            data = json.load(f)
        recs.extend(data if isinstance(data, list) else [data])
    return recs


def merge_job_dir(folder: str, out_path: str | None = None,
                  completed_only: bool = True) -> list[dict]:
    paths = sorted(
        os.path.join(folder, f) for f in os.listdir(folder) if f.endswith(".json"))
    merged = merge_job_records(load_job_files(paths), completed_only=completed_only)
    if out_path:
        with open(out_path, "w") as f:
            json.dump(merged, f)
    return merged


def decode_jobs_to_expectations(
    records: Sequence[dict], *, jobs_per_instance: int,
    measurement_key: str = "c_1_0_0", qubit: int = 0,
) -> list[list[float]]:
    """Group ordered job records into instances of `jobs_per_instance`
    consecutive time points; decode each to <Z_qubit>.

    Mirrors autocorr-iqm-data-fix.py:42-60 (20 jobs = one instance's
    t-series). Incomplete trailing groups are kept (resumable decoding).
    """
    series: list[list[float]] = []
    for i in range(0, len(records), jobs_per_instance):
        group = records[i : i + jobs_per_instance]
        vals = []
        for rec in group:
            bits = rec["measurements"][measurement_key]
            counts = measurement_bits_to_counts(bits)
            nq = len(bits[0]) if bits else 1
            vals.append(counts_to_z_expectation(counts, nq)[qubit])
        series.append(vals)
    return series
