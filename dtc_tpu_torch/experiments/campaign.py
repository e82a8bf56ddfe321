"""The hardware campaign: export -> execute -> ingest -> CSV, resumable.

Port of ``dtc_tpu/experiments/campaign.py`` (``run_hardware_campaign``,
``_export_phase``, ``_simulate_phase``, ``_decode_kind``), with the
reference's CSV schema and ``campaign_`` file name:

  run_hardware_campaign(cfg, ...)
    1. EXPORT   write per-(instance, t) OpenQASM jobs + manifest for the
                forward and echo sweeps (idempotent: skipped when the
                manifest exists)
    2. EXECUTE  an external runner executes the QASM on a QPU and drops
                raw job-record JSONs into <results_dir>/{forward,echo}.
                With simulate=True the port's trajectory engines play that
                role on ``device`` (the kernels' forward and echo sweeps),
                sampling ancilla counts per job and writing
                reference-shaped records ({"measurements": {"c_1_0_0":
                bitarrays}, "status": ...}).
    3. INGEST   merge completed records (completed-only filter, timestamp
                sort), decode to per-(instance, t) expectations, and append
                any newly completed time rows to the reference-schema CSV
                (time, av_autocorr, av_autocorr_echo, sqrt_av_autocorr_echo)
                through the realtime writer; echo results that land after
                a row was appended back-fill its NaN echo columns by
                rewriting the CSV from the decoded arrays.

Every phase is driven by what is on disk, so a campaign survives partial
batches, interrupted ingests, and incremental hardware execution. Each
phase's seconds are logged (``phase export``, ``simulate``, ``ingest``;
the sweeps ``forward`` and ``echo``).
"""

from __future__ import annotations

import json
import os
import warnings

import numpy as np

from dtc_tpu_torch.device.backends import QasmExportBackend
from dtc_tpu_torch.device.jobs import (
    counts_to_z_expectation,
    measurement_bits_to_counts,
    merge_job_dir,
)
from dtc_tpu_torch.experiments.engine import (
    build_context,
    echo_sweep,
    forward_sweep,
)
from dtc_tpu_torch.io import naming
from dtc_tpu_torch.io.csvio import RealtimeCSVWriter, read_columns, write_columns
from dtc_tpu_torch.io.disorder import get_disorder
from dtc_tpu_torch.utils.profiling import phase_timer

CSV_FIELDS = ("time", "av_autocorr", "av_autocorr_echo",
              "sqrt_av_autocorr_echo")


def _export_phase(cfg, hs, phis, job_dir: str, shots: int) -> dict:
    """Write forward/echo QASM jobs + manifests (skip kinds already there)."""
    status = {}
    for kind, echo in (("forward", False), ("echo", True)):
        kdir = os.path.join(job_dir, kind)
        manifest = os.path.join(kdir, "manifest.json")
        if os.path.exists(manifest):
            status[kind] = "existing"
            continue
        backend = QasmExportBackend(cfg, kdir, shots=shots)
        paths = backend.submit_sweep(hs, phis, echo=echo)
        status[kind] = f"exported {len(paths)} jobs"
    return status


def _simulate_phase(cfg, hs, phis, job_dir: str, results_dir: str,
                    shots: int, seed: int, fail_fraction: float = 0.0, *,
                    device="cuda", uniforms=None) -> dict:
    """Execute the manifests on the port's engines, writing raw job records.

    Plays the external hardware runner: the forward and echo sweeps run on
    ``device`` (``uniforms``: the optional (forward, echo) blocks of
    ``run_autocorr``), then per manifest job ``shots`` single-bit ancilla
    measurements are sampled from the engine's A value and written as one
    reference-shaped record JSON. fail_fraction marks a deterministic
    subset of jobs incomplete (status "queued") to exercise partial-batch
    recovery.
    """
    if cfg.use_fakebackend:
        raise NotImplementedError(
            "use_fakebackend=1 (device noise) is refused by the simulated "
            "campaign: the reference's runs depolarizing noise under the "
            "flag (ROADMAP.md queue 3)")
    sched, params, noise = build_context(cfg, hs, phis, device=device)
    u_fwd, u_echo = uniforms if uniforms is not None else (None, None)
    with phase_timer("forward"):
        forward = forward_sweep(cfg, sched, params, noise, uniforms=u_fwd)
    with phase_timer("echo"):
        echo = echo_sweep(cfg, sched, params, noise, uniforms=u_echo)
    values = {"forward": forward, "echo": echo}
    rng = np.random.default_rng(seed)
    written = {}
    for kind in ("forward", "echo"):
        kdir = os.path.join(results_dir, kind)
        os.makedirs(kdir, exist_ok=True)
        with open(os.path.join(job_dir, kind, "manifest.json")) as f:
            manifest = json.load(f)
        n = 0
        for j, job in enumerate(manifest["jobs"]):
            i, t = job["instance"], job["t"]
            a = float(values[kind][i, t])
            p0 = float(np.clip((1.0 + a) / 2.0, 0.0, 1.0))
            n0 = int(rng.binomial(shots, p0))
            bits = [[0]] * n0 + [[1]] * (shots - n0)
            failed = fail_fraction > 0 and (j % max(1, int(1 / max(
                fail_fraction, 1e-9)))) == 0
            rec = {
                "job": job["qasm"],
                "instance": i,
                "t": t,
                "created": f"{i:05d}_{t:05d}",
                "status": "queued" if failed else "completed",
                "measurements": {"c_1_0_0": bits},
            }
            with open(os.path.join(
                    kdir, job["qasm"].replace(".qasm", ".json")), "w") as f:
                json.dump(rec, f)
            n += 1
        written[kind] = n
    return written


def _decode_kind(cfg, job_dir: str, results_dir: str, kind: str,
                 measurement_key: str) -> np.ndarray:
    """(inst, T) decoded expectations with NaN in not-yet-completed slots.

    Slot-aware partial recovery: records carrying instance/t metadata (ours,
    and any runner that echoes the manifest fields back) land in their exact
    slot. Bare reference-style records fall back to the timestamp-sorted
    positional grouping of autocorr-iqm-data-fix.py:42-60 — but positional
    assignment is only sound when the set is COMPLETE (a missing middle job
    would silently shift every later record into the wrong (instance, t)
    slot), so an incomplete bare batch is skipped with a warning instead of
    decoded wrong; incremental ingest needs the metadata records.
    """
    out = np.full((cfg.inst, cfg.tf), np.nan)
    kdir = os.path.join(results_dir, kind)
    if not os.path.isdir(kdir):
        return out
    records = merge_job_dir(kdir, completed_only=True)
    positional = [r for r in records if "instance" not in r or "t" not in r]
    for rec in records:
        if "instance" in rec and "t" in rec:
            bits = rec["measurements"][measurement_key]
            counts = measurement_bits_to_counts(bits)
            nq = len(bits[0]) if bits else 1
            out[rec["instance"], rec["t"]] = counts_to_z_expectation(
                counts, nq)[0]
    if positional and len(positional) != cfg.inst * cfg.tf:
        warnings.warn(
            f"{kind}: {len(positional)} bare records without instance/t "
            f"metadata don't form a complete {cfg.inst}x{cfg.tf} batch — "
            "positional slot inference would misalign on the gaps, so they "
            "are skipped; re-ingest when the batch completes, or use a "
            "runner that echoes the manifest's instance/t fields",
            stacklevel=2)
        positional = []
    for k, rec in enumerate(positional):
        i, t = divmod(k, cfg.tf)
        bits = rec["measurements"][measurement_key]
        counts = measurement_bits_to_counts(bits)
        nq = len(bits[0]) if bits else 1
        out[i, t] = counts_to_z_expectation(counts, nq)[0]
    return out


def run_hardware_campaign(cfg, hs=None, phis=None, *, job_dir,
                          device="cuda", results_dir=None, out_dir=None,
                          shots: int = 1024, simulate: bool = False,
                          simulate_fail_fraction=0.0,
                          measurement_key: str = "c_1_0_0",
                          disorder_dir=None, uniforms=None) -> dict:
    """One command for the full hardware loop; every phase resumable.

    Returns a status dict with per-phase results, the decoded arrays, and
    the CSV path. Call repeatedly as results land — newly completed time
    rows are appended, and late-landing echo results back-fill the NaN
    echo columns of rows already on disk. ``device`` and ``uniforms`` serve
    the simulated runner only (``simulate=True``).
    """
    if hs is None or phis is None:
        hs, phis = get_disorder(cfg, disorder_dir)
    results_dir = results_dir or os.path.join(job_dir, "results")

    with phase_timer("export"):
        export_status = _export_phase(cfg, hs, phis, job_dir, shots)
    sim_status = None
    if simulate:
        with phase_timer("simulate"):
            sim_status = _simulate_phase(
                cfg, hs, phis, job_dir, results_dir, shots, seed=cfg.seed,
                fail_fraction=simulate_fail_fraction, device=device,
                uniforms=uniforms)

    with phase_timer("ingest"):
        return _ingest(cfg, job_dir, results_dir, out_dir, measurement_key,
                       export_status, sim_status)


def _ingest(cfg, job_dir, results_dir, out_dir, measurement_key,
            export_status, sim_status) -> dict:
    """Decode both kinds and bring the CSV up to date; the status dict."""
    fwd = _decode_kind(cfg, job_dir, results_dir, "forward", measurement_key)
    ech = _decode_kind(cfg, job_dir, results_dir, "echo", measurement_key)

    # realtime CSV: a time row is appendable once every instance's forward
    # job for that t has completed (echo columns NaN-tolerant: the reference
    # runs forward and echo as separate campaigns)
    folder = out_dir or naming.autocorr_folder_name(cfg)
    csv_path = os.path.join(
        folder, "campaign_" + naming.autocorr_csv_name(cfg))
    writer = RealtimeCSVWriter(csv_path, CSV_FIELDS)
    start = writer.resume_index()

    def row_for(t: int) -> dict:
        e = float(np.mean(ech[:, t])) if not np.isnan(ech[:, t]).any() \
            else float("nan")
        return {
            "time": t,
            "av_autocorr": float(np.mean(fwd[:, t])),
            "av_autocorr_echo": e,
            "sqrt_av_autocorr_echo": float(np.sqrt(e)) if e == e and e >= 0
            else float("nan"),
        }

    # Rows beyond those persisted: strictly sequential realtime appends.
    # Rows already on disk are NEVER gated on re-decoding — a forward
    # record that later fails to decode must not block (or truncate away)
    # work that was already checkpointed.
    new_rows = []
    for t in range(start, cfg.tf):
        if np.isnan(fwd[:, t]).any():
            break  # realtime semantics: strictly sequential time rows
        new_rows.append(row_for(t))

    # Echo back-fill: the realtime writer is append-only, so echo results
    # that land AFTER a time row was appended (the reference flow — forward
    # and echo are separate campaigns) would otherwise stay NaN in the
    # compatibility-contract CSV forever. When a previously NaN echo column
    # now has a decoded value, rewrite the file from the decoded arrays —
    # but only when every persisted row can be rebuilt exactly (all forward
    # values for t < start decoded); otherwise keep pure append semantics
    # and the persisted rows stay untouched.
    backfill = False
    if start > 0 and not np.isnan(fwd[:, :start]).any():
        old_echo = np.asarray(
            read_columns(csv_path).get("av_autocorr_echo", []), float)
        backfill = any(
            np.isnan(old_echo[t]) and not np.isnan(ech[:, t]).any()
            for t in range(min(start, len(old_echo))))
    rows_written = len(new_rows)
    if backfill:
        writer.close()
        all_rows = [row_for(t) for t in range(start)] + new_rows
        write_columns(csv_path,
                      {k: [r[k] for r in all_rows] for k in CSV_FIELDS})
    else:
        for r in new_rows:
            writer.write_row(r)
        writer.close()

    n_fwd = int(np.sum(~np.isnan(fwd)))
    n_ech = int(np.sum(~np.isnan(ech)))
    total = cfg.inst * cfg.tf
    return {
        "export": export_status,
        "simulate": sim_status,
        "completed": {"forward": n_fwd, "echo": n_ech, "total_per_kind": total},
        "rows_written": rows_written,
        "rows_on_disk": start + rows_written,
        "forward": fwd,
        "echo": ech,
        "csv_path": csv_path,
    }
