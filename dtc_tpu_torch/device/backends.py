"""Execution backends: the port's engines, or QASM jobs for a hardware
runner.

Port of ``dtc_tpu/device/backends.py``:
- ``SimulatorBackend`` runs the autocorrelator sweep on the port's engines
  (``experiments/autocorr.py::run_autocorr``) on ``device``, default cuda;
- ``QasmExportBackend`` "submits" a sweep by writing one OpenQASM 2.0
  program and a job manifest per (instance, t), the same files as the
  reference's, and ``ingest_results`` feeds raw job-record JSONs back
  through the decode pipeline (``device/jobs.py``) to the expectation
  series.
"""

from __future__ import annotations

import json
import os

import numpy as np

from dtc_tpu_torch.device.jobs import decode_jobs_to_expectations, merge_job_dir
from dtc_tpu_torch.device.qasm import circuit_to_qasm
from dtc_tpu_torch.device.transpile import gate_counts
from dtc_tpu_torch.models.drives import build_kick_schedule


class SimulatorBackend:
    """Counts/expectation execution on the port's trajectory engines."""

    name = "dtc_tpu_simulator"

    def __init__(self, cfg, *, device="cuda"):
        self.cfg = cfg
        self.device = device

    def run_autocorr(self, hs, phis, **kw):
        from dtc_tpu_torch.experiments.autocorr import run_autocorr

        kw.setdefault("device", self.device)
        return run_autocorr(self.cfg, hs, phis, write=False, **kw)


class QasmExportBackend:
    """Write per-(instance, t) QASM jobs + manifest; decode results later."""

    name = "qasm_export"

    def __init__(self, cfg, job_dir: str, *, shots: int = 1024):
        self.cfg = cfg
        self.job_dir = job_dir
        self.shots = shots
        os.makedirs(job_dir, exist_ok=True)

    def submit_sweep(self, hs, phis, *, echo: bool = False) -> list[str]:
        """One QASM file per (instance, t) in submission order; manifest.json
        records the order so decode can group jobs_per_instance = tf."""
        cfg = self.cfg
        sched = build_kick_schedule(
            cfg.polarization, cfg.g, max(cfg.tf, 1),
            circular_frequency=cfg.circular_frequency,
            xy_cycle_period=cfg.xy_cycle_period)
        paths = []
        manifest = {"shots": self.shots, "echo": echo,
                    "jobs_per_instance": cfg.tf, "jobs": []}
        for i in range(cfg.inst):
            for t in range(cfg.tf):
                name = f"job_inst{i}_t{t}{'_echo' if echo else ''}.qasm"
                path = os.path.join(self.job_dir, name)
                with open(path, "w") as f:
                    f.write(circuit_to_qasm(
                        cfg.L, hs[i], phis[i], t, sched, echo=echo,
                        initial_state=cfg.initial_state,
                        probe_qubit=cfg.probe_qubit))
                manifest["jobs"].append(
                    {"instance": i, "t": t, "qasm": name,
                     "gate_counts": gate_counts(
                         cfg.L, t, echo=echo, polarization=cfg.polarization)})
                paths.append(path)
        with open(os.path.join(self.job_dir, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=1)
        return paths

    def ingest_results(self, results_dir: str, *, measurement_key="c_1_0_0",
                       completed_only: bool = True) -> np.ndarray:
        """Raw job-record JSONs -> (inst, T) expectation series through the
        merge/decode pipeline."""
        with open(os.path.join(self.job_dir, "manifest.json")) as f:
            manifest = json.load(f)
        records = merge_job_dir(results_dir, completed_only=completed_only)
        series = decode_jobs_to_expectations(
            records, jobs_per_instance=manifest["jobs_per_instance"],
            measurement_key=measurement_key)
        return np.asarray(series)
