"""Energy sweep experiments.

Port of ``dtc_tpu/experiments/energy.py`` (``apply_estimator_noise``,
``_energy_single_noise``, ``run_energy``, ``run_ham_comparison``,
``run_per_qubit_z``, ``_fmt``): E(t)/L per noise probability (CSV
``time, energy_p_{p}``), the component Hamiltonians full / z_only / zz_only
/ x_only / z_zz (CSV ``time, energy_{component}``) and per-qubit <Z_q(t)>
(CSV ``time, z_q{q}``), with the reference's columns, folder and file names
and estimator-noise seeds.

Dispatch by shape, the reference's own split with the port's tiers:
- complex64 at 14 <= L <= 23 with T*K <= ``MAX_STEPS`` rows: the
  observables entry (``ops/observables.py``: kernel K5 for CUDA tensors,
  its plain version for CPU tensors), logged ``engine=obs``;
- everything else (complex128, other L, longer schedules): the torch eager
  engine (``core/evolve.py``) on the requested device, ``engine=eager``.
The reference's TPU engine switch (``DTC_TPU_ENERGY_ENGINE``) and its TPU
guard (``_guard_energy_xla``) are not ported.

Noise: one block of f32 uniforms (inst, n_traj, T*K, L), laid out as the
reference draws them per trajectory, injected (``uniforms=``) or drawn once
per run from a ``torch.Generator`` seeded with cfg.seed, and reused for
every noise level and component, as the reference reuses its keys.

Unlike the reference: ``use_fakebackend=1`` raises (the reference silently
computes depolarizing energies); the checkpoint key names the engine and
the dtype, so a journal of another engine or dtype is recomputed; and
``cfg.dtype`` is honoured (complex128 never runs on the f32 kernel).
"""

from __future__ import annotations

import hashlib
import logging
import os

import numpy as np
import torch

from dtc_tpu_torch.core.evolve import evolve_observables, make_floquet_params
from dtc_tpu_torch.core.sigma_evolve import DTYPES
from dtc_tpu_torch.core.statevector import initial_statevector
from dtc_tpu_torch.experiments.engine import (
    _sweep_uniforms,
    build_context,
    traj_chunks,
)
from dtc_tpu_torch.io import csvio, naming
from dtc_tpu_torch.io.disorder import get_disorder
from dtc_tpu_torch.models.hamiltonian import hamiltonian_terms
from dtc_tpu_torch.ops import observables
from dtc_tpu_torch.ops.diag import zz_z_diag_energy
from dtc_tpu_torch.ops.params_general import general_forward_rows
from dtc_tpu_torch.ops.routes import launch_states
from dtc_tpu_torch.utils.checkpoints import SweepJournal
from dtc_tpu_torch.utils.profiling import phase_timer, span
from dtc_tpu_torch.utils.validation import guard

log = logging.getLogger("dtc_tpu_torch")

DEFAULT_NPROBS = (0.0, 0.001, 0.01, 0.1)


def apply_estimator_noise(values: np.ndarray, shots: int,
                          seed: int = 0) -> np.ndarray:
    """Estimator shot-precision emulation: E -> E + N(0, 1/sqrt(shots)).

    The reference's hardware energy runners evaluate <H> with
    ``BackendEstimatorV2(..., precision=1/sqrt(1024))``, so every recorded
    energy carries gaussian sampling noise of that standard error.
    shots=0 returns the exact expectations unchanged."""
    if not shots:
        return values
    rng = np.random.default_rng(seed)
    return values + rng.normal(0.0, 1.0 / np.sqrt(shots), np.shape(values))


def _refuse_fakebackend(cfg) -> None:
    if cfg.use_fakebackend:
        raise NotImplementedError(
            "use_fakebackend=1 (device noise) is refused by the energy"
            " studies: the reference's have no device-noise path and run"
            " depolarizing noise under the flag (ROADMAP.md queue 3)")


def energy_engine(cfg, K: int) -> str:
    """'obs' (the observables entry: K5 or its plain version) or 'eager'."""
    if (cfg.dtype == "complex64"
            and observables.MIN_L <= cfg.L <= observables.MAX_L
            and cfg.tf * K <= observables.MAX_STEPS):
        return "obs"
    return "eager"


def _sweep(cfg, hs, phis, device, uniforms):
    """(schedule, (hs, phis), uniform block) of one run."""
    sched, params, _ = build_context(cfg, hs, phis, device=device)
    shape = (cfg.inst, cfg.n_trajectories, cfg.tf * sched.K, cfg.L)
    u = _sweep_uniforms(uniforms, shape, cfg.seed, params[0].device)
    return sched, params, u


def obs_chunk(n_traj: int, L: int, inst: int) -> int:
    """Trajectories per observables launch, which holds inst x chunk
    states: within ``launch_states``."""
    return max(1, min(n_traj, launch_states(L) // inst))


def _obs_batch(cfg, sched, hs, phis, th, tph, x_coeff, u, c, p):
    """(inst, c, T) energies and (inst, c, T, L) <Z_q> on the obs route."""
    L, T, K = cfg.L, cfg.tf, sched.K
    rows = general_forward_rows(u, hs[:, None], phis[:, None], sched.angles,
                                L=L, T=T, K=K, p=p, batch=(cfg.inst, c))
    e_diag, x_sum, zs = observables.observables_forward_batch(
        rows, observables.energy_row(th, tph, L)[:, None], L=L, T=T,
        initial_state=cfg.initial_state, with_x=x_coeff != 0.0)
    return e_diag.double() + x_coeff * x_sum.double(), zs


def _eager_batch(cfg, sched, hs, phis, th, tph, x_coeff, u, c, p):
    """The same through the eager engine, one instance at a time."""
    L, T, K = cfg.L, cfg.tf, sched.K
    dtype = DTYPES[cfg.dtype]
    real = torch.float64 if dtype == torch.complex128 else torch.float32
    psi0 = initial_statevector(L, cfg.initial_state, dtype=dtype,
                               device=hs.device).expand(c, -1)
    out = [evolve_observables(
        psi0, sched.angles, make_floquet_params(hs[i], phis[i], L,
                                                dtype=dtype),
        zz_z_diag_energy(th[i], tph[i], L, dtype=real), x_coeff,
        u[i] if u is not None else None, L=L, T=T, K=K, p=p,
        with_x=x_coeff != 0.0) for i in range(cfg.inst)]
    return (torch.stack([e for e, _ in out]),
            torch.stack([z for _, z in out]))


def _energy_single_noise(cfg, sweep, p: float, component: str = "full"):
    """(inst, T) energies and (inst, T, L) per-qubit Z, averaged over the
    trajectories (one at p == 0)."""
    sched, (hs, phis), u_all = sweep
    L, T = cfg.L, cfg.tf
    with span("dtc.feed.energy_terms"):
        terms = [hamiltonian_terms(L, cfg.g, hs[i], phis[i], component)
                 for i in range(cfg.inst)]
        th = torch.stack([t.hs for t in terms])
        tph = torch.stack([t.phis for t in terms])
    x_coeff = terms[0].x_coeff
    engine = energy_engine(cfg, sched.K)
    log.info("energy_sweep: engine=%s pol=%s L=%d T=%d p=%s component=%s",
             engine, cfg.polarization, L, T, p, component)
    batch = _obs_batch if engine == "obs" else _eager_batch
    n_traj = cfg.n_trajectories if p > 0 else 1
    if engine == "obs":
        chunk = obs_chunk(n_traj, L, cfg.inst)
    else:
        chunk = traj_chunks(n_traj, L, extra_factor=4 * cfg.inst)
    acc_e = np.zeros((cfg.inst, T))
    acc_z = np.zeros((cfg.inst, T, L))
    done = 0
    while done < n_traj:
        with span("dtc.sweep.energy_batch"):
            c = min(chunk, n_traj - done)
            u = u_all[:, done:done + c] if p > 0 else None
            e, zs = batch(cfg, sched, hs, phis, th, tph, x_coeff, u, c, p)
            acc_e += guard("energy_batch", e.sum(dim=1).cpu().numpy())
            acc_z += guard("perqubit_z_batch", zs.sum(dim=1).cpu().numpy(),
                           bound=float(c))
        done += c
    return acc_e / n_traj, acc_z / n_traj


@span("dtc.driver.energy")
def run_energy(cfg, hs=None, phis=None, *, nprobs=DEFAULT_NPROBS,
               component="full", device="cuda", out_dir=None,
               disorder_dir=None, write=True, per_qubit_norm=True,
               checkpoint_path=None, uniforms=None) -> dict:
    """E(t)/L per noise probability on ``device``; CSV
    ``time, energy_p_{p}``.

    checkpoint_path: crash-safe journal; each completed noise level is
    stored and skipped on resume. Its key is the run's identity (config,
    a digest of the disorder, engine and dtype). uniforms: optional
    (inst, n_traj, T*K, L) f32 block."""
    _refuse_fakebackend(cfg)
    if hs is None or phis is None:
        hs, phis = get_disorder(cfg, disorder_dir)
    sweep = _sweep(cfg, hs, phis, device, uniforms)
    journal = SweepJournal(checkpoint_path) if checkpoint_path else None
    dig = hashlib.sha1(
        np.ascontiguousarray(np.asarray(hs, dtype=np.float64)).tobytes()
        + np.ascontiguousarray(np.asarray(phis, dtype=np.float64)).tobytes()
    ).hexdigest()[:10]
    ident = (f"L{cfg.L}_inst{cfg.inst}_g{cfg.g}_tf{cfg.tf}"
             f"_traj{cfg.n_trajectories}_pol{cfg.polarization}"
             f"_seed{cfg.seed}_init{cfg.initial_state}_d{dig}"
             f"_engine{energy_engine(cfg, sweep[0].K)}_{cfg.dtype}")
    data = {"time": np.arange(cfg.tf)}
    z_data = {}
    for p in nprobs:
        jkey = f"energy_{component}_p{p}_{ident}"
        if journal is not None and jkey in journal:
            e = journal.get(jkey)
            zs = journal.get(jkey + "_z")
        else:
            with phase_timer(f"energy p={p}"):
                e, zs = _energy_single_noise(cfg, sweep, float(p), component)
            if journal is not None:
                journal.put(jkey, e)
                journal.put(jkey + "_z", zs)
        # per-(instance, t) estimator sampling noise, like one estimator job
        # per circuit in the reference's hardware loop
        e = apply_estimator_noise(e, cfg.estimator_shots,
                                  seed=cfg.seed * 1000003 + int(p * 1e6))
        av = e.mean(axis=0)
        data[f"energy_p_{_fmt(p)}"] = av / cfg.L if per_qubit_norm else av
        z_data[float(p)] = zs.mean(axis=0)  # (T, L)
    result = dict(data)
    result["per_qubit_z"] = z_data
    if write:
        folder = out_dir or naming.energy_folder_name(cfg)
        path = os.path.join(folder, naming.energy_csv_name(cfg))
        csvio.write_columns(path, data)
        result["csv_path"] = path
    return result


def run_ham_comparison(cfg, hs=None, phis=None, *,
                       components=("full", "z_only", "zz_only", "x_only",
                                   "z_zz"),
                       nprob=None, device="cuda", out_dir=None,
                       disorder_dir=None, write=True, uniforms=None) -> dict:
    """Component-Hamiltonian comparison: E(t)/L of each component at one
    noise probability; CSV ``time, energy_{component}``."""
    _refuse_fakebackend(cfg)
    if hs is None or phis is None:
        hs, phis = get_disorder(cfg, disorder_dir)
    sweep = _sweep(cfg, hs, phis, device, uniforms)
    p = cfg.noise_p if nprob is None else nprob
    data = {"time": np.arange(cfg.tf)}
    for ci, comp in enumerate(components):
        with phase_timer(f"energy {comp}"):
            e, _ = _energy_single_noise(cfg, sweep, float(p), comp)
        e = apply_estimator_noise(e, cfg.estimator_shots,
                                  seed=cfg.seed * 1000003 + ci)
        data[f"energy_{comp}"] = e.mean(axis=0) / cfg.L
    if write:
        folder = out_dir or f"energy-data_L{cfg.L}-ham-comparison"
        path = os.path.join(folder, naming.energy_csv_name(cfg).replace(
            "energy_data_", "energy_ham_comparison_"))
        csvio.write_columns(path, data)
        data["csv_path"] = path
    return data


def run_per_qubit_z(cfg, hs=None, phis=None, *, device="cuda", out_dir=None,
                    disorder_dir=None, write=True, uniforms=None) -> dict:
    """Per-qubit <Z_q(t)> at cfg's noise; CSV ``time, z_q0, ...``."""
    _refuse_fakebackend(cfg)
    if hs is None or phis is None:
        hs, phis = get_disorder(cfg, disorder_dir)
    sweep = _sweep(cfg, hs, phis, device, uniforms)
    with phase_timer("per-qubit-z"):
        _, zs = _energy_single_noise(cfg, sweep, cfg.noise_p, "full")
    av = zs.mean(axis=0)  # (T, L)
    data = {"time": np.arange(cfg.tf)}
    for q in range(cfg.L):
        data[f"z_q{q}"] = av[:, q]
    if write:
        folder = out_dir or f"zdata_L{cfg.L}"
        path = os.path.join(
            folder, f"per_qubit_z_{cfg.initial_state}_g{cfg.g}_L{cfg.L}"
            f"_inst{cfg.inst}_noise{cfg.noise_prob}.csv")
        csvio.write_columns(path, data)
        data["csv_path"] = path
    return data


def _fmt(p: float) -> str:
    return str(int(p)) if p == int(p) else str(p)
