"""Amplitude-sharded autocorrelator and energy runs.

Port of ``dtc_tpu/experiments/sharded_run.py`` (``_auto_mesh``,
``_cycle_kernel_ok``, ``_general_kernel_ok``, ``run_autocorr_sharded``,
``run_energy_sharded``):
the forward + echo autocorrelator on a (traj, amp) mesh
(``parallel/mesh.py``), the CSV of ``run_autocorr`` in the folder
``autocorr_data_L{L}_sharded``. Routes, by shape as in the reference (its
TPU-only gate is not ported: a CPU tensor takes each kernel's plain
version), logged once per run as ``sharded_sweep: engine=<route>
mesh=(traj,amp)``:

- ``cycle``: a constant x drive with q < L_loc and 17 <= L_loc <= 23, the
  x cycle kernels K8a/K8b (``make_sharded_*_kernel``);
- ``cycle_hi``: a constant x drive with q < L_loc and 24 <= L_loc <= 29
  (from ``ops.cycle_hi.MIN_ROUTE_L``), the same engines on the streamed
  per-shard kernels K9a/K9b;
- ``cycle_general``: every other drive with q < L_loc and
  17 <= L_loc <= 23, the lab-frame cycle kernels K8c/K8d
  (``make_sharded_*_general``);
- ``sharded_sigma``: everything else, the sigma-frame engines, as the
  reference's fallback: x at L_loc = 30 and every other drive at
  L_loc >= 24 among them. The general engines run K10's shard-local forms
  at 24 <= L_loc <= 30 where they are called directly, as the reference's
  tests call them.

``run_energy_sharded`` runs the energy sweep on the mesh through the
eager observables engine (``make_sharded_observables``), logged
``sharded_energy: engine=sharded_obs mesh=(traj,amp)``, with the CSV of
``run_energy`` in the folder ``energy-data_L{L}-sharded``. Unlike the
reference's, it refuses no L (the reference's refusal at 17 <= L <= 23
guards a TPU backend fault), it runs ``cfg.dtype`` (the reference's runs
complex64 whatever the config says) and it refuses ``use_fakebackend=1``,
as the port's energy family does. The reference's environment switches
(``DTC_TPU_SHARDED_ENGINE``, ``DTC_TPU_SHARDED_HI_MIN_LB``,
``DTC_TPU_SHARDED_HI_SPLIT_MIN_LB``) are not
ported: the engines are called directly where a route must be forced, and
``ops.cycle_hi.MIN_ROUTE_L`` takes the place of the second.

Noise: one f32 block of uniforms per run, forward (inst, n_traj, T*K, L)
and echo (inst, n_traj, 2T, K, L) (each instance's echo block shared by
every t), drawn up front from ``torch.Generator``s seeded with cfg.seed and
cfg.seed + 7919 (the engine's echo salt), or handed in as ``uniforms``.
The energy sweep takes one block (inst, n_traj, T*K, L), used at every
noise level, as the reference reuses its keys.
"""

from __future__ import annotations

import logging
import os

import numpy as np
import torch

from dtc_tpu_torch.core.sigma_evolve import DTYPES
from dtc_tpu_torch.experiments.autocorr import _raw_sqrt
from dtc_tpu_torch.experiments.energy import (
    _fmt,
    _refuse_fakebackend,
    apply_estimator_noise,
)
from dtc_tpu_torch.experiments.engine import ECHO_SALT
from dtc_tpu_torch.io import csvio, naming
from dtc_tpu_torch.io.disorder import get_disorder
from dtc_tpu_torch.models.drives import build_kick_schedule
from dtc_tpu_torch.models.hamiltonian import hamiltonian_terms
from dtc_tpu_torch.models.noise import NoiseSpec
from dtc_tpu_torch.ops.routes import constant_x_theta
from dtc_tpu_torch.parallel.mesh import amp_bits, make_mesh, visible_devices
from dtc_tpu_torch.parallel.sharded import (
    _launch_traj,
    _runs,
    make_sharded_autocorr_forward,
    make_sharded_autocorr_forward_general,
    make_sharded_autocorr_forward_kernel,
    make_sharded_echo,
    make_sharded_echo_general,
    make_sharded_echo_kernel,
    make_sharded_observables,
    use_hi,
)
from dtc_tpu_torch.utils.profiling import phase_timer
from dtc_tpu_torch.utils.validation import guard

log = logging.getLogger("dtc_tpu_torch")


def _auto_mesh(L: int, n_amp=None, devices=None, device="cuda"):
    """The (traj, amp) mesh over ``devices`` (default: every visible card of
    ``device``); without n_amp the largest power of two that divides the
    device count and leaves each shard two amplitudes."""
    if devices is None:
        devices = visible_devices(device)
    n_dev = len(devices)
    if n_amp is None:
        n_amp = 1
        while (n_amp * 2 <= n_dev and n_dev % (n_amp * 2) == 0
               and (1 << L) // (n_amp * 2) >= 2):
            n_amp *= 2
    return make_mesh(n_amp=n_amp, n_traj=n_dev // n_amp, devices=devices)


def _cycle_kernel_ok(mesh, sched, cfg) -> bool:
    """The x cycle kernels' gate: a constant x-only schedule, a shard-local
    probe q < L_loc and 17 <= L_loc <= 29 (the reference's)."""
    local_bits = cfg.L - amp_bits(mesh)
    return (constant_x_theta(sched.angles) is not None
            and cfg.probe_qubit < local_bits
            and 17 <= local_bits <= 29)


def _general_kernel_ok(mesh, cfg) -> bool:
    """The lab-frame cycle kernels' gate: q < L_loc and 17 <= L_loc <= 23."""
    local_bits = cfg.L - amp_bits(mesh)
    return cfg.probe_qubit < local_bits and 17 <= local_bits <= 23


def sharded_route(mesh, sched, cfg) -> str:
    """'cycle', 'cycle_hi', 'cycle_general' or 'sharded_sigma'."""
    if _cycle_kernel_ok(mesh, sched, cfg):
        return "cycle_hi" if use_hi(cfg.L - amp_bits(mesh)) else "cycle"
    if _general_kernel_ok(mesh, cfg):
        return "cycle_general"
    return "sharded_sigma"


def _engines(route, mesh, cfg, K, p):
    """(forward fn, echo fn) of ``route``."""
    kw = dict(L=cfg.L, T=cfg.tf, p=p, q=cfg.probe_qubit,
              initial_state=cfg.initial_state)
    if route in ("cycle", "cycle_hi"):
        return (make_sharded_autocorr_forward_kernel(mesh, **kw),
                make_sharded_echo_kernel(mesh, **kw))
    if route == "cycle_general":
        return (make_sharded_autocorr_forward_general(mesh, K=K, **kw),
                make_sharded_echo_general(mesh, K=K, **kw))
    # has_y engages the sigma-conjugated kicks for drives with a Y part
    has_y = cfg.polarization != "x"
    return (make_sharded_autocorr_forward(mesh, K=K, has_y=has_y, **kw),
            make_sharded_echo(mesh, K=K, has_y=has_y, **kw))


def _block(uniforms, shape, seed, device):
    if uniforms is not None:
        u = torch.as_tensor(np.asarray(uniforms, dtype=np.float32)
                            if not torch.is_tensor(uniforms) else uniforms,
                            dtype=torch.float32, device=device)
        if tuple(u.shape) != tuple(shape):
            raise ValueError(f"uniforms shape {tuple(u.shape)} != {shape}")
        return u
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.rand(shape, generator=gen, dtype=torch.float32,
                      device=device)


def _traj_count(n_trajectories, p, mesh) -> int:
    """Trajectories of a sharded run, as the reference rounds them: at
    least one a traj group (one in all at p=0 on one group), a multiple of
    the groups."""
    groups = mesh.shape["traj"]
    n = max(n_trajectories if p > 0 else 1, groups)
    return n - n % groups


def forward_plan(mesh, cfg) -> dict:
    """The sharded forward of ``cfg`` on ``mesh`` as a run would lay it
    out, with no state allocated: the run's engines are built, not called.
    Returns its route, L_loc, the bytes of one trajectory's complex64
    shard, the trajectories of a traj group, and the trajectories of each
    kernel launch of one cycle (one launch a shard and run, runs of at most
    ``_launch_traj``; none on ``sharded_sigma``, whose torch ops hold a
    group's trajectories at once)."""
    sched = build_kick_schedule(
        cfg.polarization, cfg.g, cfg.tf,
        circular_frequency=cfg.circular_frequency,
        xy_cycle_period=cfg.xy_cycle_period)
    p = NoiseSpec(p=cfg.noise_p).p
    route = sharded_route(mesh, sched, cfg)
    _engines(route, mesh, cfg, sched.K, p)
    local_bits = cfg.L - amp_bits(mesh)
    n_traj = _traj_count(cfg.n_trajectories, p, mesh)
    kernels = route != "sharded_sigma"
    runs = [c for _, _, c in _runs(
        mesh, n_traj, _launch_traj(mesh, local_bits) if kernels else None)]
    return {"route": route, "local_bits": local_bits,
            "shard_bytes": 8 << local_bits,
            "group_traj": n_traj // mesh.shape["traj"],
            "launches": [c for c in runs for _ in range(mesh.shape["amp"])]
            if kernels else []}


def run_autocorr_sharded(cfg, hs=None, phis=None, *, n_amp=None, mesh=None,
                         devices=None, device="cuda", out_dir=None,
                         disorder_dir=None, write=True, with_echo=True,
                         echo_ts=None, uniforms=None) -> dict:
    """Forward (+echo) autocorrelator on an amplitude-sharded mesh.

    n_amp: amplitude shards (a power of two; the remaining devices become
    the trajectory axis); ``devices`` the mesh's logical devices (default
    every visible card of ``device``). The 2^L statevector never exists on
    one device. uniforms: optional (forward, echo) pair of blocks (module
    doc). Echo times not evaluated read NaN in the CSV; at p=0 the echo is
    1 everywhere, as the reference writes it. ``cfg.use_fakebackend``
    raises: the sharded engines run no device noise (the reference's
    ``run_autocorr_sharded`` runs depolarizing noise under the flag).
    """
    if cfg.use_fakebackend:
        raise NotImplementedError(
            "use_fakebackend=1 is refused by run_autocorr_sharded: the "
            "reference's never reads the flag and runs depolarizing noise "
            "(ROADMAP.md queue 3)")
    if hs is None or phis is None:
        hs, phis = get_disorder(cfg, disorder_dir)
    if mesh is None:
        mesh = _auto_mesh(cfg.L, n_amp, devices, device)
    dev0 = mesh.device(0, 0)
    noise = NoiseSpec(p=cfg.noise_p)
    sched = build_kick_schedule(
        cfg.polarization, cfg.g, cfg.tf,
        circular_frequency=cfg.circular_frequency,
        xy_cycle_period=cfg.xy_cycle_period)
    K, L, T = sched.K, cfg.L, cfg.tf
    route = sharded_route(mesh, sched, cfg)
    log.info("sharded_sweep: engine=%s mesh=(%d,%d) pol=%s L=%d T=%d", route,
             mesh.shape["traj"], mesh.shape["amp"], cfg.polarization, L, T)
    fwd, ech = _engines(route, mesh, cfg, K, noise.p)

    n_traj = _traj_count(cfg.n_trajectories, noise.p, mesh)
    u_fwd, u_echo = uniforms if uniforms is not None else (None, None)
    if noise.p > 0:
        u_fwd = _block(u_fwd, (cfg.inst, n_traj, T * K, L), cfg.seed, dev0)
    angles = sched.angles.to(dev0)
    hs_t = torch.as_tensor(np.asarray(hs)[:, :L], dtype=torch.float64,
                           device=dev0)
    phis_t = torch.as_tensor(np.asarray(phis)[:, :L - 1],
                             dtype=torch.float64, device=dev0)

    autocorr = np.zeros((cfg.inst, T))
    # p == 0: echo == 1 exactly (U^dag U = I), so ones are the values; with
    # noise, times not evaluated read NaN, not a fabricated 1.0
    echo = (np.ones((cfg.inst, T)) if noise.p == 0
            else np.full((cfg.inst, T), np.nan))
    for i in range(cfg.inst):
        with phase_timer(f"sharded forward inst {i}"):
            a = fwd(angles, hs_t[i], phis_t[i],
                    None if u_fwd is None else u_fwd[i], n_traj=n_traj)
            autocorr[i] = guard("sharded_forward", a.cpu().numpy(),
                                bound=1.0)
    if with_echo and noise.p > 0:
        u_echo = _block(u_echo, (cfg.inst, n_traj, 2 * T, K, L),
                        cfg.seed + ECHO_SALT, dev0)
        ts = list(range(T)) if echo_ts is None else list(echo_ts)
        for i in range(cfg.inst):
            with phase_timer(f"sharded echo inst {i}"):
                vals = torch.stack([ech(angles, hs_t[i], phis_t[i],
                                        u_echo[i], t, n_traj=n_traj)
                                    for t in ts])
                echo[i, ts] = guard("sharded_echo", vals.cpu().numpy(),
                                    bound=1.0)

    av = autocorr.mean(axis=0)
    av_echo = echo.mean(axis=0)
    data = {
        "time": np.arange(T),
        "av_autocorr": av,
        "av_autocorr_echo": av_echo,
        # raw sqrt like the reference's base schema: a negative averaged
        # echo records NaN, not a clamped 0
        "sqrt_av_autocorr_echo": _raw_sqrt(av_echo),
    }
    result = dict(data)
    result["mesh_shape"] = dict(mesh.shape)
    result["engine"] = route
    if write:
        folder = out_dir or f"autocorr_data_L{L}_sharded"
        path = os.path.join(folder, naming.autocorr_csv_name(cfg))
        csvio.write_columns(path, data)
        result["csv_path"] = path
    return result


def run_energy_sharded(cfg, hs=None, phis=None, *, n_amp=None, mesh=None,
                       devices=None, device="cuda",
                       nprobs=(0.0, 0.001, 0.01, 0.1), component="full",
                       out_dir=None, disorder_dir=None, write=True,
                       per_qubit_norm=True, uniforms=None) -> dict:
    """Energy sweep E(t)/L on an amplitude-sharded mesh: the counterpart of
    ``experiments/energy.py::run_energy``, CSV ``time, energy_p_{p}``.

    Trajectories are rounded to the mesh's traj axis as the reference
    rounds them (one a group at p=0); the estimator noise is applied per
    (instance, t) before the instance mean, with the reference's seeds.
    uniforms: optional (inst, n_traj, T*K, L) block, used at every noise
    level; drawn from a generator seeded with cfg.seed when None. Returns
    the CSV columns, ``per_qubit_z`` ({p: (T, L)}) and ``mesh_shape``."""
    _refuse_fakebackend(cfg)
    if hs is None or phis is None:
        hs, phis = get_disorder(cfg, disorder_dir)
    if mesh is None:
        mesh = _auto_mesh(cfg.L, n_amp, devices, device)
    dev0 = mesh.device(0, 0)
    sched = build_kick_schedule(
        cfg.polarization, cfg.g, cfg.tf,
        circular_frequency=cfg.circular_frequency,
        xy_cycle_period=cfg.xy_cycle_period)
    K, L, T = sched.K, cfg.L, cfg.tf
    angles = sched.angles.to(dev0)
    hs_t = torch.as_tensor(np.asarray(hs)[:, :L], dtype=torch.float64,
                           device=dev0)
    phis_t = torch.as_tensor(np.asarray(phis)[:, :L - 1],
                             dtype=torch.float64, device=dev0)
    noisy = [float(p) for p in nprobs if float(p) > 0]
    u_all = None
    if noisy:
        n_traj = _traj_count(cfg.n_trajectories, noisy[0], mesh)
        u_all = _block(uniforms, (cfg.inst, n_traj, T * K, L), cfg.seed,
                       dev0)
    data = {"time": np.arange(T)}
    z_data = {}
    for p in nprobs:
        p = float(p)
        log.info("sharded_energy: engine=sharded_obs mesh=(%d,%d) pol=%s "
                 "L=%d T=%d p=%s component=%s", mesh.shape["traj"],
                 mesh.shape["amp"],
                 cfg.polarization, L, T, p, component)
        fn = make_sharded_observables(mesh, L=L, T=T, K=K, p=p,
                                      initial_state=cfg.initial_state,
                                      dtype=DTYPES[cfg.dtype])
        n_traj = _traj_count(cfg.n_trajectories, p, mesh)
        inst_e = np.zeros((cfg.inst, T))
        acc_z = np.zeros((T, L))
        with phase_timer(f"sharded energy p={p}"):
            for i in range(cfg.inst):
                terms = hamiltonian_terms(L, cfg.g, hs_t[i], phis_t[i],
                                          component)
                e, zs = fn(angles, hs_t[i], phis_t[i], terms.hs, terms.phis,
                           terms.x_coeff,
                           u_all[i] if p > 0 else None, n_traj=n_traj)
                inst_e[i] = guard("sharded_energy", e.cpu().numpy())
                acc_z += guard("sharded_z", zs.cpu().numpy(), bound=1.0)
        # per-(instance, t) estimator noise before the instance mean, one
        # estimator job per circuit, as run_energy does
        av = apply_estimator_noise(inst_e, cfg.estimator_shots,
                                   seed=cfg.seed * 1000003 + int(p * 1e6)
                                   ).mean(axis=0)
        data[f"energy_p_{_fmt(p)}"] = av / L if per_qubit_norm else av
        z_data[p] = acc_z / cfg.inst
    result = dict(data)
    result["per_qubit_z"] = z_data
    result["mesh_shape"] = dict(mesh.shape)
    if write:
        folder = out_dir or f"energy-data_L{L}-sharded"
        path = os.path.join(folder, naming.energy_csv_name(cfg))
        csvio.write_columns(path, data)
        result["csv_path"] = path
    return result
