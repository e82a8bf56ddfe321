"""Amplitude-sharded autocorrelator runs.

Port of ``dtc_tpu/experiments/sharded_run.py`` (``_auto_mesh``,
``_cycle_kernel_ok``, ``_general_kernel_ok``, ``run_autocorr_sharded``):
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

``run_energy_sharded`` is not ported yet and raises. The reference's
environment switches (``DTC_TPU_SHARDED_ENGINE``,
``DTC_TPU_SHARDED_HI_MIN_LB``, ``DTC_TPU_SHARDED_HI_SPLIT_MIN_LB``) are not
ported: the engines are called directly where a route must be forced, and
``ops.cycle_hi.MIN_ROUTE_L`` takes the place of the second.

Noise: one f32 block of uniforms per run, forward (inst, n_traj, T*K, L)
and echo (inst, n_traj, 2T, K, L) (each instance's echo block shared by
every t), drawn up front from ``torch.Generator``s seeded with cfg.seed and
cfg.seed + 7919 (the engine's echo salt), or handed in as ``uniforms``.
"""

from __future__ import annotations

import logging
import os

import numpy as np
import torch

from dtc_tpu_torch.experiments.autocorr import _raw_sqrt
from dtc_tpu_torch.experiments.engine import ECHO_SALT, constant_x_theta
from dtc_tpu_torch.io import csvio, naming
from dtc_tpu_torch.io.disorder import get_disorder
from dtc_tpu_torch.models.drives import build_kick_schedule
from dtc_tpu_torch.models.noise import NoiseSpec
from dtc_tpu_torch.parallel.mesh import amp_bits, make_mesh, visible_devices
from dtc_tpu_torch.parallel.sharded import (
    make_sharded_autocorr_forward,
    make_sharded_autocorr_forward_general,
    make_sharded_autocorr_forward_kernel,
    make_sharded_echo,
    make_sharded_echo_general,
    make_sharded_echo_kernel,
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

    n_traj = max(cfg.n_trajectories if noise.p > 0 else 1,
                 mesh.shape["traj"])
    n_traj -= n_traj % mesh.shape["traj"]
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


def run_energy_sharded(cfg, *args, **kwargs) -> dict:
    """Not ported yet (the sharded observables engine)."""
    raise NotImplementedError(
        "run_energy_sharded (make_sharded_observables) is not ported yet: "
        "ROADMAP.md queue 1, sharding (make_sharded_observables / "
        "run_energy_sharded)")
