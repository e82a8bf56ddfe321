"""Sweep machinery: instance x trajectory batching with memory-aware chunks.

Port of ``dtc_tpu/experiments/engine.py`` (``build_context``,
``traj_chunks``, ``_forward_batch``, ``_echo_batch``, ``forward_sweep``,
``echo_sweep``, ``apply_shot_noise``).

Dispatch is by shape, as in the reference, with the port's own tiers:
- an x drive (K = 1, no y angle) in complex64 goes to the resident x
  entries (``ops/resident.py``: CUDA kernels K3a/K3b for CUDA tensors, their
  plain versions for CPU tensors) at 14 <= L <= 16 when it is constant (one
  angle for every cycle) and at 14 <= L <= 21 when it is per-cycle (the
  adaptive-g schedules), the reference's K3 range;
- a constant x drive goes to the blocked x entries at 17 <= L <= 23
  (``ops/resident_blocked.py``: K1/K2, or their plain versions) and to the
  streamed x entries at 24 <= L <= 30 (``ops/streamed.py``: the large-L
  CUDA family, or its plain versions);
- every other drive (y, xy, yx, circular, xy-cycle, per-cycle x at
  22 <= L) in complex64 goes to the lab-frame general entries at 14 <= L <= 23
  (``ops/resident_general.py``: CUDA kernel K4, or its plain versions) and
  to the streamed lab-frame entries at 24 <= L <= 29
  (``ops/cycle_hi_general.py``: the large-L CUDA family K10a/K10b, or its
  plain versions), both fed the same step rows
  (``ops/params_general.py``);
- everything else goes to the sigma-frame engine (``core/sigma_evolve.py``),
  among it every non-x drive at L=30 and complex128, as in the reference,
  whose single-chip general route stops at L=29 and complex64.
Each sweep logs once which engine served it (``engine=...``).

The engine choice ``DTC_TPU_ENGINE`` (read by each sweep, as the reference
reads it; also the sweeps' ``engine=`` keyword) takes ``auto`` (the routes
above) or ``planar``: then a constant x drive's forward sweep takes the
planar engine (``core/planar_evolve.py``, kernel K11 once per cycle), and
every other forward shape and every echo the sigma engine, as the
reference's dispatch does under that name. The reference's other names
select v5e code shapes, which the port does not have; they raise.

Noise: every entry takes an optional block of f32 uniforms laid out as the
reference draws them per trajectory — forward (inst, n_traj, T*K, L), echo
(inst, n_traj, 2T*K, L), the echo block shared by every t. Without one, the
sweep draws the whole block up front from a ``torch.Generator`` seeded with
cfg.seed (echo: cfg.seed + 7919, the reference's echo salt), so results do
not depend on chunking.
"""

from __future__ import annotations

import logging
import os

import numpy as np
import torch

from dtc_tpu_torch.core.planar_evolve import planar_forward_batch
from dtc_tpu_torch.core.sigma_evolve import (
    draw_uniforms,
    sigma_echo_batch,
    sigma_forward_batch,
)
from dtc_tpu_torch.models.drives import build_kick_schedule
from dtc_tpu_torch.models.noise import NoiseSpec
from dtc_tpu_torch.ops import (
    cycle_hi_general,
    resident,
    resident_blocked,
    resident_general,
    streamed,
)
from dtc_tpu_torch.ops.params import echo_pair_tiles, forward_rows
from dtc_tpu_torch.ops.params_general import (
    echo_kick_steps,
    forward_kick_steps,
    general_echo_rows,
    general_forward_rows,
)
from dtc_tpu_torch.utils.profiling import count_kicks, span
from dtc_tpu_torch.utils.validation import guard

log = logging.getLogger("dtc_tpu_torch")

# Live trajectory states per chunk for the sigma engine (its einsums keep a
# few state-sized temporaries), as in the reference.
DEFAULT_BATCH_BYTES = 2 << 30

# Live states per launch on the kernel routes. The CUDA kernels hold
# every state of a launch in device memory at once (8 MiB per trajectory or
# echo pair at L=20, 64 MiB at L=23, 8 GiB at L=30), unlike the TPU kernels,
# which hold one per grid step. 8 GiB is a tenth of an 80 GB card: 1024
# trajectories at L=20, 128 at L=23, one at L=30, and room left for the
# plain route's angle tables.
KERNEL_STATE_BYTES = 8 << 30

ECHO_SALT = 7919

ENGINES = ("auto", "planar")

# The lab-frame routes' entries (forward, echo), under whose spans the
# sweeps count the steps of each kick kind (``profiling.KICKS``).
LAB_ENTRIES = {"general": ("K4.forward", "K4.echo"),
               "general_hi": ("K10.forward", "K10.echo")}


def engine_choice(engine=None) -> str:
    """``engine``, else ``DTC_TPU_ENGINE``, else "auto"; ValueError for a
    name the port does not take."""
    if engine is None:
        engine = os.environ.get("DTC_TPU_ENGINE", "auto")
    if engine not in ENGINES:
        raise ValueError(f"engine {engine!r} (DTC_TPU_ENGINE) is not one of "
                         f"{', '.join(ENGINES)}")
    return engine


def resolve_device(device) -> torch.device:
    """torch.device for ``device``; a CUDA request without CUDA raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not"
                           " available")
    return dev


def traj_chunks(n_traj: int, L: int, extra_factor: int = 2,
                budget_bytes: int = DEFAULT_BATCH_BYTES) -> int:
    """Trajectories per chunk so live states stay under the budget."""
    bytes_per_traj = extra_factor * (1 << L) * 8
    return max(1, min(n_traj, budget_bytes // max(1, bytes_per_traj)))


def launch_states(L: int, state_bytes: int = 8) -> int:
    """States of 2^L amplitudes, ``state_bytes`` each with their
    temporaries, that one kernel launch may hold: within KERNEL_STATE_BYTES
    and at most ``resident_blocked.MAX_LAUNCH``, the kernels' grid limit;
    at least one."""
    return max(1, min(resident_blocked.MAX_LAUNCH,
                      KERNEL_STATE_BYTES // (state_bytes << L)))


def kernel_chunks(inst: int, n_traj: int, n_ts: int, L: int):
    """(instances, trajectories, t values) per kernel launch: at most
    ``launch_states(L)`` states (t values x states for the echoes), at
    least one of each; the t values are kept together first, then the
    instances, then the trajectories."""
    states = launch_states(L)
    ts = min(n_ts, states)
    ic = min(inst, states // ts)
    return ic, min(n_traj, states // (ts * ic)), ts


def planar_chunk(n_traj: int, L: int, inst: int) -> int:
    """Trajectories per planar forward call: its inst x chunk states, whole
    states and their matmul temporaries (16 bytes an amplitude), all go to
    one K11 launch a cycle, so within ``launch_states``."""
    return max(1, min(n_traj, launch_states(L, 16) // inst))


def kick_schedule(cfg, device=None):
    """The run's kick schedule on ``device`` (default the CPU)."""
    return build_kick_schedule(
        cfg.polarization, cfg.g, cfg.tf,
        circular_frequency=cfg.circular_frequency,
        xy_cycle_period=cfg.xy_cycle_period, device=device)


def build_context(cfg, hs, phis, *, device):
    """Per-run precomputation: kick schedule + parameter tensors on device."""
    dev = resolve_device(device)
    sched = kick_schedule(cfg, dev)
    hs = torch.as_tensor(np.asarray(hs)[:, :cfg.L], dtype=torch.float64,
                         device=dev)
    phis = torch.as_tensor(np.asarray(phis)[:, :cfg.L - 1],
                           dtype=torch.float64, device=dev)
    return sched, (hs, phis), NoiseSpec(p=cfg.noise_p)


def x_schedule(angles) -> bool:
    """Whether the schedule kicks about x only: K = 1 and no y angle."""
    ang = angles.detach().cpu()
    return ang.shape[1] == 1 and not bool((ang[:, :, 1] != 0).any())


def constant_x_theta(angles) -> float | None:
    """The kick angle of a constant x-drive schedule, else None."""
    if not x_schedule(angles):
        return None
    ang = angles.detach().cpu()
    if not bool((ang == ang[0]).all()):
        return None
    return float(ang[0, 0, 0])


def engine_for(angles, *, L, T, q, dtype_name, has_y, echo: bool,
               engine: str = "auto") -> str:
    """'resident' (x kernels K3a/K3b or their plain versions), 'blocked'
    (K1/K2 or their plain versions), 'streamed' (the large-L x family or its
    plain versions), 'general' (the lab-frame kernel K4 or its plain
    versions), 'general_hi' (the large-L lab-frame family or its plain
    versions) or 'sigma'; under ``engine="planar"`` 'planar' (a constant x
    drive's forward, any L and dtype: the planar engine computes in f32
    planes) or 'sigma'."""
    x_only = not has_y and x_schedule(angles)
    const_x = x_only and constant_x_theta(angles) is not None
    if engine == "planar":
        return ("planar" if const_x and not echo and 0 <= q < L
                else "sigma")
    if dtype_name != "complex64" or not 0 <= q < L:
        return "sigma"
    if x_only:
        # constant x: K3 below K1's range; per-cycle x: K3's whole range
        top = resident_blocked.MIN_L - 1 if const_x else resident.MAX_L
        t_max = resident.MAX_T_ECHO if echo else resident.MAX_T_FORWARD
        if resident.MIN_L <= L <= top and T <= t_max:
            return "resident"
    if const_x:
        for name, mod in (("blocked", resident_blocked),
                          ("streamed", streamed)):
            t_max = mod.MAX_T_ECHO if echo else mod.MAX_T_FORWARD
            if mod.MIN_L <= L <= mod.MAX_L and T <= t_max:
                return name
    if const_x:
        return "sigma"
    steps = (2 if echo else 1) * T * angles.shape[1]
    for name, lo, mod in (
            ("general", resident_general.MIN_L, resident_general),
            ("general_hi", cycle_hi_general.MIN_ROUTE_L, cycle_hi_general)):
        if lo <= L <= mod.MAX_L and steps <= mod.MAX_STEPS:
            return name
    return "sigma"


def _host_and_device(angles, device):
    """(a host copy, a copy on ``device``) of a kick schedule: the route
    and the constant angle are read from the host copy, so that a batch
    costs at most one device-to-host copy of its schedule."""
    return angles.detach().cpu(), angles.to(device)


def _forward_batch(hs, phis, angles, uniforms, *, L, T, K, p, q,
                   initial_state, dtype_name, ancilla_factor, has_y=False,
                   n_traj=None, generator=None, engine="auto"):
    """(inst, L), (inst, L-1), (T, K, 2) on any device, uniforms (inst, c,
    T*K, L) or None -> (inst, c, T) tensor on hs's device."""
    host, angles = _host_and_device(angles, hs.device)
    engine = engine_for(host, L=L, T=T, q=q, dtype_name=dtype_name,
                        has_y=has_y, echo=False, engine=engine)
    if engine == "planar":
        return planar_forward_batch(
            hs, phis, angles, uniforms, L=L, T=T, p=p, q=q,
            initial_state=initial_state, ancilla_factor=ancilla_factor,
            n_traj=n_traj, generator=generator)
    theta = constant_x_theta(host)
    if engine != "sigma":
        inst = hs.shape[0]
        if uniforms is None and p > 0.0:
            uniforms = draw_uniforms((inst, n_traj, T * K, L),
                                     generator=generator, device=hs.device)
        c = uniforms.shape[1] if uniforms is not None else n_traj
    if engine == "resident":
        rows, sig_after = forward_rows(uniforms, hs[:, None], phis[:, None],
                                       L=L, T=T, p=p, batch=(inst, c))
        return resident.resident_forward_batch(
            rows, sig_after, angles, L=L, q=q, initial_state=initial_state,
            ancilla_factor=ancilla_factor,
            time_dependent=theta is None)
    if engine in ("blocked", "streamed"):
        rows, sig_after = forward_rows(uniforms, hs[:, None], phis[:, None],
                                       L=L, T=T, p=p, batch=(inst, c))
        entry = (resident_blocked.blocked_forward_batch if engine == "blocked"
                 else streamed.streamed_forward_batch)
        return entry(rows, sig_after, theta, L=L, q=q,
                     initial_state=initial_state,
                     ancilla_factor=ancilla_factor)
    if engine in ("general", "general_hi"):
        rows = general_forward_rows(uniforms, hs[:, None], phis[:, None],
                                    angles, L=L, T=T, K=K, p=p,
                                    batch=(inst, c))
        entry = (resident_general.general_forward_batch
                 if engine == "general"
                 else cycle_hi_general.general_hi_forward_batch)
        return entry(rows, L=L, T=T, q=q, initial_state=initial_state,
                     ancilla_factor=ancilla_factor)
    return sigma_forward_batch(
        hs, phis, angles, uniforms, L=L, T=T, K=K, p=p, q=q,
        initial_state=initial_state, dtype_name=dtype_name,
        ancilla_factor=ancilla_factor, has_y=has_y, n_traj=n_traj,
        generator=generator)


def _echo_batch(hs, phis, angles, ts, uniforms, *, L, T, K, p, q,
                initial_state, dtype_name, ancilla_factor, has_y=False,
                n_traj=None, generator=None, engine="auto"):
    """-> (inst, c, n_ts) echo values; uniforms (inst, c, 2T*K, L)."""
    host, angles = _host_and_device(angles, hs.device)
    engine = engine_for(host, L=L, T=T, q=q, dtype_name=dtype_name,
                        has_y=has_y, echo=True, engine=engine)
    theta = constant_x_theta(host)
    if engine != "sigma":
        inst = hs.shape[0]
        if uniforms is None and p > 0.0:
            uniforms = draw_uniforms((inst, n_traj, 2 * T * K, L),
                                     generator=generator, device=hs.device)
        c = uniforms.shape[1] if uniforms is not None else n_traj
    if engine == "resident":
        tiles, sig_fin = echo_pair_tiles(uniforms, ts, hs[:, None],
                                         phis[:, None], L=L, T=T, p=p,
                                         batch=(inst, c))
        return resident.resident_echo_batch(
            tiles, sig_fin, angles, L=L, q=q, initial_state=initial_state,
            ancilla_factor=ancilla_factor,
            time_dependent=theta is None)
    if engine in ("blocked", "streamed"):
        tiles, sig_fin = echo_pair_tiles(uniforms, ts, hs[:, None],
                                         phis[:, None], L=L, T=T, p=p,
                                         batch=(inst, c))
        entry = (resident_blocked.blocked_echo_batch if engine == "blocked"
                 else streamed.streamed_echo_batch)
        return entry(tiles, sig_fin, theta, L=L, q=q,
                     initial_state=initial_state,
                     ancilla_factor=ancilla_factor)
    if engine in ("general", "general_hi"):
        tiles = general_echo_rows(uniforms, ts, hs[:, None], phis[:, None],
                                  angles, L=L, T=T, K=K, p=p,
                                  batch=(inst, c))
        entry = (resident_general.general_echo_batch if engine == "general"
                 else cycle_hi_general.general_hi_echo_batch)
        return entry(tiles, L=L, q=q, initial_state=initial_state,
                     ancilla_factor=ancilla_factor)
    return sigma_echo_batch(
        hs, phis, angles, ts, uniforms, L=L, T=T, K=K, p=p, q=q,
        initial_state=initial_state, dtype_name=dtype_name,
        ancilla_factor=ancilla_factor, has_y=has_y, n_traj=n_traj,
        generator=generator)


@span("dtc.feed.uniforms")
def _sweep_uniforms(uniforms, shape, seed, device):
    if uniforms is not None:
        if not torch.is_tensor(uniforms):
            uniforms = np.array(uniforms, dtype=np.float32)
        u = torch.as_tensor(uniforms, dtype=torch.float32, device=device)
        if tuple(u.shape) != tuple(shape):
            raise ValueError(f"uniforms shape {tuple(u.shape)} != {shape}")
        return u
    gen = torch.Generator(device=device).manual_seed(seed)
    return draw_uniforms(shape, generator=gen, device=device)


def forward_sweep(cfg, sched, params, noise, *, uniforms=None,
                  engine=None) -> np.ndarray:
    """A(t) per instance, trajectory-averaged: (inst, T) numpy. ``engine``
    (default ``DTC_TPU_ENGINE``, else "auto"): "auto" or "planar"."""
    hs, phis = params
    p = noise.p
    af = noise.ancilla_factor if p > 0 else 1.0
    K, L, T = sched.K, cfg.L, cfg.tf
    choice = engine_choice(engine)
    kw = dict(L=L, T=T, K=K, p=p, q=cfg.probe_qubit,
              initial_state=cfg.initial_state, dtype_name=cfg.dtype,
              ancilla_factor=af, has_y=cfg.polarization != "x",
              engine=choice)
    engine = engine_for(sched.angles, L=L, T=T, q=cfg.probe_qubit,
                        dtype_name=cfg.dtype, has_y=kw["has_y"], echo=False,
                        engine=choice)
    log.info("forward_sweep: engine=%s pol=%s L=%d T=%d", engine,
             cfg.polarization, L, T)
    n_traj = cfg.n_trajectories if p > 0 else 1
    lab = LAB_ENTRIES.get(engine)
    host = sched.angles.detach().cpu() if lab else None
    u = (_sweep_uniforms(uniforms, (cfg.inst, n_traj, T * K, L), cfg.seed,
                         hs.device) if p > 0 else None)
    if engine == "planar":
        ic = cfg.inst
        chunk = planar_chunk(n_traj, L, cfg.inst)
    elif engine != "sigma":
        ic, chunk, _ = kernel_chunks(cfg.inst, n_traj, 1, L)
    else:
        ic = cfg.inst
        chunk = traj_chunks(n_traj, L, extra_factor=2 * cfg.inst)
    acc = np.zeros((cfg.inst, T))
    for i0 in range(0, cfg.inst, ic):
        i1 = min(i0 + ic, cfg.inst)
        for done in range(0, n_traj, chunk):
            with span("dtc.sweep.forward_batch"):
                c = min(chunk, n_traj - done)
                uc = u[i0:i1, done:done + c] if u is not None else None
                vals = _forward_batch(hs[i0:i1], phis[i0:i1], sched.angles,
                                      uc, n_traj=c, **kw)
                if lab:
                    count_kicks(lab[0], forward_kick_steps(
                        host, T, (i1 - i0) * c))
                acc[i0:i1] += guard("forward_batch",
                                    vals.sum(dim=1).cpu().numpy(),
                                    bound=float(c))
    return guard("forward_sweep", acc / n_traj, bound=1.0)


def echo_sweep(cfg, sched, params, noise, *, uniforms=None,
               t_chunk: int = 8, engine=None) -> np.ndarray:
    """Echo A0(t) per instance, trajectory-averaged: (inst, T) numpy.
    The noiseless echo is exactly 1 and is returned analytically. The
    kernel routes take at most ``t_chunk`` t values per launch, fewer where
    a launch holds fewer states (``launch_states``). ``engine`` as in
    ``forward_sweep`` ("planar": every echo takes the sigma engine)."""
    hs, phis = params
    p = noise.p
    choice = engine_choice(engine)
    if p == 0.0:
        return np.ones((cfg.inst, cfg.tf))
    K, L, T = sched.K, cfg.L, cfg.tf
    kw = dict(L=L, T=T, K=K, p=p, q=cfg.probe_qubit,
              initial_state=cfg.initial_state, dtype_name=cfg.dtype,
              ancilla_factor=noise.ancilla_factor,
              has_y=cfg.polarization != "x", engine=choice)
    engine = engine_for(sched.angles, L=L, T=T, q=cfg.probe_qubit,
                        dtype_name=cfg.dtype, has_y=kw["has_y"], echo=True,
                        engine=choice)
    log.info("echo_sweep: engine=%s pol=%s L=%d T=%d", engine,
             cfg.polarization, L, T)
    n_traj = cfg.n_trajectories
    lab = LAB_ENTRIES.get(engine)
    host = sched.angles.detach().cpu() if lab else None
    u = _sweep_uniforms(uniforms, (cfg.inst, n_traj, 2 * T * K, L),
                        cfg.seed + ECHO_SALT, hs.device)
    if engine != "sigma":
        ic, chunk, t_chunk = kernel_chunks(cfg.inst, n_traj, t_chunk, L)
    else:
        ic = cfg.inst
        chunk = traj_chunks(n_traj, L, extra_factor=2 * cfg.inst * t_chunk)
    out = np.zeros((cfg.inst, T))
    for t0 in range(0, T, t_chunk):
        ts = torch.arange(t0, min(t0 + t_chunk, T), device=hs.device)
        for i0 in range(0, cfg.inst, ic):
            i1 = min(i0 + ic, cfg.inst)
            acc = np.zeros((i1 - i0, len(ts)))
            for done in range(0, n_traj, chunk):
                with span("dtc.sweep.echo_batch"):
                    c = min(chunk, n_traj - done)
                    vals = _echo_batch(hs[i0:i1], phis[i0:i1], sched.angles,
                                       ts, u[i0:i1, done:done + c], n_traj=c,
                                       **kw)
                    if lab:
                        count_kicks(lab[1], echo_kick_steps(
                            host, range(t0, t0 + len(ts)), (i1 - i0) * c))
                    acc += guard("echo_batch", vals.sum(dim=1).cpu().numpy(),
                                 bound=float(c))
            out[i0:i1, t0:t0 + len(ts)] = acc / n_traj
    return guard("echo_sweep", out, bound=1.0)


def apply_shot_noise(values: np.ndarray, shots: int, seed: int = 0) -> np.ndarray:
    """Binomial measurement sampling: <Z> -> 2*Binom(shots, (1+A)/2)/shots - 1."""
    rng = np.random.default_rng(seed)
    p0 = np.clip((1.0 + values) / 2.0, 0.0, 1.0)
    return 2.0 * rng.binomial(shots, p0) / shots - 1.0
