"""Sweep machinery: instance x trajectory batching with memory-aware chunks.

Port of ``dtc_tpu/experiments/engine.py`` (``build_context``,
``traj_chunks``, ``_forward_batch``, ``_echo_batch``, ``forward_sweep``,
``echo_sweep``, ``apply_shot_noise``).

Dispatch is by shape (``ops/routes.py``: the port's tiers, and each kernel
route's feeders and entries), routed once a sweep; what no kernel route
takes goes to the sigma-frame engine (``core/sigma_evolve.py``).
Each sweep logs once which engine served it (``engine=...``).

The engine choice ``DTC_TPU_ENGINE`` (read by each sweep, as the reference
reads it; also the sweeps' ``engine=`` keyword) takes ``auto`` (the tiers)
or ``planar``: then a constant x drive's forward sweep takes the
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
from dtc_tpu_torch.ops.routes import (
    ROUTES,
    kernel_chunks,
    launch_states,
    sweep_route,
)
from dtc_tpu_torch.utils.profiling import span
from dtc_tpu_torch.utils.validation import guard

log = logging.getLogger("dtc_tpu_torch")

# Live trajectory states per chunk for the sigma engine (its einsums keep a
# few state-sized temporaries), as in the reference.
DEFAULT_BATCH_BYTES = 2 << 30

ECHO_SALT = 7919

ENGINES = ("auto", "planar")


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


def _kernel_batch(hs, phis, angles, ts, uniforms, *, route, theta, L, T, K,
                  p, q, initial_state, ancilla_factor, n_traj, generator):
    """A forward (``ts`` None) or echo batch on a kernel route: the route's
    feeder, then its entry (``ops/routes.py::ROUTES``)."""
    r, echo = ROUTES[route], ts is not None
    inst = hs.shape[0]
    if uniforms is None and p > 0.0:
        uniforms = draw_uniforms((inst, n_traj, (1 + echo) * T * K, L),
                                 generator=generator, device=hs.device)
    c = uniforms.shape[1] if uniforms is not None else n_traj
    lead = (uniforms, ts) if echo else (uniforms,)
    shape = dict(L=L, T=T, p=p, batch=(inst, c))
    kw = dict(L=L, q=q, initial_state=initial_state,
              ancilla_factor=ancilla_factor)
    if r.kick == "rows":  # the lab-frame rows carry each step's U
        rows = r.feeder(echo)(*lead, hs[:, None], phis[:, None], angles, K=K,
                              **shape)
        entry = r.entry(echo)
        return entry(rows, **kw) if echo else entry(rows, T=T, **kw)
    rows, sig = r.feeder(echo)(*lead, hs[:, None], phis[:, None], **shape)
    return r.x_entry(echo, rows, sig, angles, theta, **kw)


def _forward_batch(hs, phis, angles, uniforms, *, route, theta, L, T, K, p,
                   q, initial_state, dtype_name, ancilla_factor, has_y=False,
                   n_traj=None, generator=None):
    """(inst, L), (inst, L-1), (T, K, 2) on any device, uniforms (inst, c,
    T*K, L) or None -> (inst, c, T) tensor on hs's device; ``route`` and
    ``theta`` are the sweep's (``ops/routes.py::sweep_route``)."""
    angles = angles.to(hs.device)
    if route == "planar":
        return planar_forward_batch(
            hs, phis, angles, uniforms, L=L, T=T, p=p, q=q,
            initial_state=initial_state, ancilla_factor=ancilla_factor,
            n_traj=n_traj, generator=generator)
    if route == "sigma":
        return sigma_forward_batch(
            hs, phis, angles, uniforms, L=L, T=T, K=K, p=p, q=q,
            initial_state=initial_state, dtype_name=dtype_name,
            ancilla_factor=ancilla_factor, has_y=has_y, n_traj=n_traj,
            generator=generator)
    return _kernel_batch(hs, phis, angles, None, uniforms, route=route,
                         theta=theta, L=L, T=T, K=K, p=p, q=q,
                         initial_state=initial_state,
                         ancilla_factor=ancilla_factor, n_traj=n_traj,
                         generator=generator)


def _echo_batch(hs, phis, angles, ts, uniforms, *, route, theta, L, T, K, p,
                q, initial_state, dtype_name, ancilla_factor, has_y=False,
                n_traj=None, generator=None):
    """-> (inst, c, n_ts) echo values; uniforms (inst, c, 2T*K, L)."""
    angles = angles.to(hs.device)
    if route == "sigma":
        return sigma_echo_batch(
            hs, phis, angles, ts, uniforms, L=L, T=T, K=K, p=p, q=q,
            initial_state=initial_state, dtype_name=dtype_name,
            ancilla_factor=ancilla_factor, has_y=has_y, n_traj=n_traj,
            generator=generator)
    return _kernel_batch(hs, phis, angles, ts, uniforms, route=route,
                         theta=theta, L=L, T=T, K=K, p=p, q=q,
                         initial_state=initial_state,
                         ancilla_factor=ancilla_factor, n_traj=n_traj,
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
    has_y = cfg.polarization != "x"
    engine, theta = sweep_route(sched.angles, L=L, T=T, q=cfg.probe_qubit,
                                dtype_name=cfg.dtype, has_y=has_y,
                                echo=False, engine=choice)
    kw = dict(route=engine, theta=theta, L=L, T=T, K=K, p=p,
              q=cfg.probe_qubit, initial_state=cfg.initial_state,
              dtype_name=cfg.dtype, ancilla_factor=af, has_y=has_y)
    log.info("forward_sweep: engine=%s pol=%s L=%d T=%d", engine,
             cfg.polarization, L, T)
    n_traj = cfg.n_trajectories if p > 0 else 1
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
    has_y = cfg.polarization != "x"
    engine, theta = sweep_route(sched.angles, L=L, T=T, q=cfg.probe_qubit,
                                dtype_name=cfg.dtype, has_y=has_y,
                                echo=True, engine=choice)
    kw = dict(route=engine, theta=theta, L=L, T=T, K=K, p=p,
              q=cfg.probe_qubit, initial_state=cfg.initial_state,
              dtype_name=cfg.dtype, ancilla_factor=noise.ancilla_factor,
              has_y=has_y)
    log.info("echo_sweep: engine=%s pol=%s L=%d T=%d", engine,
             cfg.polarization, L, T)
    n_traj = cfg.n_trajectories
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
                    acc += guard("echo_batch", vals.sum(dim=1).cpu().numpy(),
                                 bound=float(c))
            out[i0:i1, t0:t0 + len(ts)] = acc / n_traj
    return guard("echo_sweep", out, bound=1.0)


def apply_shot_noise(values: np.ndarray, shots: int, seed: int = 0) -> np.ndarray:
    """Binomial measurement sampling: <Z> -> 2*Binom(shots, (1+A)/2)/shots - 1."""
    rng = np.random.default_rng(seed)
    p0 = np.clip((1.0 + values) / 2.0, 0.0, 1.0)
    return 2.0 * rng.binomial(shots, p0) / shots - 1.0
