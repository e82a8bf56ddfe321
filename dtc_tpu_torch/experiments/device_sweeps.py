"""Device-noise sweeps: ``use_fakebackend=1`` (BASELINE config 4's mode).

Port of ``dtc_tpu/experiments/device_sweeps.py`` (``device_forward_sweep``,
``device_echo_sweep``, the gather guard). The noise model is
``models/device_noise.py::fake_device_model`` (``cfg.fake_device``,
``cfg.calibration_path``, seed cfg.seed + 7); the readout and ancilla
contractions ride ``ancilla_factor``. The engine choice
``DTC_TPU_DEVICE_ENGINE`` (read by each sweep, as the reference reads it;
also the ``device_engine=`` keyword) is ``auto``, ``sigma`` or ``kernel``.

Routes follow the port's tiers (``ops/routes.py::engine_for``), not
the reference's v5e ones. Under ``auto`` and ``kernel`` the device rows
(``core/device_evolve.py``) go to the kernel that ``engine_for`` picks for
the shape, in complex64 or not (the reference's device kernel routes do not
read the dtype):
- a constant x drive: K3, K1/K2 or the streamed family with device x rows
  (route ``x_kernel``), else the sigma device engine (``sigma``);
- any other drive: K4 with lab-frame device rows at 14 <= L <= 23
  (``general``); at 24 <= L <= 30 the lab-frame sharded engines with device
  rows on a one-shard mesh (``general_mesh``: K10's shard-local forms,
  256-lane rows at L=30), as the reference routes it; else the dense gather
  engine (``gather``).
``sigma`` sends an x drive to the sigma device engine and any other drive
to the gather engine; ``kernel`` raises where no kernel takes the x drive.
The reference's TPU-only limits (q < 14, and ``kernel`` raising on a CPU
backend) are not copied: on CPU tensors the kernel routes run the plain
versions, as every route of the port does. The gather engine is refused
above L = 24, the reference's limit, so that the port answers the same
requests.

Noise: uniforms in the blocks of ``core/device_evolve.py``, with (inst,
n_traj) leading: (u1, ue, uo), u1 (inst, n, T, K*E, L); the echoes 2T steps,
and the gather echo a second block for its inverse steps. Without them the
sweep draws them from a ``torch.Generator`` seeded with cfg.seed (echo:
cfg.seed + 7919), so results do not depend on chunking. Each sweep logs
its route (``engine=...``).
"""

from __future__ import annotations

import logging
import os

import numpy as np
import torch

from dtc_tpu_torch.core import device_evolve as de
from dtc_tpu_torch.experiments.engine import ECHO_SALT, traj_chunks
from dtc_tpu_torch.models.device_noise import fake_device_model
from dtc_tpu_torch.ops.routes import engine_for, kernel_chunks, x_route
from dtc_tpu_torch.parallel.mesh import make_mesh
from dtc_tpu_torch.parallel.sharded import (
    make_sharded_autocorr_forward_general,
    make_sharded_echo_general,
)
from dtc_tpu_torch.utils.validation import guard

log = logging.getLogger("dtc_tpu_torch")

GATHER_MAX_L = 24
DEVICE_ENGINES = ("auto", "sigma", "kernel")
EVENTS_PER_KICK = 2
MESH_MIN_L, MESH_MAX_L, MESH_MAX_STEPS = 24, 30, 1024


def device_engine_choice(device_engine=None) -> str:
    """``device_engine``, else ``DTC_TPU_DEVICE_ENGINE``, else "auto"."""
    if device_engine is None:
        device_engine = os.environ.get("DTC_TPU_DEVICE_ENGINE", "auto")
    if device_engine not in DEVICE_ENGINES:
        raise ValueError(f"DTC_TPU_DEVICE_ENGINE={device_engine!r} (want "
                         f"{'|'.join(DEVICE_ENGINES)})")
    return device_engine


def _guard_gather_path(cfg):
    if cfg.L > GATHER_MAX_L:
        raise ValueError(
            f"device-noise {cfg.polarization!r} polarization at L={cfg.L} "
            f"would fall to the dense gather engine, which the reference "
            f"refuses above L={GATHER_MAX_L}. Supported: constant x drives "
            f"(kernel and sigma engines) up to L=30; other drives through "
            f"the lab-frame kernels up to L=30 (q < L, forward tf*K <= "
            f"{MESH_MAX_STEPS}, echo 2*tf*K <= {MESH_MAX_STEPS}; "
            f"DTC_TPU_DEVICE_ENGINE=auto|kernel); this request missed "
            f"those constraints.")


def device_route(cfg, sched, *, echo: bool, device_engine=None) -> str:
    """'x_kernel', 'sigma', 'general', 'general_mesh' or 'gather' for this
    config (module docstring)."""
    engine = device_engine_choice(device_engine)
    L, T, q, K = cfg.L, cfg.tf, cfg.probe_qubit, sched.K
    x_drive = cfg.polarization == "x" and K == 1
    kw = dict(L=L, T=T, q=q, dtype_name="complex64", echo=echo)
    if x_drive:
        kernel_ok = (engine in ("auto", "kernel")
                     and x_route(engine_for(sched.angles, has_y=False, **kw)))
        if engine == "kernel" and not kernel_ok:
            raise ValueError(
                "the device kernel engine needs a constant x-only schedule "
                f"that an x kernel takes (L={L}, T={T}, q={q}): 14 <= L <= "
                "30, forward T <= 1024, echo T <= 512")
        return "x_kernel" if kernel_ok else "sigma"
    if engine in ("auto", "kernel"):
        if engine_for(sched.angles, has_y=True, **kw) == "general":
            return "general"
        steps = (2 if echo else 1) * T * K
        if (MESH_MIN_L <= L <= MESH_MAX_L and 0 <= q < L
                and steps <= MESH_MAX_STEPS):
            return "general_mesh"
    _guard_gather_path(cfg)
    return "gather"


def _model(cfg):
    return fake_device_model(cfg.L, cfg.fake_device, seed=cfg.seed + 7,
                             calibration_path=cfg.calibration_path)


def _rates(cfg, dev):
    """(p_1q, p_2q, ancilla factor) of the config's device model, the rates
    f64 as the reference's x64 arrays."""
    model = _model(cfg)
    af = (model.ancilla_interferometric_factor()
          * model.readout_z_factor(cfg.probe_qubit))
    return (torch.as_tensor(model.p_1q, dtype=torch.float64, device=dev),
            torch.as_tensor(model.p_2q, dtype=torch.float64, device=dev), af)


def _blocks(uniforms, lead, steps, n1, L, seed, dev, sets=1):
    """The device uniform block(s): given, checked and moved to ``dev``; else
    drawn. Returns (u1, ue, uo) per set, flattened into one tuple."""
    ne, no = de.n_bonds(L)
    shapes = [(*lead, steps, n1, L), (*lead, steps, ne), (*lead, steps, no)]
    shapes = shapes * sets
    if uniforms is not None:
        if len(uniforms) != len(shapes):
            raise ValueError(f"{len(uniforms)} uniform blocks, want "
                             f"{len(shapes)}")
        out = []
        for u, shape in zip(uniforms, shapes):
            u = torch.as_tensor(np.asarray(u) if not torch.is_tensor(u)
                                else u, device=dev)
            if tuple(u.shape) != shape:
                raise ValueError(f"uniforms shape {tuple(u.shape)} != "
                                 f"{shape}")
            out.append(u)
        return tuple(out)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return tuple(torch.rand(s, generator=gen, dtype=torch.float32,
                            device=dev) for s in shapes)


def device_forward_sweep(cfg, sched, params, *, uniforms=None,
                         device_engine=None) -> np.ndarray:
    """Device-noise A(t) per instance, trajectory-averaged: (inst, T)."""
    hs, phis = params
    dev = hs.device
    L, T, K, q = cfg.L, cfg.tf, sched.K, cfg.probe_qubit
    route = device_route(cfg, sched, echo=False, device_engine=device_engine)
    log.info("device_forward_sweep: engine=%s pol=%s L=%d T=%d", route,
             cfg.polarization, L, T)
    p1, p2, af = _rates(cfg, dev)
    n = cfg.n_trajectories
    u = _blocks(uniforms, (cfg.inst, n), T, K * EVENTS_PER_KICK, L, cfg.seed,
                dev)
    angles = sched.angles.to(dev)
    kw = dict(L=L, T=T, q=q, initial_state=cfg.initial_state,
              ancilla_factor=af, events_per_kick=EVENTS_PER_KICK)
    if route == "general_mesh":
        fn = make_sharded_autocorr_forward_general(
            make_mesh(n_amp=1, n_traj=1, devices=[dev]), L=L, T=T, K=K,
            p=0.0, q=q, initial_state=cfg.initial_state, ancilla_factor=af,
            device=(p1, p2, EVENTS_PER_KICK))
        out = np.stack([guard("device_forward_sweep", fn(
            angles, hs[i], phis[i], tuple(b[i] for b in u)).cpu().numpy(),
            bound=1.0) for i in range(cfg.inst)])
        return guard("device_forward_sweep", out, bound=1.0)
    if route == "x_kernel":
        run = de.device_kernel_forward_batch
    elif route == "sigma":
        run = de.device_sigma_forward_batch
        kw["dtype_name"] = cfg.dtype
    elif route == "general":
        run = de.device_general_kernel_forward_batch
        kw["K"] = K
    else:
        run = de.device_autocorr_forward
        kw.update(K=K, dtype_name=cfg.dtype)
    chunk = (kernel_chunks(1, n, 1, L)[1] if route in ("x_kernel", "general")
             else traj_chunks(n, L, extra_factor=2 * cfg.inst))
    out = np.zeros((cfg.inst, T))
    for i in range(cfg.inst):
        for lo in range(0, n, chunk):
            c = min(chunk, n - lo)
            vals = run(hs[i], phis[i], p1, p2, angles,
                       tuple(b[i, lo:lo + c] for b in u), **kw)
            out[i] += guard("device_forward_sweep",
                            vals.sum(0).cpu().numpy(), bound=float(c))
    return guard("device_forward_sweep", out / n, bound=1.0)


def device_echo_sweep(cfg, sched, params, *, uniforms=None,
                      device_engine=None, t_chunk: int = 8) -> np.ndarray:
    """Device-noise echo A0(t) per instance, trajectory-averaged: (inst, T).
    The kernel routes take at most ``t_chunk`` t values per launch, fewer
    where a launch holds fewer states (``routes.launch_states``)."""
    hs, phis = params
    dev = hs.device
    L, T, K, q = cfg.L, cfg.tf, sched.K, cfg.probe_qubit
    route = device_route(cfg, sched, echo=True, device_engine=device_engine)
    log.info("device_echo_sweep: engine=%s pol=%s L=%d T=%d", route,
             cfg.polarization, L, T)
    p1, p2, af = _rates(cfg, dev)
    n = cfg.n_trajectories
    u = _blocks(uniforms, (cfg.inst, n), 2 * T, K * EVENTS_PER_KICK, L,
                cfg.seed + ECHO_SALT, dev, sets=2 if route == "gather" else 1)
    angles = sched.angles.to(dev)
    kw = dict(L=L, T=T, q=q, initial_state=cfg.initial_state,
              ancilla_factor=af, events_per_kick=EVENTS_PER_KICK)
    out = np.zeros((cfg.inst, T))
    if route == "general_mesh":
        fn = make_sharded_echo_general(
            make_mesh(n_amp=1, n_traj=1, devices=[dev]), L=L, T=T, K=K,
            p=0.0, q=q, initial_state=cfg.initial_state, ancilla_factor=af,
            device=(p1, p2, EVENTS_PER_KICK))
        for i in range(cfg.inst):
            ui = tuple(b[i] for b in u)
            for t in range(T):
                out[i, t] = float(fn(angles, hs[i], phis[i], ui, t))
        return guard("device_echo_sweep", out, bound=1.0)
    if route == "x_kernel":
        run = de.device_kernel_echo_batch
    elif route == "sigma":
        run = de.device_sigma_echo_batch
        kw["dtype_name"] = cfg.dtype
    elif route == "general":
        run = de.device_general_kernel_echo_batch
        kw["K"] = K
    else:
        run = de.device_autocorr_echo
        kw.update(K=K, dtype_name=cfg.dtype)
    if route in ("x_kernel", "general"):
        _, chunk, t_chunk = kernel_chunks(1, n, t_chunk, L)
    else:
        chunk = traj_chunks(n, L, extra_factor=2 * cfg.inst * t_chunk)
    for t0 in range(0, T, t_chunk):
        ts = torch.arange(t0, min(t0 + t_chunk, T), device=dev)
        for i in range(cfg.inst):
            acc = np.zeros(len(ts))
            for lo in range(0, n, chunk):
                c = min(chunk, n - lo)
                vals = run(hs[i], phis[i], p1, p2, angles,
                           tuple(b[i, lo:lo + c] for b in u), ts, **kw)
                acc += guard("device_echo_sweep", vals.sum(0).cpu().numpy(),
                             bound=float(c))
            out[i, t0:t0 + len(ts)] = acc / n
    return guard("device_echo_sweep", out, bound=1.0)
