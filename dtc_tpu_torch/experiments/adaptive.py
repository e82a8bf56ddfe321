"""Adaptive-g control experiments: the real-time feedback loop, its g
optimizers, the batch (non-causal) control and the fixed-g comparisons.

Port of ``dtc_tpu/experiments/adaptive.py``: the feedback laws
(``linear_g_adjustment``, ``exponential_g_adjustment``,
``adjust_g_schedule``), the optimizers (``golden_section_minimize``,
``grid_search_minimize``, ``optimize_g_for_target_echo``), the steppers
(``AdaptiveStepper``, ``KernelAdaptiveStepper``, ``make_stepper``) and the
runs (``run_adaptive_realtime``, ``run_fixed_g``, ``run_adaptive_batch``),
with the reference's CSV columns, file names and per-instance seeds
(realtime ``seed + 101 i``, fixed g ``seed + 977 i``, batch ``seed + 31 i``).

The steppers share one API (``reset``, ``advance``, ``forward_value``,
``echo_value``):
- ``KernelAdaptiveStepper``: ``states`` is the number of applied cycles;
  every query re-evolves from t=0 through the accumulated per-cycle g
  schedule (T+1 cycles) with the engine's ``_forward_batch`` /
  ``_echo_batch``, which route a per-cycle x schedule to the resident x
  kernels K3a/K3b at 14 <= L <= 21 (``ops/resident.py``) and other drives to
  the lab-frame kernels. Common random numbers: its forward block
  (1, n_traj, (T+1) K, L) and echo block (1, n_traj, 2 (T+1) K, L) are drawn
  once per instance (``instance_uniforms``) and handed to every call, so
  that every optimizer candidate sees the same noise and the echo objective
  is deterministic in g.
- ``AdaptiveStepper``: carries trajectory-batched branch pairs
  (n_traj, 2, 2^L) with the eager cycles of ``core/evolve.py``; noise from
  the ``torch.Generator`` passed as ``key``.
``make_stepper(mode="auto"|"kernel"|"carried")`` takes the place of the
reference's ``DTC_TPU_ADAPTIVE`` switch: "auto" takes the kernel stepper on
a CUDA device for complex64 shapes whose per-cycle schedules the resident
or general route serves, else the carried one (as the reference does on
the CPU).

Each adaptive or fixed-g sweep logs its engine once (``..._sweep:
engine=...``; the carried stepper's is ``carried``). The kernel stepper
logs the route its calls take, once for each: a step whose schedule is
still constant (the first) takes the constant-x route, as in the
reference, the later ones the per-cycle route. Unlike the reference,
``use_fakebackend=1`` raises: the reference's adaptive loops have no
device-noise path and run depolarizing noise under the flag.
"""

from __future__ import annotations

import logging
import os

import numpy as np
import torch

from dtc_tpu_torch.analysis.envelope import find_envelope
from dtc_tpu_torch.core.evolve import (
    _branch_autocorr,
    _branch_pair,
    forward_cycle,
    inverse_cycle,
)
from dtc_tpu_torch.core.sigma_evolve import DTYPES, draw_uniforms
from dtc_tpu_torch.core.statevector import initial_statevector
from dtc_tpu_torch.experiments.engine import (
    _echo_batch,
    _forward_batch,
    resolve_device,
)
from dtc_tpu_torch.io import csvio, naming
from dtc_tpu_torch.io.disorder import get_disorder
from dtc_tpu_torch.models.drives import build_kick_schedule, n_kick_slots
from dtc_tpu_torch.models.noise import NoiseSpec
from dtc_tpu_torch.ops.diag import z_sign_mask, zz_z_phase_mask
from dtc_tpu_torch.ops.routes import engine_for, kernel_chunks, sweep_route
from dtc_tpu_torch.utils.validation import guard

log = logging.getLogger("dtc_tpu_torch")


# ---------------------------------------------------------------------------
# feedback laws


def linear_g_adjustment(echo_val, target_echo, current_g, feedback_gain,
                        g_min, g_max):
    return float(np.clip(current_g + feedback_gain * (target_echo - echo_val),
                         g_min, g_max))


def exponential_g_adjustment(echo_val, target_echo, current_g, time_step,
                             feedback_gain, decay_compensation, g_min, g_max):
    """Exponential-compensation feedback: gain scaled by exp(decay*t), plus a
    log-ratio amplification term for small echo, the combined adjustment
    rescaled by (1 + decay*t)."""
    echo_error = target_echo - echo_val
    time_factor = np.exp(decay_compensation * time_step)
    exp_adj = feedback_gain * echo_error * time_factor
    if echo_val > 0.01:
        log_adj = feedback_gain * 0.1 * (np.log(target_echo / echo_val)
                                         if echo_val < target_echo else 0.0)
    else:
        log_adj = feedback_gain * 2.0
    total = (exp_adj + log_adj) * (1.0 + decay_compensation * time_step)
    return float(np.clip(current_g + total, g_min, g_max))


def adjust_g_schedule(echo_values, g_values, target_echo, feedback_gain,
                      g_min, g_max):
    """Batch (non-causal) whole-schedule adjustment from the previous echo
    trajectory: g[t] += gain * (target - echo[t-1])."""
    new_g = np.array(g_values, dtype=float)
    for t in range(1, len(echo_values)):
        new_g[t] = np.clip(
            g_values[t] + feedback_gain * (target_echo - echo_values[t - 1]),
            g_min, g_max,
        )
    return new_g


# ---------------------------------------------------------------------------
# noise and routes


def instance_uniforms(seed: int, n_traj: int, shapes, device):
    """One block of f32 uniforms (1, n_traj, *shape) per entry of
    ``shapes``, drawn in order from a ``torch.Generator`` seeded with
    ``seed``: the port's stand-in for the reference's split of the instance
    key PRNGKey(seed) into halves, each split into per-trajectory keys. A
    test hands in those draws by replacing this function."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return tuple(draw_uniforms((1, n_traj, *shape), generator=gen,
                               device=device) for shape in shapes)


def _refuse_fakebackend(cfg) -> None:
    if cfg.use_fakebackend:
        raise NotImplementedError(
            "use_fakebackend=1 (device noise) is refused by the adaptive"
            " runs: the reference's have no device-noise path and run"
            " depolarizing noise under the flag (ROADMAP.md queue 3)")


def stepper_engine(cfg) -> str:
    """The engine route of the loop's per-cycle schedules: T+1 cycles whose
    g varies (the route then depends on the shape alone), the echo's."""
    T1 = cfg.tf + 1
    angles = build_kick_schedule(
        cfg.polarization, torch.linspace(0.0, 1.0, T1, dtype=torch.float64),
        T1, circular_frequency=cfg.circular_frequency,
        xy_cycle_period=cfg.xy_cycle_period).angles
    return engine_for(angles, L=cfg.L, T=T1, q=cfg.probe_qubit,
                      dtype_name=cfg.dtype,
                      has_y=cfg.polarization != "x", echo=True)


def _row(x, n, device):
    return torch.as_tensor(np.asarray(x)[:n], dtype=torch.float64,
                           device=device)[None]


# ---------------------------------------------------------------------------
# steppers


class AdaptiveStepper:
    """Carries trajectory-batched branch pairs (n_traj, 2, 2^L) through a
    per-cycle g schedule, one eager cycle per ``advance``."""

    def __init__(self, cfg, hs_row, phis_row, *, n_traj=None,
                 device="cuda"):
        self.cfg = cfg
        self.L = cfg.L
        self.T = cfg.tf
        self.K = n_kick_slots(cfg.polarization)
        self.p = cfg.noise_p
        self.q = cfg.probe_qubit
        self.dtype = DTYPES[cfg.dtype]
        noise = NoiseSpec(p=self.p)
        self.af = noise.ancilla_factor if self.p > 0 else 1.0
        self.n_traj = n_traj or (cfg.n_trajectories if self.p > 0 else 1)
        self.device = resolve_device(device)
        dev = self.device
        self.diag = zz_z_phase_mask(_row(hs_row, self.L, dev)[0],
                                    _row(phis_row, self.L - 1, dev)[0],
                                    self.L, dtype=self.dtype)
        self.zq = z_sign_mask(self.q, self.L, device=dev)
        psi0 = initial_statevector(self.L, cfg.initial_state,
                                   dtype=self.dtype, device=dev)
        self.state0 = _branch_pair(psi0, self.zq).expand(
            self.n_traj, 2, 1 << self.L)
        self._kw = dict(L=self.L, K=self.K, p=self.p)
        log.info("adaptive_sweep: engine=carried pol=%s L=%d T=%d",
                 cfg.polarization, self.L, self.T)

    def _angles_for(self, g_schedule):
        return build_kick_schedule(
            self.cfg.polarization,
            torch.as_tensor(g_schedule, dtype=torch.float64), self.T,
            circular_frequency=self.cfg.circular_frequency,
            xy_cycle_period=self.cfg.xy_cycle_period,
            device=self.device).angles  # (T, K, 2)

    def reset(self):
        return self.state0

    def advance(self, states, g_value, time_step, key):
        angles = self._angles_for(np.full(self.T, g_value))[time_step]
        return forward_cycle(states, angles, self.diag, generator=key,
                             **self._kw)

    def forward_value(self, states) -> float:
        return float(_branch_autocorr(states, self.zq, self.af).mean())

    def echo_value(self, states_prev, g_schedule, g_last, t_next,
                   key) -> float:
        """Echo at t_next cycles: carried states_prev (after t_next-1
        cycles) + one cycle at g_last + t_next inverse cycles in reverse
        time order."""
        g_full = np.array(g_schedule, dtype=float)
        g_full[t_next - 1] = g_last
        angles = self._angles_for(g_full)
        state = forward_cycle(states_prev, angles[t_next - 1], self.diag,
                              generator=key, **self._kw)
        for k in range(t_next):
            state = inverse_cycle(state, angles[t_next - 1 - k], self.diag,
                                  generator=key, **self._kw)
        return float(_branch_autocorr(state, self.zq, self.af).mean())


class KernelAdaptiveStepper:
    """Schedule-sweep stepper on the engine's batch entries (module doc):
    ``states`` counts the applied cycles, every query re-evolves from t=0,
    the noise blocks are fixed per instance."""

    def __init__(self, cfg, hs_row, phis_row, *, n_traj=None, seed=None,
                 device="cuda"):
        self.cfg = cfg
        self.T = cfg.tf
        self.K = n_kick_slots(cfg.polarization)
        noise = NoiseSpec(p=cfg.noise_p)
        self.p = noise.p
        self.af = noise.ancilla_factor if self.p > 0 else 1.0
        self.n_traj = n_traj or (cfg.n_trajectories if self.p > 0 else 1)
        self.device = resolve_device(device)
        seed = cfg.seed if seed is None else seed
        steps = (self.T + 1) * self.K
        self._u_f, self._u_e = (
            instance_uniforms(seed, self.n_traj, ((steps, cfg.L),
                                                  (2 * steps, cfg.L)),
                              self.device)
            if self.p > 0 else (None, None))
        self._h = _row(hs_row, cfg.L, self.device)
        self._ph = _row(phis_row, cfg.L - 1, self.device)
        self._g = np.full(self.T + 1, cfg.g, dtype=float)
        self._kw = dict(L=cfg.L, T=self.T + 1, K=self.K, p=self.p,
                        q=cfg.probe_qubit, initial_state=cfg.initial_state,
                        dtype_name=cfg.dtype, ancilla_factor=self.af,
                        has_y=cfg.polarization != "x", n_traj=self.n_traj)
        self._logged = set()

    def _angles(self, g_schedule, echo: bool):
        """The schedule of ``g_schedule`` on the host (the engine moves it
        to the device) and its route (``sweep_route``); logs the first call
        of each engine route."""
        angles = build_kick_schedule(
            self.cfg.polarization,
            torch.as_tensor(g_schedule, dtype=torch.float64), self.T + 1,
            circular_frequency=self.cfg.circular_frequency,
            xy_cycle_period=self.cfg.xy_cycle_period).angles
        kw = self._kw
        routed = sweep_route(angles, L=kw["L"], T=kw["T"], q=kw["q"],
                             dtype_name=kw["dtype_name"], has_y=kw["has_y"],
                             echo=echo)
        if routed[0] not in self._logged:
            self._logged.add(routed[0])
            log.info("adaptive_sweep: engine=%s pol=%s L=%d T=%d", routed[0],
                     self.cfg.polarization, kw["L"], kw["T"])
        return angles, routed

    def reset(self):
        self._g[:] = self.cfg.g
        return 0

    def advance(self, states, g_value, time_step, key):
        self._g[time_step] = g_value
        return states + 1

    def forward_value(self, states) -> float:
        vals = _batch_values(self._h, self._ph,
                             *self._angles(self._g, echo=False), self._u_f,
                             self._kw)
        return float(vals[0, :, states].mean())

    def echo_value(self, states_prev, g_schedule, g_last, t_next,
                   key) -> float:
        g_full = np.array(self._g)
        g_full[: len(g_schedule)] = g_schedule
        g_full[t_next - 1] = g_last
        vals = _batch_values(self._h, self._ph,
                             *self._angles(g_full, echo=True), self._u_e,
                             self._kw, ts=torch.tensor([t_next],
                                                       device=self.device))
        return float(vals[0, :, 0].mean())


def make_stepper(cfg, hs_row, phis_row, *, n_traj=None, seed=None,
                 device="cuda", mode: str = "auto"):
    """The stepper for this config and device: "kernel", "carried", or
    "auto" (module doc)."""
    if mode not in ("auto", "kernel", "carried"):
        raise ValueError(f"unknown stepper mode {mode!r}")
    dev = resolve_device(device)
    use_kernel = mode == "kernel" or (
        mode == "auto" and dev.type == "cuda" and cfg.dtype == "complex64"
        and stepper_engine(cfg) in ("resident", "general"))
    if use_kernel:
        return KernelAdaptiveStepper(cfg, hs_row, phis_row, n_traj=n_traj,
                                     seed=seed, device=dev)
    return AdaptiveStepper(cfg, hs_row, phis_row, n_traj=n_traj, device=dev)


# ---------------------------------------------------------------------------
# optimizers


def golden_section_minimize(f, lo, hi, iters=20):
    """Fixed-iteration golden-section minimizer (deterministic)."""
    invphi = (np.sqrt(5) - 1) / 2
    a, b = lo, hi
    c = b - invphi * (b - a)
    d = a + invphi * (b - a)
    fc, fd = f(c), f(d)
    for _ in range(iters):
        if fc < fd:
            b, d, fd = d, c, fc
            c = b - invphi * (b - a)
            fc = f(c)
        else:
            a, c, fc = c, d, fd
            d = a + invphi * (b - a)
            fd = f(d)
    return (a + b) / 2


def grid_search_minimize(f, lo, hi, num_points=10):
    gs = np.linspace(lo, hi, num_points)
    vals = [f(g) for g in gs]
    return float(gs[int(np.argmin(vals))])


def optimize_g_for_target_echo(stepper, states_prev, g_schedule, t,
                               target_echo, g_min, g_max, key, *,
                               method="bounded", iters=20):
    """argmin_g (echo(t+1; g_hist[0..t-1] + [g]) - target)^2."""

    def objective(g_cand):
        e = stepper.echo_value(states_prev, g_schedule, float(g_cand), t + 1,
                               key)
        return (e - target_echo) ** 2

    if method == "bounded":
        from scipy.optimize import minimize_scalar

        res = minimize_scalar(objective, bounds=(g_min, g_max),
                              method="bounded")
        if res.success:
            return float(res.x)
        return grid_search_minimize(objective, g_min, g_max)
    if method == "golden":
        return float(golden_section_minimize(objective, g_min, g_max, iters))
    return grid_search_minimize(objective, g_min, g_max)


# ---------------------------------------------------------------------------
# runs


def _folder(cfg, out_dir):
    return out_dir or f"controlled-autocorr_data_L{cfg.L}"


def _batch_values(h, ph, angles, routed, uniforms, kw,
                  ts=None) -> np.ndarray:
    """One instance's forward values (1, n_traj, T), or with ``ts`` its echo
    values (1, n_traj, len(ts)), on the route ``routed`` (``sweep_route``'s
    (route, theta) of ``angles``), in launches of at most
    ``routes.launch_states`` states (``kernel_chunks``: t values kept
    together first, then trajectories)."""
    n_traj = kw["n_traj"]
    _, chunk, t_chunk = kernel_chunks(1, n_traj, 1 if ts is None else len(ts),
                                      kw["L"])
    route, theta = routed
    parts = []
    for d in range(0, n_traj, chunk):
        sub = dict(kw, n_traj=min(chunk, n_traj - d), route=route,
                   theta=theta)
        u = None if uniforms is None else uniforms[:, d:d + chunk]
        if ts is None:
            parts.append(_forward_batch(h, ph, angles, u, **sub).cpu().numpy())
            continue
        parts.append(np.concatenate(
            [_echo_batch(h, ph, angles, ts[i:i + t_chunk], u, **sub)
             .cpu().numpy() for i in range(0, len(ts), t_chunk)], axis=-1))
    return np.concatenate(parts, axis=1)


def run_adaptive_realtime(cfg, hs=None, phis=None, *, device="cuda",
                          out_dir=None, disorder_dir=None, write=True,
                          optimizer_method="golden",
                          realtime_csv: bool = False,
                          compare_g_high: float = 0.97,
                          mode: str = "auto") -> dict:
    """Real-time causal adaptive-g loop + fixed-g standard comparisons.

    The row at time index t corresponds to t+1 applied cycles. With
    realtime_csv, each completed timestep is appended and flushed to a
    per-instance CSV. ``mode`` picks the stepper (``make_stepper``)."""
    _refuse_fakebackend(cfg)
    if hs is None or phis is None:
        hs, phis = get_disorder(cfg, disorder_dir)
    dev = resolve_device(device)
    T = cfg.tf
    all_fwd, all_echo, all_g = [], [], []
    for i in range(cfg.inst):
        rt_writer = None
        if realtime_csv and write:
            # resume=False: this loop always recomputes from t=0, so a
            # rerun must overwrite, not append duplicate rows
            rt_writer = csvio.RealtimeCSVWriter(
                os.path.join(_folder(cfg, out_dir),
                             f"adaptive_realtime_inst{i+1}_"
                             + naming.adaptive_csv_name(cfg)),
                ["time", "g", "forward", "echo"], resume=False)
        seed = cfg.seed + 101 * i
        stepper = make_stepper(cfg, hs[i], phis[i], seed=seed, device=dev,
                               mode=mode)
        # the carried stepper's noise; the kernel stepper's is fixed
        key = torch.Generator(device=dev).manual_seed(seed)
        states_prev = stepper.reset()
        g_schedule = np.full(T, cfg.g)
        current_g = cfg.g
        fwd, ech, ghist = [], [], []
        for t in range(T):
            g_schedule[t] = current_g
            ghist.append(current_g)
            states = stepper.advance(states_prev, current_g, t, key)
            fwd.append(stepper.forward_value(states))
            ech.append(stepper.echo_value(states_prev, g_schedule, current_g,
                                          t + 1, key))
            if rt_writer is not None:
                rt_writer.write_row({"time": t, "g": float(current_g),
                                     "forward": fwd[-1], "echo": ech[-1]})
            if t < T - 1:
                if cfg.use_optimization:
                    current_g = optimize_g_for_target_echo(
                        stepper, states_prev, g_schedule, t, cfg.target_echo,
                        cfg.g_min, cfg.g_max, key, method=optimizer_method,
                        iters=max(cfg.optimization_iterations * 3, 12),
                    )
                elif cfg.exponential_feedback:
                    current_g = exponential_g_adjustment(
                        ech[-1], cfg.target_echo, current_g, t,
                        cfg.feedback_gain, cfg.decay_compensation,
                        cfg.g_min, cfg.g_max)
                else:
                    current_g = linear_g_adjustment(
                        ech[-1], cfg.target_echo, current_g,
                        cfg.feedback_gain, cfg.g_min, cfg.g_max)
            states_prev = states
        if rt_writer is not None:
            rt_writer.close()
        all_fwd.append(fwd)
        all_echo.append(ech)
        all_g.append(ghist)

    all_fwd = guard("adaptive_forward", np.asarray(all_fwd), bound=1.0)
    all_echo = guard("adaptive_echo", np.asarray(all_echo), bound=1.0)
    all_g = np.asarray(all_g)

    # fixed-g standard comparisons (same seeds): the initial g and the
    # reference's high comparison g=0.97, labelled g84 / g97 whatever the
    # initial g is
    std = run_fixed_g(cfg, hs, phis, device=dev)
    std97 = run_fixed_g(cfg, hs, phis, g_value=compare_g_high, device=dev)

    av_fwd_a = all_fwd.mean(axis=0)
    av_echo_a = all_echo.mean(axis=0)
    av_fwd_84 = std["forward"].mean(axis=0)
    av_echo_84 = std["echo"].mean(axis=0)
    av_fwd_97 = std97["forward"].mean(axis=0)
    av_echo_97 = std97["echo"].mean(axis=0)
    data = {
        "time": np.arange(T),
        "av_autocorr_adaptive": av_fwd_a,
        "av_autocorr_echo_adaptive": av_echo_a,
        "av_g_values": all_g.mean(axis=0),
        "av_autocorr_standard": av_fwd_84,
        "av_autocorr_echo_standard": av_echo_84,
        "av_autocorr_standard_g84": av_fwd_84,
        "av_autocorr_echo_standard_g84": av_echo_84,
        "av_autocorr_standard_g97": av_fwd_97,
        "av_autocorr_echo_standard_g97": av_echo_97,
        "sqrt_av_autocorr_echo_adaptive": np.sqrt(np.abs(av_echo_a)),
        "sqrt_av_autocorr_echo_standard": np.sqrt(np.abs(av_echo_84)),
        "sqrt_av_autocorr_echo_standard_g84": np.sqrt(np.abs(av_echo_84)),
        "sqrt_av_autocorr_echo_standard_g97": np.sqrt(np.abs(av_echo_97)),
    }
    for label, f_sig, e_sig in (("adaptive", av_fwd_a, av_echo_a),
                                ("g84", av_fwd_84, av_echo_84),
                                ("g97", av_fwd_97, av_echo_97)):
        uf, lf = find_envelope(f_sig, window_size=3)
        ue, le = find_envelope(e_sig, window_size=3)
        data[f"upper_env_{label}_forward"] = uf
        data[f"lower_env_{label}_forward"] = lf
        data[f"upper_env_{label}_echo"] = ue
        data[f"lower_env_{label}_echo"] = le
    for i in range(cfg.inst):
        data[f"g_history_inst{i+1}"] = all_g[i]
        data[f"echo_adaptive_inst{i+1}"] = all_echo[i]
        data[f"forward_adaptive_inst{i+1}"] = all_fwd[i]
        data[f"echo_standard_g84_inst{i+1}"] = std["echo"][i]
        data[f"forward_standard_g84_inst{i+1}"] = std["forward"][i]
        data[f"echo_standard_g97_inst{i+1}"] = std97["echo"][i]
        data[f"forward_standard_g97_inst{i+1}"] = std97["forward"][i]

    result = dict(data)
    result.update(g_history=all_g, echo=all_echo, forward=all_fwd)
    if write:
        folder = _folder(cfg, out_dir)
        path = os.path.join(folder, naming.adaptive_csv_name(cfg))
        csvio.write_columns(path, data)
        ghist_cols = {}
        for i in range(cfg.inst):
            ghist_cols[f"inst{i+1}_g_values"] = all_g[i]
            ghist_cols[f"inst{i+1}_echo_values"] = all_echo[i]
        gpath = os.path.join(folder, naming.g_history_csv_name(cfg))
        csvio.write_columns(gpath, ghist_cols)
        comp = {
            "time": np.arange(T),
            "av_g_values": all_g.mean(axis=0),
            "av_echo_adaptive": av_echo_a,
            "av_echo_g84": av_echo_84,
            "av_echo_g97": av_echo_97,
            "av_forward_adaptive": av_fwd_a,
            "av_forward_g84": av_fwd_84,
            "av_forward_g97": av_fwd_97,
        }
        for i in range(cfg.inst):
            comp[f"inst{i+1}_g_values"] = all_g[i]
            comp[f"inst{i+1}_echo_adaptive"] = all_echo[i]
            comp[f"inst{i+1}_echo_g84"] = std["echo"][i]
            comp[f"inst{i+1}_echo_g97"] = std97["echo"][i]
        cpath = os.path.join(folder, naming.adaptive_comparison_csv_name(cfg))
        csvio.write_columns(cpath, comp)
        result["csv_path"] = path
        result["g_history_csv_path"] = gpath
        result["comparison_csv_path"] = cpath
    return result


def run_fixed_g(cfg, hs, phis, g_value=None, *, device="cuda") -> dict:
    """Fixed-g forward + echo with the t+1-cycle row convention: one forward
    batch and one echo batch (t = 1..T) per instance over T+1 cycles."""
    _refuse_fakebackend(cfg)
    g = cfg.g if g_value is None else g_value
    T = cfg.tf
    dev = resolve_device(device)
    noise = NoiseSpec(p=cfg.noise_p)
    p = noise.p
    af = noise.ancilla_factor if p > 0 else 1.0
    n_traj = cfg.n_trajectories if p > 0 else 1
    sched = build_kick_schedule(
        cfg.polarization, g, T + 1,
        circular_frequency=cfg.circular_frequency,
        xy_cycle_period=cfg.xy_cycle_period, device=dev)
    kw = dict(L=cfg.L, T=T + 1, K=sched.K, p=p, q=cfg.probe_qubit,
              initial_state=cfg.initial_state, dtype_name=cfg.dtype,
              ancilla_factor=af, has_y=cfg.polarization != "x",
              n_traj=n_traj)
    shape = dict(L=cfg.L, T=T + 1, q=cfg.probe_qubit, dtype_name=cfg.dtype,
                 has_y=kw["has_y"])
    routed = {echo: sweep_route(sched.angles, echo=echo, **shape)
              for echo in (False, True)}
    for sweep, echo in (("forward", False), ("echo", True)):
        log.info("fixed_g_%s_sweep: engine=%s pol=%s L=%d T=%d g=%s", sweep,
                 routed[echo][0], cfg.polarization, cfg.L, T + 1, g)
    ts = torch.arange(1, T + 1, device=dev)
    fwd = np.zeros((cfg.inst, T))
    ech = np.zeros((cfg.inst, T))
    steps = (T + 1) * sched.K
    for i in range(cfg.inst):
        h, ph = _row(hs[i], cfg.L, dev), _row(phis[i], cfg.L - 1, dev)
        uf, ue = (instance_uniforms(cfg.seed + 977 * i, n_traj,
                                    ((steps, cfg.L), (2 * steps, cfg.L)), dev)
                  if p > 0 else (None, None))
        f = guard("fixed_g_forward", _batch_values(
            h, ph, sched.angles, routed[False], uf, kw),
            bound=1.0).mean(axis=1)[0]
        fwd[i] = f[1:]  # row t = A(t+1)
        ech[i] = guard("fixed_g_echo", _batch_values(
            h, ph, sched.angles, routed[True], ue, kw, ts=ts),
            bound=1.0).mean(axis=1)[0]
    return {"forward": fwd, "echo": ech}


def run_adaptive_batch(cfg, hs=None, phis=None, *, device="cuda",
                       out_dir=None, disorder_dir=None, write=True) -> dict:
    """Non-causal batch control: an echo pass with the initial schedule,
    the whole schedule adjusted at once from it, then a forward run with
    the adjusted per-cycle schedule."""
    _refuse_fakebackend(cfg)
    if hs is None or phis is None:
        hs, phis = get_disorder(cfg, disorder_dir)
    dev = resolve_device(device)
    T = cfg.tf
    noise = NoiseSpec(p=cfg.noise_p)
    p = noise.p
    af = noise.ancilla_factor if p > 0 else 1.0
    n_traj = cfg.n_trajectories if p > 0 else 1

    def schedule_angles(schedule):
        # per-cycle x-kick angles (T, 1, 2) in f32: theta_x = pi * g_t
        ang = np.zeros((T, 1, 2), dtype=np.float32)
        ang[:, 0, 0] = np.pi * np.asarray(schedule)
        return torch.as_tensor(ang, device=dev)

    kw = dict(L=cfg.L, T=T, K=1, p=p, q=cfg.probe_qubit,
              initial_state=cfg.initial_state, dtype_name=cfg.dtype,
              ancilla_factor=af, has_y=False, n_traj=n_traj)
    shape = dict(L=cfg.L, T=T, q=cfg.probe_qubit, dtype_name=cfg.dtype,
                 has_y=False)
    ts = torch.arange(1, T + 1, device=dev)
    g0 = np.full(T, cfg.g)
    echo_routed = sweep_route(schedule_angles(g0), echo=True, **shape)
    log.info("adaptive_batch_echo_sweep: engine=%s pol=x L=%d T=%d",
             echo_routed[0], cfg.L, T)
    all_fwd, all_echo, all_g = [], [], []
    for i in range(cfg.inst):
        h, ph = _row(hs[i], cfg.L, dev), _row(phis[i], cfg.L - 1, dev)
        u_echo, u_fwd = (instance_uniforms(cfg.seed + 31 * i, n_traj,
                                           ((2 * T, cfg.L), (T, cfg.L)), dev)
                         if p > 0 else (None, None))
        # echo pass with the initial schedule: echo_vals[t] = A0(t+1)
        echo_vals = guard("adaptive_batch_echo", _batch_values(
            h, ph, schedule_angles(g0), echo_routed, u_echo, kw, ts=ts),
            bound=1.0).mean(axis=1)[0]
        adj = adjust_g_schedule(echo_vals, g0, cfg.target_echo,
                                cfg.feedback_gain, cfg.g_min, cfg.g_max)
        angles = schedule_angles(adj)
        routed = sweep_route(angles, echo=False, **shape)
        log.info("adaptive_batch_forward_sweep: engine=%s pol=x L=%d T=%d",
                 routed[0], cfg.L, T)
        fwd_vals = guard("adaptive_batch_forward", _batch_values(
            h, ph, angles, routed, u_fwd, kw), bound=1.0).mean(axis=1)[0]
        all_fwd.append(fwd_vals)
        all_echo.append(echo_vals)
        all_g.append(adj)

    result = {
        "time": np.arange(T),
        "av_autocorr_adaptive": np.mean(all_fwd, axis=0),
        "av_autocorr_echo_adaptive": np.mean(all_echo, axis=0),
        "av_g_values": np.mean(all_g, axis=0),
        "g_history": np.asarray(all_g),
    }
    if write:
        path = os.path.join(
            _folder(cfg, out_dir),
            naming.adaptive_csv_name(cfg).replace("realtime_adaptive",
                                                  "batch_adaptive"))
        csvio.write_columns(path, {k: v for k, v in result.items()
                                   if k != "g_history"})
        result["csv_path"] = path
    return result
