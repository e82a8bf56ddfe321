"""Autocorrelation sweep experiments.

Port of ``dtc_tpu/experiments/autocorr.py``: ``run_autocorr`` (trajectory
and exact methods), forward + echo interferometric autocorrelator averaged
over disorder instances, CSV schema
``time, av_autocorr, av_autocorr_echo, sqrt_av_autocorr_echo`` (+6 envelope
columns when requested); and the studies built on it,
``run_polarization_comparison``, ``run_shots_study`` and
``run_xy_cycle_comparison``, with the reference's CSV columns and file
names; ``run_autocorr(emit_gate_counts=True)`` also writes the per-t
gate-count CSVs, and ``run_xy_cycle_comparison`` its figure where
matplotlib is installed (else it logs a warning, and the CSV is written
all the same). ``use_fakebackend=1`` takes the
device-noise sweeps (``experiments/device_sweeps.py``) in ``run_autocorr``,
and so in ``run_polarization_comparison`` and ``run_xy_cycle_comparison``,
as the reference's does. ``run_shots_study`` refuses it: the reference's
runs depolarizing noise under the flag (ROADMAP.md queue 3).
"""

from __future__ import annotations

import logging
import os

import numpy as np

from dtc_tpu_torch.analysis.envelope import find_envelope
from dtc_tpu_torch.core.density import (
    dm_autocorr_echo_run,
    dm_autocorr_forward_run,
)
from dtc_tpu_torch.device.transpile import write_gate_count_csv
from dtc_tpu_torch.io import csvio, naming
from dtc_tpu_torch.io.disorder import get_disorder
from dtc_tpu_torch.utils.profiling import phase_timer, span
from dtc_tpu_torch.experiments.device_sweeps import (
    device_echo_sweep,
    device_forward_sweep,
)
from dtc_tpu_torch.experiments.engine import (
    apply_shot_noise,
    build_context,
    echo_sweep,
    forward_sweep,
)

log = logging.getLogger("dtc_tpu_torch")


def _raw_sqrt(x):
    """np.sqrt without clamping: a negative averaged echo records NaN in the
    contract column, as the reference's base schema does."""
    with np.errstate(invalid="ignore"):
        return np.sqrt(np.asarray(x, dtype=float))


def _refuse_fakebackend(cfg) -> None:
    if cfg.use_fakebackend:
        raise NotImplementedError(
            "use_fakebackend=1 (device noise) is refused by the shots study:"
            " the reference's runs depolarizing noise under the flag"
            " (ROADMAP.md queue 3)")


def _exact_sweeps(cfg, sched, params, noise):
    """(forward, echo) (inst, T) of the exact density-matrix mode, one
    instance at a time; the noiseless echo is exactly 1."""
    hs, phis = params
    kw = dict(L=cfg.L, T=cfg.tf, K=sched.K, p=noise.p, q=cfg.probe_qubit,
              initial_state=cfg.initial_state, dtype_name=cfg.dtype,
              ancilla_factor=noise.ancilla_factor if noise.p > 0 else 1.0)
    autocorr = np.stack([
        dm_autocorr_forward_run(hs[i], phis[i], sched.angles, **kw)
        .cpu().numpy() for i in range(cfg.inst)])
    if noise.p == 0:
        return autocorr, np.ones((cfg.inst, cfg.tf))
    ts = range(cfg.tf)
    echo = np.stack([
        dm_autocorr_echo_run(hs[i], phis[i], sched.angles, ts, **kw)
        .cpu().numpy() for i in range(cfg.inst)])
    return autocorr, echo


@span("dtc.driver.autocorr")
def run_autocorr(cfg, hs=None, phis=None, *, device="cuda", out_dir=None,
                 disorder_dir=None, with_envelopes: bool = False, write=True,
                 method: str = "trajectories", emit_gate_counts=False,
                 uniforms=None) -> dict:
    """Run the forward + echo sweep on ``device``; returns the result dict
    and writes the CSV.

    method: "trajectories" (Pauli-twirl trajectories, any L) or "exact"
    (the density-matrix superoperator, ``core/density.py``: 4^L amplitudes,
    L <= 13 in the reference's CLI; it ignores ``use_fakebackend`` and
    ``uniforms``, as the reference's ignores its key).
    emit_gate_counts: with ``write``, also the gate-count CSVs of every t
    < tf, forward and echo, beside the result CSV.
    uniforms: optional (forward, echo) pair of f32 blocks,
    (inst, n_traj, T*K, L) and (inst, n_traj, 2T*K, L); drawn from
    generators seeded with cfg.seed when None. With ``use_fakebackend=1``
    the sweeps are the device-noise ones and the blocks theirs
    (``experiments/device_sweeps.py``).
    """
    if method not in ("trajectories", "exact"):
        raise ValueError(f"unknown method {method!r}")
    if hs is None or phis is None:
        hs, phis = get_disorder(cfg, disorder_dir)
    sched, params, noise = build_context(cfg, hs, phis, device=device)
    u_fwd, u_echo = uniforms if uniforms is not None else (None, None)

    if method == "exact":
        with phase_timer("exact"):
            autocorr, echo = _exact_sweeps(cfg, sched, params, noise)
    elif cfg.use_fakebackend:
        with phase_timer("forward(device)"):
            autocorr = device_forward_sweep(cfg, sched, params,
                                            uniforms=u_fwd)
        with phase_timer("echo(device)"):
            echo = device_echo_sweep(cfg, sched, params, uniforms=u_echo)
    else:
        with phase_timer("forward"):
            autocorr = forward_sweep(cfg, sched, params, noise,
                                     uniforms=u_fwd)
        with phase_timer("echo"):
            echo = echo_sweep(cfg, sched, params, noise, uniforms=u_echo)

    if cfg.shots:
        autocorr = apply_shot_noise(autocorr, cfg.shots, cfg.seed)
        echo = apply_shot_noise(echo, cfg.shots, cfg.seed + 1)

    av = autocorr.mean(axis=0)
    av_echo = echo.mean(axis=0)
    data = {
        "time": np.arange(cfg.tf),
        "av_autocorr": av,
        "av_autocorr_echo": av_echo,
        "sqrt_av_autocorr_echo": _raw_sqrt(av_echo),
    }
    if with_envelopes:
        fu, fl = find_envelope(av)
        eu, el = find_envelope(av_echo)
        su, sl = find_envelope(data["sqrt_av_autocorr_echo"])
        data.update(
            forward_upper_env=fu, forward_lower_env=fl,
            echo_upper_env=eu, echo_lower_env=el,
            sqrt_echo_upper_env=su, sqrt_echo_lower_env=sl,
        )

    result = dict(data)
    result["autocorr_per_instance"] = autocorr
    result["echo_per_instance"] = echo
    if write:
        folder = out_dir or naming.autocorr_folder_name(cfg)
        pol = cfg.polarization if cfg.polarization != "x" else None
        path = os.path.join(folder, naming.autocorr_csv_name(
            cfg, pol=pol, with_envelopes=with_envelopes))
        csvio.write_columns(path, data)
        result["csv_path"] = path
        if emit_gate_counts:
            for t in range(cfg.tf):
                for echo_flag in (False, True):
                    write_gate_count_csv(
                        os.path.join(folder, naming.gate_count_csv_name(
                            t, echo_flag)), cfg.L, t, echo=echo_flag,
                        polarization=cfg.polarization)
    return result


def run_polarization_comparison(cfg, polarizations=("x", "y", "xy", "yx"), *,
                                device="cuda", out_dir=None,
                                disorder_dir=None, write=True) -> dict:
    """One forward + echo sweep (with envelopes) per polarization, and the
    merged comparison CSV: ``time`` then nine columns per polarization."""
    merged = {"time": np.arange(cfg.tf)}
    per_pol = {}
    for pol in polarizations:
        r = run_autocorr(cfg.replace(polarization=pol), device=device,
                         out_dir=out_dir, disorder_dir=disorder_dir,
                         with_envelopes=True, write=write)
        per_pol[pol] = r
        for key in ("av_autocorr", "av_autocorr_echo", "sqrt_av_autocorr_echo",
                    "forward_upper_env", "forward_lower_env",
                    "echo_upper_env", "echo_lower_env", "sqrt_echo_upper_env",
                    "sqrt_echo_lower_env"):
            merged[f"{key}_{pol}"] = r[key]
    if write:
        folder = out_dir or f"autocorr_data_L{cfg.L}_polarization"
        path = os.path.join(folder, naming.autocorr_comparison_csv_name(cfg))
        csvio.write_columns(path, merged)
        merged["csv_path"] = path
    merged["per_polarization"] = per_pol
    return merged


def run_shots_study(cfg, shots_list=(100, 1000, 10_000, 100_000, 1_000_000),
                    *, device="cuda", out_dir=None, disorder_dir=None,
                    write=True) -> dict:
    """Echo A0(t) under binomial shot sampling, one column per shot count."""
    _refuse_fakebackend(cfg)
    if cfg.shots:
        cfg = cfg.replace(shots=0)
    hs, phis = get_disorder(cfg, disorder_dir)
    sched, params, noise = build_context(cfg, hs, phis, device=device)
    echo = echo_sweep(cfg, sched, params, noise)
    data = {"time": np.arange(cfg.tf)}
    for s in shots_list:
        sampled = apply_shot_noise(echo, int(s), cfg.seed + int(s))
        data[f"av_autocorr_echo_shots{int(s)}"] = sampled.mean(axis=0)
    if write:
        folder = out_dir or f"autocorr_data_L{cfg.L}_shots"
        path = os.path.join(folder, naming.autocorr_csv_name(cfg).replace(
            "autocorr_data_", "autocorr_shots_"))
        csvio.write_columns(path, data)
        data["csv_path"] = path
    return data


def run_xy_cycle_comparison(cfg, *, device="cuda", out_dir=None,
                            disorder_dir=None, write=True,
                            period=None) -> dict:
    """The xy-cycle drive (kick axis flips every ``period`` cycles) against
    the pure-x drive on the same disorder: one merged CSV, and its figure
    beside it (``png_path``; None, with a warning, without matplotlib)."""
    period = period or cfg.xy_cycle_period
    hs, phis = get_disorder(cfg.replace(polarization="x"), disorder_dir)
    r_x = run_autocorr(cfg.replace(polarization="x"), hs, phis,
                       device=device, write=False)
    r_xy = run_autocorr(cfg.replace(polarization="xy_cycle",
                                    xy_cycle_period=period), hs, phis,
                        device=device, write=False)
    data = {
        "time": np.arange(cfg.tf),
        "av_autocorr_x": r_x["av_autocorr"],
        "av_autocorr_echo_x": r_x["av_autocorr_echo"],
        "av_autocorr_xy_cycle": r_xy["av_autocorr"],
        "av_autocorr_echo_xy_cycle": r_xy["av_autocorr_echo"],
    }
    result = dict(data)
    if write:
        folder = out_dir or f"autocorr_data_L{cfg.L}_xy_cycle"
        path = os.path.join(folder, naming.autocorr_csv_name(cfg).replace(
            "autocorr_data_", "autocorr_xy_cycle_"))
        csvio.write_columns(path, data)
        result["csv_path"] = path
        result["png_path"] = _xy_cycle_figure(cfg, data, path, period)
    return result


def _xy_cycle_figure(cfg, data, csv_path, period):
    """The two forward traces with the period's gridlines, as a PNG beside
    the CSV; None, with a warning, where matplotlib is not installed."""
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        log.warning("xy-cycle: matplotlib is not installed, so no figure "
                    "is drawn (the CSV is written)")
        return None
    from dtc_tpu_torch.analysis.plots import plot_xy_cycle_comparison

    return plot_xy_cycle_comparison(
        {"x": (data["time"], data["av_autocorr_x"]),
         "xy_cycle": (data["time"], data["av_autocorr_xy_cycle"])},
        csv_path.replace(".csv", ".png"), period=period,
        title=f"XY-alternating (period {period}) vs pure-X, L={cfg.L}")
