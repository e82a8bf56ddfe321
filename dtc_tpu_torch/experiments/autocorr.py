"""Autocorrelation sweep experiment.

Port of ``dtc_tpu/experiments/autocorr.py`` (``run_autocorr``, trajectory
method): forward + echo interferometric autocorrelator averaged over
disorder instances, CSV schema
``time, av_autocorr, av_autocorr_echo, sqrt_av_autocorr_echo`` (+6 envelope
columns when requested), under the reference's file names.
"""

from __future__ import annotations

import os

import numpy as np

from dtc_tpu.analysis.envelope import find_envelope
from dtc_tpu.io import csvio, naming
from dtc_tpu.io.disorder import get_disorder
from dtc_tpu.utils.profiling import phase_timer
from dtc_tpu_torch.experiments.engine import (
    apply_shot_noise,
    build_context,
    echo_sweep,
    forward_sweep,
)


def _raw_sqrt(x):
    """np.sqrt without clamping: a negative averaged echo records NaN in the
    contract column, as the reference's base schema does."""
    with np.errstate(invalid="ignore"):
        return np.sqrt(np.asarray(x, dtype=float))


def run_autocorr(cfg, hs=None, phis=None, *, device="cuda", out_dir=None,
                 disorder_dir=None, with_envelopes: bool = False, write=True,
                 method: str = "trajectories", uniforms=None) -> dict:
    """Run the forward + echo sweep on ``device``; returns the result dict
    and writes the CSV.

    uniforms: optional (forward, echo) pair of f32 blocks,
    (inst, n_traj, T*K, L) and (inst, n_traj, 2T*K, L); drawn from
    generators seeded with cfg.seed when None.
    """
    if method == "exact":
        raise NotImplementedError(
            "method='exact' (density-matrix superoperator) is not ported yet:"
            " ROADMAP.md queue 1, item 5 (core/density.py)")
    if method != "trajectories":
        raise ValueError(f"unknown method {method!r}")
    if cfg.use_fakebackend:
        raise NotImplementedError(
            "use_fakebackend=1 (device noise) is not ported yet: ROADMAP.md"
            " queue 1, item 9 (core/device_evolve.py)")
    if hs is None or phis is None:
        hs, phis = get_disorder(cfg, disorder_dir)
    sched, params, noise = build_context(cfg, hs, phis, device=device)
    u_fwd, u_echo = uniforms if uniforms is not None else (None, None)

    with phase_timer("forward"):
        autocorr = forward_sweep(cfg, sched, params, noise, uniforms=u_fwd)
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
    return result
