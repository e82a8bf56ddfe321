"""Config-encoded file names of the autocorrelator, energy and adaptive
results.

A copy of the autocorr, energy and adaptive names of
``dtc_tpu/io/naming.py`` (``autocorr_csv_name``,
``autocorr_comparison_csv_name``, ``autocorr_folder_name``,
``energy_csv_name``, ``energy_folder_name``, ``adaptive_csv_name``,
``adaptive_comparison_csv_name``, ``g_history_csv_name``), the gate-count
names (``gate_count_csv_name``, whose ``backend="dtc_tpu"`` default is part
of the file name) and their inverse, ``parse_config_from_name``; the file
name is the experiment's config key:
autocorr_data_{state}_g{g}_L{L}_inst{inst}_tf{tf}_randomphi{r}_delta{d}
_amplitude{A}_noise{p}_usenoise{u}[_pol{pol}][_with_envelopes].csv
autocorr_data_{state}_realtime_adaptive[_optimization_iterN|_expD|_linear]
_g{g}_L{L}_inst{inst}_randomphi{r}_delta{d}_amplitude{A}_noise{p}
_usenoise{u}_target{T}_gain{G}.csv
"""

from __future__ import annotations

import os
import re


def _base(cfg) -> str:
    return f"g{cfg.g}_L{cfg.L}_inst{cfg.inst}"


def _suffix(cfg) -> str:
    return (
        f"randomphi{cfg.randomphi}_delta{cfg.phi_delta}_amplitude{cfg.phi_amplitude}"
        f"_noise{cfg.noise_prob}_usenoise{cfg.use_noise}"
    )


def autocorr_csv_name(cfg, *, pol: str | None = None,
                      with_envelopes: bool = False) -> str:
    name = (
        f"autocorr_data_{cfg.initial_state}_{_base(cfg)}_tf{cfg.tf}_{_suffix(cfg)}"
    )
    if pol:
        name += f"_pol{pol}"
    if with_envelopes:
        name += "_with_envelopes"
    return name + ".csv"


def autocorr_comparison_csv_name(cfg, with_envelopes: bool = True) -> str:
    name = f"autocorr_data_comparison_{cfg.initial_state}_{_base(cfg)}_{_suffix(cfg)}"
    if with_envelopes:
        name += "_with_envelopes"
    return name + ".csv"


def autocorr_folder_name(cfg) -> str:
    return (f"autocorr_data_L{cfg.L}_noiseprob{cfg.noise_prob}"
            f"_fakebackend{cfg.use_fakebackend}")


def energy_csv_name(cfg) -> str:
    return f"energy_data_{cfg.initial_state}_{_base(cfg)}_{_suffix(cfg)}.csv"


def energy_folder_name(cfg) -> str:
    return f"energy-data_L{cfg.L}-full-ham"


def adaptive_csv_name(cfg) -> str:
    if cfg.use_optimization:
        method = f"_optimization_iter{cfg.optimization_iterations}"
    elif cfg.exponential_feedback:
        method = f"_exp{cfg.decay_compensation}"
    else:
        method = "_linear"
    return (
        f"autocorr_data_{cfg.initial_state}_realtime_adaptive{method}_{_base(cfg)}"
        f"_{_suffix(cfg)}_target{cfg.target_echo}_gain{cfg.feedback_gain}.csv"
    )


def adaptive_comparison_csv_name(cfg) -> str:
    """comparison_{state}_adaptive_{method}_vs_fixed_g{g0}_L{L}_inst{n}_
    target{t}_gain{gain}.csv — the adaptive-vs-fixed comparison file."""
    if cfg.use_optimization:
        method = "optimization"
    elif cfg.exponential_feedback:
        method = "exponential"
    else:
        method = "linear"
    return (f"comparison_{cfg.initial_state}_adaptive_{method}_vs_fixed_"
            f"g{cfg.g}_L{cfg.L}_inst{cfg.inst}_target{cfg.target_echo}"
            f"_gain{cfg.feedback_gain}.csv")


def g_history_csv_name(cfg) -> str:
    return (
        f"g_history_{cfg.initial_state}_realtime_g{cfg.g}_L{cfg.L}_inst{cfg.inst}"
        f"_target{cfg.target_echo}_gain{cfg.feedback_gain}.csv"
    )


def gate_count_csv_name(t: int, echo: bool, *, opt_level: int = 0,
                        backend: str = "dtc_tpu", tag: str = "") -> str:
    echo_str = "echo" if echo else "forward"
    name = f"gate_counts_t{t}_{echo_str}_opt{opt_level}_{backend}"
    if tag:
        name += f"_{tag}"
    return name + ".csv"


def parse_config_from_name(path: str) -> dict:
    """Inverse of the encoders above: the config key of a file name.

    Returns a dict with whatever tokens are present; numeric values are
    parsed. The draw commands pair and grid data sets by these tokens.
    """
    stem = os.path.basename(path)
    stem = stem.rsplit(".", 1)[0]
    out: dict = {}
    m = re.match(r"(autocorr_data|energy_data|g_history)_(comparison_)?([a-z]+)_",
                 stem)
    if m:
        out["kind"] = m.group(1)
        out["initial_state"] = m.group(3)
    if "_realtime_adaptive" in stem:
        out["adaptive"] = True
        am = re.search(r"_realtime_adaptive_(optimization_iter(\d+)|exp([\d.eE+-]+)|linear)",
                       stem)
        if am:
            if am.group(2) is not None:
                out["method"] = "optimization"
                out["optimization_iterations"] = int(am.group(2))
            elif am.group(3) is not None:
                out["method"] = "exponential"
                out["decay_compensation"] = float(am.group(3))
            else:
                out["method"] = "linear"
    num = r"(-?[\d.]+(?:[eE][+-]?\d+)?)"
    for token, key, cast in [
        ("g", "g", float), ("L", "L", int), ("inst", "inst", int),
        ("tf", "tf", int), ("randomphi", "randomphi", int),
        ("delta", "phi_delta", float), ("amplitude", "phi_amplitude", float),
        ("noise", "noise_prob", float), ("usenoise", "use_noise", int),
        ("target", "target_echo", float), ("gain", "feedback_gain", float),
    ]:
        tm = re.search(rf"_{token}{num}(?=_|$)", stem)
        if tm:
            out[key] = cast(tm.group(1))
    pm = re.search(r"_pol([a-z_]+?)(?:_with_envelopes)?$", stem)
    if pm:
        out["polarization"] = pm.group(1)
    out["with_envelopes"] = stem.endswith("_with_envelopes")
    return out
