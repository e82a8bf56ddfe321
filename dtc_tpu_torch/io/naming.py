"""Config-encoded file names of the autocorrelator and energy results.

A copy of the autocorr and energy names of ``dtc_tpu/io/naming.py``
(``autocorr_csv_name``, ``autocorr_comparison_csv_name``,
``autocorr_folder_name``, ``energy_csv_name``, ``energy_folder_name``);
the file name is the experiment's config key:
autocorr_data_{state}_g{g}_L{L}_inst{inst}_tf{tf}_randomphi{r}_delta{d}
_amplitude{A}_noise{p}_usenoise{u}[_pol{pol}][_with_envelopes].csv
"""

from __future__ import annotations


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
