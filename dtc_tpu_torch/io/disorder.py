"""Disorder instances: generation and loading.

A copy of ``dtc_tpu/io/disorder.py`` (``generate_disorder``,
``disorder_filenames``, ``save_disorder``, ``load_disorder``,
``get_disorder``), drawing the same numbers from the same seed and writing
the same bytes:
- h_i ~ U[-pi, pi], shape (inst, L);
- DTC phase (randomphi=1): phi_i ~ U[0, amplitude*pi) - 1.5*pi + delta*pi,
  shape (inst, L-1); prethermal (randomphi=0): phi_i = -0.4.
CSV files have one row per instance under headers h_0.. / phi_0..; extra
trailing columns are tolerated on load.
"""

from __future__ import annotations

import os

import numpy as np


def generate_disorder(
    L: int,
    inst: int,
    *,
    phi_amplitude: float = 1.0,
    phi_delta: float = 0.0,
    randomphi: int = 1,
    seed: int | None = None,
    rng: np.random.Generator | None = None,
):
    """Sample (hs, phis) with shapes (inst, L), (inst, L-1)."""
    if rng is None:
        rng = np.random.default_rng(seed)
    hs = rng.uniform(-np.pi, np.pi, size=(inst, L))
    if randomphi == 1:
        phis = (
            rng.uniform(0.0, phi_amplitude * np.pi, size=(inst, L - 1))
            - 1.5 * np.pi
            + phi_delta * np.pi
        )
    else:
        phis = np.full((inst, L - 1), -0.4)
    return hs, phis


def disorder_filenames(
    L, inst, phi_amplitude=1.0, phi_delta=0.0, randomphi=1, folder="."
):
    hs = f"{folder}/hs_L{L}_inst{inst}_ampl{phi_amplitude}_delta{phi_delta}_randomphi{randomphi}.csv"
    phis = f"{folder}/phis_L{L}_inst{inst}_ampl{phi_amplitude}_delta{phi_delta}_randomphi{randomphi}.csv"
    return hs, phis


def save_disorder(hs: np.ndarray, phis: np.ndarray, hs_path: str, phis_path: str):
    os.makedirs(os.path.dirname(hs_path) or ".", exist_ok=True)
    _write_csv(hs_path, hs, "h")
    _write_csv(phis_path, phis, "phi")


def _write_csv(path: str, arr: np.ndarray, prefix: str):
    header = ",".join(f"{prefix}_{i}" for i in range(arr.shape[1]))
    with open(path, "w") as f:
        f.write(header + "\n")
        for row in arr:
            f.write(",".join(repr(float(v)) for v in row) + "\n")


def _read_csv(path: str) -> np.ndarray:
    with open(path) as f:
        rows = [ln.strip() for ln in f if ln.strip() and not ln.startswith("#")]
    data = [[float(v) for v in ln.split(",") if v != ""] for ln in rows[1:]]
    width = min(len(r) for r in data)
    return np.asarray([r[:width] for r in data])


def load_disorder(hs_path: str, phis_path: str, L: int, inst: int):
    """Load first `inst` rows, first L (resp. L-1) columns."""
    hs = _read_csv(hs_path)[:inst, :L]
    phis = _read_csv(phis_path)[:inst, : L - 1]
    if hs.shape != (inst, L) or phis.shape != (inst, L - 1):
        raise ValueError(
            f"disorder files too small: got hs{hs.shape}, phis{phis.shape}, "
            f"need ({inst},{L}) / ({inst},{L-1})"
        )
    return hs, phis


def get_disorder(cfg, folder: str | None = None):
    """Load `hs_L{L}.csv`/`phis_L{L}.csv` from ``folder`` if present, else
    generate deterministically from cfg.seed."""
    if folder is not None:
        hp = os.path.join(folder, f"hs_L{cfg.L}.csv")
        pp = os.path.join(folder, f"phis_L{cfg.L}.csv")
        if os.path.exists(hp) and os.path.exists(pp):
            return load_disorder(hp, pp, cfg.L, cfg.inst)
    return generate_disorder(
        cfg.L,
        cfg.inst,
        phi_amplitude=cfg.phi_amplitude,
        phi_delta=cfg.phi_delta,
        randomphi=cfg.randomphi,
        seed=cfg.seed,
    )
