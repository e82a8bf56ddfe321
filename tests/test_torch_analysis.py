"""The port's fits, spectra, figures and their CLI against the reference.

``analysis/fft.py`` and ``analysis/fits.py`` are numpy/scipy copies: the
same arrays give the reference's results (rtol 1e-9). Each ``draw --kind``
and ``layout`` writes its PNG, and the lines they print (fit results,
minimum energies, layout paths) equal ``python -m dtc_tpu``'s; the fit-grid
CSV is byte-identical. Without matplotlib the xy-cycle study still writes
its CSV (``png_path=None``, one warning), and ``draw`` / ``layout`` raise an
ImportError naming it.
"""

import dataclasses
import filecmp
import logging
import os
import sys

import numpy as np
import pytest
import torch

from dtc_tpu.analysis import fft as j_fft
from dtc_tpu.analysis import fits as j_fits
from dtc_tpu.io import csvio
from dtc_tpu.utils.cli import main as j_cli_main
from dtc_tpu_torch.analysis import fft, fits
from dtc_tpu_torch.utils.cli import main as cli_main

torch.set_num_threads(2)
T = np.arange(30, dtype=float)
SIGNALS = {
    "dtc": np.cos(np.pi * T) * np.exp(-0.05 * T),
    "noisy": 0.8 * np.cos(np.pi * T + 0.3) * np.exp(-0.03 * T)
    + np.random.default_rng(0).normal(0, 0.01, T.size),
    "thermal": np.exp(-0.2 * T),
    "flat": np.zeros(T.size),
}


def _close(a, b):
    np.testing.assert_allclose(a, b, rtol=1e-9, atol=0, equal_nan=True)


def _same_fit(a, b):
    assert a.success == b.success and a.model == b.model
    assert list(a.params) == list(b.params)
    _close([a.params[k] for k in a.params], [b.params[k] for k in b.params])
    _close(a.r_squared, b.r_squared)


@pytest.mark.parametrize("name", list(SIGNALS))
def test_fft_matches_reference(name):
    y = SIGNALS[name]
    for dt in (1.0, 0.5):
        for a, b in zip(fft.spectrum(y, dt), j_fft.spectrum(y, dt)):
            _close(a, b)
        _close(fft.subharmonic_weight(y, dt), j_fft.subharmonic_weight(y, dt))
        _close(fft.dominant_frequency(y, dt), j_fft.dominant_frequency(y, dt))
    assert fft.subharmonic_markers(7) == j_fft.subharmonic_markers(7)
    assert fft.dominant_frequency([1.0]) == j_fft.dominant_frequency([1.0])


@pytest.mark.parametrize("name", list(SIGNALS))
def test_fits_match_reference(name):
    y = SIGNALS[name]
    _close(fits.seed_omega_fft(T, y), j_fits.seed_omega_fft(T, y))
    _same_fit(fits.fit_sincos_decay(T, y), j_fits.fit_sincos_decay(T, y))
    e = -2 + 0.5 * np.log(T + 1) + 0.1 * y
    _same_fit(fits.fit_power_law(T, e), j_fits.fit_power_law(T, e))
    _same_fit(fits.fit_energy_envelope(T, e),
              j_fits.fit_energy_envelope(T, e))
    for model in ("sincos_decay", "power_law", "energy_envelope_model"):
        n = getattr(fits, model).__code__.co_argcount - 1
        p = np.linspace(0.1, 0.9, n)
        _close(getattr(fits, model)(T + 1, *p),
               getattr(j_fits, model)(T + 1, *p))


def test_fit_failure_rows_and_grid_match_reference():
    bad = np.array([np.nan] * 3)
    res, ref = fits.fit_sincos_decay(np.arange(3.0), bad), \
        j_fits.fit_sincos_decay(np.arange(3.0), bad)
    assert not res.success
    assert res.as_row(g=0.9).keys() == ref.as_row(g=0.9).keys()
    assert res.as_row(g=0.9)["fit_success"] is False
    assert [f.name for f in dataclasses.fields(fits.FitResult)] == \
        [f.name for f in dataclasses.fields(j_fits.FitResult)]
    records = [({"g": g}, {"time": T, "av_autocorr": SIGNALS[k]})
               for g, k in ((0.9, "dtc"), (0.97, "noisy"), (1.0, "flat"))]
    for a, b in zip(fits.fit_grid(records), j_fits.fit_grid(records)):
        assert list(a) == list(b)
        _close([a[k] for k in a], [b[k] for k in b])
    sources = {"a": (T, -2 + 0.1 * T), "b": (T, -3 + np.cos(T)),
               "c": (T, -2.5 + 0.0 * T)}
    for L in (None, 4):
        assert fits.min_energy_analysis(sources, L=L) == \
            j_fits.min_energy_analysis(sources, L=L)
    assert fits.min_energy_analysis({}) == j_fits.min_energy_analysis({})


def _inputs(d):
    """The draw commands' input CSVs under ``d`` (absolute paths)."""
    os.makedirs(d)
    t = np.arange(20)
    a = os.path.join(d, "a.csv")
    csvio.write_columns(a, {
        "time": t,
        "av_autocorr": np.cos(np.pi * t) * np.exp(-0.05 * t),
        "av_autocorr_echo": np.exp(-0.08 * t),
        "sqrt_av_autocorr_echo": np.exp(-0.04 * t)})
    grid = []
    for dl, am in [(0.0, 1.0), (0.1, 1.0), (0.0, 2.0)]:
        p = os.path.join(d, f"autocorr_data_vacuum_g0.9_L4_inst1_tf20_"
                            f"randomphi1_delta{dl}_amplitude{am}_noise0.05"
                            "_usenoise1.csv")
        csvio.write_columns(p, {"time": t, "av_autocorr": np.cos(np.pi * t)
                                * np.exp(-(0.03 + dl) * t)})
        grid.append(p)
    e = os.path.join(d, "energy_data_vacuum_g0.9_L4_inst1_randomphi1_"
                        "delta0.0_amplitude1.0_noise0.05_usenoise1.csv")
    csvio.write_columns(e, {"time": t, "energy_p_0.0": -4.0 + 0.1 * t,
                            "energy_p_0.05": -4.0 + 0.3 * np.sqrt(t + 1.0)})
    merged = os.path.join(d, "merged.csv")
    csvio.write_columns(merged, {
        "time": t, "av_autocorr_x": np.cos(np.pi * t),
        "av_autocorr_echo_x": 0 * t + 1.0,
        "sqrt_av_autocorr_echo_x": 0 * t + 1.0,
        "av_autocorr_y": np.cos(np.pi * t) * 0.9,
        "av_autocorr_echo_y": 0 * t + 0.9,
        "sqrt_av_autocorr_echo_y": 0 * t + 0.95})
    ad = os.path.join(d, "adaptive.csv")
    csvio.write_columns(ad, {
        "time": t, "av_autocorr_adaptive": np.cos(np.pi * t) * 0.8,
        "av_autocorr_echo_adaptive": 0.9 ** t,
        "av_autocorr_standard_g84": np.cos(np.pi * t) * 0.7,
        "av_autocorr_echo_standard_g84": 0.85 ** t,
        "upper_env_g84_forward": 0.7 + 0 * t,
        "lower_env_g84_forward": -0.7 + 0 * t,
        "av_g_values": np.linspace(0.84, 0.95, 20),
        "g_history_inst1": np.linspace(0.84, 0.96, 20)})
    return {"autocorr": [a], "sincos-fit": [a], "fft": [a], "envelope": [a],
            "quicklook": [a], "power-law": [e], "energy-all": [e, grid[0]],
            "sub-echo": [e, "--echo_csv", grid[0], a, "--per_qubit"],
            "fit-grid": [*grid, "--fit_csv", "fits.csv"],
            "polarization-comparison": [merged],
            "xy-cycle": [*grid, "--period", "4"], "adaptive": [ad]}


def _both(tmp_path, monkeypatch, capsys, argv):
    """Run the reference's and the port's CLI on ``argv`` in a directory
    each; their printed lines."""
    out = {}
    for side, main in (("jax", j_cli_main), ("torch", cli_main)):
        os.makedirs(tmp_path / side)
        monkeypatch.chdir(tmp_path / side)
        assert main(argv) == 0
        out[side] = capsys.readouterr().out
    return out


KINDS = ["autocorr", "sincos-fit", "fft", "envelope", "quicklook",
         "power-law", "energy-all", "sub-echo", "fit-grid",
         "polarization-comparison", "xy-cycle", "adaptive"]


@pytest.mark.parametrize("kind", KINDS)
def test_draw_matches_reference(kind, tmp_path, monkeypatch, capsys):
    inputs = _inputs(str(tmp_path / "in"))[kind]
    out = _both(tmp_path, monkeypatch, capsys,
                ["draw", *inputs, "--kind", kind, "--out", "fig.png"])
    assert out["torch"] == out["jax"]
    assert out["torch"].splitlines()[-1] == "wrote fig.png"
    if kind in ("sincos-fit", "energy-all", "power-law", "fit-grid"):
        assert len(out["torch"].splitlines()) > 1
    assert os.path.getsize(tmp_path / "torch" / "fig.png") > 1000
    if kind == "fit-grid":
        assert filecmp.cmp(tmp_path / "torch" / "fits.csv",
                           tmp_path / "jax" / "fits.csv", shallow=False)


@pytest.mark.parametrize("device,L", [("garnet", 19), ("linear", 6),
                                      ("brisbane", 12)])
def test_layout_matches_reference(device, L, tmp_path, monkeypatch, capsys):
    out = _both(tmp_path, monkeypatch, capsys,
                ["layout", "--device", device, "--L", str(L)])
    assert out["torch"] == out["jax"]
    png = tmp_path / "torch" / f"layout_{device}_L{L}.png"
    assert os.path.getsize(png) > 1000


def test_without_matplotlib(tmp_path, monkeypatch, caplog):
    """matplotlib made to fail on import: xy-cycle writes its CSV and no
    figure, with one warning naming matplotlib; draw and layout raise."""
    from dtc_tpu_torch.experiments.autocorr import run_xy_cycle_comparison
    from dtc_tpu_torch.utils.config import SimConfig

    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with caplog.at_level(logging.WARNING, logger="dtc_tpu_torch"):
        r = run_xy_cycle_comparison(
            SimConfig(L=4, tf=3, n_trajectories=2), device="cpu",
            out_dir=str(tmp_path / "out"), disorder_dir=str(tmp_path))
    assert r["png_path"] is None
    assert os.listdir(tmp_path / "out") == [os.path.basename(r["csv_path"])]
    warned = [m for m in caplog.messages if "matplotlib" in m]
    assert len(warned) == 1
    a = _inputs(str(tmp_path / "in"))["autocorr"][0]
    with pytest.raises(ImportError, match="matplotlib"):
        cli_main(["draw", a, "--out", str(tmp_path / "x.png")])
    with pytest.raises(ImportError, match="matplotlib"):
        cli_main(["layout", "--device", "linear", "--L", "4", "--out",
                  str(tmp_path / "y.png")])
    assert not os.path.exists(tmp_path / "x.png")
