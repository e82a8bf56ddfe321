"""Oscillation and decay fits.

A copy of ``dtc_tpu/analysis/fits.py`` (numpy; scipy's ``curve_fit`` is
imported inside the fit functions). Models:
- sincos decay: (A sin(wt) + B cos(wt)) e^{-gamma t} + c, FFT-seeded
  frequency, |A|,|B| <= 1 bounds;
- power law: a t^b + c with R^2;
- energy envelope: a (x+b)^c + d log(e x + f) + g.
Failed fits are recorded (``fit_success=False``), never dropped.
"""

from __future__ import annotations

import dataclasses

import numpy as np


def sincos_decay(t, A, B, omega, gamma, c):
    return (A * np.sin(omega * t) + B * np.cos(omega * t)) * np.exp(-gamma * t) + c


def power_law(t, a, b, c):
    return a * np.power(t, b) + c


def energy_envelope_model(x, a, b, c, d, e, f, g):
    return a * np.power(x + b, c) + d * np.log(e * x + f) + g


@dataclasses.dataclass
class FitResult:
    params: dict
    success: bool
    r_squared: float = np.nan
    model: str = ""

    def as_row(self, **extra) -> dict:
        row = dict(extra)
        row.update({f"{k}_fitted": v for k, v in self.params.items()})
        row["fit_success"] = self.success
        row["r_squared"] = self.r_squared
        return row


def _r2(y, yhat) -> float:
    ss_res = float(np.sum((y - yhat) ** 2))
    ss_tot = float(np.sum((y - np.mean(y)) ** 2))
    return 1.0 - ss_res / ss_tot if ss_tot > 0 else np.nan


def seed_omega_fft(t, y) -> float:
    """Dominant non-DC frequency of the detrended signal (fit seed)."""
    if len(t) <= 10:
        return 1.0
    freqs = np.fft.fftfreq(len(t), d=float(np.mean(np.diff(t))))
    vals = np.abs(np.fft.fft(y - np.mean(y)))
    idx = int(np.argmax(vals[1 : len(vals) // 2])) + 1
    omega = 2 * np.pi * abs(freqs[idx])
    return omega if omega > 1e-3 else 1.0


def fit_sincos_decay(t, y, maxfev: int = 5000) -> FitResult:
    from scipy.optimize import curve_fit

    t = np.asarray(t, dtype=float)
    y = np.asarray(y, dtype=float)
    p0 = [
        float(np.clip((np.max(y) - np.min(y)) / 2, -1, 1)),  # A
        0.0,                                                  # B
        seed_omega_fft(t, y),                                 # omega
        0.1,                                                  # gamma
        float(np.mean(y)),                                    # offset
    ]
    names = ("A", "B", "omega", "gamma", "offset")
    try:
        popt, _ = curve_fit(
            sincos_decay, t, y, p0=p0,
            bounds=([-1, -1, 0, 0, -np.inf], [1, 1, np.inf, np.inf, np.inf]),
            maxfev=maxfev,
        )
        params = dict(zip(names, popt))
        params["frequency"] = params["omega"] / (2 * np.pi)
        return FitResult(params, True, _r2(y, sincos_decay(t, *popt)), "sincos_decay")
    except Exception:
        return FitResult({k: np.nan for k in names + ("frequency",)}, False,
                         model="sincos_decay")


def fit_power_law(t, y, maxfev: int = 5000) -> FitResult:
    from scipy.optimize import curve_fit

    t = np.asarray(t, dtype=float)
    y = np.asarray(y, dtype=float)
    mask = t > 0  # t=0 undefined for t^b with b<0
    try:
        popt, _ = curve_fit(power_law, t[mask], y[mask],
                            p0=[y[mask][0] - y[mask][-1], -0.5, y[mask][-1]],
                            maxfev=maxfev)
        params = dict(zip(("a", "b", "c"), popt))
        return FitResult(params, True, _r2(y[mask], power_law(t[mask], *popt)),
                         "power_law")
    except Exception:
        return FitResult({k: np.nan for k in ("a", "b", "c")}, False,
                         model="power_law")


def fit_energy_envelope(t, y, maxfev: int = 20000) -> FitResult:
    from scipy.optimize import curve_fit

    t = np.asarray(t, dtype=float)
    y = np.asarray(y, dtype=float)
    names = ("a", "b", "c", "d", "e", "f", "g")
    try:
        # the optimizer legitimately probes e*x+f <= 0 and x+b < 0 while
        # exploring (it steers away from the resulting NaNs) — keep that
        # behavior but silence the invalid-domain warnings HERE rather
        # than in every caller
        with np.errstate(invalid="ignore", divide="ignore"):
            popt, _ = curve_fit(
                energy_envelope_model, t, y,
                p0=[1.0, 1.0, -0.5, 0.1, 1.0, 1.0, float(np.mean(y))],
                maxfev=maxfev,
            )
            r2 = _r2(y, energy_envelope_model(t, *popt))
        return FitResult(dict(zip(names, popt)), True, r2, "energy_envelope")
    except Exception:
        return FitResult({k: np.nan for k in names}, False, model="energy_envelope")


def min_energy_analysis(sources, L=None) -> dict:
    """Per-source and overall minimum-energy report.

    Mirrors draw-energy-all.py:208-250: for every energy trace report the
    minimum energy, its per-qubit value, and the cycle where it occurs,
    then the overall minimum across all sources (absolute and per-qubit).
    """
    per_source = {}
    for label, (t, e) in sources.items():
        t = np.asarray(t, dtype=float)
        e = np.asarray(e, dtype=float)
        i = int(np.argmin(e))
        per_source[label] = {
            "min_energy": float(e[i]),
            "min_energy_per_qubit": float(e[i] / L) if L else float(e[i]),
            "t_min": float(t[i]),
        }
    if not per_source:
        return {"per_source": {}}
    overall = min(per_source, key=lambda k: per_source[k]["min_energy"])
    overall_pq = min(per_source,
                     key=lambda k: per_source[k]["min_energy_per_qubit"])
    return {
        "per_source": per_source,
        "overall_min": per_source[overall]["min_energy"],
        "overall_min_source": overall,
        "overall_min_per_qubit": per_source[overall_pq]["min_energy_per_qubit"],
        "overall_min_per_qubit_source": overall_pq,
    }


def fit_grid(records, t_key="time", y_key="av_autocorr", fit=fit_sincos_decay,
             **meta_keys) -> list[dict]:
    """Apply a fitter over a list of (metadata, columns) records, producing
    fit-result rows with failure tracking (draw-2b-sincosfit.py:121-136:
    failed fits are recorded with fit_success=False, never dropped)."""
    rows = []
    for meta, cols in records:
        res = fit(cols[t_key], cols[y_key])
        rows.append(res.as_row(**meta))
    return rows
