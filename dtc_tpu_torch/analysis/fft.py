"""FFT subharmonic analysis: the period-doubling diagnostic.

A copy of ``dtc_tpu/analysis/fft.py`` (numpy). The DTC signature is a rigid
peak at f = 1/2 (period doubling) in the autocorrelator spectrum; the
figures mark f = 1/m for m = 2..10 and the fitted frequency.
"""

from __future__ import annotations

import numpy as np


def spectrum(y, dt: float = 1.0):
    """One-sided rFFT amplitude spectrum of the detrended signal."""
    y = np.asarray(y, dtype=float)
    amps = np.abs(np.fft.rfft(y - np.mean(y)))
    freqs = np.fft.rfftfreq(len(y), d=dt)
    return freqs, amps


def subharmonic_markers(m_max: int = 10):
    """f = 1/m for m = 2..m_max."""
    return [1.0 / m for m in range(2, m_max + 1)]


def subharmonic_weight(y, dt: float = 1.0, target: float = 0.5,
                       tol: float = 0.02) -> float:
    """Fraction of spectral weight within ±tol of the target frequency
    (f=0.5 = period doubling). A scalar DTC order diagnostic."""
    freqs, amps = spectrum(y, dt)
    total = float(np.sum(amps))
    if total == 0:
        return 0.0
    sel = np.abs(freqs - target) <= tol
    return float(np.sum(amps[sel])) / total


def dominant_frequency(y, dt: float = 1.0) -> float:
    freqs, amps = spectrum(y, dt)
    if len(amps) < 2:
        return 0.0
    return float(freqs[1 + int(np.argmax(amps[1:]))])
