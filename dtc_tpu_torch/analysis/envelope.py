"""Upper and lower envelopes of an autocorrelation trace.

A copy of ``dtc_tpu/analysis/envelope.py`` (``find_envelope``): peak and
valley detection with endpoint pinning, cubic (or linear) interpolation,
light gaussian smoothing, and bounds so the envelopes always bracket the
signal. Needs scipy.
"""

from __future__ import annotations

import numpy as np
from scipy.interpolate import interp1d
from scipy.ndimage import gaussian_filter1d
from scipy.signal import find_peaks


def _one_side(signal: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """Interpolate through extremum indices (>=4 -> cubic, >=2 -> linear)."""
    n = len(signal)
    pts = np.unique(np.concatenate([[0], idx, [n - 1]])).astype(int)
    t = np.arange(n)
    if len(pts) >= 4:
        f = interp1d(pts, signal[pts], kind="cubic", bounds_error=False,
                     fill_value="extrapolate")
        return f(t)
    if len(pts) >= 2:
        f = interp1d(pts, signal[pts], kind="linear", bounds_error=False,
                     fill_value="extrapolate")
        return f(t)
    return np.full(n, signal[pts[0]] if len(pts) else 0.0)


def find_envelope(signal, window_size: int = 5):
    """Return (upper_env, lower_env), both bounding the signal."""
    signal = np.asarray(signal, dtype=float)
    dist = max(1, window_size // 2)
    peaks_max, _ = find_peaks(signal, distance=dist)
    peaks_min, _ = find_peaks(-signal, distance=dist)

    upper = _one_side(signal, peaks_max)
    lower = _one_side(signal, peaks_min)

    upper = np.maximum(upper, signal)
    lower = np.minimum(lower, signal)

    sigma = max(0.5, window_size / 4)
    upper = gaussian_filter1d(upper, sigma=sigma)
    lower = gaussian_filter1d(lower, sigma=sigma)

    upper = np.maximum(upper, signal)
    lower = np.minimum(lower, signal)
    return upper, lower
