"""NaN/Inf and bound guards where engine outputs reach the host.

A copy of ``dtc_tpu/utils/validation.py`` (``NumericalFault``,
``validation_enabled``, ``guard``); the reference's jax ``checked`` wrapper
is left out. ``guard`` materializes its input as numpy (call ``.cpu()`` on
a CUDA tensor first), raises a ``NumericalFault`` naming the stage on a
non-finite value or on |x| above ``bound`` beyond 1e-3 relative, and
returns the array. ``DTC_TPU_VALIDATE=0`` disables it, as in the reference.
"""

from __future__ import annotations

import os

import numpy as np

__all__ = ["NumericalFault", "guard", "validation_enabled"]


class NumericalFault(RuntimeError):
    """A guarded engine output contained NaN/Inf or violated its bound."""

    def __init__(self, name: str, message: str, *, n_bad: int,
                 first_index: tuple | None):
        super().__init__(f"{name}: {message}")
        self.name = name
        self.n_bad = n_bad
        self.first_index = first_index


def validation_enabled() -> bool:
    return os.environ.get("DTC_TPU_VALIDATE", "1") not in ("0", "false", "")


def guard(name: str, arr, *, bound: float | None = None,
          enabled: bool | None = None) -> np.ndarray:
    """Materialize ``arr`` to host and sanitize it (see the module doc)."""
    out = np.asarray(arr)
    if enabled is None:
        enabled = validation_enabled()
    if not enabled or out.dtype.kind not in "fc":
        return out
    finite = np.isfinite(out)
    if out.dtype.kind == "c":
        finite = np.isfinite(out.real) & np.isfinite(out.imag)
    if not finite.all():
        n_bad = int(out.size - np.count_nonzero(finite))
        first = np.unravel_index(int(np.argmin(finite)), out.shape)
        raise NumericalFault(
            name, f"{n_bad}/{out.size} non-finite values "
            f"(first at index {tuple(int(i) for i in first)})",
            n_bad=n_bad, first_index=tuple(int(i) for i in first))
    if bound is not None:
        mag = np.abs(out)
        # catches faults (garbage magnitudes), not f32 drift: healthy
        # saturated runs (|A| = 1 at g = 1) sit within ~3e-4 of the bound
        tol = bound * 1e-3 + 1e-6
        bad = mag > bound + tol
        if bad.any():
            n_bad = int(np.count_nonzero(bad))
            first = np.unravel_index(int(np.argmax(bad)), out.shape)
            raise NumericalFault(
                name, f"{n_bad}/{out.size} values exceed |x| <= {bound} "
                f"(max {float(mag.max()):.6g}, first at index "
                f"{tuple(int(i) for i in first)})",
                n_bad=n_bad, first_index=tuple(int(i) for i in first))
    return out
