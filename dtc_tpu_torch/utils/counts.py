"""Counts helpers of the hardware post-processing.

A copy of the pure-Python path of ``dtc_tpu/native/__init__.py``
(``crc32``, ``z_expectations``, ``bit_histogram``,
``generate_disorder_native``); the reference's C library is not ported, so
each function is what the reference computes without it. (The journal
format of the same module is in ``utils/checkpoints.py``.)
"""

from __future__ import annotations

import zlib

import numpy as np

from dtc_tpu_torch.io.disorder import generate_disorder


def crc32(data: bytes) -> int:
    return zlib.crc32(data) & 0xFFFFFFFF


def z_expectations(bits: np.ndarray) -> np.ndarray:
    """bits (shots, nq) uint8 -> (nq,) <Z_q>."""
    bits = np.ascontiguousarray(bits, dtype=np.uint8)
    return 1.0 - 2.0 * bits.mean(axis=0)


def bit_histogram(bits: np.ndarray, max_entries: int = 4096):
    """bits (shots, nq) -> {little-endian bitstring: count} (qubit 0 = the
    rightmost character). ``max_entries`` is the reference's C buffer size;
    the Python path has no limit."""
    bits = np.ascontiguousarray(bits, dtype=np.uint8)
    out: dict[str, int] = {}
    for row in bits:
        key = "".join(str(int(b)) for b in reversed(row))
        out[key] = out.get(key, 0) + 1
    return out


def generate_disorder_native(seed: int, L: int, inst: int, *,
                             phi_amplitude=1.0, phi_delta=0.0, randomphi=1):
    """(hs, phis) of ``io/disorder.py::generate_disorder`` from ``seed``:
    the reference's fallback without its C sampler."""
    return generate_disorder(L, inst, phi_amplitude=phi_amplitude,
                             phi_delta=phi_delta, randomphi=randomphi,
                             seed=seed)
