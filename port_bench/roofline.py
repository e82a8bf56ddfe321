"""The least time an NVIDIA H100 could take for a cell's counted work.

Frozen copies, for the benchmark, of ``chip_smoke.py``'s ``bound`` and its
two peaks, and of the per-step operation counts of PERF.md section 6. The
work comes from the cell's shapes and the cycles it ran, never from how
many passes an implementation makes over the state:

- a kick slot that is a rotation about one axis (RX or RY): 6 f32
  operations per amplitude and qubit (a complex pair times a real and an
  imaginary coefficient); a general 2x2 (RY RX with both angles): 14;
- the cycle's diagonal D0: 6 per amplitude, once a cycle;
- the energy study's measure, once per measured cycle and trajectory:
  5 + 2 k1 + 2 L per amplitude, k1 = L - L // 2 (|psi|^2 3, the energy sum
  2, the z_q sums of the low k1 bits 2 k1, the x pairs 2 L).

Bytes: inputs read once and outputs written once.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12   # H100 SXM, published
F32_FLOPS_PER_S = 67e12     # H100 SXM, f32 outside the tensor cores


def bound(io_bytes, amp_steps, flops_per_amp_step, extra_ops=0) -> tuple:
    """(bound ms, what bounds it): the larger of the bytes that must move
    (inputs read once, outputs written once) over the HBM rate and the f32
    operations over the f32 peak. Copy of ``chip_smoke.py::bound``."""
    t_bytes = io_bytes / HBM_BYTES_PER_S
    t_ops = (amp_steps * flops_per_amp_step + extra_ops) / F32_FLOPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def slot_flops(theta_x: float, theta_y: float) -> int:
    """Operations per amplitude and qubit of one kick slot."""
    return 6 if theta_x == 0.0 or theta_y == 0.0 else 14


def cycle_flops(L: int, slots) -> int:
    """Operations per amplitude of one cycle: each kick slot on every
    qubit, then the diagonal. ``slots``: the (theta_x, theta_y) of each."""
    return sum(slot_flops(tx, ty) for tx, ty in slots) * L + 6


def measure_flops(L: int) -> int:
    """Operations per amplitude of one measure of E and every <Z_q>."""
    return 5 + 2 * (L - L // 2) + 2 * L
