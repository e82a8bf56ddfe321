"""Single-qubit observables on flat statevectors.

Port of ``dtc_tpu/ops/gates.py`` (``probabilities_bit``, ``expect_z``,
``expect_x``). A state on n qubits is a tensor (..., 2^n) with any leading
batch dimensions; qubit q is bit q of the basis index (qubit 0 the least
significant, the Qiskit convention).
"""

from __future__ import annotations

import torch


def _split(state: torch.Tensor, q: int, n: int) -> torch.Tensor:
    """Last axis 2^n -> (2^(n-1-q), 2, 2^q)."""
    return state.reshape(*state.shape[:-1], 1 << (n - 1 - q), 2, 1 << q)


def probabilities_bit(state: torch.Tensor, q: int, n: int):
    """(p0, p1): the probabilities of qubit q being 0 and 1."""
    s = _split(state, q, n)
    p = (s.real ** 2 + s.imag ** 2).sum(dim=(-3, -1))
    return p[..., 0], p[..., 1]


def expect_z(state: torch.Tensor, q: int, n: int) -> torch.Tensor:
    """<Z_q> on a normalized state."""
    p0, p1 = probabilities_bit(state, q, n)
    return p0 - p1


def expect_x(state: torch.Tensor, q: int, n: int) -> torch.Tensor:
    """<X_q> on a normalized state: 2 Re sum conj(psi_0) psi_1 over the
    bit-q pairs."""
    s = _split(state, q, n)
    a, b = s[..., 0, :], s[..., 1, :]
    return 2.0 * (a.real * b.real + a.imag * b.imag).sum(dim=(-2, -1))
