"""Dense gates and single-qubit observables on flat statevectors.

Port of ``dtc_tpu/ops/gates.py`` (``apply_1q``, ``apply_2q``,
``apply_diag``, ``apply_gate_layer``, ``probabilities_bit``, ``expect_z``,
``expect_x``). A state on n qubits is a tensor (..., 2^n) with any leading
batch dimensions; qubit q is bit q of the basis index (qubit 0 the least
significant, the Qiskit convention). The gates are reshapes and one
``torch.einsum`` each (TF32 off, ``ops/precision.py``).
"""

from __future__ import annotations

import torch


def _split(state: torch.Tensor, q: int, n: int) -> torch.Tensor:
    """Last axis 2^n -> (2^(n-1-q), 2, 2^q)."""
    return state.reshape(*state.shape[:-1], 1 << (n - 1 - q), 2, 1 << q)


def apply_1q(state: torch.Tensor, u: torch.Tensor, q: int,
             n: int) -> torch.Tensor:
    """Apply the 2x2 ``u`` to qubit q of an n-qubit state."""
    s = torch.einsum("ab,...xbz->...xaz", u, _split(state, q, n))
    return s.reshape(state.shape)


def apply_2q(state: torch.Tensor, u: torch.Tensor, q1: int, q2: int,
             n: int) -> torch.Tensor:
    """Apply the 4x4 ``u`` to qubits (q1, q2) of an n-qubit state, indexed
    u[(a1 a2), (b1 b2)] with a1 the bit of q1 (the order of kron(U_q1,
    U_q2)); q1 != q2, in either order. ``u`` need not be unitary: the
    vectorized density matrix applies superoperator blocks with it."""
    if q1 == q2:
        raise ValueError("q1 and q2 must differ")
    qa, qb = (q1, q2) if q1 > q2 else (q2, q1)
    s = state.reshape(*state.shape[:-1], 1 << (n - 1 - qa), 2,
                      1 << (qa - 1 - qb), 2, 1 << qb)
    u4 = u.reshape(2, 2, 2, 2)  # [a1, a2, b1, b2], a1 the bit of q1
    if q1 > q2:
        s = torch.einsum("acbd,...xbmdz->...xamcz", u4, s)
    else:
        s = torch.einsum("acbd,...xdmbz->...xcmaz", u4, s)
    return s.reshape(state.shape)


def apply_diag(state: torch.Tensor, diag: torch.Tensor) -> torch.Tensor:
    """Multiply by a broadcastable diagonal (a fused phase mask)."""
    return state * diag


def apply_gate_layer(state: torch.Tensor, gates, n: int) -> torch.Tensor:
    """Apply a sequence of (2x2 u, qubit) pairs in order."""
    for u, q in gates:
        state = apply_1q(state, u, q, n)
    return state


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
