"""Statevector construction.

Port of ``dtc_tpu/core/statevector.py`` (``neel_index``,
``initial_statevector``): "vacuum" = |0...0>, "neel" = X on 0-indexed
qubits 1, 3, 5, ...
"""

from __future__ import annotations

import torch


def neel_index(L: int) -> int:
    idx = 0
    for q in range(1, L, 2):
        idx |= 1 << q
    return idx


def basis_index(L: int, initial_state: str) -> int:
    """Basis index of the initial product state."""
    if initial_state == "vacuum":
        return 0
    if initial_state == "neel":
        return neel_index(L)
    raise ValueError(f"unknown initial_state {initial_state!r}")


def initial_statevector(L: int, initial_state: str = "vacuum", *,
                        dtype=torch.complex64, device=None) -> torch.Tensor:
    """(2**L,) basis state."""
    psi = torch.zeros(1 << L, dtype=dtype, device=device)
    psi[basis_index(L, initial_state)] = 1.0
    return psi
