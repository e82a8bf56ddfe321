"""Kicked-Ising Hamiltonian H = sum_i h_i Z_i + sum_i phi_i Z_i Z_{i+1}
+ g*pi*sum_i X_i and its component selection.

Port of ``dtc_tpu/models/hamiltonian.py`` (``COMPONENTS``,
``HamiltonianTerms``, ``hamiltonian_terms``, ``pauli_string_terms``,
``dense_hamiltonian``). The terms are coefficient tensors for the energy
engines: the Z and ZZ parts form one diagonal reduction, the X part a sum of
pair reductions; ``pauli_string_terms`` exports them as Pauli strings.
"""

from __future__ import annotations

import dataclasses
import math

import torch

COMPONENTS = ("full", "z_only", "zz_only", "x_only", "z_zz")


@dataclasses.dataclass(frozen=True)
class HamiltonianTerms:
    hs: torch.Tensor    # (L,) Z coefficients
    phis: torch.Tensor  # (L-1,) ZZ coefficients
    x_coeff: float      # g*pi, the uniform X coefficient


def hamiltonian_terms(L: int, g, hs, phis,
                      component: str = "full") -> HamiltonianTerms:
    """The coefficients of ``component``: the unselected parts are zero."""
    if component not in COMPONENTS:
        raise ValueError(f"unknown component {component!r}; one of "
                         f"{COMPONENTS}")
    hs = torch.as_tensor(hs)[:L]
    phis = torch.as_tensor(phis)[:L - 1]
    zero_h = component in ("zz_only", "x_only")
    zero_zz = component in ("z_only", "x_only")
    zero_x = component in ("z_only", "zz_only", "z_zz")
    return HamiltonianTerms(
        hs=torch.zeros_like(hs) if zero_h else hs,
        phis=torch.zeros_like(phis) if zero_zz else phis,
        x_coeff=0.0 if zero_x else float(g) * math.pi,
    )


def pauli_string_terms(L: int, terms: HamiltonianTerms, *,
                       num_qubits: int | None = None,
                       layout: list[int] | None = None) -> list[tuple[str, float]]:
    """H as (pauli_string, coeff) pairs, the ``SparsePauliOp.from_list``
    surface, optionally embedded in a wider device register.

    Strings are little-endian (rightmost character = qubit 0). ``layout``
    maps logical site i to device qubit layout[i] (a snake layout from
    ``device/layouts.py``, say); default identity, ``num_qubits`` default
    L. Zero-coefficient terms are dropped, matching component selection.
    """
    n = num_qubits if num_qubits is not None else L
    lay = list(range(L)) if layout is None else list(layout[:L])
    if len(lay) < L or max(lay) >= n:
        raise ValueError(f"layout must map {L} sites into [0, {n})")

    def string_with(ops: dict[int, str]) -> str:
        chars = ["I"] * n
        for q, c in ops.items():
            chars[n - 1 - q] = c
        return "".join(chars)

    hs = torch.as_tensor(terms.hs, dtype=torch.float64).cpu().tolist()
    phis = torch.as_tensor(terms.phis, dtype=torch.float64).cpu().tolist()
    xc = float(terms.x_coeff)
    out: list[tuple[str, float]] = []
    for i in range(L):
        if hs[i] != 0.0:
            out.append((string_with({lay[i]: "Z"}), hs[i]))
    for i in range(L - 1):
        if phis[i] != 0.0:
            out.append((string_with({lay[i]: "Z", lay[i + 1]: "Z"}), phis[i]))
    if xc != 0.0:
        for i in range(L):
            out.append((string_with({lay[i]: "X"}), xc))
    return out


def dense_hamiltonian(L: int, terms: HamiltonianTerms) -> torch.Tensor:
    """Dense (2^L, 2^L) complex128 matrix: the test oracle (L <= ~12)."""
    eye = torch.eye(2, dtype=torch.complex128)
    x = torch.tensor([[0, 1], [1, 0]], dtype=torch.complex128)
    z = torch.tensor([[1, 0], [0, -1]], dtype=torch.complex128)

    def op_at(op, q):
        m = torch.ones((1, 1), dtype=torch.complex128)
        for i in range(L - 1, -1, -1):
            m = torch.kron(m, op if i == q else eye)
        return m

    hs = torch.as_tensor(terms.hs, dtype=torch.float64).cpu()
    phis = torch.as_tensor(terms.phis, dtype=torch.float64).cpu()
    h = torch.zeros((1 << L, 1 << L), dtype=torch.complex128)
    for q in range(L):
        h += float(hs[q]) * op_at(z, q) + terms.x_coeff * op_at(x, q)
    for q in range(L - 1):
        h += float(phis[q]) * (op_at(z, q) @ op_at(z, q + 1))
    return h
