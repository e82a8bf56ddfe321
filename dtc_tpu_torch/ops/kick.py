"""Kronecker-power kick matrices and the uniform kick layer.

Port of ``dtc_tpu/ops/kick.py`` (``kron_power``,
``apply_uniform_1q_layer``). Batched: ``u`` may carry leading batch
dimensions, (..., d, d). The layer applies the same 2x2 to every qubit in
kron groups of up to 7 qubits, one (2^k x 2^k) contraction per group.
"""

from __future__ import annotations

import torch

_GROUP = 7


def kron(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched Kronecker product of (..., m, m) and (..., n, n) matrices
    (a is the high, left factor)."""
    m, n = a.shape[-1], b.shape[-1]
    out = a[..., :, None, :, None] * b[..., None, :, None, :]
    return out.reshape(*out.shape[:-4], m * n, m * n)


def kron_power(u: torch.Tensor, k: int) -> torch.Tensor:
    """U^{(x)k}."""
    result = u
    for _ in range(k - 1):
        result = kron(result, u)
    return result


def apply_uniform_1q_layer(state: torch.Tensor, u: torch.Tensor,
                           n: int) -> torch.Tensor:
    """Apply the 2x2 ``u`` to each of the n low qubits of ``state``
    (..., 2^m), m >= n; qubits n..m-1 are untouched."""
    shape = state.shape
    q = 0
    while q < n:
        k = min(_GROUP, n - q)
        uk = kron_power(u, k)
        s = state.reshape(*shape[:-1], shape[-1] >> (q + k), 1 << k, 1 << q)
        state = torch.einsum("ab,...hbl->...hal", uk, s).reshape(shape)
        q += k
    return state
