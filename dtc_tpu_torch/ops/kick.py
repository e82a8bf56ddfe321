"""Kronecker-power kick matrices.

Port of ``dtc_tpu/ops/kick.py`` (``kron_power``). Batched: ``u`` may carry
leading batch dimensions, (..., d, d).
"""

from __future__ import annotations

import torch


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
