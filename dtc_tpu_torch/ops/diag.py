"""Fused diagonal layers of the kicked-Ising Floquet cycle.

Port of ``dtc_tpu/ops/diag.py`` (``zz_z_diag_energy``, ``zz_z_phase_mask``,
``z_sign_mask``). With z_q = 1 - 2*bit_q the RZZ(even) + RZZ(odd) + RZ layer
is the single mask exp(-i/2 E(s)),
E(s) = sum_q h_q z_q(s) + sum_q phi_q z_q(s) z_{q+1}(s).
Indices are int64 (torch has no shifts on CPU uint32). ``offset``/``size``
select a contiguous window of global indices, as the reference's do: an
amplitude shard's (offset = shard index * local size).
"""

from __future__ import annotations

import torch


def _z_signs(idx: torch.Tensor, q: int, dtype) -> torch.Tensor:
    return (1 - 2 * ((idx >> q) & 1)).to(dtype)


def _window(n: int, offset: int, size: int | None, device) -> torch.Tensor:
    size = 1 << n if size is None else size
    return torch.arange(size, dtype=torch.int64, device=device) + offset


def zz_z_diag_energy(hs, phis, n: int, *, offset=0, size=None,
                     dtype=torch.float64):
    """E(s) for the basis indices s in [offset, offset + size), default
    every s < 2^n."""
    hs = torch.as_tensor(hs)
    phis = torch.as_tensor(phis)
    idx = _window(n, offset, size, hs.device)
    e = torch.zeros(idx.shape, dtype=dtype, device=hs.device)
    z_prev = None
    for q in range(n):
        z = _z_signs(idx, q, dtype)
        e = e + hs[q] * z
        if q > 0:
            e = e + phis[q - 1] * z_prev * z
        z_prev = z
    return e


def zz_z_phase_mask(hs, phis, n: int, *, offset=0, size=None,
                    dtype=torch.complex64):
    """exp(-i/2 E(s)) — one mask for the full RZZ+RZZ+RZ layer. E is
    accumulated in the promoted dtype of (hs, float32), as the reference
    does, then cast to ``dtype`` before the exponential."""
    hs = torch.as_tensor(hs)
    real = torch.float64 if (dtype == torch.complex128
                             or hs.dtype == torch.float64) else torch.float32
    e = zz_z_diag_energy(hs, phis, n, offset=offset, size=size, dtype=real)
    return torch.exp(-0.5j * e.to(dtype))


def z_sign_mask(q: int, n: int, *, offset=0, size=None, dtype=torch.float32,
                device=None):
    """z_q(s) signs — the diagonal of the Z_q observable."""
    return _z_signs(_window(n, offset, size, device), q, dtype)
