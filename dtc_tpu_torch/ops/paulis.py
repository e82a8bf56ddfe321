"""Pauli-string application, the eager noise layer of the energy engine.

Port of ``dtc_tpu/ops/paulis.py`` (``pauli_string_masks``,
``apply_pauli_string``, ``sample_depolarizing_codes``,
``sample_bond_depolarizing_codes``). A noise layer of one sampled Pauli per qubit is one
Pauli string, which acts on a statevector as one XOR permutation and one
phase:

    P|s> = i^{n_Y} (-1)^{popcount(s & zmask)} |s XOR xmask>

Masks are int64 (torch has no shifts on CPU uint32) and may carry batch
dimensions, one string per batch entry; the masks come from
``core/sigma_evolve.py::_masks_from_codes``. The samplers take their
uniforms (ROADMAP.md porting rule 2) instead of a key.
"""

from __future__ import annotations

import torch

from dtc_tpu_torch.core.sigma_evolve import _masks_from_codes


def pauli_string_masks(codes: torch.Tensor):
    """(..., n) codes in {0:I, 1:X, 2:Y, 3:Z} -> (xmask, zmask, n_y) int64
    over the last axis: xmask flags X/Y positions (bit flips), zmask Y/Z
    positions (signs), n_y counts the Y's."""
    xm, zm = _masks_from_codes(codes, codes.shape[-1])
    return xm, zm, (codes == 2).sum(-1)


def _parity(v: torch.Tensor) -> torch.Tensor:
    """popcount(v) & 1 of non-negative int64 values below 2^32."""
    for s in (16, 8, 4, 2, 1):
        v = v ^ (v >> s)
    return v & 1


def _i_power(n_y: torch.Tensor, dtype) -> torch.Tensor:
    """i**n_y as complex values of ``dtype``."""
    m = n_y % 4
    re = torch.where(m == 0, 1.0, torch.where(m == 2, -1.0, 0.0))
    im = torch.where(m == 1, 1.0, torch.where(m == 3, -1.0, 0.0))
    return torch.complex(re, im).to(dtype)


def apply_pauli_string(state: torch.Tensor, xmask, zmask, n_y) -> torch.Tensor:
    """Apply P = (x)_q P_q to ``state`` (..., 2^n); the masks are scalars or
    tensors of the state's batch shape."""
    dev = state.device
    size = state.shape[-1]
    xm = torch.as_tensor(xmask, dtype=torch.int64, device=dev)[..., None]
    zm = torch.as_tensor(zmask, dtype=torch.int64, device=dev)[..., None]
    ny = torch.as_tensor(n_y, dtype=torch.int64, device=dev)
    idx = torch.arange(size, dtype=torch.int64, device=dev)
    src = idx ^ xm
    sign = (1 - 2 * _parity(src & zm)).to(state.real.dtype)
    shape = torch.broadcast_shapes(state.shape, src.shape)
    amp = torch.gather(state.expand(shape), -1, src.expand(shape))
    return amp * (_i_power(ny, state.dtype)[..., None] * sign)


def _common(u, p):
    """u and p as tensors of their promoted dtype (an f64 calibration makes
    the thresholds f64, as the reference's x64 arrays do)."""
    p = torch.as_tensor(p, device=u.device)
    if not p.is_floating_point():
        p = p.to(torch.float64)
    dt = torch.promote_types(u.dtype, p.dtype)
    return u.to(dt), p.to(dt)


def sample_depolarizing_codes(u, p) -> torch.Tensor:
    """Pauli codes per site from uniforms u (..., n): P(I) = 1 - 3p/4,
    P(X) = P(Y) = P(Z) = p/4 (qiskit's depolarizing_error(p, 1)); p a
    scalar or per-site rates broadcastable to u."""
    u, p = _common(u, p)
    q = p * 0.25
    thr = 1.0 - 3.0 * q
    c = (u >= thr).to(torch.int64) * (
        1 + torch.floor((u - thr) / torch.clamp_min(q, 1e-30)).to(
            torch.int64))
    return torch.clamp(c, 0, 3)


def sample_bond_depolarizing_codes(u, p_bonds, start: int, L: int
                                   ) -> torch.Tensor:
    """Two-qubit depolarizing layer on bonds (start, start+2, ...) -> per-site
    codes (..., L). u (..., n_bonds): one uniform per bond; a bond is the
    identity with probability 1 - 15p/16, else one of the 15 other Pauli
    pairs (qiskit's depolarizing_error(p, 2)); bonds of a sublayer are
    disjoint, so the layer is one Pauli string."""
    hi = torch.arange(start, L - 1, 2, device=u.device)
    u, p = _common(u, p_bonds)
    q16 = torch.broadcast_to(p, u.shape[-1:]) / 16.0
    thr = 1.0 - 15.0 * q16
    idx = (u >= thr).to(torch.int64) * (
        1 + torch.floor((u - thr) / torch.clamp_min(q16, 1e-30)).to(
            torch.int64))
    idx = torch.clamp(idx, 0, 15)
    codes = torch.zeros((*u.shape[:-1], L), dtype=torch.int64,
                        device=u.device)
    codes[..., hi] = idx >> 2
    codes[..., hi + 1] = idx & 3
    return codes
