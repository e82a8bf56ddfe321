"""Eager Floquet engines: the observables engine and the branch-pair cycles.

Port of ``dtc_tpu/core/evolve.py`` (``make_floquet_params``,
``evolve_observables``, ``forward_cycle``, ``inverse_cycle``,
``_noise_layer``, ``_branch_pair``, ``_branch_autocorr``). The reference's
scan over cycles is a Python loop and its vmap over trajectories a batch
dimension.

``evolve_observables`` (energy E(t) and every <Z_q(t)>) serves what the
observables kernel (``ops/observables.py``, K5) does not: complex128, and
every L or schedule length outside K5's range. Its ``key`` becomes an
injected block of uniforms laid out as the reference draws them,
``uniform(key, (T, K, L))`` row-major, i.e. (..., T*K, L).

The cycle functions act on branch pairs (..., 2, 2^L), (phi1, phi2) =
(|psi>, Z_q|psi>) evolved under the same noise, and serve the carried
adaptive stepper (``experiments/adaptive.py``). Their noise comes from an
explicit ``torch.Generator``: one uniform per qubit and pair, through the
reference's ``_codes_from_uniform``, one Pauli string per pair applied to
both branches. ``autocorr_forward`` and ``autocorr_echo`` are not ported
here; they go with ``core/density.py`` (ROADMAP.md queue 1, exact density
matrix).
"""

from __future__ import annotations

import torch

from dtc_tpu_torch.core.sigma_evolve import _codes_from_uniform
from dtc_tpu_torch.models.drives import slot_unitary, slot_unitary_inverse
from dtc_tpu_torch.ops.diag import zz_z_phase_mask
from dtc_tpu_torch.ops.gates import expect_x, expect_z
from dtc_tpu_torch.ops.kick import apply_uniform_1q_layer
from dtc_tpu_torch.ops.paulis import apply_pauli_string, pauli_string_masks


def make_floquet_params(hs, phis, L: int, *, dtype=torch.complex64):
    """The fused diagonal phase mask of one instance, (2^L,)."""
    return zz_z_phase_mask(hs[:L], phis[:L - 1], L, dtype=dtype)


def evolve_observables(psi0, angles, diag_mask, diag_energy, x_coeff,
                       uniforms, *, L: int, T: int, K: int, p: float,
                       with_x: bool = True):
    """Single-branch evolution emitting E(t) and <Z_q(t)>, t = 0..T-1.

    psi0 (..., 2^L); angles (T, K, 2); diag_mask and diag_energy (2^L,) or
    batched like the state; uniforms (..., T*K, L) f32, or None when
    p == 0. Each cycle first measures
        E = sum_s |psi_s|^2 diag_energy(s) + x_coeff * sum_q <X_q>
    (the x term only if with_x)
    and every <Z_q>, then (cycles t < T-1) applies the K kick slots, each
    followed by its sampled Pauli string, and the diagonal. Returns
    E (..., T) and zs (..., T, L) in the state's real dtype."""
    if p > 0.0:
        codes = _codes_from_uniform(uniforms, p).reshape(
            *uniforms.shape[:-2], T, K, L)
    state = psi0
    energies, zs = [], []
    for t in range(T):
        probs = state.real ** 2 + state.imag ** 2
        e = (probs * diag_energy).sum(-1)
        if with_x:
            xs = sum(expect_x(state, q, L) for q in range(L))
            e = e + x_coeff * xs
        energies.append(e)
        zs.append(torch.stack([expect_z(state, q, L) for q in range(L)], -1))
        if t == T - 1:  # the last cycle's kicks are never measured
            break
        for k in range(K):
            u = slot_unitary(angles[t, k, 0], angles[t, k, 1], psi0.dtype)
            state = apply_uniform_1q_layer(state, u, L)
            if p > 0.0:
                state = apply_pauli_string(
                    state, *pauli_string_masks(codes[..., t, k, :]))
        state = state * diag_mask
    return torch.stack(energies, -1), torch.stack(zs, -2)


def _noise_layer(state, generator, p: float, L: int, active=None):
    """One depolarizing event per qubit on branch pairs (..., 2, 2^L): one
    sampled Pauli string per pair, applied to both branches (the noise acts
    on the whole superposed state). ``active`` (...) bool leaves a pair
    untouched where False."""
    u = torch.rand((*state.shape[:-2], L), generator=generator,
                   dtype=torch.float32, device=state.device)
    codes = _codes_from_uniform(u, p)
    if active is not None:
        codes = torch.where(active[..., None], codes, 0)
    xm, zm, n_y = pauli_string_masks(codes)
    return apply_pauli_string(state, xm[..., None], zm[..., None],
                              n_y[..., None])


def forward_cycle(state, angles, diag_mask, *, L: int, K: int, p: float,
                  generator=None):
    """One forward Floquet cycle on branch pairs: the K kick slots of
    ``angles`` (K, 2), each followed by its noise event, then the fused
    diagonal."""
    for k in range(K):
        u = slot_unitary(angles[k, 0], angles[k, 1], state.dtype)
        state = apply_uniform_1q_layer(state, u, L)
        if p > 0.0:
            state = _noise_layer(state, generator, p, L)
    return state * diag_mask


def inverse_cycle(state, angles, diag_mask, *, L: int, K: int, p: float,
                  generator=None):
    """One inverse cycle: conj(diagonal), then the inverse slots in reverse
    order, each followed by its noise event."""
    state = state * diag_mask.conj()
    for k in range(K - 1, -1, -1):
        u = slot_unitary_inverse(angles[k, 0], angles[k, 1], state.dtype)
        state = apply_uniform_1q_layer(state, u, L)
        if p > 0.0:
            state = _noise_layer(state, generator, p, L)
    return state


def _branch_pair(psi0, zq_sign):
    """(..., 2, 2^L) pair (|psi>, Z_q|psi>) of a state (..., 2^L)."""
    return torch.stack([psi0, psi0 * zq_sign.to(psi0.dtype)], dim=-2)


def _branch_autocorr(state, zq_sign, ancilla_factor):
    """af * Re <phi1| Z_q |phi2> of branch pairs (..., 2, 2^L) -> (...)."""
    return ancilla_factor * (state[..., 0, :].conj()
                             * zq_sign.to(state.dtype)
                             * state[..., 1, :]).sum(-1).real
