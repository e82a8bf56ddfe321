"""Eager Floquet engines: the observables engine, the branch-pair cycles
and the direct-mode autocorrelator.

Port of ``dtc_tpu/core/evolve.py`` (``make_floquet_params``,
``evolve_observables``, ``forward_cycle``, ``inverse_cycle``,
``_noise_layer``, ``_branch_pair``, ``_branch_autocorr``,
``autocorr_forward``, ``autocorr_echo``). The reference's scan over cycles
is a Python loop and its vmap over trajectories a batch dimension.

``evolve_observables`` (energy E(t) and every <Z_q(t)>) serves what the
observables kernel (``ops/observables.py``, K5) does not: complex128, and
every L or schedule length outside K5's range. Its ``key`` becomes an
injected block of uniforms laid out as the reference draws them,
``uniform(key, (T, K, L))`` row-major, i.e. (..., T*K, L).

The cycle functions act on branch pairs (..., 2, 2^L), (phi1, phi2) =
(|psi>, Z_q|psi>) evolved under the same noise, and serve the carried
adaptive stepper (``experiments/adaptive.py``) and the autocorrelator.
Their noise is one uniform per qubit, slot and pair, through the
reference's ``_codes_from_uniform``, one Pauli string per pair applied to
both branches: injected (``uniforms``, (..., K, L) a cycle) or drawn slot
by slot from an explicit ``torch.Generator``. ``autocorr_forward`` and
``autocorr_echo`` take the reference's per-slot draws as one block,
forward (..., T, K, L) (cycle t, slot k: ``uniform(fold_in(split(key,
T)[t], k), (L,))``) and echo (..., 2T, K, L) (step k, position j:
``uniform(fold_in(split(key, 2T)[k], j), (L,))``), or draw it from a
generator seeded with ``seed``.
"""

from __future__ import annotations

import torch

from dtc_tpu_torch.core.sigma_evolve import _codes_from_uniform, draw_uniforms
from dtc_tpu_torch.models.drives import slot_unitary, slot_unitary_inverse
from dtc_tpu_torch.ops.diag import z_sign_mask, zz_z_phase_mask
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


def _noise_layer(state, generator, p: float, L: int, active=None, u=None):
    """One depolarizing event per qubit on branch pairs (..., 2, 2^L): one
    sampled Pauli string per pair, applied to both branches (the noise acts
    on the whole superposed state). ``u`` (..., L) are the pairs' uniforms,
    drawn from ``generator`` when None. ``active`` (...) bool leaves a pair
    untouched where False."""
    if u is None:
        u = torch.rand((*state.shape[:-2], L), generator=generator,
                       dtype=torch.float32, device=state.device)
    codes = _codes_from_uniform(u.to(state.device), p)
    if active is not None:
        codes = torch.where(active[..., None], codes, 0)
    xm, zm, n_y = pauli_string_masks(codes)
    return apply_pauli_string(state, xm[..., None], zm[..., None],
                              n_y[..., None])


def _slot_uniforms(uniforms, j):
    return None if uniforms is None else uniforms[..., j, :]


def forward_cycle(state, angles, diag_mask, *, L: int, K: int, p: float,
                  generator=None, uniforms=None):
    """One forward Floquet cycle on branch pairs: the K kick slots of
    ``angles`` (K, 2), each followed by its noise event (slot k's
    uniforms ``uniforms[..., k, :]``, else drawn from ``generator``), then
    the fused diagonal."""
    for k in range(K):
        u = slot_unitary(angles[k, 0], angles[k, 1], state.dtype)
        state = apply_uniform_1q_layer(state, u, L)
        if p > 0.0:
            state = _noise_layer(state, generator, p, L,
                                 u=_slot_uniforms(uniforms, k))
    return state * diag_mask


def inverse_cycle(state, angles, diag_mask, *, L: int, K: int, p: float,
                  generator=None, uniforms=None):
    """One inverse cycle: conj(diagonal), then the inverse slots in reverse
    order, each followed by its noise event (the j-th applied takes
    ``uniforms[..., j, :]``, as the reference folds its key by position)."""
    state = state * diag_mask.conj()
    for j, k in enumerate(range(K - 1, -1, -1)):
        u = slot_unitary_inverse(angles[k, 0], angles[k, 1], state.dtype)
        state = apply_uniform_1q_layer(state, u, L)
        if p > 0.0:
            state = _noise_layer(state, generator, p, L,
                                 u=_slot_uniforms(uniforms, j))
    return state


def _branch_pair(psi0, zq_sign):
    """(..., 2, 2^L) pair (|psi>, Z_q|psi>) of a state (..., 2^L)."""
    return torch.stack([psi0, psi0 * zq_sign.to(psi0.dtype)], dim=-2)


def _branch_autocorr(state, zq_sign, ancilla_factor):
    """af * Re <phi1| Z_q |phi2> of branch pairs (..., 2, 2^L) -> (...)."""
    return ancilla_factor * (state[..., 0, :].conj()
                             * zq_sign.to(state.dtype)
                             * state[..., 1, :]).sum(-1).real


def _autocorr_uniforms(uniforms, shape, p, seed, device):
    if p <= 0.0:
        return None
    if uniforms is None:
        gen = torch.Generator(device=device).manual_seed(seed)
        return draw_uniforms(shape, generator=gen, device=device)
    return torch.as_tensor(uniforms, dtype=torch.float32, device=device)


def autocorr_forward(psi0, angles, diag_mask, uniforms=None, *, L: int,
                     T: int, K: int, p: float, q: int,
                     ancilla_factor: float = 1.0, seed: int = 0):
    """A(t), t = 0..T-1, of the branch pair (|psi0>, Z_q|psi0>) in one
    pass over the cycles: measured at each cycle's start, then the cycle.

    psi0 (..., 2^L); angles (T, K, 2); diag_mask (2^L,); uniforms
    (..., T, K, L) f32 or None (drawn from a generator seeded with
    ``seed`` when p > 0). Returns (..., T) in the state's real dtype. The
    last cycle, which the reference evolves and never measures, is not
    run."""
    zq = z_sign_mask(q, L, device=psi0.device)
    state = _branch_pair(psi0, zq)
    u = _autocorr_uniforms(uniforms, (*psi0.shape[:-1], T, K, L), p, seed,
                           psi0.device)
    out = []
    for t in range(T):
        out.append(_branch_autocorr(state, zq, ancilla_factor))
        if t < T - 1:
            state = forward_cycle(
                state, angles[t], diag_mask, L=L, K=K, p=p,
                uniforms=None if u is None else u[..., t, :, :])
    return torch.stack(out, -1)


def autocorr_echo(psi0, angles, diag_mask, uniforms, t_value, *, L: int,
                  T: int, K: int, p: float, q: int,
                  ancilla_factor: float = 1.0, seed: int = 0):
    """Echo A0(t) for one t: t forward cycles, then t inverse cycles in
    reverse time order, step k taking ``uniforms[..., k, :, :]``.

    uniforms (..., 2T, K, L) f32 or None (drawn from a generator seeded
    with ``seed`` when p > 0), shared by every t. The reference's masked
    scan of 2T steps runs identities from step 2t on; only the 2t active
    steps run here. Returns (...) in the state's real dtype."""
    t_value = int(t_value)
    zq = z_sign_mask(q, L, device=psi0.device)
    state = _branch_pair(psi0, zq)
    u = _autocorr_uniforms(uniforms, (*psi0.shape[:-1], 2 * T, K, L), p,
                           seed, psi0.device)
    for k in range(2 * t_value):
        uk = None if u is None else u[..., k, :, :]
        if k < t_value:
            state = forward_cycle(state, angles[k], diag_mask, L=L, K=K, p=p,
                                  uniforms=uk)
        else:
            state = inverse_cycle(state, angles[2 * t_value - 1 - k],
                                  diag_mask, L=L, K=K, p=p, uniforms=uk)
    return _branch_autocorr(state, zq, ancilla_factor)
