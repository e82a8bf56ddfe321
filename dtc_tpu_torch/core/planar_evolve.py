"""Planar sigma-frame forward engine for constant x drives.

Port of ``dtc_tpu/core/planar_evolve.py`` (``_group_starts``,
``_rx_kron_planar``, ``_planar_matmul``, ``planar_forward_batch``). The
state is a batch of separate (re, im) f32 planes, (B, 2, 2^L). A cycle is
the RX kick as groups of up to 7 sites, each one real kron matrix pair
applied with ``torch.matmul`` (TF32 off, ``ops/precision.py``), then the
constant instance diagonal D0, then, when p > 0, kernel K11
(``ops/noise_factor.py``) once per cycle for the whole batch: the sampled
Pauli Z-sign and the sigma-frame correction of the diagonal. A(t) is
measured at the start of each cycle, times the sign of sigma_q at the cycle
start and ``ancilla_factor * s0``.

Noise is injected (ROADMAP.md porting rule 2): uniforms (inst, c, T, L), the
block the reference's ``presample_noise`` draws per trajectory. The last
cycle's evolution, which the reference computes and never measures, is not
run.
"""

from __future__ import annotations

import torch

from dtc_tpu_torch.core.sigma_evolve import draw_uniforms, presample_noise
from dtc_tpu_torch.core.statevector import basis_index
from dtc_tpu_torch.ops.diag import z_sign_mask, zz_z_diag_energy
from dtc_tpu_torch.ops.kick import kron
from dtc_tpu_torch.ops.noise_factor import apply_noise_factor, pack_cycle_params

_GROUP = 7


def _group_starts(L, group=_GROUP):
    """[(q0, k)]: the kick's site groups, k <= group sites from q0."""
    return [(q, min(group, L - q)) for q in range(0, L, group)]


def _rx_kron_planar(theta, k, device=None):
    """Real and imaginary parts of RX(theta)^{(x)k}, f32 (theta rounded to
    f32 first, as the reference does)."""
    theta = torch.as_tensor(theta, dtype=torch.float32, device=device)
    c, s = torch.cos(theta / 2), torch.sin(theta / 2)
    rr = torch.eye(2, dtype=torch.float32, device=device) * c
    ri = torch.tensor([[0.0, -1.0], [-1.0, 0.0]], dtype=torch.float32,
                      device=device) * s
    kr, ki = rr, ri
    for _ in range(k - 1):
        kr, ki = (kron(kr, rr) - kron(ki, ri), kron(kr, ri) + kron(ki, rr))
    return kr, ki


def _planar_matmul(state, ukr, uki, q0, k):
    """The group's kron pair on sites [q0, q0+k) of (B, 2, N) planes; the
    lowest group as one product with the transposed pair (rows of 2^k
    consecutive amplitudes), the others batched over the high bits."""
    B, _, N = state.shape
    if q0 == 0:
        re = state[:, 0].reshape(-1, 1 << k)
        im = state[:, 1].reshape(-1, 1 << k)
        re2 = re @ ukr.T - im @ uki.T
        im2 = im @ ukr.T + re @ uki.T
    else:
        re = state[:, 0].reshape(B, N >> (q0 + k), 1 << k, 1 << q0)
        im = state[:, 1].reshape(B, N >> (q0 + k), 1 << k, 1 << q0)
        re2 = ukr @ re - uki @ im
        im2 = ukr @ im + uki @ re
    return torch.stack([re2.reshape(B, N), im2.reshape(B, N)], 1)


def planar_forward_batch(hs, phis, angles, uniforms=None, *, L, T, p, q,
                         initial_state, ancilla_factor, n_traj=None,
                         generator=None) -> torch.Tensor:
    """(inst, L), (inst, L-1), (T, 1, 2) -> (inst, c, T) f32 A(t).

    x-polarized forward autocorrelator of a constant x drive (only
    angles[0, 0, 0] is read) from a Z-eigenstate. uniforms (inst, c, T, L)
    f32; drawn from ``generator`` when None and p > 0 (then ``n_traj``
    gives c)."""
    dev = hs.device
    inst = hs.shape[0]
    N = 1 << L
    if p > 0.0 and uniforms is None:
        uniforms = draw_uniforms((inst, n_traj, T, L), generator=generator,
                                 device=dev)
    c = uniforms.shape[1] if uniforms is not None else n_traj
    B = inst * c
    b0 = basis_index(L, initial_state)
    s0 = 1.0 if ((b0 >> q) & 1) == 0 else -1.0
    zq = z_sign_mask(q, L, device=dev)
    h32, ph32 = hs.to(torch.float32), phis.to(torch.float32)
    e0 = torch.stack([zz_z_diag_energy(h, ph, L, dtype=torch.float32)
                      for h, ph in zip(h32, ph32)])            # (inst, N)
    d0r = torch.cos(-0.5 * e0)[:, None, :]
    d0i = torch.sin(-0.5 * e0)[:, None, :]
    theta = angles[0, 0, 0].to(torch.float32)
    kicks = [(q0, k, *_rx_kron_planar(theta, k, dev))
             for q0, k in _group_starts(L)]
    if p > 0.0:
        _, zm, _, csum = presample_noise(uniforms.reshape(B, T, L), p, L)
        h_b = h32.repeat_interleave(c, 0)[:, None, :]
        ph_b = ph32.repeat_interleave(c, 0)[:, None, :]
        params = pack_cycle_params(zm, csum, h_b, ph_b, L)       # (B, T, 8, 128)
        params = params.transpose(0, 1).contiguous()             # (T, B, 8, 128)
        sig_after = csum
    else:
        sig_after = torch.zeros((B, T), dtype=torch.int64, device=dev)

    state = torch.zeros((B, 2, N), dtype=torch.float32, device=dev)
    state[:, 0, b0] = 1.0
    a = torch.empty((B, T), dtype=torch.float32, device=dev)
    for t in range(T):
        a[:, t] = (state[:, 0].square() + state[:, 1].square()) @ zq
        if t == T - 1:
            break  # the last cycle's state is never measured
        for q0, k, ukr, uki in kicks:
            state = _planar_matmul(state, ukr, uki, q0, k)
        st = state.reshape(inst, c, 2, N)
        re, im = st[:, :, 0], st[:, :, 1]
        state = torch.stack([re * d0r - im * d0i, re * d0i + im * d0r],
                            2).reshape(B, 2, N)
        if p > 0.0:
            state = apply_noise_factor(state, params[t], L=L)
    # A(t) takes the sign of sigma_q at the cycle's start
    sig_start = torch.cat([torch.zeros_like(sig_after[:, :1]),
                           sig_after[:, :-1]], 1)
    sq = (1 - 2 * ((sig_start >> q) & 1)).to(torch.float32)
    return (ancilla_factor * s0 * sq * a).reshape(inst, c, T)
