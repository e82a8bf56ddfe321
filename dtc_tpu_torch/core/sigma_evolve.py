"""Sigma-frame trajectory evolution — factored, mask-free noise.

Port of ``dtc_tpu/core/sigma_evolve.py`` (``_codes_from_uniform``,
``_masks_from_codes``, ``presample_noise``, ``forward_cycle_fac``,
``inverse_cycle_fac``, ``sigma_forward_batch``, ``sigma_echo_batch``).

Noise is presampled from a block of uniforms, the Pauli X-part is deferred
into a carried XOR frame sigma (psi(s) = v(s XOR sigma)), and every
per-cycle diagonal correction folds into the kick's kron-group matrices as
column factors; bonds straddling a group boundary apply as (4,) broadcasts.
See the reference module's docstring for the algebra.

Torch idiom: the reference's vmaps over (instance, trajectory[, t]) are a
flattened batch dimension B, its scans are Python loops, and bit masks are
int64 (torch has no shifts on CPU uint32). Every batch entry takes an
optional block of uniforms so that its noise can be fed from the JAX
reference's own draws; without one it draws from a ``torch.Generator``.
"""

from __future__ import annotations

import torch

from dtc_tpu_torch.core.statevector import basis_index
from dtc_tpu_torch.models.drives import slot_unitary, slot_unitary_inverse
from dtc_tpu_torch.ops.diag import z_sign_mask, zz_z_phase_mask
from dtc_tpu_torch.ops.kick import kron, kron_power
from dtc_tpu_torch.utils.profiling import span

_GROUP = 7

DTYPES = {"complex64": torch.complex64, "complex128": torch.complex128}


# ---------------------------------------------------------------------------
# presampling


@span("dtc.feed.uniforms")
def draw_uniforms(shape, *, generator=None, device=None) -> torch.Tensor:
    """f32 uniform(0, 1) block, the port's stand-in for the reference's
    per-trajectory ``jax.random.uniform`` draws."""
    return torch.rand(shape, generator=generator, dtype=torch.float32,
                      device=device)


def _codes_from_uniform(u: torch.Tensor, p: float) -> torch.Tensor:
    """uniform(0,1) -> Pauli codes with P(I)=1-3p/4, P(X/Y/Z)=p/4 each.

    The arithmetic is the reference's, in f32: thresholds and the divisor
    are rounded to f32 first (JAX's weak-typed Python scalars), and the
    divisor is a full tensor so no reciprocal-multiply shortcut applies.
    """
    q = 0.25 * p
    thr = torch.tensor(1.0 - 3.0 * q, dtype=torch.float32, device=u.device)
    den = torch.full_like(u, max(q, 1e-30))
    above = (u >= thr).to(torch.int64)
    c = above * (1 + torch.floor((u - thr) / den).to(torch.int64))
    return torch.clamp(c, 0, 3)


def _masks_from_codes(codes: torch.Tensor, L: int):
    """(..., L) codes -> (xmask, zmask) int64 over the last axis."""
    weights = 1 << torch.arange(L, dtype=torch.int64, device=codes.device)
    is_x = (codes == 1) | (codes == 2)
    is_z = codes >= 2
    xm = torch.where(is_x, weights, 0).sum(-1)
    zm = torch.where(is_z, weights, 0).sum(-1)
    return xm, zm


def xor_scan(masks: torch.Tensor, L: int) -> torch.Tensor:
    """Inclusive XOR prefix scan of (..., n) L-bit masks along the last axis."""
    sh = torch.arange(L, dtype=torch.int64, device=masks.device)
    bits = (masks[..., None] >> sh) & 1
    par = torch.cumsum(bits, dim=-2) & 1
    return (par << sh).sum(-1)


def presample_noise(u: torch.Tensor, p: float, L: int):
    """(..., n_events, L) uniforms -> per-event (xmask, zmask,
    sigma_before, sigma_csum), each (..., n_events) int64."""
    codes = _codes_from_uniform(u, p)
    xm, zm = _masks_from_codes(codes, L)
    csum = xor_scan(xm, L)
    sigma_before = torch.cat([torch.zeros_like(csum[..., :1]),
                              csum[..., :-1]], dim=-1)
    return xm, zm, sigma_before, csum


# ---------------------------------------------------------------------------
# small per-cycle builders (sizes <= 2^group per trajectory, never 2^L)


def _bits(mask: torch.Tensor, n: int) -> torch.Tensor:
    """(B,) masks -> (B, n) bits."""
    return (mask[:, None] >> torch.arange(n, device=mask.device)) & 1


def _sigma_signs(sigma, L, dtype):
    return (1 - 2 * _bits(sigma, L)).to(dtype)


def _group_column_factors(q0, k, pend_zm, diag_sig, exp_h, exp_p, L, dtype):
    """(B, 2^k) complex column factors for qubits [q0, q0+k): noise signs
    from pend_zm, per-qubit diag corrections where diag_sig flips q, and
    in-group bond factors where the bond sign flipped."""
    dev = exp_h.device
    j = torch.arange(1 << k, device=dev)
    B = pend_zm.shape[0]
    one = torch.ones((), dtype=dtype, device=dev)
    out = torch.ones((B, 1 << k), dtype=dtype, device=dev)
    sig_bits = _bits(diag_sig, L)
    zm_bits = _bits(pend_zm, L)
    for q in range(q0, q0 + k):
        bit = (j >> (q - q0)) & 1
        nsign = torch.where(zm_bits[:, q:q + 1] * bit == 1, -1.0, 1.0)
        fq = torch.where(bit == 0, exp_h[:, q:q + 1], exp_h[:, q:q + 1].conj())
        fq = torch.where(sig_bits[:, q:q + 1] == 1, fq, one)
        out = out * (nsign * fq)
    for b in range(q0, min(q0 + k - 1, L - 1)):
        flip = sig_bits[:, b:b + 1] ^ sig_bits[:, b + 1:b + 2]
        zz_pos = ((j >> (b - q0)) & 1) == ((j >> (b + 1 - q0)) & 1)
        gb = torch.where(zz_pos, exp_p[:, b:b + 1], exp_p[:, b:b + 1].conj())
        out = out * torch.where(flip == 1, gb, one)
    return out


def _straddle_factor(state, b, diag_sig, exp_p, L, dtype):
    """Bond b straddling a group boundary: multiply by the (4,) diagonal
    [g, g*, g*, g] on qubits (b, b+1) via an axis reshape."""
    sig_bits = _bits(diag_sig, L)
    flip = (sig_bits[:, b] ^ sig_bits[:, b + 1]) == 1
    g = torch.where(flip, exp_p[:, b], torch.ones((), dtype=dtype,
                                                  device=exp_p.device))
    vec4 = torch.stack([g, g.conj(), g.conj(), g], dim=-1)  # (B, 4)
    B, total = state.shape
    s = state.reshape(B, total >> (b + 2), 4, 1 << b)
    return (s * vec4[:, None, :, None]).reshape(B, total)


def _group_starts(L):
    return [(q, min(_GROUP, L - q)) for q in range(0, L, _GROUP)]


def _kick_factored(state, theta_x, theta_y, sigma, pend_zm, diag_sig, exp_h,
                   exp_p, *, L, dtype, has_y, inverse=False):
    """Sigma-conjugated kick on a (B, 2^L) state with pending noise signs and
    diag-correction factors folded into the kron-group columns. theta_x and
    theta_y are (B,) angles."""
    starts = _group_starts(L)
    for q0, k in starts[:-1]:
        b = q0 + k - 1
        if b < L - 1:
            state = _straddle_factor(state, b, diag_sig, exp_p, L, dtype)
    make = slot_unitary_inverse if inverse else slot_unitary
    if has_y:
        s = _sigma_signs(sigma, L, theta_y.dtype)                  # (B, L)
        us = make(theta_x[:, None], s * theta_y[:, None], dtype)   # (B,L,2,2)
    else:
        u = make(theta_x, theta_y, dtype)                          # (B,2,2)
    B, total = state.shape
    for q0, k in starts:
        if has_y:
            uk = us[:, q0 + k - 1]
            for jq in range(k - 2, -1, -1):
                uk = kron(uk, us[:, q0 + jq])
        else:
            uk = kron_power(u, k) if k > 1 else u
        cols = _group_column_factors(q0, k, pend_zm, diag_sig, exp_h, exp_p,
                                     L, dtype)
        uk = uk * cols[:, None, :]
        s2 = state.reshape(B, total >> (q0 + k), 1 << k, 1 << q0)
        state = torch.einsum("bxy,bhyl->bhxl", uk, s2).reshape(B, total)
    return state


# ---------------------------------------------------------------------------
# cycles (pending = (zm, diag_sig) int64 (B,): what the next kick absorbs)


def _per_b(x, B):
    """Broadcast a scalar or (B,) tensor angle to (B,)."""
    return torch.as_tensor(x).expand(B) if torch.as_tensor(x).dim() == 0 else x


def forward_cycle_fac(state, pending, ang, exp_h, exp_p, ev, *, L, K, p,
                      dtype, has_y):
    """Forward cycle's kicks on (B, 2^L); the caller then applies the
    instance diagonal D0. ang (K, 2) or (B, K, 2); ev = (zm (B, K),
    sig_b (B, K), sig_after (B,))."""
    pend_zm, pend_sig = pending
    B = state.shape[0]
    zero = torch.zeros_like(pend_zm)
    if p <= 0.0:
        for k in range(K):
            state = _kick_factored(
                state, _per_b(ang[..., k, 0], B), _per_b(ang[..., k, 1], B),
                zero, zero, zero, exp_h, exp_p, L=L, dtype=dtype,
                has_y=False)
        return state, pending
    zm, sig_b, sig_after = ev
    for k in range(K):
        state = _kick_factored(
            state, _per_b(ang[..., k, 0], B), _per_b(ang[..., k, 1], B),
            sig_b[:, k], pend_zm, pend_sig, exp_h, exp_p, L=L, dtype=dtype,
            has_y=has_y)
        pend_zm, pend_sig = zm[:, k], zero
    return state, (pend_zm, sig_after)


def inverse_cycle_fac(state, pending, ang, exp_hc, exp_pc, ev, *, L, K,
                      p, dtype, has_y):
    """Inverse cycle on a state the caller has multiplied by conj(D0): its
    sigma correction, at sig_b[0], folds into the first inverse kick,
    XOR-composed with any pending one; then inverse slots each followed by
    a noise event."""
    pend_zm, pend_sig = pending
    B = state.shape[0]
    zero = torch.zeros_like(pend_zm)
    if p <= 0.0:
        for k in range(K - 1, -1, -1):
            state = _kick_factored(
                state, _per_b(ang[..., k, 0], B), _per_b(ang[..., k, 1], B),
                zero, zero, zero, exp_hc, exp_pc, L=L, dtype=dtype,
                has_y=False, inverse=True)
        return state, pending
    zm, sig_b, _sig_after = ev
    for j in range(K):
        slot = K - 1 - j
        dsig = (sig_b[:, 0] ^ pend_sig) if j == 0 else zero
        state = _kick_factored(
            state, _per_b(ang[..., slot, 0], B), _per_b(ang[..., slot, 1], B),
            sig_b[:, j], pend_zm, dsig, exp_hc, exp_pc, L=L, dtype=dtype,
            has_y=has_y, inverse=True)
        pend_zm, pend_sig = zm[:, j], zero
    return state, (pend_zm, pend_sig)


def _measure_single_autocorr(state, sigma, zq, q, s0, ancilla_factor):
    """A(t) = af * s0 * (1 - 2 sigma_q) * sum |v|^2 z_q on (B, 2^L)."""
    sq = (1 - 2 * ((sigma >> q) & 1)).to(zq.dtype)
    val = ((state.real ** 2 + state.imag ** 2) * zq).sum(-1)
    return ancilla_factor * s0 * sq * val


def _instance_tables(hs, phis, L, dtype):
    """Per-instance D0 (inst, 2^L) and unit factors exp(i h), exp(i phi),
    the latter from f32-rounded angles as the reference builds them."""
    d0 = torch.stack([zz_z_phase_mask(h, ph, L, dtype=dtype)
                      for h, ph in zip(hs, phis)])
    exp_h = torch.exp(1j * hs.to(torch.float32)).to(dtype)
    exp_p = torch.exp(1j * phis.to(torch.float32)).to(dtype)
    return d0, exp_h, exp_p


def _repeat_rows(x, reps):
    """(inst, ...) -> (inst * reps, ...) with each instance row repeated."""
    return x.repeat_interleave(reps, dim=0)


# ---------------------------------------------------------------------------
# batched drivers


def sigma_forward_batch(hs, phis, angles, uniforms=None, *, L, T, K, p, q,
                        initial_state, dtype_name, ancilla_factor, has_y,
                        n_traj=None, generator=None):
    """(inst, L), (inst, L-1), (T, K, 2) -> (inst, c, T) real tensor.

    uniforms: (inst, c, T*K, L) f32, the block ``presample_noise`` draws
    per trajectory in the reference; drawn from ``generator`` when None
    (then ``n_traj`` gives c)."""
    dtype = DTYPES[dtype_name]
    real = torch.float64 if dtype == torch.complex128 else torch.float32
    dev = hs.device
    inst = hs.shape[0]
    if uniforms is None:
        uniforms = draw_uniforms((inst, n_traj, T * K, L),
                                 generator=generator, device=dev)
    c = uniforms.shape[1]
    B = inst * c
    b0 = basis_index(L, initial_state)
    s0 = 1.0 if ((b0 >> q) & 1) == 0 else -1.0
    zq = z_sign_mask(q, L, dtype=torch.float32, device=dev)
    d0, exp_h, exp_p = _instance_tables(hs, phis, L, dtype)
    exp_h = _repeat_rows(exp_h, c)
    exp_p = _repeat_rows(exp_p, c)
    d0 = d0[:, None, :]

    if p > 0.0:
        _, zm, sig_b, csum = presample_noise(
            uniforms.reshape(B, T * K, L), p, L)
        zm = zm.reshape(B, T, K)
        sig_b = sig_b.reshape(B, T, K)
        sig_after = csum.reshape(B, T, K)[:, :, -1]
        sig_start = torch.cat([torch.zeros_like(sig_after[:, :1]),
                               sig_after[:, :-1]], dim=1)
    else:
        zm = sig_b = torch.zeros((B, T, K), dtype=torch.int64, device=dev)
        sig_after = sig_start = torch.zeros((B, T), dtype=torch.int64,
                                            device=dev)

    state = torch.zeros((B, 1 << L), dtype=dtype, device=dev)
    state[:, b0] = 1.0
    zero = torch.zeros(B, dtype=torch.int64, device=dev)
    pend = (zero, zero)
    out = torch.empty((B, T), dtype=real, device=dev)
    for t in range(T):
        out[:, t] = _measure_single_autocorr(state, sig_start[:, t], zq, q,
                                             s0, ancilla_factor)
        if t == T - 1:
            break  # the last cycle's state is never measured
        state, pend = forward_cycle_fac(
            state, pend, angles[t], exp_h, exp_p,
            (zm[:, t], sig_b[:, t], sig_after[:, t]), L=L, K=K, p=p,
            dtype=dtype, has_y=has_y)
        state = (state.reshape(inst, c, -1) * d0).reshape(B, -1)
    return out.reshape(inst, c, T)


def sigma_echo_batch(hs, phis, angles, ts, uniforms=None, *, L, T, K, p, q,
                     initial_state, dtype_name, ancilla_factor, has_y,
                     n_traj=None, generator=None):
    """-> (inst, c, n_ts) echo values: for each (trajectory, t) pair, t
    forward cycles then t inverse cycles, each followed by its noise event.

    uniforms: (inst, c, 2T*K, L) f32 — one block per trajectory, shared by
    every t, as the reference draws ``uniform(key, (2T, K, L))``."""
    dtype = DTYPES[dtype_name]
    real = torch.float64 if dtype == torch.complex128 else torch.float32
    dev = hs.device
    inst = hs.shape[0]
    if uniforms is None:
        uniforms = draw_uniforms((inst, n_traj, 2 * T * K, L),
                                 generator=generator, device=dev)
    c = uniforms.shape[1]
    ts = torch.as_tensor(ts, dtype=torch.int64, device=dev)
    n_ts = ts.shape[0]
    B = inst * c * n_ts
    b0 = basis_index(L, initial_state)
    s0 = 1.0 if ((b0 >> q) & 1) == 0 else -1.0
    zq = z_sign_mask(q, L, dtype=torch.float32, device=dev)
    d0, exp_h, exp_p = _instance_tables(hs, phis, L, dtype)
    exp_h = _repeat_rows(exp_h, c * n_ts)
    exp_p = _repeat_rows(exp_p, c * n_ts)
    exp_hc, exp_pc = exp_h.conj(), exp_p.conj()
    d0 = d0[:, None, :]
    t_b = ts.repeat(inst * c)                                  # (B,)

    if p > 0.0:
        u = uniforms.reshape(inst * c, 1, 2 * T, K, L).expand(
            -1, n_ts, -1, -1, -1).reshape(B, 2 * T, K, L)
        codes = _codes_from_uniform(u, p)
        step = torch.arange(2 * T, device=dev)
        active = step[None, :] < 2 * t_b[:, None]
        codes = torch.where(active[:, :, None, None], codes, 0)
        _xm, zm = _masks_from_codes(codes, L)
        xm = _xm.reshape(B, 2 * T * K)
        csum = xor_scan(xm, L)
        sig_b = torch.cat([torch.zeros_like(csum[:, :1]), csum[:, :-1]],
                          dim=1).reshape(B, 2 * T, K)
        sig_after = csum.reshape(B, 2 * T, K)[:, :, -1]
    else:
        zm = sig_b = torch.zeros((B, 2 * T, K), dtype=torch.int64, device=dev)
        sig_after = torch.zeros((B, 2 * T), dtype=torch.int64, device=dev)

    state = torch.zeros((B, 1 << L), dtype=dtype, device=dev)
    state[:, b0] = 1.0
    zero = torch.zeros(B, dtype=torch.int64, device=dev)
    pend = (zero, zero)
    kw = dict(L=L, K=K, p=p, dtype=dtype, has_y=has_y)
    n_steps = 2 * int(ts.max()) if n_ts else 0
    for k in range(n_steps):
        fwd = k < t_b
        inv = (k >= t_b) & (k < 2 * t_b)
        ev = (zm[:, k], sig_b[:, k], sig_after[:, k])
        st2, pend2 = state, pend
        if bool(fwd.any()):
            st_f, pend_f = forward_cycle_fac(state, pend, angles[k], exp_h,
                                             exp_p, ev, **kw)
            st_f = (st_f.reshape(inst, c * n_ts, -1) * d0).reshape(B, -1)
            st2 = torch.where(fwd[:, None], st_f, st2)
            pend2 = tuple(torch.where(fwd, a, b) for a, b in zip(pend_f, pend2))
        if bool(inv.any()):
            i_b = torch.clamp(2 * t_b - 1 - k, 0, T - 1)
            st_i = (state.reshape(inst, c * n_ts, -1) * d0.conj()).reshape(B, -1)
            st_i, pend_i = inverse_cycle_fac(st_i, pend, angles[i_b], exp_hc,
                                             exp_pc, ev, **kw)
            st2 = torch.where(inv[:, None], st_i, st2)
            pend2 = tuple(torch.where(inv, a, b) for a, b in zip(pend_i, pend2))
        state, pend = st2, pend2
    out = _measure_single_autocorr(state, sig_after[:, -1], zq, q, s0,
                                   ancilla_factor)
    return out.to(real).reshape(inst, c, n_ts)
