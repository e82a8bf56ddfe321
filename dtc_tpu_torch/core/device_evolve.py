"""Floquet evolution under device-noise models (calibration-derived).

Port of ``dtc_tpu/core/device_evolve.py``. Against the flat depolarizing
model a device-noise cycle has per-site 1q depolarizing rates after each
kick gate (``events_per_kick`` events, default 2: rx transpiles to two sx
pulses on heavy-hex hardware), per-bond 2q depolarizing after each RZZ
sublayer (so the diagonal splits into even-bond, odd-bond and field masks),
and readout errors as exact (1 - 2 eps) contractions (the caller's
``ancilla_factor``). Engines, as in the reference:

- the dense gather engine (``device_autocorr_forward``,
  ``device_autocorr_echo``): gate by gate on complex states, any drive;
- the sigma-frame engines (``device_sigma_forward_batch``,
  ``device_sigma_echo_batch``): constant x drives, the X parts of the
  events in a carried XOR frame;
- the x kernel rows (``device_kernel_forward_batch``,
  ``device_echo_pair_tiles``, ``device_kernel_echo_batch``): the events
  packed into the compact rows of the x kernels (K3, K1/K2, the streamed
  family), which run unchanged;
- the lab-frame rows (``_device_general_rows``,
  ``device_general_kernel_forward_batch``, ``_device_general_echo_rows``,
  ``device_general_kernel_echo_batch``): the bond events commuted into the
  final slot's Pauli hook of the lab-frame kernels (K4 here; K10's
  shard-local forms through ``parallel/sharded.py``), with their
  original-order oracles ``device_general_forward_oracle`` and
  ``device_general_echo_oracle``.

Noise is injected (ROADMAP.md porting rule 2). An engine takes its uniforms
in the shapes the reference draws them per trajectory, with the
trajectories first: ``(u1, ue, uo)`` with u1 (n, T, E, L) for the 1q events
(E = events_per_kick, or K * events_per_kick slot-major for the lab-frame
and gather engines), ue (n, T, ceil((L-1)/2)) and uo (n, T, floor((L-1)/2))
for the even and odd bond events; the echoes take 2T steps, shared by every
t. The reference's presamplers draw them as ``split(key, 3)`` then
``uniform(k1, (T, E, L))``, ``uniform(k2, ...)``, ``uniform(k3, ...)``; its
gather engine per cycle key ``split(key, T)[t]`` as ``fold_in(k_t, 7k +
ev)``, 101 and 102 (the gather echo's inverse steps 7k + ev + 300, 201 and
202 on the same step key, a second set of the same shapes). Engines take one
instance (hs (L,), phis (L-1,)); bit masks are int64.
"""

from __future__ import annotations

import torch

from dtc_tpu_torch.core.sigma_evolve import (
    DTYPES,
    _bits,
    _group_starts,
    _masks_from_codes,
    _straddle_factor,
    xor_scan,
)
from dtc_tpu_torch.core.statevector import basis_index
from dtc_tpu_torch.models.drives import slot_unitary, slot_unitary_inverse
from dtc_tpu_torch.ops import resident_general
from dtc_tpu_torch.ops.diag import z_sign_mask, zz_z_phase_mask
from dtc_tpu_torch.ops.kick import apply_uniform_1q_layer, kron_power
from dtc_tpu_torch.ops.params import (
    echo_width,
    forward_width,
    pack_device_cycle_params_compact,
)
from dtc_tpu_torch.ops.params_general import (
    general_echo_rows,
    general_forward_rows,
)
from dtc_tpu_torch.ops.paulis import (
    _parity,
    apply_pauli_string,
    pauli_string_masks,
    sample_bond_depolarizing_codes,
    sample_depolarizing_codes,
)
from dtc_tpu_torch.ops.routes import ROUTES, engine_for, x_route


def n_bonds(L: int) -> tuple[int, int]:
    """(even, odd) bond counts of an L-site chain: the widths of ue, uo."""
    return L // 2, (L - 1) // 2


def _s0(L, initial_state, q):
    b0 = basis_index(L, initial_state)
    return 1.0 if ((b0 >> q) & 1) == 0 else -1.0


def _basis(n, L, initial_state, dtype, dev):
    st = torch.zeros((n, 1 << L), dtype=dtype, device=dev)
    st[:, basis_index(L, initial_state)] = 1.0
    return st


def _masks_split(hs, phis, L, dtype):
    """(even-bond, odd-bond, field) phase masks whose product is the fused
    one."""
    idx = torch.arange(L - 1, device=phis.device)
    zeros_h = torch.zeros_like(hs)
    zeros_p = torch.zeros_like(phis)
    m_even = zz_z_phase_mask(zeros_h, torch.where(idx % 2 == 0, phis, 0.0),
                             L, dtype=dtype)
    m_odd = zz_z_phase_mask(zeros_h, torch.where(idx % 2 == 1, phis, 0.0),
                            L, dtype=dtype)
    m_field = zz_z_phase_mask(hs, zeros_p, L, dtype=dtype)
    return m_even, m_odd, m_field


def _apply_codes(state, codes):
    xm, zm, ny = pauli_string_masks(codes)
    return apply_pauli_string(state, xm, zm, ny)


def _apply_masks(state, xm, zm):
    """A Pauli string from its (x, z) masks, global phase dropped."""
    return apply_pauli_string(state, xm, zm, 0)


def _measure(state, q, L):
    zq = z_sign_mask(q, L, dtype=state.real.dtype, device=state.device)
    return (state.real.square() + state.imag.square()) @ zq


# ---------------------------------------------------------------------------
# dense gather engine (any drive)


def device_forward_cycle(state, ang, masks, p_1q, p_2q, u1, ue, uo, *, L, K,
                         dtype, events_per_kick=2):
    """One device-noise cycle on (n, 2^L): per slot the kick, then its
    events; the even-bond sublayer and its event, the odd one and its
    event, the field. u1 (n, K*E, L), ue (n, even bonds), uo (n, odd)."""
    m_even, m_odd, m_field = masks
    for k in range(K):
        state = apply_uniform_1q_layer(
            state, slot_unitary(ang[k, 0], ang[k, 1], dtype), L)
        for ev in range(events_per_kick):
            codes = sample_depolarizing_codes(
                u1[:, k * events_per_kick + ev], p_1q)
            state = _apply_codes(state, codes)
    state = state * m_even
    state = _apply_codes(state, sample_bond_depolarizing_codes(
        ue, p_2q[0::2], 0, L))
    state = state * m_odd
    state = _apply_codes(state, sample_bond_depolarizing_codes(
        uo, p_2q[1::2], 1, L))
    return state * m_field  # rz is virtual on hardware: no error


def device_inverse_cycle(state, ang, masks, p_1q, p_2q, u1, ue, uo, *, L, K,
                         dtype, events_per_kick=2):
    """Inverse cycle: the sublayers reversed, the gates daggered, each
    followed by its events (u1 indexed by the cycle's slot, as the
    reference's salts 7k + ev + 300)."""
    m_even, m_odd, m_field = masks
    state = state * m_field.conj() * m_odd.conj()
    state = _apply_codes(state, sample_bond_depolarizing_codes(
        uo, p_2q[1::2], 1, L))
    state = state * m_even.conj()
    state = _apply_codes(state, sample_bond_depolarizing_codes(
        ue, p_2q[0::2], 0, L))
    for k in range(K - 1, -1, -1):
        state = apply_uniform_1q_layer(
            state, slot_unitary_inverse(ang[k, 0], ang[k, 1], dtype), L)
        for ev in range(events_per_kick):
            state = _apply_codes(state, sample_depolarizing_codes(
                u1[:, k * events_per_kick + ev], p_1q))
    return state


def device_autocorr_forward(hs, phis, p_1q, p_2q, angles, uniforms, *, L, T,
                            K, q, initial_state="vacuum",
                            dtype_name="complex64", ancilla_factor=1.0,
                            events_per_kick=2) -> torch.Tensor:
    """Trajectory-batched A(t) on the gather engine: uniforms (u1 (n, T,
    K*E, L), ue, uo) -> (n, T). ``ancilla_factor`` carries the ancilla's
    events and the readout contractions."""
    u1, ue, uo = uniforms
    dtype = DTYPES[dtype_name]
    masks = _masks_split(hs, phis, L, dtype)
    s0 = _s0(L, initial_state, q)
    st = _basis(u1.shape[0], L, initial_state, dtype, hs.device)
    out = []
    for t in range(T):
        out.append(ancilla_factor * s0 * _measure(st, q, L))
        if t == T - 1:
            break  # the last cycle's state is never measured
        st = device_forward_cycle(st, angles[t], masks, p_1q, p_2q, u1[:, t],
                                  ue[:, t], uo[:, t], L=L, K=K, dtype=dtype,
                                  events_per_kick=events_per_kick)
    return torch.stack(out, 1)


def device_autocorr_echo(hs, phis, p_1q, p_2q, angles, uniforms, ts, *, L,
                         T, K, q, initial_state="vacuum",
                         dtype_name="complex64", ancilla_factor=1.0,
                         events_per_kick=2) -> torch.Tensor:
    """Trajectory-batched echo A0(t) on the gather engine: uniforms (u1f,
    uef, uof, u1i, uei, uoi), the forward and inverse steps' draws, each
    (n, 2T, ...) -> (n, n_ts). Step k < t is forward cycle k, then inverse
    cycle 2t-1-k; the reference's masked steps past 2t are the identity."""
    u1f, uef, uof, u1i, uei, uoi = uniforms
    dtype = DTYPES[dtype_name]
    masks = _masks_split(hs, phis, L, dtype)
    s0 = _s0(L, initial_state, q)
    kw = dict(L=L, K=K, dtype=dtype, events_per_kick=events_per_kick)
    out = []
    for t in [int(v) for v in torch.as_tensor(ts).tolist()]:
        st = _basis(u1f.shape[0], L, initial_state, dtype, hs.device)
        for k in range(2 * t):
            if k < t:
                st = device_forward_cycle(st, angles[k], masks, p_1q, p_2q,
                                          u1f[:, k], uef[:, k], uof[:, k],
                                          **kw)
            else:
                ci = min(max(2 * t - 1 - k, 0), T - 1)
                st = device_inverse_cycle(st, angles[ci], masks, p_1q, p_2q,
                                          u1i[:, k], uei[:, k], uoi[:, k],
                                          **kw)
        out.append(ancilla_factor * s0 * _measure(st, q, L))
    return torch.stack(out, 1)


# ---------------------------------------------------------------------------
# presampled events (the sigma, kernel-row and lab-frame engines)


def _device_presample_split(uniforms, p_1q, p_2q, L):
    """Per-event Pauli masks of one block: u1 (..., T, E, L) -> xm1, zm1
    (..., T, E); ue, uo -> xme, zme, xmo, zmo (..., T)."""
    u1, ue, uo = uniforms
    p2 = torch.broadcast_to(torch.as_tensor(p_2q, device=u1.device),
                            (L - 1,))
    xm1, zm1 = _masks_from_codes(sample_depolarizing_codes(u1, p_1q), L)
    xme, zme = _masks_from_codes(
        sample_bond_depolarizing_codes(ue, p2[0::2], 0, L), L)
    xmo, zmo = _masks_from_codes(
        sample_bond_depolarizing_codes(uo, p2[1::2], 1, L), L)
    return xm1, zm1, xme, zme, xmo, zmo


def _compose_1q(xm1, zm1, epk):
    """XOR-compose the epk per-kick 1q events (exact up to a global
    phase)."""
    xm, zm = xm1[..., 0], zm1[..., 0]
    for e in range(1, epk):
        xm, zm = xm ^ xm1[..., e], zm ^ zm1[..., e]
    return xm, zm


def _device_presample(uniforms, p_1q, p_2q, epk, L):
    """Per cycle: the combined Z mask and the three sigma checkpoints
    (sig_a after the kick's events, sig_b after the even bond event, sig_c
    at the cycle's end), each (..., T) int64."""
    xm1, zm1, xme, zme, xmo, zmo = _device_presample_split(
        uniforms, p_1q, p_2q, L)
    xm_kick, zm_1q = _compose_1q(xm1, zm1, epk)
    sig_c = xor_scan(xm_kick ^ xme ^ xmo, L)
    sig_a = torch.cat([torch.zeros_like(sig_c[..., :1]), sig_c[..., :-1]],
                      -1) ^ xm_kick
    return zm_1q ^ zme ^ zmo, sig_a, sig_a ^ xme, sig_c


def _device_presample_echo(uniforms, p_1q, p_2q, epk, ts, L):
    """Echo events of 2T steps for every t in ts, zeroed past step 2t: the
    split masks, the step-start sigma and the running sigma, each
    (..., n_ts, 2T), and the (n_ts, 2T) forward / inverse step flags. A
    forward step's events fire kick first, an inverse step's odd bond
    first, but the step-end frame is the XOR of all three either way."""
    xm1, zm1, xme, zme, xmo, zmo = _device_presample_split(
        uniforms, p_1q, p_2q, L)
    xm_kick, zm_1q = _compose_1q(xm1, zm1, epk)
    T2 = xm_kick.shape[-1]
    ts = torch.as_tensor(ts, dtype=torch.int64, device=xm_kick.device)
    step = torch.arange(T2, device=xm_kick.device)
    t_ = ts[:, None]
    act = step < 2 * t_
    ev = [torch.where(act, m[..., None, :], 0)
          for m in (xm_kick, zm_1q, xme, zme, xmo, zmo)]
    csum = xor_scan(ev[0] ^ ev[2] ^ ev[4], L)
    sig0 = torch.cat([torch.zeros_like(csum[..., :1]), csum[..., :-1]], -1)
    fwd = step < t_
    inv = (step >= t_) & act
    return (*ev, sig0, csum, fwd, inv)


# ---------------------------------------------------------------------------
# sigma-frame engines (constant x drives)


def _require_constant_x(angles, fname):
    """The sigma-frame and x-row engines evolve every cycle with
    angles[0, 0]; any other schedule would be wrong physics."""
    ang = angles.detach().cpu()
    if (ang.dim() != 3 or ang.shape[1] != 1
            or not (bool((ang[:, :, 1] == 0).all())
                    and bool((ang == ang[0]).all()))):
        raise ValueError(
            f"{fname} supports only constant x-polarized K=1 kick schedules "
            f"(got shape {tuple(ang.shape)}); use the lab-frame rows or the "
            "gather engine for other drives")


def _device_column_factors(q0, k, pend_zm, sa, sb, sc, exp_h, exp_p, L,
                           dtype):
    """(n, 2^k) column factors with per-class sigmas: field h from sc, even
    bonds from sa, odd bonds from sb."""
    dev = exp_h.device
    j = torch.arange(1 << k, device=dev)
    one = torch.ones((), dtype=dtype, device=dev)
    out = torch.ones((pend_zm.shape[0], 1 << k), dtype=dtype, device=dev)
    bits_c, bits_a, bits_b = _bits(sc, L), _bits(sa, L), _bits(sb, L)
    zm_bits = _bits(pend_zm, L)
    for q in range(q0, q0 + k):
        bit = (j >> (q - q0)) & 1
        nsign = torch.where(zm_bits[:, q:q + 1] * bit == 1, -1.0, 1.0)
        fq = torch.where(bit == 0, exp_h[q], exp_h[q].conj())
        fq = torch.where(bits_c[:, q:q + 1] == 1, fq, one)
        out = out * (nsign * fq)
    for b in range(q0, min(q0 + k - 1, L - 1)):
        sig = bits_a if b % 2 == 0 else bits_b
        flip = sig[:, b:b + 1] ^ sig[:, b + 1:b + 2]
        zz_pos = ((j >> (b - q0)) & 1) == ((j >> (b + 1 - q0)) & 1)
        gb = torch.where(zz_pos, exp_p[b], exp_p[b].conj())
        out = out * torch.where(flip == 1, gb, one)
    return out


def device_sigma_forward_batch(hs, phis, p_1q, p_2q, angles, uniforms, *, L,
                               T, q, initial_state="vacuum",
                               dtype_name="complex64", ancilla_factor=1.0,
                               events_per_kick=2) -> torch.Tensor:
    """Gather-free device-noise forward A(t) of a constant x drive:
    uniforms (u1 (n, T, E, L), ue, uo) -> (n, T). The sigma frame with the
    pending noise signs and per-class diagonal corrections folded into the
    kick's kron-group columns (``core/sigma_evolve.py``)."""
    _require_constant_x(angles, "device_sigma_forward_batch")
    dtype = DTYPES[dtype_name]
    dev = hs.device
    n = uniforms[0].shape[0]
    s0 = _s0(L, initial_state, q)
    zq = z_sign_mask(q, L, dtype=torch.zeros((), dtype=dtype).real.dtype,
                     device=dev)
    d0 = zz_z_phase_mask(hs, phis, L, dtype=dtype)
    exp_h = torch.exp(1j * hs.to(torch.float32)).to(dtype)
    exp_p = torch.exp(1j * phis.to(torch.float32)).to(dtype)
    exp_pb = exp_p.expand(n, L - 1)
    starts = _group_starts(L)
    u = slot_unitary(angles[0, 0, 0], angles[0, 0, 1], dtype)
    zm_all, sig_a, sig_b, sig_c = _device_presample(
        uniforms, p_1q, p_2q, events_per_kick, L)
    sig_start = torch.cat([torch.zeros_like(sig_c[:, :1]), sig_c[:, :-1]], 1)
    st = _basis(n, L, initial_state, dtype, dev)
    zero = torch.zeros(n, dtype=torch.int64, device=dev)
    pzm = pa = pb = pc = zero
    total = 1 << L
    out = []
    for t in range(T):
        sq = (1 - 2 * ((sig_start[:, t] >> q) & 1)).to(torch.float32)
        out.append(ancilla_factor * (s0 * sq * (
            (st.real.square() + st.imag.square()) @ zq)))
        if t == T - 1:
            break
        for q0, kk in starts[:-1]:  # bonds straddling the groups
            bb = q0 + kk - 1
            if bb < L - 1:
                st = _straddle_factor(st, bb, pa if bb % 2 == 0 else pb,
                                      exp_pb, L, dtype)
        for q0, kk in starts:
            uk = kron_power(u, kk) if kk > 1 else u
            cols = _device_column_factors(q0, kk, pzm, pa, pb, pc, exp_h,
                                          exp_p, L, dtype)
            s2 = st.reshape(n, total >> (q0 + kk), 1 << kk, 1 << q0)
            st = torch.einsum("bxy,bhyl->bhxl", uk * cols[:, None, :],
                              s2).reshape(n, total)
        st = st * d0
        pzm, pa, pb, pc = zm_all[:, t], sig_a[:, t], sig_b[:, t], sig_c[:, t]
    return torch.stack(out, 1)


def _phase_masks(h, ph, L, dtype):
    """exp(-i/2 E(s)) of per-trajectory angles h (n, L), ph (n, L-1): (n,
    2^L), E accumulated in ``zz_z_diag_energy``'s order."""
    real = (torch.float64 if dtype == torch.complex128
            or h.dtype == torch.float64 else torch.float32)
    s = torch.arange(1 << L, dtype=torch.int64, device=h.device)
    e = torch.zeros((h.shape[0], 1 << L), dtype=real, device=h.device)
    z_prev = None
    for q in range(L):
        z = (1 - 2 * ((s >> q) & 1)).to(real)
        e = e + h[:, q:q + 1] * z
        if q > 0:
            e = e + ph[:, q - 1:q] * z_prev * z
        z_prev = z
    return torch.exp(-0.5j * e.to(dtype))


def device_sigma_echo_batch(hs, phis, p_1q, p_2q, angles, uniforms, ts, *,
                            L, T, q, initial_state="vacuum",
                            dtype_name="complex64", ancilla_factor=1.0,
                            events_per_kick=2) -> torch.Tensor:
    """Gather-free device-noise echo A0(t) of a constant x drive: uniforms
    of 2T steps -> (n, n_ts). Every step applies [pre mask] -> kick ->
    [post mask], eager frame-corrected diagonals built from the step's
    small parameters (a diagonal applied physically at frame sigma becomes
    h_q (1 - 2 sigma_q), phi_b (1 - 2 flip_b)); a Z mask is a popcount
    parity sign. An independent data path from the kernel rows that shares
    only the presampled events."""
    _require_constant_x(angles, "device_sigma_echo_batch")
    dtype = DTYPES[dtype_name]
    dev = hs.device
    s0 = _s0(L, initial_state, q)
    theta, ty = angles[0, 0, 0], angles[0, 0, 1]
    u_f = slot_unitary(theta, ty, dtype)
    u_i = slot_unitary_inverse(theta, ty, dtype)
    idx = torch.arange(1 << L, dtype=torch.int64, device=dev)
    even = torch.arange(L - 1, device=dev) % 2 == 0
    ts = torch.as_tensor(ts, dtype=torch.int64, device=dev)
    (xmk, zm1, xme, zme, xmo, zmo, sig0, csum, fwd, inv) = (
        _device_presample_echo(uniforms, p_1q, p_2q, events_per_kick, ts, L))
    n = xmk.shape[0]

    def frame_params(h_sig, even_sig, odd_sig):
        sh = (1 - 2 * _bits(h_sig, L)).to(torch.float32)
        be, bo = _bits(even_sig, L), _bits(odd_sig, L)
        flip = torch.where(even, be[:, :-1] ^ be[:, 1:],
                           bo[:, :-1] ^ bo[:, 1:]).to(torch.float32)
        return hs * sh, phis * (1.0 - 2.0 * flip)

    def zpar(zm):
        return 1.0 - 2.0 * _parity(idx & zm[:, None]).to(torch.float32)

    out = []
    for ti, t in enumerate(ts.tolist()):
        st = _basis(n, L, initial_state, dtype, dev)
        for k in range(2 * t):
            ws = [m[:, ti, k] for m in (xmk, zm1, xme, zme, xmo, zmo, sig0,
                                        csum)]
            xmk_k, zm1_k, xme_k, zme_k, xmo_k, zmo_k, s0_k, sc_k = ws
            if k < t:  # post mask: the split diagonal at (sa, sb, sc)
                sa = s0_k ^ xmk_k
                h_post, p_post = frame_params(sc_k, sa, sa ^ xme_k)
                m_post = (_phase_masks(h_post, p_post, L, dtype)
                          * zpar(zm1_k ^ zme_k ^ zmo_k))
                st = apply_uniform_1q_layer(st, u_f, L) * m_post
            else:  # pre mask: the daggered split diagonal, 2q Z parities
                h_pre, p_pre = frame_params(s0_k, s0_k ^ xmo_k, s0_k)
                m_pre = (_phase_masks(-h_pre, -p_pre, L, dtype)
                         * zpar(zme_k ^ zmo_k))
                st = apply_uniform_1q_layer(st * m_pre, u_i, L) * zpar(zm1_k)
        val = (st.real.square() + st.imag.square()) @ z_sign_mask(
            q, L, dtype=st.real.dtype, device=dev)
        sq = (1 - 2 * ((csum[:, ti, -1] >> q) & 1)).to(val.dtype)
        out.append(ancilla_factor * s0 * sq * val)
    return torch.stack(out, 1)


# ---------------------------------------------------------------------------
# x kernel rows (K3, K1/K2, the streamed family)


def _x_route(angles, L, T, q, echo):
    """The x-family route (``ops/routes.py::ROUTES``) of the shape."""
    route = engine_for(angles, L=L, T=T, q=q, dtype_name="complex64",
                       has_y=False, echo=echo)
    if not x_route(route):
        raise ValueError(f"no x kernel takes device rows at L={L}, T={T}, "
                         f"q={q} (route {route!r})")
    return ROUTES[route]


def device_forward_rows(uniforms, hs, phis, p_1q, p_2q, *, L, epk):
    """Compact forward rows (n, T, forward_width(L)) and the cycle-end
    sigma (n, T) of the device events."""
    zm, sa, sb, sc = _device_presample(uniforms, p_1q, p_2q, epk, L)
    rows = pack_device_cycle_params_compact(zm, sa, sb, sc, hs, phis, L,
                                            forward_width(L))
    return rows, sc


def device_kernel_forward_batch(hs, phis, p_1q, p_2q, angles, uniforms, *, L,
                                T, q, initial_state="vacuum",
                                ancilla_factor=1.0, events_per_kick=2
                                ) -> torch.Tensor:
    """Device-noise forward A(t) of a constant x drive through the x kernel
    that ``engine_for`` picks (K3 at 14 <= L <= 16, K1 at 17..23, the
    streamed family at 24..30; their plain versions on CPU tensors), fed the
    device rows: uniforms (u1 (n, T, E, L), ue, uo) -> (n, T)."""
    _require_constant_x(angles, "device_kernel_forward_batch")
    route = _x_route(angles, L, T, q, echo=False)
    rows, sig = device_forward_rows(uniforms, hs, phis, p_1q, p_2q, L=L,
                                    epk=events_per_kick)
    return route.x_entry(False, rows.contiguous(), sig, angles.to(hs.device),
                         float(angles[0, 0, 0]), L=L, q=q,
                         initial_state=initial_state,
                         ancilla_factor=ancilla_factor)


def device_echo_pair_tiles(uniforms, ts, hs, phis, p_1q, p_2q, *, L, T, epk,
                           width=None):
    """Interleaved (pre, post) step rows (n, n_ts, 4T, width) of every
    (trajectory, t) device echo pair and the final sigma (n, n_ts): the
    device counterpart of ``ops/params.py::echo_pair_tiles``; the echo
    kernels run unchanged.

    Forward step (kick; E 1q events; D_even; even event; D_odd; odd event;
    D_field): no pre row; post row = the device row at the per-class frames
    (even bonds at sa, odd at sb, field at sc) with all the step's Z masks.
    Inverse step (D_field*; D_odd*; odd event; D_even*; even event; K*; 1q
    events): pre row = the daggered split diagonal (even bonds at s1 = sig0
    ^ xm_odd, odd and field at sig0; -h, -phi) with the 2q events' Z masks;
    post row = the 1q events' Z mask only."""
    width = echo_width(L) if width is None else width
    if 5 * L - 2 > width - 4:
        raise ValueError(
            f"L={L} data lanes collide with the flag lanes at width={width}")
    dev = hs.device
    ts = torch.as_tensor(ts, dtype=torch.int64, device=dev)
    (xmk, zm1, xme, zme, xmo, zmo, sig0, csum, fwd, inv) = (
        _device_presample_echo(uniforms, p_1q, p_2q, epk, ts, L))
    T2 = 2 * T
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    sa = sig0 ^ xmk
    post_f = pack_device_cycle_params_compact(
        zm1 ^ zme ^ zmo, sa, sa ^ xme, csum, hs, phis, L, width)
    pre_i = pack_device_cycle_params_compact(
        zme ^ zmo, sig0 ^ xmo, sig0, sig0, -hs, -phis, L, width)
    post_i = pack_device_cycle_params_compact(
        zm1, zero, zero, zero, torch.zeros_like(hs), torch.zeros_like(phis),
        L, width)
    fwd_f = fwd.to(torch.float32)[..., None]
    inv_f = inv.to(torch.float32)[..., None]
    pre = pre_i * inv_f
    post = post_f * fwd_f + post_i * inv_f
    step = torch.arange(T2, device=dev)
    t_ = ts[:, None]
    aidx = torch.where(fwd, step, torch.clamp(2 * t_ - 1 - step, 0, T - 1))
    pre[..., width - 3] = torch.where(inv, -1.0, 1.0)
    pre[..., width - 2] = (fwd | inv).to(torch.float32)
    pre[..., width - 1] = aidx.to(torch.float32)
    tiles = torch.stack([pre, post], -2).reshape(*pre.shape[:-2], 2 * T2,
                                                 width)
    tiles[..., 0, width - 4] = (2 * ts).to(torch.float32)
    return tiles.contiguous(), csum[..., -1]


def device_kernel_echo_batch(hs, phis, p_1q, p_2q, angles, uniforms, ts, *,
                             L, T, q, initial_state="vacuum",
                             ancilla_factor=1.0, events_per_kick=2
                             ) -> torch.Tensor:
    """Device-noise echo A0(t) of a constant x drive through the x echo
    kernel that ``engine_for`` picks, fed ``device_echo_pair_tiles``:
    uniforms of 2T steps -> (n, n_ts)."""
    _require_constant_x(angles, "device_kernel_echo_batch")
    route = _x_route(angles, L, T, q, echo=True)
    tiles, sig = device_echo_pair_tiles(uniforms, ts, hs, phis, p_1q, p_2q,
                                        L=L, T=T, epk=events_per_kick)
    return route.x_entry(True, tiles, sig, angles.to(hs.device),
                         float(angles[0, 0, 0]), L=L, q=q,
                         initial_state=initial_state,
                         ancilla_factor=ancilla_factor)


# ---------------------------------------------------------------------------
# lab-frame rows (any drive): the bond events commute into the final slot's
# Pauli hook. Operator product, rightmost first:
#   field . E_o . odd . E_e . even . E_1q . U
#     = field . odd^{E_o} . even^{E_e + E_o} . (E_o E_e E_1q) . U,
# conjugating a ZZ phase by X_m flips its angle iff m's parity across the
# bond is odd: a +-1 sign on the final slot's even and odd phi entries.


def _bond_parity_row(mask, L):
    """(...,) int64 mask -> (..., L-1) f32 +-1 bond-parity signs."""
    j = torch.arange(L - 1, device=mask.device)
    b = (mask[..., None] >> j) & 1
    b1 = (mask[..., None] >> (j + 1)) & 1
    return (1 - 2 * (b ^ b1)).to(torch.float32)


def _site_sign_row(mask, L):
    """(...,) int64 mask -> (..., L) f32 +-1 per-site signs."""
    j = torch.arange(L, device=mask.device)
    return (1 - 2 * ((mask[..., None] >> j) & 1)).to(torch.float32)


def _device_general_rows(uniforms, phis, p_1q, p_2q, epk, T, K, L):
    """Per-trajectory composed masks zm, xm (n, T*K) and phi rows (n, T*K,
    L-1) of the lab-frame kernels' device hook; uniforms (u1 (n, T, K*E,
    L), ue, uo), the 1q events slot-major."""
    xm1, zm1, xme, zme, xmo, zmo = _device_presample_split(
        uniforms, p_1q, p_2q, L)
    n = xm1.shape[0]
    xk, zk = _compose_1q(xm1.reshape(n, T, K, epk), zm1.reshape(n, T, K, epk),
                         epk)
    xk[..., K - 1] ^= xme ^ xmo
    zk[..., K - 1] ^= zme ^ zmo
    even = torch.arange(L - 1, device=xk.device) % 2 == 0
    sign = torch.where(even, _bond_parity_row(xme ^ xmo, L),
                       _bond_parity_row(xmo, L))               # (n, T, L-1)
    phi_rows = torch.zeros((n, T, K, L - 1), dtype=torch.float32,
                           device=xk.device)
    phi_rows[:, :, K - 1] = phis.to(torch.float32) * sign
    S = T * K
    return zk.reshape(n, S), xk.reshape(n, S), phi_rows.reshape(n, S, L - 1)


def device_general_kernel_forward_batch(hs, phis, p_1q, p_2q, angles,
                                        uniforms, *, L, T, K, q,
                                        initial_state="vacuum",
                                        ancilla_factor=1.0,
                                        events_per_kick=2) -> torch.Tensor:
    """Device-noise forward A(t) of any kick schedule through the lab-frame
    kernel K4 (its plain version on CPU tensors), 14 <= L <= 23: uniforms
    (u1 (n, T, K*E, L), ue, uo) -> (n, T)."""
    if not resident_general.MIN_L <= L <= resident_general.MAX_L:
        raise ValueError(f"device general kernel path supports "
                         f"{resident_general.MIN_L} <= L <= "
                         f"{resident_general.MAX_L}")
    zm, xm, phi_rows = _device_general_rows(uniforms, phis, p_1q, p_2q,
                                            events_per_kick, T, K, L)
    rows = general_forward_rows(None, hs, phis, angles.to(hs.device), L=L,
                                T=T, K=K, p=0.0, masks=(zm, xm),
                                phi_rows=phi_rows)
    return resident_general.general_forward_batch(
        rows, L=L, T=T, q=q, initial_state=initial_state,
        ancilla_factor=ancilla_factor)


def _device_general_echo_rows(uniforms, ts, hs, phis, p_1q, p_2q, epk, T, K,
                              L):
    """Per-(trajectory, t) hook rows of the lab-frame echo kernels: xm, zm
    (n, n_ts, 2T, K); pre_h (n, n_ts, 2T, L), pre_phi (.., L-1) (inverse
    steps); post_h, post_phi (forward steps, the turnaround conjugation
    applied).

    The forward commutation, time-reversed: an inverse cycle runs field^ .
    odd^ . E_o . even^ . E_e . kicks, so its bond events commute earlier,
    through the full pre diagonal (conjugating it) and through the previous
    step's post diagonal (the turnaround's D0 when that step is the last
    forward cycle), into the previous step's final-slot hook. E_e crosses
    even, odd and field (flip by xme), E_o odd and field (flip by xmo); the
    previous post D0 is crossed by both (xme ^ xmo, h sites included)."""
    xm1, zm1, xme, zme, xmo, zmo = _device_presample_split(
        uniforms, p_1q, p_2q, L)
    n, T2 = xm1.shape[0], 2 * T
    dev = xm1.device
    xk, zk = _compose_1q(xm1.reshape(n, T2, K, epk),
                         zm1.reshape(n, T2, K, epk), epk)
    ts = torch.as_tensor(ts, dtype=torch.int64, device=dev)
    step = torch.arange(T2, device=dev)
    t_ = ts[:, None]
    fwd = step < t_                                            # (n_ts, 2T)
    inv = (step >= t_) & (step < 2 * t_)
    act = fwd | inv
    xk = torch.where(act[..., None], xk[:, None], 0)           # (n, n_ts, 2T, K)
    zk = torch.where(act[..., None], zk[:, None], 0)
    xme, zme, xmo, zmo = (torch.where(act, m[:, None], 0)
                          for m in (xme, zme, xmo, zmo))
    m_eo, z_eo = xme ^ xmo, zme ^ zmo
    hf = hs.to(torch.float32)
    pf = phis.to(torch.float32)
    even = torch.arange(L - 1, device=dev) % 2 == 0
    fwd_f = fwd.to(torch.float32)[..., None]
    inv_f = inv.to(torch.float32)[..., None]
    # forward steps: own bond events into the final slot, post-D0 signs
    xk[..., K - 1] ^= torch.where(fwd, m_eo, 0)
    zk[..., K - 1] ^= torch.where(fwd, z_eo, 0)
    sign_fwd = torch.where(even, _bond_parity_row(m_eo, L),
                           _bond_parity_row(xmo, L))
    post_h = fwd_f * hf + torch.zeros((T2, L), device=dev)
    post_phi = fwd_f * pf * sign_fwd
    # inverse steps: bond events fold into the previous step's final slot,
    # conjugating its post diagonal (non-zero at the turnaround only)
    pad_m = torch.cat([torch.where(inv, m_eo, 0)[..., 1:],
                       torch.zeros_like(m_eo[..., :1])], -1)
    pad_z = torch.cat([torch.where(inv, z_eo, 0)[..., 1:],
                       torch.zeros_like(z_eo[..., :1])], -1)
    xk[..., K - 1] ^= pad_m
    zk[..., K - 1] ^= pad_z
    post_h = post_h * _site_sign_row(pad_m, L)
    post_phi = post_phi * _bond_parity_row(pad_m, L)
    # inverse pre diagonal: D0^dagger with the crossing conjugations
    pre_h = -inv_f * hf * _site_sign_row(m_eo, L)
    sign_pre = torch.where(even, _bond_parity_row(xme, L),
                           _bond_parity_row(m_eo, L))
    pre_phi = -inv_f * pf * sign_pre
    return xk, zk, pre_h, pre_phi, post_h, post_phi


def device_general_kernel_echo_batch(hs, phis, p_1q, p_2q, angles, uniforms,
                                     ts, *, L, T, K, q,
                                     initial_state="vacuum",
                                     ancilla_factor=1.0, events_per_kick=2
                                     ) -> torch.Tensor:
    """Device-noise echo A0(t) of any kick schedule through K4's echo (its
    plain version on CPU tensors), 14 <= L <= 23: uniforms of 2T steps ->
    (n, n_ts)."""
    if not resident_general.MIN_L <= L <= resident_general.MAX_L:
        raise ValueError(f"device general kernel path supports "
                         f"{resident_general.MIN_L} <= L <= "
                         f"{resident_general.MAX_L}")
    xk, zk, *diag = _device_general_echo_rows(
        uniforms, ts, hs, phis, p_1q, p_2q, events_per_kick, T, K, L)
    tiles = general_echo_rows(None, ts, hs, phis, angles.to(hs.device), L=L,
                              T=T, K=K, p=0.0, masks=(xk, zk),
                              diag_rows=diag)
    return resident_general.general_echo_batch(
        tiles, L=L, q=q, initial_state=initial_state,
        ancilla_factor=ancilla_factor)


def device_general_forward_oracle(hs, phis, p_1q, p_2q, angles, uniforms, *,
                                  L, T, K, q, initial_state="vacuum",
                                  dtype_name="complex64", ancilla_factor=1.0,
                                  events_per_kick=2) -> torch.Tensor:
    """Dense lab-frame oracle on the same presampled events as
    ``_device_general_rows``, applied in the original circuit order (no
    commutation): uniforms (u1 (n, T, K*E, L), ue, uo) -> (n, T)."""
    dtype = DTYPES[dtype_name]
    m_even, m_odd, m_field = _masks_split(hs, phis, L, dtype)
    s0 = _s0(L, initial_state, q)
    xm1, zm1, xme, zme, xmo, zmo = _device_presample_split(
        uniforms, p_1q, p_2q, L)
    n = xm1.shape[0]
    xk, zk = _compose_1q(xm1.reshape(n, T, K, events_per_kick),
                         zm1.reshape(n, T, K, events_per_kick),
                         events_per_kick)
    st = _basis(n, L, initial_state, dtype, hs.device)
    out = []
    for t in range(T):
        out.append(ancilla_factor * s0 * _measure(st, q, L))
        if t == T - 1:
            break
        for k in range(K):
            st = apply_uniform_1q_layer(
                st, slot_unitary(angles[t, k, 0], angles[t, k, 1], dtype), L)
            st = _apply_masks(st, xk[:, t, k], zk[:, t, k])
        st = _apply_masks(st * m_even, xme[:, t], zme[:, t])
        st = _apply_masks(st * m_odd, xmo[:, t], zmo[:, t]) * m_field
    return torch.stack(out, 1)


def device_general_echo_oracle(hs, phis, p_1q, p_2q, angles, uniforms,
                               t_value, *, L, T, K, q,
                               initial_state="vacuum",
                               dtype_name="complex64", ancilla_factor=1.0,
                               events_per_kick=2) -> torch.Tensor:
    """Dense lab-frame echo oracle: the same presample as
    ``_device_general_echo_rows``, the events in ``device_inverse_cycle``'s
    original order. One t; uniforms of 2T steps -> (n,)."""
    dtype = DTYPES[dtype_name]
    m_even, m_odd, m_field = _masks_split(hs, phis, L, dtype)
    s0 = _s0(L, initial_state, q)
    epk = events_per_kick
    xm1, zm1, xme, zme, xmo, zmo = _device_presample_split(
        uniforms, p_1q, p_2q, L)
    n = xm1.shape[0]
    xk, zk = _compose_1q(xm1.reshape(n, 2 * T, K, epk),
                         zm1.reshape(n, 2 * T, K, epk), epk)
    t = int(t_value)
    st = _basis(n, L, initial_state, dtype, hs.device)
    for s in range(t):
        for k in range(K):
            st = apply_uniform_1q_layer(
                st, slot_unitary(angles[s, k, 0], angles[s, k, 1], dtype), L)
            st = _apply_masks(st, xk[:, s, k], zk[:, s, k])
        st = _apply_masks(st * m_even, xme[:, s], zme[:, s])
        st = _apply_masks(st * m_odd, xmo[:, s], zmo[:, s]) * m_field
    for s in range(t, 2 * t):
        ci = 2 * t - 1 - s
        st = st * m_field.conj() * m_odd.conj()
        st = _apply_masks(st, xmo[:, s], zmo[:, s]) * m_even.conj()
        st = _apply_masks(st, xme[:, s], zme[:, s])
        for j in range(K):
            st = apply_uniform_1q_layer(st, slot_unitary_inverse(
                angles[ci, K - 1 - j, 0], angles[ci, K - 1 - j, 1], dtype), L)
            st = _apply_masks(st, xk[:, s, j], zk[:, s, j])
    return ancilla_factor * s0 * _measure(st, q, L)
