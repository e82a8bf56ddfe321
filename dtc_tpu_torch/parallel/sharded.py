"""Amplitude-sharded Floquet simulation over the single-controller mesh.

Port of ``dtc_tpu/parallel/sharded.py``: the global-bit algebra
(``_global_1q``, ``_sharded_pauli_string``, ``_sharded_kick_factored``,
``_sharded_forward_cycle``, ``_tail_phase_angles``, ``_global_shard_kicks``,
``_global_diag``, ``_global_diag_inv``, ``_check_constant_x``,
``_global_general_slot_kick``), the sigma-frame engines
``make_sharded_autocorr_forward`` and ``make_sharded_echo``, the eager
observables engine ``make_sharded_observables`` (energy and every <Z_q>,
uniforms (n, T*K, L) as ``core/evolve.py::evolve_observables`` takes
them), and the cycle-kernel engines at 17 <= L_loc <= 30:
``make_sharded_autocorr_forward_kernel`` (K8a; K9a from
``cycle_hi.MIN_ROUTE_L`` = 24 on), ``make_sharded_echo_kernel`` (K8a/K8b;
K9a/K9b), ``make_sharded_autocorr_forward_general`` (K8c; K10a
shard-local) and ``make_sharded_echo_general`` (K8c/K8d; K10a/K10b
shard-local).

Layout, as in the reference: the 2^L statevector is split along its top
k = log2(n_amp) index bits; shard a holds global indices [a M, (a+1) M),
M = 2^L_loc, L_loc = L - k, as a flat (n, M) complex64 tensor of n
trajectories (the reference's split (re, im) planes and its ``_on_fused``
are TPU DMA mechanics and are not ported). A 1q gate on a global qubit is
one XOR-partner exchange (``Mesh.xor_partners``) and a two-term combine,
computed out of place: every new shard is built from the old shards before
any is stored. The diagonal and every Z-type sign are shard-local; sums
over 'amp' and 'traj' go through ``Mesh.psum`` in shard order.

Noise is injectable (ROADMAP.md rule 2): every engine function takes a
block of f32 uniforms with one row per trajectory, in the shape the
reference draws per trajectory key: sigma forward (T*K, L), sigma echo
(2T, K, L); x kernel forward (T, L), x kernel echo (2T, 1, L); general
forward (T*K, L), general echo (2T, K, L). The trajectories split over
'traj' in order (the reference's P("traj")). With p == 0 the block may be
None and ``n_traj`` gives the count. An engine function returns the
trajectory average, forward (T,) and echo a scalar, as a tensor of the
state's real type on the device of shard (0, 0).

The cycle-kernel engines launch one kernel per shard and cycle: the shards
of a trajectory group are separate tensors that may sit on different
cards, and the local rows are the same on every shard, so a launch holds
the group's trajectories of one shard, in runs of at most
``_launch_traj(mesh, L_loc)`` trajectories so that the shard states of a
run that share one device stay within ``routes.KERNEL_STATE_BYTES`` through
the out-of-place exchange (one trajectory at L_loc = 29 and 30 with a card
a shard). The observables engine runs its trajectories in runs of
``_launch_traj(mesh, L_loc, OBS_AMP_BYTES)`` under the same budget. The
per-shard kernels are K8 (``ops/cycle.py``,
L_loc < ``cycle_hi.MIN_ROUTE_L``) and the streamed family (``ops/cycle_hi.py``,
from it up to 30), as the reference switches at its
``DTC_TPU_SHARDED_HI_MIN_LB``; x rows are ``forward_width(L_loc)`` lanes
wide and lab-frame rows ``general_hi_width(L_loc)``. The shard-bit kicks
are torch tensor ops between the launches. A shard's global diagonal (the
shard-bit terms and the boundary bond phi[L_loc-1]) rides in the launch's
folded rows (every per-shard kernel: K8a-d, K9a/K9b and K10's shard-local
forms), its angles built once a run for every step and shard; no engine
applies it as a torch pass.

Device noise: the lab-frame cycle-kernel engines take ``device=(p_1q,
p_2q, events_per_kick)`` with p == 0, as the reference's do. The
depolarizing draw is replaced by the lab-frame device rows of
``core/device_evolve.py`` (composed per-slot Pauli words, the commutation
signs baked into per-step h and phi rows). The words' shard-bit parts take
the depolarizing bookkeeping (X into the XOR frame, Z through the slot kicks
and the global diagonal), and the per-step rows reach the global and
boundary bonds through the global diagonal. Uniforms are then the device
block ``(u1, ue, uo)`` of ``core/device_evolve.py`` (forward T steps, echo
2T), trajectories first. It is the route of the device sweeps for every
non-x drive at 24 <= L <= 30 on a one-shard mesh
(``experiments/device_sweeps.py``).
"""

from __future__ import annotations

import math

import torch

from dtc_tpu_torch.core.device_evolve import (
    _device_general_echo_rows,
    _device_general_rows,
)
from dtc_tpu_torch.core.sigma_evolve import (
    _bits,
    _codes_from_uniform,
    _group_column_factors,
    _group_starts,
    _masks_from_codes,
    _per_b,
    _sigma_signs,
    _straddle_factor,
    presample_noise,
    xor_scan,
)
from dtc_tpu_torch.core.statevector import basis_index
from dtc_tpu_torch.models.drives import slot_unitary, slot_unitary_inverse
from dtc_tpu_torch.ops import cycle, cycle_hi
from dtc_tpu_torch.ops.diag import zz_z_diag_energy, zz_z_phase_mask
from dtc_tpu_torch.ops.gates import expect_x
from dtc_tpu_torch.ops.kick import apply_uniform_1q_layer, kron, kron_power
from dtc_tpu_torch.ops.params import forward_width, pack_cycle_params_compact
from dtc_tpu_torch.ops.params_general import (
    general_echo_rows,
    general_forward_rows,
    general_hi_width,
)
from dtc_tpu_torch.ops.paulis import _i_power, _parity, pauli_string_masks
from dtc_tpu_torch.ops.routes import KERNEL_STATE_BYTES
from dtc_tpu_torch.parallel.mesh import amp_bits

_HALF_PI = math.pi / 2

# ---------------------------------------------------------------------------
# the global-bit algebra (shards: one (n, M) tensor per 'amp' index)


def _global_1q(mesh, shards, u, gbit):
    """(n, 2, 2) unitaries on global qubit (shard-id bit ``gbit``): pair
    exchange + local two-term combine."""
    partners = mesh.xor_partners(shards, gbit)
    out = []
    for a, (st, pt) in enumerate(zip(shards, partners)):
        ud = u.to(st.device)
        row = (a >> gbit) & 1
        diag_c, off_c = ud[:, row, row], ud[:, row, 1 - row]
        out.append(diag_c[:, None] * st + off_c[:, None] * pt)
    return out


def _sharded_pauli_string(mesh, shards, xmask, zmask, n_y, *, local_bits):
    """Apply a Pauli string per trajectory (int64 masks (n,)) whose x-mask
    may touch global (shard-id) bits."""
    M = 1 << local_bits
    xhigh = xmask >> local_bits
    for gb in range(amp_bits(mesh)):
        partners = mesh.xor_partners(shards, gb)
        take = ((xhigh >> gb) & 1).bool()[:, None]
        shards = [torch.where(take.to(s.device), p, s)
                  for s, p in zip(shards, partners)]
    out = []
    for a, st in enumerate(shards):
        dev = st.device
        xm, zm = xmask.to(dev)[:, None], zmask.to(dev)[:, None]
        local = torch.arange(M, dtype=torch.int64, device=dev)
        st = torch.gather(st, 1, (local ^ (xm & (M - 1))).expand(st.shape))
        sign = 1 - 2 * _parity(((a * M + local) ^ xm) & zm)
        phase = _i_power(n_y.to(dev), st.dtype)[:, None]
        out.append(st * (phase * sign.to(st.real.dtype)))
    return out


def _sharded_kick_factored(mesh, shards, theta_x, theta_y, sigma, pend_zm,
                           diag_sig, exp_h, exp_p, *, L, local_bits, dtype,
                           has_y, inverse=False):
    """Sigma-conjugated kick on every shard with the pending noise Z-signs
    and diagonal sigma corrections folded in (core/sigma_evolve's
    ``_kick_factored`` on the local bits). Shard bits get their per-qubit
    factors on the exchange's 2x2 columns, the boundary bond (local top
    bit, shard bit 0) a (2,) broadcast on the local top bit, and bonds
    between shard bits a per-shard scalar. Per trajectory: theta_x,
    theta_y (n,) or scalars, masks (n,) int64, exp_h (n, L), exp_p
    (n, L-1); ``inverse`` daggers the slot unitary."""
    k_bits = L - local_bits
    M = 1 << local_bits
    B = shards[0].shape[0]
    theta_x, theta_y = _per_b(theta_x, B), _per_b(theta_y, B)
    sig_bits = _bits(diag_sig, L)
    zm_bits = _bits(pend_zm, L)
    make = slot_unitary_inverse if inverse else slot_unitary
    starts = _group_starts(local_bits)
    one = torch.ones((), dtype=dtype, device=exp_h.device)
    if has_y:
        s_all = _sigma_signs(sigma, L, theta_y.dtype)              # (B, L)
        us = make(theta_x[:, None], s_all * theta_y[:, None], dtype)
    else:
        u = make(theta_x, theta_y, dtype)                          # (B,2,2)
    kicks = []
    for q0, k in starts:
        if has_y:
            uk = us[:, q0 + k - 1]
            for jq in range(k - 2, -1, -1):
                uk = kron(uk, us[:, q0 + jq])
        else:
            uk = kron_power(u, k) if k > 1 else u
        cols = _group_column_factors(q0, k, pend_zm, diag_sig, exp_h, exp_p,
                                     L, dtype)
        kicks.append((q0, k, uk * cols[:, None, :]))
    if k_bits > 0:
        b = local_bits - 1
        flip = (sig_bits[:, b] ^ sig_bits[:, b + 1]) == 1
        g_bnd = torch.where(flip, exp_p[:, b], one)
    out = []
    for a, st in enumerate(shards):
        dev = st.device
        # pre-kick diagonal factors on bonds outside the local kron groups
        for q0, k in starts[:-1]:
            b = q0 + k - 1
            if b < local_bits - 1:
                st = _straddle_factor(st, b, diag_sig.to(dev),
                                      exp_p.to(dev), L, dtype)
        if k_bits > 0:
            g = g_bnd.to(dev)
            vec2 = (torch.stack([g, g.conj()], -1) if (a & 1) == 0
                    else torch.stack([g.conj(), g], -1))           # (B, 2)
            st = (st.reshape(B, 2, M >> 1) * vec2[:, :, None]).reshape(B, M)
        for b in range(local_bits, L - 1):
            gb, gb1 = b - local_bits, b + 1 - local_bits
            flip = (sig_bits[:, b] ^ sig_bits[:, b + 1]) == 1
            equal = ((a >> gb) & 1) == ((a >> gb1) & 1)
            e = exp_p[:, b] if equal else exp_p[:, b].conj()
            st = st * torch.where(flip, e, one).to(dev)[:, None]
        for q0, k, uk in kicks:
            s2 = st.reshape(B, M >> (q0 + k), 1 << k, 1 << q0)
            st = torch.einsum("bxy,bhyl->bhxl", uk.to(dev), s2).reshape(B, M)
        out.append(st)
    # global (shard-bit) kicks: per-qubit factors ride the 2x2 columns
    for gb in range(k_bits):
        qq = local_bits + gb
        u1 = (make(theta_x, s_all[:, qq] * theta_y, dtype) if has_y
              else make(theta_x, theta_y, dtype))
        f0 = torch.where(sig_bits[:, qq] == 1, exp_h[:, qq], one)
        f1 = torch.where(sig_bits[:, qq] == 1, exp_h[:, qq].conj(), one)
        f1 = f1 * torch.where(zm_bits[:, qq] == 1, -one, one)
        out = _global_1q(mesh, out, u1 * torch.stack([f0, f1], -1)[:, None],
                         gb)
    return out


def _sharded_forward_cycle(mesh, shards, pending, ang, ev, d0s, exp_h, exp_p,
                           *, L, local_bits, K, p, dtype, has_y):
    """Sharded counterpart of core/sigma_evolve's ``forward_cycle_fac``
    followed by the diagonal D0 (``d0s``: one (M,) mask per shard)."""
    kw = dict(L=L, local_bits=local_bits, dtype=dtype)
    pend_zm, pend_sig = pending
    if p <= 0.0:
        zero = torch.zeros_like(pend_zm)
        for k in range(K):
            shards = _sharded_kick_factored(
                mesh, shards, ang[k, 0], ang[k, 1], zero, zero, zero, exp_h,
                exp_p, has_y=False, **kw)
        return [s * d for s, d in zip(shards, d0s)], pending
    zm, sig_b, sig_after = ev
    for k in range(K):
        shards = _sharded_kick_factored(
            mesh, shards, ang[k, 0], ang[k, 1], sig_b[:, k], pend_zm, pend_sig,
            exp_h, exp_p, has_y=has_y, **kw)
        pend_zm, pend_sig = zm[:, k], torch.zeros_like(pend_zm)
    return [s * d for s, d in zip(shards, d0s)], (pend_zm, sig_after)


def _tail_phase_angles(zm_t, sig_t, hs, phis, aidx, *, L, local_bits):
    """Per-trajectory angles (theta_scalar, theta_boundary) of shard
    ``aidx``: the global part of a cycle-kernel cycle's post-fold diagonal
    is exp(i theta_scalar) * exp(i theta_boundary z_top), z_top the local
    top bit's sign. theta_scalar holds the shard-bit h terms with their
    sigma corrections, the noise-Z signs on shard bits and the shard-shard
    bonds; theta_boundary the boundary bond phi[L_loc-1] with its
    shard-bit-0 leg. The compact-row formula (cz = h (sig - 1/2) -
    (pi/2) n, cb = phi (flip - 1/2), c0 = (pi/2) sum n) restricted to bits
    >= L_loc. Masks int64 of any shape, aidx an int or an int64 tensor that
    broadcasts against them (every step and shard at once: masks (S, 1, n),
    aidx (A, 1)); hs (>= L,) or per trajectory (n, >= L), phis likewise
    (>= L-1), their first L (L-1) read. Both angles f32 of the broadcast
    shape."""
    dev = zm_t.device
    bit = torch.arange(L, device=dev)
    zb = ((sig_t[..., None] >> bit) & 1).to(torch.float32)        # (..., L)
    nb = ((zm_t[..., None] >> bit) & 1).to(torch.float32)
    hf = hs[..., :L].to(torch.float32).to(dev)
    pf = phis[..., :L - 1].to(torch.float32).to(dev)
    # an int shard index stays on the host: a copy of it to the card would
    # wait for the card's queue to drain, once a call
    shard = aidx[..., None] if torch.is_tensor(aidx) else aidx
    za = (1.0 - 2.0 * ((shard >> bit[:L - local_bits]) & 1)).to(
        torch.float32)                                  # shard-bit z signs
    g = slice(local_bits, L)
    czq = hf[..., g] * (zb[..., g] - 0.5) - _HALF_PI * nb[..., g]
    bond = pf * ((zb[..., :-1] - zb[..., 1:]).abs() - 0.5)
    th_sc = ((czq * za + _HALF_PI * nb[..., g]).sum(-1)
             + (bond[..., local_bits:] * za[..., :-1] * za[..., 1:]).sum(-1))
    th_bnd = bond[..., local_bits - 1] * za[..., 0]
    return th_sc, th_bnd


def _global_diag(st, zm_t, sig_t, hs, phis, aidx, *, L, local_bits,
                 sign=1.0):
    """Global diagonal factors of one cycle on shard ``aidx``: the
    per-trajectory scalar phase and the boundary bond's split on the local
    top bit (the upper half of the flat shard), in place on ``st``, as a
    torch pass: the oracle the tests hold the per-shard kernels' folded
    rows against (no engine calls it). ``sign=-1`` daggers it."""
    th_sc, th_bnd = _tail_phase_angles(zm_t, sig_t, hs, phis, aidx, L=L,
                                       local_bits=local_bits)
    return cycle_hi.global_phase(st, th_sc, th_bnd, sign)


def _global_diag_inv(st, zm_t, sig_t, hs, phis, aidx, *, L, local_bits):
    """Daggered ``_global_diag`` (negated angles): the general echo's
    inverse-step global diagonal, at the step's pre-event sigma with the
    previous event's Z word."""
    return _global_diag(st, zm_t, sig_t, hs, phis, aidx, L=L,
                        local_bits=local_bits, sign=-1.0)


def _global_shard_kicks(mesh, shards, theta):
    """RX(theta) on every shard-id bit: pair exchange + combine per bit,
    new = cos(theta/2) mine - i sin(theta/2) partner, one new tensor per
    shard (the old shards stay whole until every new one is built). The
    bits' kicks commute, so their order is free."""
    c = float(torch.tensor(math.cos(theta / 2), dtype=torch.float32))
    s = float(torch.tensor(math.sin(theta / 2), dtype=torch.float32))
    for gb in range(amp_bits(mesh)):
        partners = mesh.xor_partners(shards, gb)
        shards = [st.mul(c).add_(pt, alpha=complex(0.0, -s))
                  for st, pt in zip(shards, partners)]
    return shards


def _check_constant_x(angles) -> float:
    """The kick angle of a constant x-only K=1 schedule; raises for any
    other schedule (the x cycle kernels read only angles[0, 0, 0])."""
    ang = angles.detach().cpu()
    if not (ang.shape[1] == 1 and bool((ang[:, :, 1] == 0.0).all())
            and bool((ang == ang[0]).all())):
        raise ValueError("cycle-kernel sharded engine requires a constant "
                         "x-only K=1 schedule (only angles[0,0,0] is read)")
    return float(ang[0, 0, 0])


def _global_general_slot_kick(mesh, shards, tx, ty, sig_w, zmp_w, *,
                              local_bits, dagger=False):
    """Per-trajectory sigma-conjugated slot kick RY(+-ty) RX(tx) on every
    shard-id bit, the previous event's global Z-signs folded into the 2x2
    columns. The +-ty sign is the trajectory's shard-bit XOR frame at this
    slot (X RY X = RY(-ty)); ``dagger`` applies (X^s U X^s)^dag, the
    general echo's inverse steps. tx, ty Python floats (no device read in
    the loop); sig_w, zmp_w (n,)."""
    cx = float(torch.tensor(math.cos(tx / 2), dtype=torch.float32))
    sx = float(torch.tensor(math.sin(tx / 2), dtype=torch.float32))
    for gb in range(amp_bits(mesh)):
        qq = local_bits + gb
        ysign = 1.0 - 2.0 * ((sig_w >> qq) & 1).to(torch.float64)   # (n,)
        cy = torch.cos(ysign * ty / 2).to(torch.float32)
        sy = torch.sin(ysign * ty / 2).to(torch.float32)
        f1 = 1.0 - 2.0 * ((zmp_w >> qq) & 1).to(torch.float32)
        partners = mesh.xor_partners(shards, gb)
        out = []
        for a, (st, pt) in enumerate(zip(shards, partners)):
            # slot_unitary's entries: u00=(cy cx, sy sx) u01=(-sy cx, -cy sx)
            # u10=(sy cx, -cy sx) u11=(cy cx, -sy sx); columns diag(1, f1)
            mine = (a >> gb) & 1 == 0
            if dagger:
                d = ((cy * cx, -sy * sx) if mine
                     else (cy * cx * f1, sy * sx * f1))
                o = ((sy * cx * f1, cy * sx * f1) if mine
                     else (-sy * cx, cy * sx))
            else:
                d = ((cy * cx, sy * sx) if mine
                     else (cy * cx * f1, -sy * sx * f1))
                o = ((-sy * cx * f1, -cy * sx * f1) if mine
                     else (sy * cx, -cy * sx))
            dc = torch.complex(*d).to(st.device)[:, None]
            oc = torch.complex(*o).to(st.device)[:, None]
            out.append(st.mul(dc).addcmul_(pt, oc))
        shards = out
    return shards


# ---------------------------------------------------------------------------
# shared set-up


def _ancilla(p, ancilla_factor):
    if ancilla_factor is not None:
        return ancilla_factor
    return (1.0 - p) ** 6 if p > 0 else 1.0


def _traj_groups(mesh, uniforms, n_traj, p, chunk=None):
    """[(t, uniforms of the run or None, trajectories c)]: the trajectories
    split over 'traj' in order, each group in runs of at most ``chunk``.
    ``uniforms`` may be a tuple of blocks (device noise), each sliced."""
    if uniforms is None and p > 0.0:
        raise ValueError("a noisy run (p > 0) needs its block of uniforms")
    if isinstance(uniforms, (tuple, list)):
        blocks = uniforms
        return [(t, tuple(b[lo:lo + run] for b in blocks), run)
                for t, lo, run in _runs(mesh, blocks[0].shape[0], chunk)]
    n = uniforms.shape[0] if uniforms is not None else n_traj
    return [(t, None if uniforms is None else uniforms[lo:lo + run], run)
            for t, lo, run in _runs(mesh, n, chunk)]


def _runs(mesh, n, chunk):
    """[(traj group, first trajectory, count)] of n trajectories."""
    groups = mesh.shape["traj"]
    if n is None or n % groups:
        raise ValueError(f"{n} trajectories do not split over the mesh's "
                         f"{groups} traj groups")
    c = n // groups
    step = chunk or c
    return [(t, lo, min(step, (t + 1) * c - lo)) for t in range(groups)
            for lo in range(t * c, (t + 1) * c, step)]


def _basis_shards(mesh, t, c, L, local_bits, b0, dtype):
    """The basis state b0 of c trajectories, one (c, M) tensor per shard."""
    M = 1 << local_bits
    out = []
    for a in range(mesh.shape["amp"]):
        st = torch.zeros((c, M), dtype=dtype, device=mesh.device(t, a))
        if a * M <= b0 < (a + 1) * M:
            st[:, b0 - a * M] = 1.0
        out.append(st)
    return out


def _probs(shards):
    """|psi|^2 of each shard, (n, M) real."""
    return [st.real.square().addcmul_(st.imag, st.imag) for st in shards]


def _z_part(prob, a, q, local_bits):
    """sum |psi|^2 z_q of shard a's probabilities (n, M), per trajectory:
    for a shard-local q the halves with bit q at 0 and at 1; for a
    shard-id bit q the shard's one sign."""
    if q < local_bits:
        prob = prob.view(prob.shape[0], -1, 2, 1 << q)
        return prob[:, :, 0].sum((1, 2)) - prob[:, :, 1].sum((1, 2))
    return (1 - 2 * (((a << local_bits) >> q) & 1)) * prob.sum(1)


def _measure(mesh, shards, q, local_bits):
    """sum_a sum |psi|^2 z_q over the shards, per trajectory (n,)."""
    return mesh.psum([_z_part(prob, a, q, local_bits)
                      for a, prob in enumerate(_probs(shards))])


def _sign(mask, q):
    return (1 - 2 * ((mask >> q) & 1)).to(torch.float32)


def _prev(words):
    """Each step's previous word along the last axis (0 first)."""
    return torch.cat([torch.zeros_like(words[..., :1]), words[..., :-1]], -1)


def _kernel_geometry(mesh, L, q):
    """L_loc after the cycle kernels' checks: ValueError outside
    17 <= L_loc <= 30 or for q >= L_loc (the reference's)."""
    local_bits = L - amp_bits(mesh)
    n_amp = mesh.shape["amp"]
    if not (17 <= local_bits <= 30):
        raise ValueError(
            f"cycle-kernel sharding needs 17 <= L - log2(n_amp) <= 30 "
            f"(got L={L}, n_amp={n_amp}: local_bits={local_bits})")
    if not (0 <= q < local_bits):
        raise ValueError(
            "cycle-kernel sharding requires a shard-local probe qubit "
            f"q < L - log2(n_amp) = {local_bits} (got q={q})")
    return local_bits


def use_hi(local_bits) -> bool:
    """The streamed per-shard kernels (``ops/cycle_hi.py``) from
    ``cycle_hi.MIN_ROUTE_L`` (at least 22) on, K8 below."""
    return local_bits >= max(cycle_hi.MIN_L, cycle_hi.MIN_ROUTE_L)


# Bytes an amplitude of a shard holds at the peak of an observables run:
# the complex64 state (8), the exchanged or gathered copy (8), its f32
# probabilities (4) and the Pauli string's int64 index and sign words
# (8 + 8 + 8 for the parity), rounded up.
OBS_AMP_BYTES = 64


def _launch_traj(mesh, local_bits, amp_bytes=16) -> int:
    """Trajectories of one run: ``amp_bytes`` a shard amplitude (16, a
    kernel run's complex64 state doubled for the out-of-place exchange) on
    the device that holds most of the run's shards, within
    KERNEL_STATE_BYTES (one kernel run's trajectory at L_loc >= 29 with a
    card a shard)."""
    per_device = max(
        sum(mesh.device(t, a) == mesh.device(t, b)
            for b in range(mesh.shape["amp"]))
        for t in range(mesh.shape["traj"]) for a in range(mesh.shape["amp"]))
    return max(1, KERNEL_STATE_BYTES // (amp_bytes * per_device << local_bits))


# ---------------------------------------------------------------------------
# sigma-frame engines (every shape; the plain reference of the kernel ones)


def make_sharded_autocorr_forward(mesh, *, L, T, K, p, q,
                                  initial_state="vacuum",
                                  dtype=torch.complex64, ancilla_factor=None,
                                  has_y=False):
    """Sharded sigma-frame forward autocorrelator.

    Returns fn(angles (T, K, 2), hs (L,), phis (L-1,), uniforms (n, T*K, L)
    or None, n_traj=None) -> A (T,), the trajectory average. Noise X-parts
    are deferred into the XOR frame sigma, shard-id bits included, so a
    sampled X on a global qubit costs no exchange."""
    n_amp = mesh.shape["amp"]
    local_bits = L - amp_bits(mesh)
    if local_bits < 1:
        raise ValueError(f"L={L} too small for {n_amp} amp-shards")
    M = 1 << local_bits
    af = _ancilla(p, ancilla_factor)
    b0 = basis_index(L, initial_state)
    s0 = 1.0 if ((b0 >> q) & 1) == 0 else -1.0
    ckw = dict(L=L, local_bits=local_bits, K=K, p=p, dtype=dtype,
               has_y=has_y)

    def fn(angles, hs, phis, uniforms=None, n_traj=None):
        total = 0.0
        n = 0
        for t, u, c in _traj_groups(mesh, uniforms, n_traj, p):
            dev0 = mesh.device(t, 0)
            d0s = [zz_z_phase_mask(hs.to(mesh.device(t, a)),
                                   phis.to(mesh.device(t, a)), L,
                                   offset=a * M, size=M, dtype=dtype)
                   for a in range(n_amp)]
            exp_h = torch.exp(1j * hs.to(dev0, torch.float32)).to(
                dtype).expand(c, L)
            exp_p = torch.exp(1j * phis.to(dev0, torch.float32)).to(
                dtype).expand(c, L - 1)
            if p > 0.0:
                _, zm, sig_b, csum = presample_noise(u.to(dev0), p, L)
                zm, sig_b = zm.reshape(c, T, K), sig_b.reshape(c, T, K)
                sig_after = csum.reshape(c, T, K)[:, :, -1]
            else:
                zm = sig_b = torch.zeros((c, T, K), dtype=torch.int64,
                                         device=dev0)
                sig_after = torch.zeros((c, T), dtype=torch.int64, device=dev0)
            sig_start = _prev(sig_after)
            shards = _basis_shards(mesh, t, c, L, local_bits, b0, dtype)
            zero = torch.zeros(c, dtype=torch.int64, device=dev0)
            pend = (zero, zero)
            out = []
            for tt in range(T):
                part = _measure(mesh, shards, q, local_bits).to(dev0)
                out.append(af * s0 * _sign(sig_start[:, tt], q) * part)
                if tt == T - 1:
                    break  # the last cycle's state is never measured
                shards, pend = _sharded_forward_cycle(
                    mesh, shards, pend, angles[tt],
                    (zm[:, tt], sig_b[:, tt], sig_after[:, tt]), d0s, exp_h,
                    exp_p, **ckw)
            total = total + torch.stack(out, 1).sum(0)
            n += c
        return total / n

    return fn


def make_sharded_echo(mesh, *, L, T, K, p, q, initial_state="vacuum",
                      dtype=torch.complex64, ancilla_factor=None,
                      has_y=False):
    """Sharded sigma-frame echo A0(t): t forward cycles, then t inverse
    cycles in reverse order, each followed by its noise event.

    Returns fn(angles, hs, phis, uniforms (n, 2T, K, L) or None, t_value,
    n_traj=None) -> the scalar echo. The uniforms are shared by every t,
    their codes zeroed from step 2t on."""
    n_amp = mesh.shape["amp"]
    local_bits = L - amp_bits(mesh)
    M = 1 << local_bits
    af = _ancilla(p, ancilla_factor)
    b0 = basis_index(L, initial_state)
    s0 = 1.0 if ((b0 >> q) & 1) == 0 else -1.0
    kw = dict(L=L, local_bits=local_bits, dtype=dtype, has_y=has_y)

    def fn(angles, hs, phis, uniforms, t_value, n_traj=None):
        t_value = int(t_value)
        total = 0.0
        n = 0
        for t, u, c in _traj_groups(mesh, uniforms, n_traj, p):
            dev0 = mesh.device(t, 0)
            d0s = [zz_z_phase_mask(hs.to(mesh.device(t, a)),
                                   phis.to(mesh.device(t, a)), L,
                                   offset=a * M, size=M, dtype=dtype)
                   for a in range(n_amp)]
            exp_h = torch.exp(1j * hs.to(dev0, torch.float32)).to(
                dtype).expand(c, L)
            exp_p = torch.exp(1j * phis.to(dev0, torch.float32)).to(
                dtype).expand(c, L - 1)
            if p > 0.0:
                codes = _codes_from_uniform(u.to(dev0).reshape(c, 2 * T, K, L),
                                            p)
                active = torch.arange(2 * T, device=dev0) < 2 * t_value
                codes = torch.where(active[:, None, None], codes, 0)
                xm, zm = _masks_from_codes(codes, L)               # (c, 2T, K)
                csum = xor_scan(xm.reshape(c, 2 * T * K), L)
                sig_b = _prev(csum).reshape(c, 2 * T, K)
                sig_after = csum.reshape(c, 2 * T, K)[:, :, -1]
            else:
                zm = sig_b = torch.zeros((c, 2 * T, K), dtype=torch.int64,
                                         device=dev0)
                sig_after = torch.zeros((c, 2 * T), dtype=torch.int64,
                                        device=dev0)
            shards = _basis_shards(mesh, t, c, L, local_bits, b0, dtype)
            zero = torch.zeros(c, dtype=torch.int64, device=dev0)
            pend_zm, pend_sig = zero, zero
            for k in range(2 * t_value):
                fwd = k < t_value
                ang = angles[k if fwd else min(max(2 * t_value - 1 - k, 0),
                                               T - 1)]
                eh, ep = (exp_h, exp_p) if fwd else (exp_h.conj(),
                                                     exp_p.conj())
                if not fwd:
                    shards = [s * d.conj() for s, d in zip(shards, d0s)]
                for j in range(K):
                    slot = j if fwd else K - 1 - j
                    pz = pend_zm if j == 0 else zm[:, k, j - 1]
                    if j == 0:
                        dsig = pend_sig if fwd else sig_b[:, k, 0] ^ pend_sig
                    else:
                        dsig = zero
                    shards = _sharded_kick_factored(
                        mesh, shards, ang[slot, 0], ang[slot, 1],
                        sig_b[:, k, j], pz, dsig, eh, ep, inverse=not fwd,
                        **kw)
                if fwd:
                    shards = [s * d for s, d in zip(shards, d0s)]
                pend_zm = zm[:, k, K - 1]
                pend_sig = sig_after[:, k] if fwd else zero
            part = _measure(mesh, shards, q, local_bits).to(dev0)
            e = af * s0 * _sign(sig_after[:, -1], q) * part
            total = total + e.sum()
            n += c
        return total / n

    return fn


def make_sharded_observables(mesh, *, L, T, K, p, initial_state="vacuum",
                             dtype=torch.complex64):
    """Sharded single-state evolution emitting the energy and every
    <Z_q>: the counterpart of ``core/evolve.py::evolve_observables``.

    Returns fn(angles (T, K, 2), hs (L,), phis (L-1,), term_hs (L,),
    term_phis (L-1,), x_coeff, uniforms (n, T*K, L) or None, n_traj=None,
    seed=0) -> (E (T,), zs (T, L)), trajectory averages in the state's real
    type on the device of shard (0, 0). Each cycle measures, then (but the
    last) runs its K slots: the kick on the local bits and, one exchange
    each, on the shard-id bits, then the slot's sampled Pauli string; then
    the diagonal. The diagonal energy and every <Z_q> are shard-local
    sums; <X_q> of a local qubit is a shard-local pair sum, of a shard-id
    bit one partner exchange, each shard of a pair adding Re <mine|partner>
    (the pair gives the factor 2); with x_coeff == 0 no X sum is taken.
    Sums over shards run in shard order. A traj group runs in runs of at
    most ``_launch_traj(mesh, L_loc, OBS_AMP_BYTES)`` trajectories. Without
    uniforms and with p > 0 the block is drawn from a generator seeded
    with ``seed``."""
    n_amp = mesh.shape["amp"]
    k_bits = amp_bits(mesh)
    local_bits = L - k_bits
    if local_bits < 1:
        raise ValueError(f"L={L} too small for {n_amp} amp-shards")
    M = 1 << local_bits
    real = torch.float64 if dtype == torch.complex128 else torch.float32
    b0 = basis_index(L, initial_state)
    run = _launch_traj(mesh, local_bits, OBS_AMP_BYTES)

    def measure(shards, diag_es, x_coeff):
        probs = _probs(shards)
        e = mesh.psum([(pr * de).sum(1) for pr, de in zip(probs, diag_es)])
        zs = torch.stack([
            mesh.psum([_z_part(pr, a, q, local_bits)
                       for a, pr in enumerate(probs)]) for q in range(L)], 1)
        if x_coeff == 0.0:
            return e, zs
        xs = []
        for q in range(L):
            if q < local_bits:
                parts = [expect_x(st, q, local_bits) for st in shards]
            else:
                partners = mesh.xor_partners(shards, q - local_bits)
                parts = [(st.real * pt.real + st.imag * pt.imag).sum(1)
                         for st, pt in zip(shards, partners)]
            xs.append(mesh.psum(parts))
        x_sum = torch.stack(xs).sum(0)
        return e + x_coeff * x_sum.to(e.device), zs

    def fn(angles, hs, phis, term_hs, term_phis, x_coeff, uniforms=None,
           n_traj=None, seed=0):
        dev0 = mesh.device(0, 0)
        if uniforms is None and p > 0.0:
            gen = torch.Generator(device=dev0).manual_seed(seed)
            uniforms = torch.rand((n_traj, T * K, L), generator=gen,
                                  dtype=torch.float32, device=dev0)
        x_coeff = float(x_coeff)
        e_tot, z_tot, n = 0.0, 0.0, 0
        for t, u, c in _traj_groups(mesh, uniforms, n_traj, p, run):
            devs = [mesh.device(t, a) for a in range(n_amp)]
            diags = [zz_z_phase_mask(hs.to(d), phis.to(d), L, offset=a * M,
                                     size=M, dtype=dtype)
                     for a, d in enumerate(devs)]
            diag_es = [zz_z_diag_energy(torch.as_tensor(term_hs).to(d),
                                        torch.as_tensor(term_phis).to(d), L,
                                        offset=a * M, size=M, dtype=real)
                       for a, d in enumerate(devs)]
            if p > 0.0:
                codes = _codes_from_uniform(u.to(devs[0]), p).reshape(
                    c, T, K, L)
            shards = _basis_shards(mesh, t, c, L, local_bits, b0, dtype)
            es, zs = [], []
            for tt in range(T):
                e, z = measure(shards, diag_es, x_coeff)
                es.append(e.to(dev0))
                zs.append(z.to(dev0))
                if tt == T - 1:
                    break  # the last cycle's kicks are never measured
                for k in range(K):
                    uk = slot_unitary(angles[tt, k, 0], angles[tt, k, 1],
                                      dtype)
                    shards = [apply_uniform_1q_layer(st, uk.to(st.device),
                                                     local_bits)
                              for st in shards]
                    for gb in range(k_bits):
                        shards = _global_1q(mesh, shards,
                                            uk.expand(c, 2, 2), gb)
                    if p > 0.0:
                        xm, zm, n_y = pauli_string_masks(codes[:, tt, k])
                        shards = _sharded_pauli_string(
                            mesh, shards, xm, zm, n_y, local_bits=local_bits)
                shards = [st * d for st, d in zip(shards, diags)]
            e_tot = e_tot + torch.stack(es, 1).sum(0)
            z_tot = z_tot + torch.stack(zs, 1).sum(0)
            n += c
        return e_tot / n, z_tot / n

    return fn


# ---------------------------------------------------------------------------
# cycle-kernel engines, 17 <= L_loc <= 30


def _x_cycles(shards, zm, sig, hs, phis, theta, *, L, local_bits,
              inverse=False):
    """The per-shard x cycle of every step of a run, with each shard's
    global diagonal, its rows built once, before the step loop: zm and sig
    (c, S) the noise-Z and sigma words of the S steps, from which come the
    compact rows of the local bits (``pack_cycle_params_compact`` at L =
    L_loc) and every step's and shard's global diagonal at once
    (``_tail_phase_angles``), folded together into each launch's row pairs
    (``cycle.fold_cycle_rows``) for K8 or, from ``cycle_hi.MIN_ROUTE_L``,
    K9. Returns run(k, a, st, q=None): step k on shard a's states st in
    place; the forward's partial sum |psi|^2 z_q with q, else None (no
    measure; the inverse never measures)."""
    rows = pack_cycle_params_compact(
        zm, sig, hs[:local_bits].to(zm.device),
        phis[:local_bits - 1].to(zm.device), local_bits,
        forward_width(local_bits)).transpose(0, 1)       # (S, c, width)
    th = (None, None)
    if L > local_bits:
        aidx = torch.arange(len(shards), device=zm.device)[:, None]
        th = _tail_phase_angles(zm.T[:, None], sig.T[:, None], hs, phis,
                                aidx, L=L, local_bits=local_bits)  # (S, A, c)
    fold = cycle.fold_cycle_rows(rows[:, None], local_bits, *th,
                                 inverse=inverse)  # (S, A or 1, c, 2, 2L)
    per = [fold[:, a].contiguous().to(st.device)
           for a, st in enumerate(shards)]
    entry = {(False, False): cycle.cycle_forward_apply,
             (False, True): cycle.cycle_inverse_apply,
             (True, False): cycle_hi.hi_cycle_forward_apply,
             (True, True): cycle_hi.hi_cycle_inverse_apply}[
                 use_hi(local_bits), inverse]

    def run(k, a, st, q=None):
        if inverse:
            entry(st, per[a][k], theta, L=local_bits)
            return None
        return entry(st, per[a][k], theta, L=local_bits, q=q)[1]

    return run


def make_sharded_autocorr_forward_kernel(mesh, *, L, T, p, q,
                                         initial_state="vacuum",
                                         ancilla_factor=None):
    """Cycle-kernel sharded forward autocorrelator of a constant x drive:
    every cycle is the shard-bit kicks (torch ops), then one K8a (K9a from
    ``cycle_hi.MIN_ROUTE_L`` on) launch per shard: the local kick, the
    local noise-Z and sigma-conjugated D0 with the shard's global diagonal,
    and the A(t) partial (exact: the shard-bit kicks commute with the local
    kick and diagonal, and z_q of a local bit with them).

    Same semantics as ``make_sharded_autocorr_forward`` (K=1): fn(angles,
    hs, phis, uniforms (n, T, L) or None, n_traj=None) -> A (T,). Requires a
    constant x-only schedule, 17 <= L_loc <= 30 and q < L_loc."""
    local_bits = _kernel_geometry(mesh, L, q)
    k_bits = L - local_bits
    af = _ancilla(p, ancilla_factor)
    b0 = basis_index(L, initial_state)
    s0 = 1.0 if ((b0 >> q) & 1) == 0 else -1.0

    def fn(angles, hs, phis, uniforms=None, n_traj=None):
        theta = _check_constant_x(angles)
        total = 0.0
        n = 0
        for t, u, c in _traj_groups(mesh, uniforms, n_traj, p,
                                    _launch_traj(mesh, local_bits)):
            dev0 = mesh.device(t, 0)
            if p > 0.0:
                _, zm, _, csum = presample_noise(u.to(dev0), p, L)  # (c, T)
            else:
                zm = csum = torch.zeros((c, T), dtype=torch.int64,
                                        device=dev0)
            shards = _basis_shards(mesh, t, c, L, local_bits, b0,
                                   torch.complex64)
            # A(0) is analytic: the T - 1 cycles after it
            run = _x_cycles(shards, zm[:, :T - 1], csum[:, :T - 1], hs, phis,
                            theta, L=L, local_bits=local_bits)
            frames = []
            for tt in range(T - 1):
                if k_bits:
                    shards = _global_shard_kicks(mesh, shards, theta)
                frames.append(mesh.psum([run(tt, a, st, q) for a, st in
                                         enumerate(shards)]).to(dev0))
            # A(t >= 1) carries the sigma sign after cycle t-1
            a_traj = torch.full((c, T), af, dtype=torch.float32, device=dev0)
            if T > 1:
                a_traj[:, 1:] = (af * s0 * _sign(csum[:, :T - 1], q)
                                 * torch.stack(frames, 1))
            total = total + a_traj.sum(0)
            n += c
        return total / n

    return fn


def make_sharded_echo_kernel(mesh, *, L, T, p, q, initial_state="vacuum",
                             ancilla_factor=None):
    """Cycle-kernel sharded echo A0(t) of a constant x drive: a forward step
    is the shard-bit kicks, then one K8a (K9a) launch per shard with the
    shard's global diagonal and no measure; at the turnaround the imaginary
    part is negated once, after which every inverse step is one K8b (K9b)
    launch per shard, the global diagonal (with the previous event's Z
    word, zeroed at step t) with the local one before the local kick, then
    the shard-bit kicks, in reverse time order. Only the 2t active steps
    run.

    Same semantics as ``make_sharded_echo`` (K=1): fn(angles, hs, phis,
    uniforms (n, 2T, 1, L) or None, t_value, n_traj=None) -> scalar."""
    local_bits = _kernel_geometry(mesh, L, q)
    k_bits = L - local_bits
    af = _ancilla(p, ancilla_factor)
    b0 = basis_index(L, initial_state)
    s0 = 1.0 if ((b0 >> q) & 1) == 0 else -1.0
    T2 = 2 * T

    def fn(angles, hs, phis, uniforms, t_value, n_traj=None):
        theta = _check_constant_x(angles)
        t_value = int(t_value)
        total = 0.0
        n = 0
        for t, u, c in _traj_groups(mesh, uniforms, n_traj, p,
                                    _launch_traj(mesh, local_bits)):
            dev0 = mesh.device(t, 0)
            step = torch.arange(T2, device=dev0)
            if p > 0.0:
                codes = _codes_from_uniform(u.to(dev0).reshape(c, T2, L), p)
                codes = torch.where((step < 2 * t_value)[:, None], codes, 0)
                xm, zm = _masks_from_codes(codes, L)               # (c, 2T)
                csum = xor_scan(xm, L)
            else:
                zm = csum = torch.zeros((c, T2), dtype=torch.int64,
                                        device=dev0)
            sig_b = _prev(csum)
            zm_prev = torch.where(step == t_value, 0, _prev(zm))
            shards = _basis_shards(mesh, t, c, L, local_bits, b0,
                                   torch.complex64)
            # the forward steps [0, t), the inverse steps [t, 2t)
            f, i = slice(0, t_value), slice(t_value, 2 * t_value)
            kw = dict(L=L, local_bits=local_bits)
            fwd = _x_cycles(shards, zm[:, f], csum[:, f], hs, phis, theta,
                            **kw)
            inv = _x_cycles(shards, zm_prev[:, i], sig_b[:, i], hs, phis,
                            theta, inverse=True, **kw)
            for k in range(t_value):
                if k_bits:
                    shards = _global_shard_kicks(mesh, shards, theta)
                for a, st in enumerate(shards):
                    fwd(k, a, st)
            shards = [s.conj_physical_() for s in shards]
            for k in range(t_value):
                for a, st in enumerate(shards):
                    inv(k, a, st)
                if k_bits:
                    shards = _global_shard_kicks(mesh, shards, theta)
            part = _measure(mesh, shards, q, local_bits).to(dev0)
            e = af * s0 * _sign(csum[:, -1], q) * part
            total = total + e.sum()
            n += c
        return total / n

    return fn


def _check_device(device, p, uniforms=None, called=False):
    """The device mode's conditions: p == 0 when the engine is made, the
    device uniform blocks when it is called."""
    if device is not None and p != 0.0:
        raise ValueError("device mode replaces depolarizing noise; pass p=0")
    if device is not None and called and not isinstance(uniforms,
                                                         (tuple, list)):
        raise ValueError("device mode needs its uniform blocks (u1, ue, uo)")


def _device_rates(device, dev):
    """(p_1q, p_2q, events_per_kick) on ``dev``: the rates in f32, as the
    reference's sharded engines take them."""
    p1, p2, epk = device
    return (torch.as_tensor(p1, dtype=torch.float32, device=dev),
            torch.as_tensor(p2, dtype=torch.float32, device=dev), int(epk))


def _on_final(rows, K):
    """Per-cycle rows (c, T, n) -> per-slot rows (c, T*K, n), zero off the
    final slots."""
    c, T, n = rows.shape
    out = torch.zeros((c, T, K, n), dtype=rows.dtype, device=rows.device)
    out[:, :, K - 1] = rows
    return out.reshape(c, T * K, n)


def _general_words(u, p, L, shape, dev):
    """(xm, zm) int64 of ``shape`` from uniforms (..., L); zeros at p=0."""
    if p > 0.0:
        return _masks_from_codes(_codes_from_uniform(u.to(dev), p), L)
    zero = torch.zeros(shape, dtype=torch.int64, device=dev)
    return zero, zero


def _global_angles(shards, zm, sig, hs, phis, *, L, local_bits):
    """Every step's and shard's global diagonal of a run, in one
    ``_tail_phase_angles`` call: zm and sig (c, S) the words of each step's
    global diagonal (masked to the shard bits), hs and phis as it takes
    them, broadcast against (S, 1, c) (per step and trajectory in device
    mode). Returns (th_sc, th_bnd) (S, A, c), or None without shard bits."""
    if L == local_bits:
        return None
    aidx = torch.arange(len(shards), device=zm.device)[:, None]
    return _tail_phase_angles(zm.T[:, None], sig.T[:, None], hs, phis, aidx,
                              L=L, local_bits=local_bits)


def _general_cycles(shards, rows, th, *, local_bits, K, inverse=False):
    """The per-shard lab-frame cycle of every step of a run, with each
    shard's global diagonal: rows (S, c, K, width) the steps' slot rows
    (forward) or (S, c, K, 2, width) their (pre, post) slot pairs
    (``inverse``) at L = L_loc, th the steps' (th_sc, th_bnd) (S, A, c) of
    ``_global_angles`` (negated by the caller to dagger them) or None. The
    angles are folded into each launch's rows (``cycle.fold_general_rows``,
    once, before the step loop): K8c (K10a shard-local from
    ``cycle_hi.MIN_ROUTE_L``) carries the global diagonal after its final
    slot, K8d (K10b shard-local) before its first kick. Returns run(k, a,
    st, q=None): step k on shard a's states st in place; the forward's
    partial sum |psi|^2 z_q, the inverse None."""
    fold = cycle.fold_general_rows(rows[:, None], local_bits,
                                   *(th or (None, None)), inverse=inverse)
    per = [fold[:, a].contiguous().to(st.device)
           for a, st in enumerate(shards)]
    if use_hi(local_bits):
        fwd, inv = (cycle_hi.general_hi_cycle_forward_apply,
                    cycle_hi.general_hi_cycle_inverse_apply)
    else:
        fwd, inv = (cycle.general_cycle_forward_apply,
                    cycle.general_cycle_inverse_apply)
    kw = dict(L=local_bits, K=K)

    def run(k, a, st, q=None):
        r = rows[k].to(st.device)
        if inverse:
            inv(st, r, per[a][k], **kw)
            return None
        return fwd(st, r, per[a][k], q=q, **kw)[1]

    return run


def make_sharded_autocorr_forward_general(mesh, *, L, T, K, p, q,
                                          initial_state="vacuum",
                                          ancilla_factor=None, device=None):
    """Lab-frame cycle-kernel sharded forward autocorrelator for every
    drive and per-cycle schedule: a cycle is the K global slot kicks, then
    one K8c (K10a, shard-local, from ``cycle_hi.MIN_ROUTE_L`` on) launch per
    shard for its shard-local work (K slot kicks with X-mask row folds, the
    local diagonal, the partial) and the shard's global diagonal
    (``_general_cycles``: in the launch's folded rows, after the final
    slot). The
    shard-id bits keep an XOR noise frame, so the global slot kicks are
    sigma-conjugated per trajectory and the cycle's global diagonal is
    evaluated at the cycle-end frame with the sig words masked to shard
    bits (local bits are lab-frame); its angles are built once a call for
    every cycle and shard. The order is exact: the global slot kicks (their
    noise-Z words on the 2x2 columns) act on shard bits only and the local
    slots and diagonal on local bits only, so they commute; the global
    diagonal, which holds the boundary bond, still follows every kick, and
    z_q of a local bit commutes with the global kicks.

    Same semantics as ``make_sharded_autocorr_forward``: fn(angles, hs,
    phis, uniforms (n, T*K, L) or None, n_traj=None) -> A (T,). Requires
    17 <= L_loc <= 30 and q < L_loc. ``device=(p_1q, p_2q,
    events_per_kick)`` (p == 0) takes the device rows of
    ``core/device_evolve.py::_device_general_rows`` from uniforms (u1 (n,
    T, K*E, L), ue, uo); the final slot's sign-adjusted phi row also
    reaches the global diagonal."""
    _check_device(device, p)
    local_bits = _kernel_geometry(mesh, L, q)
    width = general_hi_width(local_bits)
    k_bits = L - local_bits
    af = _ancilla(p, ancilla_factor)
    b0 = basis_index(L, initial_state)
    s0 = 1.0 if ((b0 >> q) & 1) == 0 else -1.0
    S = T * K
    gmask = ((1 << L) - 1) & ~((1 << local_bits) - 1)
    gkw = dict(L=L, local_bits=local_bits)

    def fn(angles, hs, phis, uniforms=None, n_traj=None):
        _check_device(device, p, uniforms, called=True)
        host = angles.detach().cpu().tolist()
        total = 0.0
        n = 0
        for t, u, c in _traj_groups(mesh, uniforms, n_traj, p,
                                    _launch_traj(mesh, local_bits)):
            dev0 = mesh.device(t, 0)
            ang = angles.to(dev0)
            if device is not None:
                zm, xm, phi_rows = _device_general_rows(
                    tuple(b.to(dev0) for b in u), phis.to(dev0),
                    *_device_rates(device, dev0), T, K, L)
                dkw = dict(masks=(zm, xm),
                           phi_rows=phi_rows[..., :local_bits - 1])
                phi_fin = phi_rows.reshape(c, T, K, L - 1)[:, :, K - 1]
            else:
                xm, zm = _general_words(u, p, L, (c, S), dev0)     # (c, S)
                dkw = {}
            csum = xor_scan(xm, L)
            sig_b = _prev(csum).reshape(c, T, K)
            zm_prev = _prev(zm).reshape(c, T, K)
            # the previous cycle's final event reached the shard bits in
            # that cycle's global diagonal: slot 0 folds no Z word
            zm_prev[:, :, 0] = 0
            zm_fin = zm.reshape(c, T, K)[:, :, K - 1] & gmask
            csum_fin = csum.reshape(c, T, K)[:, :, K - 1] & gmask
            rows = general_forward_rows(
                None if u is None or device is not None
                else u.to(dev0)[..., :local_bits],
                hs[:local_bits].to(dev0), phis[:local_bits - 1].to(dev0),
                ang, L=local_bits, T=T, K=K, p=p, batch=(c,), width=width,
                **dkw)
            rows = rows.reshape(c, T, K, -1).transpose(0, 1).contiguous()
            shards = _basis_shards(mesh, t, c, L, local_bits, b0,
                                   torch.complex64)
            # A(0) is analytic: the T - 1 cycles after it
            ph = (phis if device is None
                  else phi_fin[:, :T - 1].transpose(0, 1)[:, None])
            th = _global_angles(shards, zm_fin[:, :T - 1],
                                csum_fin[:, :T - 1], hs, ph, **gkw)
            run = _general_cycles(shards, rows[:T - 1], th,
                                  local_bits=local_bits, K=K)
            frames = []
            for tt in range(T - 1):
                if k_bits:
                    for k in range(K):
                        shards = _global_general_slot_kick(
                            mesh, shards, host[tt][k][0], host[tt][k][1],
                            sig_b[:, tt, k], zm_prev[:, tt, k],
                            local_bits=local_bits)
                frames.append(mesh.psum([run(tt, a, st, q) for a, st in
                                         enumerate(shards)]).to(dev0))
            a_traj = torch.full((c, T), af, dtype=torch.float32, device=dev0)
            if T > 1:  # no sigma sign: q is a lab-frame local bit
                a_traj[:, 1:] = af * s0 * torch.stack(frames, 1)
            total = total + a_traj.sum(0)
            n += c
        return total / n

    return fn


def make_sharded_echo_general(mesh, *, L, T, K, p, q, initial_state="vacuum",
                              ancilla_factor=None, device=None):
    """Lab-frame cycle-kernel sharded echo A0(t) for every drive: forward
    steps are the forward engine's cycle (the sigma-conjugated global slot
    kicks, then one K8c, or K10a shard-local, launch per shard with the
    global diagonal); inverse steps have no conjugation trick (Y slots are
    not symmetric): one K8d (K10b shard-local) launch per shard with K4's
    echo rows of the inverse step (daggered slot unitaries in reversed
    order, the D0^dag lead on the first slot), led by the daggered global
    diagonal (at the step's pre-event sigma with the previous event's Z
    word, zeroed at the turnaround), then the daggered global slot kicks in
    reversed slot order. The global diagonal rides in the launches' folded
    rows, after the forward's final slot and before the inverse's first
    kick (``_general_cycles``); the angles of every step and shard come from
    one ``_tail_phase_angles`` call. The order is exact for the reason the
    forward engine gives: the global diagonal still comes before every
    kick of an inverse step.

    Same semantics as ``make_sharded_echo``: fn(angles, hs, phis, uniforms
    (n, 2T, K, L) or None, t_value, n_traj=None) -> scalar. Requires
    17 <= L_loc <= 30 and q < L_loc. ``device=`` as in the forward, from
    ``core/device_evolve.py::_device_general_echo_rows`` (uniforms of 2T
    steps): the forward steps' rows and global diagonal take the signed
    post rows, the inverse steps' global diagonal the pre rows, which carry
    the D0^dag negation (so it is not negated again)."""
    _check_device(device, p)
    local_bits = _kernel_geometry(mesh, L, q)
    width = general_hi_width(local_bits)
    k_bits = L - local_bits
    af = _ancilla(p, ancilla_factor)
    b0 = basis_index(L, initial_state)
    s0 = 1.0 if ((b0 >> q) & 1) == 0 else -1.0
    T2 = 2 * T
    gmask = ((1 << L) - 1) & ~((1 << local_bits) - 1)
    gkw = dict(L=L, local_bits=local_bits)

    def fn(angles, hs, phis, uniforms, t_value, n_traj=None):
        _check_device(device, p, uniforms, called=True)
        t_value = int(t_value)
        host = angles.detach().cpu().tolist()
        total = 0.0
        n = 0
        for t, u, c in _traj_groups(mesh, uniforms, n_traj, p,
                                    _launch_traj(mesh, local_bits)):
            dev0 = mesh.device(t, 0)
            ang = angles.to(dev0)
            h_loc = hs[:local_bits].to(dev0)
            ph_loc = phis[:local_bits - 1].to(dev0)
            if device is not None:
                xk, zk, *diag = _device_general_echo_rows(
                    tuple(b.to(dev0) for b in u), [t_value], hs.to(dev0),
                    phis.to(dev0), *_device_rates(device, dev0), T, K, L)
                pre_h, pre_phi, post_h, post_phi = (r[:, 0] for r in diag)
                xm = xk[:, 0].reshape(c, T2 * K)
                zm = zk[:, 0].reshape(c, T2 * K)
                rows_f = general_forward_rows(
                    None, h_loc, ph_loc, ang, L=local_bits, T=T, K=K, p=0.0,
                    width=width, masks=(zm[:, :T * K], xm[:, :T * K]),
                    h_rows=_on_final(post_h[:, :T, :local_bits], K),
                    phi_rows=_on_final(post_phi[:, :T, :local_bits - 1], K))
                tiles = general_echo_rows(
                    None, [t_value], h_loc, ph_loc, ang, L=local_bits, T=T,
                    K=K, p=0.0, width=width, masks=(xk, zk),
                    diag_rows=tuple(r[..., :local_bits - (i % 2)]
                                    for i, r in enumerate(diag)))
            else:
                u = None if u is None else u.to(dev0).reshape(c, T2 * K, L)
                xm, zm = _general_words(u, p, L, (c, T2 * K), dev0)
                if p > 0.0:
                    active = (torch.arange(T2 * K, device=dev0) // K
                              < 2 * t_value)
                    xm, zm = xm * active, zm * active
                u_loc = None if u is None else u[..., :local_bits]
                rows_f = general_forward_rows(
                    None if u is None else u_loc[:, :T * K], h_loc, ph_loc,
                    ang, L=local_bits, T=T, K=K, p=p, batch=(c,),
                    width=width)
                tiles = general_echo_rows(u_loc, [t_value], h_loc, ph_loc,
                                          ang, L=local_bits, T=T, K=K, p=p,
                                          batch=(c,), width=width)
            csum = xor_scan(xm, L)
            sig_b = _prev(csum).reshape(c, T2, K)
            zm_prev = _prev(zm).reshape(c, T2, K)
            if t_value < T2:  # the last forward cycle folded its own event
                zm_prev[:, t_value, 0] = 0
            zero = torch.zeros(c, dtype=torch.int64, device=dev0)
            zm_fin = zm.reshape(c, T2, K)[:, :, K - 1] & gmask
            csum_fin = csum.reshape(c, T2, K)[:, :, K - 1] & gmask
            rows_f = rows_f.reshape(c, T, K, -1).transpose(0, 1).contiguous()
            tiles = tiles.reshape(c, T2, K, 2, -1).transpose(0, 1).contiguous()
            shards = _basis_shards(mesh, t, c, L, local_bits, b0,
                                   torch.complex64)
            # the forward steps [0, t) and the inverse steps [t, 2t)
            f, i = slice(0, t_value), slice(t_value, 2 * t_value)
            if device is None:
                hk, pk = hs, phis
            else:
                hk, pk = (torch.cat([post[:, f], pre[:, i]], 1).transpose(
                    0, 1)[:, None] for post, pre in ((post_h, pre_h),
                                                     (post_phi, pre_phi)))
            th = _global_angles(
                shards, torch.cat([zm_fin[:, f], zm_prev[:, i, 0] & gmask], 1),
                torch.cat([csum_fin[:, f], sig_b[:, i, 0] & gmask], 1), hk,
                pk, **gkw)
            th_f = th_i = None
            if th is not None:
                # device rows carry the D0^dag negation themselves
                sign = -1.0 if device is None else 1.0
                th_f = tuple(x[f] for x in th)
                th_i = tuple(sign * x[t_value:] for x in th)
            fwd = _general_cycles(shards, rows_f[f], th_f,
                                  local_bits=local_bits, K=K)
            inv = _general_cycles(shards, tiles[i], th_i,
                                  local_bits=local_bits, K=K, inverse=True)
            for k in range(t_value):
                if k_bits:
                    # slot 0 folds no Z word: the previous step's final
                    # event is in that step's global diagonal
                    for j in range(K):
                        shards = _global_general_slot_kick(
                            mesh, shards, host[k][j][0], host[k][j][1],
                            sig_b[:, k, j],
                            zero if j == 0 else zm_prev[:, k, j],
                            local_bits=local_bits)
                for a, st in enumerate(shards):
                    fwd(k, a, st, q)
            for k in range(t_value, 2 * t_value):
                for a, st in enumerate(shards):
                    inv(k - t_value, a, st)
                if k_bits:
                    ci = min(max(2 * t_value - 1 - k, 0), T - 1)
                    for j in range(K):
                        shards = _global_general_slot_kick(
                            mesh, shards, host[ci][K - 1 - j][0],
                            host[ci][K - 1 - j][1], sig_b[:, k, j],
                            zero if j == 0 else zm_prev[:, k, j],
                            local_bits=local_bits, dagger=True)
            part = _measure(mesh, shards, q, local_bits).to(dev0)
            # q is a lab-frame local bit: no sigma measurement sign
            total = total + (af * s0 * part).sum()
            n += c
        return total / n

    return fn
