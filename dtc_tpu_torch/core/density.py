"""Exact noisy evolution: the vectorized density matrix, interleaved bits.

Port of ``dtc_tpu/core/density.py``: the layout helpers (``pure_dm_vec``,
``dm_vec_to_matrix``, ``op_vec``, ``diag_mask_dm``,
``pauli_weight_vector``, ``trace_weight_vector``), the site and two-site
superoperators (``unitary_site_op``, ``depolarizing_site_op``,
``apply_uniform_site_layer``, ``apply_site_op``, ``two_qubit_superop``,
``apply_two_site_op``), the cycle ``_dm_cycle``, ``dm_autocorr_forward``,
``dm_autocorr_echo``, ``dm_energy``, ``energy_weight_vector``,
``dm_autocorr_interferometric`` and the run wrappers
``dm_autocorr_forward_run`` / ``dm_autocorr_echo_run`` (the
``method="exact"`` mode of ``experiments/autocorr.py``).

A density matrix on n qubits is a vector of 4^n amplitudes whose base-4
digit q holds (col_bit << 1 | row_bit) of qubit q. In this layout a
unitary U on qubit q is the 4x4 kron(conj(U), U) on digit q, a 1q channel
its 4x4 superoperator, the fused RZZ+RZ layer one diagonal mask
D(row) conj(D(col)), and Tr(P rho) of a Pauli string one weighted sum.
A kick slot and its depolarizing channel act on each digit alone, so the
cycle applies their 4x4 product per digit, in kron groups of 3 digits
(64 x 64 products through ``torch.matmul``, TF32 off: ``ops/precision.py``).

Direct mode: the ancilla coherence block of the Hadamard test evolves as
the operator B_0 = rho_0 Z_q through the noisy cycle superoperator, and
A(t) = (1-p)^6 Re Tr(Z_q B_t), one pass over the cycles. The echo of time
t runs t forward cycles and t inverse ones; the echoes of a vector of
times share the forward cycles, so the run holds two density vectors (the
forward carry and one echo) and needs no chunks over t, where the
reference's vmap over t holds one vector per time.
``dm_autocorr_interferometric`` keeps the literal ancilla qubit and its six
depolarizing events, for validation.
"""

from __future__ import annotations

import numpy as np
import torch

from dtc_tpu_torch.core.sigma_evolve import DTYPES
from dtc_tpu_torch.core.statevector import initial_statevector
from dtc_tpu_torch.models.drives import slot_unitary, slot_unitary_inverse
from dtc_tpu_torch.ops.diag import z_sign_mask, zz_z_phase_mask

# ---------------------------------------------------------------------------
# layout helpers


def _interleave_bits(row: int, col: int, n: int) -> int:
    s = 0
    for q in range(n):
        s |= ((row >> q) & 1) << (2 * q)
        s |= ((col >> q) & 1) << (2 * q + 1)
    return s


# A CUDA tensor takes at most 25 dimensions, so the 2n bit axes of an
# n-qubit operator are permuted in two blocks: the high qubits' digits,
# then the low qubits', each block with a leading and a trailing axis.


def _split_qubits(n: int):
    """(high, low) qubit counts of the two blocks."""
    return n // 2, n - n // 2


def _interleave_block(t: torch.Tensor, k: int) -> torch.Tensor:
    """(P, 2^k row, 2^k col, S) -> (P, 4^k, S), digit q = col_q<<1 | row_q."""
    P, S = t.shape[0], t.shape[-1]
    t = t.reshape(P, *(2,) * (2 * k), S)
    # axis 1+i is row bit k-1-i, axis 1+k+i col bit k-1-i; from the top
    # digit down, each digit's col axis then its row axis
    perm = [0]
    for i in range(k):
        perm += [1 + k + i, 1 + i]
    return t.permute(perm + [2 * k + 1]).reshape(P, 4 ** k, S)


def _deinterleave_block(t: torch.Tensor, k: int) -> torch.Tensor:
    """Inverse of ``_interleave_block``: (P, 4^k, S) -> (P, 2^k, 2^k, S)."""
    P, S = t.shape[0], t.shape[-1]
    t = t.reshape(P, *(2,) * (2 * k), S)
    # axes 1.. : [col_{k-1}, row_{k-1}, col_{k-2}, row_{k-2}, ...]
    rows = [2 + 2 * i for i in range(k)]
    cols = [1 + 2 * i for i in range(k)]
    return t.permute([0] + rows + cols + [2 * k + 1]).reshape(
        P, 1 << k, 1 << k, S)


def _interleave(rho: torch.Tensor, n: int) -> torch.Tensor:
    """rho[row, col] (2^n, 2^n) -> the interleaved vec (4^n,)."""
    a, b = _split_qubits(n)
    t = rho.reshape(1 << a, 1 << b, 1 << a, 1 << b).permute(0, 2, 1, 3)
    t = _interleave_block(t.reshape(1, 1 << a, 1 << a, 4 ** b), a)
    t = _interleave_block(t.reshape(4 ** a, 1 << b, 1 << b, 1), b)
    return t.reshape(4 ** n)


def op_vec(a: torch.Tensor, b: torch.Tensor, n: int) -> torch.Tensor:
    """Interleaved vec of the (generally non-Hermitian) operator |a><b|."""
    return _interleave(torch.outer(a, b.conj()), n)


def pure_dm_vec(psi: torch.Tensor, n: int) -> torch.Tensor:
    """|psi><psi| as an interleaved vec of length 4^n."""
    return op_vec(psi, psi, n)


def dm_vec_to_matrix(vec: torch.Tensor, n: int) -> torch.Tensor:
    """Inverse of the packing: interleaved vec -> rho[row, col]."""
    a, b = _split_qubits(n)
    t = _deinterleave_block(vec.reshape(4 ** a, 4 ** b, 1), b)
    t = _deinterleave_block(t.reshape(1, 4 ** a, 4 ** b), a)
    t = t.reshape(1 << a, 1 << a, 1 << b, 1 << b).permute(0, 2, 1, 3)
    return t.reshape(1 << n, 1 << n)


def diag_mask_dm(diag_sv: torch.Tensor, n: int) -> torch.Tensor:
    """mask[s] = D(row(s)) * conj(D(col(s))): the interleaved vec of
    D D^dag, the same products as the reference's bit gathers."""
    return op_vec(diag_sv, diag_sv, n)


_PAULI_DIGIT_WEIGHTS = np.array([
    [1, 0, 0, 1],        # I
    [0, 1, 1, 0],        # X: P[0,1] -> v=1, P[1,0] -> v=2
    [0, -1j, 1j, 0],     # Y
    [1, 0, 0, -1],       # Z
])


def pauli_weight_vector(codes, n: int, dtype=torch.complex64,
                        device=None) -> torch.Tensor:
    """w[s] = prod_q P_q[col_bit, row_bit], so Tr(P rho) = sum_s w[s]
    vec[s]; codes: n ints {0:I, 1:X, 2:Y, 3:Z}, qubit q's at codes[q]. The
    digit weights are 0, +-1 and +-i, so their products are exact in any
    order: built as the kron of the per-digit tables, digit n-1 the high
    factor."""
    tables = torch.as_tensor(_PAULI_DIGIT_WEIGHTS, dtype=dtype,
                             device=device)
    w = tables[int(codes[0])]
    for q in range(1, n):
        w = torch.kron(tables[int(codes[q])], w)
    return w


def trace_weight_vector(n: int, dtype=torch.complex64,
                        device=None) -> torch.Tensor:
    return pauli_weight_vector([0] * n, n, dtype=dtype, device=device)


# ---------------------------------------------------------------------------
# site-local superoperators


def unitary_site_op(u: torch.Tensor) -> torch.Tensor:
    """4x4 digit operator of rho -> U rho U^dag (digit = col<<1 | row)."""
    return torch.kron(u.conj(), u)


def depolarizing_site_op(p: float, dtype=torch.complex64,
                         device=None) -> torch.Tensor:
    """qiskit depolarizing_error(p, 1) as a 4x4 digit superoperator."""
    eye = np.eye(2)
    x = np.array([[0, 1], [1, 0]])
    y = np.array([[0, -1j], [1j, 0]])
    z = np.array([[1, 0], [0, -1]])
    m = (1 - 3 * p / 4) * np.kron(eye, eye)
    for pauli in (x, y, z):
        m = m + (p / 4) * np.kron(np.conj(pauli), pauli)
    return torch.as_tensor(m, dtype=dtype, device=device)


def _apply_digits(vec: torch.Tensor, mk: torch.Tensor, q: int,
                  k: int) -> torch.Tensor:
    """The (4^k x 4^k) ``mk`` on digits q .. q+k-1 of (..., 4^m)."""
    shape = vec.shape
    low = 1 << (2 * q)
    s = vec.reshape(*shape[:-1], shape[-1] >> (2 * (q + k)), 1 << (2 * k),
                    low)
    if low == 1:  # one product over rows of 4^k consecutive amplitudes
        return (s.reshape(-1, 1 << (2 * k)) @ mk.T).reshape(shape)
    return torch.matmul(mk, s).reshape(shape)


def apply_uniform_site_layer(vec: torch.Tensor, m4: torch.Tensor,
                             n_sites: int, group: int = 3) -> torch.Tensor:
    """Apply the same 4x4 op to digits 0..n_sites-1 of a base-4 vector
    (..., 4^m), in kron groups of ``group`` digits (3: 64 x 64). Digits
    from n_sites on (a literal ancilla) are untouched."""
    q = 0
    while q < n_sites:
        k = min(group, n_sites - q)
        mk = m4
        for _ in range(k - 1):
            mk = torch.kron(mk, m4)
        vec = _apply_digits(vec, mk, q, k)
        q += k
    return vec


def apply_site_op(vec: torch.Tensor, m4: torch.Tensor, q: int) -> torch.Tensor:
    """Apply a 4x4 op to digit q only."""
    return _apply_digits(vec, m4, q, 1)


def two_qubit_superop(u4: np.ndarray) -> np.ndarray:
    """16x16 digit-pair superoperator of a 4x4 unitary (qubit order hi=q1,
    lo=q2): index (digit_q1 << 2) | digit_q2, digit = col<<1 | row."""
    u4 = np.asarray(u4)
    uc = np.conj(u4)
    s = np.zeros((16, 16), dtype=complex)
    for rp in range(4):          # (r1', r2') output row bits
        for cp in range(4):      # (c1', c2') output col bits
            for r in range(4):
                for c in range(4):
                    val = u4[rp, r] * uc[cp, c]
                    if val == 0:
                        continue
                    out = ((((cp >> 1) << 1 | (rp >> 1)) << 2)
                           | ((cp & 1) << 1 | (rp & 1)))
                    inp = ((((c >> 1) << 1 | (r >> 1)) << 2)
                           | ((c & 1) << 1 | (r & 1)))
                    s[out, inp] += val
    return s


def apply_two_site_op(vec: torch.Tensor, m16: torch.Tensor, s1: int,
                      s2: int) -> torch.Tensor:
    """Apply a 16x16 digit-pair op to sites (s1, s2), s1 the high digit of
    the op's index."""
    if s1 == s2:
        raise ValueError("sites must differ")
    shape = vec.shape
    sa, sb = (s1, s2) if s1 > s2 else (s2, s1)
    s = vec.reshape(*shape[:-1], shape[-1] >> (2 * (sa + 1)), 4,
                    1 << (2 * (sa - 1 - sb)), 4, 1 << (2 * sb))
    m = m16.reshape(4, 4, 4, 4)  # [a1, a2, b1, b2], a1 the digit of s1
    if s1 > s2:
        s = torch.einsum("acbd,...xbmdz->...xamcz", m, s)
    else:
        s = torch.einsum("acbd,...xdmbz->...xcmaz", m, s)
    return s.reshape(shape)


# ---------------------------------------------------------------------------
# Floquet evolution on the vectorized density matrix


def _slot_op(ang, depol4, p, dtype, inverse=False):
    """The 4x4 digit op of one kick slot and its depolarizing channel."""
    make = slot_unitary_inverse if inverse else slot_unitary
    m = unitary_site_op(make(ang[0], ang[1], dtype).to(depol4.device))
    return depol4 @ m if p > 0.0 else m


def _dm_cycle(vec, angles, dmask, depol4, *, L, K, p, dtype, inverse=False):
    """One cycle: the K slots (kick, then the channel, on every digit),
    then the diagonal; ``inverse``: conj(diagonal), then the inverse slots
    in reverse order."""
    if inverse:
        vec = vec * dmask.conj()
        for k in range(K - 1, -1, -1):
            vec = apply_uniform_site_layer(
                vec, _slot_op(angles[k], depol4, p, dtype, inverse=True), L)
        return vec
    for k in range(K):
        vec = apply_uniform_site_layer(
            vec, _slot_op(angles[k], depol4, p, dtype), L)
    return vec * dmask


def _coherence_setup(psi0, diag_sv, *, L, p, q, ancilla_factor):
    """(af, B_0 = rho_0 Z_q, the diagonal mask, the channel, Z_q's
    weights) of the direct mode."""
    dtype, dev = psi0.dtype, psi0.device
    af = (1.0 - p) ** 6 if ancilla_factor is None else ancilla_factor
    zq = z_sign_mask(q, L, dtype=psi0.real.dtype, device=dev)
    b0 = op_vec(psi0, zq.to(dtype) * psi0, L)  # |psi><Z_q psi|
    dmask = diag_mask_dm(diag_sv.to(dev), L)
    depol4 = depolarizing_site_op(p, dtype=dtype, device=dev)
    wz = pauli_weight_vector([3 if i == q else 0 for i in range(L)], L,
                             dtype=dtype, device=dev)
    return af, b0, dmask, depol4, wz


def _weighted(w, vec):
    return (w * vec).sum(-1).real


def dm_autocorr_forward(psi0, angles, diag_sv, *, L, T, K, p, q,
                        ancilla_factor=None) -> torch.Tensor:
    """Exact noisy A(t), t = 0..T-1: B_0 = rho_0 Z_q evolves through the
    noisy cycle superoperator, A(t) = af Re Tr(Z_q B_t) at each cycle's
    start (af = (1-p)^6 by default: the ancilla's six u2 depolarizing
    events). The last cycle, never measured, is not run."""
    af, vec, dmask, depol4, wz = _coherence_setup(
        psi0, diag_sv, L=L, p=p, q=q, ancilla_factor=ancilla_factor)
    out = []
    for t in range(T):
        out.append(af * _weighted(wz, vec))
        if t < T - 1:
            vec = _dm_cycle(vec, angles[t], dmask, depol4, L=L, K=K, p=p,
                            dtype=psi0.dtype)
    return torch.stack(out)


def _dm_echoes(psi0, angles, diag_sv, ts, *, L, K, p, q, ancilla_factor):
    """Echo A0(t) of each t in ``ts``: the forward carry advances once
    through the cycles; each t's echo runs its t inverse cycles from the
    carry at t."""
    af, carry, dmask, depol4, wz = _coherence_setup(
        psi0, diag_sv, L=L, p=p, q=q, ancilla_factor=ancilla_factor)
    kw = dict(L=L, K=K, p=p, dtype=psi0.dtype)
    values = {}
    done = 0
    for t in sorted(set(int(t) for t in ts)):
        while done < t:
            carry = _dm_cycle(carry, angles[done], dmask, depol4, **kw)
            done += 1
        vec = carry
        for k in range(t - 1, -1, -1):
            vec = _dm_cycle(vec, angles[k], dmask, depol4, inverse=True,
                            **kw)
        values[t] = af * _weighted(wz, vec)
    return torch.stack([values[int(t)] for t in ts])


def dm_autocorr_echo(psi0, angles, diag_sv, t_value, *, L, T, K, p, q,
                     ancilla_factor=None) -> torch.Tensor:
    """Exact noisy echo A0(t): t forward cycles, then t inverse cycles in
    reverse time order. The reference's masked scan of 2T steps runs
    identities from step 2t on; the 2t active steps run here."""
    if not 0 <= int(t_value) <= T:
        raise ValueError(f"t_value={int(t_value)} outside [0, {T}]")
    return _dm_echoes(psi0, angles, diag_sv, [t_value], L=L, K=K, p=p, q=q,
                      ancilla_factor=ancilla_factor)[0]


def dm_energy(psi0, angles, diag_sv, weight_vec, *, L, T, K, p):
    """Exact noisy E(t) = Re sum(weight_vec * vec_t), t = 0..T-1."""
    dtype, dev = psi0.dtype, psi0.device
    vec = op_vec(psi0, psi0, L)
    dmask = diag_mask_dm(diag_sv.to(dev), L)
    depol4 = depolarizing_site_op(p, dtype=dtype, device=dev)
    out = []
    for t in range(T):
        out.append(_weighted(weight_vec, vec))
        if t < T - 1:
            vec = _dm_cycle(vec, angles[t], dmask, depol4, L=L, K=K, p=p,
                            dtype=dtype)
    return torch.stack(out)


def energy_weight_vector(terms, L: int, dtype=torch.complex64,
                         device=None) -> torch.Tensor:
    """Tr(H rho) weight vector of ``HamiltonianTerms``, summed in the
    reference's order."""
    hs = np.asarray(torch.as_tensor(terms.hs).cpu())
    phis = np.asarray(torch.as_tensor(terms.phis).cpu())
    xc = float(terms.x_coeff)
    kw = dict(dtype=dtype, device=device)
    w = torch.zeros(4 ** L, **kw)
    for i in range(L):
        if hs[i] != 0.0:
            w = w + float(hs[i]) * pauli_weight_vector(
                [3 if j == i else 0 for j in range(L)], L, **kw)
        if xc != 0.0:
            w = w + xc * pauli_weight_vector(
                [1 if j == i else 0 for j in range(L)], L, **kw)
    for i in range(L - 1):
        if phis[i] != 0.0:
            w = w + float(phis[i]) * pauli_weight_vector(
                [3 if j in (i, i + 1) else 0 for j in range(L)], L, **kw)
    return w


def dm_autocorr_interferometric(psi0, angles, diag_sv, t: int, *, L, K, p,
                                q=None, echo=False) -> float:
    """Literal Hadamard test on L+1 sites with the ancilla's depolarizing
    events, gate for gate as the transpiled reference circuit: h [depol];
    h [depol] cx h [depol]; the cycles (and with ``echo`` their inverses);
    h [depol] cx h [depol]; h [depol]; <Z_anc>. Validation mode."""
    dtype, dev = psi0.dtype, psi0.device
    n = L + 1
    anc = L
    qq = (L // 2) if q is None else q
    h = np.array([[1, 1], [1, -1]], dtype=complex) / np.sqrt(2)
    h_op = torch.as_tensor(np.kron(np.conj(h), h), dtype=dtype, device=dev)
    depol4 = depolarizing_site_op(p, dtype=dtype, device=dev)
    cx = np.zeros((4, 4), dtype=complex)  # control hi (system q), target lo
    for b in range(4):
        hi, lo = (b >> 1) & 1, b & 1
        cx[(hi << 1) | (lo ^ hi), b] = 1
    cx_super = torch.as_tensor(two_qubit_superop(cx), dtype=dtype, device=dev)

    psi_full = torch.zeros(1 << n, dtype=dtype, device=dev)
    psi_full[: 1 << L] = psi0
    vec = op_vec(psi_full, psi_full, n)
    diag_sv = diag_sv.to(dev)
    dmask = diag_mask_dm(torch.cat([diag_sv, diag_sv]), n)  # no ancilla phase
    kw = dict(L=L, K=K, p=p, dtype=dtype)

    def hd(v):
        v = apply_site_op(v, h_op, anc)
        if p > 0.0:
            v = apply_site_op(v, depol4, anc)
        return v

    vec = hd(hd(vec))
    vec = hd(apply_two_site_op(vec, cx_super, qq, anc))
    for step in range(t):
        vec = _dm_cycle(vec, angles[step], dmask, depol4, **kw)
    if echo:
        for step in range(t - 1, -1, -1):
            vec = _dm_cycle(vec, angles[step], dmask, depol4, inverse=True,
                            **kw)
    vec = hd(vec)
    vec = hd(apply_two_site_op(vec, cx_super, qq, anc))
    vec = hd(vec)
    wz = pauli_weight_vector([3 if i == anc else 0 for i in range(n)], n,
                             dtype=dtype, device=dev)
    return float(_weighted(wz, vec))


def _run_inputs(hs, phis, L, initial_state, dtype_name):
    dtype = DTYPES[dtype_name]
    hs = torch.as_tensor(hs)
    psi0 = initial_statevector(L, initial_state, dtype=dtype,
                               device=hs.device)
    return psi0, zz_z_phase_mask(hs, torch.as_tensor(phis, device=hs.device),
                                 L, dtype=dtype)


def dm_autocorr_forward_run(hs, phis, angles, *, L, T, K, p, q,
                            initial_state="vacuum", dtype_name="complex64",
                            ancilla_factor=None) -> torch.Tensor:
    """Exact noisy A(t) (T,) of one instance from (hs, phis), on hs's
    device: the exact mode of the autocorr experiment."""
    psi0, diag_sv = _run_inputs(hs, phis, L, initial_state, dtype_name)
    return dm_autocorr_forward(psi0, angles.to(psi0.device), diag_sv, L=L,
                               T=T, K=K, p=p, q=q,
                               ancilla_factor=ancilla_factor)


def dm_autocorr_echo_run(hs, phis, angles, ts, *, L, T, K, p, q,
                         initial_state="vacuum", dtype_name="complex64",
                         ancilla_factor=None) -> torch.Tensor:
    """Exact noisy echo A0(t) for each t of ``ts`` (len(ts),), on hs's
    device."""
    psi0, diag_sv = _run_inputs(hs, phis, L, initial_state, dtype_name)
    ts = [int(t) for t in ts]
    if any(not 0 <= t <= T for t in ts):
        raise ValueError(f"echo times {ts} outside [0, {T}]")
    return _dm_echoes(psi0, angles.to(psi0.device), diag_sv, ts, L=L, K=K,
                      p=p, q=q, ancilla_factor=ancilla_factor)
