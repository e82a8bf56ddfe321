"""Plain statevector trajectories of the noisy kicked-Ising Floquet cycle.

The benchmark's reference: it imports nothing of the program, and works out
from the same disorder and uniforms everything the program derives. One
cycle, in the lab frame, is the drive's K kick slots, each RY(ty) RX(tx) on
every qubit and each followed by one depolarizing event on every qubit, then
the diagonal D0(s) = exp(-i E(s) / 2),
E(s) = sum_q h_q z_q(s) + sum_q phi_q z_q(s) z_{q+1}(s), z_q = 1 - 2 bit_q(s).
An event turns a uniform u into a Pauli (I, X, Y, Z) with probabilities
(1 - 3p/4, p/4, p/4, p/4); the reference's f32 thresholds are kept, so that
the same uniform gives the same Pauli. The inverse cycle is conj(D0), then
the inverse slots in reverse order, each followed by its event.

The states of a batch are one complex64 tensor (B, 2^L), the batch holding
every instance's trajectories, instance-major. Every kick and Pauli acts on
single qubits, so a cycle's kicks and events are, on each block of up to 5
qubits, one 32 x 32 matrix per trajectory: the product, built in complex128
and rounded to complex64, is applied with one batched matrix product a
block, top block first. Each product leaves its block's qubits at the
bottom of the index, so that after every block of a cycle the index is in
its natural order again, and no product needs a copy of the state. The
control (``real`` bfloat16) rounds the matrices, the diagonal and the state
after every product to bfloat16, as bfloat16 products with float32 sums
would. Probabilities are formed in float32 and summed in float64;
sum_q <X_q> is sum_q <Z_q> of H^L psi. Matrix products run with TF32 off.

Observables: A(t) = af * s0 * <Z_q(t)> (s0 = the initial state's z_q, af the
ancilla factor (1 - p)^6) and its echo A0(t) (t forward cycles, then t
inverse cycles on the echo block's rows t..2t-1); E(t) = <H> with
H = sum h_q Z_q + sum phi_q Z_q Z_{q+1} + g pi sum X_q, and every <Z_q(t)>.
Each is measured at t = 0..T-1 with a cycle between two measurements.
"""

from __future__ import annotations

import math

import numpy as np
import torch

BLOCK = 5  # qubits per kick block


def schedule(polarization: str, g: float, T: int) -> np.ndarray:
    """(T, K, 2) kick angles (theta_x, theta_y) of a constant drive."""
    a = math.pi * g
    slots = {"x": [(a, 0.0)], "y": [(0.0, a)],
             "xy": [(a / 2, 0.0), (0.0, a / 2)],
             "yx": [(0.0, a / 2), (a / 2, 0.0)]}
    if polarization not in slots:
        raise ValueError(f"the reference drives x, y, xy and yx, not "
                         f"{polarization!r}")
    return np.broadcast_to(np.array(slots[polarization]),
                           (T, len(slots[polarization]), 2)).copy()


def slot_unitary(theta_x: float, theta_y: float) -> np.ndarray:
    """RY(theta_y) @ RX(theta_x), complex128 (2, 2)."""
    cx, sx = math.cos(theta_x / 2), math.sin(theta_x / 2)
    cy, sy = math.cos(theta_y / 2), math.sin(theta_y / 2)
    rx = np.array([[cx, -1j * sx], [-1j * sx, cx]])
    ry = np.array([[cy, -sy], [sy, cy]], dtype=complex)
    return ry @ rx


def pauli_codes(u: torch.Tensor, p: float) -> torch.Tensor:
    """f32 uniforms -> codes 0 (I), 1 (X), 2 (Y), 3 (Z), int64. The
    threshold 1 - 3p/4 and the width p/4 are f32 numbers."""
    q = 0.25 * p
    thr = torch.tensor(1.0 - 3.0 * q, dtype=torch.float32, device=u.device)
    width = torch.full_like(u, max(q, 1e-30))
    code = 1 + torch.floor((u - thr) / width).to(torch.int64)
    return torch.where(u >= thr, code, 0).clamp(0, 3)


def blocks(L: int) -> list[tuple[int, int]]:
    """(first qubit, qubits) of each kick block, the top block first."""
    return [(q0, min(BLOCK, L - q0)) for q0 in range(0, L, BLOCK)][::-1]


def _masks(codes: torch.Tensor, q0: int, k: int):
    """(..., L) codes -> X and Z masks over qubits q0..q0+k-1, int64."""
    w = 1 << torch.arange(k, device=codes.device)
    c = codes[..., q0:q0 + k]
    xm = torch.where((c == 1) | (c == 2), w, 0).sum(-1)
    zm = torch.where(c >= 2, w, 0).sum(-1)
    return xm, zm


def _parity(v: torch.Tensor) -> torch.Tensor:
    par = torch.zeros_like(v)
    for i in range(BLOCK):
        par ^= (v >> i) & 1
    return par


def _block_matrices(codes, unitaries, L: int):
    """Per block, the (B, 2^k, 2^k) complex128 product over the slots of
    (Pauli of the slot's event) @ (slot unitary on every qubit), later slots
    on the left. codes (B, S, L) for the S slots of ``unitaries``; None:
    no noise."""
    dev = unitaries[0].device
    out = []
    for q0, k in blocks(L):
        x = torch.arange(1 << k, device=dev)
        m = None
        for s, u in enumerate(unitaries):
            uk = u
            for _ in range(k - 1):
                uk = torch.kron(uk, u)
            if codes is None:
                pu = uk.expand(1, -1, -1)
            else:
                xm, zm = _masks(codes[:, s], q0, k)            # (B,)
                src = x[None, :] ^ xm[:, None]                 # (B, 2^k)
                sign = 1 - 2 * _parity(src & zm[:, None])      # Z, then X
                pu = sign[:, :, None] * uk[src]
            m = pu if m is None else pu @ m
        out.append(m)
    return out


def apply_blocks(state: torch.Tensor, mats, L: int, rnd=None):
    """Each block's matrix (B or 1, 2^k, 2^k) on its qubits of (B, 2^L),
    top block first: the block's qubits are the top k bits of the index,
    and the product leaves them at the bottom. ``rnd`` rounds each
    product's result (the control)."""
    B = state.shape[0]
    for (_, k), m in zip(blocks(L), mats):
        v = state.view(B, 1 << k, -1).transpose(1, 2)
        state = torch.matmul(v, m.transpose(1, 2)).reshape(B, -1)
        if rnd is not None:
            state = rnd(state)
    return state


def z_signs(L: int, device) -> torch.Tensor:
    """(2^L, L) float64 z_q(s)."""
    s = torch.arange(1 << L, device=device)
    return (1 - 2 * ((s[:, None] >> torch.arange(L, device=device)) & 1)
            ).double()


def diag_energy(hs, phis, L: int, device) -> torch.Tensor:
    """E(s) of each instance, float64 (I, 2^L)."""
    z = z_signs(L, device)
    h = torch.as_tensor(np.asarray(hs, dtype=np.float64), device=device)
    ph = torch.as_tensor(np.asarray(phis, dtype=np.float64), device=device)
    return h @ z.T + ph @ (z[:, :-1] * z[:, 1:]).T


HADAMARD = np.array([[1.0, 1.0], [1.0, -1.0]]) / math.sqrt(2.0)


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """A complex64 tensor with its parts rounded to bfloat16."""
    return torch.view_as_complex(
        torch.view_as_real(x).to(torch.bfloat16).float().contiguous())


class Chain:
    """The disorder instances hs (I, L), phis (I, L-1) of the chain, evolved
    on ``device`` in complex64, or with every value rounded to bfloat16
    where ``real`` is bfloat16 (the control). A batch (B, 2^L) holds B / I
    trajectories of each instance, instance-major."""

    def __init__(self, hs, phis, *, L, polarization, g, T, real, device):
        self.L, self.T, self.g, self.real, self.dev = L, T, g, real, device
        self.rnd = _bf16 if real == torch.bfloat16 else None
        self.angles = schedule(polarization, g, T)
        self.K = self.angles.shape[1]
        self.I = len(hs)
        hs = np.asarray(hs)[:, :L]
        phis = np.asarray(phis)[:, :L - 1]
        self.energy = diag_energy(hs, phis, L, device)           # (I, N)
        self.d0 = self._low(torch.exp(-0.5j * self.energy))[:, None]
        self.zs = z_signs(L, device)
        self._u: dict = {}
        h = torch.as_tensor(HADAMARD, dtype=torch.complex128, device=device)
        self.hadamard = self._mats(_block_matrices(None, [h], L))

    def _low(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(torch.complex64)
        return x if self.rnd is None else self.rnd(x)

    def _mats(self, mats):
        return [self._low(m) for m in mats]

    def _unitaries(self, t: int, inverse: bool):
        key = (tuple(self.angles[t].ravel()), inverse)
        if key not in self._u:
            us = [slot_unitary(*self.angles[t, k]) for k in range(self.K)]
            if inverse:
                us = [u.conj().T for u in reversed(us)]
            self._u[key] = [torch.as_tensor(u, device=self.dev) for u in us]
        return self._u[key]

    def _diag(self, state, conj: bool):
        """D0 (conj(D0)) of each state's instance."""
        d = self.d0.conj() if conj else self.d0
        out = (state.view(self.I, -1, 1 << self.L) * d).view_as(state)
        return out if self.rnd is None else self.rnd(out)

    def initial(self, per_instance: int, b0: int) -> torch.Tensor:
        st = torch.zeros((self.I * per_instance, 1 << self.L),
                         dtype=torch.complex64, device=self.dev)
        st[:, b0] = 1.0
        return st

    def forward(self, state, t: int, codes):
        """Cycle t; codes (B, K, L) of its events or None."""
        mats = _block_matrices(codes, self._unitaries(t, False), self.L)
        state = apply_blocks(state, self._mats(mats), self.L, self.rnd)
        return self._diag(state, conj=False)

    def inverse(self, state, t: int, codes):
        """The inverse of cycle t; codes (B, K, L): the j-th event follows
        the j-th inverse slot applied (slot K-1-j)."""
        state = self._diag(state, conj=True)
        mats = _block_matrices(codes, self._unitaries(t, True), self.L)
        return apply_blocks(state, self._mats(mats), self.L, self.rnd)

    def probs(self, state) -> torch.Tensor:
        """(B, 2^L) float32 |psi|^2."""
        return state.real ** 2 + state.imag ** 2

    def z(self, state, q: int) -> torch.Tensor:
        """(I, B / I) <Z_q>, float64."""
        B, L = state.shape[0], self.L
        p = self.probs(state).view(B, 1 << (L - q - 1), 2, 1 << q)
        half = p.sum((1, 3), dtype=torch.float64)
        return (half[:, 0] - half[:, 1]).view(self.I, -1)

    def energy_and_z(self, state):
        """(I, B / I) <H> and (I, B / I, L) <Z_q>, float64."""
        p = self.probs(state).double()
        zs = (p @ self.zs).view(self.I, -1, self.L)
        e = (p.view(self.I, -1, 1 << self.L)
             @ self.energy[:, :, None])[..., 0]
        xs = self.probs(apply_blocks(state, self.hadamard, self.L,
                                      self.rnd)).double()
        x_sum = (xs @ self.zs).sum(-1).view(self.I, -1)
        return e + math.pi * self.g * x_sum, zs


def _codes(u, p):
    """(I, n, S, L) uniforms -> (I, n, S, L) codes, or None: no noise."""
    return None if u is None or p <= 0.0 else pauli_codes(u, p)


class _Batches:
    """The trajectories of every instance in batches of ``batch`` states;
    ``rows(r)``: the codes of the current batch's event row r, (B, K, L)."""

    def __init__(self, codes, n: int, I: int, K: int, batch: int):
        self.codes, self.K = codes, K
        self.per = max(1, min(n, batch // I))
        self.spans = [(i, min(i + self.per, n)) for i in range(0, n, self.per)]

    def __iter__(self):
        for i0, i1 in self.spans:
            self.cur = (i0, i1)
            yield i1 - i0

    def rows(self, r: int):
        if self.codes is None:
            return None
        i0, i1 = self.cur
        c = self.codes[:, i0:i1, r * self.K:(r + 1) * self.K]
        return c.reshape(-1, *c.shape[2:])


def _setup():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def forward_autocorr(chain: Chain, u, *, p, q, b0, af, batch=128):
    """A(t), t < T, of each instance, averaged over the trajectories of
    ``u`` (I, n, T*K, L) f32; numpy (I, T)."""
    _setup()
    T, n = chain.T, u.shape[1]
    s0 = 1 - 2 * ((b0 >> q) & 1)
    batches = _Batches(_codes(u, p), n, chain.I, chain.K, batch)
    acc = torch.zeros((chain.I, T), dtype=torch.float64, device=chain.dev)
    for c in batches:
        st = chain.initial(c, b0)
        for t in range(T):
            acc[:, t] += chain.z(st, q).sum(1)
            if t < T - 1:
                st = chain.forward(st, t, batches.rows(t))
    return (af * s0 * acc / n).cpu().numpy()


def echo_autocorr(chain: Chain, u, ts, *, p, q, b0, af, batch=128):
    """A0(t) of each instance at the t of ``ts``, averaged over the
    trajectories of ``u`` (I, n, 2T*K, L): t forward cycles on rows
    0..t-1, then t inverse cycles on rows t..2t-1, the forward prefix
    shared; numpy (I, T), NaN at every other t."""
    _setup()
    T, n = chain.T, u.shape[1]
    ts = sorted(set(int(t) for t in ts))
    s0 = 1 - 2 * ((b0 >> q) & 1)
    batches = _Batches(_codes(u, p), n, chain.I, chain.K, batch)
    acc = torch.full((chain.I, T), float("nan"), dtype=torch.float64,
                     device=chain.dev)
    acc[:, ts] = 0.0
    for c in batches:
        fwd = chain.initial(c, b0)
        for t in range(ts[-1] + 1):
            if t:
                fwd = chain.forward(fwd, t - 1, batches.rows(t - 1))
            if t in ts:
                st = fwd
                for j in range(t):
                    st = chain.inverse(st, t - 1 - j, batches.rows(t + j))
                acc[:, t] += chain.z(st, q).sum(1)
    return (af * s0 * acc / n).cpu().numpy()


def energy_trace(chain: Chain, u, *, p, b0, batch=128):
    """(E(t), <Z_q(t)>) of each instance averaged over the trajectories of
    ``u`` (I, n, T*K, L), or over one noiseless trajectory where p == 0;
    numpy (I, T), (I, T, L)."""
    _setup()
    T, L = chain.T, chain.L
    n = 1 if p <= 0.0 else u.shape[1]
    batches = _Batches(_codes(u, p), n, chain.I, chain.K, batch)
    acc_e = torch.zeros((chain.I, T), dtype=torch.float64, device=chain.dev)
    acc_z = torch.zeros((chain.I, T, L), dtype=torch.float64,
                        device=chain.dev)
    for c in batches:
        st = chain.initial(c, b0)
        for t in range(T):
            e, zs = chain.energy_and_z(st)
            acc_e[:, t] += e.sum(1)
            acc_z[:, t] += zs.sum(1)
            if t < T - 1:
                st = chain.forward(st, t, batches.rows(t))
    return (acc_e / n).cpu().numpy(), (acc_z / n).cpu().numpy()
