"""``floquet.Chain`` for chains whose 2^L x L tables do not fit a card.

``floquet.Chain`` builds z_q(s) as a (2^L, L) float64 table, twice, and
E(s) as its product with the couplings: 60 GB each at L=28. This chain
gives the same numbers without any table over 2^L x L: E(s) is summed qubit
by qubit in float64, over blocks of at most ``block`` indices, and D0(s) is
formed from each block of E as ``floquet.Chain`` forms it from the whole.
The kick schedule, the f32 Pauli thresholds, the block products, the
bfloat16 control and TF32 off are ``floquet.py``'s own, unchanged. At
L <= 16 E agrees with ``floquet.Chain``'s to the last bits of its sums
(1e-12), and D0, A(t) and A0(t) are the same numbers.

What it holds at L=28, one instance and one trajectory a batch (a
complex64 state is 2 GiB): E (float64) 2 GiB and D0 (complex64) 2 GiB for
the whole run; the forward state 2 GiB; in the echo, the echo state 2 GiB
beside it. An inverse cycle holds its diagonal's output and, while a block
product runs, its input and its output: 2 GiB each, so the echo's peak is
five states and E and D0, 14 GiB. Forming E and D0 takes about 1 GiB
beside them for a block of 2^24 indices; measuring <Z_q> takes |psi|^2 in
float32 (1 GiB) and its float64 copy (2 GiB).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from port_bench.reference import floquet

BLOCK_INDICES = 1 << 24  # indices s a block of E(s) and D0(s) covers


def z_sign(s: torch.Tensor, q: int) -> torch.Tensor:
    """float64 z_q(s) = 1 - 2 bit_q(s) of the indices ``s``."""
    return (1 - 2 * ((s >> q) & 1)).double()


def diag_energy(hs, phis, L: int, device, block: int = BLOCK_INDICES):
    """E(s) of each instance, float64 (I, 2^L), as ``floquet.diag_energy``
    gives it: sum_q h_q z_q(s) + sum_q phi_q z_q(s) z_{q+1}(s), summed qubit
    by qubit over blocks of ``block`` indices."""
    h = torch.as_tensor(np.asarray(hs, dtype=np.float64), device=device)
    ph = torch.as_tensor(np.asarray(phis, dtype=np.float64), device=device)
    n = 1 << L
    out = torch.empty((h.shape[0], n), dtype=torch.float64, device=device)
    for s0 in range(0, n, block):
        s = torch.arange(s0, min(s0 + block, n), device=device)
        z = z_sign(s, 0)
        field = h[:, :1] * z
        bond = torch.zeros_like(field)
        for q in range(1, L):
            z_next = z_sign(s, q)
            field += h[:, q:q + 1] * z_next
            bond += ph[:, q - 1:q] * (z * z_next)
            z = z_next
        out[:, s0:s0 + s.numel()] = field + bond
    return out


class Chain(floquet.Chain):
    """``floquet.Chain`` with E and D0 built in blocks of ``block`` indices
    and no z_q(s) table: the same instances, batches and answers."""

    def __init__(self, hs, phis, *, L, polarization, g, T, real, device,
                 block: int = BLOCK_INDICES):
        self.L, self.T, self.g, self.real, self.dev = L, T, g, real, device
        self.rnd = floquet._bf16 if real == torch.bfloat16 else None
        self.angles = floquet.schedule(polarization, g, T)
        self.K = self.angles.shape[1]
        self.I = len(hs)
        hs = np.asarray(hs)[:, :L]
        phis = np.asarray(phis)[:, :L - 1]
        self.energy = diag_energy(hs, phis, L, device, block)   # (I, N)
        d0 = torch.empty(self.energy.shape, dtype=torch.complex64,
                         device=device)
        for s0 in range(0, d0.shape[1], block):
            d0[:, s0:s0 + block] = self._low(
                torch.exp(-0.5j * self.energy[:, s0:s0 + block]))
        self.d0 = d0[:, None]
        self.zs = None  # no (2^L, L) table: see energy_and_z
        self._u: dict = {}
        h = torch.as_tensor(floquet.HADAMARD, dtype=torch.complex128,
                            device=device)
        self.hadamard = self._mats(floquet._block_matrices(None, [h], L))

    def _z_all(self, p: torch.Tensor) -> torch.Tensor:
        """(B, L) sum_s p(s) z_q(s) of float64 probabilities (B, 2^L)."""
        B, L = p.shape[0], self.L
        zs = []
        for q in range(L):
            half = p.view(B, 1 << (L - q - 1), 2, 1 << q).sum((1, 3))
            zs.append(half[:, 0] - half[:, 1])
        return torch.stack(zs, -1)

    def energy_and_z(self, state):
        """(I, B / I) <H> and (I, B / I, L) <Z_q>, float64, qubit by
        qubit."""
        p = self.probs(state).double()
        zs = self._z_all(p).view(self.I, -1, self.L)
        e = (p.view(self.I, -1, 1 << self.L)
             @ self.energy[:, :, None])[..., 0]
        xs = self.probs(floquet.apply_blocks(state, self.hadamard, self.L,
                                             self.rnd)).double()
        x_sum = self._z_all(xs).sum(-1).view(self.I, -1)
        return e + math.pi * self.g * x_sum, zs
