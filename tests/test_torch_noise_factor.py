"""The planar engine's noise factor (K11): its plain version and tile packer
against the JAX reference on the CPU.

``pack_cycle_params`` must give the reference's (8, 128) tile bit for bit;
``noise_factor_plain`` must match ``apply_noise_factor(interpret=True)`` on
the same random normalised states and random tiles within 1e-6 (f32 angle
sums of at most 2L terms, then one sincos; observed at most 3.0e-8). The
kernel itself is held against this plain version on the card by
``test_torch_kernels_cuda.py`` and ``chip_smoke.py``.

The kernel does not sum an angle per amplitude: it splits the factor at
qubit a = min(kLoBits, L) into a table of the low qubits' unit phases
(their z terms, bonds and sign bits, and the bond to qubit a, indexed by
bits [0, a]) and one unit phase per row of 2^a amplitudes (qubits [a, L)),
each entry's angle summed in double and reduced to [-pi, pi] before one f32
sincos, and multiplies the two. ``_mirror`` repeats that arithmetic in
numpy, reading kLoBits from ``csrc/noise_factor.cu``; it is held to the
same function in float64 (1e-6, at every split a <= L, the straddling bond
included, and at the kernel's own, which is the whole chain where L <
kLoBits), to ``noise_factor_plain`` (1e-5: the plain version sums the
angle in f32, up to about 2L pi) and to JAX's interpret kernel at L=8
(1e-5), on random unit states, L = 1..12.
"""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dtc_tpu.ops.pallas_noise import apply_noise_factor as j_apply
from dtc_tpu.ops.pallas_noise import pack_cycle_params as j_pack
from dtc_tpu_torch.ops import noise_factor as nf
from dtc_tpu_torch.utils import profiling

torch.set_num_threads(2)


def _case(L, B, seed):
    rng = np.random.default_rng(seed)
    zm = rng.integers(0, 1 << L, size=B)
    sig = rng.integers(0, 1 << L, size=B)
    hs = rng.uniform(-np.pi, np.pi, size=(B, L))
    phis = rng.uniform(-np.pi, np.pi, size=(B, L - 1))
    st = rng.normal(size=(B, 2, 1 << L)).astype(np.float32)
    st /= np.sqrt((st ** 2).sum(axis=(1, 2), keepdims=True))
    return zm, sig, hs, phis, st


@pytest.mark.parametrize("L", [4, 8, 10])
def test_pack_cycle_params_bit_identical(L):
    zm, sig, hs, phis, _ = _case(L, 5, L)
    got = nf.pack_cycle_params(torch.as_tensor(zm), torch.as_tensor(sig),
                               torch.as_tensor(hs), torch.as_tensor(phis), L)
    assert got.shape == (5, 8, 128) and got.dtype == torch.float32
    for b in range(5):
        ref = np.asarray(j_pack(jnp.uint32(zm[b]), jnp.uint32(sig[b]),
                                jnp.asarray(hs[b]), jnp.asarray(phis[b]), L))
        np.testing.assert_array_equal(got[b].numpy(), ref)


@pytest.mark.parametrize("L", [4, 8, 10])
def test_plain_matches_reference_interpret(L):
    """L=4 takes the reference's N < 128 branch (one (2, 1, 16) block)."""
    B = 3
    zm, sig, hs, phis, st = _case(L, B, 100 + L)
    params = nf.pack_cycle_params(torch.as_tensor(zm), torch.as_tensor(sig),
                                  torch.as_tensor(hs),
                                  torch.as_tensor(phis), L)
    profiling.reset_counters()
    got = nf.apply_noise_factor(torch.from_numpy(st.copy()), params, L=L)
    # CPU tensors: the plain version
    assert profiling.LAUNCHES["dtc.entry.K11"] == 0
    for b in range(B):
        ref = np.asarray(j_apply(jnp.asarray(st[b]),
                                 jnp.asarray(params[b].numpy()), L=L,
                                 interpret=True))
        np.testing.assert_allclose(got[b].numpy(), ref, atol=1e-6, rtol=0)
    # a unit factor: norms are kept
    np.testing.assert_allclose((got ** 2).sum(dim=(1, 2)).numpy(), 1.0,
                               atol=1e-5)


def test_zero_tile_is_the_identity_and_sign_is_the_parity():
    L = 5
    st = torch.randn(2, 2, 1 << L)
    zero = torch.zeros(2, 8, 128)
    torch.testing.assert_close(nf.noise_factor_plain(st, zero, L=L), st)
    zm = torch.tensor([0b10110, 0])
    par = nf.pack_cycle_params(zm, torch.zeros(2, dtype=torch.int64),
                               torch.zeros(2, L), torch.zeros(2, L - 1), L)
    s = torch.arange(1 << L)
    parity = torch.tensor([bin(int(v) & 0b10110).count("1") & 1 for v in s])
    want = st.clone()
    want[0] *= (1 - 2 * parity).to(torch.float32)
    torch.testing.assert_close(nf.noise_factor_plain(st, par, L=L), want)


@pytest.mark.parametrize("shape,pshape", [((2, 2, 16), (2, 8, 128)),
                                          ((2, 3, 32), (2, 8, 128)),
                                          ((2, 2, 32), (1, 8, 128)),
                                          ((2, 2, 32), (2, 8, 64))])
def test_bad_shapes_raise(shape, pshape):
    with pytest.raises(ValueError):
        nf.apply_noise_factor(torch.zeros(shape), torch.zeros(pshape), L=5)


# --- K11's table arithmetic (csrc/noise_factor.cu), mirrored in numpy

CSRC = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                    "dtc_tpu_torch", "csrc")


def _lo_bits() -> int:
    with open(os.path.join(CSRC, "noise_factor.cu")) as f:
        m = re.search(r"constexpr int kLoBits = (\d+);", f.read())
    assert m, "kLoBits not found in noise_factor.cu"
    return int(m.group(1))


def _coeffs(par, L):
    """The kernel's f32 per-qubit products and Z mask of one (8, 128) tile."""
    cz = par[1, :32] * par[3, :32]
    cb = par[2, :32] * par[4, :32]
    zm = sum(1 << q for q in range(L) if par[0, q] != 0)
    return cz, cb, zm


def _unit_phase(cz, cb, zm, s, q0, q1, nxt):
    """``unit_phase`` of the kernel on indices s: (-1)^popcount of qubits
    [q0, q1) in zm times exp(i angle), the angle (their z terms, the bonds
    among them, with ``nxt`` the bond (q1 - 1, q1)) summed in float64,
    reduced to [-pi, pi], rounded to f32 before the f32 cos and sin."""
    ang = np.zeros(s.shape)
    zp = 0.0
    for q in range(q0, q1 + 1 if nxt else q1):
        z = 1.0 - 2.0 * ((s >> q) & 1)
        if q < q1:
            ang += float(cz[q]) * z
        if q > q0:
            ang += float(cb[q - 1]) * zp * z
        zp = z
    ang -= 2 * np.pi * np.rint(ang / (2 * np.pi))
    a32 = ang.astype(np.float32)
    bits = ((1 << q1) - (1 << q0)) & zm
    par = np.array([bin(int(v) & bits).count("1") & 1 for v in s])
    sign = (1 - 2 * par).astype(np.float32)
    return sign * np.cos(a32), sign * np.sin(a32)


def _mirror(state, params, L, a=None):
    """K11 on (B, 2, 2^L) f32 planes as the kernel computes it, split at a
    (default the kernel's, min(kLoBits, L)): the lower table of 2^(a+1)
    entries (2^a where a = L) indexed by the amplitude's bits [0, a], the
    row phases of qubits [a, L), one complex product of the two, then the
    state multiply, all in f32."""
    a = min(_lo_bits(), L) if a is None else a
    N = 1 << L
    i = np.arange(N)
    out = np.empty_like(state)
    for b in range(state.shape[0]):
        cz, cb, zm = _coeffs(params[b], L)
        n_lo = 2 << a if a < L else 1 << a
        lr, li = _unit_phase(cz, cb, zm, np.arange(n_lo), 0, a, a < L)
        hr, hi = _unit_phase(cz, cb, zm, np.arange(N >> a) << a, a, L, False)
        lr, li = lr[i & (n_lo - 1)], li[i & (n_lo - 1)]
        hr, hi = hr[i >> a], hi[i >> a]
        fr, fi = lr * hr - li * hi, lr * hi + li * hr
        re, im = state[b, 0], state[b, 1]
        out[b, 0] = re * fr - im * fi
        out[b, 1] = re * fi + im * fr
    return out


def _exact(state, params, L):
    """The factor in float64 from the same f32 tile."""
    s = np.arange(1 << L)
    out = np.empty(state.shape)
    for b in range(state.shape[0]):
        par = params[b].astype(np.float64)
        ang = np.zeros(s.shape)
        par_z = np.zeros(s.shape, np.int64)
        for q in range(L):
            z = 1.0 - 2.0 * ((s >> q) & 1)
            par_z ^= ((s >> q) & 1) * int(par[0, q] != 0)
            ang += par[1, q] * par[3, q] * z
            if q:
                ang += par[2, q - 1] * par[4, q - 1] * (1.0 - 2.0 * (
                    (s >> (q - 1)) & 1)) * z
        f = (1 - 2 * par_z) * np.exp(1j * ang)
        psi = (state[b, 0] + 1j * state[b, 1]) * f
        out[b, 0], out[b, 1] = psi.real, psi.imag
    return out


def _tables_case(L, seed):
    zm, sig, hs, phis, st = _case(L, 3, seed)
    params = nf.pack_cycle_params(torch.as_tensor(zm), torch.as_tensor(sig),
                                  torch.as_tensor(hs),
                                  torch.as_tensor(phis), L)
    return st, params.numpy()


@pytest.mark.parametrize("L", range(1, 13))
def test_table_mirror_matches_float64(L):
    """Every split a <= L (the bond across it taken once, from the lower
    table's bit a), and the kernel's own."""
    st, params = _tables_case(L, 200 + L)
    want = _exact(st, params, L)
    assert min(_lo_bits(), L) in range(1, L + 1)
    for a in range(1, L + 1):
        got = _mirror(st, params, L, a)
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0, err_msg=a)


@pytest.mark.parametrize("L", range(1, 13))
def test_table_mirror_matches_plain(L):
    st, params = _tables_case(L, 300 + L)
    got = _mirror(st, params, L)
    want = nf.noise_factor_plain(torch.from_numpy(st), torch.from_numpy(
        params), L=L).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_table_mirror_matches_reference_interpret():
    L = 8
    st, params = _tables_case(L, 408)
    got = _mirror(st, params, L)
    for b in range(st.shape[0]):
        ref = np.asarray(j_apply(jnp.asarray(st[b]), jnp.asarray(params[b]),
                                 L=L, interpret=True))
        np.testing.assert_allclose(got[b], ref, atol=1e-5, rtol=0)
