"""The planar engine's noise factor (K11): its plain version and tile packer
against the JAX reference on the CPU.

``pack_cycle_params`` must give the reference's (8, 128) tile bit for bit;
``noise_factor_plain`` must match ``apply_noise_factor(interpret=True)`` on
the same random normalised states and random tiles within 1e-6 (f32 angle
sums of at most 2L terms, then one sincos; observed at most 3.0e-8). The
kernel itself is held against this plain version on the card by
``test_torch_kernels_cuda.py`` and ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dtc_tpu.ops.pallas_noise import apply_noise_factor as j_apply
from dtc_tpu.ops.pallas_noise import pack_cycle_params as j_pack
from dtc_tpu_torch.ops import noise_factor as nf

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
    nf.reset_counters()
    got = nf.apply_noise_factor(torch.from_numpy(st.copy()), params, L=L)
    assert nf.LAUNCHES["noise_factor"] == 0  # CPU tensors: plain version
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
