"""Port's small ops and kernel feeders against the JAX reference (CPU).

Drives, initial states, diagonal masks and kron powers must agree with the
reference to f64 rounding; the blocked kernels' feeders (compact rows, echo
step rows) must be bit-identical for the same uniforms, and the kick
matrices agree to 1e-7.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dtc_tpu.core.statevector import initial_statevector as j_init
from dtc_tpu.core.statevector import neel_index as j_neel
from dtc_tpu.core.sigma_evolve import presample_noise as j_presample
from dtc_tpu.models.drives import build_kick_schedule as j_sched
from dtc_tpu.models.drives import slot_unitary as j_su
from dtc_tpu.models.drives import slot_unitary_inverse as j_sui
from dtc_tpu.ops.diag import z_sign_mask as j_zsign
from dtc_tpu.ops.diag import zz_z_phase_mask as j_mask
from dtc_tpu.ops.kick import kron_power as j_kron_power
from dtc_tpu.ops.pallas_noise import pack_cycle_params_compact as j_pack
from dtc_tpu.ops.pallas_resident import _kick_matrices as j_kick
from dtc_tpu.ops.pallas_resident import echo_pair_tiles as j_tiles
from dtc_tpu_torch.core.statevector import initial_statevector, neel_index
from dtc_tpu_torch.models.drives import (
    build_kick_schedule,
    n_kick_slots,
    slot_unitary,
    slot_unitary_inverse,
)
from dtc_tpu_torch.ops.diag import z_sign_mask, zz_z_phase_mask
from dtc_tpu_torch.ops.kick import kron_power
from dtc_tpu_torch.ops.params import (
    echo_pair_tiles,
    kick_matrices,
    pack_cycle_params_compact,
)

torch.set_num_threads(2)

POLARIZATIONS = ["x", "y", "xy", "yx", "circular_left", "circular_right",
                 "circular_static", "xy_cycle"]


@pytest.mark.parametrize("pol", POLARIZATIONS)
def test_kick_schedule_matches_reference(pol):
    for g in (0.97, np.linspace(0.85, 1.0, 12)):
        ref = np.asarray(j_sched(pol, g, 12, circular_frequency=0.4,
                                 xy_cycle_period=3).angles)
        got = build_kick_schedule(pol, g, 12, circular_frequency=0.4,
                                  xy_cycle_period=3).angles.numpy()
        assert got.shape == ref.shape
        assert got.shape[1] == n_kick_slots(pol)
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12)


@pytest.mark.parametrize("dtype", ["complex64", "complex128"])
def test_slot_unitaries_match_reference(dtype):
    jd, td = {"complex64": (jnp.complex64, torch.complex64),
              "complex128": (jnp.complex128, torch.complex128)}[dtype]
    tol = 1e-7 if dtype == "complex64" else 1e-14
    for tx, ty in ((0.97 * np.pi, 0.0), (0.0, 1.3), (0.4, -2.2)):
        np.testing.assert_allclose(
            slot_unitary(tx, ty, td).numpy(), np.asarray(j_su(tx, ty, jd)),
            atol=tol)
        np.testing.assert_allclose(
            slot_unitary_inverse(tx, ty, td).numpy(),
            np.asarray(j_sui(tx, ty, jd)), atol=tol)
    batch = slot_unitary(torch.tensor([0.3, 0.7]), torch.tensor([0.1, 0.0]),
                         td)
    assert batch.shape == (2, 2, 2)
    np.testing.assert_allclose(batch[1].numpy(),
                               np.asarray(j_su(0.7, 0.0, jd)), atol=tol)


@pytest.mark.parametrize("state", ["vacuum", "neel"])
def test_initial_state_matches_reference(state):
    for L in (1, 4, 7):
        assert neel_index(L) == j_neel(L)
        np.testing.assert_array_equal(
            initial_statevector(L, state, dtype=torch.complex128).numpy(),
            np.asarray(j_init(L, state, dtype=jnp.complex128)))


def test_diag_masks_match_reference():
    rng = np.random.default_rng(4)
    L = 7
    hs, phis = rng.uniform(-np.pi, np.pi, L), rng.uniform(-5, 0, L - 1)
    for jd, td, tol in ((jnp.complex64, torch.complex64, 1e-6),
                        (jnp.complex128, torch.complex128, 1e-13)):
        ref = np.asarray(j_mask(jnp.asarray(hs), jnp.asarray(phis), L,
                                dtype=jd))
        got = zz_z_phase_mask(torch.from_numpy(hs), torch.from_numpy(phis), L,
                              dtype=td).numpy()
        np.testing.assert_allclose(got, ref, atol=tol)
    for q in range(L):
        np.testing.assert_array_equal(z_sign_mask(q, L).numpy(),
                                      np.asarray(j_zsign(q, L)))


def test_kron_power_matches_reference():
    u = np.array(j_su(0.9, 0.3, jnp.complex128))
    for k in (1, 2, 3, 5):
        np.testing.assert_allclose(kron_power(torch.from_numpy(u), k).numpy(),
                                   np.asarray(j_kron_power(jnp.asarray(u), k)),
                                   atol=1e-14)
    batch = kron_power(torch.from_numpy(np.stack([u, u.conj()])), 3)
    np.testing.assert_allclose(
        batch[1].numpy(),
        np.asarray(j_kron_power(jnp.asarray(u.conj()), 3)), atol=1e-14)


def test_compact_rows_bit_identical():
    L, T = 17, 6
    rng = np.random.default_rng(1)
    hs, phis = rng.standard_normal(L), rng.standard_normal(L - 1)
    _, zm, _, csum = j_presample(jax.random.PRNGKey(2), 0.6, T, L)
    ref = np.asarray(jax.vmap(
        lambda z, s: j_pack(z, s, jnp.asarray(hs), jnp.asarray(phis), L))(
            zm, csum))
    got = pack_cycle_params_compact(
        torch.from_numpy(np.asarray(zm).astype(np.int64)),
        torch.from_numpy(np.asarray(csum).astype(np.int64)),
        torch.from_numpy(hs)[None], torch.from_numpy(phis)[None], L).numpy()
    np.testing.assert_array_equal(got, ref)
    with pytest.raises(ValueError):
        pack_cycle_params_compact(torch.zeros((), dtype=torch.int64),
                                  torch.zeros((), dtype=torch.int64),
                                  torch.zeros(27), torch.zeros(26), 27)


@pytest.mark.parametrize("L", [17, 20, 23])
def test_kick_matrices_match_reference(L):
    ang = build_kick_schedule("x", 0.97, 3).angles
    ref = j_kick(jnp.asarray(ang.numpy()), L, 1 << (L - 14), False)
    got = kick_matrices(ang, L)
    for r, g in zip(ref, got):
        assert g.shape == r.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-7)


@pytest.mark.parametrize("p", [0.6, 0.0])
def test_echo_pair_tiles_bit_identical(p):
    L, T = 17, 3
    rng = np.random.default_rng(5)
    hs, phis = rng.standard_normal(L), rng.standard_normal(L - 1)
    key = jax.random.PRNGKey(5)
    u = np.asarray(jax.random.uniform(key, (2 * T, 1, L),
                                      dtype=jnp.float32))[:, 0]
    ts = [0, 1, 2, 3]
    tiles, sig = echo_pair_tiles(
        torch.from_numpy(u.copy()), torch.tensor(ts), torch.from_numpy(hs),
        torch.from_numpy(phis), L=L, T=T, p=p, batch=())
    for i, t in enumerate(ts):
        rt, rs = j_tiles(key, jnp.asarray(t), jnp.asarray(hs),
                         jnp.asarray(phis), L=L, T=T, p=p)
        np.testing.assert_array_equal(tiles[i].numpy(), np.asarray(rt))
        assert int(sig[i]) == int(rs)
