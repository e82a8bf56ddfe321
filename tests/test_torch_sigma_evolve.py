"""Port's sigma-frame engine against the JAX reference (CPU).

The same per-trajectory uniforms, drawn from the reference's own keys, go
through both engines, for the x drive and for the y, xy, circular_left and
xy_cycle drives (K = 1 or 2 kick slots per cycle). Tolerances: 1e-10 in
complex128 (the engines do the same arithmetic; rounding order differs),
1e-5 in complex64 (f32 rounding
over T cycles). Codes, masks and the XOR sigma frame must be bit-identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import exact_oracle as oracle
from dtc_tpu.core.sigma_evolve import _codes_from_uniform as j_codes
from dtc_tpu.core.sigma_evolve import presample_noise as j_presample
from dtc_tpu.core.sigma_evolve import sigma_forward_batch as j_forward
from dtc_tpu.io.disorder import generate_disorder
from dtc_tpu.models.drives import build_kick_schedule as j_sched
from dtc_tpu_torch.core.sigma_evolve import (
    _codes_from_uniform,
    presample_noise,
    sigma_forward_batch,
)
from dtc_tpu_torch.models.drives import build_kick_schedule
from dtc_tpu_torch.utils.convert import from_reference

torch.set_num_threads(2)


def _uniforms(keys, shape):
    draw = jax.vmap(jax.vmap(lambda k: jax.random.uniform(
        k, shape, dtype=jnp.float32)))
    return np.asarray(draw(keys))


@pytest.mark.parametrize("p", [0.05, 0.1, 0.6])
def test_codes_bit_identical_at_thresholds(p):
    q = 0.25 * p
    u = [np.random.default_rng(0).random(50000, dtype=np.float32)]
    for k in range(3):  # every floor boundary and its f32 neighbours
        b = np.float32(1 - 3 * q + k * q)
        u.append(np.array([np.nextafter(b, np.float32(0)), b,
                           np.nextafter(b, np.float32(1))], np.float32))
    u = np.concatenate(u)
    np.testing.assert_array_equal(
        _codes_from_uniform(torch.from_numpy(u), p).numpy(),
        np.asarray(j_codes(jnp.asarray(u), p)))


def test_presample_bit_identical():
    L, n = 9, 40
    key = jax.random.PRNGKey(11)
    ref = j_presample(key, 0.6, n, L)
    u = np.asarray(jax.random.uniform(key, (n, L), dtype=jnp.float32))
    got = presample_noise(torch.from_numpy(u.copy()), 0.6, L)
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(g.numpy(),
                                      np.asarray(r).astype(np.int64))


_X_CASES = [
    (6, 0.1, "vacuum", "complex128"),
    (6, 0.6, "neel", "complex128"),
    (9, 0.6, "neel", "complex64"),
    (9, 0.1, "vacuum", "complex64"),
]
# (pol, L, p, state, dtype); the x cases keep their ids
CASES = ([pytest.param("x", *c, id="-".join(map(str, c))) for c in _X_CASES]
         + [pytest.param(pol, *c, id="-".join(map(str, (pol, *c))))
            for pol in ("y", "xy", "circular_left", "xy_cycle")
            for c in (_X_CASES[1], _X_CASES[2])])
T_CASE = 6
ECHO_TS = [0, 1, 3, T_CASE - 1]


def reference_case(pol, L, p, state, dtype):
    """Disorder, schedule, keys and engine kwargs of one parity case, the
    reference's inputs and the port's (uniforms drawn from the keys)."""
    inst, c, T = 2, 2, T_CASE
    hs, phis = generate_disorder(L, inst, seed=3)
    hs, phis = hs[:, :L], phis[:, :L - 1]
    angles = j_sched(pol, 0.97, T).angles
    K = angles.shape[1]
    keys = jax.vmap(lambda k: jax.random.split(k, c))(
        jax.random.split(jax.random.PRNGKey(1), inst))
    kw = dict(L=L, T=T, K=K, p=p, q=L // 2, initial_state=state,
              dtype_name=dtype, ancilla_factor=0.7, has_y=pol != "x")
    jax_args = (jnp.asarray(hs), jnp.asarray(phis), angles, keys)
    port_args = from_reference(
        hs, phis, np.asarray(angles),
        (_uniforms(keys, (T * K, L)), _uniforms(keys, (2 * T * K, L))))
    return jax_args, port_args, kw


def tolerance(dtype):
    return 1e-10 if dtype == "complex128" else 1e-5


@pytest.mark.parametrize("pol,L,p,state,dtype", CASES)
def test_sigma_forward_matches_reference(pol, L, p, state, dtype):
    jax_args, (h, ph, ang, (uf, _ue)), kw = reference_case(pol, L, p, state,
                                                           dtype)
    ref = np.asarray(j_forward(*jax_args, **kw))
    got = sigma_forward_batch(h, ph, ang, uf, **kw).numpy()
    np.testing.assert_allclose(got, ref, atol=tolerance(dtype), rtol=0)


def test_noiseless_forward_matches_exact_oracle():
    L, T = 4, 5
    hs, phis = generate_disorder(L, 1, seed=2)
    h = torch.from_numpy(hs[:, :L])
    ph = torch.from_numpy(phis[:, :L - 1])
    a = sigma_forward_batch(h, ph, build_kick_schedule("x", 0.97, T).angles,
                            L=L, T=T, K=1, p=0.0, q=L // 2,
                            initial_state="neel", dtype_name="complex128",
                            ancilla_factor=1.0, has_y=False, n_traj=1)
    ref = [oracle.autocorr_dm(L, 0.97, hs[0, :L], phis[0, :L - 1], t, 0.0,
                              initial_state="neel") for t in range(T)]
    np.testing.assert_allclose(a[0, 0].numpy(), ref, atol=1e-10)
