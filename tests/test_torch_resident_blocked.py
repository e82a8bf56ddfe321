"""Blocked x-drive entries (kernels K1/K2 and their plain versions).

On the CPU the entries run the plain versions, which are held against the
JAX Pallas kernels in interpret mode, fed the same uniforms: 1e-4, the
reference's own bound for its interpret kernels against the sigma engine.
The kernels themselves are compared with these plain versions on the card
by ``test_torch_kernels_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dtc_tpu.io.disorder import generate_disorder
from dtc_tpu.models.drives import build_kick_schedule as j_sched
from dtc_tpu.ops.pallas_resident_blocked import blocked_echo_batch as j_echo
from dtc_tpu.ops.pallas_resident_blocked import (
    blocked_forward_batch as j_forward,
)
from dtc_tpu_torch.ops import resident_blocked as rb
from dtc_tpu_torch.ops.params import echo_pair_tiles, forward_rows
from dtc_tpu_torch.utils import profiling

torch.set_num_threads(2)

THETA = 0.97 * np.pi


def _disorder(L):
    hs, phis = generate_disorder(L, 1, seed=7)
    return torch.as_tensor(hs[:, :L]), torch.as_tensor(phis[:, :L - 1])


def _uniforms(keys, shape):
    return torch.from_numpy(np.array(jax.vmap(jax.vmap(
        lambda k: jax.random.uniform(k, shape, dtype=jnp.float32)))(keys)))


@pytest.mark.parametrize("state", ["vacuum", "neel"])
def test_plain_forward_matches_reference_interpret(state):
    L, T, q, p = 17, 3, 11, 0.1
    hs, phis = _disorder(L)
    keys = jax.random.split(jax.random.PRNGKey(3), 2)[None]
    ref = np.asarray(j_forward(
        jnp.asarray(hs.numpy()), jnp.asarray(phis.numpy()),
        j_sched("x", 0.97, T).angles, keys, L=L, T=T, p=p, q=q,
        initial_state=state, ancilla_factor=0.8, interpret=True))
    rows, sig = forward_rows(_uniforms(keys, (T, L)), hs[:, None],
                             phis[:, None], L=L, T=T, p=p)
    got = rb.blocked_forward_batch(rows, sig, THETA, L=L, q=q,
                                   initial_state=state,
                                   ancilla_factor=0.8).numpy()
    assert got.shape == (1, 2, T)
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)


def test_plain_echo_matches_reference_interpret():
    L, T, q = 17, 2, 11
    hs, phis = _disorder(L)
    keys = jax.random.split(jax.random.PRNGKey(0), 2)[None]
    ts = [1, 2]
    jargs = (jnp.asarray(hs.numpy()), jnp.asarray(phis.numpy()),
             j_sched("x", 0.97, T).angles, keys, jnp.asarray(ts))
    u = _uniforms(keys, (2 * T, L))
    for p in (0.6, 0.0):
        ref = np.asarray(j_echo(*jargs, L=L, T=T, p=p, q=q, interpret=True))
        tiles, sig = echo_pair_tiles(u, torch.tensor(ts), hs[:, None],
                                     phis[:, None], L=L, T=T, p=p)
        got = rb.blocked_echo_batch(tiles, sig, THETA, L=L, q=q).numpy()
        assert got.shape == (1, 2, 2)
        np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)
        if p > 0:
            assert got.min() < -0.9  # sampled events really fired
        else:
            np.testing.assert_allclose(got, 1.0, atol=1e-4)


def test_entries_reject_out_of_range():
    rows = torch.zeros((1, 3, 128))
    sig = torch.zeros((1, 3), dtype=torch.int64)
    for L, q in ((16, 3), (24, 3), (17, 17)):
        with pytest.raises(ValueError):
            rb.blocked_forward_batch(rows, sig, THETA, L=L, q=q)
    with pytest.raises(ValueError):
        rb.blocked_forward_batch(torch.zeros((1, 1025, 128)),
                                 torch.zeros((1, 1025), dtype=torch.int64),
                                 THETA, L=17, q=3)
    with pytest.raises(ValueError):
        rb.blocked_echo_batch(torch.zeros((1, 4 * 513, 128)),
                              torch.zeros((1,), dtype=torch.int64), THETA,
                              L=17, q=3)
    with pytest.raises(ValueError):  # neither CPU (plain) nor CUDA (kernel)
        rb.blocked_forward_batch(rows.to("meta"), sig, THETA, L=17, q=3)


def test_wrapper_routes_cpu_to_plain_version():
    L, T = 17, 2
    hs, phis = _disorder(L)
    rows, sig = forward_rows(None, hs[:, None], phis[:, None], L=L, T=T,
                             p=0.0, batch=(1, 1))
    profiling.reset_counters()
    a = rb.blocked_forward_batch(rows, sig, THETA, L=L, q=3)
    b = rb.blocked_forward_batch_ref(rows, sig, THETA, L=L, q=3)
    assert torch.equal(a, b)
    assert not profiling.LAUNCHES
    assert not profiling.PLAIN_ON_CUDA
