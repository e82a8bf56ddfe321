"""Resident x-drive entries (kernels K3a/K3b and their plain versions).

On the CPU the entries run the plain versions, which are held against the
JAX Pallas kernels K3a/K3b in interpret mode (constant and per-cycle
schedules), fed the same uniforms: 1e-4, the reference's own bound for its
interpret kernels against the sigma engine. The kernels themselves are
compared with these plain versions on the card by
``test_torch_kernels_cuda.py``. Also: the per-cycle kick matrices against
the reference's, the engine's routes, and the range checks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dtc_tpu.io.disorder import generate_disorder
from dtc_tpu.models.drives import build_kick_schedule as j_sched
from dtc_tpu.ops.pallas_resident import _kick_matrices as j_kick_matrices
from dtc_tpu.ops.pallas_resident import resident_echo_batch as j_echo
from dtc_tpu.ops.pallas_resident import resident_forward_batch as j_forward
from dtc_tpu_torch.models.drives import build_kick_schedule
from dtc_tpu_torch.ops import resident as rs
from dtc_tpu_torch.ops.params import echo_pair_tiles, forward_rows, kick_matrices
from dtc_tpu_torch.ops.routes import engine_for
from dtc_tpu_torch.utils import profiling

torch.set_num_threads(2)

# the reference's own interpret case (tests/test_kernel_interpret_parity.py)
L, T, P, Q = 14, 3, 0.6, 7
RAMP = np.linspace(0.86, 0.99, T)


def _disorder(L):
    hs, phis = generate_disorder(L, 1, seed=7)
    return torch.as_tensor(hs[:, :L]), torch.as_tensor(phis[:, :L - 1])


def _uniforms(keys, shape):
    return torch.from_numpy(np.array(jax.vmap(jax.vmap(
        lambda k: jax.random.uniform(k, shape, dtype=jnp.float32)))(keys)))


def _schedule(time_dependent):
    g = RAMP if time_dependent else 0.97
    return np.asarray(j_sched("x", jnp.asarray(g), T).angles)


def _keys():
    return jax.random.split(jax.random.PRNGKey(9), 2)[None]


@pytest.mark.parametrize("time_dependent", [False, True])
def test_plain_forward_matches_reference_interpret(time_dependent):
    hs, phis = _disorder(L)
    keys = _keys()
    ang = _schedule(time_dependent)
    ref = np.asarray(j_forward(
        jnp.asarray(hs.numpy()), jnp.asarray(phis.numpy()), jnp.asarray(ang),
        keys, L=L, T=T, p=P, q=Q, initial_state="neel", ancilla_factor=0.8,
        time_dependent=time_dependent, interpret=True))
    rows, sig = forward_rows(_uniforms(keys, (T, L)), hs[:, None],
                             phis[:, None], L=L, T=T, p=P)
    got = rs.resident_forward_batch(rows, sig, torch.tensor(ang), L=L,
                                    q=Q, initial_state="neel",
                                    ancilla_factor=0.8,
                                    time_dependent=time_dependent).numpy()
    assert got.shape == (1, 2, T)
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)


@pytest.mark.parametrize("time_dependent", [False, True])
def test_plain_echo_matches_reference_interpret(time_dependent):
    hs, phis = _disorder(L)
    keys = _keys()
    ang = _schedule(time_dependent)
    ts = [1, 3]
    u = _uniforms(keys, (2 * T, L))
    for p in (P, 0.0):
        ref = np.asarray(j_echo(
            jnp.asarray(hs.numpy()), jnp.asarray(phis.numpy()),
            jnp.asarray(ang), keys, jnp.asarray(ts), L=L, T=T, p=p, q=Q,
            time_dependent=time_dependent, interpret=True))
        tiles, sig = echo_pair_tiles(u, torch.tensor(ts), hs[:, None],
                                     phis[:, None], L=L, T=T, p=p)
        got = rs.resident_echo_batch(tiles, sig, torch.tensor(ang), L=L,
                                     q=Q, time_dependent=time_dependent
                                     ).numpy()
        assert got.shape == (1, 2, 2)
        np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)
        if p > 0:
            assert np.abs(got - 1).max() > 1e-2  # sampled events fired
        else:
            np.testing.assert_allclose(got, 1.0, atol=1e-4)


@pytest.mark.parametrize("L_", [14, 16, 17])
def test_kick_matrices_match_reference(L_):
    ang = np.asarray(j_sched("x", jnp.asarray(np.linspace(0.8, 1.0, 5)),
                             5).angles)
    top = 1 << (L_ - 14)
    for td in (False, True):
        ref = j_kick_matrices(jnp.asarray(ang), L_, top, td)
        got = kick_matrices(torch.tensor(ang), L_, time_dependent=td)
        assert got[0].shape == (5 if td else 1, 128, 128)
        assert got[2].shape == (5 if td else 1, top, top)
        for a, b in zip(got, ref):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6,
                                       rtol=0)


@pytest.mark.parametrize("L_,const,want", [
    (14, True, "resident"), (16, True, "resident"), (17, True, "blocked"),
    (14, False, "resident"), (21, False, "resident"), (22, False, "general"),
])
def test_engine_routes(L_, const, want):
    g = 0.97 if const else torch.linspace(0.86, 0.99, 6, dtype=torch.float64)
    ang = build_kick_schedule("x", g, 6).angles
    kw = dict(L=L_, T=6, q=L_ // 2, has_y=False)
    for echo in (False, True):
        assert engine_for(ang, dtype_name="complex64", echo=echo,
                          **kw) == want
        assert engine_for(ang, dtype_name="complex128", echo=echo,
                          **kw) == "sigma"


def test_entries_reject_out_of_range():
    ang = build_kick_schedule("x", 0.97, 3).angles
    rows = torch.zeros((1, 3, 128))
    sig = torch.zeros((1, 3), dtype=torch.int64)
    for L_, q in ((13, 3), (22, 3), (14, 14), (14, -1)):
        with pytest.raises(ValueError):
            rs.resident_forward_batch(rows, sig, ang, L=L_, q=q)
    with pytest.raises(ValueError, match="T <= 1024"):
        rs.resident_forward_batch(torch.zeros((1, 1025, 128)),
                                  torch.zeros((1, 1025), dtype=torch.int64),
                                  ang, L=14, q=3)
    with pytest.raises(ValueError, match="T <= 512"):
        rs.resident_echo_batch(torch.zeros((1, 4 * 513, 128)),
                               torch.zeros((1,), dtype=torch.int64), ang,
                               L=14, q=3)
    with pytest.raises(ValueError, match="does not cover"):
        rs.resident_forward_batch(torch.zeros((1, 4, 128)),
                                  torch.zeros((1, 4), dtype=torch.int64),
                                  ang, L=14, q=3, time_dependent=True)
    with pytest.raises(ValueError, match="x schedule"):
        rs.resident_forward_batch(rows, sig,
                                  build_kick_schedule("xy", 0.97, 3).angles,
                                  L=14, q=3)
    with pytest.raises(ValueError):  # neither CPU (plain) nor CUDA (kernel)
        rs.resident_forward_batch(rows.to("meta"), sig, ang, L=14, q=3)


def test_wrapper_routes_cpu_to_plain_version():
    hs, phis = _disorder(L)
    ang = build_kick_schedule("x", torch.tensor(RAMP), T).angles
    rows, sig = forward_rows(None, hs[:, None], phis[:, None], L=L, T=T,
                             p=0.0, batch=(1, 1))
    profiling.reset_counters()
    a = rs.resident_forward_batch(rows, sig, ang, L=L, q=3,
                                  time_dependent=True)
    b = rs.resident_forward_batch_ref(rows, sig, ang, L=L, q=3,
                                      time_dependent=True)
    assert torch.equal(a, b)
    assert not profiling.LAUNCHES
    assert not profiling.PLAIN_ON_CUDA
