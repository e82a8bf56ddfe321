"""Lab-frame cycle-kernel sharding (K8c/K8d) against the reference.

The port's ``make_sharded_autocorr_forward_general`` and
``make_sharded_echo_general`` (on the CPU: the plain versions of K8c/K8d)
run on a mesh of 8 logical CPU devices; the reference's sigma-frame sharded
engines with ``has_y=True``, its own plain reference for these kernels
(``tests/test_sharded_kernel.py``), on the 8 virtual CPU devices of
``tests/conftest.py``. Both get the same uniforms, drawn per trajectory key
as the reference's engines draw them: forward (T*K, L), echo (2T, K, L).
Tolerance 1e-4 at every time point, ancilla_factor=1 on both sides so that
the values are O(1).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dtc_tpu.io.disorder import generate_disorder
from dtc_tpu.models.drives import build_kick_schedule as j_sched
from dtc_tpu.parallel.mesh import make_mesh as j_make_mesh
from dtc_tpu.parallel.sharded import (
    make_sharded_autocorr_forward as j_forward,
)
from dtc_tpu.parallel.sharded import make_sharded_echo as j_echo
from dtc_tpu_torch.core.sigma_evolve import (
    sigma_echo_batch,
    sigma_forward_batch,
)
from dtc_tpu_torch.parallel import mesh as pmesh
from dtc_tpu_torch.parallel import sharded as sh
from dtc_tpu_torch.utils.convert import from_reference

torch.set_num_threads(2)
TOL = 1e-4
T, P, N_TRAJ = 3, 0.6, 2

# (polarization, L, n_amp, q): y and circular_left with the boundary bond
# and one global kick; xy at n_amp=4 adds a shard-shard bond and a second
# exchange bit; q=15 and q=16 (the local top bit) sit next to the shard
# bits, where an error in the global algebra shows within T=3 cycles
CASES = [("y", 18, 2, 16), ("xy", 19, 4, 9), ("circular_left", 18, 2, 15)]


def _inputs(L, pol, n, shape):
    hs, phis = generate_disorder(L, 1, seed=5)
    hs, phis = hs[:, :L], phis[:, :L - 1]
    sched = j_sched(pol, 0.97, T, circular_frequency=0.5)
    keys = jax.random.split(jax.random.PRNGKey(11), n)
    u = np.asarray(jax.vmap(lambda k: jax.random.uniform(
        k, shape(sched.K), dtype=jnp.float32))(keys))
    h, ph, ang, uu = from_reference(hs, phis, np.asarray(sched.angles), u)
    jargs = (sched.angles, jnp.asarray(hs[0]), jnp.asarray(phis[0]), keys)
    return sched.K, jargs, (ang, h[0], ph[0], uu)


def _port_mesh(n_amp):
    return pmesh.make_mesh(n_amp, N_TRAJ, devices=["cpu"] * 8)


@pytest.mark.parametrize("pol,L,n_amp,q", CASES)
def test_general_forward_matches_reference(pol, L, n_amp, q):
    K, jargs, args = _inputs(L, pol, 2 * N_TRAJ, lambda K: (T * K, L))
    kw = dict(L=L, T=T, K=K, p=P, q=q, ancilla_factor=1.0)
    want = np.asarray(j_forward(j_make_mesh(n_amp=n_amp, n_traj=N_TRAJ),
                                has_y=True, **kw)(*jargs))
    got = sh.make_sharded_autocorr_forward_general(_port_mesh(n_amp),
                                                   **kw)(*args)
    assert got.shape == (T,)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL)


@pytest.mark.parametrize("pol,L,n_amp,q", CASES)
def test_general_echo_matches_reference(pol, L, n_amp, q):
    """Every t of (0, 1, T): daggered slots in reversed order, the daggered
    global diagonal, the previous event's Z word zeroed at the turnaround."""
    K, jargs, args = _inputs(L, pol, 2 * N_TRAJ, lambda K: (2 * T, K, L))
    kw = dict(L=L, T=T, K=K, p=P, q=q, ancilla_factor=1.0)
    ref = j_echo(j_make_mesh(n_amp=n_amp, n_traj=N_TRAJ), has_y=True, **kw)
    port = sh.make_sharded_echo_general(_port_mesh(n_amp), **kw)
    for t in (0, 1, T):
        want = float(ref(*jargs, jnp.asarray(t)))
        assert abs(float(port(*args, t)) - want) < TOL, t


def test_general_noiseless_echo_is_one():
    """p=0: the lab-frame echo returns every shard to the basis state."""
    K, _, (ang, hs, phis, _) = _inputs(18, "xy", 1, lambda K: (1,))
    port = sh.make_sharded_echo_general(_port_mesh(2), L=18, T=T, K=K, p=0.0,
                                        q=9)
    for t in range(T + 1):
        assert abs(float(port(ang, hs, phis, None, t, n_traj=N_TRAJ))
                   - 1.0) < TOL


@pytest.mark.parametrize("pol", ["xy", "circular_left"])
def test_final_slot_shard_z_is_applied_once(pol):
    """One Z event on shard bit 17 after the final slot of cycle 0, L=18 on
    2 shards, probe on the local top bit: the cycle's global diagonal applies
    it, and the next cycle's first global kick must not fold it again. The
    reference's kernel engines (``make_sharded_*_general``) fold it twice,
    which cancels it; the port applies it once and agrees with the unsharded
    sigma engine (complex128) on the same uniforms."""
    L, q, T4 = 18, 16, 4
    K, _, (ang, hs, phis, _) = _inputs(L, pol, 1, lambda K: (1,))
    ang = torch.cat([ang, ang[-1:]])                             # T = 4
    thr = 1.0 - 0.75 * P
    kw = dict(L=L, T=T4, K=K, p=P, q=q, initial_state="vacuum",
              dtype_name="complex128", ancilla_factor=1.0, has_y=True)
    mesh = pmesh.make_mesh(2, 1, devices=["cpu"] * 8)
    u = torch.zeros(1, T4, K, L)
    u[0, 0, K - 1, 17] = thr + 0.625 * P                         # a Z
    want = sigma_forward_batch(hs[None], phis[None], ang,
                               u.reshape(1, 1, T4 * K, L), **kw)[0, 0]
    got = sh.make_sharded_autocorr_forward_general(
        mesh, L=L, T=T4, K=K, p=P, q=q,
        ancilla_factor=1.0)(ang, hs, phis, u.reshape(1, T4 * K, L))
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=TOL)
    ue = torch.zeros(1, 2 * T4, K, L)
    ue[0, 0, K - 1, 17] = thr + 0.625 * P                        # a Z
    ue[0, 2, K - 1, 16] = thr + 0.375 * P                        # a Y
    want = sigma_echo_batch(hs[None], phis[None], ang, [3],
                            ue.reshape(1, 1, 2 * T4 * K, L), **kw)[0, 0, 0]
    got = sh.make_sharded_echo_general(
        mesh, L=L, T=T4, K=K, p=P, q=q,
        ancilla_factor=1.0)(ang, hs, phis, ue, 3)
    assert abs(float(got) - float(want)) < TOL
