"""Amplitude sharding through the streamed per-shard kernels: the cycle-kernel
engines of ``parallel/sharded.py`` on K9a/K9b (constant x) and on K10's
shard-local forms (every other drive), against the reference.

The engines take the streamed kernels from L_loc = ``cycle_hi.MIN_ROUTE_L``
(24) on; here it is lowered to 22, as the reference's own test lowers
``DTC_TPU_SHARDED_HI_MIN_LB`` (``tests/test_sharded_kernel.py``), so that
the route runs at L=23 on 2 shards, a size a CPU holds. On the CPU the
engines run the kernels' plain versions. They are held against the
reference's sigma-frame sharded engines (``has_y`` for the drives with a Y
part) on the 8 virtual CPU devices of ``tests/conftest.py``, fed the same
uniforms, drawn per trajectory key as the reference's engines draw them:
1e-4 at every time point, the reference's own bound, with ancilla_factor=1
so that the values are O(1). q=16 sits in the strided bits of the streamed
passes, the band the reference's test probes.
"""

import logging
import os

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
from dtc_tpu_torch.ops import cycle, cycle_hi
from dtc_tpu_torch.parallel import mesh as pmesh
from dtc_tpu_torch.parallel import sharded as sh
from dtc_tpu_torch.utils import cli
from dtc_tpu_torch.utils import profiling
from dtc_tpu_torch.utils.convert import from_reference

torch.set_num_threads(2)
TOL = 1e-4
L, N_AMP, T, P, Q = 23, 2, 2, 0.6, 16

HI_REFS = ("hi_cycle_forward_apply_ref", "hi_cycle_inverse_apply_ref",
           "general_hi_cycle_forward_apply_ref",
           "general_hi_cycle_inverse_apply_ref")
K8_REFS = ("cycle_forward_apply_ref", "cycle_inverse_apply_ref",
           "general_cycle_forward_apply_ref",
           "general_cycle_inverse_apply_ref")


@pytest.fixture
def hi_route(monkeypatch):
    """MIN_ROUTE_L at 22, and a count of the plain calls each family gets
    (on the CPU every kernel entry runs its plain version)."""
    monkeypatch.setattr(cycle_hi, "MIN_ROUTE_L", 22)
    calls = {}
    for mod, names in ((cycle_hi, HI_REFS), (cycle, K8_REFS)):
        for name in names:
            def spy(*a, _fn=getattr(mod, name), _name=name, **kw):
                calls[_name] = calls.get(_name, 0) + 1
                return _fn(*a, **kw)
            monkeypatch.setattr(mod, name, spy)
    return calls


def _inputs(pol, n, shape, Lr=L, seed=11):
    """(K, JAX args (angles, hs, phis, keys), port args (angles, hs, phis,
    uniforms)): n trajectory keys and their uniforms of shape(K)."""
    hs, phis = generate_disorder(Lr, 1, seed=5)
    hs, phis = hs[:, :Lr], phis[:, :Lr - 1]
    sched = j_sched(pol, 0.97, T, circular_frequency=0.5)
    keys = jax.random.split(jax.random.PRNGKey(seed), n)
    u = np.asarray(jax.vmap(lambda k: jax.random.uniform(
        k, shape(sched.K), dtype=jnp.float32))(keys))
    h, ph, ang, uu = from_reference(hs, phis, np.asarray(sched.angles), u)
    jargs = (sched.angles, jnp.asarray(hs[0]), jnp.asarray(phis[0]), keys)
    return sched.K, jargs, (ang, h[0], ph[0], uu)


def _port_mesh(n_amp=N_AMP, n_traj=1):
    return pmesh.make_mesh(n_amp, n_traj, devices=["cpu"] * 8)


@pytest.mark.parametrize("pol", ["x", "y", "xy", "circular_left"])
def test_hi_engines_match_reference(hi_route, pol):
    """Forward A(t) and the echo at t=T, 2 trajectories, through K9a/K9b (x)
    or K10a/K10b shard-local (y: K=1 with Y kicks; xy, circular_left: K=2,
    reversed daggered slots on the inverse steps): the boundary bond, the
    global kick and the global diagonal around each launch."""
    x = pol == "x"
    K, jargs, args = _inputs(pol, 2, lambda K: (T * K, L))
    kw = dict(L=L, T=T, p=P, q=Q, ancilla_factor=1.0)
    jmesh = j_make_mesh(n_amp=N_AMP, n_traj=1)
    want = np.asarray(j_forward(jmesh, K=K, has_y=not x, **kw)(*jargs))
    maker = (sh.make_sharded_autocorr_forward_kernel if x else
             lambda mesh, **k: sh.make_sharded_autocorr_forward_general(
                 mesh, K=K, **k))
    got = maker(_port_mesh(), **kw)(*args)
    assert got.shape == (T,)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL)
    assert abs(float(got[1])) > 1e-3  # the cycle left a signal to compare

    K, jargs, args = _inputs(pol, 2, lambda K: (2 * T, K, L))
    want = float(j_echo(jmesh, K=K, has_y=not x, **kw)(*jargs,
                                                       jnp.asarray(T)))
    maker = (sh.make_sharded_echo_kernel if x else
             lambda mesh, **k: sh.make_sharded_echo_general(mesh, K=K, **k))
    got = float(maker(_port_mesh(), **kw)(*args, T))
    assert abs(got - want) < TOL
    fam = HI_REFS[:2] if x else HI_REFS[2:]
    assert all(hi_route.get(name, 0) > 0 for name in fam), hi_route
    assert not any(hi_route.get(name) for name in K8_REFS), hi_route


def test_final_slot_shard_z_is_applied_once_on_the_hi_route(hi_route):
    """One Z event on shard bit 22 after the final slot of cycle 0, L=23 on
    2 shards through K10's shard-local forms (xy, K=2), probe on the local
    top bit: the cycle's global diagonal applies it, and the next cycle's
    first global kick must not fold it again (the reference's engines fold
    it twice, which cancels it; ROADMAP.md queue 3). The port agrees with
    the unsharded sigma engine (complex128) on the same uniforms."""
    q, T3 = 21, 3
    K, _, (ang, hs, phis, _) = _inputs("xy", 1, lambda K: (1,))
    ang = torch.cat([ang, ang[-1:]])                             # T = 3
    thr = 1.0 - 0.75 * P
    kw = dict(L=L, T=T3, K=K, p=P, q=q, initial_state="vacuum",
              dtype_name="complex128", ancilla_factor=1.0, has_y=True)
    mesh = _port_mesh()
    u = torch.zeros(1, T3, K, L)
    u[0, 0, K - 1, 22] = thr + 0.625 * P                         # a Z
    want = sigma_forward_batch(hs[None], phis[None], ang,
                               u.reshape(1, 1, T3 * K, L), **kw)[0, 0]
    got = sh.make_sharded_autocorr_forward_general(
        mesh, L=L, T=T3, K=K, p=P, q=q,
        ancilla_factor=1.0)(ang, hs, phis, u.reshape(1, T3 * K, L))
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=TOL)
    ue = torch.zeros(1, 2 * T3, K, L)
    ue[0, 0, K - 1, 22] = thr + 0.625 * P                        # a Z
    ue[0, 2, K - 1, 21] = thr + 0.375 * P                        # a Y
    want = sigma_echo_batch(hs[None], phis[None], ang, [2],
                            ue.reshape(1, 1, 2 * T3 * K, L), **kw)[0, 0, 0]
    got = sh.make_sharded_echo_general(
        mesh, L=L, T=T3, K=K, p=P, q=q,
        ancilla_factor=1.0)(ang, hs, phis, ue, 2)
    assert abs(float(got) - float(want)) < TOL
    assert hi_route.get("general_hi_cycle_inverse_apply_ref", 0) > 0


@pytest.mark.parametrize("route", ["hi", "k8"])
def test_general_engines_build_the_global_angles_once(route, monkeypatch):
    """A lab-frame engine call (the forward over 2 cycles, the echo at t=1:
    2 steps; xy, 2 trajectories, 2 shards) makes one ``_tail_phase_angles``
    call, for every step and shard at once, not one a step. On both routes,
    K10's (L=23, MIN_ROUTE_L at 22) and K8's (L=19), the global diagonal
    rides in the launches' folded rows and ``global_phase`` is never
    called."""
    Lr = 23 if route == "hi" else 19
    if route == "hi":
        monkeypatch.setattr(cycle_hi, "MIN_ROUTE_L", 22)
    calls = {"angles": 0, "phase": 0}

    def spy(key, fn):
        def wrapped(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(sh, "_tail_phase_angles",
                        spy("angles", sh._tail_phase_angles))
    monkeypatch.setattr(cycle_hi, "global_phase",
                        spy("phase", cycle_hi.global_phase))
    T3 = 3
    K, _, (ang, hs, phis, u) = _inputs("xy", 2, lambda K: (T3 * K, Lr),
                                       Lr=Lr)
    ang = torch.cat([ang, ang[-1:]])                             # T = 3
    kw = dict(L=Lr, T=T3, K=K, p=P, q=Lr - 6, ancilla_factor=1.0)
    sh.make_sharded_autocorr_forward_general(_port_mesh(), **kw)(
        ang, hs, phis, u)
    assert calls == {"angles": 1, "phase": 0}
    u = _inputs("xy", 2, lambda K: (2 * T3, K, Lr), Lr=Lr)[2][3]
    sh.make_sharded_echo_general(_port_mesh(), **kw)(ang, hs, phis, u, 1)
    assert calls == {"angles": 2, "phase": 0}


def test_launch_runs_split_a_group(monkeypatch):
    """A trajectory group runs in launches of at most ``_launch_traj``
    trajectories (the shard states of a run, doubled for the exchange,
    within KERNEL_STATE_BYTES: one at L_loc = 29 and 30 with a card a
    shard); a group cut into runs of one gives what the whole group
    gives."""
    cards = pmesh.Mesh([torch.device("cuda", i) for i in range(2)], 1, 2)
    assert [sh._launch_traj(cards, b) for b in (30, 29, 28, 27, 24, 23)] == [
        1, 1, 2, 4, 32, 64]
    mesh = _port_mesh(2, 2)
    u = torch.arange(6 * 3).reshape(6, 3)
    runs = sh._traj_groups(mesh, u, None, 0.5, chunk=2)
    assert [(t, c, r[:, 0].tolist()) for t, r, c in runs] == [
        (0, 2, [0, 3]), (0, 1, [6]), (1, 2, [9, 12]), (1, 1, [15])]
    assert [c for _, _, c in sh._traj_groups(mesh, None, 6, 0.0)] == [3, 3]
    K, _, args = _inputs("xy", 3, lambda K: (T * K, 18))
    kw = dict(L=18, T=T, K=K, p=P, q=9, ancilla_factor=1.0)
    whole = sh.make_sharded_autocorr_forward_general(_port_mesh(2), **kw)(
        *args)
    monkeypatch.setattr(sh, "KERNEL_STATE_BYTES", 16 << 17)  # one a run
    split = sh.make_sharded_autocorr_forward_general(_port_mesh(2), **kw)(
        *args)
    torch.testing.assert_close(split, whole, atol=1e-6, rtol=0)


def test_launch_runs_count_the_shards_that_share_a_device():
    """Shards that share a card share its budget: n_amp shards of one group
    on one card (``--num_devices`` over fewer cards) cut the run n_amp
    times; the device that holds most shards sets it."""
    one = torch.device("cuda", 0)
    assert sh._launch_traj(pmesh.Mesh([one] * 8, 1, 8), 24) == 4
    assert sh._launch_traj(pmesh.Mesh([one] * 2, 1, 2), 27) == 2
    assert sh._launch_traj(pmesh.Mesh([one] * 2, 1, 2), 29) == 1
    split = pmesh.Mesh([one, torch.device("cuda", 1), one,
                        torch.device("cuda", 1)], 1, 4)
    assert sh._launch_traj(split, 24) == 16
    lopsided = pmesh.Mesh([one, one, one, torch.device("cuda", 1)], 1, 4)
    assert sh._launch_traj(lopsided, 24) == 10
    # the traj groups run one after the other: a card that holds one shard
    # of each group holds one run's shard at a time
    assert sh._launch_traj(pmesh.make_mesh(
        2, 2, devices=[one, torch.device("cuda", 1)] * 2), 24) == 32


def test_cli_sharded_hi_route(hi_route, tmp_path, caplog):
    """``--num_devices 2 autocorr --sharded --n_amp 2`` of the x drive at
    L=23 (L_loc 22) with MIN_ROUTE_L at 22: engine=cycle_hi, the plain
    versions of K9a/K9b and nothing of K8; the reference-named CSV is
    written; no kernel is launched on the CPU."""
    profiling.reset_counters()
    with caplog.at_level(logging.INFO, logger="dtc_tpu_torch"):
        assert cli.main(["--num_devices", "2", "autocorr", "--device", "cpu",
                         "--sharded", "--n_amp", "2", "--L", str(L), "--tf",
                         "2", "--n_trajectories", "1", "--out_dir",
                         str(tmp_path / "out"), "--disorder_dir",
                         str(tmp_path)]) == 0
    assert "sharded_sweep: engine=cycle_hi mesh=(1,2)" in caplog.text
    assert len(os.listdir(tmp_path / "out")) == 1
    assert hi_route.get("hi_cycle_forward_apply_ref", 0) > 0
    assert hi_route.get("hi_cycle_inverse_apply_ref", 0) > 0
    assert not any(hi_route.get(name) for name in K8_REFS)
    assert not profiling.LAUNCHES
    assert not profiling.PLAIN_ON_CUDA


def test_engines_refuse_outside_the_range():
    """17 <= L_loc <= 30 and q < L_loc, as the reference's engines; the
    entries below refuse L_loc < 22 themselves."""
    with pytest.raises(ValueError, match="17 <="):
        sh.make_sharded_echo_kernel(_port_mesh(2), L=32, T=2, p=0.0, q=9)
    with pytest.raises(ValueError, match="17 <="):
        sh.make_sharded_autocorr_forward_general(_port_mesh(2), L=32, T=2,
                                                 K=1, p=0.0, q=9)
    with pytest.raises(ValueError, match="shard-local probe"):
        sh.make_sharded_echo_general(_port_mesh(2), L=31, T=2, K=1, p=0.0,
                                     q=30)
    for maker in (sh.make_sharded_autocorr_forward_kernel,
                  sh.make_sharded_echo_kernel):
        maker(_port_mesh(2), L=31, T=2, p=0.0, q=29)  # L_loc 30: builds
    assert sh.use_hi(24) and sh.use_hi(30) and not sh.use_hi(23)
