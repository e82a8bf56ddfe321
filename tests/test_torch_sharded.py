"""Amplitude sharding on the single-controller mesh against the reference.

The port's engines (``dtc_tpu_torch/parallel/sharded.py``) run on a mesh
of 8 logical CPU devices, the reference's on the 8 virtual CPU devices of
``tests/conftest.py``; both are fed the same uniforms, drawn per trajectory
key as the reference's engines draw them. On the CPU the cycle-kernel
engines run the plain versions of K8a-d. They are held against the
reference's sigma-frame sharded engines, the reference's own plain
reference for its cycle kernels (``tests/test_sharded_kernel.py``), within
1e-4 at every time point, with ancilla_factor=1 on both sides so that the
values are O(1). The general drives (y, xy, circular_left) are in
``test_torch_sharded_general.py``.
"""

import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dtc_tpu.experiments.sharded_run import (
    run_autocorr_sharded as j_run_sharded,
)
from dtc_tpu.io.disorder import generate_disorder
from dtc_tpu.models.drives import build_kick_schedule as j_sched
from dtc_tpu.parallel.mesh import make_mesh as j_make_mesh
from dtc_tpu.parallel.sharded import (
    make_sharded_autocorr_forward as j_forward,
)
from dtc_tpu.parallel.sharded import make_sharded_echo as j_echo
from dtc_tpu.utils.config import SimConfig
from dtc_tpu_torch.experiments import sharded_run
from dtc_tpu_torch.models.drives import build_kick_schedule
from dtc_tpu_torch.ops import resident_blocked as rb
from dtc_tpu_torch.ops.params import forward_rows
from dtc_tpu_torch.ops.paulis import apply_pauli_string
from dtc_tpu_torch.parallel import mesh as pmesh
from dtc_tpu_torch.parallel import sharded as sh
from dtc_tpu_torch.utils import cli
from dtc_tpu_torch.utils import profiling
from dtc_tpu_torch.utils.config import SimConfig as PortConfig
from dtc_tpu_torch.utils.convert import from_reference

torch.set_num_threads(2)
TOL = 1e-4


def _mesh(n_amp, n_traj):
    return pmesh.make_mesh(n_amp, n_traj, devices=["cpu"] * 8)


def _inputs(L, pol, T, n, shape, seed=11, **kw):
    """(JAX args (angles, hs, phis, keys), port args (angles, hs, phis,
    uniforms)): n trajectory keys and their uniforms of ``shape``."""
    hs, phis = generate_disorder(L, 1, seed=5)
    hs, phis = hs[:, :L], phis[:, :L - 1]
    sched = j_sched(pol, 0.97, T, **kw)
    keys = jax.random.split(jax.random.PRNGKey(seed), n)
    u = np.asarray(jax.vmap(lambda k: jax.random.uniform(
        k, shape, dtype=jnp.float32))(keys))
    h, ph, ang, uu = from_reference(hs, phis, np.asarray(sched.angles), u)
    jargs = (sched.angles, jnp.asarray(hs[0]), jnp.asarray(phis[0]), keys)
    return jargs, (ang, h[0], ph[0], uu)


X_CASES = [(18, 2, 2, None), (19, 4, 2, None), (18, 2, 2, 15),
           (19, 4, 2, 16)]


@pytest.mark.parametrize("L,n_amp,n_traj,q", X_CASES)
def test_x_cycle_forward_matches_reference(L, n_amp, n_traj, q):
    """K8a's engine: L=18/n_amp=2 has the boundary bond and one global
    kick; L=19/n_amp=4 adds a shard-shard bond and a second exchange bit;
    q=15 is a probe in the high local bits, q=16 on the local top bit,
    where the boundary bond's angle rides the folded row."""
    T, p = 3, 0.6
    q = L // 2 if q is None else q
    jargs, args = _inputs(L, "x", T, 2 * n_traj, (T, L))
    want = np.asarray(j_forward(j_make_mesh(n_amp=n_amp, n_traj=n_traj),
                                L=L, T=T, K=1, p=p, q=q,
                                ancilla_factor=1.0)(*jargs))
    got = sh.make_sharded_autocorr_forward_kernel(
        _mesh(n_amp, n_traj), L=L, T=T, p=p, q=q, ancilla_factor=1.0)(*args)
    assert got.shape == (T,)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL)


@pytest.mark.parametrize("L,n_amp,q", [(18, 2, 9), (19, 4, 15),
                                       (18, 2, 16)])
def test_x_cycle_echo_matches_reference(L, n_amp, q):
    """K8a/K8b's echo engine at every t of (0, 1, 2, T): the turnaround
    conjugation, the global diagonal in each inverse step's folded row
    before its local kick, the shard-bit kicks after it, the previous
    event's Z word zeroed at step t; q=16 on the local top bit."""
    T, p, n_traj = 3, 0.6, 2
    jargs, args = _inputs(L, "x", T, 2 * n_traj, (2 * T, 1, L))
    ref = j_echo(j_make_mesh(n_amp=n_amp, n_traj=n_traj), L=L, T=T, K=1, p=p,
                 q=q, ancilla_factor=1.0)
    port = sh.make_sharded_echo_kernel(_mesh(n_amp, n_traj), L=L, T=T, p=p,
                                       q=q, ancilla_factor=1.0)
    for t in (0, 1, 2, T):
        want = float(ref(*jargs, jnp.asarray(t)))
        assert abs(float(port(*args, t)) - want) < TOL, t


SIGMA_CASES = [("x", 6, 1, 8), ("x", 6, 4, 2), ("x", 6, 8, 1),
               ("y", 6, 8, 1), ("xy", 8, 4, 2)]


@pytest.mark.parametrize("pol,L,n_amp,n_traj", SIGMA_CASES)
def test_sigma_route_matches_reference(pol, L, n_amp, n_traj):
    """The sigma-frame engines (the route of every shape the kernel gates
    refuse), complex128 as the reference's tests run them."""
    T, p, q = 5, 0.12, L // 2
    K = 2 if pol == "xy" else 1
    kw = dict(L=L, T=T, K=K, p=p, q=q, ancilla_factor=1.0, has_y=pol != "x")
    jargs, args = _inputs(L, pol, T, 8, (T * K, L))
    want = np.asarray(j_forward(j_make_mesh(n_amp=n_amp, n_traj=n_traj),
                                dtype=jnp.complex128, **kw)(*jargs))
    got = sh.make_sharded_autocorr_forward(
        _mesh(n_amp, n_traj), dtype=torch.complex128, **kw)(*args)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL)
    jargs, args = _inputs(L, pol, T, 8, (2 * T, K, L))
    ref = j_echo(j_make_mesh(n_amp=n_amp, n_traj=n_traj),
                 dtype=jnp.complex128, **kw)
    port = sh.make_sharded_echo(_mesh(n_amp, n_traj), dtype=torch.complex128,
                                **kw)
    for t in (0, 2, 4):
        want = float(ref(*jargs, jnp.asarray(t)))
        assert abs(float(port(*args, t)) - want) < TOL, t


def test_noiseless_invariants():
    """p=0: the echo is 1 at every t, and the sharded forward equals K1's
    plain version on the whole state (L=18, 2 shards)."""
    L, T, q = 18, 3, 9
    _, (ang, hs, phis, _) = _inputs(L, "x", T, 1, (1,))
    mesh = _mesh(2, 2)
    echo = sh.make_sharded_echo_kernel(mesh, L=L, T=T, p=0.0, q=q)
    for t in range(T + 1):
        assert abs(float(echo(ang, hs, phis, None, t, n_traj=2)) - 1) < 1e-5
    a = sh.make_sharded_autocorr_forward_kernel(mesh, L=L, T=T, p=0.0, q=q)(
        ang, hs, phis, None, n_traj=2)
    rows, sig = forward_rows(None, hs[None], phis[None], L=L, T=T, p=0.0,
                             batch=(1,))
    want = rb.blocked_forward_batch_ref(rows, sig, float(ang[0, 0, 0]), L=L,
                                        q=q)[0]
    np.testing.assert_allclose(a.numpy(), want.numpy(), atol=TOL)
    assert abs(float(a[0]) - 1.0) < 1e-6


def test_pauli_string_on_shards_matches_whole_state():
    """``_sharded_pauli_string`` on 4 shards equals the string applied to
    the whole state, with X parts on local and global bits."""
    L, n = 6, 3
    gen = torch.Generator().manual_seed(2)
    psi = torch.randn((n, 1 << L), dtype=torch.complex128, generator=gen)
    xm = torch.tensor([0b110001, 0b000110, 0b101010])
    zm = torch.tensor([0b011001, 0b100000, 0b111111])
    ny = torch.tensor([1, 2, 3])
    mesh = _mesh(4, 2)
    shards = list(psi.reshape(n, 4, 1 << (L - 2)).unbind(1))
    got = sh._sharded_pauli_string(mesh, shards, xm, zm, ny, local_bits=L - 2)
    want = apply_pauli_string(psi, xm, zm, ny)
    torch.testing.assert_close(torch.stack(got, 1).reshape(n, -1), want)


def test_mesh_shapes_and_collectives():
    assert _mesh(4, None).shape == {"traj": 2, "amp": 4}
    assert _mesh(8, 1).shape == {"traj": 1, "amp": 8}
    assert pmesh.amp_bits(_mesh(4, 2)) == 2
    with pytest.raises(ValueError, match="power of two"):
        _mesh(3, 1)
    with pytest.raises(ValueError, match="need 16 devices"):
        _mesh(8, 2)
    cpu = torch.device("cpu")
    assert pmesh.logical_devices(3, "cpu") == [cpu] * 3
    assert pmesh.visible_devices("cpu") == [cpu]
    mesh = _mesh(4, 2)
    assert mesh.axis_index("amp") == [0, 1, 2, 3]
    assert mesh.device(1, 3) == cpu
    shards = [torch.full((2,), float(a)) for a in range(4)]
    partners = mesh.xor_partners(shards, 1)
    assert [float(x[0]) for x in partners] == [2.0, 3.0, 0.0, 1.0]
    assert partners[0] is shards[2]  # same device: no copy, the old tensor
    assert float(mesh.psum(shards)[0]) == 6.0


def test_kernel_engines_refuse_what_they_do_not_run():
    mesh = _mesh(2, 2)
    with pytest.raises(ValueError, match="17 <="):
        sh.make_sharded_autocorr_forward_kernel(_mesh(8, 1), L=18, T=3,
                                                p=0.0, q=9)
    with pytest.raises(ValueError, match="shard-local probe"):
        sh.make_sharded_echo_kernel(mesh, L=18, T=3, p=0.0, q=17)
    for maker in (sh.make_sharded_autocorr_forward_kernel,
                  sh.make_sharded_echo_kernel):
        # L_loc 24..30 builds on the streamed per-shard kernels (K9a/K9b)
        maker(mesh, L=25, T=3, p=0.0, q=9)
        with pytest.raises(ValueError, match="<= 30"):
            maker(mesh, L=32, T=3, p=0.0, q=9)
    for maker in (sh.make_sharded_autocorr_forward_general,
                  sh.make_sharded_echo_general):
        # device-noise rows replace the depolarizing draw: p must be 0
        with pytest.raises(ValueError, match="p=0"):
            maker(mesh, L=18, T=3, K=1, p=0.1, q=9, device=(1, 2, 2))
        maker(mesh, L=18, T=3, K=1, p=0.0, q=9, device=(1, 2, 2))
        maker(mesh, L=26, T=3, K=1, p=0.0, q=9)  # K10's shard-local forms
    _, (ang, hs, phis, _) = _inputs(18, "y", 3, 1, (1,))
    fn = sh.make_sharded_autocorr_forward_kernel(mesh, L=18, T=3, p=0.0, q=9)
    with pytest.raises(ValueError, match="constant x-only"):
        fn(ang, hs, phis, None, n_traj=2)
    with pytest.raises(ValueError, match="uniforms"):
        sh.make_sharded_autocorr_forward_kernel(mesh, L=18, T=3, p=0.1, q=9)(
            build_kick_schedule("x", 0.97, 3).angles, hs, phis)


def test_routes():
    cfg = PortConfig(L=19, tf=3)
    x, y = (build_kick_schedule(pol, 0.97, 3) for pol in ("x", "y"))
    mesh2 = _mesh(2, 4)
    assert sharded_run.sharded_route(mesh2, x, cfg) == "cycle"
    assert sharded_run.sharded_route(mesh2, y, cfg) == "cycle_general"
    assert sharded_run.sharded_route(mesh2, x,
                                     cfg.replace(L=12)) == "sharded_sigma"
    assert sharded_run.sharded_route(  # q = 18 is a shard bit
        mesh2, x, cfg.replace(qubit=18)) == "sharded_sigma"
    # the reference's routing at L_loc >= 24: x takes K9 to L_loc = 29,
    # every other drive and x at L_loc = 30 the sigma-frame engines
    for L in range(25, 32):
        assert sharded_run.sharded_route(mesh2, y, cfg.replace(
            L=L)) == "sharded_sigma"
        assert sharded_run.sharded_route(mesh2, x, cfg.replace(L=L)) == (
            "cycle_hi" if L <= 30 else "sharded_sigma")
    assert sharded_run._auto_mesh(6, devices=["cpu"] * 8).shape == {
        "traj": 1, "amp": 8}
    # run_energy_sharded (once refused) returns the reference's keys
    r = sharded_run.run_energy_sharded(
        cfg.replace(L=6, n_trajectories=2), n_amp=2, devices=["cpu"] * 2,
        nprobs=(0.0, 0.1), write=False)
    assert set(r) == {"time", "energy_p_0", "energy_p_0.1", "per_qubit_z",
                      "mesh_shape"}
    assert r["mesh_shape"] == {"traj": 1, "amp": 2}
    assert set(r["per_qubit_z"]) == {0.0, 0.1}


def test_run_names_and_columns_match_reference(tmp_path, monkeypatch):
    """run_autocorr_sharded: the CSV's name, folder and header are the
    reference's; at p=0 (no noise draws) the values agree too."""
    hs, phis = generate_disorder(6, 1, seed=3)
    for noisy in (0, 1):
        cfg = dict(L=6, tf=4, g=0.97, inst=1, n_trajectories=4,
                   use_noise=noisy)
        j_dir, p_dir = tmp_path / f"jax{noisy}", tmp_path / f"port{noisy}"
        j_dir.mkdir()
        p_dir.mkdir()
        monkeypatch.chdir(j_dir)
        j = j_run_sharded(SimConfig(**cfg), hs, phis, n_amp=2)
        monkeypatch.chdir(p_dir)
        r = sharded_run.run_autocorr_sharded(
            PortConfig(**cfg), hs, phis, n_amp=2, devices=["cpu"] * 8)
        assert r["csv_path"] == j["csv_path"]
        assert os.path.dirname(r["csv_path"]) == "autocorr_data_L6_sharded"
        with open(j_dir / j["csv_path"]) as f:
            j_head = f.readline()
        with open(p_dir / r["csv_path"]) as f:
            assert f.readline() == j_head
        assert r["mesh_shape"] == j["mesh_shape"] == {"traj": 4, "amp": 2}
        if not noisy:
            for k in ("av_autocorr", "av_autocorr_echo"):
                np.testing.assert_allclose(r[k], j[k], atol=1e-5)


def test_cli_sharded_routes(tmp_path, capsys, caplog):
    """``--num_devices N autocorr --sharded`` on the CPU: the x drive at
    L_loc=17 takes the x cycle kernels' plain versions (engine=cycle), xy
    the lab-frame ones (engine=cycle_general); the mesh is printed and the
    reference-named CSV written; no kernel is launched."""
    profiling.reset_counters()
    for pol, route in (("x", "cycle"), ("xy", "cycle_general")):
        out = tmp_path / pol
        caplog.clear()
        with caplog.at_level(logging.INFO, logger="dtc_tpu_torch"):
            assert cli.main(["--num_devices", "2", "autocorr", "--device",
                             "cpu", "--sharded", "--n_amp", "2", "--L", "18",
                             "--tf", "3", "--n_trajectories", "2",
                             "--polarization", pol, "--out_dir", str(out),
                             "--disorder_dir", str(tmp_path)]) == 0
        assert f"sharded_sweep: engine={route} mesh=(1,2)" in caplog.text
        printed = capsys.readouterr().out
        assert "mesh={'traj': 1, 'amp': 2}" in printed
        assert len(os.listdir(out)) == 1
    assert not profiling.LAUNCHES
    assert not profiling.PLAIN_ON_CUDA
