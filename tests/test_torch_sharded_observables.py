"""The sharded observables engine and the sharded energy sweep against the
reference (CPU).

The port's ``make_sharded_observables`` runs on a mesh of 8 logical CPU
devices, the reference's on the 8 virtual CPU devices of
``tests/conftest.py``, fed the same uniforms: JAX's ``uniform(key, (T, K,
L))`` of each trajectory key, the draw of the reference's
``sample_depolarizing_codes``. In complex128 the energy and every <Z_q>
agree within 1e-9, on 1 to 8 amplitude shards (a shard-id qubit's <X_q> is
a partner exchange). ``run_energy_sharded`` writes the reference's CSV
name and header, and its values agree on the reference's own trajectory
keys when both sides run complex128 (the reference's runs complex64
whatever the config says, so the test hands it the complex128 engine).
"""

import functools
import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dtc_tpu.experiments import sharded_run as j_sharded_run
from dtc_tpu.io.disorder import generate_disorder
from dtc_tpu.models.drives import build_kick_schedule as j_sched
from dtc_tpu.models.hamiltonian import hamiltonian_terms as j_terms
from dtc_tpu.parallel.mesh import make_mesh as j_make_mesh
from dtc_tpu.parallel.sharded import make_sharded_observables as j_obs
from dtc_tpu.utils.config import SimConfig
from dtc_tpu_torch.experiments import sharded_run
from dtc_tpu_torch.parallel import sharded as sh
from dtc_tpu_torch.parallel.mesh import make_mesh
from dtc_tpu_torch.utils.cli import main as cli_main
from dtc_tpu_torch.utils.config import SimConfig as PortConfig

torch.set_num_threads(2)
TOL = 1e-9


def _uniforms(keys, shape):
    return np.asarray(jax.vmap(lambda k: jax.random.uniform(
        k, shape, dtype=jnp.float32))(keys))


@pytest.mark.parametrize("p", [0.0, 0.12])
@pytest.mark.parametrize("L,n_amp,pol", [(6, 1, "xy"), (6, 2, "x"),
                                         (7, 4, "y"), (8, 8, "xy"),
                                         (6, 8, "circular_left")])
def test_sharded_observables_match_reference(L, n_amp, pol, p):
    """E(t) and <Z_q(t)>, trajectory-averaged over the mesh's traj
    groups, two trajectories a group; n_amp = 8 at L=6 leaves 3 local
    qubits, so half the <X_q> are shard-id exchanges."""
    T = 4
    hs, phis = generate_disorder(L, 1, seed=3)
    hs, phis = hs[0, :L], phis[0, :L - 1]
    sched = j_sched(pol, 0.97, T)
    K = sched.K
    groups = 8 // n_amp
    keys = jax.random.split(jax.random.PRNGKey(L + n_amp), 2 * groups)
    terms = j_terms(L, 0.97, hs, phis, "full")
    jfn = j_obs(j_make_mesh(n_amp=n_amp, n_traj=groups,
                            devices=jax.devices()[:8]),
                L=L, T=T, K=K, p=p, dtype=jnp.complex128)
    e_j, z_j = jfn(sched.angles, jnp.asarray(hs), jnp.asarray(phis),
                   terms.hs, terms.phis, jnp.asarray(float(terms.x_coeff)),
                   keys)
    u = _uniforms(keys, (T, K, L)).reshape(2 * groups, T * K, L)
    fn = sh.make_sharded_observables(
        make_mesh(n_amp, groups, devices=["cpu"] * 8), L=L, T=T, K=K, p=p,
        dtype=torch.complex128)
    e, z = fn(torch.tensor(np.asarray(sched.angles)), torch.tensor(hs),
              torch.tensor(phis), torch.tensor(np.asarray(terms.hs)),
              torch.tensor(np.asarray(terms.phis)), float(terms.x_coeff),
              torch.tensor(u) if p > 0 else None, n_traj=2 * groups)
    assert e.shape == (T,) and z.shape == (T, L)
    assert e.dtype == z.dtype == torch.float64
    np.testing.assert_allclose(e.numpy(), np.asarray(e_j), atol=TOL, rtol=0)
    np.testing.assert_allclose(z.numpy(), np.asarray(z_j), atol=TOL, rtol=0)


def test_sharded_observables_without_x_and_with_a_seed(monkeypatch):
    """A component without an X term (x_coeff = 0) takes no X sum and
    still matches the reference; without uniforms a noisy run draws its
    block from a generator seeded with ``seed``."""
    L, T, p = 6, 3, 0.12
    hs, phis = generate_disorder(L, 1, seed=1)
    hs, phis = hs[0, :L], phis[0, :L - 1]
    sched = j_sched("x", 0.97, T)
    keys = jax.random.split(jax.random.PRNGKey(5), 8)
    terms = j_terms(L, 0.97, hs, phis, "z_zz")
    assert float(terms.x_coeff) == 0.0
    e_j, z_j = j_obs(j_make_mesh(n_amp=2, n_traj=4,
                                 devices=jax.devices()[:8]),
                     L=L, T=T, K=1, p=p, dtype=jnp.complex128)(
        sched.angles, jnp.asarray(hs), jnp.asarray(phis), terms.hs,
        terms.phis, jnp.asarray(0.0), keys)
    calls = []
    expect_x = sh.expect_x
    monkeypatch.setattr(sh, "expect_x",
                        lambda *a: calls.append(1) or expect_x(*a))
    mesh = make_mesh(2, 4, devices=["cpu"] * 8)
    args = (torch.tensor(np.asarray(sched.angles)), torch.tensor(hs),
            torch.tensor(phis), torch.tensor(np.asarray(terms.hs)),
            torch.tensor(np.asarray(terms.phis)))
    e, z = sh.make_sharded_observables(
        mesh, L=L, T=T, K=1, p=p, dtype=torch.complex128)(
        *args, 0.0, torch.tensor(_uniforms(keys, (T, 1, L)).reshape(8, T, L)))
    assert calls == []
    np.testing.assert_allclose(e.numpy(), np.asarray(e_j), atol=TOL, rtol=0)
    np.testing.assert_allclose(z.numpy(), np.asarray(z_j), atol=TOL, rtol=0)
    sh.make_sharded_observables(mesh, L=L, T=T, K=1, p=0.0)(
        *args, 1.0, n_traj=4)
    assert calls
    fn = sh.make_sharded_observables(mesh, L=L, T=T, K=1, p=0.3)
    a = fn(*args, 1.0, n_traj=8, seed=2)
    b = fn(*args, 1.0, n_traj=8, seed=2)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_sharded_observables_in_runs_match_the_whole_group(monkeypatch):
    """A traj group runs in runs of at most ``_launch_traj(mesh, L_loc,
    OBS_AMP_BYTES)`` trajectories; runs of one give what the whole group
    gives. At L=24 on 2 shards of one card, 8 trajectories a run."""
    card = torch.device("cuda", 0)
    assert sh._launch_traj(make_mesh(2, 1, devices=[card] * 2), 23,
                           sh.OBS_AMP_BYTES) == 8
    L, T, p = 7, 3, 0.2
    hs, phis = (torch.tensor(a[0]) for a in generate_disorder(L, 1, seed=6))
    ang = torch.tensor(np.asarray(j_sched("xy", 0.97, T).angles))
    terms = j_terms(L, 0.97, np.asarray(hs[:L]), np.asarray(phis[:L - 1]),
                    "full")
    u = torch.rand((6, T * 2, L), generator=torch.Generator().manual_seed(1))
    mesh = make_mesh(2, 2, devices=["cpu"] * 4)
    args = (ang, hs[:L], phis[:L - 1], torch.tensor(np.asarray(terms.hs)),
            torch.tensor(np.asarray(terms.phis)), float(terms.x_coeff), u)
    kw = dict(L=L, T=T, K=2, p=p, dtype=torch.complex128)
    whole = sh.make_sharded_observables(mesh, **kw)(*args)
    monkeypatch.setattr(sh, "KERNEL_STATE_BYTES",
                        sh.OBS_AMP_BYTES << (L - 1))  # one a run
    assert sh._launch_traj(mesh, L - 1, sh.OBS_AMP_BYTES) == 1
    split = sh.make_sharded_observables(mesh, **kw)(*args)
    for x, y in zip(split, whole):
        torch.testing.assert_close(x, y, atol=1e-12, rtol=0)


def test_run_energy_sharded_matches_reference(tmp_path, monkeypatch):
    """CSV name, folder and header byte for byte; energies and per-qubit Z
    at p=0 and p=0.05 on the reference's trajectory keys, both sides in
    complex128; the mesh shape."""
    L, T, nprobs = 6, 4, (0.0, 0.05)
    hs, phis = generate_disorder(L, 2, seed=4)
    cfg = dict(L=L, tf=T, inst=2, n_trajectories=4, g=0.97)
    monkeypatch.setattr(j_sharded_run, "make_sharded_observables",
                        functools.partial(j_obs, dtype=jnp.complex128))
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    monkeypatch.chdir(tmp_path / "jax")
    ref = j_sharded_run.run_energy_sharded(SimConfig(**cfg), hs, phis,
                                           n_amp=2, nprobs=nprobs)
    # the reference's keys: split(fold_in(PRNGKey(seed), i), n_traj)
    key = jax.random.PRNGKey(0)
    u = np.stack([_uniforms(jax.random.split(jax.random.fold_in(key, i), 4),
                            (T, 1, L)).reshape(4, T, L) for i in range(2)])
    monkeypatch.chdir(tmp_path / "port")
    got = sharded_run.run_energy_sharded(
        PortConfig(**cfg, dtype="complex128"), hs, phis, n_amp=2,
        devices=["cpu"] * 8, nprobs=nprobs, uniforms=u)
    assert got["csv_path"] == ref["csv_path"]
    assert os.path.dirname(got["csv_path"]) == "energy-data_L6-sharded"
    with open(tmp_path / "jax" / ref["csv_path"], "rb") as f:
        head = f.readline()
    with open(got["csv_path"], "rb") as f:
        assert f.readline() == head
    assert got["mesh_shape"] == ref["mesh_shape"] == {"traj": 4, "amp": 2}
    for k in ("energy_p_0", "energy_p_0.05"):
        np.testing.assert_allclose(got[k], ref[k], atol=TOL, rtol=0)
    for p in nprobs:
        np.testing.assert_allclose(got["per_qubit_z"][p],
                                   ref["per_qubit_z"][p], atol=TOL, rtol=0)


def test_energy_sharded_through_the_cli(tmp_path, capsys, caplog):
    """``--num_devices 4 energy --device cpu --sharded --n_amp 2``: the
    route is logged, the mesh printed, and the CSV holds what
    run_energy_sharded returns for the same config."""
    argv = ["--num_devices", "4", "energy", "--device", "cpu", "--sharded",
            "--n_amp", "2", "--L", "6", "--tf", "3", "--n_trajectories", "4",
            "--nprobs", "0,0.05", "--out_dir", str(tmp_path / "cli"),
            "--disorder_dir", str(tmp_path)]
    with caplog.at_level(logging.INFO, logger="dtc_tpu_torch"):
        assert cli_main(argv) == 0
    assert "sharded_energy: engine=sharded_obs mesh=(2,2)" in caplog.text
    out = capsys.readouterr().out
    assert "mesh={'traj': 2, 'amp': 2}" in out
    path = out.split("wrote ")[-1].strip()
    r = sharded_run.run_energy_sharded(
        PortConfig(L=6, tf=3, n_trajectories=4), n_amp=2,
        devices=["cpu"] * 4, nprobs=(0.0, 0.05), write=False,
        disorder_dir=str(tmp_path))
    with open(path) as f:
        rows = [line.split(",") for line in f.read().splitlines()[1:]]
    for col, key in ((1, "energy_p_0"), (2, "energy_p_0.05")):
        np.testing.assert_allclose([float(x[col]) for x in rows], r[key],
                                   atol=1e-6, rtol=0)
