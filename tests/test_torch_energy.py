"""The port's energy drivers and CLI against the JAX reference (CPU).

With the reference's own per-trajectory uniforms injected (keys
``split(fold_in(split(PRNGKey(seed), inst)[i], 0), n_traj)``, one chunk on
both sides), ``run_energy``, ``run_ham_comparison`` and ``run_per_qubit_z``
agree with the reference's:
- at L=6, both through their eager engines: 1e-5 (complex64 rounding);
- at L=14, the port through the plain K5 and the reference (on the CPU)
  through its eager engine: energies per qubit within
  1e-4 * (sum|th| + sum|tph|) / L (f32 sums of tens in another order) and
  <Z_q> within 1e-4.
Against the exact density matrix (``tests/exact_oracle.py``) at L=3, p=0,
complex128: 1e-10. Estimator noise, names, CSV headers and time columns,
and the journal format are equal exactly.
"""

import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import exact_oracle as oracle
from dtc_tpu.experiments import energy as j_energy
from dtc_tpu.io import naming as j_naming
from dtc_tpu.io.disorder import generate_disorder
from dtc_tpu.utils import checkpoints as j_checkpoints
from dtc_tpu.utils.config import SimConfig
from dtc_tpu_torch.experiments import energy
from dtc_tpu_torch.io import naming
from dtc_tpu_torch.ops import observables as obs
from dtc_tpu_torch.utils import checkpoints
from dtc_tpu_torch.utils.cli import main as cli_main
from dtc_tpu_torch.utils.config import SimConfig as PortConfig

torch.set_num_threads(2)


def _reference_uniforms(cfg, K):
    """The reference's per-trajectory uniforms of one chunk,
    (inst, n_traj, T*K, L)."""
    ki = jax.random.split(jax.random.PRNGKey(cfg.seed), cfg.inst)
    draw = jax.vmap(lambda k: jax.random.uniform(
        k, (cfg.tf * K, cfg.L), dtype=jnp.float32))
    return np.stack([np.array(draw(jax.random.split(
        jax.random.fold_in(k, 0), cfg.n_trajectories))) for k in ki])


def _disorder(cfg):
    hs, phis = generate_disorder(cfg.L, cfg.inst, seed=21)
    return hs[:, :cfg.L], phis[:, :cfg.L - 1]


def _same_csv(ours, ref, atol):
    """Same file name, header and time column (bytes); values within
    ``atol``."""
    assert os.path.basename(ours) == os.path.basename(ref)
    with open(ours) as f, open(ref) as g:
        a, b = f.read().splitlines(), g.read().splitlines()
    assert a[0] == b[0] and len(a) == len(b)
    assert [r.split(",")[0] for r in a] == [r.split(",")[0] for r in b]
    got = np.array([[float(x) for x in r.split(",")] for r in a[1:]])
    want = np.array([[float(x) for x in r.split(",")] for r in b[1:]])
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)


def _energy_atol(hs, phis, L):
    """1e-4 * (sum|th| + sum|tph|) / L: the bound on E/L at L=14."""
    return 1e-4 * (np.abs(hs).sum(-1) + np.abs(phis).sum(-1)).max() / L


DRIVER_CASES = [(6, "x"), (14, "x"), (14, "xy")]


@pytest.mark.parametrize("L,pol", DRIVER_CASES)
def test_run_energy_matches_reference(L, pol, tmp_path):
    kw = dict(L=L, tf=5, inst=2 if L < 14 else 1, n_trajectories=3,
              polarization=pol, estimator_shots=256, seed=3)
    cfg = SimConfig(**kw)
    hs, phis = _disorder(cfg)
    nprobs = (0.0, 0.01, 0.1) if L < 14 else (0.0, 0.1)
    ref = j_energy.run_energy(cfg, hs, phis, nprobs=nprobs,
                              out_dir=str(tmp_path / "jax"))
    K = 1 if pol == "x" else 2
    got = energy.run_energy(PortConfig(**kw), hs, phis, nprobs=nprobs,
                            device="cpu", out_dir=str(tmp_path / "torch"),
                            uniforms=_reference_uniforms(cfg, K))
    e_tol = 1e-5 if L < 14 else _energy_atol(hs, phis, L)
    z_tol = 1e-5 if L < 14 else 1e-4
    _same_csv(got["csv_path"], ref["csv_path"], e_tol)
    for p in nprobs:
        np.testing.assert_allclose(got["per_qubit_z"][p],
                                   ref["per_qubit_z"][p], atol=z_tol, rtol=0)


@pytest.mark.parametrize("L", [6, 14])
def test_run_ham_comparison_matches_reference(L, tmp_path):
    kw = dict(L=L, tf=4, inst=1, n_trajectories=3, noise_prob=0.2,
              estimator_shots=1024 if L < 14 else 0, seed=5)
    cfg = SimConfig(**kw)
    hs, phis = _disorder(cfg)
    ref = j_energy.run_ham_comparison(cfg, hs, phis,
                                      out_dir=str(tmp_path / "jax"))
    got = energy.run_ham_comparison(
        PortConfig(**kw), hs, phis, device="cpu",
        out_dir=str(tmp_path / "torch"),
        uniforms=_reference_uniforms(cfg, 1))
    _same_csv(got["csv_path"], ref["csv_path"],
              1e-5 if L < 14 else _energy_atol(hs, phis, L))


@pytest.mark.parametrize("L,pol", [(6, "xy"), (14, "y")])
def test_run_per_qubit_z_matches_reference(L, pol, tmp_path):
    kw = dict(L=L, tf=4, inst=2, n_trajectories=2, noise_prob=0.1,
              polarization=pol, initial_state="neel")
    cfg = SimConfig(**kw)
    hs, phis = _disorder(cfg)
    ref = j_energy.run_per_qubit_z(cfg, hs, phis,
                                   out_dir=str(tmp_path / "jax"))
    got = energy.run_per_qubit_z(
        PortConfig(**kw), hs, phis, device="cpu",
        out_dir=str(tmp_path / "torch"),
        uniforms=_reference_uniforms(cfg, 1 if pol == "y" else 2))
    _same_csv(got["csv_path"], ref["csv_path"], 1e-5 if L < 14 else 1e-4)


def test_energy_noiseless_matches_exact_oracle(tmp_path):
    cfg = PortConfig(L=3, g=0.9, inst=1, tf=4, use_noise=0,
                     dtype="complex128")
    hs, phis = generate_disorder(cfg.L, 1, seed=9)
    r = energy.run_energy(cfg, hs, phis, nprobs=(0.0,), device="cpu",
                          out_dir=str(tmp_path))
    for t in range(cfg.tf):
        want = oracle.energy_dm(cfg.L, cfg.g, hs[0], phis[0], t, 0.0) / cfg.L
        np.testing.assert_allclose(r["energy_p_0"][t], want, atol=1e-10)


@pytest.mark.parametrize("shots", [0, 1, 1024])
def test_estimator_noise_equals_reference(shots):
    vals = np.random.default_rng(2).normal(size=(3, 7))
    for seed in (0, 5 * 1000003 + 100000):
        assert np.array_equal(
            energy.apply_estimator_noise(vals, shots, seed=seed),
            j_energy.apply_estimator_noise(vals, shots, seed=seed))


def test_energy_names_equal_reference():
    for kw in (dict(), dict(L=20, g=0.93, inst=3, noise_prob=0.1,
                            initial_state="neel", randomphi=0)):
        assert naming.energy_csv_name(PortConfig(**kw)) == \
            j_naming.energy_csv_name(SimConfig(**kw))
        assert naming.energy_folder_name(PortConfig(**kw)) == \
            j_naming.energy_folder_name(SimConfig(**kw))


def test_journal_reads_the_references_and_back(tmp_path):
    a = np.arange(12.0).reshape(3, 4)
    b = np.ones((2, 5, 3), np.float32)
    ours, theirs = str(tmp_path / "port.j"), str(tmp_path / "jax.j")
    j_checkpoints.SweepJournal(theirs).put("k1", a)
    j_checkpoints.SweepJournal(theirs).put("k2", b)
    checkpoints.SweepJournal(ours).put("k1", a)
    checkpoints.SweepJournal(ours).put("k2", b)
    with open(ours, "rb") as f, open(theirs, "rb") as g:
        assert f.read() == g.read()
    for cls, path in ((checkpoints.SweepJournal, theirs),
                      (j_checkpoints.SweepJournal, ours)):
        j = cls(path)
        assert j.keys() == ["k1", "k2"]
        assert np.array_equal(j.get("k1"), a) and np.array_equal(
            j.get("k2"), b)
    # a torn tail (a record cut mid-write) and a corrupt record are ignored
    with open(ours, "ab") as f:
        f.write(b"DTCJ\x02\x00\x00")
    assert checkpoints.SweepJournal(ours).keys() == ["k1", "k2"]
    with open(theirs, "rb") as f:
        blob = bytearray(f.read())
    blob[-1] ^= 0xFF
    with open(theirs, "wb") as f:
        f.write(bytes(blob))
    assert checkpoints.SweepJournal(theirs).keys() == ["k1"]


def test_checkpoint_resumes_only_the_same_engine_and_dtype(tmp_path,
                                                           monkeypatch):
    calls = []
    real = energy._energy_single_noise

    def counted(*a, **k):
        calls.append(a[0].dtype)
        return real(*a, **k)

    monkeypatch.setattr(energy, "_energy_single_noise", counted)
    journal = str(tmp_path / "energy.journal")
    cfg = PortConfig(L=4, tf=3, n_trajectories=2, noise_prob=0.1)
    kw = dict(nprobs=(0.0, 0.1), device="cpu", write=False,
              checkpoint_path=journal)
    first = energy.run_energy(cfg, **kw)
    assert len(calls) == 2
    again = energy.run_energy(cfg, **kw)
    assert len(calls) == 2  # resumed from the journal
    np.testing.assert_array_equal(first["energy_p_0.1"],
                                  again["energy_p_0.1"])
    energy.run_energy(cfg.replace(dtype="complex128"), **kw)
    assert calls[2:] == ["complex128"] * 2  # another dtype recomputes
    keys = checkpoints.SweepJournal(journal).keys()
    assert any(k.endswith("_engineeager_complex64") for k in keys)
    assert any(k.endswith("_engineeager_complex128") for k in keys)


def test_complex128_is_never_served_by_the_f32_kernel(caplog, monkeypatch):
    """At L=14 complex64 takes the observables route (K5's plain version
    here); complex128 the eager engine, even where K5 would fit."""
    seen = []
    real = obs.observables_forward_batch_ref

    def counted(*a, **k):
        seen.append(k["L"])
        return real(*a, **k)

    monkeypatch.setattr(obs, "observables_forward_batch_ref", counted)
    cfg = PortConfig(L=14, tf=2, n_trajectories=1, noise_prob=0.1)
    with caplog.at_level(logging.INFO, logger="dtc_tpu_torch"):
        energy.run_energy(cfg, nprobs=(0.1,), device="cpu", write=False)
        assert seen == [14] and "engine=obs" in caplog.text
        caplog.clear()
        energy.run_energy(cfg.replace(dtype="complex128"), nprobs=(0.1,),
                          device="cpu", write=False)
    assert seen == [14] and "engine=eager" in caplog.text
    assert energy.energy_engine(cfg, 1) == "obs"
    for bad in (dict(dtype="complex128"), dict(L=13), dict(L=24),
                dict(tf=obs.MAX_STEPS + 1)):
        assert energy.energy_engine(cfg.replace(**bad), 1) == "eager"


@pytest.mark.parametrize("fn", ["run_energy", "run_ham_comparison",
                                "run_per_qubit_z"])
def test_fakebackend_is_refused(fn):
    cfg = PortConfig(L=4, tf=2, use_fakebackend=1)
    with pytest.raises(NotImplementedError,
                       match="ROADMAP.md queue 3"):
        getattr(energy, fn)(cfg, device="cpu", write=False)


@pytest.mark.parametrize("command,prefix,header", [
    ("energy", "energy_data_", "time,energy_p_0,energy_p_0.1"),
    ("ham-comparison", "energy_ham_comparison_",
     "time,energy_full,energy_z_only,energy_zz_only,energy_x_only,"
     "energy_z_zz"),
    ("per-qubit-z", "per_qubit_z_", "time,z_q0,z_q1,z_q2,z_q3"),
])
def test_cli_energy_subcommands_on_cpu(command, prefix, header, tmp_path,
                                       caplog):
    argv = [command, "--device", "cpu", "--L", "4", "--tf", "3",
            "--n_trajectories", "2", "--out_dir", str(tmp_path),
            "--disorder_dir", str(tmp_path)]
    if command == "energy":
        argv += ["--nprobs", "0,0.1", "--checkpoint",
                 str(tmp_path / "j.journal")]
    with caplog.at_level(logging.INFO, logger="dtc_tpu_torch"):
        assert cli_main(argv) == 0
    csvs = [f for f in os.listdir(tmp_path) if f.startswith(prefix)]
    assert len(csvs) == 1
    with open(tmp_path / csvs[0]) as f:
        assert f.readline().strip() == header
    assert "engine=eager" in caplog.text
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        cli_main([*argv, "--use_fakebackend", "1"])


def test_energy_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA is available: the request is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        energy.run_energy(PortConfig(L=4, tf=2), write=False)
