"""The hardware campaign, the backends, counts sampling and the counts
helpers of the port against the reference (CPU).

- The seven cases of ``tests/test_campaign.py`` on the port
  (``device="cpu"``).
- The exported job directories (manifests and QASM) are byte-identical to
  the reference's; the port's ingest of the reference campaign's own
  result records writes a byte-identical CSV.
- With the reference's own uniforms injected, the simulated runner's sweep
  values agree with the reference's at 1e-5 (complex64 rounding; 16
  trajectories, which the reference takes in one chunk), and its records
  and CSV are byte-identical (the shots are drawn from the same numpy
  generator).
- ``sample_counts`` samples by inverse CDF, which cannot reproduce
  ``jax.random.categorical``'s stream: the same key set and format, and
  frequencies within 0.02 of the probabilities and of the reference's at
  40,000 shots; past ``torch.multinomial``'s 2^24 categories too.
- ``utils/counts.py`` equals the reference's pure-Python paths exactly.
"""

import filecmp
import json
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import exact_oracle as oracle
from dtc_tpu import native as j_native
from dtc_tpu import observables as j_observables
from dtc_tpu.device.backends import QasmExportBackend as JQasmExportBackend
from dtc_tpu.experiments import campaign as j_campaign
from dtc_tpu.experiments import engine as j_engine
from dtc_tpu.experiments.engine import _inst_keys
from dtc_tpu.io.disorder import generate_disorder
from dtc_tpu.utils.config import SimConfig as JSimConfig
from dtc_tpu_torch import observables
from dtc_tpu_torch.device.backends import QasmExportBackend, SimulatorBackend
from dtc_tpu_torch.experiments import campaign
from dtc_tpu_torch.experiments.campaign import run_hardware_campaign
from dtc_tpu_torch.io import csvio
from dtc_tpu_torch.io.csvio import RealtimeCSVWriter, read_columns
from dtc_tpu_torch.utils import counts
from dtc_tpu_torch.utils.cli import main as cli_main
from dtc_tpu_torch.utils.config import SimConfig

torch.set_num_threads(2)
CFG = SimConfig(L=4, g=0.84, inst=2, tf=5, noise_prob=0.05, use_noise=1,
                n_trajectories=128, seed=3)
CPU = dict(device="cpu")


def _same_tree(a, b):
    """Every file under a and b, byte for byte."""
    files = sorted(os.path.relpath(os.path.join(r, f), a)
                   for r, _, fs in os.walk(a) for f in fs)
    assert files == sorted(os.path.relpath(os.path.join(r, f), b)
                           for r, _, fs in os.walk(b) for f in fs)
    assert files
    for f in files:
        assert filecmp.cmp(os.path.join(a, f), os.path.join(b, f),
                           shallow=False), f


# -- the seven cases of tests/test_campaign.py on the port ------------------


def test_campaign_closed_loop(tmp_path):
    hs, phis = generate_disorder(CFG.L, CFG.inst, seed=5)
    r = run_hardware_campaign(
        CFG, hs, phis, job_dir=str(tmp_path / "jobs"),
        out_dir=str(tmp_path / "out"), shots=4096, simulate=True, **CPU)
    for kind in ("forward", "echo"):
        kdir = tmp_path / "jobs" / kind
        manifest = json.load(open(kdir / "manifest.json"))
        assert len(manifest["jobs"]) == CFG.inst * CFG.tf
        assert all((kdir / j["qasm"]).exists() for j in manifest["jobs"])
    assert r["completed"]["forward"] == CFG.inst * CFG.tf
    assert r["rows_on_disk"] == CFG.tf
    cols = csvio.read_columns(r["csv_path"])
    assert list(cols) == ["time", "av_autocorr", "av_autocorr_echo",
                          "sqrt_av_autocorr_echo"]
    af = (1 - CFG.noise_prob) ** 6
    assert abs(cols["av_autocorr"][0] - af) < 5 / np.sqrt(4096 * CFG.inst)
    assert abs(cols["av_autocorr_echo"][0] - af) < 5 / np.sqrt(4096 * CFG.inst)


def test_campaign_partial_batch_recovery(tmp_path):
    hs, phis = generate_disorder(CFG.L, CFG.inst, seed=5)
    job_dir, out_dir = str(tmp_path / "jobs"), str(tmp_path / "out")
    r1 = run_hardware_campaign(
        CFG, hs, phis, job_dir=job_dir, out_dir=out_dir, shots=512,
        simulate=True, simulate_fail_fraction=0.3, **CPU)
    assert r1["completed"]["forward"] < CFG.inst * CFG.tf
    assert r1["rows_on_disk"] == 0  # job 0 (inst 0, t=0) is queued
    r2 = run_hardware_campaign(
        CFG, hs, phis, job_dir=job_dir, out_dir=out_dir, shots=512,
        simulate=True, **CPU)
    assert r2["export"] == {"forward": "existing", "echo": "existing"}
    assert r2["completed"]["forward"] == CFG.inst * CFG.tf
    assert r2["rows_on_disk"] == CFG.tf
    assert len(csvio.read_columns(r2["csv_path"])["time"]) == CFG.tf


def _bare(results, ts, bits):
    results.mkdir(parents=True, exist_ok=True)
    for t, b in zip(ts, bits):
        rec = {"created": f"2024-01-01T00:00:{t:02d}", "status": "completed",
               "measurements": {"c_1_0_0": b}}
        with open(results / f"job{t}.json", "w") as f:
            json.dump(rec, f)


def test_campaign_ingest_reference_style_records(tmp_path):
    cfg = CFG.replace(inst=1, tf=3)
    hs, phis = generate_disorder(cfg.L, cfg.inst, seed=5)
    _bare(tmp_path / "res" / "forward", range(3),
          [[[0]] * 8, [[1]] * 8, [[0]] * 8])
    r = run_hardware_campaign(
        cfg, hs, phis, job_dir=str(tmp_path / "jobs"),
        results_dir=str(tmp_path / "res"), out_dir=str(tmp_path / "out"),
        shots=8)
    np.testing.assert_allclose(r["forward"][0], [1.0, -1.0, 1.0])
    assert r["rows_on_disk"] == 3


def test_campaign_incomplete_bare_batch_is_skipped(tmp_path):
    cfg = CFG.replace(inst=1, tf=3)
    hs, phis = generate_disorder(cfg.L, cfg.inst, seed=5)
    _bare(tmp_path / "res" / "forward", (0, 2), [[[0]] * 8] * 2)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        r = run_hardware_campaign(
            cfg, hs, phis, job_dir=str(tmp_path / "jobs"),
            results_dir=str(tmp_path / "res"),
            out_dir=str(tmp_path / "out"), shots=8)
    assert any("positional" in str(x.message) for x in w)
    assert np.isnan(r["forward"]).all()
    assert r["rows_on_disk"] == 0


def _drop(tmp_path, kind, t, bit=0):
    kdir = tmp_path / "res" / kind
    kdir.mkdir(parents=True, exist_ok=True)
    rec = {"created": f"2024-01-01T00:00:{t:02d}", "status": "completed",
           "instance": 0, "t": t, "measurements": {"c_1_0_0": [[bit]] * 8}}
    with open(kdir / f"job{t}.json", "w") as f:
        json.dump(rec, f)


def _kw(tmp_path):
    return dict(job_dir=str(tmp_path / "jobs"),
                results_dir=str(tmp_path / "res"),
                out_dir=str(tmp_path / "out"), shots=8)


def test_campaign_echo_backfill_after_forward_rows(tmp_path):
    cfg = CFG.replace(inst=1, tf=2)
    hs, phis = generate_disorder(cfg.L, cfg.inst, seed=6)
    for t in range(2):
        _drop(tmp_path, "forward", t)
    r1 = run_hardware_campaign(cfg, hs, phis, **_kw(tmp_path))
    assert r1["rows_on_disk"] == 2
    c1 = read_columns(r1["csv_path"])
    assert np.isnan(c1["av_autocorr_echo"]).all()
    for t in range(2):
        _drop(tmp_path, "echo", t)
    r2 = run_hardware_campaign(cfg, hs, phis, **_kw(tmp_path))
    assert r2["rows_on_disk"] == 2
    c2 = read_columns(r2["csv_path"])
    np.testing.assert_allclose(c2["av_autocorr_echo"], [1.0, 1.0])
    np.testing.assert_allclose(c2["av_autocorr"], c1["av_autocorr"])


def test_campaign_persisted_rows_survive_record_regression(tmp_path):
    cfg = CFG.replace(inst=1, tf=3)
    hs, phis = generate_disorder(cfg.L, cfg.inst, seed=7)
    for t in range(2):
        _drop(tmp_path, "forward", t)
    r1 = run_hardware_campaign(cfg, hs, phis, **_kw(tmp_path))
    assert r1["rows_on_disk"] == 2
    os.remove(tmp_path / "res" / "forward" / "job0.json")
    _drop(tmp_path, "forward", 2)
    r2 = run_hardware_campaign(cfg, hs, phis, **_kw(tmp_path))
    assert r2["rows_written"] == 1
    assert r2["rows_on_disk"] == 3
    cols = csvio.read_columns(r2["csv_path"])
    np.testing.assert_allclose(cols["time"], [0, 1, 2])
    np.testing.assert_allclose(
        cols["av_autocorr"][:2],
        csvio.read_columns(r1["csv_path"])["av_autocorr"][:2])


def test_realtime_writer_resume_and_overwrite(tmp_path):
    path = str(tmp_path / "rt.csv")
    fields = ["time", "value"]
    with RealtimeCSVWriter(path, fields) as w:
        assert w.resume_index() == 0
        w.write_row({"time": 0, "value": 1.5})
        w.write_row({"time": 1, "value": 2.5})
    w2 = RealtimeCSVWriter(path, fields)
    assert w2.resume_index() == 2
    with w2:
        w2.write_row({"time": 2, "value": 3.5})
    assert csvio.read_columns(path)["time"].tolist() == [0.0, 1.0, 2.0]
    with RealtimeCSVWriter(path, fields, resume=False) as w3:
        w3.write_row({"time": 0, "value": 9.0})
    cols = csvio.read_columns(path)
    assert cols["time"].tolist() == [0.0] and cols["value"].tolist() == [9.0]


# -- against the reference ---------------------------------------------------


EXPORT_CONFIGS = [
    dict(L=4, inst=2, tf=3),
    dict(L=6, inst=1, tf=4, initial_state="neel", qubit=1, g=0.9),
    dict(L=5, inst=1, tf=3, polarization="xy"),
]


@pytest.mark.parametrize("kw", EXPORT_CONFIGS)
def test_export_matches_reference_bytes(kw, tmp_path):
    hs, phis = generate_disorder(kw["L"], kw["inst"], seed=9)
    ours = campaign._export_phase(SimConfig(**kw), hs, phis,
                                  str(tmp_path / "torch"), 64)
    ref = j_campaign._export_phase(JSimConfig(**kw), hs, phis,
                                   str(tmp_path / "jax"), 64)
    assert ours == ref
    _same_tree(str(tmp_path / "torch"), str(tmp_path / "jax"))
    assert campaign._export_phase(SimConfig(**kw), hs, phis,
                                  str(tmp_path / "torch"), 64) == {
        "forward": "existing", "echo": "existing"}


@pytest.mark.parametrize("fail", [0.0, 0.3])
def test_ingest_of_reference_records_writes_the_same_csv(fail, tmp_path):
    kw = dict(L=4, g=0.84, inst=2, tf=4, n_trajectories=8, seed=3)
    hs, phis = generate_disorder(4, 2, seed=5)
    ref = j_campaign.run_hardware_campaign(
        JSimConfig(**kw), hs, phis, job_dir=str(tmp_path / "jobs"),
        out_dir=str(tmp_path / "jax"), shots=256, simulate=True,
        simulate_fail_fraction=fail)
    ours = run_hardware_campaign(
        SimConfig(**kw), hs, phis, job_dir=str(tmp_path / "jobs"),
        out_dir=str(tmp_path / "torch"), shots=256)
    assert ours["export"] == {"forward": "existing", "echo": "existing"}
    assert ours["completed"] == ref["completed"]
    assert ours["rows_on_disk"] == ref["rows_on_disk"]
    for k in ("forward", "echo"):
        np.testing.assert_array_equal(ours[k], ref[k])
    assert os.path.basename(ours["csv_path"]) == os.path.basename(
        ref["csv_path"])
    if fail:  # job 0 (instance 0, t=0) is queued: no row, no file
        assert ref["rows_on_disk"] == 0
        assert not os.path.exists(ours["csv_path"])
        assert not os.path.exists(ref["csv_path"])
    else:
        assert filecmp.cmp(ours["csv_path"], ref["csv_path"], shallow=False)


def _uniforms(keys, shape):
    return np.asarray(jax.vmap(jax.vmap(
        lambda k: jax.random.uniform(k, shape, dtype=jnp.float32)))(keys))


def _recording(mod, store, side):
    for name in ("forward_sweep", "echo_sweep"):
        fn = getattr(mod, name)

        def rec(*a, _fn=fn, _name=name, **k):
            store[(side, _name)] = out = _fn(*a, **k)
            return out

        yield name, rec


@pytest.mark.parametrize("pol", ["x", "xy"])
def test_simulated_campaign_matches_reference(pol, tmp_path, monkeypatch):
    """The reference's uniforms injected: the sweep values within 1e-5, the
    records, manifests, QASM and CSV byte-identical, and the CLI's output
    the same."""
    kw = dict(L=6, g=0.9, inst=2, tf=4, n_trajectories=16, seed=2,
              polarization=pol, noise_prob=0.08)
    cfg = JSimConfig(**kw)
    K = 1 if pol == "x" else 2
    key = jax.random.PRNGKey(cfg.seed)
    uf = _uniforms(_inst_keys(key, cfg.inst, 0, 16), (cfg.tf * K, cfg.L))
    ue = _uniforms(_inst_keys(key, cfg.inst, 7919, 16),
                   (2 * cfg.tf * K, cfg.L))
    hs, phis = generate_disorder(cfg.L, cfg.inst, seed=0)
    values = {}
    for name, fn in _recording(j_engine, values, "jax"):
        monkeypatch.setattr(j_engine, name, fn)
    for name, fn in _recording(campaign, values, "torch"):
        monkeypatch.setattr(campaign, name, fn)
    run = dict(shots=1024, simulate=True)
    ref = j_campaign.run_hardware_campaign(
        cfg, hs, phis, job_dir=str(tmp_path / "jax"),
        out_dir=str(tmp_path / "jax_out"), **run)
    ours = run_hardware_campaign(
        SimConfig(**kw), hs, phis, job_dir=str(tmp_path / "torch"),
        out_dir=str(tmp_path / "torch_out"), uniforms=(uf, ue), **CPU, **run)
    for name in ("forward_sweep", "echo_sweep"):
        np.testing.assert_allclose(values[("torch", name)],
                                   values[("jax", name)], atol=1e-5, rtol=0)
    assert ours["simulate"] == ref["simulate"]
    _same_tree(str(tmp_path / "torch"), str(tmp_path / "jax"))
    _same_tree(str(tmp_path / "torch_out"), str(tmp_path / "jax_out"))


def test_campaign_cli_matches_reference(tmp_path, capsys, monkeypatch):
    """``campaign`` without --simulate: the same export and printed lines
    as ``python -m dtc_tpu``'s; ``--simulate`` on the CPU completes."""
    from dtc_tpu.utils.cli import main as j_cli_main

    flags = ["--L", "4", "--tf", "3", "--inst", "2", "--campaign_shots",
             "32", "--n_trajectories", "4"]
    out = {}
    for side, main, extra in (("jax", j_cli_main, []),
                              ("torch", cli_main, ["--device", "cpu"])):
        monkeypatch.chdir(tmp_path)
        os.makedirs(side)
        monkeypatch.chdir(tmp_path / side)
        assert main(["campaign", *flags, *extra, "--job_dir", "jobs",
                     "--out_dir", "out", "--disorder_dir", "."]) == 0
        out[side] = capsys.readouterr().out
    assert out["torch"] == out["jax"]
    assert "rows on disk: 0/3" in out["torch"]
    _same_tree(str(tmp_path / "torch"), str(tmp_path / "jax"))
    assert cli_main(["campaign", *flags, "--device", "cpu", "--simulate",
                     "--job_dir", "jobs", "--out_dir", "out",
                     "--disorder_dir", "."]) == 0
    printed = capsys.readouterr().out
    assert "export: {'forward': 'existing', 'echo': 'existing'}" in printed
    assert "completed: forward 6/6, echo 6/6" in printed
    assert "rows on disk: 3/3" in printed


def test_simulated_campaign_refuses_device_noise(tmp_path):
    hs, phis = generate_disorder(4, 1, seed=1)
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 3"):
        run_hardware_campaign(SimConfig(L=4, tf=2, use_fakebackend=1), hs,
                              phis, job_dir=str(tmp_path), simulate=True,
                              **CPU)


def test_qasm_export_backend_and_decode_pipeline(tmp_path):
    """Submit QASM jobs, fabricate raw results, ingest through the
    merge/decode pipeline: the reference's series, and its files."""
    cfg = SimConfig(L=4, tf=3, inst=2, use_noise=0)
    hs, phis = generate_disorder(cfg.L, cfg.inst, seed=81)
    be = QasmExportBackend(cfg, str(tmp_path / "jobs"), shots=400)
    paths = be.submit_sweep(hs, phis)
    j_be = JQasmExportBackend(JSimConfig(L=4, tf=3, inst=2, use_noise=0),
                              str(tmp_path / "jjobs"), shots=400)
    j_be.submit_sweep(hs, phis)
    _same_tree(str(tmp_path / "jobs"), str(tmp_path / "jjobs"))
    assert len(paths) == cfg.inst * cfg.tf
    manifest = json.load(open(tmp_path / "jobs" / "manifest.json"))
    rng = np.random.default_rng(0)
    results, truth = [], []
    for j, _ in enumerate(manifest["jobs"]):
        bits = [[1 if rng.random() < 0.1 + 0.05 * j else 0]
                for _ in range(400)]
        truth.append(1 - 2 * np.mean([b[0] for b in bits]))
        results.append({"id": f"r{j}", "created": f"2025-02-{j+1:02d}",
                        "status": "completed",
                        "measurements": {"c_1_0_0": bits}})
    os.makedirs(tmp_path / "results")
    with open(tmp_path / "results" / "all.json", "w") as f:
        json.dump(results, f)
    series = be.ingest_results(str(tmp_path / "results"))
    assert series.shape == (cfg.inst, cfg.tf)
    np.testing.assert_allclose(series.ravel(), truth, atol=1e-12)
    np.testing.assert_array_equal(
        series, j_be.ingest_results(str(tmp_path / "results")))


def test_simulator_backend_matches_oracle():
    cfg = SimConfig(L=4, tf=4, use_noise=0, inst=1, dtype="complex128")
    hs, phis = generate_disorder(cfg.L, 1, seed=82)
    r = SimulatorBackend(cfg, **CPU).run_autocorr(hs, phis)
    want = oracle.autocorr_dm(cfg.L, cfg.g, hs[0], phis[0], 2, 0.0)
    np.testing.assert_allclose(r["av_autocorr"][2], want, atol=1e-10)
    assert SimulatorBackend(cfg).device == "cuda"


# -- counts sampling and helpers -------------------------------------------


def test_sample_counts_statistics():
    probs = np.array([0.5, 0.25, 0.125, 0.125])
    ours = observables.sample_counts(probs, 40000, n_qubits=2, seed=1)
    ref = j_observables.sample_counts(probs, 40000, n_qubits=2, seed=1)
    assert set(ours) == set(ref) == {"00", "01", "10", "11"}
    assert sum(ours.values()) == 40000
    for i, p in enumerate(probs):
        k = format(i, "02b")
        assert abs(ours[k] / 40000 - p) < 0.02
        assert abs(ours[k] / 40000 - ref[k] / 40000) < 0.02
    z = observables.counts_to_z_expectation(ours, 2)
    want_z0 = (probs[0] + probs[2]) - (probs[1] + probs[3])
    assert abs(z[0] - want_z0) < 0.03
    # the same draws from a generator, and from a tensor
    gen = torch.Generator().manual_seed(1)
    assert observables.sample_counts(torch.as_tensor(probs), 40000,
                                     n_qubits=2, generator=gen) == ours
    # a zero-probability state is never drawn; little-endian keys
    got = observables.sample_counts(np.array([0.0, 0.0, 0.0, 1.0, 0.0]),
                                    100, n_qubits=3)
    assert got == {"011": 100}


def test_sample_counts_past_multinomial_limit():
    n = 2**24 + 1
    probs = torch.zeros(n, dtype=torch.float64)
    probs[-1], probs[0] = 0.75, 0.25
    got = observables.sample_counts(probs, 4000, n_qubits=25, seed=3)
    assert set(got) == {"0" * 25, format(n - 1, "025b")}
    assert abs(got[format(n - 1, "025b")] / 4000 - 0.75) < 0.05


def test_counts_from_z_probability_identical():
    for a, shots, seed in ((0.3, 100, 0), (-1.0, 7, 3), (0.999, 4096, 11)):
        assert observables.counts_from_z_probability(a, shots, seed) == \
            j_observables.counts_from_z_probability(a, shots, seed)


def test_counts_helpers_match_reference_python_path(monkeypatch):
    monkeypatch.setattr(j_native, "lib", lambda: None)
    rng = np.random.default_rng(4)
    for data in (b"", b"dtc", bytes(rng.integers(0, 256, 999, np.uint8))):
        assert counts.crc32(data) == j_native.crc32(data)
    bits = rng.integers(0, 2, (300, 5)).astype(np.uint8)
    np.testing.assert_array_equal(counts.z_expectations(bits),
                                  j_native.z_expectations(bits))
    assert counts.bit_histogram(bits) == j_native.bit_histogram(bits)
    for kw in ({}, dict(phi_amplitude=0.5, phi_delta=0.2),
               dict(randomphi=0)):
        for a, b in zip(counts.generate_disorder_native(42, 6, 3, **kw),
                        j_native.generate_disorder_native(42, 6, 3, **kw)):
            np.testing.assert_array_equal(a, b)
