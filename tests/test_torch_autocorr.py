"""Port's drivers and CLI against the JAX reference (CPU).

With the reference's own per-trajectory uniforms injected, per-instance
forward A(t) and echo A0(t) agree at 1e-5 (complex64 rounding) when both
sides run the sigma engine (L <= 13), and at 1e-4 at L=14, where the port's
non-x drives go through the plain version of the lab-frame kernel K4 and the
reference (on the CPU) through its sigma engine. The CSVs have the
reference's file names and headers.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dtc_tpu.experiments import autocorr as j_autocorr
from dtc_tpu.experiments.autocorr import run_autocorr as j_run_autocorr
from dtc_tpu.experiments.engine import _inst_keys
from dtc_tpu.experiments.engine import apply_shot_noise as j_shot_noise
from dtc_tpu.io import csvio, naming
from dtc_tpu.utils.config import SimConfig
from dtc_tpu_torch.experiments import autocorr, engine
from dtc_tpu_torch.experiments.autocorr import run_autocorr
from dtc_tpu_torch.utils.cli import main as cli_main
from dtc_tpu_torch.utils.config import SimConfig as PortConfig

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _uniforms(keys, shape):
    return np.asarray(jax.vmap(jax.vmap(
        lambda k: jax.random.uniform(k, shape, dtype=jnp.float32)))(keys))


def test_run_autocorr_matches_reference(tmp_path):
    cfg = SimConfig(L=8, tf=10, inst=2, n_trajectories=16, noise_prob=0.05)
    ref = j_run_autocorr(cfg, out_dir=str(tmp_path / "jax"))
    # the reference takes all 16 trajectories in one chunk at L=8, with
    # chunk salt 0 (forward) and 7919 (echo)
    key = jax.random.PRNGKey(cfg.seed)
    uf = _uniforms(_inst_keys(key, cfg.inst, 0, 16), (cfg.tf, cfg.L))
    ue = _uniforms(_inst_keys(key, cfg.inst, 7919, 16), (2 * cfg.tf, cfg.L))
    got = run_autocorr(cfg, device="cpu", out_dir=str(tmp_path / "torch"),
                       uniforms=(uf, ue))
    for k in ("autocorr_per_instance", "echo_per_instance"):
        np.testing.assert_allclose(got[k], ref[k], atol=1e-5, rtol=0)
    assert os.path.basename(got["csv_path"]) == os.path.basename(
        ref["csv_path"])
    with open(got["csv_path"]) as f, open(ref["csv_path"]) as g:
        assert f.readline() == g.readline()
    a, b = csvio.read_columns(got["csv_path"]), csvio.read_columns(
        ref["csv_path"])
    assert list(a) == list(b)
    for k in a:
        np.testing.assert_allclose(a[k], b[k], atol=1e-5, equal_nan=True)


def test_sweep_through_blocked_dispatch(monkeypatch):
    """L=17 constant x: both sweeps go through the blocked entries (plain
    versions on the CPU); the physics invariants hold."""
    from dtc_tpu_torch.ops import resident_blocked as rb

    cfg = SimConfig(L=17, tf=3, inst=1, n_trajectories=2, noise_prob=0.3)
    calls = {"forward": 0, "echo": 0}
    for name in calls:
        fn = getattr(rb, f"blocked_{name}_batch_ref")

        def counted(*a, _fn=fn, _name=name, **k):
            calls[_name] += 1
            return _fn(*a, **k)

        monkeypatch.setattr(rb, f"blocked_{name}_batch_ref", counted)
    r = run_autocorr(cfg, device="cpu", write=False)
    assert calls["forward"] >= 1 and calls["echo"] >= 1
    af = (1 - 0.3) ** 6
    a, e = r["autocorr_per_instance"], r["echo_per_instance"]
    np.testing.assert_allclose(a[0, 0], af, atol=1e-6)
    assert a[0, 1] < 0 < a[0, 2]  # period doubling
    assert np.all(np.abs(a) <= 1 + 1e-3) and np.all(np.abs(e) <= 1 + 1e-3)
    np.testing.assert_allclose(e[0, 0], af, atol=1e-6)


def test_cli_writes_reference_named_csv(tmp_path):
    argv = ["--L", "6", "--tf", "4", "--inst", "1", "--n_trajectories", "4",
            "--out_dir", str(tmp_path), "--disorder_dir", str(tmp_path)]
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-m", "dtc_tpu_torch", "autocorr", "--device", "cpu",
         *argv], capture_output=True, text=True, cwd=tmp_path, env=env,
        timeout=120)
    assert proc.returncode == 0, proc.stderr
    cfg = SimConfig(L=6, tf=4, inst=1, n_trajectories=4)
    path = tmp_path / naming.autocorr_csv_name(cfg)
    assert path.exists(), os.listdir(tmp_path)
    assert path.read_text().splitlines()[0] == (
        "time,av_autocorr,av_autocorr_echo,sqrt_av_autocorr_echo")
    assert "engine=sigma" in proc.stderr


def _reference_uniforms(monkeypatch, seed):
    """Make every port sweep draw the reference's own uniforms: the chunk
    salt of a JAX sweep (forward 0, echo 7919) is the port's seed offset
    (engine.ECHO_SALT), and every sweep below takes its trajectories in one
    chunk on both sides."""
    def draw(uniforms, shape, sweep_seed, device):
        inst, n, steps, L = shape
        keys = _inst_keys(jax.random.PRNGKey(seed), inst, sweep_seed - seed,
                          n)
        return torch.tensor(_uniforms(keys, (steps, L)), device=device)

    monkeypatch.setattr(engine, "_sweep_uniforms", draw)


def _same_csv(ours, ref, atol):
    assert os.path.basename(ours) == os.path.basename(ref)
    a, b = csvio.read_columns(ours), csvio.read_columns(ref)
    assert list(a) == list(b)
    for k in a:
        np.testing.assert_allclose(a[k], b[k], atol=atol, rtol=0,
                                   equal_nan=True, err_msg=k)


DRIVER_CASES = [(6, 1e-5), (14, 1e-4)]


@pytest.mark.parametrize("L,atol", DRIVER_CASES)
def test_polarization_comparison_matches_reference(L, atol, tmp_path,
                                                   monkeypatch):
    kw = dict(L=L, tf=4, inst=1, n_trajectories=3, noise_prob=0.1)
    pols = ("x", "y", "xy") if L < 14 else ("y", "xy")
    ref = j_autocorr.run_polarization_comparison(
        SimConfig(**kw), polarizations=pols, out_dir=str(tmp_path / "jax"),
        disorder_dir=str(tmp_path))
    _reference_uniforms(monkeypatch, 0)
    got = autocorr.run_polarization_comparison(
        PortConfig(**kw), polarizations=pols, device="cpu",
        out_dir=str(tmp_path / "torch"), disorder_dir=str(tmp_path))
    assert len(got) == len(ref) and list(got)[:10] == list(ref)[:10]
    _same_csv(got["csv_path"], ref["csv_path"], atol)
    for pol in pols:
        g, r = got["per_polarization"][pol], ref["per_polarization"][pol]
        for k in ("autocorr_per_instance", "echo_per_instance"):
            np.testing.assert_allclose(g[k], r[k], atol=atol, rtol=0)
        _same_csv(g["csv_path"], r["csv_path"], atol)


@pytest.mark.parametrize("L,atol", DRIVER_CASES)
def test_xy_cycle_comparison_matches_reference(L, atol, tmp_path,
                                               monkeypatch):
    kw = dict(L=L, tf=7, inst=1, n_trajectories=2, noise_prob=0.1,
              xy_cycle_period=3)
    ref = j_autocorr.run_xy_cycle_comparison(
        SimConfig(**kw), out_dir=str(tmp_path / "jax"),
        disorder_dir=str(tmp_path))
    _reference_uniforms(monkeypatch, 0)
    got = autocorr.run_xy_cycle_comparison(
        PortConfig(**kw), device="cpu", out_dir=str(tmp_path / "torch"),
        disorder_dir=str(tmp_path))
    _same_csv(got["csv_path"], ref["csv_path"], atol)
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        assert got["png_path"] is None
    else:  # the figure beside the CSV, under the reference's name
        assert os.path.basename(got["png_path"]) == os.path.basename(
            ref["png_path"])
        assert os.path.dirname(got["png_path"]) == os.path.dirname(
            got["csv_path"])
        assert os.path.getsize(got["png_path"]) > 1000


@pytest.mark.parametrize("L,atol", DRIVER_CASES)
def test_shots_study_matches_reference(L, atol, tmp_path, monkeypatch):
    """Both drivers' shot sampling replaced by a recorder that returns the
    analytic echo: the echo sweeps agree at the driver's tolerance and the
    same (shots, seed) pairs are asked for; the sampler itself is compared
    on its own in test_shot_noise_identical."""
    kw = dict(L=L, tf=4, inst=2, n_trajectories=2, noise_prob=0.2,
              polarization="y", shots=5)
    calls = {"jax": [], "torch": []}

    def recorder(side):
        def sample(values, shots, seed=0):
            calls[side].append((shots, seed))
            return values
        return sample

    monkeypatch.setattr(j_autocorr, "apply_shot_noise", recorder("jax"))
    monkeypatch.setattr(autocorr, "apply_shot_noise", recorder("torch"))
    ref = j_autocorr.run_shots_study(
        SimConfig(**kw), shots_list=[10, 1000], out_dir=str(tmp_path / "jax"),
        disorder_dir=str(tmp_path))
    _reference_uniforms(monkeypatch, 0)
    got = autocorr.run_shots_study(
        PortConfig(**kw), shots_list=[10, 1000], device="cpu",
        out_dir=str(tmp_path / "torch"), disorder_dir=str(tmp_path))
    assert calls["torch"] == calls["jax"] == [(10, 10), (1000, 1000)]
    _same_csv(got["csv_path"], ref["csv_path"], atol)


def test_shot_noise_identical():
    vals = np.random.default_rng(2).uniform(-1, 1, (3, 9))
    for shots, seed in ((1, 0), (100, 7), (10**6, 3)):
        np.testing.assert_array_equal(engine.apply_shot_noise(vals, shots,
                                                              seed),
                                      j_shot_noise(vals, shots, seed))


@pytest.mark.parametrize("command,extra,engines", [
    ("polarization", ["--polarizations", "x,y"],
     {("resident", "x"), ("general", "y")}),
    ("xy-cycle", [], {("resident", "x"), ("general", "xy_cycle")}),
    ("shots", ["--polarization", "xy", "--shots_list", "10,100"],
     {("general", "xy")}),
])
def test_cli_new_subcommands(command, extra, engines, tmp_path, caplog):
    """Each new subcommand on the CPU at L=14: the reference's CSV name and
    header, and the engine each sweep logs."""
    argv = [command, "--device", "cpu", "--L", "14", "--tf", "3",
            "--n_trajectories", "2", "--out_dir", str(tmp_path),
            "--disorder_dir", str(tmp_path), *extra]
    caplog.set_level("INFO", logger="dtc_tpu_torch")
    assert cli_main(argv) == 0
    cfg = SimConfig(L=14, tf=3, n_trajectories=2)
    if command == "polarization":
        name = naming.autocorr_comparison_csv_name(cfg)
        header = ["time"] + [f"{k}_{pol}" for pol in ("x", "y") for k in (
            "av_autocorr", "av_autocorr_echo", "sqrt_av_autocorr_echo",
            "forward_upper_env", "forward_lower_env", "echo_upper_env",
            "echo_lower_env", "sqrt_echo_upper_env", "sqrt_echo_lower_env")]
    elif command == "xy-cycle":
        name = naming.autocorr_csv_name(cfg).replace("autocorr_data_",
                                                     "autocorr_xy_cycle_")
        header = ["time", "av_autocorr_x", "av_autocorr_echo_x",
                  "av_autocorr_xy_cycle", "av_autocorr_echo_xy_cycle"]
    else:
        name = naming.autocorr_csv_name(cfg).replace("autocorr_data_",
                                                     "autocorr_shots_")
        header = ["time", "av_autocorr_echo_shots10",
                  "av_autocorr_echo_shots100"]
    assert (tmp_path / name).read_text().splitlines()[0].split(",") == header
    logged = {tuple(w.split("=")[1] for w in r.getMessage().split()[1:3])
              for r in caplog.records if "_sweep: engine=" in r.getMessage()}
    assert logged == engines
