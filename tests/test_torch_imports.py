"""The port imports torch and never jax, nor any module of the JAX package
``dtc_tpu``; a CUDA request without CUDA raises."""

import os
import pkgutil
import subprocess
import sys

import pytest
import torch

import dtc_tpu_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_no_module_of_the_port_loads_jax():
    """Every module of the port, and chip_smoke.py's module-level imports,
    in a fresh interpreter: no jax*, no dtc_tpu / dtc_tpu.* module and no
    matplotlib (the figures import it inside their functions)."""
    names = [m.name for m in pkgutil.walk_packages(
        dtc_tpu_torch.__path__, "dtc_tpu_torch.")
        if m.name != "dtc_tpu_torch.__main__"]
    for module in ("ops.resident_general", "io.disorder", "experiments.energy",
                   "ops.observables", "utils.checkpoints", "ops.streamed",
                   "ops.resident", "experiments.adaptive", "ops.cycle",
                   "ops.cycle_hi", "parallel.mesh", "parallel.sharded",
                   "experiments.sharded_run", "ops.noise_factor",
                   "core.planar_evolve", "core.device_evolve",
                   "device.layouts", "models.device_noise",
                   "experiments.device_sweeps", "core.density", "dryrun",
                   "analysis.plots", "experiments.campaign", "device.qasm",
                   "observables"):
        assert f"dtc_tpu_torch.{module}" in names
    code = ("import importlib, sys\n"
            f"for n in {names + ['chip_smoke']!r}:\n"
            "    importlib.import_module(n)\n"
            "bad = sorted(m for m in sys.modules if m.startswith('jax')"
            " or m == 'dtc_tpu' or m.startswith('dtc_tpu.')"
            " or m.split('.')[0] == 'matplotlib')\n"
            "assert not bad, bad\n"
            "print(len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_cuda_request_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("CUDA is available: the request is valid")
    from dtc_tpu_torch.utils.config import SimConfig
    from dtc_tpu_torch.experiments.autocorr import run_autocorr
    from dtc_tpu_torch.experiments.engine import resolve_device

    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        run_autocorr(SimConfig(L=4, tf=2), device="cuda", write=False)


def test_unported_methods_raise(tmp_path):
    """method="exact" (once refused) runs on the CPU; an unknown method
    raises ValueError before any work."""
    from dtc_tpu_torch.utils.config import SimConfig
    from dtc_tpu_torch.experiments.autocorr import run_autocorr

    kw = dict(device="cpu", write=False, disorder_dir=str(tmp_path))
    r = run_autocorr(SimConfig(L=4, tf=2), method="exact", **kw)
    assert r["av_autocorr"].shape == r["av_autocorr_echo"].shape == (2,)
    assert abs(r["av_autocorr"][0] - 0.95 ** 6) < 1e-6
    with pytest.raises(ValueError, match="unknown method"):
        run_autocorr(SimConfig(L=4, tf=2), method="dense", **kw)


def _reference_gate_counts(folder, cfg):
    """The 2*tf gate-count CSVs the reference's run_autocorr writes for
    ``cfg`` (its own naming and transpile calls)."""
    from dtc_tpu.device.transpile import write_gate_count_csv
    from dtc_tpu.io.naming import gate_count_csv_name

    names = []
    for t in range(cfg.tf):
        for echo in (False, True):
            names.append(gate_count_csv_name(t, echo))
            write_gate_count_csv(os.path.join(folder, names[-1]), cfg.L, t,
                                 echo=echo, polarization=cfg.polarization)
    return names


def _same_gate_counts(ours, ref, cfg):
    names = _reference_gate_counts(ref, cfg)
    assert len(names) == 2 * cfg.tf
    got = sorted(f for f in os.listdir(ours) if f.startswith("gate_counts_"))
    assert got == sorted(names)
    for name in names:
        with open(os.path.join(ours, name), "rb") as f, \
                open(os.path.join(ref, name), "rb") as g:
            assert f.read() == g.read(), name


@pytest.mark.parametrize("flag", [["--sharded", "--use_fakebackend", "1"],
                                  ["--n_amp", "1", "--use_fakebackend", "1"],
                                  ["--emit_gate_counts"]])
def test_unported_autocorr_flags_raise(flag, tmp_path):
    """--sharded / --n_amp with device noise (``--use_fakebackend 1``),
    which the sharded engines do not run, raise: the reference's
    ``run_autocorr_sharded`` runs depolarizing noise under the flag.
    --emit_gate_counts (once refused) writes the 2*tf gate-count CSVs,
    byte-identical to the reference's."""
    from dtc_tpu_torch.utils.cli import main
    from dtc_tpu_torch.utils.config import SimConfig

    argv = ["autocorr", "--device", "cpu", "--L", "4", "--tf", "2",
            "--n_trajectories", "2", "--out_dir", str(tmp_path / "torch"),
            "--disorder_dir", str(tmp_path), *flag]
    if flag != ["--emit_gate_counts"]:
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            main(argv)
        return
    assert main(argv) == 0
    os.makedirs(tmp_path / "jax")
    _same_gate_counts(str(tmp_path / "torch"), str(tmp_path / "jax"),
                      SimConfig(L=4, tf=2))


@pytest.mark.parametrize("emit", [False, True])
def test_run_autocorr_takes_emit_gate_counts(emit, tmp_path):
    """The reference's keyword: False writes the result CSV alone, True
    also the 2*tf gate-count CSVs beside it, byte-identical to the
    reference's (here for the xy drive, two kick slots)."""
    from dtc_tpu_torch.experiments.autocorr import run_autocorr
    from dtc_tpu_torch.utils.config import SimConfig

    cfg = SimConfig(L=4, tf=3, n_trajectories=2, polarization="xy")
    r = run_autocorr(cfg, device="cpu", out_dir=str(tmp_path / "torch"),
                     disorder_dir=str(tmp_path), emit_gate_counts=emit)
    assert r["av_autocorr"].shape == r["av_autocorr_echo"].shape == (3,)
    files = os.listdir(tmp_path / "torch")
    if not emit:
        assert files == [os.path.basename(r["csv_path"])]
        return
    assert len(files) == 1 + 2 * cfg.tf
    os.makedirs(tmp_path / "jax")
    _same_gate_counts(str(tmp_path / "torch"), str(tmp_path / "jax"), cfg)


@pytest.mark.parametrize("flag", [["--sharded"], ["--n_amp", "2"]])
def test_unported_energy_flags_raise(flag, tmp_path, capsys):
    """``energy --sharded`` and ``--n_amp 2`` (once refused) run the
    sharded energy sweep on logical CPU devices and write its CSV."""
    from dtc_tpu_torch.utils.cli import main

    assert main(["--num_devices", "2", "energy", "--device", "cpu", "--L",
                 "4", "--tf", "2", "--n_trajectories", "2", "--out_dir",
                 str(tmp_path), "--disorder_dir", str(tmp_path), *flag]) == 0
    out = capsys.readouterr().out
    assert "mesh={'traj': 1, 'amp': 2}" in out
    assert os.path.isfile(out.split("wrote ")[-1].strip())


@pytest.mark.parametrize("via", ["function", "cli"])
def test_shots_refuses_fakebackend(via, tmp_path):
    """``shots`` does not run depolarizing noise in place of the device
    noise it was asked for."""
    from dtc_tpu_torch.experiments.autocorr import run_shots_study
    from dtc_tpu_torch.utils.cli import main
    from dtc_tpu_torch.utils.config import SimConfig

    with pytest.raises(NotImplementedError,
                       match="ROADMAP.md queue 3"):
        if via == "function":
            run_shots_study(SimConfig(L=4, tf=2, use_fakebackend=1),
                            device="cpu", write=False,
                            disorder_dir=str(tmp_path))
        else:
            main(["shots", "--device", "cpu", "--L", "4", "--tf", "2",
                  "--use_fakebackend", "1", "--out_dir", str(tmp_path),
                  "--disorder_dir", str(tmp_path)])
    assert not os.listdir(tmp_path)
