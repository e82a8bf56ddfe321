"""Port's run_autocorr and CLI against the JAX reference (CPU).

With the reference's own per-trajectory uniforms injected, per-instance
forward A(t) and echo A0(t) agree at 1e-5 (complex64 rounding), and the CSV
has the reference's file name and header.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

from dtc_tpu.experiments.autocorr import run_autocorr as j_run_autocorr
from dtc_tpu.experiments.engine import _inst_keys
from dtc_tpu.io import csvio, naming
from dtc_tpu.utils.config import SimConfig
from dtc_tpu_torch.experiments.autocorr import run_autocorr

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
