"""The port's own copies of the JAX package's jax-free modules give the
reference's results: disorder arrays and file names exactly, CSV bytes
exactly, envelopes at 1e-12, the same config defaults and CLI flags."""

import argparse
import dataclasses

import numpy as np
import pytest

from dtc_tpu.analysis.envelope import find_envelope as j_find_envelope
from dtc_tpu.io import csvio as j_csvio
from dtc_tpu.io import disorder as j_disorder
from dtc_tpu.io import naming as j_naming
from dtc_tpu.utils import cli as j_cli
from dtc_tpu.utils.config import SimConfig as JSimConfig
from dtc_tpu.utils.profiling import phase_timer as j_phase_timer
from dtc_tpu.utils.validation import NumericalFault as JNumericalFault
from dtc_tpu.utils.validation import guard as j_guard
from dtc_tpu_torch.analysis.envelope import find_envelope
from dtc_tpu_torch.io import csvio, disorder, naming
from dtc_tpu_torch.utils import cli
from dtc_tpu_torch.utils.config import SimConfig
from dtc_tpu_torch.utils.profiling import phase_timer
from dtc_tpu_torch.utils.validation import NumericalFault, guard

CONFIGS = [
    {},
    dict(L=20, g=0.9, inst=3, tf=50, noise_prob=0.01, polarization="xy"),
    dict(L=7, initial_state="neel", randomphi=0, phi_delta=0.25,
         phi_amplitude=0.5, use_noise=0, seed=11),
]


def test_config_defaults_match_reference():
    ours = {f.name: f.default for f in dataclasses.fields(SimConfig)}
    ref = {f.name: f.default for f in dataclasses.fields(JSimConfig)}
    assert ours == ref
    cfg, jcfg = SimConfig(L=9, qubit=None), JSimConfig(L=9, qubit=None)
    assert (cfg.probe_qubit, cfg.T, cfg.noise_p) == (
        jcfg.probe_qubit, jcfg.T, jcfg.noise_p)
    assert SimConfig(use_noise=0).noise_p == 0.0


@pytest.mark.parametrize("kw", CONFIGS)
def test_disorder_identical(kw, tmp_path):
    cfg, jcfg = SimConfig(**kw), JSimConfig(**kw)
    for a, b in zip(disorder.get_disorder(cfg, None),
                    j_disorder.get_disorder(jcfg, None)):
        np.testing.assert_array_equal(a, b)
    hs, phis = j_disorder.generate_disorder(cfg.L, 2, seed=3)
    j_disorder.save_disorder(hs, phis, str(tmp_path / f"hs_L{cfg.L}.csv"),
                             str(tmp_path / f"phis_L{cfg.L}.csv"))
    for a, b in zip(disorder.get_disorder(cfg.replace(inst=2), str(tmp_path)),
                    j_disorder.get_disorder(jcfg.replace(inst=2),
                                            str(tmp_path))):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kw", CONFIGS)
def test_names_identical(kw):
    cfg, jcfg = SimConfig(**kw), JSimConfig(**kw)
    for pol in (None, "y", "circular_left"):
        for env in (False, True):
            assert naming.autocorr_csv_name(
                cfg, pol=pol, with_envelopes=env) == j_naming.autocorr_csv_name(
                    jcfg, pol=pol, with_envelopes=env)
    for env in (False, True):
        assert naming.autocorr_comparison_csv_name(cfg, env) == \
            j_naming.autocorr_comparison_csv_name(jcfg, env)
    assert naming.autocorr_folder_name(cfg) == j_naming.autocorr_folder_name(
        jcfg)


@pytest.mark.parametrize("kw", CONFIGS + [
    dict(use_optimization=0, optimization_iterations=7),
    dict(use_optimization=0, exponential_feedback=0, target_echo=0.9,
         feedback_gain=0.05, g=0.84, decay_compensation=0.2)])
def test_adaptive_names_identical(kw):
    cfg, jcfg = SimConfig(**kw), JSimConfig(**kw)
    for name in ("adaptive_csv_name", "adaptive_comparison_csv_name",
                 "g_history_csv_name"):
        assert getattr(naming, name)(cfg) == getattr(j_naming, name)(jcfg)


def test_realtime_writer_bytes_identical(tmp_path):
    """Header on first write, one flushed row per step, the same bytes;
    resume=True appends after the rows on disk, resume=False truncates."""
    rows = [{"time": t, "g": 0.84 + 0.01 * t, "forward": np.float32(-0.5),
             "echo": np.float64(0.25) ** t} for t in range(3)]
    fields = ["time", "g", "forward", "echo"]
    for side, mod in (("ours", csvio), ("ref", j_csvio)):
        path = str(tmp_path / side / "rt.csv")
        with mod.RealtimeCSVWriter(path, fields) as w:
            assert w.resume_index() == 0
            for r in rows[:2]:
                w.write_row(r)
        w = mod.RealtimeCSVWriter(path, fields)
        assert w.resume_index() == 2
        w.write_row(rows[2])
        w.close()
    assert (tmp_path / "ours" / "rt.csv").read_bytes() == (
        tmp_path / "ref" / "rt.csv").read_bytes()
    assert len((tmp_path / "ours" / "rt.csv").read_text().splitlines()) == 4
    w = csvio.RealtimeCSVWriter(str(tmp_path / "ours" / "rt.csv"), fields,
                                resume=False)
    w.write_row(rows[0])
    w.close()
    assert len((tmp_path / "ours" / "rt.csv").read_text().splitlines()) == 2


def test_csv_bytes_identical(tmp_path):
    rng = np.random.default_rng(0)
    cols = {"time": np.arange(7), "a": rng.normal(size=7),
            "b": np.float32(rng.normal(size=7)),
            "c": np.array([np.nan, -0.0, 1e-300, 1e300, 0.1, 2.0, -3.5])}
    csvio.write_columns(str(tmp_path / "ours" / "x.csv"), cols)
    j_csvio.write_columns(str(tmp_path / "ref" / "x.csv"), cols)
    ours = (tmp_path / "ours" / "x.csv").read_bytes()
    assert ours == (tmp_path / "ref" / "x.csv").read_bytes()
    back = csvio.read_columns(str(tmp_path / "ours" / "x.csv"))
    ref = j_csvio.read_columns(str(tmp_path / "ref" / "x.csv"))
    assert list(back) == list(ref)
    for k in back:
        np.testing.assert_array_equal(back[k], ref[k])
    with pytest.raises(ValueError):
        csvio.write_columns(str(tmp_path / "bad.csv"), {"a": [1], "b": [1, 2]})


@pytest.mark.parametrize("n", [3, 10, 50])
def test_envelope_matches_reference(n):
    t = np.arange(n)
    sig = 0.9 ** t * np.cos(np.pi * 0.97 * t) + 0.01 * np.sin(t)
    for a, b in zip(find_envelope(sig), j_find_envelope(sig)):
        np.testing.assert_allclose(a, b, atol=1e-12, rtol=0)


def test_guard_matches_reference():
    ok = np.array([0.5, -1.0005])
    np.testing.assert_array_equal(guard("s", ok, bound=1.0),
                                  j_guard("s", ok, bound=1.0))
    for bad in (np.array([np.nan, 0.0]), np.array([1.2, 0.0])):
        with pytest.raises(NumericalFault) as ours:
            guard("stage", bad, bound=1.0)
        with pytest.raises(JNumericalFault) as ref:
            j_guard("stage", bad, bound=1.0)
        assert str(ours.value) == str(ref.value)


def test_phase_timer_records_like_reference():
    ours, ref = {}, {}
    with phase_timer("p", ours):
        pass
    with j_phase_timer("p", ref):
        pass
    assert list(ours) == list(ref) == ["p"] and ours["p"] >= 0


def test_common_flags_and_config_match_reference():
    argv = ["--L", "12", "--tf", "7", "--polarization", "xy",
            "--noise_prob", "0.02", "--initial_state", "neel"]
    ours, ref = argparse.ArgumentParser(), argparse.ArgumentParser()
    cli.add_common_flags(ours)
    j_cli.add_common_flags(ref)
    a, b = ours.parse_args(argv), ref.parse_args(argv)
    assert vars(a) == vars(b)
    assert dataclasses.asdict(cli.config_from_args(a)) == dataclasses.asdict(
        j_cli.config_from_args(b))
