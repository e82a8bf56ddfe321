"""The adaptive-g slice against the JAX reference (CPU).

The port's runs use the kernel stepper (``mode="kernel"``), so
every sweep goes through the plain versions of K3a/K3b at L=14; the
reference runs its kernel stepper (``DTC_TPU_ADAPTIVE=kernel``, set for the
reference side only) on its sigma engine, as it does on a CPU. Both sides
see the same uniforms: the port's ``instance_uniforms`` is replaced by the
reference's own per-instance key splits. Every CSV column agrees within
1e-4 (f32 sums in another order, through a feedback loop whose gain keeps
g's differences 100x smaller) and the file names are equal. The carried
stepper is held against the reference's noiselessly in complex128 within
1e-6; the feedback laws and optimizers exactly.
"""

import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dtc_tpu.experiments import adaptive as j_adaptive
from dtc_tpu.io import csvio as j_csvio
from dtc_tpu.io.disorder import generate_disorder
from dtc_tpu.utils import cli as j_cli
from dtc_tpu.utils.config import SimConfig
from dtc_tpu_torch.experiments import adaptive
from dtc_tpu_torch.io import csvio
from dtc_tpu_torch.ops import resident as rs
from dtc_tpu_torch.ops import routes
from dtc_tpu_torch.utils import cli
from dtc_tpu_torch.utils import profiling
from dtc_tpu_torch.utils.config import SimConfig as PortConfig

torch.set_num_threads(2)

KW = dict(L=14, inst=1, tf=4, n_trajectories=2, noise_prob=0.1,
          use_optimization=0)
ATOL = 1e-4


def _jax_instance_uniforms(seed, n_traj, shapes, device):
    """The reference's draws: PRNGKey(seed) split in two halves, each split
    into per-trajectory keys, one uniform block per key."""
    halves = jax.random.split(jax.random.PRNGKey(seed))
    out = []
    for k, shape in zip(halves, shapes):
        keys = jax.random.split(k, n_traj)
        u = jax.vmap(lambda kk: jax.random.uniform(kk, shape,
                                                   dtype=jnp.float32))(keys)
        out.append(torch.tensor(np.asarray(u)[None], device=device))
    return tuple(out)


@pytest.fixture
def reference_noise(monkeypatch):
    monkeypatch.setattr(adaptive, "instance_uniforms", _jax_instance_uniforms)
    monkeypatch.setenv("DTC_TPU_ADAPTIVE", "kernel")  # the reference only


def _disorder(L, inst=1):
    hs, phis = generate_disorder(L, inst, seed=5)
    return hs[:, :L], phis[:, :L - 1]


def _same_csv(ours, ref):
    assert os.path.basename(ours) == os.path.basename(ref)
    a, b = csvio.read_columns(ours), j_csvio.read_columns(ref)
    assert list(a) == list(b)
    for k in a:
        np.testing.assert_allclose(a[k], b[k], atol=ATOL, rtol=0, err_msg=k)


@pytest.mark.parametrize("exponential", [0, 1])
def test_realtime_matches_reference(exponential, tmp_path, reference_noise,
                                    caplog):
    kw = dict(KW, exponential_feedback=exponential)
    hs, phis = _disorder(14)
    ref = j_adaptive.run_adaptive_realtime(SimConfig(**kw), hs, phis,
                                           out_dir=str(tmp_path / "jax"))
    profiling.reset_counters()
    with caplog.at_level(logging.INFO, logger="dtc_tpu_torch"):
        got = adaptive.run_adaptive_realtime(
            PortConfig(**kw), hs, phis, device="cpu", mode="kernel",
            out_dir=str(tmp_path / "torch"))
    # the loop's g really moved, so the per-cycle schedule was exercised
    assert np.ptp(got["g_history"]) > 1e-3
    for key in ("csv_path", "g_history_csv_path", "comparison_csv_path"):
        _same_csv(got[key], ref[key])
    for key in ("g_history", "echo", "forward"):
        np.testing.assert_allclose(got[key], ref[key], atol=ATOL, rtol=0)
    sweeps = [r.getMessage() for r in caplog.records
              if "_sweep: engine=" in r.getMessage()]
    assert sum(m.startswith("adaptive_sweep: engine=resident")
               for m in sweeps) == 1  # once per sweep, not per call
    assert all("engine=resident" in m for m in sweeps)


def test_fixed_g_matches_reference(reference_noise):
    kw = dict(KW, inst=2)
    hs, phis = _disorder(14, inst=2)
    for g in (None, 0.9):
        ref = j_adaptive.run_fixed_g(SimConfig(**kw), hs, phis, g_value=g)
        got = adaptive.run_fixed_g(PortConfig(**kw), hs, phis, g_value=g,
                                   device="cpu")
        for key in ("forward", "echo"):
            assert got[key].shape == (2, 4)
            np.testing.assert_allclose(got[key], ref[key], atol=ATOL, rtol=0)


def test_batch_matches_reference(tmp_path, reference_noise):
    hs, phis = _disorder(14)
    ref = j_adaptive.run_adaptive_batch(SimConfig(**KW), hs, phis,
                                        out_dir=str(tmp_path / "jax"))
    got = adaptive.run_adaptive_batch(PortConfig(**KW), hs, phis,
                                      device="cpu",
                                      out_dir=str(tmp_path / "torch"))
    _same_csv(got["csv_path"], ref["csv_path"])
    np.testing.assert_allclose(got["g_history"], ref["g_history"], atol=ATOL,
                               rtol=0)


def test_kernel_stepper_logs_each_route_it_takes(monkeypatch, caplog):
    """At L=17 the loop's first step (a constant schedule) takes the blocked
    route, every later step the resident one: each is logged once, and the
    resident entries get exactly the per-cycle calls."""
    calls = {"forward": 0, "echo": 0}
    for what in calls:
        entry = getattr(rs, f"resident_{what}_batch")

        def counted(*a, _entry=entry, _what=what, **k):
            calls[_what] += 1
            return _entry(*a, **k)

        monkeypatch.setattr(rs, f"resident_{what}_batch", counted)
    cfg = PortConfig(**dict(KW, L=17, tf=3))
    hs, phis = _disorder(17)
    with caplog.at_level(logging.INFO, logger="dtc_tpu_torch"):
        got = adaptive.run_adaptive_realtime(cfg, hs, phis, device="cpu",
                                             mode="kernel", write=False)
    assert np.ptp(got["g_history"]) > 1e-3
    assert [r.getMessage().split()[1] for r in caplog.records
            if r.getMessage().startswith("adaptive_sweep:")] == [
                "engine=blocked", "engine=resident"]
    assert calls == {"forward": 2, "echo": 2}


def test_fixed_g_in_one_state_launches_equals_unsplit(monkeypatch):
    """With room for one state a launch, run_fixed_g splits trajectories
    and t values and gives the unsplit values."""
    kw = dict(KW, n_trajectories=3)
    hs, phis = _disorder(14)
    whole = adaptive.run_fixed_g(PortConfig(**kw), hs, phis, device="cpu")
    monkeypatch.setattr(routes, "KERNEL_STATE_BYTES", 8 << 14)
    split = adaptive.run_fixed_g(PortConfig(**kw), hs, phis, device="cpu")
    for key in ("forward", "echo"):
        np.testing.assert_allclose(split[key], whole[key], atol=1e-6, rtol=0)


def test_echo_at_golden_candidates_matches_reference(reference_noise):
    """The optimizer's objective: the kernel stepper's echo_value at the
    golden search's candidates, after two advanced cycles."""
    cfg = dict(KW, use_optimization=1)
    hs, phis = _disorder(14)
    j_step = j_adaptive.KernelAdaptiveStepper(
        SimConfig(**cfg), hs[0], phis[0], key=jax.random.PRNGKey(101))
    p_step = adaptive.make_stepper(PortConfig(**cfg), hs[0], phis[0],
                                   seed=101, device="cpu", mode="kernel")
    assert isinstance(p_step, adaptive.KernelAdaptiveStepper)
    sched = np.array([0.97, 0.91, 0.97, 0.97])
    s_j, s_p = j_step.reset(), p_step.reset()
    for t in range(2):
        s_j = j_step.advance(s_j, sched[t], t, None)
        s_p = p_step.advance(s_p, sched[t], t, None)
    np.testing.assert_allclose(p_step.forward_value(s_p),
                               j_step.forward_value(s_j), atol=ATOL)
    seen = []

    def objective(g):
        seen.append(g)
        return (p_step.echo_value(s_p, sched, g, 3, None) - 1.0) ** 2

    adaptive.golden_section_minimize(objective, 0.84, 1.0, iters=3)
    assert len(seen) == 5
    for g in seen:
        np.testing.assert_allclose(p_step.echo_value(s_p, sched, g, 3, None),
                                   j_step.echo_value(s_j, sched, g, 3, None),
                                   atol=ATOL, err_msg=f"g={g}")


def test_carried_stepper_matches_reference_noiseless():
    kw = dict(L=6, tf=4, noise_prob=0.0, use_noise=0, dtype="complex128")
    hs, phis = _disorder(6)
    j_step = j_adaptive.AdaptiveStepper(SimConfig(**kw), hs[0], phis[0])
    p_step = adaptive.make_stepper(PortConfig(**kw), hs[0], phis[0],
                                   device="cpu", mode="carried")
    assert isinstance(p_step, adaptive.AdaptiveStepper)
    history = np.array([0.9, 0.95, 0.87, 0.99])
    s_j, s_p = j_step.reset(), p_step.reset()
    key = jax.random.PRNGKey(0)
    for t, g in enumerate(history):
        e_j = j_step.echo_value(s_j, history, g, t + 1, key)
        e_p = p_step.echo_value(s_p, history, g, t + 1, None)
        np.testing.assert_allclose(e_p, e_j, atol=1e-6)
        np.testing.assert_allclose(e_p, 1.0, atol=1e-6)  # noiseless echo
        s_j = j_step.advance(s_j, g, t, key)
        s_p = p_step.advance(s_p, g, t, None)
        np.testing.assert_allclose(p_step.forward_value(s_p),
                                   j_step.forward_value(s_j), atol=1e-6)


def test_carried_stepper_noisy_echo_is_an_estimate():
    """With noise the carried stepper's echo is a finite trajectory mean
    below 1, and its generator makes it reproducible."""
    cfg = PortConfig(L=5, tf=3, noise_prob=0.2, n_trajectories=64)
    hs, phis = _disorder(5)
    vals = []
    for _ in range(2):
        step = adaptive.AdaptiveStepper(cfg, hs[0], phis[0], device="cpu")
        gen = torch.Generator().manual_seed(3)
        s = step.advance(step.reset(), 0.97, 0, gen)
        vals.append(step.echo_value(s, np.full(3, 0.97), 0.97, 2, gen))
    assert vals[0] == vals[1]
    assert 0.0 < vals[0] < 1.0


@pytest.mark.parametrize("entry", ["AdaptiveStepper", "make_stepper"])
def test_carried_stepper_defaults_to_the_card(entry):
    """The carried stepper, built directly or by ``make_stepper(mode=
    "carried")``, defaults to device="cuda" as every other entry of the
    port: without a card the request raises, it does not run on the CPU."""
    import inspect

    cfg = PortConfig(L=6, tf=2, n_trajectories=2)
    hs, phis = _disorder(6)
    fn = getattr(adaptive, entry)
    assert inspect.signature(fn).parameters["device"].default == "cuda"
    kw = {"mode": "carried"} if entry == "make_stepper" else {}
    if torch.cuda.is_available():
        assert fn(cfg, hs[0], phis[0], **kw).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            fn(cfg, hs[0], phis[0], **kw)


def test_feedback_laws_and_optimizers_match_reference():
    rng = np.random.default_rng(0)
    for _ in range(20):
        e, tgt, g, gain, dec = rng.uniform(-0.2, 1.2, 5)
        t = int(rng.integers(0, 30))
        assert adaptive.linear_g_adjustment(e, tgt, g, gain, 0.84, 1.0) == \
            j_adaptive.linear_g_adjustment(e, tgt, g, gain, 0.84, 1.0)
        assert adaptive.exponential_g_adjustment(
            e, tgt, g, t, gain, dec, 0.84, 1.0) == \
            j_adaptive.exponential_g_adjustment(e, tgt, g, t, gain, dec,
                                                0.84, 1.0)
    echo, g0 = rng.uniform(0, 1, 9), rng.uniform(0.8, 1.0, 9)
    np.testing.assert_array_equal(
        adaptive.adjust_g_schedule(echo, g0, 1.0, 0.05, 0.84, 1.0),
        j_adaptive.adjust_g_schedule(echo, g0, 1.0, 0.05, 0.84, 1.0))

    def f(x):
        return (x - 0.913) ** 2 + 0.1 * np.sin(20 * x)

    assert adaptive.golden_section_minimize(f, 0.84, 1.0, 15) == \
        j_adaptive.golden_section_minimize(f, 0.84, 1.0, 15)
    assert adaptive.grid_search_minimize(f, 0.84, 1.0) == \
        j_adaptive.grid_search_minimize(f, 0.84, 1.0)

    class Quadratic:  # echo(g) = 1 - (g - 0.93)^2, for the bounded method
        def echo_value(self, states, sched, g, t_next, key):
            return 1.0 - (g - 0.93) ** 2

    for method in ("bounded", "golden", "grid"):
        assert adaptive.optimize_g_for_target_echo(
            Quadratic(), 0, None, 2, 1.0, 0.84, 1.0, None, method=method) \
            == j_adaptive.optimize_g_for_target_echo(
                Quadratic(), 0, None, 2, 1.0, 0.84, 1.0, None, method=method)


def test_make_stepper_modes():
    cfg = PortConfig(L=14, tf=4, n_trajectories=2)
    hs, phis = _disorder(14)
    assert isinstance(adaptive.make_stepper(cfg, hs[0], phis[0],
                                            device="cpu"),
                      adaptive.AdaptiveStepper)  # auto on the CPU
    with pytest.raises(ValueError, match="mode"):
        adaptive.make_stepper(cfg, hs[0], phis[0], device="cpu", mode="x")
    assert adaptive.stepper_engine(cfg) == "resident"
    assert adaptive.stepper_engine(cfg.replace(L=22)) == "general"
    assert adaptive.stepper_engine(cfg.replace(L=12)) == "sigma"
    assert adaptive.stepper_engine(cfg.replace(dtype="complex128")) == "sigma"


@pytest.mark.parametrize("command", ["adaptive", "adaptive-batch"])
def test_cli_names_and_headers_match_reference(command, tmp_path):
    argv = ["--L", "4", "--tf", "3", "--n_trajectories", "2",
            "--use_optimization", "0", "--disorder_dir", str(tmp_path)]
    if command == "adaptive":
        argv.append("--realtime_csv")
    assert j_cli.main([command, *argv, "--out_dir",
                       str(tmp_path / "jax")]) == 0
    assert cli.main([command, "--device", "cpu", *argv, "--out_dir",
                     str(tmp_path / "torch")]) == 0
    ours = sorted(os.listdir(tmp_path / "torch"))
    assert ours == sorted(os.listdir(tmp_path / "jax"))
    assert len(ours) == (4 if command == "adaptive" else 1)
    for name in ours:
        heads = [(tmp_path / side / name).read_text().splitlines()[0]
                 for side in ("torch", "jax")]
        assert heads[0] == heads[1]


def test_adaptive_flags_match_reference():
    import argparse

    argv = ["--target_echo", "0.9", "--g_min", "0.8",
            "--optimizer_method", "grid", "--exponential_feedback", "0"]
    ours, ref = argparse.ArgumentParser(), argparse.ArgumentParser()
    cli.add_adaptive_flags(ours)
    j_cli.add_adaptive_flags(ref)
    assert vars(ours.parse_args(argv)) == vars(ref.parse_args(argv))
    assert vars(ours.parse_args([])) == vars(ref.parse_args([]))


@pytest.mark.parametrize("fn", ["run_adaptive_realtime", "run_adaptive_batch"])
def test_fakebackend_is_refused(fn):
    cfg = PortConfig(L=4, tf=2, use_fakebackend=1)
    with pytest.raises(NotImplementedError,
                       match="ROADMAP.md queue 3"):
        getattr(adaptive, fn)(cfg, device="cpu", write=False)
