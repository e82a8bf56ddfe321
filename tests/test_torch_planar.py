"""The port's planar engine against the JAX reference on the CPU.

``planar_forward_batch`` runs trajectory for trajectory against the
reference's ``planar_forward_batch`` (its K11 in interpret mode) on the
reference's own uniforms (``uniform(key, (T, L))`` per trajectory, what its
``presample_noise`` draws): within 1e-4, the reference's planar-vs-sigma
bound (``tests/test_planar.py``); observed at most 2.4e-7. The noiseless
vacuum and Neel runs match the exact density-matrix oracle within 2e-6.
The sweeps route a constant x drive's forward to it under
``engine="planar"`` or ``DTC_TPU_ENGINE=planar``, and everything else to
the sigma engine.
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import exact_oracle as oracle
from dtc_tpu.core.planar_evolve import planar_forward_batch as j_planar
from dtc_tpu.io.disorder import generate_disorder
from dtc_tpu.models.drives import build_kick_schedule as j_sched
from dtc_tpu_torch.core.planar_evolve import planar_forward_batch
from dtc_tpu_torch.experiments import engine
from dtc_tpu_torch.models.drives import build_kick_schedule
from dtc_tpu_torch.ops import noise_factor, routes
from dtc_tpu_torch.utils import profiling
from dtc_tpu_torch.utils.config import SimConfig

torch.set_num_threads(2)


def _run_both(L, T, p, n_traj, state, seed=60, g=0.9):
    hs, phis = generate_disorder(L, 1, seed=seed)
    hs32 = hs[:, :L].astype(np.float32)
    ph32 = phis[:, :L - 1].astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(1), n_traj)[None]
    af = (1 - p) ** 6 if p else 1.0
    ref = np.asarray(j_planar(
        jnp.asarray(hs32), jnp.asarray(ph32), j_sched("x", g, T).angles,
        keys, L=L, T=T, p=p, q=L // 2, initial_state=state,
        dtype_name="complex64", ancilla_factor=af, interpret=True))
    u = np.asarray(jax.vmap(jax.vmap(lambda k: jax.random.uniform(
        k, (T, L), dtype=jnp.float32)))(keys))
    got = planar_forward_batch(
        torch.from_numpy(hs32), torch.from_numpy(ph32),
        build_kick_schedule("x", g, T).angles,
        torch.from_numpy(u.copy()) if p else None, L=L, T=T, p=p,
        q=L // 2, initial_state=state, ancilla_factor=af, n_traj=n_traj)
    return hs, phis, ref, got.numpy()


@pytest.mark.parametrize("state", ["vacuum", "neel"])
@pytest.mark.parametrize("p", [0.0, 0.15])
def test_matches_reference_trajectory_for_trajectory(state, p):
    profiling.reset_counters()
    _, _, ref, got = _run_both(5, 6, p, 6 if p else 1, state)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)
    if p:
        assert np.ptp(got[0, :, -1]) > 0.1  # sampled events really differ
    # CPU tensors: the plain version, never the kernel
    assert profiling.LAUNCHES["dtc.entry.K11"] == 0


@pytest.mark.parametrize("state,L,T", [("vacuum", 4, 6), ("neel", 5, 5)])
def test_noiseless_matches_exact_oracle(state, L, T):
    hs, phis, _, got = _run_both(L, T, 0.0, 1, state)
    for t in range(T):
        want = oracle.autocorr_dm(L, 0.9, hs[0], phis[0], t, 0.0,
                                  initial_state=state)
        assert abs(got[0, 0, t] - want) < 2e-6, (t, got[0, 0, t], want)


def _sweep_setup(L=6, T=5, n=8, p=0.1):
    cfg = SimConfig(L=L, tf=T, inst=2, n_trajectories=n, noise_prob=p)
    hs, phis = generate_disorder(L, 2, seed=3)
    sched, params, noise = engine.build_context(cfg, hs, phis, device="cpu")
    u = torch.rand((2, n, T, L), generator=torch.Generator().manual_seed(4))
    return cfg, sched, params, noise, u


@pytest.mark.parametrize("via", ["keyword", "environment"])
def test_forward_sweep_routes_planar(via, monkeypatch, caplog):
    """A constant x drive's forward takes the planar engine (K11's plain
    version once per cycle) and agrees with the sigma engine on the same
    uniforms; its echo takes the sigma engine."""
    cfg, sched, params, noise, u = _sweep_setup()
    kw = {"engine": "planar"} if via == "keyword" else {}
    if via == "environment":
        monkeypatch.setenv("DTC_TPU_ENGINE", "planar")
    calls = []
    orig = noise_factor.noise_factor_plain
    monkeypatch.setattr(noise_factor, "noise_factor_plain",
                        lambda *a, **k: calls.append(1) or orig(*a, **k))
    with caplog.at_level(logging.INFO, logger="dtc_tpu_torch"):
        got = engine.forward_sweep(cfg, sched, params, noise, uniforms=u, **kw)
        engine.echo_sweep(cfg, sched, params, noise, uniforms=torch.rand(
            (2, 8, 2 * cfg.tf, cfg.L)), **kw)
    assert "forward_sweep: engine=planar" in caplog.text
    assert "echo_sweep: engine=sigma" in caplog.text
    assert len(calls) == cfg.tf - 1  # one batch call per measured cycle
    want = engine.forward_sweep(cfg, sched, params, noise, uniforms=u,
                                engine="auto")
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_planar_sends_other_shapes_to_sigma():
    x = build_kick_schedule("x", 0.9, 4).angles
    y = build_kick_schedule("y", 0.9, 4).angles
    ramp = build_kick_schedule("x", torch.linspace(0.9, 0.95, 4), 4).angles
    kw = dict(L=20, T=4, q=10, dtype_name="complex64", engine="planar")
    assert routes.engine_for(x, has_y=False, echo=False, **kw) == "planar"
    assert routes.engine_for(x, has_y=False, echo=True, **kw) == "sigma"
    assert routes.engine_for(y, has_y=True, echo=False, **kw) == "sigma"
    assert routes.engine_for(ramp, has_y=False, echo=False, **kw) == "sigma"
    assert routes.engine_for(x, has_y=False, echo=False,
                             **{**kw, "dtype_name": "complex128"}) == "planar"
    assert routes.engine_for(x, has_y=False, echo=False,
                             **{**kw, "engine": "auto"}) == "blocked"


@pytest.mark.parametrize("name", ["streamed", "resident", "bogus"])
def test_unknown_engine_values_raise(name, monkeypatch):
    cfg, sched, params, noise, u = _sweep_setup(T=3)
    with pytest.raises(ValueError, match="auto, planar"):
        engine.forward_sweep(cfg, sched, params, noise, uniforms=u,
                             engine=name)
    monkeypatch.setenv("DTC_TPU_ENGINE", name)
    with pytest.raises(ValueError, match="DTC_TPU_ENGINE"):
        engine.echo_sweep(cfg, sched, params, noise)
