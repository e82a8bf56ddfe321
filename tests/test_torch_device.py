"""Device noise (``use_fakebackend=1``) of the port against the JAX reference
on the CPU.

The copies (layouts, calibrations, models) must equal the reference's; the
row packer, the samplers and the presampled masks must be bit-identical on
the same uniforms, drawn in JAX as the reference's engines draw them
(``core/device_evolve.py`` module docstring: the presamplers' ``split(key,
3)``, the gather engine's per-cycle ``fold_in`` salts). Every engine then
matches its JAX counterpart trajectory for trajectory: the gather and sigma
engines in complex128 within 1e-10 (the same arithmetic, other rounding
order), the kernel-row paths (the plain versions of K3, K1/K2 and K4) in
f32 within 1e-4, the reference's bound for its kernels against the sigma
engine and the oracles (``tests/test_device.py``), at the reference tests'
sizes. The sharded lab-frame engines with device rows agree with the
original-order oracle on a one-shard and a two-shard mesh.
"""

import csv
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dtc_tpu.core import device_evolve as jde
from dtc_tpu.device import layouts as jl
from dtc_tpu.io.disorder import generate_disorder
from dtc_tpu.models import device_noise as jdn
from dtc_tpu.models.drives import build_kick_schedule as j_sched
from dtc_tpu.ops import paulis as jp
from dtc_tpu.ops.pallas_noise import pack_device_cycle_params_compact as j_pack
from dtc_tpu_torch.core import device_evolve as de
from dtc_tpu_torch.device import layouts as tl
from dtc_tpu_torch.experiments import device_sweeps as ds
from dtc_tpu_torch.experiments.engine import build_context
from dtc_tpu_torch.models import device_noise as tdn
from dtc_tpu_torch.models.drives import build_kick_schedule, n_kick_slots
from dtc_tpu_torch.ops import paulis as tp
from dtc_tpu_torch.ops.params import pack_device_cycle_params_compact
from dtc_tpu_torch.parallel import mesh as pmesh
from dtc_tpu_torch.parallel import sharded as sh
from dtc_tpu_torch.utils import profiling
from dtc_tpu_torch.utils.config import SimConfig

torch.set_num_threads(2)
EPK = 2


def _t(x, dtype=None):
    return torch.as_tensor(np.array(x, copy=True), dtype=dtype)


def _disorder(L, seed=7):
    hs, phis = generate_disorder(L, 1, seed=seed)
    return hs[0, :L], phis[0, :L - 1]


def _rates(L, lo1=0.1, hi1=0.4, lo2=0.15, hi2=0.45):
    return np.linspace(lo1, hi1, L), np.linspace(lo2, hi2, L - 1)


def _split_uniforms(keys, steps, e, L):
    """The presamplers' draws: split(key, 3) -> u1, ue, uo (trajectories
    first)."""
    ne, no = de.n_bonds(L)

    def one(key):
        k1, k2, k3 = jax.random.split(key, 3)
        return (jax.random.uniform(k1, (steps, e, L), dtype=jnp.float32),
                jax.random.uniform(k2, (steps, ne), dtype=jnp.float32),
                jax.random.uniform(k3, (steps, no), dtype=jnp.float32))

    return tuple(_t(x) for x in jax.vmap(one)(keys))


def _gather_uniforms(keys, steps, K, L, salt=0, e_salt=(101, 102)):
    """The gather engine's per-cycle draws: split(key, steps)[s], then
    fold_in 7k+ev (+salt) for the 1q events (f32) and the bond salts
    (JAX's default float, f64 here)."""
    ne, no = de.n_bonds(L)

    def one(key):
        ks = jax.random.split(key, steps)

        def step(k_t):
            u1 = jnp.stack([jax.random.uniform(
                jax.random.fold_in(k_t, 7 * k + ev + salt), (L,),
                dtype=jnp.float32) for k in range(K) for ev in range(EPK)])
            return (u1, jax.random.uniform(jax.random.fold_in(k_t, e_salt[0]),
                                           (ne,)),
                    jax.random.uniform(jax.random.fold_in(k_t, e_salt[1]),
                                       (no,)))

        return jax.vmap(step)(ks)

    return tuple(_t(x) for x in jax.vmap(one)(keys))


# ---------------------------------------------------------------------------
# copies


def test_layouts_equal_reference():
    for name in ("eagle_coupling", "heron_coupling", "garnet_coupling"):
        assert getattr(tl, name)() == getattr(jl, name)()
    assert tl.linear_with_ancilla_coupling(9) == \
        jl.linear_with_ancilla_coupling(9)
    for L, dev in ((12, "brisbane"), (27, "brisbane"), (12, "garnet"),
                   (19, "garnet"), (8, "linear"), (20, "torino")):
        assert tl.snake_layout(L, dev) == jl.snake_layout(L, dev), (L, dev)


def _qiskit_props(n, edges):
    return {
        "qubits": [[{"name": "readout_error", "value": 0.01 + 1e-5 * i}]
                   for i in range(n)],
        "gates": ([{"gate": "sx", "qubits": [i], "parameters": [
            {"name": "gate_error", "value": 2e-4 + 1e-8 * i}]}
            for i in range(n)]
            + [{"gate": "ecr", "qubits": [a, b], "parameters": [
                {"name": "gate_error", "value": 8e-3 + 1e-7 * (a + b)}]}
               for a, b in edges]),
    }


def test_calibrations_and_models_equal_reference(tmp_path):
    assert (tdn.synthetic_eagle_calibration(127, 7)
            == jdn.synthetic_eagle_calibration(127, 7))
    assert (tdn.synthetic_eagle_calibration(133, 3)
            == jdn.synthetic_eagle_calibration(133, 3))
    assert tdn.synthetic_garnet_calibration(7) == \
        jdn.synthetic_garnet_calibration(7)
    n, edges, _ = jl.eagle_coupling()
    props = _qiskit_props(n, edges)
    assert tdn.qiskit_properties_to_calibration(props) == \
        jdn.qiskit_properties_to_calibration(props)
    path = tmp_path / "props.json"
    path.write_text(__import__("json").dumps(props))
    assert tdn.load_calibration(str(path)) == jdn.load_calibration(str(path))
    for args, kw in (((27, "brisbane"), {"seed": 7}),
                     ((12, "garnet"), {"seed": 9}),
                     ((8, "brisbane"), {"calibration_path": str(path)})):
        a = tdn.fake_device_model(*args, **kw)
        b = jdn.fake_device_model(*args, **kw)
        for f in ("p_1q", "p_2q", "readout"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        assert a.readout_ancilla == b.readout_ancilla
        assert a.ancilla_interferometric_factor() == \
            b.ancilla_interferometric_factor()
    with pytest.raises(ValueError, match="fake_device"):
        tdn.fake_device_model(8, "nowhere")


# ---------------------------------------------------------------------------
# packers, samplers, presampled masks


@pytest.mark.parametrize("L,width", [(17, 128), (27, 256)])
def test_pack_device_row_bit_identical(L, width):
    rng = np.random.default_rng(L)
    m = rng.integers(0, 1 << L, size=(4, 6))
    h, ph = _disorder(L)
    got = pack_device_cycle_params_compact(
        *(_t(x) for x in m), _t(h), _t(ph), L, width)
    for i in range(6):
        ref = j_pack(*(jnp.uint32(x) for x in m[:, i]), jnp.asarray(h),
                     jnp.asarray(ph), L, width=width)
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(ref))


def test_samplers_bit_identical():
    L = 9
    p1, p2 = _rates(L, 0.2, 0.9, 0.3, 0.95)
    key = jax.random.PRNGKey(4)
    for i in range(20):
        k = jax.random.fold_in(key, i)
        u = jax.random.uniform(k, (L,), dtype=jnp.float32)
        np.testing.assert_array_equal(
            tp.sample_depolarizing_codes(_t(u), _t(p1)).numpy(),
            np.asarray(jp.sample_depolarizing_codes(k, jnp.asarray(p1),
                                                    (L,))))
        for start in (0, 1):
            pb = p2[start::2]
            ub = jax.random.uniform(k, (len(pb),))
            np.testing.assert_array_equal(
                tp.sample_bond_depolarizing_codes(_t(ub), _t(pb), start,
                                                  L).numpy(),
                np.asarray(jp.sample_bond_depolarizing_codes(
                    k, jnp.asarray(pb), start, L)))


def test_presampled_masks_bit_identical():
    L, T, e = 7, 6, 2
    p1, p2 = _rates(L)
    keys = jax.random.split(jax.random.PRNGKey(9), 3)
    u = _split_uniforms(keys, T, e, L)
    pj = (jnp.asarray(p1), jnp.asarray(p2))
    ref = jax.vmap(lambda k: jde._device_presample_split(k, *pj, e, T, L))(
        keys)
    for r, g in zip(ref, de._device_presample_split(u, _t(p1), _t(p2), L)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    ref = jax.vmap(lambda k: jde._device_presample(k, *pj, e, T, L))(keys)
    for r, g in zip(ref, de._device_presample(u, _t(p1), _t(p2), e, L)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    T2 = 2 * T
    u2 = _split_uniforms(keys, T2, e, L)
    ts = [0, 2, 5]
    got = de._device_presample_echo(u2, _t(p1), _t(p2), e, ts, L)
    for ti, t in enumerate(ts):
        ref = jax.vmap(lambda k: jde._device_presample_echo(
            k, *pj, e, jnp.asarray(t), T, L))(keys)
        for r, g in zip(ref[:8], got[:8]):
            np.testing.assert_array_equal(g[:, ti].numpy(), np.asarray(r))
        np.testing.assert_array_equal(got[8][ti].numpy(),
                                      np.asarray(ref[8][0]))
        np.testing.assert_array_equal(got[9][ti].numpy(),
                                      np.asarray(ref[9][0]))


# ---------------------------------------------------------------------------
# the gather and sigma engines (complex128)


@pytest.mark.parametrize("pol", ["x", "xy"])
def test_gather_engine_matches_reference(pol):
    L, T = 5, 4
    K = n_kick_slots(pol)
    h, ph = _disorder(L, 40)
    p1, p2 = _rates(L)
    keys = jax.random.split(jax.random.PRNGKey(0), 3)
    kw = dict(L=L, T=T, K=K, q=L // 2, dtype_name="complex128",
              ancilla_factor=0.9)
    jargs = (jnp.asarray(h), jnp.asarray(ph), jnp.asarray(p1),
             jnp.asarray(p2), j_sched(pol, 0.9, T).angles)
    targs = (_t(h), _t(ph), _t(p1), _t(p2),
             build_kick_schedule(pol, 0.9, T).angles)
    ref = np.asarray(jde.device_autocorr_forward(*jargs, keys, **kw))
    got = de.device_autocorr_forward(*targs, _gather_uniforms(keys, T, K, L),
                                     **kw).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-10, rtol=0)
    ts = [1, 2, 4]
    u_echo = (_gather_uniforms(keys, 2 * T, K, L)
              + _gather_uniforms(keys, 2 * T, K, L, 300, (201, 202)))
    got = de.device_autocorr_echo(*targs, u_echo, ts, **kw).numpy()
    for ti, t in enumerate(ts):
        ref = np.asarray(jde.device_autocorr_echo(*jargs, keys,
                                                  jnp.asarray(t), **kw))
        np.testing.assert_allclose(got[:, ti], ref, atol=1e-10, rtol=0)
    assert np.ptp(got) > 0.05  # events fired


def test_sigma_engines_match_reference():
    L, T, q, af = 6, 4, 3, 0.9
    h, ph = _disorder(L, 11)
    p1, p2 = _rates(L)
    keys = jax.random.split(jax.random.PRNGKey(5), 3)
    kw = dict(L=L, T=T, q=q, dtype_name="complex128", ancilla_factor=af,
              events_per_kick=EPK)
    jargs = (jnp.asarray(h), jnp.asarray(ph), jnp.asarray(p1),
             jnp.asarray(p2), j_sched("x", 0.93, T).angles, keys)
    targs = (_t(h), _t(ph), _t(p1), _t(p2),
             build_kick_schedule("x", 0.93, T).angles)
    ref = np.asarray(jde.device_sigma_forward_batch(*jargs, **kw))
    got = de.device_sigma_forward_batch(
        *targs, _split_uniforms(keys, T, EPK, L), **kw).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-10, rtol=0)
    ts = [1, 2, 3, 4]
    ref = np.asarray(jde.device_sigma_echo_batch(*jargs, jnp.asarray(ts),
                                                 **kw))
    got = de.device_sigma_echo_batch(
        *targs, _split_uniforms(keys, 2 * T, EPK, L), ts, **kw).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-10, rtol=0)
    assert np.ptp(got) > 0.05
    with pytest.raises(ValueError, match="constant x"):
        de.device_sigma_forward_batch(
            _t(h), _t(ph), _t(p1), _t(p2),
            build_kick_schedule("y", 0.93, T).angles,
            _split_uniforms(keys, T, EPK, L), **kw)


# ---------------------------------------------------------------------------
# the x kernel rows (plain K3 and K1/K2) and the lab-frame rows (plain K4)


@pytest.mark.parametrize("L,T", [(14, 3), (17, 3)])
def test_x_kernel_rows_match_sigma_engine(L, T):
    """The reference's own check (its kernels against its sigma device
    engine, identical keys), at K3's and K1's floors; the rows bit for bit
    against the reference's packer."""
    h, ph = _disorder(L, 4)
    p1 = np.linspace(0.05, 0.3, L)
    p2 = np.linspace(0.1, 0.4, L - 1)
    keys = jax.random.split(jax.random.PRNGKey(7), 2)
    q = L // 2
    jargs = (jnp.asarray(h), jnp.asarray(ph), jnp.asarray(p1),
             jnp.asarray(p2), j_sched("x", 0.95, T).angles, keys)
    targs = (_t(h), _t(ph), _t(p1), _t(p2),
             build_kick_schedule("x", 0.95, T).angles)
    kw = dict(L=L, T=T, q=q, ancilla_factor=0.9)
    ref = np.asarray(jde.device_sigma_forward_batch(*jargs, **kw))
    u = _split_uniforms(keys, T, EPK, L)
    got = de.device_kernel_forward_batch(*targs, u, **kw).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)
    rows, sig = de.device_forward_rows(u, _t(h), _t(ph), _t(p1), _t(p2),
                                       L=L, epk=EPK)
    zm, sa, sb, sc = jax.vmap(lambda k: jde._device_presample(
        k, jnp.asarray(p1), jnp.asarray(p2), EPK, T, L))(keys)
    want = jax.vmap(jax.vmap(lambda z, a, b, c: j_pack(
        z, a, b, c, jnp.asarray(h), jnp.asarray(ph), L)))(zm, sa, sb, sc)
    np.testing.assert_array_equal(rows.numpy(), np.asarray(want))
    np.testing.assert_array_equal(sig.numpy(), np.asarray(sc))
    if L == 17:
        ts = [1, 2]
        ref = np.asarray(jde.device_sigma_echo_batch(
            *jargs, jnp.asarray(ts), dtype_name="complex128", **kw))
        u2 = _split_uniforms(keys, 2 * T, EPK, L)
        profiling.reset_counters()
        got = de.device_kernel_echo_batch(*targs, u2, ts, **kw).numpy()
        assert profiling.PLAIN_ON_CUDA["dtc.entry.K2"] == 0
        np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)
        tiles, sig = de.device_echo_pair_tiles(
            u2, ts, _t(h), _t(ph), _t(p1), _t(p2), L=L, T=T, epk=EPK)
        for ti, t in enumerate(ts):
            want = jax.vmap(lambda k: jde.device_echo_pair_tiles(
                k, jnp.asarray(t), jnp.asarray(h), jnp.asarray(ph),
                jnp.asarray(p1), jnp.asarray(p2), L=L, T=T, epk=EPK))(keys)
            np.testing.assert_array_equal(tiles[:, ti].numpy(),
                                          np.asarray(want[0]))
            np.testing.assert_array_equal(sig[:, ti].numpy(),
                                          np.asarray(want[1]))


def _general_case(L=14, T=4):
    h, ph = _disorder(L, 7)
    return h, ph, *_rates(L), jax.random.split(jax.random.PRNGKey(3), 2)


@pytest.mark.parametrize("pol", ["y", "xy", "circular_left"])
def test_general_rows_match_original_order_oracle(pol):
    """Plain K4 with the lab-frame device rows against the reference's
    dense original-order oracle (and the port's oracle against it), at the
    reference test's size; the rows bit for bit."""
    L, T, q = 14, 4, 7
    h, ph, p1, p2, keys = _general_case(L, T)
    K = n_kick_slots(pol)
    kw = dict(L=L, T=T, K=K, q=q, ancilla_factor=0.9)
    jargs = (jnp.asarray(h), jnp.asarray(ph), jnp.asarray(p1),
             jnp.asarray(p2), j_sched(pol, 0.97, T).angles, keys)
    targs = (_t(h), _t(ph), _t(p1), _t(p2),
             build_kick_schedule(pol, 0.97, T).angles)
    u = _split_uniforms(keys, T, K * EPK, L)
    ref = np.asarray(jde.device_general_forward_oracle(*jargs, **kw))
    profiling.reset_counters()
    got = de.device_general_kernel_forward_batch(*targs, u, **kw).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)
    orc = de.device_general_forward_oracle(*targs, u, **kw).numpy()
    np.testing.assert_allclose(orc, ref, atol=1e-5, rtol=0)
    rows = de._device_general_rows(u, _t(ph), _t(p1), _t(p2), EPK, T, K, L)
    want = jax.vmap(lambda k: jde._device_general_rows(
        k, jnp.asarray(ph), jnp.asarray(p1), jnp.asarray(p2), EPK, T, K, L))(
            keys)
    for g, r in zip(rows, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


@pytest.mark.parametrize("pol", ["y", "xy"])
def test_general_echo_rows_match_original_order_oracle(pol):
    L, T, q = 14, 4, 7
    h, ph, p1, p2, keys = _general_case(L, T)
    p1, p2 = np.linspace(0.1, 0.35, L), np.linspace(0.15, 0.4, L - 1)
    keys = keys[:1]
    K = n_kick_slots(pol)
    kw = dict(L=L, T=T, K=K, q=q, ancilla_factor=0.9)
    jang = j_sched(pol, 0.97, T).angles
    targs = (_t(h), _t(ph), _t(p1), _t(p2),
             build_kick_schedule(pol, 0.97, T).angles)
    u = _split_uniforms(keys, 2 * T, K * EPK, L)
    ts = [1, 3]
    got = de.device_general_kernel_echo_batch(*targs, u, ts, **kw).numpy()
    for ti, t in enumerate(ts):
        ref = jde.device_general_echo_oracle(
            jnp.asarray(h), jnp.asarray(ph), jnp.asarray(p1),
            jnp.asarray(p2), jang, keys[0], t, **kw)
        assert abs(got[0, ti] - ref) < 1e-4, (t, got[0, ti], ref)
        orc = de.device_general_echo_oracle(*targs, u, t, **kw)
        assert abs(float(orc[0]) - ref) < 1e-5
    rows = de._device_general_echo_rows(u, ts, _t(h), _t(ph), _t(p1),
                                        _t(p2), EPK, T, K, L)
    for ti, t in enumerate(ts):
        want = jde._device_general_echo_rows(
            keys[0], jnp.asarray(t), jnp.asarray(h), jnp.asarray(ph),
            jnp.asarray(p1), jnp.asarray(p2), EPK, T, K, L)
        for g, r in zip(rows, want):
            np.testing.assert_array_equal(g[0, ti].numpy(), np.asarray(r))
    # noiseless: U^dag U = I
    zero = (torch.zeros(L, dtype=torch.float64),
            torch.zeros(L - 1, dtype=torch.float64))
    a0 = de.device_general_kernel_echo_batch(
        targs[0], targs[1], *zero, targs[4], u, ts,
        **{**kw, "ancilla_factor": 1.0})
    np.testing.assert_allclose(a0.numpy(), 1.0, atol=1e-4)


@pytest.mark.parametrize("n_amp,L", [(1, 17), (2, 18)])
def test_sharded_general_device_rows_match_oracle(n_amp, L):
    """The lab-frame sharded engines with ``device=`` rows (plain K8c/K8d)
    on a one-shard mesh (the device sweeps' route at 24 <= L <= 30) and on
    two shards, against the original-order oracles."""
    T, q, K = 3, 5, 2
    h, ph = _disorder(L, 8)
    p1, p2 = _rates(L)
    p1, p2 = p1.astype(np.float32), p2.astype(np.float32)  # as the engines
    keys = jax.random.split(jax.random.PRNGKey(2), 2)
    ang = build_kick_schedule("xy", 0.97, T).angles
    targs = (_t(h), _t(ph), _t(p1), _t(p2), ang)
    kw = dict(L=L, T=T, K=K, q=q, ancilla_factor=1.0)
    mesh = pmesh.make_mesh(n_amp, 1, devices=["cpu"] * n_amp)
    dev = (_t(p1), _t(p2), EPK)
    u = _split_uniforms(keys, T, K * EPK, L)
    fn = sh.make_sharded_autocorr_forward_general(
        mesh, L=L, T=T, K=K, p=0.0, q=q, device=dev)
    got = fn(ang, _t(h), _t(ph), u).numpy()
    want = de.device_general_forward_oracle(*targs, u, **kw).mean(0).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    u2 = _split_uniforms(keys, 2 * T, K * EPK, L)
    fn = sh.make_sharded_echo_general(mesh, L=L, T=T, K=K, p=0.0, q=q,
                                      device=dev)
    for t in (1, 3):
        got = float(fn(ang, _t(h), _t(ph), u2, t))
        want = float(de.device_general_echo_oracle(*targs, u2, t,
                                                   **kw).mean())
        assert abs(got - want) < 1e-4, (t, got, want)
    with pytest.raises(ValueError, match="p=0"):
        sh.make_sharded_echo_general(mesh, L=L, T=T, K=K, p=0.1, q=q,
                                     device=dev)


# ---------------------------------------------------------------------------
# sweeps and drivers


def _cfg(**kw):
    return SimConfig(**{"g": 0.9, "use_fakebackend": 1, "n_trajectories": 2,
                        "tf": 2, **kw})


def _route(cfg, echo=False, **kw):
    sched = build_kick_schedule(cfg.polarization, cfg.g, cfg.tf)
    return ds.device_route(cfg, sched, echo=echo, **kw)


def test_device_routes(monkeypatch):
    assert _route(_cfg(L=20)) == "x_kernel"
    assert _route(_cfg(L=27), echo=True) == "x_kernel"
    assert _route(_cfg(L=15)) == "x_kernel"
    assert _route(_cfg(L=10)) == "sigma"
    assert _route(_cfg(L=20), device_engine="sigma") == "sigma"
    assert _route(_cfg(L=14, polarization="xy")) == "general"
    for L in (24, 26, 30):
        assert _route(_cfg(L=L, polarization="y"), echo=True) == \
            "general_mesh"
    assert _route(_cfg(L=10, polarization="xy")) == "gather"
    assert _route(_cfg(L=20, polarization="y"),
                  device_engine="sigma") == "gather"
    with pytest.raises(ValueError, match="dense gather"):
        _route(_cfg(L=31, polarization="y"))
    with pytest.raises(ValueError, match="dense gather"):
        _route(_cfg(L=26, tf=2048, polarization="y"))
    with pytest.raises(ValueError, match="device kernel engine"):
        _route(_cfg(L=10), device_engine="kernel")
    monkeypatch.setenv("DTC_TPU_DEVICE_ENGINE", "bogus")
    with pytest.raises(ValueError, match="auto|sigma|kernel"):
        _route(_cfg(L=20))
    monkeypatch.setenv("DTC_TPU_DEVICE_ENGINE", "sigma")
    assert _route(_cfg(L=20)) == "sigma"


def _header_and_name(run, cfg, tmp):
    out = run(cfg, tmp)
    path = out["csv_path"]
    with open(path) as f:
        return os.path.relpath(path, tmp), next(csv.reader(f)), out


@pytest.mark.parametrize("pol", ["x", "y", "xy", "circular_left"])
def test_run_autocorr_fakebackend_writes_reference_csv(pol, tmp_path):
    """Same file name and columns as the reference's run_autocorr with
    use_fakebackend=1; A(0) is the ancilla and readout factor."""
    from dtc_tpu.experiments.autocorr import run_autocorr as j_run
    from dtc_tpu.utils.config import SimConfig as JConfig
    from dtc_tpu_torch.experiments.autocorr import run_autocorr

    kw = dict(L=6, tf=3, use_fakebackend=1, n_trajectories=4,
              polarization=pol, fake_device="garnet" if pol == "y" else
              "brisbane")
    disorder = str(tmp_path / "disorder")
    ref = _header_and_name(lambda c, d: j_run(
        c, out_dir=d, disorder_dir=disorder), JConfig(**kw),
        str(tmp_path / "ref"))
    got = _header_and_name(lambda c, d: run_autocorr(
        c, device="cpu", out_dir=d, disorder_dir=disorder), SimConfig(**kw),
        str(tmp_path / "port"))
    assert got[:2] == ref[:2]
    np.testing.assert_allclose(got[2]["av_autocorr"][0],
                               ref[2]["av_autocorr"][0], rtol=1e-12)
    assert np.all(np.abs(got[2]["av_autocorr_echo"]) <= 1.0)


@pytest.mark.parametrize("sub", ["polarization", "xy-cycle"])
def test_cli_studies_run_device_noise(sub, tmp_path, caplog):
    import logging

    from dtc_tpu_torch.utils.cli import main

    with caplog.at_level(logging.INFO, logger="dtc_tpu_torch"):
        main([sub, "--device", "cpu", "--L", "14", "--tf", "2",
              "--n_trajectories", "2", "--use_fakebackend", "1",
              "--out_dir", str(tmp_path), "--disorder_dir", str(tmp_path)])
    assert "device_forward_sweep: engine=x_kernel" in caplog.text
    assert "device_echo_sweep: engine=general" in caplog.text
    assert any(f.endswith(".csv") for f in os.listdir(tmp_path))


def test_sweeps_take_injected_uniforms():
    """A sweep on injected blocks equals the engine on the same blocks,
    averaged; the blocks are checked."""
    cfg = _cfg(L=6, tf=3, inst=1, n_trajectories=3)
    hs, phis = generate_disorder(6, 1, seed=2)
    sched, params, _ = build_context(cfg, hs, phis, device="cpu")
    keys = jax.random.split(jax.random.PRNGKey(1), 3)
    u = _split_uniforms(keys, 3, EPK, 6)
    got = ds.device_forward_sweep(cfg, sched, params,
                                  uniforms=tuple(b[None] for b in u))
    p1, p2, af = ds._rates(cfg, torch.device("cpu"))
    want = de.device_sigma_forward_batch(
        params[0][0], params[1][0], p1, p2, sched.angles, u, L=6, T=3, q=3,
        ancilla_factor=af).mean(0).numpy()
    np.testing.assert_allclose(got[0], want, atol=1e-6, rtol=0)
    with pytest.raises(ValueError, match="uniforms shape"):
        ds.device_forward_sweep(cfg, sched, params, uniforms=u)
