"""Streamed lab-frame entries (the large-L CUDA family K10a/K10b and its
plain versions) and the engine's ``general_hi`` route.

On the CPU the entries run the plain versions, which are held against the
JAX package's single-chip general route: the cycle scans of
``make_sharded_autocorr_forward_general`` / ``make_sharded_echo_general`` on
a (1,1) mesh, as ``engine._singlechip_general_fn`` builds them, with the
HBM-streamed kernels K10a/K10b (``pallas_cycle_hi_general.py``) in
interpret mode at L=22 (``DTC_TPU_SHARDED_HI_MIN_LB=22``, as the JAX suite's
``test_general_hi_cycle_kernel_sharded_parity`` runs them). Both are fed the
same per-trajectory uniforms (drawn in JAX, passed as numpy): 1e-4, the
reference's own bound. The kernels themselves are compared with these plain
versions on the card by ``test_torch_kernels_cuda.py`` and
``chip_smoke.py``.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dtc_tpu.io.disorder import generate_disorder
from dtc_tpu.models.drives import build_kick_schedule as j_sched
from dtc_tpu.parallel.mesh import make_mesh
from dtc_tpu.parallel.sharded import (
    make_sharded_autocorr_forward_general,
    make_sharded_echo_general,
)
from dtc_tpu_torch.experiments.autocorr import run_autocorr
from dtc_tpu_torch.models.drives import build_kick_schedule
from dtc_tpu_torch.ops import cycle_hi_general as chg
from dtc_tpu_torch.ops import resident_general as rg
from dtc_tpu_torch.ops import routes
from dtc_tpu_torch.ops.params_general import (
    LANE_COUNT,
    flag_base,
    general_echo_rows,
    general_forward_rows,
)
from dtc_tpu_torch.utils import profiling
from dtc_tpu_torch.utils.config import SimConfig
from dtc_tpu_torch.utils.convert import from_reference

torch.set_num_threads(2)

L, T, P, AF = 22, 2, 0.6, 0.8
CASES = [("y", 11), ("y", 16), ("circular_left", 11), ("circular_left", 16)]


def _inputs(pol, shape):
    """The JAX suite's disorder (seed 7), the schedule, one trajectory key
    and its uniforms of ``shape`` as the reference draws them."""
    hs, phis = generate_disorder(L, 1, seed=7)
    hs, phis = hs[:, :L], phis[:, :L - 1]
    sched = j_sched(pol, 0.97, T)
    keys = jax.random.split(jax.random.PRNGKey(9), 1)
    u = np.asarray(jax.vmap(lambda k: jax.random.uniform(
        k, shape, dtype=jnp.float32))(keys)).reshape(1, 1, -1, L)
    jargs = (sched.angles, jnp.asarray(hs[0]), jnp.asarray(phis[0]), keys)
    return from_reference(hs, phis, np.asarray(sched.angles), u), jargs


def _jax_fn(monkeypatch, maker, pol, q):
    monkeypatch.setenv("DTC_TPU_SHARDED_HI_MIN_LB", str(L))
    K = j_sched(pol, 0.97, T).K
    mesh = make_mesh(n_amp=1, n_traj=1, devices=jax.devices()[:1])
    return maker(mesh, L=L, T=T, K=K, p=P, q=q, ancilla_factor=AF,
                 interpret=True)


@pytest.mark.parametrize("pol,q", CASES)
def test_plain_forward_matches_reference_interpret(monkeypatch, pol, q):
    """K10a on the (1,1) mesh against the plain forward entry: T=2, so A(1)
    is the first cycle's K slots, measured on the last."""
    fn = _jax_fn(monkeypatch, make_sharded_autocorr_forward_general, pol, q)
    K = j_sched(pol, 0.97, T).K
    (hs, phis, angles, u), jargs = _inputs(pol, (T * K, L))
    ref = np.asarray(fn(*jargs))
    rows = general_forward_rows(u, hs[:, None], phis[:, None], angles, L=L,
                                T=T, K=K, p=P)
    got = chg.general_hi_forward_batch(rows, L=L, T=T, q=q,
                                       ancilla_factor=AF).numpy()
    assert got.shape == (1, 1, T)
    np.testing.assert_allclose(got[0, 0], ref, atol=1e-4, rtol=0)
    assert abs(got[0, 0, 1]) > 1e-4  # the cycle left a signal to compare


@pytest.mark.parametrize("pol,q", CASES)
def test_plain_echo_matches_reference_interpret(monkeypatch, pol, q):
    """K10b (with K10a's forward cycles) on the (1,1) mesh against the plain
    echo entry at t=T: 2TK steps, the inverse ones reversed and daggered."""
    fn = _jax_fn(monkeypatch, make_sharded_echo_general, pol, q)
    K = j_sched(pol, 0.97, T).K
    (hs, phis, angles, u), jargs = _inputs(pol, (2 * T, K, L))
    ref = float(fn(*jargs, jnp.asarray(T)))
    tiles = general_echo_rows(u, torch.tensor([T]), hs[:, None],
                              phis[:, None], angles, L=L, T=T, K=K, p=P)
    got = chg.general_hi_echo_batch(tiles, L=L, q=q,
                                    ancilla_factor=AF).numpy()
    assert got.shape == (1, 1, 1)
    np.testing.assert_allclose(got[0, 0, 0], ref, atol=1e-4, rtol=0)


def test_noiseless_echo_is_one_and_t0_is_the_basis_sign():
    """Without noise every pair returns to its basis state (A0 = 1); a pair
    at t=0 runs no step and gives z_q of its basis state."""
    Lr, Tr = 22, 2
    hs, phis = (torch.as_tensor(a[:, :n]) for a, n in zip(
        generate_disorder(Lr, 1, seed=3), (Lr, Lr - 1)))
    angles = build_kick_schedule("xy", 0.97, Tr).angles
    tiles = general_echo_rows(None, torch.tensor([0, 1]), hs[:, None],
                              phis[:, None], angles, L=Lr, T=Tr, K=2, p=0.0,
                              batch=(1, 1))
    got = chg.general_hi_echo_batch(tiles, L=Lr, q=1, initial_state="neel")
    np.testing.assert_allclose(got.numpy(), 1.0, atol=1e-4)
    assert tiles[0, 0, 0, 0, flag_base(Lr) + LANE_COUNT] == 0.0


@pytest.mark.parametrize("Lr", [23, 24, 26, 28, 29, 30])
def test_engine_routes_large_general_drives(Lr):
    """Non-x drives in complex64 take general_hi at 24 <= L <= 29; L=23
    stays on K4's route, L=30 and complex128 on the sigma engine, and a
    constant x drive on the streamed x route."""
    q = SimConfig(L=Lr).probe_qubit
    want = ("general" if Lr == 23 else "sigma" if Lr == 30 else
            "general_hi")
    for pol in ("y", "xy", "yx", "circular_left", "circular_static",
                "xy_cycle"):
        angles = build_kick_schedule(pol, 0.97, 6).angles
        kw = dict(L=Lr, T=6, q=q, has_y=True)
        for echo in (False, True):
            assert routes.engine_for(angles, dtype_name="complex64",
                                     echo=echo, **kw) == want, (pol, echo)
            assert routes.engine_for(angles, dtype_name="complex128",
                                     echo=echo, **kw) == "sigma"
    ramp = build_kick_schedule("x", 0.97, 6).angles.clone()
    ramp[:, 0, 0] *= torch.linspace(0.9, 1.1, 6, dtype=ramp.dtype)
    assert routes.engine_for(ramp, L=Lr, T=6, q=q, has_y=False,
                             dtype_name="complex64", echo=False) == want
    x = build_kick_schedule("x", 0.97, 6).angles
    assert routes.engine_for(x, L=Lr, T=6, q=q, has_y=False,
                             dtype_name="complex64", echo=False) == (
        "blocked" if Lr == 23 else "streamed")


def test_engine_keeps_k4_step_limit():
    y = build_kick_schedule("y", 0.97, rg.MAX_STEPS // 2 + 1).angles
    kw = dict(L=26, T=y.shape[0], q=13, has_y=True, dtype_name="complex64")
    assert routes.engine_for(y, echo=False, **kw) == "general_hi"
    assert routes.engine_for(y, echo=True, **kw) == "sigma"


def test_kernel_chunks_at_l29():
    """Two 4 GiB states per launch at L=29 (the 8 GiB budget)."""
    assert routes.kernel_chunks(1, 4, 1, 29) == (1, 2, 1)
    assert routes.kernel_chunks(2, 1, 6, 29) == (1, 1, 2)


def test_sweep_split_to_one_state_equals_unsplit(monkeypatch):
    """At L=22 through the general_hi route (a y drive), a sweep whose state
    budget holds one state splits instances, trajectories and t values into
    one-state launches and gives the numbers of the unsplit sweep."""
    monkeypatch.setattr(rg, "MAX_L", 21)
    monkeypatch.setattr(chg, "MIN_ROUTE_L", 22)
    cfg = SimConfig(L=L, tf=2, inst=2, n_trajectories=2, noise_prob=0.3,
                    polarization="y")
    sizes = []
    for name in ("general_hi_forward_batch", "general_hi_echo_batch"):
        fn = getattr(chg, name)

        def counted(x, *a, _fn=fn, **k):
            sizes.append(math.prod(x.shape[:-2]))
            return _fn(x, *a, **k)

        monkeypatch.setattr(chg, name, counted)
    whole = run_autocorr(cfg, device="cpu", write=False)
    assert max(sizes) == 8  # the echo's 2 instances x 2 trajectories x 2 t
    sizes.clear()
    monkeypatch.setattr(routes, "KERNEL_STATE_BYTES", 8 << L)
    split = run_autocorr(cfg, device="cpu", write=False)
    assert max(sizes) == 1 and len(sizes) == 4 + 2 * 4
    for k in ("autocorr_per_instance", "echo_per_instance"):
        np.testing.assert_allclose(split[k], whole[k], atol=1e-6, rtol=0)
    assert whole["autocorr_per_instance"][0, 0] == pytest.approx(0.7 ** 6)


def test_entries_reject_out_of_range():
    rows = torch.zeros((1, 2, 128))
    for Lr, q in ((21, 3), (30, 3), (22, 22), (22, -1)):
        with pytest.raises(ValueError):
            chg.general_hi_forward_batch(rows, L=Lr, T=2, q=q)
    with pytest.raises(ValueError):
        chg.general_hi_forward_batch(torch.zeros((1, rg.MAX_STEPS + 1, 128)),
                                     L=22, T=rg.MAX_STEPS + 1, q=3)
    with pytest.raises(ValueError):
        chg.general_hi_echo_batch(torch.zeros((1, 2 * rg.MAX_STEPS + 2, 128)),
                                  L=22, q=3)
    with pytest.raises(ValueError):  # neither CPU (plain) nor CUDA (kernel)
        chg.general_hi_forward_batch(rows.to("meta"), L=22, T=2, q=3)


def test_wrapper_routes_cpu_to_plain_version():
    hs, phis = torch.zeros((1, L)), torch.zeros((1, L - 1))
    rows = general_forward_rows(None, hs[:, None], phis[:, None],
                                build_kick_schedule("y", 0.97, 2).angles,
                                L=L, T=2, K=1, p=0.0, batch=(1, 1))
    profiling.reset_counters()
    a = chg.general_hi_forward_batch(rows, L=L, T=2, q=0)
    b = chg.general_hi_forward_batch_ref(rows, L=L, T=2, q=0)
    assert torch.equal(a, b)
    # RY(pi g) on |0...0>, no field: <Z_0> = cos(pi g)
    np.testing.assert_allclose(a[0, 0, 1], math.cos(0.97 * math.pi),
                               atol=1e-6)
    assert not profiling.LAUNCHES
    assert not profiling.PLAIN_ON_CUDA
