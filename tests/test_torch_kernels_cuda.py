"""CUDA kernels K1/K2 (constant x), K3a/K3b (constant or per-cycle x at
14 <= L <= 21), the streamed x family (constant x at 22 <= L <= 30), K4
(lab frame, any drive), K5 (per-cycle observables), the streamed
lab-frame family (K10a/K10b, any drive at 22 <= L <= 29), the per-shard
cycle kernels K8a-d (one cycle at 17 <= L_loc <= 23), the per-shard
streamed cycle kernels K9a/K9b and K10's shard-local forms (one cycle at
22 <= L_loc <= 30) and the planar engine's noise factor K11 against their
plain versions, on the card; the planar route and the device-noise rows
on the kernels against the same calls on the CPU.

These tests need an NVIDIA GPU (the kernels have no CPU mode) and skip
without one. They import neither jax nor ``tests/conftest.py``'s setup, so
on a machine with a card and no jax they run as
``python -m pytest --noconftest -q -m cuda tests/test_torch_kernels_cuda.py``.
Tolerance 1e-4: f32 sums over 2^L amplitudes in another order than the
plain version's; K5's energy sums reach sum|th| + sum|tph| (tens at L=20)
and its x sum L, so e_diag is held to 1e-4 * (sum|th| + sum|tph|) and
x_sum to 1e-4 * L. From a random unit state of 2^L amplitudes the state
and the partial are held to ``_unit_tol(L)`` = 1e-3 * 2^(-L/2), one part
in 10^3 of a typical amplitude.
"""

import math

import numpy as np
import pytest
import torch

from dtc_tpu_torch.core.statevector import basis_index
from dtc_tpu_torch.experiments import adaptive
from dtc_tpu_torch.experiments.autocorr import run_autocorr
from dtc_tpu_torch.experiments.energy import run_energy
from dtc_tpu_torch.models.hamiltonian import hamiltonian_terms
from dtc_tpu_torch.io.disorder import generate_disorder
from dtc_tpu_torch.models.drives import build_kick_schedule
from dtc_tpu_torch.ops import cycle as cy
from dtc_tpu_torch.ops import cycle_hi as ch
from dtc_tpu_torch.ops import cycle_hi_general as chg
from dtc_tpu_torch.ops import resident_blocked as rb
from dtc_tpu_torch.ops import observables as obs
from dtc_tpu_torch.ops import resident as rs
from dtc_tpu_torch.ops import resident_general as rg
from dtc_tpu_torch.ops import streamed as sm
from dtc_tpu_torch.ops.params import echo_pair_tiles, forward_rows
from dtc_tpu_torch.parallel import sharded as sh
from dtc_tpu_torch.parallel.mesh import make_mesh
from dtc_tpu_torch.ops.params_general import (
    LANE_U8,
    flag_base,
    general_echo_rows,
    general_forward_rows,
    general_hi_width,
    kick_kind,
    slot_u8,
)
from dtc_tpu_torch.utils import profiling
from dtc_tpu_torch.utils.config import SimConfig

THETA = 0.97 * np.pi
TOL = 1e-4
K8 = ("K8a", "K8b", "K8c", "K8d")
K9 = ("K9a", "K9b", "K10a.local", "K10b.local")


def _launched(*kids) -> int:
    """Kernel-route calls of the entries ``kids`` (``dtc.entry.<kid>``) in
    the launch registry."""
    return sum(profiling.LAUNCHES[profiling.ENTRY + k] for k in kids)


def _plain_on_cuda(*kids) -> int:
    """Their plain versions' calls on CUDA tensors."""
    return sum(profiling.PLAIN_ON_CUDA[profiling.ENTRY + k] for k in kids)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from dtc_tpu_torch.ops.precision import set_fp32_policy

    set_fp32_policy()
    return torch.device("cuda")


def _disorder(L, device):
    hs, phis = generate_disorder(L, 1, seed=7)
    return (torch.as_tensor(hs[:, :L], device=device),
            torch.as_tensor(phis[:, :L - 1], device=device))


@pytest.mark.cuda
@pytest.mark.parametrize("L,T,state", [(17, 4, "neel"), (20, 8, "vacuum"),
                                       (23, 3, "vacuum")])
def test_forward_kernel_matches_plain_on_card(cuda_device, L, T, state):
    hs, phis = _disorder(L, cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(L)
    u = torch.rand((1, 3, T, L), generator=gen, device=cuda_device)
    rows, sig = forward_rows(u, hs[:, None], phis[:, None], L=L, T=T, p=0.1)
    launches = _launched("K1")
    k = rb.blocked_forward_batch(rows, sig, THETA, L=L, q=L // 2,
                                 initial_state=state)
    torch.cuda.synchronize()
    assert _launched("K1") == launches + 1
    ref = rb.blocked_forward_batch_ref(rows, sig, THETA, L=L, q=L // 2,
                                       initial_state=state)
    assert float((k - ref).abs().max()) <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("L,T,state", [(17, 3, "neel"), (20, 4, "vacuum"),
                                       (23, 2, "vacuum")])
def test_echo_kernel_matches_plain_on_card(cuda_device, L, T, state):
    hs, phis = _disorder(L, cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    u = torch.rand((1, 2, 2 * T, L), generator=gen, device=cuda_device)
    ts = torch.arange(1, T + 1, device=cuda_device)
    for p in (0.6, 0.0):
        tiles, sig = echo_pair_tiles(u, ts, hs[:, None], phis[:, None], L=L,
                                     T=T, p=p)
        k = rb.blocked_echo_batch(tiles, sig, THETA, L=L, q=L // 2,
                                  initial_state=state)
        torch.cuda.synchronize()
        ref = rb.blocked_echo_batch_ref(tiles, sig, THETA, L=L, q=L // 2,
                                        initial_state=state)
        assert float((k - ref).abs().max()) <= TOL
        if p == 0:
            assert float((k - 1).abs().max()) <= TOL


@pytest.mark.cuda
def test_kernel_wrappers_reject_bad_inputs(cuda_device):
    rows = torch.zeros((1, 3, 128), device=cuda_device)
    sig = torch.zeros((1, 3), dtype=torch.int64, device=cuda_device)
    with pytest.raises(ValueError, match="float32"):
        rb.blocked_forward_batch(rows.double(), sig, THETA, L=17, q=3)
    with pytest.raises(ValueError, match="contiguous"):
        rb.blocked_forward_batch(
            torch.zeros((1, 3, 256), device=cuda_device)[..., ::2], sig,
            THETA, L=17, q=3)
    with pytest.raises(ValueError, match="shape"):
        rb.blocked_forward_batch(torch.zeros((1, 3, 64), device=cuda_device),
                                 sig, THETA, L=17, q=3)


@pytest.mark.cuda
def test_autocorr_on_card_runs_the_kernels_and_matches_cpu(cuda_device):
    """The same injected uniforms through the CPU (plain versions) and the
    card (kernels): per-instance A and A0 agree at 1e-4."""
    cfg = SimConfig(L=17, tf=4, inst=1, n_trajectories=4, noise_prob=0.3)
    rng = np.random.default_rng(0)
    u = (rng.random((1, 4, 4, 17), dtype=np.float32),
         rng.random((1, 4, 8, 17), dtype=np.float32))
    profiling.reset_counters()
    got = run_autocorr(cfg, device="cuda", write=False, uniforms=u)
    assert _launched("K1") >= 1 and _launched("K2") >= 1
    assert not _plain_on_cuda("K1", "K2")
    ref = run_autocorr(cfg, device="cpu", write=False, uniforms=u)
    for k in ("autocorr_per_instance", "echo_per_instance"):
        np.testing.assert_allclose(got[k], ref[k], atol=TOL, rtol=0)


@pytest.mark.cuda
def test_sigma_engine_on_card_matches_cpu(cuda_device):
    """Shapes no kernel serves (here L=8) run the torch sigma engine on the
    card; with the same uniforms it agrees with the CPU run at 1e-5."""
    cfg = SimConfig(L=8, tf=6, inst=2, n_trajectories=8, noise_prob=0.2)
    rng = np.random.default_rng(1)
    u = (rng.random((2, 8, 6, 8), dtype=np.float32),
         rng.random((2, 8, 12, 8), dtype=np.float32))
    got = run_autocorr(cfg, device="cuda", write=False, uniforms=u)
    ref = run_autocorr(cfg, device="cpu", write=False, uniforms=u)
    for k in ("autocorr_per_instance", "echo_per_instance"):
        np.testing.assert_allclose(got[k], ref[k], atol=1e-5, rtol=0)


GENERAL_CASES = [(14, "y", "neel", 0), (17, "xy", "vacuum", 16),
                 (20, "circular_left", "vacuum", 10),
                 (23, "xy_cycle", "neel", 22), (20, "x", "neel", 3)]

# The kick kinds that the lab-frame kernels choose from a step's U
# (``csrc/floquet_lab.cuh``): the drive's own rows (RX, RY, or both in one
# launch), or the same rows with the U of one step row a trajectory or pair
# planted: a general 2x2 (both angles non-zero, so no entry of U is zero),
# or an RX off by one non-zero lane; both take the general butterfly.
KICKS = ["drive", "general", "near_rx"]


def _plant_u(rows, L, kick, row=1):
    """``rows`` with the U lanes of row ``row`` of every trajectory (an
    echo's pre row of step s is row 2s) set as ``kick`` says."""
    if kick == "drive":
        return rows
    if kick == "general":
        u8 = slot_u8(torch.tensor(0.9), torch.tensor(0.6))
        assert bool((u8 != 0).all())
    else:
        u8 = slot_u8(torch.tensor(0.97 * math.pi), torch.tensor(0.0))
        assert int(kick_kind(u8)) == 0  # an RX
        u8[2] = 1e-3                    # re a01
    assert int(kick_kind(u8)) == 2
    rows = rows.clone()
    fo = flag_base(L) + LANE_U8
    rows[..., row, fo:fo + 8] = u8.to(rows.device)
    return rows


@pytest.mark.cuda
@pytest.mark.parametrize("kick", KICKS)
@pytest.mark.parametrize("L,pol,state,q", GENERAL_CASES)
def test_general_forward_kernel_matches_plain_on_card(cuda_device, L, pol,
                                                      state, q, kick):
    T = 4 if L < 23 else 3
    hs, phis = _disorder(L, cuda_device)
    angles = build_kick_schedule(pol, 0.97, T, xy_cycle_period=1,
                                 device=cuda_device).angles
    K = angles.shape[1]
    gen = torch.Generator(device=cuda_device).manual_seed(L)
    u = torch.rand((1, 3, T * K, L), generator=gen, device=cuda_device)
    rows = _plant_u(general_forward_rows(u, hs[:, None], phis[:, None],
                                         angles, L=L, T=T, K=K, p=0.1),
                    L, kick)
    launches = _launched("K4.forward")
    k = rg.general_forward_batch(rows, L=L, T=T, q=q, initial_state=state)
    torch.cuda.synchronize()
    assert _launched("K4.forward") == launches + 1
    ref = rg.general_forward_batch_ref(rows, L=L, T=T, q=q,
                                       initial_state=state)
    assert float((k - ref).abs().max()) <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("kick", KICKS)
@pytest.mark.parametrize("L,pol,state,q", GENERAL_CASES)
def test_general_echo_kernel_matches_plain_on_card(cuda_device, L, pol,
                                                   state, q, kick):
    T = 3 if L < 23 else 2
    hs, phis = _disorder(L, cuda_device)
    angles = build_kick_schedule(pol, 0.97, T, xy_cycle_period=1,
                                 device=cuda_device).angles
    K = angles.shape[1]
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    u = torch.rand((1, 2, 2 * T * K, L), generator=gen, device=cuda_device)
    ts = torch.arange(0, T + 1, device=cuda_device)
    for p in (0.6, 0.0):
        tiles = _plant_u(general_echo_rows(u, ts, hs[:, None],
                                           phis[:, None], angles, L=L, T=T,
                                           K=K, p=p), L, kick, row=2)
        k = rg.general_echo_batch(tiles, L=L, q=q, initial_state=state)
        torch.cuda.synchronize()
        ref = rg.general_echo_batch_ref(tiles, L=L, q=q, initial_state=state)
        assert float((k - ref).abs().max()) <= TOL
        if p == 0 and kick == "drive":  # a planted step is not undone
            assert float((k - 1).abs().max()) <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("state", ["vacuum", "neel"])
@pytest.mark.parametrize("L", [14, 17, 20, 23])
def test_general_forward_on_step_passes_matches_plain_on_card(cuda_device, L,
                                                              state):
    """K4's forward on the step passes (K2's split a = L - L/2) against its
    plain version: y and xy, T=1 (no step runs) and T=4, probes in pass
    lo's bits (0, a - 1) and pass hi's (a, L - 1)."""
    hs, phis = _disorder(L, cuda_device)
    a = L - L // 2
    for pol in ("y", "xy"):
        for T in (1, 4):
            angles = build_kick_schedule(pol, 0.97, T,
                                         device=cuda_device).angles
            K = angles.shape[1]
            gen = torch.Generator(device=cuda_device).manual_seed(L + T)
            u = torch.rand((1, 3, T * K, L), generator=gen,
                           device=cuda_device)
            rows = general_forward_rows(u, hs[:, None], phis[:, None], angles,
                                        L=L, T=T, K=K, p=0.1)
            for q in (0, a - 1, a, L - 1):
                launches = _launched("K4.forward")
                k = rg.general_forward_batch(rows, L=L, T=T, q=q,
                                             initial_state=state)
                torch.cuda.synchronize()
                assert _launched("K4.forward") == launches + 1
                ref = rg.general_forward_batch_ref(rows, L=L, T=T, q=q,
                                                   initial_state=state)
                assert k.shape == ref.shape == (1, 3, T)
                assert float((k - ref).abs().max()) <= TOL, (pol, T, q)


@pytest.mark.cuda
def test_general_forward_entry_checks_its_range(cuda_device):
    """K4's forward C entry returns cudaErrorInvalidValue (1) without a
    launch for L outside 14..23, q outside [0, L), no trajectory, T < 1,
    n_steps < 0 or past the rows, and fold rows not past n_steps; in range
    it launches (0)."""
    from dtc_tpu_torch.ops import _build

    dev = cuda_device
    stream = torch.cuda.current_stream(dev).cuda_stream
    lib = _build.load("floquet_general")
    L, T, K = 14, 2, 1
    state = torch.zeros((1, 1 << L), dtype=torch.complex64, device=dev)
    rows = torch.zeros((1, T * K, 128), device=dev)
    rows[0, :, 4 * L - 1] = torch.tensor([1.0, -1.0], device=dev)  # MPOS
    fold = torch.zeros((1, T, 2 * L), device=dev)
    partials = torch.zeros((1, T, lib.floquet_general_forward_partials(L)),
                           device=dev)
    out = torch.full((1, T), 7.0, device=dev)

    def fwd(L=L, T=T, n=1, rows_per_traj=T * K, fold_rows=T, n_steps=1,
            q=0):
        return lib.floquet_general_forward(
            state.data_ptr(), rows.data_ptr(), fold.data_ptr(),
            partials.data_ptr(), out.data_ptr(), n, L, rows_per_traj,
            fold_rows, T, n_steps, q, 0, stream)

    for bad in (dict(L=13), dict(L=24), dict(q=L), dict(q=-1), dict(n=0),
                dict(T=0), dict(n_steps=-1), dict(n_steps=3),
                dict(fold_rows=1)):
        assert fwd(**bad) == 1, bad
    torch.cuda.synchronize()
    assert torch.equal(out, torch.full_like(out, 7.0))  # nothing ran
    # a zero row's kick U = 0 zeroes the state: A(0) = z_0 of the vacuum,
    # A(1) reads 0
    assert fwd() == 0
    torch.cuda.synchronize()
    assert out.tolist() == [[1.0, 0.0]]


@pytest.mark.cuda
def test_general_wrappers_reject_bad_inputs(cuda_device):
    rows = torch.zeros((1, 3, 128), device=cuda_device)
    with pytest.raises(ValueError, match="float32"):
        rg.general_forward_batch(rows.double(), L=14, T=3, q=3)
    with pytest.raises(ValueError, match="K per cycle"):
        rg.general_forward_batch(rows, L=14, T=2, q=3)
    with pytest.raises(ValueError, match="step count"):
        tiles = torch.zeros((1, 4, 128), device=cuda_device)
        tiles[0, 0, 4 * 14 - 1 + 10] = 3.0
        rg.general_echo_batch(tiles, L=14, q=3)


@pytest.mark.cuda
@pytest.mark.parametrize("pol", ["y", "xy"])
def test_general_autocorr_on_card_runs_k4_and_matches_cpu(cuda_device, pol):
    """A non-x drive at L=14 through the card (K4) and the CPU (its plain
    version) with the same uniforms: per-instance A and A0 agree at 1e-4."""
    K = 1 if pol == "y" else 2
    cfg = SimConfig(L=14, tf=4, inst=1, n_trajectories=4, noise_prob=0.3,
                    polarization=pol)
    rng = np.random.default_rng(0)
    u = (rng.random((1, 4, 4 * K, 14), dtype=np.float32),
         rng.random((1, 4, 8 * K, 14), dtype=np.float32))
    profiling.reset_counters()
    got = run_autocorr(cfg, device="cuda", write=False, uniforms=u)
    assert _launched("K4.forward") >= 1 and _launched("K4.echo") >= 1
    assert not _plain_on_cuda("K4.forward", "K4.echo")
    ref = run_autocorr(cfg, device="cpu", write=False, uniforms=u)
    for k in ("autocorr_per_instance", "echo_per_instance"):
        np.testing.assert_allclose(got[k], ref[k], atol=TOL, rtol=0)


# (L, drive, state, component, p, T); 3 trajectories of different rows
# each. The range's ends (pass lo's tile of 2^7 and 2^12 amplitudes, two
# tuples a thread in some rounds from L = 16), K = 1 and K = 2 (xy,
# circular_left), with_x off (z_zz), T = 1 (the measure only) and T*K past
# one reduce chunk at L = 14 (``obs.chunk_cycles``: 6 cycles; 3
# trajectories at L = 23 walk 8 tiles a block, whose chunk holds 744
# cycles: ``test_observables_walks_past_one_chunk_agree_at_l23_on_card``
# takes L = 23 past its chunks).
OBS_CASES = [(14, "x", "vacuum", "full", 0.0, 4),
             (14, "circular_left", "neel", "x_only", 0.3, 4),
             (14, "xy", "vacuum", "full", 0.3, 1),
             (14, "xy", "neel", "full", 0.3, 20),
             (17, "y", "neel", "z_zz", 0.3, 4),
             (17, "xy", "vacuum", "full", 0.3, 4),
             (20, "x", "vacuum", "full", 0.3, 4),
             (20, "xy", "neel", "x_only", 0.0, 4),
             (22, "xy_cycle", "neel", "full", 0.3, 3),
             (23, "y", "vacuum", "full", 0.3, 3),
             (23, "circular_left", "vacuum", "z_zz", 0.0, 3),
             (23, "x", "neel", "full", 0.3, 133)]


def _obs_inputs(device, L, pol, component, p, T, inst=1, n=3):
    hs, phis = generate_disorder(L, inst, seed=7)
    hs = torch.as_tensor(hs[:, :L], device=device)
    phis = torch.as_tensor(phis[:, :L - 1], device=device)
    terms = [hamiltonian_terms(L, 0.97, hs[i], phis[i], component)
             for i in range(inst)]
    angles = build_kick_schedule(pol, 0.97, T, device=device).angles
    K = angles.shape[1]
    gen = torch.Generator(device=device).manual_seed(L)
    u = torch.rand((inst, n, T * K, L), generator=gen, device=device)
    rows = general_forward_rows(u, hs[:, None], phis[:, None], angles, L=L,
                                T=T, K=K, p=p)
    erow = obs.energy_row(torch.stack([t.hs for t in terms]),
                          torch.stack([t.phis for t in terms]), L)[:, None]
    scale = float(max(t.hs.abs().sum() + t.phis.abs().sum() for t in terms))
    return rows, erow, terms[0].x_coeff != 0.0, scale


def _held_obs(k, ref, L, scale):
    for name, a, b, tol in zip(("e_diag", "x_sum", "zs"), k, ref,
                               (TOL * scale, TOL * L, TOL)):
        assert float((a - b).abs().max()) <= tol, name


@pytest.mark.cuda
@pytest.mark.parametrize("kick", KICKS)
@pytest.mark.parametrize("L,pol,state,component,p,T", OBS_CASES)
def test_observables_kernel_matches_plain_on_card(cuda_device, L, pol, state,
                                                  component, p, T, kick):
    rows, erow, with_x, scale = _obs_inputs(cuda_device, L, pol, component,
                                            p, T)
    rows = _plant_u(rows, L, kick)
    if p > 0:  # the trajectories' rows differ
        assert not torch.equal(rows[0, 0], rows[0, 1])
    launches = _launched("K5")
    k = obs.observables_forward_batch(rows, erow, L=L, T=T,
                                      initial_state=state, with_x=with_x)
    torch.cuda.synchronize()
    assert _launched("K5") == launches + 1
    ref = obs.observables_forward_batch_ref(rows, erow, L=L, T=T,
                                            initial_state=state,
                                            with_x=with_x)
    _held_obs(k, ref, L, scale)
    if not with_x:
        assert not k[1].any()


@pytest.mark.cuda
def test_observables_entry_checks_its_range(cuda_device):
    """The C entry returns cudaErrorInvalidValue (1) without a launch for
    arguments out of its range: L, T, rows not K per cycle, fold rows short
    of the last step's, a chunk below 1; in range it launches (0)."""
    from dtc_tpu_torch.ops import _build

    from dtc_tpu_torch.ops.params_general import LANE_U8, flag_base

    lib = _build.load("floquet_general")
    L, T, K = 14, 3, 2
    dev = cuda_device
    slots = lib.floquet_general_observables_slots(L, 1)
    for bad in (0, 3, 32):
        assert lib.floquet_general_observables_slots(L, bad) == -1, bad
    state = torch.zeros((1, 1 << L), dtype=torch.complex64, device=dev)
    rows = torch.zeros((1, T * K, 128), device=dev)
    u8 = flag_base(L) + LANE_U8
    rows[..., u8] = rows[..., u8 + 6] = 1.0  # U = 1, no noise, h = phi = 0
    fold = torch.zeros((1, T * K + 1, 2 * L), device=dev)
    erow = torch.zeros((1, 128), device=dev)
    part = torch.zeros((1, T, slots), device=dev)
    out = torch.full((1, T, 2 + L), 7.0, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def call(L=L, S=T * K, fold_rows=T * K + 1, T=T, chunk=T, tiles=1):
        return lib.floquet_general_observables(
            state.data_ptr(), rows.data_ptr(), fold.data_ptr(),
            erow.data_ptr(), part.data_ptr(), out.data_ptr(), 1, L, S,
            fold_rows, T, chunk, 1, tiles, 0, stream)

    for bad in (dict(L=13), dict(L=24), dict(T=0), dict(S=T * K + 1),
                dict(S=0), dict(fold_rows=(T - 1) * K + 1), dict(chunk=0),
                dict(tiles=0), dict(tiles=3), dict(tiles=32)):
        assert call(**bad) == 1, bad
    torch.cuda.synchronize()
    assert torch.equal(out, torch.full_like(out, 7.0))  # nothing ran
    assert call() == 0
    torch.cuda.synchronize()
    # the identity steps keep the vacuum: z_q = 1, no energy, no x pairs
    assert torch.equal(out[..., 2:], torch.ones_like(out[..., 2:]))
    assert not out[..., :2].any()


@pytest.mark.cuda
def test_observables_kernel_two_instances_equal_single_calls(cuda_device):
    L, T = 17, 3
    rows, erow, _, scale = _obs_inputs(cuda_device, L, "xy", "full", 0.3, T,
                                       inst=2)
    both = obs.observables_forward_batch(rows, erow, L=L, T=T)
    for i in range(2):
        one = obs.observables_forward_batch(rows[i:i + 1], erow[i:i + 1],
                                            L=L, T=T)
        _held_obs([a[i:i + 1] for a in both], one, L, scale)
        ref = obs.observables_forward_batch_ref(rows[i:i + 1],
                                                erow[i:i + 1], L=L, T=T)
        _held_obs(one, ref, L, scale)


# The edges of pass lo's walk (``obs.walk_tiles``): one trajectory (one
# tile a block to L = 20, 4 at L = 23) and 256 (the energy cell's launch:
# 8 to 16 tiles a block from L = 14 to 23), x (a measure every step) and
# xy (K = 2: steps that open no cycle walk the same tiles with the plain
# rounds), with_x on and off. The kernel's launch of 256 is held to the
# plain version on its first two and last trajectories.
WALK_CASES = [(L, n, pol, comp) for L in (14, 17, 20, 23) for n in (1, 256)
              for pol, comp in (("x", "full"), ("xy", "z_zz"))]


@pytest.mark.cuda
@pytest.mark.parametrize("L,n,pol,component", WALK_CASES)
def test_observables_walk_matches_plain_on_card(cuda_device, L, n, pol,
                                                component):
    T = 3
    rows, erow, with_x, scale = _obs_inputs(cuda_device, L, pol, component,
                                            0.1, T, n=n)
    assert with_x == (component == "full")
    tiles = obs.walk_tiles(L, n)
    assert tiles == (1 if L <= 20 else 4) if n == 1 else tiles >= 8
    walks = profiling.OBS_TILES[tiles]
    k = obs.observables_forward_batch(rows, erow, L=L, T=T, with_x=with_x)
    torch.cuda.synchronize()
    assert profiling.OBS_TILES[tiles] == walks + 1
    some = [0, 1, n - 1] if n > 2 else list(range(n))
    ref = obs.observables_forward_batch_ref(rows[:, some], erow, L=L, T=T,
                                            with_x=with_x)
    _held_obs([a[:, some] for a in k], ref, L, scale)
    if not with_x:
        assert not k[1].any()


@pytest.mark.cuda
def test_observables_walk_past_one_chunk_matches_plain_on_card(cuda_device):
    """256 trajectories at L = 14 (walks of 8 tiles), T one cycle past a
    reduce chunk of the walk's slots: the second chunk's lanes."""
    from dtc_tpu_torch.ops import _build

    L, n = 14, 256
    tiles = obs.walk_tiles(L, n)
    slots = _build.load("floquet_general").floquet_general_observables_slots(
        L, tiles)
    T = obs.chunk_cycles(L, obs.MAX_STEPS, slots) + 1
    rows, erow, _, scale = _obs_inputs(cuda_device, L, "xy", "full", 0.1, T,
                                       n=n)
    k = obs.observables_forward_batch(rows, erow, L=L, T=T)
    some = [0, 1, n - 1]
    ref = obs.observables_forward_batch_ref(rows[:, some], erow, L=L, T=T)
    _held_obs([a[:, some] for a in k], ref, L, scale)


@pytest.mark.cuda
def test_observables_walks_past_one_chunk_agree_at_l23_on_card(cuda_device):
    """One trajectory at L = 23: one tile a block, T = 133, one cycle past
    its reduce chunk of 132, against the plain version; then the entry's
    walk of 4 tiles at T = 432, one cycle past its chunk of 431, against
    one tile a block (four chunks) on the same rows: the steps are the same
    arithmetic whatever the walk, so only the sums' order differs (the
    plain version's float32 rounding over 864 steps is larger)."""
    from dtc_tpu_torch.ops import _build

    L = 23
    lib = _build.load("floquet_general")
    kw = dict(L=L, initial_state="vacuum", with_x=True)
    assert obs.chunk_cycles(L, obs.MAX_STEPS,
                            lib.floquet_general_observables_slots(L, 1)) \
        == 132
    rows, erow, _, scale = _obs_inputs(cuda_device, L, "xy", "full", 0.1,
                                       133, n=1)
    k = obs.launch(rows, erow, T=133, tiles=1, **kw)
    ref = obs.observables_forward_batch_ref(rows, erow, L=L, T=133)
    _held_obs(k, ref, L, scale)
    tiles = obs.walk_tiles(L, 1)
    T = obs.chunk_cycles(
        L, obs.MAX_STEPS,
        lib.floquet_general_observables_slots(L, tiles)) + 1
    assert (tiles, T) == (4, 432)
    rows, erow, _, scale = _obs_inputs(cuda_device, L, "xy", "full", 0.1, T,
                                       n=1)
    k = obs.observables_forward_batch(rows, erow, L=L, T=T)
    one = obs.launch(rows, erow, T=T, tiles=1, **kw)
    _held_obs(k, one, L, scale)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 256])
def test_observables_kernel_repeats_bit_for_bit_on_card(cuda_device, n):
    """Two identical calls of K5 at the energy cell's shape (L = 20, x,
    p = 0.1; 256 trajectories walk 16 tiles a block) give outputs equal
    bit for bit: every sum is in a fixed order."""
    L, T = 20, 4
    rows, erow, _, _ = _obs_inputs(cuda_device, L, "x", "full", 0.1, T, n=n)
    one = obs.observables_forward_batch(rows, erow, L=L, T=T)
    two = obs.observables_forward_batch(rows, erow, L=L, T=T)
    for a, b in zip(one, two):
        assert torch.equal(a, b)


# X-mask words at the edges of the kick's packed mask (one bit a qubit):
# none, every bit, alternating bits, the two bits either side of K2's split
# (a - 1 in pass lo, a in pass hi, a = L - L/2) and the top bit L - 1.
X_MASKS = ["none", "all", "alternating", "split", "top"]


def _x_mask_lanes(pattern, L, device):
    a = L - L // 2
    bits = {"none": [], "all": range(L), "alternating": range(0, L, 2),
            "split": [a - 1, a], "top": [L - 1]}[pattern]
    lanes = torch.zeros(L, device=device)
    lanes[list(bits)] = 1.0
    return lanes


def _with_x_mask(rows, lanes, L, every=1):
    """``rows`` with the X-mask lanes [L, 2L) of every ``every``-th row
    (2: an echo's pre rows, the ones that carry its kicks) set to
    ``lanes``."""
    rows = rows.clone()
    rows[..., ::every, L:2 * L] = lanes
    return rows


@pytest.mark.cuda
@pytest.mark.parametrize("pattern", X_MASKS)
@pytest.mark.parametrize("pol,kick", [
    ("x", "drive"), ("y", "drive"), ("xy", "drive"),
    ("circular_left", "drive"), ("xy", "general"), ("x", "near_rx")])
def test_general_kernels_take_every_x_mask_on_card(cuda_device, pol, kick,
                                                   pattern):
    """K4's forward and echo and K5 on X-mask words that reach the edges of
    the kick's mask word, on every kick kind (RX, RY, both in one launch,
    and a planted general U in the same rows), against their plain versions
    at L = 17 and 23 (probes q = L - 1 and a)."""
    T = 3
    for L in (17, 23):
        a = L - L // 2
        lanes = _x_mask_lanes(pattern, L, cuda_device)
        hs, phis = _disorder(L, cuda_device)
        angles = build_kick_schedule(pol, 0.97, T,
                                     device=cuda_device).angles
        K = angles.shape[1]
        gen = torch.Generator(device=cuda_device).manual_seed(L)
        u = torch.rand((1, 2, 2 * T * K, L), generator=gen,
                       device=cuda_device)
        rows = _plant_u(_with_x_mask(general_forward_rows(
            u[..., :T * K, :], hs[:, None], phis[:, None], angles, L=L, T=T,
            K=K, p=0.1), lanes, L), L, kick)
        k = rg.general_forward_batch(rows, L=L, T=T, q=L - 1)
        ref = rg.general_forward_batch_ref(rows, L=L, T=T, q=L - 1)
        assert float((k - ref).abs().max()) <= TOL, ("forward", L)
        ts = torch.arange(0, T + 1, device=cuda_device)
        tiles = _plant_u(_with_x_mask(general_echo_rows(
            u, ts, hs[:, None], phis[:, None], angles, L=L, T=T, K=K, p=0.1),
            lanes, L, every=2), L, kick, row=2)
        k = rg.general_echo_batch(tiles, L=L, q=a)
        ref = rg.general_echo_batch_ref(tiles, L=L, q=a)
        assert float((k - ref).abs().max()) <= TOL, ("echo", L)
        orows, erow, with_x, scale = _obs_inputs(cuda_device, L, pol, "full",
                                                 0.1, T)
        orows = _plant_u(_with_x_mask(orows, lanes, L), L, kick)
        k = obs.observables_forward_batch(orows, erow, L=L, T=T,
                                          with_x=with_x)
        ref = obs.observables_forward_batch_ref(orows, erow, L=L, T=T,
                                                with_x=with_x)
        _held_obs(k, ref, L, scale)


@pytest.mark.cuda
def test_observables_wrapper_rejects_out_of_range(cuda_device):
    erow = torch.zeros((1, 128), device=cuda_device)
    for L in (13, 24):
        with pytest.raises(ValueError, match="supports"):
            obs.observables_forward_batch(
                torch.zeros((1, 3, 128), device=cuda_device), erow, L=L, T=3)
    with pytest.raises(ValueError, match="float32"):
        obs.observables_forward_batch(
            torch.zeros((1, 3, 128), device=cuda_device).double(), erow,
            L=14, T=3)


@pytest.mark.cuda
@pytest.mark.parametrize("L,dtype", [(14, "complex64"), (8, "complex64"),
                                     (8, "complex128")])
def test_energy_on_card_matches_cpu(cuda_device, L, dtype):
    """The same uniforms through the card and the CPU: at L=14 complex64
    K5 against its plain version, else the eager engine on both."""
    cfg = SimConfig(L=L, tf=4, inst=1, n_trajectories=3, noise_prob=0.2,
                    polarization="xy", dtype=dtype)
    hs, phis = generate_disorder(L, 1, seed=4)
    u = np.random.default_rng(0).random((1, 3, 8, L), dtype=np.float32)
    profiling.reset_counters()
    kw = dict(nprobs=(0.0, 0.2), write=False, uniforms=u)
    got = run_energy(cfg, hs, phis, device="cuda", **kw)
    assert _launched("K5") == (2 if L == 14 else 0)
    assert not _plain_on_cuda("K5")
    ref = run_energy(cfg, hs, phis, device="cpu", **kw)
    scale = (np.abs(hs[0, :L]).sum() + np.abs(phis[0, :L - 1]).sum()) / L
    for p in (0, 0.2):
        np.testing.assert_allclose(got[f"energy_p_{p}"], ref[f"energy_p_{p}"],
                                   atol=TOL * scale, rtol=0)
        np.testing.assert_allclose(got["per_qubit_z"][p],
                                   ref["per_qubit_z"][p], atol=TOL, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("L,q,state", [(22, 0, "neel"), (24, 12, "vacuum"),
                                       (25, 24, "neel"), (27, 26, "vacuum"),
                                       (30, 15, "vacuum")])
def test_streamed_kernels_match_plain_on_card(cuda_device, L, q, state):
    """Two passes (L=22, 24) and three (L=25, the first three-pass plan with
    16-column tiles; 27; 30 on 256-lane rows), probes in every bit band.
    The forward (on the step passes of floquet_echo.cuh, one launch a
    call) at q and at a probe in each of pass lo's, mid's (or the middle)
    and hi's bits, 3 trajectories of different rows (1 at L=30, T=3); the
    echo at q (the L=30 echo: ``test_folded_echo_kernels_match_plain_on_card``
    takes L <= 29 and chip_smoke.py L=30)."""
    hs, phis = _disorder(L, cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(L)
    n, T = (1, 3) if L == 30 else (3, 4)
    u = torch.rand((1, n, T, L), generator=gen, device=cuda_device)
    rows, sig = forward_rows(u, hs[:, None], phis[:, None], L=L, T=T, p=0.1)
    assert rows.shape[-1] == (256 if L >= 27 else 128)
    for qf in (q, *_echo_probes(L, True)):
        kw = dict(L=L, q=qf, initial_state=state)
        before = _launched("K6.forward")
        k = sm.streamed_forward_batch(rows, sig, THETA, **kw)
        torch.cuda.synchronize()
        assert _launched("K6.forward") == before + 1
        ref = sm.streamed_forward_batch_ref(rows, sig, THETA, **kw)
        assert k.shape == ref.shape == (1, n, T)
        assert float((k - ref).abs().max()) <= TOL
    if L == 30:
        return
    ue = torch.rand((1, 1, 6, L), generator=gen, device=cuda_device)
    for p in (0.6, 0.0):
        tiles, sfin = echo_pair_tiles(ue, torch.arange(4, device=cuda_device),
                                      hs[:, None], phis[:, None], L=L, T=3,
                                      p=p)
        k = sm.streamed_echo_batch(tiles, sfin, THETA, L=L, q=q,
                                   initial_state=state)
        torch.cuda.synchronize()
        ref = sm.streamed_echo_batch_ref(tiles, sfin, THETA, L=L, q=q,
                                         initial_state=state)
        assert float((k - ref).abs().max()) <= TOL
        if p == 0:
            assert float((k - 1).abs().max()) <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("L", [22, 23])
def test_streamed_kernels_match_k1_k2_on_card(cuda_device, L):
    """Where both families run, they agree on the same rows."""
    hs, phis = _disorder(L, cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    u = torch.rand((1, 3, 6, L), generator=gen, device=cuda_device)
    rows, sig = forward_rows(u, hs[:, None], phis[:, None], L=L, T=6, p=0.1)
    a = sm.streamed_forward_batch(rows, sig, THETA, L=L, q=L // 2)
    b = rb.blocked_forward_batch(rows, sig, THETA, L=L, q=L // 2)
    assert float((a - b).abs().max()) <= TOL
    tiles, sfin = echo_pair_tiles(u, torch.arange(1, 4, device=cuda_device),
                                  hs[:, None], phis[:, None], L=L, T=3, p=0.6)
    a = sm.streamed_echo_batch(tiles, sfin, THETA, L=L, q=L // 2)
    b = rb.blocked_echo_batch(tiles, sfin, THETA, L=L, q=L // 2)
    assert float((a - b).abs().max()) <= TOL


@pytest.mark.cuda
def test_streamed_forward_entry_checks_its_range(cuda_device):
    """The C forward entry returns cudaErrorInvalidValue (1) without a
    launch for arguments out of its range: L, q, the row width, and fold
    rows fewer than T; in range it launches (0)."""
    from dtc_tpu_torch.ops import _build

    lib = _build.load("floquet_x_streamed")
    L, T, width = 22, 3, 128
    dev = cuda_device
    state = torch.zeros((1, 1 << L), dtype=torch.complex64, device=dev)
    rows = torch.zeros((1, T, width), device=dev)
    fold = torch.zeros((1, T, 2 * L), device=dev)
    partials = torch.zeros((1, T, lib.floquet_x_streamed_partials(L)),
                           device=dev)
    out = torch.full((1, T), 7.0, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def call(L=L, T=T, width=width, fold_rows=T, q=0):
        return lib.floquet_x_streamed_forward(
            state.data_ptr(), rows.data_ptr(), fold.data_ptr(),
            partials.data_ptr(), out.data_ptr(), 1, L, T, width, fold_rows,
            q, 0, 1.0, 0.0, stream)

    for bad in (dict(L=21), dict(L=31), dict(q=L), dict(q=-1),
                dict(width=192), dict(L=27, width=128), dict(fold_rows=T - 1),
                dict(T=0)):
        assert call(**bad) == 1, bad
    torch.cuda.synchronize()
    assert torch.equal(out, torch.full_like(out, 7.0))  # nothing ran
    assert call() == 0
    torch.cuda.synchronize()
    # the identity kick (c=1, s=0) on the vacuum: A(t) = z_0 = 1
    assert torch.equal(out, torch.ones_like(out))


@pytest.mark.cuda
def test_streamed_wrappers_reject_bad_inputs(cuda_device):
    sig = torch.zeros((1, 3), dtype=torch.int64, device=cuda_device)
    with pytest.raises(ValueError, match="float32"):
        sm.streamed_forward_batch(
            torch.zeros((1, 3, 128), device=cuda_device).double(), sig, THETA,
            L=22, q=3)
    with pytest.raises(ValueError, match="lanes"):
        sm.streamed_forward_batch(torch.zeros((1, 3, 128), device=cuda_device),
                                  sig, THETA, L=27, q=3)
    with pytest.raises(ValueError, match="22 <= L <= 30"):
        sm.streamed_forward_batch(torch.zeros((1, 3, 256), device=cuda_device),
                                  sig, THETA, L=31, q=3)


def _general_inputs(device, L, pol, T, n, seed, ts=None, p=0.1, width=128):
    """Forward rows of n trajectories, or echo tiles of n trajectories x
    ``ts``, of the drive ``pol`` on the suite's disorder, ``width`` lanes
    wide."""
    hs, phis = _disorder(L, device)
    angles = build_kick_schedule(pol, 0.97, T, xy_cycle_period=1,
                                 device=device).angles
    K = angles.shape[1]
    gen = torch.Generator(device=device).manual_seed(seed)
    if ts is None:
        u = torch.rand((1, n, T * K, L), generator=gen, device=device)
        return general_forward_rows(u, hs[:, None], phis[:, None], angles,
                                    L=L, T=T, K=K, p=p, width=width)
    u = torch.rand((1, n, 2 * T * K, L), generator=gen, device=device)
    return general_echo_rows(u, torch.as_tensor(ts, device=device),
                             hs[:, None], phis[:, None], angles, L=L, T=T,
                             K=K, p=p, width=width)


@pytest.mark.cuda
@pytest.mark.parametrize("L,pol,q,state", [
    (22, "y", 0, "neel"), (22, "circular_left", 11, "vacuum"),
    (24, "y", 23, "vacuum"), (24, "circular_left", 12, "neel")])
def test_general_hi_kernels_match_plain_on_card(cuda_device, L, pol, q,
                                                state):
    """The streamed lab-frame family's forward and echo (two passes at
    L <= 24), K=1 and K=2, probes in the low and the high bits."""
    rows = _general_inputs(cuda_device, L, pol, 3, 2, L)
    launches = _launched("K10.forward")
    k = chg.general_hi_forward_batch(rows, L=L, T=3, q=q, initial_state=state)
    torch.cuda.synchronize()
    assert _launched("K10.forward") == launches + 1
    ref = chg.general_hi_forward_batch_ref(rows, L=L, T=3, q=q,
                                           initial_state=state)
    assert float((k - ref).abs().max()) <= TOL
    for p in (0.6, 0.0):
        tiles = _general_inputs(cuda_device, L, pol, 3, 1, 3, ts=range(4),
                                p=p)
        k = chg.general_hi_echo_batch(tiles, L=L, q=q, initial_state=state)
        torch.cuda.synchronize()
        ref = chg.general_hi_echo_batch_ref(tiles, L=L, q=q,
                                            initial_state=state)
        assert float((k - ref).abs().max()) <= TOL
        if p == 0:
            assert float((k - 1).abs().max()) <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("L", [22, 23])
def test_general_hi_kernels_match_k4_on_card(cuda_device, L):
    """Where K4 and the streamed lab-frame family both run, they agree on
    the same rows."""
    rows = _general_inputs(cuda_device, L, "xy", 4, 3, 5)
    a = chg.general_hi_forward_batch(rows, L=L, T=4, q=L // 2)
    b = rg.general_forward_batch(rows, L=L, T=4, q=L // 2)
    assert float((a - b).abs().max()) <= TOL
    tiles = _general_inputs(cuda_device, L, "xy", 3, 2, 6, ts=[1, 2, 3],
                            p=0.6)
    a = chg.general_hi_echo_batch(tiles, L=L, q=L // 2)
    b = rg.general_echo_batch(tiles, L=L, q=L // 2)
    assert float((a - b).abs().max()) <= TOL


@pytest.mark.cuda
def test_general_hi_wrappers_reject_bad_inputs(cuda_device):
    rows = torch.zeros((1, 3, 128), device=cuda_device)
    with pytest.raises(ValueError, match="float32"):
        chg.general_hi_forward_batch(rows.double(), L=22, T=3, q=3)
    with pytest.raises(ValueError, match="K per cycle"):
        chg.general_hi_forward_batch(rows, L=22, T=2, q=3)
    with pytest.raises(ValueError, match="22 <= L <= 29"):
        chg.general_hi_forward_batch(rows, L=30, T=3, q=3)
    with pytest.raises(ValueError, match="step count"):
        tiles = torch.zeros((1, 4, 128), device=cuda_device)
        tiles[0, 0, 4 * 22 - 1 + 10] = 3.0
        chg.general_hi_echo_batch(tiles, L=22, q=3)


def _x_schedule(T, device, per_cycle):
    g = (torch.linspace(0.86, 0.99, T, dtype=torch.float64, device=device)
         if per_cycle else 0.97)
    return build_kick_schedule("x", g, T, device=device).angles


@pytest.mark.cuda
@pytest.mark.parametrize("L,per_cycle,state,q", [
    (14, False, "neel", 0), (15, True, "vacuum", 7), (16, True, "vacuum", 15),
    (17, False, "neel", 8), (21, True, "neel", 20)])
def test_resident_kernels_match_plain_on_card(cuda_device, L, per_cycle,
                                              state, q):
    """K3a and K3b, constant and per-cycle x, probes in every bit band."""
    hs, phis = _disorder(L, cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(L)
    u = torch.rand((1, 3, 6, L), generator=gen, device=cuda_device)
    rows, sig = forward_rows(u, hs[:, None], phis[:, None], L=L, T=6, p=0.1)
    kw = dict(L=L, q=q, initial_state=state, time_dependent=per_cycle)
    launches = _launched("K3.forward")
    ang = _x_schedule(6, cuda_device, per_cycle)
    k = rs.resident_forward_batch(rows, sig, ang, **kw)
    torch.cuda.synchronize()
    assert _launched("K3.forward") == launches + 1
    ref = rs.resident_forward_batch_ref(rows, sig, ang, **kw)
    assert float((k - ref).abs().max()) <= TOL
    ue = torch.rand((1, 2, 8, L), generator=gen, device=cuda_device)
    ang = _x_schedule(4, cuda_device, per_cycle)
    for p in (0.6, 0.0):
        tiles, sfin = echo_pair_tiles(
            ue, torch.tensor([0, 1, 2, 4], device=cuda_device), hs[:, None],
            phis[:, None], L=L, T=4, p=p)
        k = rs.resident_echo_batch(tiles, sfin, ang, **kw)
        torch.cuda.synchronize()
        ref = rs.resident_echo_batch_ref(tiles, sfin, ang, **kw)
        assert float((k - ref).abs().max()) <= TOL
        if p == 0:
            assert float((k - 1).abs().max()) <= TOL


@pytest.mark.cuda
def test_resident_kernels_match_k1_k2_and_k4_on_card(cuda_device):
    """On the same rows: K3 with a constant schedule against K1/K2 at L=17,
    and with a per-cycle schedule against K4 (its rows built from the same
    uniforms) at L=20."""
    from dtc_tpu_torch.ops.params_general import general_echo_rows

    hs, phis = _disorder(17, cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    u = torch.rand((1, 3, 8, 17), generator=gen, device=cuda_device)
    rows, sig = forward_rows(u, hs[:, None], phis[:, None], L=17, T=8, p=0.1)
    a = rs.resident_forward_batch(rows, sig, _x_schedule(8, cuda_device,
                                                         False), L=17, q=8)
    b = rb.blocked_forward_batch(rows, sig, THETA, L=17, q=8)
    assert float((a - b).abs().max()) <= TOL
    tiles, sfin = echo_pair_tiles(u, torch.arange(1, 5, device=cuda_device),
                                  hs[:, None], phis[:, None], L=17, T=4,
                                  p=0.6)
    a = rs.resident_echo_batch(tiles, sfin, _x_schedule(4, cuda_device,
                                                        False), L=17, q=8)
    b = rb.blocked_echo_batch(tiles, sfin, THETA, L=17, q=8)
    assert float((a - b).abs().max()) <= TOL
    L, T = 20, 6
    hs, phis = _disorder(L, cuda_device)
    ang = _x_schedule(T, cuda_device, True)
    u = torch.rand((1, 2, 2 * T, L), generator=gen, device=cuda_device)
    rows, sig = forward_rows(u[:, :, :T], hs[:, None], phis[:, None], L=L,
                             T=T, p=0.1)
    grows = general_forward_rows(u[:, :, :T], hs[:, None], phis[:, None],
                                 ang, L=L, T=T, K=1, p=0.1)
    a = rs.resident_forward_batch(rows, sig, ang, L=L, q=10,
                                  time_dependent=True)
    b = rg.general_forward_batch(grows, L=L, T=T, q=10)
    assert float((a - b).abs().max()) <= TOL
    ts = torch.tensor([1, 3, 6], device=cuda_device)
    tiles, sfin = echo_pair_tiles(u, ts, hs[:, None], phis[:, None], L=L,
                                  T=T, p=0.6)
    gtiles = general_echo_rows(u, ts, hs[:, None], phis[:, None], ang, L=L,
                               T=T, K=1, p=0.6)
    a = rs.resident_echo_batch(tiles, sfin, ang, L=L, q=10,
                               time_dependent=True)
    b = rg.general_echo_batch(gtiles, L=L, q=10)
    assert float((a - b).abs().max()) <= TOL


def _echo_probes(L, streamed):
    """Probe qubits in the bits of pass lo, pass mid (the streamed plan's
    third pass, L >= 25: bits [a, a + c), c = (L - 2) // 3, a = L - 2c) or
    the middle, and pass hi."""
    if streamed and L >= 25:
        c = (L - 2) // 3
        return (0, L - 2 * c + c // 2, L - 1)
    return (0, L // 2, L - 1)


@pytest.mark.cuda
@pytest.mark.parametrize("L", [14, 17, 20, 21, 22, 23, 24, 25, 28, 29])
def test_folded_echo_kernels_match_plain_on_card(cuda_device, L):
    """K3b (to L=21), K2 (L = 17-23), K4's echo (to L=23), the streamed x
    echo (K6b/K7b; L = 22-25, 28) and the streamed lab-frame echo (K10b, y
    and xy; L = 22, 24, 25, 28, 29) on the folded diagonals against their
    plain versions:
    pairs with ragged counts (0, 1, a few, the largest; 8 pairs, 4 from
    L = 24), probes q in the bits of pass lo, pass mid (three passes, from
    L = 25) and pass hi, at p = 0.6 and 0."""
    from dtc_tpu_torch.ops.params_general import LANE_COUNT, flag_base

    hs, phis = _disorder(L, cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(L)
    T = 2 if L >= 23 else 3
    n = 1 if L >= 24 else 2
    ts = torch.tensor([0, 1, 2, T], device=cuda_device)
    angles = {pol: build_kick_schedule(pol, 0.97, T,
                                       device=cuda_device).angles
              for pol in ("y", "xy")}
    ug = torch.rand((1, n, 4 * T, L), generator=gen, device=cuda_device)
    ux = torch.rand((1, n, 2 * T, L), generator=gen, device=cuda_device)
    ang = _x_schedule(T, cuda_device, True)
    lab_lane = flag_base(L) + LANE_COUNT
    for p in (0.6, 0.0):
        gtiles = {}
        for pol, K in (("y", 1), ("xy", 2)):
            gtiles[pol] = general_echo_rows(
                ug[..., :2 * T * K, :], ts, hs[:, None], phis[:, None],
                angles[pol], L=L, T=T, K=K, p=p)
            gtiles[pol][0, n - 1, 2, 0, lab_lane] = 1.0
        runs = []
        if L <= rg.MAX_L:
            runs.append((rg.general_echo_batch, rg.general_echo_batch_ref,
                         "K4.echo", (gtiles["xy"],), {}, False))
        if L <= rs.MAX_L:
            xt, sfin = echo_pair_tiles(ux, ts, hs[:, None], phis[:, None],
                                       L=L, T=T, p=p)
            xt[0, n - 1, 2, 0, 124] = 1.0
            runs.append((rs.resident_echo_batch, rs.resident_echo_batch_ref,
                         "K3.echo", (xt, sfin, ang),
                         dict(time_dependent=True), False))
        if rb.MIN_L <= L <= rb.MAX_L:
            bt, bfin = echo_pair_tiles(ux, ts, hs[:, None], phis[:, None],
                                       L=L, T=T, p=p)
            bt[0, n - 1, 2, 0, 124] = 1.0
            runs.append((rb.blocked_echo_batch, rb.blocked_echo_batch_ref,
                         "K2", (bt, bfin, THETA), {}, False))
        if L in (22, 23, 24, 25, 28):
            st, sfin = echo_pair_tiles(ux, ts, hs[:, None], phis[:, None],
                                       L=L, T=T, p=p)
            st[0, n - 1, 2, 0, st.shape[-1] - 4] = 1.0
            runs.append((sm.streamed_echo_batch, sm.streamed_echo_batch_ref,
                         "K6.echo", (st, sfin, THETA), {}, True))
        if L in (22, 24, 25, 28, 29):
            for pol in ("y", "xy"):
                runs.append((chg.general_hi_echo_batch,
                             chg.general_hi_echo_batch_ref, "K10.echo",
                             (gtiles[pol],), {}, True))
        assert runs
        for kernel, plain, kid, args, kw, streamed in runs:
            for q in _echo_probes(L, streamed):
                kw.update(L=L, q=q, initial_state="neel" if q else "vacuum")
                before = _launched(kid)
                k = kernel(*args, **kw)
                torch.cuda.synchronize()
                assert _launched(kid) == before + 1
                ref = plain(*args, **kw)
                assert float((k - ref).abs().max()) <= TOL
                if p == 0:  # but the pair cut to one step
                    k[0, n - 1, 2] = 1.0
                    assert float((k - 1).abs().max()) <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("L", [22, 24, 25, 28, 29])
def test_general_hi_forward_on_step_passes_matches_plain_on_card(cuda_device,
                                                                 L):
    """K10a's forward on the step passes of floquet_echo.cuh (two passes to
    L = 24, three from 25; the measure in pass hi's store) against its
    plain version: y (K=1), xy (K=2) and circular_left, probes q in the
    bits of pass lo, pass mid (or the middle) and pass hi, one launch a
    call."""
    T, n = (3, 1) if L >= 28 else (4, 2)
    for pol in ("y", "xy", "circular_left"):
        rows = _general_inputs(cuda_device, L, pol, T, n, L)
        for q in _echo_probes(L, True):
            kw = dict(L=L, T=T, q=q, initial_state="neel" if q else "vacuum")
            before = _launched("K10.forward")
            k = chg.general_hi_forward_batch(rows, **kw)
            torch.cuda.synchronize()
            assert _launched("K10.forward") == before + 1
            ref = chg.general_hi_forward_batch_ref(rows, **kw)
            assert k.shape == ref.shape == (1, n, T)
            assert float((k - ref).abs().max()) <= TOL
        del rows


@pytest.mark.cuda
def test_resident_wrappers_reject_bad_inputs(cuda_device):
    ang = _x_schedule(3, cuda_device, True)
    sig = torch.zeros((1, 3), dtype=torch.int64, device=cuda_device)
    rows = torch.zeros((1, 3, 128), device=cuda_device)
    with pytest.raises(ValueError, match="float32"):
        rs.resident_forward_batch(rows.double(), sig, ang, L=14, q=3)
    with pytest.raises(ValueError, match="14 <= L <= 21"):
        rs.resident_forward_batch(rows, sig, ang, L=22, q=3)
    with pytest.raises(ValueError, match="does not cover"):
        rs.resident_forward_batch(torch.zeros((1, 4, 128),
                                              device=cuda_device),
                                  sig, ang, L=14, q=3, time_dependent=True)


RESIDENT_FORWARDS = [("K1", 17, False), ("K1", 20, False), ("K1", 23, False),
                     *[("K3a", L, per_cycle) for L in (14, 16, 20, 21)
                       for per_cycle in (False, True)]]


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,L,per_cycle", RESIDENT_FORWARDS)
def test_resident_forward_kernels_match_plain_on_card(cuda_device, kernel, L,
                                                      per_cycle):
    """K1 and K3a (constant x, and K3a's per-cycle ramp) on the step passes
    of floquet_echo.cuh against their plain versions: probes in pass lo's
    bits (0, a - 1) and pass hi's (a, L - 1), a = L - L/2; 3 trajectories
    of different rows; T = 1 (no cycle runs) and T = 57 (past the main
    paths' 50); one launch a call."""
    hs, phis = _disorder(L, cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(100 + L)
    a = L - L // 2
    kid = "K1" if kernel == "K1" else "K3.forward"
    for T, state in ((1, "neel"), (57, "vacuum")):
        u = torch.rand((1, 3, T, L), generator=gen, device=cuda_device)
        rows, sig = forward_rows(u, hs[:, None], phis[:, None], L=L, T=T,
                                 p=0.1)
        ang = _x_schedule(T, cuda_device, per_cycle)
        for q in (0, a - 1, a, L - 1):
            if kernel == "K1":
                args, kw = (rows, sig, THETA), dict(L=L, q=q,
                                                    initial_state=state)
                fn, ref_fn = rb.blocked_forward_batch, \
                    rb.blocked_forward_batch_ref
            else:
                args, kw = (rows, sig, ang), dict(
                    L=L, q=q, initial_state=state, time_dependent=per_cycle)
                fn, ref_fn = rs.resident_forward_batch, \
                    rs.resident_forward_batch_ref
            before = _launched(kid)
            k = fn(*args, **kw)
            torch.cuda.synchronize()
            assert _launched(kid) == before + 1
            ref = ref_fn(*args, **kw)
            assert k.shape == ref.shape == (1, 3, T)
            assert float((k - ref).abs().max()) <= TOL, (T, q)


@pytest.mark.cuda
def test_resident_forward_entries_check_their_range(cuda_device):
    """K1's and K3a's C entries return cudaErrorInvalidValue (1) without a
    launch for arguments out of their range: L, q, T, the batch, fold rows
    fewer than T (and K3a's table rows); in range they launch (0)."""
    from dtc_tpu_torch.ops import _build

    dev = cuda_device
    stream = torch.cuda.current_stream(dev).cuda_stream
    L, T = 17, 3
    x = _build.load("floquet_x")
    res = _build.load("floquet_x_resident")
    state = torch.zeros((1, 1 << L), dtype=torch.complex64, device=dev)
    rows = torch.zeros((1, T, 128), device=dev)
    fold = torch.zeros((1, T, 2 * L), device=dev)
    cs = torch.tensor([[1.0, 0.0]], device=dev)
    partials = torch.zeros((1, T, x.floquet_x_forward_partials(L)),
                           device=dev)
    assert (res.floquet_x_resident_forward_partials(L)
            == x.floquet_x_forward_partials(L))
    out = torch.full((1, T), 7.0, device=dev)

    def k1(L=L, T=T, n=1, fold_rows=T, q=0):
        return x.floquet_x_forward(
            state.data_ptr(), rows.data_ptr(), fold.data_ptr(),
            partials.data_ptr(), out.data_ptr(), n, L, T, fold_rows, q, 0,
            1.0, 0.0, stream)

    def k3a(L=L, T=T, n=1, fold_rows=T, q=0, tu=1):
        return res.floquet_x_resident_forward(
            state.data_ptr(), rows.data_ptr(), fold.data_ptr(),
            cs.data_ptr(), partials.data_ptr(), out.data_ptr(), n, L, T,
            fold_rows, tu, q, 0, stream)

    common = (dict(q=L), dict(q=-1), dict(T=0), dict(n=0),
              dict(fold_rows=T - 1))
    for call, bad in [(k1, b) for b in (dict(L=16), dict(L=24), *common)] + [
            (k3a, b) for b in (dict(L=13), dict(L=22), dict(tu=0),
                               *common)]:
        assert call(**bad) == 1, (call.__name__, bad)
    torch.cuda.synchronize()
    assert torch.equal(out, torch.full_like(out, 7.0))  # nothing ran
    for call in (k1, k3a):
        out.fill_(7.0)
        assert call() == 0
        torch.cuda.synchronize()
        # the identity kick (c=1, s=0) on the vacuum: A(t) = z_0 = 1
        assert torch.equal(out, torch.ones_like(out)), call.__name__


@pytest.mark.cuda
def test_adaptive_on_card_runs_k3_and_matches_cpu(cuda_device, monkeypatch):
    """The adaptive runs at L=14 on the card (kernel stepper, K3) and on
    the CPU (the same stepper, K3's plain versions), fed the same uniforms:
    every column agrees at 1e-4."""
    def numpy_uniforms(seed, n_traj, shapes, device):
        rng = np.random.default_rng(seed)
        return tuple(torch.tensor(rng.random((1, n_traj, *s),
                                             dtype=np.float32), device=device)
                     for s in shapes)

    monkeypatch.setattr(adaptive, "instance_uniforms", numpy_uniforms)
    cfg = SimConfig(L=14, tf=4, n_trajectories=3, noise_prob=0.1,
                    use_optimization=0)
    hs, phis = generate_disorder(14, 1, seed=4)
    profiling.reset_counters()
    got = adaptive.run_adaptive_realtime(cfg, hs, phis, device="cuda",
                                         write=False)
    assert _launched("K3.forward") > 0 and _launched("K3.echo") > 0
    assert not _plain_on_cuda("K3.forward", "K3.echo")
    ref = adaptive.run_adaptive_realtime(cfg, hs, phis, device="cpu",
                                         mode="kernel", write=False)
    for k in ("forward", "echo", "g_history", "av_autocorr_standard_g97",
              "av_autocorr_echo_standard_g97"):
        np.testing.assert_allclose(got[k], ref[k], atol=TOL, rtol=0)
    got = adaptive.run_adaptive_batch(cfg, hs, phis, device="cuda",
                                      write=False)
    ref = adaptive.run_adaptive_batch(cfg, hs, phis, device="cpu",
                                      write=False)
    for k in ("av_autocorr_adaptive", "av_autocorr_echo_adaptive",
              "g_history"):
        np.testing.assert_allclose(got[k], ref[k], atol=TOL, rtol=0)


def _unit_states(n, L, device, seed):
    gen = torch.Generator(device=device).manual_seed(seed)
    s = torch.randn((n, 1 << L), dtype=torch.complex64, generator=gen,
                    device=device)
    return s / s.abs().pow(2).sum(-1, keepdim=True).sqrt()


def _unit_tol(L):
    """The limit on a random unit state of 2^L amplitudes and its partial
    sum |psi|^2 z_q, both of size 2^(-L/2): 1e-4 would pass a kernel wrong
    by a typical amplitude."""
    return 1e-3 * 2 ** (-L / 2)


@pytest.mark.cuda
@pytest.mark.parametrize("L,q", [(17, 16), (20, 10), (23, 15)])
def test_cycle_kernels_match_plain_on_card(cuda_device, L, q):
    """K8a-d on one cycle of random unit states, noisy rows (p=0.6), on
    folded rows with non-zero global angles (a shard's th_sc, th_bnd,
    uniform in [-pi, pi)), K8a also without a measure: the state and the
    partial against the plain versions on the same inputs, within
    _unit_tol(L)."""
    tol = _unit_tol(L)
    hs, phis = _disorder(L, cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(L)
    u = torch.rand((1, 3, 2, L), generator=gen, device=cuda_device)
    rows = forward_rows(u, hs[:, None], phis[:, None], L=L, T=2,
                        p=0.6)[0][0, :, 1].contiguous()
    th = (torch.rand((2, 3), generator=gen, device=cuda_device) - 0.5) * 6.28
    st = _unit_states(3, L, cuda_device, L)
    launches = {k: _launched(k) for k in K8}
    fold = cy.fold_cycle_rows(rows, L, *th)
    k, kp = cy.cycle_forward_apply(st.clone(), fold, THETA, L=L, q=q)
    r, rp = cy.cycle_forward_apply_ref(st.clone(), fold, THETA, L=L, q=q)
    assert float((k - r).abs().max()) <= tol
    assert float((kp - rp).abs().max()) <= tol
    k, kp = cy.cycle_forward_apply(st.clone(), fold, THETA, L=L)
    assert kp is None
    assert float((k - r).abs().max()) <= tol
    fold = cy.fold_cycle_rows(rows, L, *th, inverse=True)
    k = cy.cycle_inverse_apply(st.clone(), fold, THETA, L=L)
    r = cy.cycle_inverse_apply_ref(st.clone(), fold, THETA, L=L)
    assert float((k - r).abs().max()) <= tol
    grows = _general_inputs(cuda_device, L, "circular_left", 2, 3, L,
                            p=0.6)[0].reshape(3, 2, 2, -1)[:, 1].contiguous()
    fold = cy.fold_general_rows(grows, L, *th)
    k, kp = cy.general_cycle_forward_apply(st.clone(), grows, fold, L=L, K=2,
                                           q=q)
    r, rp = cy.general_cycle_forward_apply_ref(st.clone(), grows, fold, L=L,
                                               K=2, q=q)
    assert float((k - r).abs().max()) <= tol
    assert float((kp - rp).abs().max()) <= tol
    tiles = _general_inputs(cuda_device, L, "xy", 2, 3, L + 1, ts=[1],
                            p=0.6)[0].reshape(3, 4, 2, 2, -1)[:, 1]
    tiles = tiles.contiguous()
    fold = cy.fold_general_rows(tiles, L, *th, inverse=True)
    k = cy.general_cycle_inverse_apply(st.clone(), tiles, fold, L=L, K=2)
    r = cy.general_cycle_inverse_apply_ref(st.clone(), tiles, fold, L=L, K=2)
    torch.cuda.synchronize()
    assert float((k - r).abs().max()) <= tol
    assert {n: _launched(n) - launches[n] for n in launches} == {
        "K8a": 2, "K8b": 1, "K8c": 1, "K8d": 1}


@pytest.mark.cuda
@pytest.mark.parametrize("pol", ["x", "xy"])
def test_sharded_engines_on_card_match_cpu(cuda_device, pol):
    """The cycle-kernel engines at L=18 on 2 shards that share the card,
    against the same engines on the CPU (the plain versions), fed the same
    uniforms; no plain version runs on a CUDA tensor."""
    L, T, q = 18, 4, 16
    hs, phis = _disorder(L, "cpu")
    angles = build_kick_schedule(pol, 0.97, T).angles
    K = angles.shape[1]
    gen = torch.Generator().manual_seed(3)
    uf = torch.rand((2, T * K, L), generator=gen)
    ue = torch.rand((2, 2 * T, K, L), generator=gen)
    kw = dict(L=L, T=T, p=0.3, q=q, ancilla_factor=1.0)
    if pol == "x":
        fwd, ech = (sh.make_sharded_autocorr_forward_kernel,
                    sh.make_sharded_echo_kernel)
    else:
        kw["K"] = K
        fwd, ech = (sh.make_sharded_autocorr_forward_general,
                    sh.make_sharded_echo_general)
    profiling.reset_counters()
    out = {}
    for dev in ("cuda", "cpu"):
        mesh = make_mesh(2, 1, devices=[dev, dev])
        args = (angles, hs[0], phis[0])
        out[dev] = (fwd(mesh, **kw)(*args, uf.to(dev)).cpu(),
                    torch.stack([ech(mesh, **kw)(*args, ue.to(dev), t).cpu()
                                 for t in (1, T)]))
    assert _launched(*K8) > 0
    assert not _plain_on_cuda(*K8)
    for a, b in zip(out["cuda"], out["cpu"]):
        assert float((a - b).abs().max()) <= TOL


@pytest.mark.cuda
def test_cycle_wrappers_reject_bad_inputs(cuda_device):
    st = torch.zeros((1, 1 << 17), dtype=torch.complex64, device=cuda_device)
    rows = torch.zeros((1, 2, 34), device=cuda_device)
    with pytest.raises(ValueError, match="float32"):
        cy.cycle_forward_apply(st, rows.double(), THETA, L=17, q=3)
    with pytest.raises(ValueError, match="17 <= L_loc <= 23"):
        cy.cycle_inverse_apply(torch.zeros((1, 1 << 16), dtype=torch.complex64,
                                           device=cuda_device), rows, THETA,
                               L=16)
    with pytest.raises(ValueError, match="contiguous"):
        cy.general_cycle_forward_apply(
            st, torch.zeros((1, 128, 2), device=cuda_device).transpose(1, 2),
            torch.zeros((1, 3, 34), device=cuda_device), L=17, K=2, q=3)
    with pytest.raises(ValueError, match="fold"):
        cy.general_cycle_inverse_apply(
            st, torch.zeros((1, 2, 2, 128), device=cuda_device),
            torch.zeros((1, 3, 34), device=cuda_device).double(), L=17, K=2)


@pytest.mark.cuda
@pytest.mark.parametrize("pol", ["y", "xy"])
@pytest.mark.parametrize("L", [17, 23])
def test_general_cycle_kernels_match_plain_on_card(cuda_device, L, pol):
    """K8c and K8d on the step passes, one cycle of random unit states,
    noisy rows (p=0.6) folded with non-zero global angles (a shard's th_sc,
    th_bnd, uniform in [-pi, pi)), q = L_loc - 1, the local top bit, where
    th_bnd lands: the state and the partial against the plain versions
    within _unit_tol(L), and the partial from the neel state within 1e-4
    (O(1) on the y drive; the xy cycle leaves z_q near 2e-3); one launch
    each."""
    tol, q, n = _unit_tol(L), L - 1, 3
    gen = torch.Generator(device=cuda_device).manual_seed(L + len(pol))
    th = (torch.rand((2, n), generator=gen, device=cuda_device) - 0.5) * 6.28
    st = _unit_states(n, L, cuda_device, L)
    rows = _general_inputs(cuda_device, L, pol, 2, n, L, p=0.6)[0]
    K = rows.shape[-2] // 2
    rows = rows.reshape(n, 2, K, -1)[:, 1].contiguous()
    tiles = _general_inputs(cuda_device, L, pol, 2, n, L + 1, ts=[1],
                            p=0.6)[0].reshape(n, 4, K, 2, -1)[:, 1]
    tiles = tiles.contiguous()
    launches = {k: _launched(k) for k in K8}
    fold = cy.fold_general_rows(rows, L, *th)
    k, kp = cy.general_cycle_forward_apply(st.clone(), rows, fold, L=L, K=K,
                                           q=q)
    r, rp = cy.general_cycle_forward_apply_ref(st.clone(), rows, fold, L=L,
                                               K=K, q=q)
    torch.cuda.synchronize()
    assert float((k - r).abs().max()) <= tol
    assert float((kp - rp).abs().max()) <= tol
    neel = rb.basis_states(n, L, basis_index(L, "neel"), cuda_device)
    kp = cy.general_cycle_forward_apply(neel.clone(), rows, fold, L=L, K=K,
                                        q=q)[1]
    rp = cy.general_cycle_forward_apply_ref(neel.clone(), rows, fold, L=L,
                                            K=K, q=q)[1]
    if pol == "y":
        assert float(rp.abs().max()) > 0.05  # not 2^(-L/2)
    assert float((kp - rp).abs().max()) <= TOL
    fold = cy.fold_general_rows(tiles, L, *th, inverse=True)
    k = cy.general_cycle_inverse_apply(st.clone(), tiles, fold, L=L, K=K)
    r = cy.general_cycle_inverse_apply_ref(st.clone(), tiles, fold, L=L,
                                           K=K)
    torch.cuda.synchronize()
    assert float((k - r).abs().max()) <= tol
    assert {k: _launched(k) - launches[k] for k in launches} == {
        "K8a": 0, "K8b": 0, "K8c": 2, "K8d": 1}


@pytest.mark.cuda
def test_general_cycle_entries_check_their_range(cuda_device):
    """K8c's and K8d's C entries return cudaErrorInvalidValue (1) without a
    launch outside 17 <= L_loc <= 23, for q outside [0, L_loc) and K < 1;
    in range they launch (0)."""
    from dtc_tpu_torch.ops import _build

    dev = cuda_device
    stream = torch.cuda.current_stream(dev).cuda_stream
    lib = _build.load(cy.LIBRARY_GENERAL)
    L, K = 17, 1
    state = torch.zeros((1, 1 << L), dtype=torch.complex64, device=dev)
    state[0, 0] = 1.0
    rows = cy.measured_rows(torch.zeros((1, K, 128), device=dev), L, K)
    tiles = torch.zeros((1, K, 2, 128), device=dev)
    fold = torch.zeros((1, K + 1, 2 * L), device=dev)
    partials = torch.zeros((1, lib.floquet_cycle_general_partials(L)),
                           device=dev)
    out = torch.full((1,), 7.0, device=dev)

    def fwd(L=L, K=K, q=0):
        return lib.floquet_cycle_general_forward(
            state.data_ptr(), rows.data_ptr(), fold.data_ptr(),
            partials.data_ptr(), out.data_ptr(), 1, L, K, q, stream)

    def inv(L=L, K=K):
        return lib.floquet_cycle_general_inverse(
            state.data_ptr(), tiles.data_ptr(), fold.data_ptr(), 1, L, K,
            stream)

    for call, bad in [(fwd, b) for b in (dict(L=16), dict(L=24), dict(q=L),
                                         dict(q=-1), dict(K=0))] + [
            (inv, b) for b in (dict(L=16), dict(L=24), dict(K=0))]:
        assert call(**bad) == 1, (call.__name__, bad)
    torch.cuda.synchronize()
    assert torch.equal(out, torch.full_like(out, 7.0))  # nothing ran
    # a zero row's kick U = 0 zeroes the state: the measure reads 0
    assert fwd() == 0
    torch.cuda.synchronize()
    assert torch.equal(out, torch.zeros_like(out))
    assert inv() == 0


@pytest.mark.cuda
@pytest.mark.parametrize("L,q", [(22, 16), (24, 12), (25, 20), (27, 16),
                                 (30, 29)])
def test_cycle_hi_kernels_match_plain_on_card(cuda_device, L, q):
    """K9a/K9b and K10a/K10b shard-local on one cycle of random unit states,
    noisy rows (p=0.6; every kernel on folded rows with non-zero global
    angles, a shard's th_sc, th_bnd, uniform in [-pi, pi), K9a also
    without a measure; lab-frame rows 256 lanes at 30): the state and the
    partial against the plain versions on the same inputs, within
    _unit_tol(L); the forwards' partials again from the neel state, where
    they are O(1), within 1e-4. L_loc = 25 is the first three-pass plan (16-column tiles).
    One state at L_loc = 30 (8 GiB: offsets past 2^31 elements), two
    below."""
    n = 1 if L == 30 else 2
    tol = _unit_tol(L)
    neel = rb.basis_states(n, L, basis_index(L, "neel"), cuda_device)
    hs, phis = _disorder(L, cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(L)
    u = torch.rand((1, n, 2, L), generator=gen, device=cuda_device)
    rows = forward_rows(u, hs[:, None], phis[:, None], L=L, T=2,
                        p=0.6)[0][0, :, 1]
    th = (torch.rand((2, n), generator=gen, device=cuda_device) - 0.5) * 6.28
    st = _unit_states(n, L, cuda_device, L)
    launches = {k: _launched(k) for k in K9}

    def held(kernel, plain, *args, **kw):
        k = kernel(st.clone(), *args, **kw)
        r = plain(st.clone(), *args, **kw)
        torch.cuda.synchronize()
        forward = isinstance(k, tuple)
        if forward:
            assert float((k[1] - r[1]).abs().max()) <= tol
            k, r = k[0], r[0]
        assert float((k - r).abs().max()) <= tol
        del k, r  # two 8 GiB states at L_loc = 30
        if forward:
            kp = kernel(neel.clone(), *args, **kw)[1]
            rp = plain(neel.clone(), *args, **kw)[1]
            assert float(rp.abs().max()) > 0.05  # not 2^(-L/2)
            assert float((kp - rp).abs().max()) <= TOL

    fold = cy.fold_cycle_rows(rows, L, *th)
    held(ch.hi_cycle_forward_apply, ch.hi_cycle_forward_apply_ref, fold,
         THETA, L=L, q=q)
    k, kp = ch.hi_cycle_forward_apply(st.clone(), fold, THETA, L=L)
    assert kp is None
    r = ch.hi_cycle_forward_apply_ref(st.clone(), fold, THETA, L=L)[0]
    torch.cuda.synchronize()
    assert float((k - r).abs().max()) <= tol
    del k, r
    held(ch.hi_cycle_inverse_apply, ch.hi_cycle_inverse_apply_ref,
         cy.fold_cycle_rows(rows, L, *th, inverse=True), THETA, L=L)
    w = general_hi_width(L)
    grows = _general_inputs(cuda_device, L, "circular_left", 2, n, L, p=0.6,
                            width=w)[0].reshape(n, 2, 2, w)[:, 1]
    grows = grows.contiguous()
    held(ch.general_hi_cycle_forward_apply,
         ch.general_hi_cycle_forward_apply_ref, grows,
         cy.fold_general_rows(grows, L, *th), L=L, K=2, q=q)
    tiles = _general_inputs(cuda_device, L, "xy", 2, n, L + 1, ts=[1], p=0.6,
                            width=w)[0].reshape(n, 4, 2, 2, w)[:, 1]
    tiles = tiles.contiguous()
    held(ch.general_hi_cycle_inverse_apply,
         ch.general_hi_cycle_inverse_apply_ref, tiles,
         cy.fold_general_rows(tiles, L, *th, inverse=True), L=L, K=2)
    assert {k: _launched(k) - launches[k] for k in launches} == {
        "K9a": 3, "K9b": 1, "K10a.local": 2, "K10b.local": 1}


@pytest.mark.cuda
@pytest.mark.parametrize("pol", ["x", "xy"])
def test_sharded_hi_engines_on_card_match_cpu(cuda_device, pol, monkeypatch):
    """The cycle-kernel engines on the streamed per-shard kernels (route
    lowered to L_loc = 22) at L=23 on 2 shards that share the card, against
    the same engines on the CPU (the plain versions), fed the same
    uniforms; K8 launches nothing and no plain version runs on a CUDA
    tensor."""
    monkeypatch.setattr(ch, "MIN_ROUTE_L", 22)
    L, T, q = 23, 3, 16
    hs, phis = _disorder(L, "cpu")
    angles = build_kick_schedule(pol, 0.97, T).angles
    K = angles.shape[1]
    gen = torch.Generator().manual_seed(4)
    uf = torch.rand((2, T * K, L), generator=gen)
    ue = torch.rand((2, 2 * T, K, L), generator=gen)
    kw = dict(L=L, T=T, p=0.3, q=q, ancilla_factor=1.0)
    if pol == "x":
        fwd, ech = (sh.make_sharded_autocorr_forward_kernel,
                    sh.make_sharded_echo_kernel)
    else:
        kw["K"] = K
        fwd, ech = (sh.make_sharded_autocorr_forward_general,
                    sh.make_sharded_echo_general)
    profiling.reset_counters()
    out = {}
    for dev in ("cuda", "cpu"):
        mesh = make_mesh(2, 1, devices=[dev, dev])
        args = (angles, hs[0], phis[0])
        out[dev] = (fwd(mesh, **kw)(*args, uf.to(dev)).cpu(),
                    ech(mesh, **kw)(*args, ue.to(dev), T).cpu())
    assert _launched(*K9) > 0
    assert not _launched(*K8)
    assert not _plain_on_cuda(*K9)
    for a, b in zip(out["cuda"], out["cpu"]):
        assert float((a - b).abs().max()) <= TOL


@pytest.mark.cuda
def test_cycle_hi_wrappers_reject_bad_inputs(cuda_device):
    st = torch.zeros((1, 1 << 22), dtype=torch.complex64, device=cuda_device)
    rows = torch.zeros((1, 2, 44), device=cuda_device)
    with pytest.raises(ValueError, match="float32"):
        ch.hi_cycle_forward_apply(st, rows.double(), THETA, L=22, q=3)
    with pytest.raises(ValueError, match="rows must be"):
        ch.hi_cycle_forward_apply(st, torch.zeros((1, 128),
                                                  device=cuda_device),
                                  THETA, L=22, q=3)
    with pytest.raises(ValueError, match="contiguous"):
        ch.hi_cycle_inverse_apply(
            st, torch.zeros((1, 44, 2), device=cuda_device).transpose(1, 2),
            THETA, L=22)
    with pytest.raises(ValueError, match="22 <= L_loc <= 30"):
        ch.hi_cycle_inverse_apply(torch.zeros((1, 1 << 21),
                                              dtype=torch.complex64,
                                              device=cuda_device), rows,
                                  THETA, L=21)
    fold = torch.zeros((1, 3, 44), device=cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        ch.general_hi_cycle_forward_apply(
            st, torch.zeros((1, 128, 2), device=cuda_device).transpose(1, 2),
            fold, L=22, K=2, q=3)
    tiles = torch.zeros((1, 2, 2, 128), device=cuda_device)
    with pytest.raises(ValueError, match="fold must be a CUDA tensor"):
        ch.general_hi_cycle_inverse_apply(st, tiles, fold.cpu(), L=22, K=2)
    with pytest.raises(ValueError, match="rows must be"):
        ch.general_hi_cycle_inverse_apply(st, tiles, fold[:, :2], L=22, K=2)
    with pytest.raises(ValueError, match="float32"):
        ch.general_hi_cycle_inverse_apply(st, tiles, fold.double(), L=22,
                                          K=2)


@pytest.mark.cuda
def test_cycle_hi_general_entries_check_their_range(cuda_device):
    """K10's shard-local C entries return cudaErrorInvalidValue (1) without
    a launch outside their range: L_loc outside 22..30, q outside
    [0, L_loc), a row width other than ``general_hi_width(L_loc)`` (128
    below 30, 256 at 30), K < 1; in range they launch (0)."""
    from dtc_tpu_torch.ops import _build

    lib = _build.load(cy.LIBRARY_GENERAL)
    L, K, dev = 22, 2, cuda_device
    state = torch.zeros((1, 1 << L), dtype=torch.complex64, device=dev)
    rows = torch.zeros((1, 2 * K, 256), device=dev)
    fold = torch.zeros((1, K + 1, 60), device=dev)
    partials = torch.zeros((1, lib.floquet_general_streamed_partials(L)),
                           device=dev)
    out = torch.full((1,), 7.0, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def forward(L=L, width=128, K=K, q=0):
        return lib.floquet_cycle_hi_general_forward(
            state.data_ptr(), rows.data_ptr(), fold.data_ptr(),
            partials.data_ptr(), out.data_ptr(), 1, L, width, K, q, stream)

    def inverse(L=L, width=128, K=K):
        return lib.floquet_cycle_hi_general_inverse(
            state.data_ptr(), rows.data_ptr(), fold.data_ptr(), 1, L, width,
            K, stream)

    for bad in (dict(L=21), dict(L=31), dict(q=L), dict(q=-1),
                dict(width=192), dict(width=256), dict(L=30, width=128),
                dict(K=0)):
        assert forward(**bad) == 1, bad
        if "q" not in bad:
            assert inverse(**bad) == 1, bad
    torch.cuda.synchronize()
    assert torch.equal(out, torch.full_like(out, 7.0))  # nothing ran
    assert forward() == 0 and inverse() == 0
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("L,B", [(4, 3), (12, 5), (20, 8), (1, 3), (2, 3),
                                 (5, 3), (9, 3), (20, 32), (30, 1),
                                 (5, 65535)])
def test_noise_factor_kernel_matches_plain_on_card(cuda_device, L, B):
    """K11 on random unit states and random tiles, in place, against its
    plain version: within 1e-5 of the largest amplitude. L = 1 (one
    amplitude a thread), 2 .. 8 (one table over the whole chain), 9 and up
    (the row phases), 30 (64-bit offsets); B = 65535, the grid's edge."""
    from dtc_tpu_torch.ops import noise_factor as nf

    gen = torch.Generator(device=cuda_device).manual_seed(L)
    st = torch.randn((B, 2, 1 << L), generator=gen, device=cuda_device)
    st /= st.square().sum((1, 2), keepdim=True).sqrt()
    rnd = torch.randint(0, 1 << L, (2, B), generator=gen, device=cuda_device)
    par = nf.pack_cycle_params(
        rnd[0], rnd[1],
        torch.rand((B, L), generator=gen, device=cuda_device) * 6 - 3,
        torch.rand((B, L - 1), generator=gen, device=cuda_device) * 6 - 3, L)
    plain = nf.noise_factor_plain(st, par, L=L)
    launches = _launched("K11")
    got = nf.apply_noise_factor(st, par, L=L)
    torch.cuda.synchronize()
    assert got.data_ptr() == st.data_ptr()  # in place
    assert _launched("K11") == launches + 1
    lim = 1e-5 * float(plain.abs().max())
    assert float((got - plain).abs().max()) <= lim
    with pytest.raises(ValueError):
        nf.apply_noise_factor(st.double(), par, L=L)
    with pytest.raises(ValueError):
        nf.apply_noise_factor(st[:, :, ::2], par, L=L)


@pytest.mark.cuda
def test_noise_factor_entry_checks_its_range(cuda_device):
    """K11's C entry returns cudaErrorInvalidValue (1) without a launch
    for L outside 1..30, a batch outside 1..65535 and a state not 16-byte
    aligned; the wrapper refuses the batch first."""
    from dtc_tpu_torch.ops import _build
    from dtc_tpu_torch.ops import noise_factor as nf

    dev = cuda_device
    stream = torch.cuda.current_stream(dev).cuda_stream
    lib = _build.load("noise_factor")
    st = torch.ones((2, 2, 32), device=dev)
    par = torch.zeros((2, 8, 128), device=dev)
    par[:, 0, 0] = 1.0  # zm bit 0: a launch would flip odd amplitudes
    for n, L, ptr in ((2, 0, 0), (2, 31, 0), (0, 5, 0), (65536, 5, 0),
                      (1, 5, 4)):
        assert lib.noise_factor_apply(st.data_ptr() + ptr, par.data_ptr(), n,
                                      L, stream) == 1, (n, L, ptr)
    torch.cuda.synchronize()
    assert torch.equal(st, torch.ones_like(st))  # nothing ran
    assert lib.noise_factor_apply(st.data_ptr(), par.data_ptr(), 2, 5,
                                  stream) == 0
    torch.cuda.synchronize()
    assert float(st[:, :, 1::2].max()) == -1.0
    with pytest.raises(ValueError, match="65535"):
        nf.apply_noise_factor(torch.zeros((65536, 2, 4), device=dev),
                              torch.zeros((65536, 8, 128), device=dev), L=2)


@pytest.mark.cuda
def test_planar_route_on_card_matches_cpu(cuda_device):
    """The planar forward at L=12 on the card (K11 once per measured cycle)
    and on the CPU (its plain version), fed the same uniforms."""
    from dtc_tpu_torch.experiments import engine

    cfg = SimConfig(L=12, tf=6, inst=2, n_trajectories=4, noise_prob=0.1)
    hs, phis = generate_disorder(12, 2, seed=5)
    u = torch.rand((2, 4, 6, 12), generator=torch.Generator().manual_seed(1))
    out = {}
    for dev in ("cuda", "cpu"):
        sched, params, noise = engine.build_context(cfg, hs, phis,
                                                    device=dev)
        profiling.reset_counters()
        out[dev] = engine.forward_sweep(cfg, sched, params, noise,
                                        uniforms=u.to(dev), engine="planar")
        if dev == "cuda":
            assert _launched("K11") == cfg.tf - 1
            assert _plain_on_cuda("K11") == 0
    np.testing.assert_allclose(out["cuda"], out["cpu"], atol=TOL, rtol=0)


def _device_blocks(L, steps, e, n, seed):
    from dtc_tpu_torch.core.device_evolve import n_bonds

    rng = np.random.default_rng(seed)
    ne, no = n_bonds(L)
    return tuple(torch.tensor(rng.random((n, steps, *s), dtype=np.float32))
                 for s in ((e, L), (ne,), (no,)))


@pytest.mark.cuda
@pytest.mark.parametrize("pol,L", [("x", 15), ("x", 17), ("xy", 14),
                                   ("y", 17)])
def test_device_rows_on_card_match_cpu(cuda_device, pol, L):
    """Device-noise rows on the kernels (K3 at L=15, K1/K2 at 17, K4 for
    y and xy) on the card against the same calls on the CPU (the plain
    versions), forward and echo."""
    from dtc_tpu_torch.core import device_evolve as de
    from dtc_tpu_torch.models.drives import n_kick_slots

    T, K, n = 4, n_kick_slots(pol), 3
    hs, phis = generate_disorder(L, 1, seed=3)
    h, ph = torch.as_tensor(hs[0, :L]), torch.as_tensor(phis[0, :L - 1])
    p1 = torch.linspace(0.05, 0.3, L, dtype=torch.float64)
    p2 = torch.linspace(0.1, 0.4, L - 1, dtype=torch.float64)
    ang = build_kick_schedule(pol, 0.95, T).angles
    fwd, echo = ((de.device_kernel_forward_batch, de.device_kernel_echo_batch)
                 if pol == "x" else
                 (de.device_general_kernel_forward_batch,
                  de.device_general_kernel_echo_batch))
    kw = dict(L=L, T=T, q=L // 2, ancilla_factor=0.9)
    if pol != "x":
        kw["K"] = K
    uf = _device_blocks(L, T, 2 * K, n, L)
    ue = _device_blocks(L, 2 * T, 2 * K, n, L + 1)
    ts = [1, 2, 4]
    out = {}
    for dev in ("cuda", "cpu"):
        args = [x.to(dev) for x in (h, ph, p1, p2, ang)]
        a = fwd(*args, tuple(b.to(dev) for b in uf), **kw)
        e = echo(*args, tuple(b.to(dev) for b in ue), ts, **kw)
        out[dev] = (a.cpu().numpy(), e.cpu().numpy())
    for g, r in zip(out["cuda"], out["cpu"]):
        np.testing.assert_allclose(g, r, atol=TOL, rtol=0)
    assert np.ptp(out["cpu"][1]) > 0.05  # events fired


@pytest.mark.cuda
@pytest.mark.parametrize("pol", ["x", "y", "xy", "circular_left"])
def test_run_autocorr_fakebackend_on_card(cuda_device, pol, tmp_path):
    """``run_autocorr`` with ``use_fakebackend=1`` on the card at L=14 (x on
    K3's device rows, the other drives on K4's) and on the CPU (the plain
    versions) on the same draws: every column within 1e-4, A(0) the
    model's ancilla and readout factor."""
    from dtc_tpu_torch.core.device_evolve import n_bonds
    from dtc_tpu_torch.experiments.device_sweeps import _rates
    from dtc_tpu_torch.models.drives import n_kick_slots

    L, T, n = 14, 4, 3
    cfg = SimConfig(L=L, tf=T, n_trajectories=n, use_fakebackend=1,
                    polarization=pol)
    hs, phis = generate_disorder(L, 1, seed=2)
    rng = np.random.default_rng(5)
    ne, no = n_bonds(L)
    e = 2 * n_kick_slots(pol)
    blocks = [tuple(rng.random((1, n, steps, *s), dtype=np.float32)
                    for s in ((e, L), (ne,), (no,))) for steps in (T, 2 * T)]
    out = {dev: run_autocorr(cfg, hs, phis, device=dev, write=False,
                             uniforms=blocks)
           for dev in ("cuda", "cpu")}
    for k in ("av_autocorr", "av_autocorr_echo"):
        np.testing.assert_allclose(out["cuda"][k], out["cpu"][k], atol=TOL,
                                   rtol=0)
    af = _rates(cfg, torch.device("cpu"))[2]
    assert abs(out["cuda"]["av_autocorr"][0] - af) < 1e-5


@pytest.mark.cuda
def test_x_echo_past_one_launch_matches_plain_on_card(cuda_device,
                                                      monkeypatch):
    """65536 echo pairs at L=14 (16 instances x 512 trajectories x 8 t
    values) through echo_sweep (route resident, K3b): the sweep splits
    them into launches of at most MAX_LAUNCH pairs, and matches the same
    sweep through K3b's plain version on the same uniforms."""
    from dtc_tpu_torch.experiments import engine
    from dtc_tpu_torch.ops import routes

    cfg = SimConfig(L=14, tf=8, inst=16, n_trajectories=512, noise_prob=0.05)
    hs, phis = generate_disorder(14, 16, seed=3)
    sched, params, noise = engine.build_context(cfg, hs, phis,
                                                device=cuda_device)
    assert routes.engine_for(sched.angles, L=14, T=8, q=7,
                             dtype_name="complex64", has_y=False,
                             echo=True) == "resident"
    profiling.reset_counters()
    got = engine.echo_sweep(cfg, sched, params, noise)
    torch.cuda.synchronize()
    assert _launched("K3.echo") == 2  # 16 x 511 x 8, then 16 x 1 x 8
    monkeypatch.setattr(rs, "resident_echo_batch",
                        rs.resident_echo_batch_ref)
    want = engine.echo_sweep(cfg, sched, params, noise)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


@pytest.mark.cuda
def test_planar_forward_past_one_launch_matches_plain_on_card(cuda_device,
                                                              monkeypatch):
    """65536 planar states at L=10: the planar forward runs them in chunks
    of at most MAX_LAUNCH states, one K11 launch a chunk and measured
    cycle, and matches the same forward through K11's plain version."""
    from dtc_tpu_torch.core import planar_evolve
    from dtc_tpu_torch.experiments import engine
    from dtc_tpu_torch.ops import noise_factor as nf

    cfg = SimConfig(L=10, tf=3, inst=1, n_trajectories=65536, noise_prob=0.1)
    hs, phis = generate_disorder(10, 1, seed=4)
    sched, params, noise = engine.build_context(cfg, hs, phis,
                                                device=cuda_device)
    profiling.reset_counters()
    got = engine.forward_sweep(cfg, sched, params, noise, engine="planar")
    torch.cuda.synchronize()
    assert _launched("K11") == 2 * (cfg.tf - 1)
    monkeypatch.setattr(planar_evolve, "apply_noise_factor",
                        lambda st, par, L: nf.noise_factor_plain(st, par,
                                                                 L=L))
    want = engine.forward_sweep(cfg, sched, params, noise, engine="planar")
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


@pytest.mark.cuda
def test_sample_counts_on_card_matches_probs(cuda_device):
    """``observables.sample_counts`` draws 10^6 shots on the card from an
    L=20 probability vector there (the distribution after one noiseless x
    kick of g=0.97 from the vacuum: each qubit flipped with probability
    sin^2(pi g / 2)): the empirical distribution within 0.01 of it in total
    variation (its expected distance at this count is about 6e-4)."""
    from dtc_tpu_torch.observables import sample_counts

    L, shots = 20, 10**6
    q = float(np.sin(THETA / 2) ** 2)
    one = torch.tensor([1 - q, q], dtype=torch.float64, device=cuda_device)
    probs = torch.ones(1, dtype=torch.float64, device=cuda_device)
    for _ in range(L):
        probs = torch.kron(one, probs)
    counts = sample_counts(probs, shots, n_qubits=L, seed=5)
    assert sum(counts.values()) == shots
    assert all(len(k) == L for k in counts)
    emp = torch.zeros_like(probs)
    emp[torch.tensor([int(k, 2) for k in counts], device=cuda_device)] = \
        torch.tensor(list(counts.values()), dtype=torch.float64,
                     device=cuda_device) / shots
    tv = 0.5 * float((emp - probs).abs().sum())
    assert tv < 0.01, tv
