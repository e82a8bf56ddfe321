"""The plain versions of the per-shard cycle kernels K8a-d (``ops/cycle.py``)
against the reference's Pallas kernels (``dtc_tpu/ops/pallas_cycle.py``) in
interpret mode, and against the port's own K1/K2/K4 plain steps.

One cycle at L_loc = 17 on random unit states: the reference's planar
(n, 2, TOP, 16384) f32 state is the port's flat (n, 2^17) complex64 state,
index by index. The rows are the port's (``pack_cycle_params_compact``,
``general_forward_rows``, ``general_echo_rows``), which
``tests/test_torch_params*.py`` hold equal to the reference's; K8a and K8b
take them folded (``cycle.fold_cycle_rows``), K8c and K8d beside their
folded diagonals (``cycle.fold_general_rows``), the reference's kernels as
they are. With a shard's global angles the folded rows are held against
the unfolded cycle followed (K8a, K8c) or preceded (K8b, K8d) by the torch
global diagonal (``parallel/sharded.py::_global_diag``,
``_global_diag_inv``). Tolerances:
amplitudes of a unit state at 2^17 are about 3e-3, and f32 sums of a cycle
leave them within 2e-6 (TOL_AMP); partial sums within 1e-5 (TOL_SUM).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dtc_tpu.io.disorder import generate_disorder
from dtc_tpu.ops import pallas_cycle as jc
from dtc_tpu.ops.pallas_resident import _C, _kick_matrices
from dtc_tpu.models.drives import build_kick_schedule as j_sched
from dtc_tpu_torch.core.sigma_evolve import presample_noise
from dtc_tpu_torch.models.drives import build_kick_schedule
from dtc_tpu_torch.ops import cycle
from dtc_tpu_torch.ops import resident_blocked as rb
from dtc_tpu_torch.ops import resident_general as rg
from dtc_tpu_torch.ops.params import forward_rows, pack_cycle_params_compact
from dtc_tpu_torch.ops.params_general import (
    general_echo_rows,
    general_forward_rows,
)
from dtc_tpu_torch.parallel import sharded as sh
from dtc_tpu_torch.utils import profiling

torch.set_num_threads(2)
L = 17
TOP = 1 << (L - 14)
TOL_AMP, TOL_SUM = 2e-6, 1e-5
THETA = float(np.pi * 0.93)


def _disorder():
    hs, phis = generate_disorder(L, 1, seed=9)
    return (torch.as_tensor(hs[0, :L]), torch.as_tensor(phis[0, :L - 1]))


def _states(n, seed=2):
    """(port (n, 2^L) complex64, reference (n, 2, TOP, C) f32) unit states."""
    rng = np.random.default_rng(seed)
    s = rng.standard_normal((n, 2, 1 << L)).astype(np.float32)
    s /= np.sqrt((s ** 2).sum(axis=(1, 2), keepdims=True))
    port = torch.complex(torch.from_numpy(s[:, 0]), torch.from_numpy(s[:, 1]))
    return port, jnp.asarray(s.reshape(n, 2, TOP, _C))


def _flat(planar):
    s = np.array(planar).reshape(planar.shape[0], 2, -1)
    return torch.complex(torch.from_numpy(s[:, 0]), torch.from_numpy(s[:, 1]))


def _x_rows(n, seed=4):
    """Noisy compact rows (p=0.6) of cycle 1 for n trajectories."""
    hs, phis = _disorder()
    u = torch.rand((n, 2, L), generator=torch.Generator().manual_seed(seed))
    _, zm, _, csum = presample_noise(u, 0.6, L)
    return pack_cycle_params_compact(zm[:, 1], csum[:, 1], hs, phis, L)


def _kicks():
    ang = jnp.asarray(j_sched("x", 0.93, 2).angles)
    return _kick_matrices(ang, L, TOP, time_dependent=False)


def _general_inputs(pol, n, seed=5):
    hs, phis = _disorder()
    sched = build_kick_schedule(pol, 0.97, 2)
    K = sched.K
    gen = torch.Generator().manual_seed(seed)
    u = torch.rand((n, 4 * K, L), generator=gen)
    return hs, phis, sched.angles, K, u


@pytest.mark.parametrize("q", [8, 15])
def test_k8a_matches_reference_interpret(q):
    n = 2
    st, jst = _states(n)
    rows = _x_rows(n)
    got, part = cycle.cycle_forward_apply(
        st, cycle.fold_cycle_rows(rows, L), THETA, L=L, q=q)
    want, jpart = jc.cycle_forward_apply(jst, jnp.asarray(rows.numpy()),
                                         *_kicks(), L=L, q=q, interpret=True)
    assert float((got - _flat(want)).abs().max()) < TOL_AMP
    np.testing.assert_allclose(part.numpy(), np.asarray(jpart), atol=TOL_SUM)


def test_k8b_matches_reference_interpret():
    n = 2
    st, jst = _states(n, seed=3)
    rows = _x_rows(n, seed=6)
    got = cycle.cycle_inverse_apply(
        st, cycle.fold_cycle_rows(rows, L, inverse=True), THETA, L=L)
    want = jc.cycle_inverse_apply(jst, jnp.asarray(rows.numpy()), *_kicks(),
                                  L=L, interpret=True)
    assert float((got - _flat(want)).abs().max()) < TOL_AMP


@pytest.mark.parametrize("pol,q", [("xy", 8), ("circular_left", 15)])
def test_k8c_matches_reference_interpret(pol, q):
    n = 2
    hs, phis, ang, K, u = _general_inputs(pol, n)
    rows = general_forward_rows(u[:, :2 * K], hs, phis, ang, L=L, T=2, K=K,
                                p=0.6).reshape(n, 2, K, -1)[:, 1]
    st, jst = _states(n, seed=7)
    zero = torch.zeros(n)
    got, part = cycle.general_cycle_forward_apply(
        st, rows, cycle.fold_general_rows(rows, L, zero, zero), L=L, K=K,
        q=q)
    want, jpart = jc.general_cycle_forward_apply(
        jst, jnp.asarray(rows.numpy()), L=L, K=K, q=q, interpret=True)
    assert float((got - _flat(want)).abs().max()) < TOL_AMP
    np.testing.assert_allclose(part.numpy(), np.asarray(jpart), atol=TOL_SUM)


@pytest.mark.parametrize("pol", ["y", "xy"])
def test_k8d_matches_reference_interpret(pol):
    n = 2
    hs, phis, ang, K, u = _general_inputs(pol, n)
    tiles = general_echo_rows(u, [1], hs, phis, ang, L=L, T=2, K=K, p=0.6)
    tiles = tiles.reshape(n, 4, K, 2, -1)[:, 1]            # inverse step 1
    st, jst = _states(n, seed=8)
    zero = torch.zeros(n)
    got = cycle.general_cycle_inverse_apply(
        st, tiles, cycle.fold_general_rows(tiles, L, zero, zero,
                                           inverse=True), L=L, K=K)
    want = jc.general_cycle_inverse_apply(jst, jnp.asarray(tiles.numpy()),
                                          L=L, K=K, interpret=True)
    assert float((got - _flat(want)).abs().max()) < TOL_AMP


def test_k8b_undoes_k8a_in_the_conjugated_frame():
    """conj(K8b(conj(K8a(s)))) = s on the same row: the inverse applies the
    diagonal before the kick with un-negated angles, (D K)^dag =
    conj(K D)."""
    st, _ = _states(1, seed=9)
    rows = _x_rows(1, seed=10)
    s1, _ = cycle.cycle_forward_apply(st.clone(),
                                      cycle.fold_cycle_rows(rows, L), THETA,
                                      L=L, q=8)
    back = cycle.cycle_inverse_apply(
        s1.conj().resolve_conj(), cycle.fold_cycle_rows(rows, L,
                                                        inverse=True),
        THETA, L=L).conj()
    assert float((back - st).abs().max()) < TOL_AMP


def test_chains_equal_the_whole_state_plain_kernels():
    """With no shard bits (k_bits = 0) a chain of cycles is the unsharded
    kernel: K8a over T cycles gives K1's partials, K8c gives K4's forward,
    K8d run over every step of a pair's echo rows gives K4's echo."""
    T, q, n = 3, 8, 2
    hs, phis = _disorder()
    u = torch.rand((n, T, L), generator=torch.Generator().manual_seed(1))
    rows, sig = forward_rows(u, hs[None], phis[None], L=L, T=T, p=0.6)
    want = rb.blocked_forward_batch_ref(rows, sig, THETA, L=L, q=q)
    st = rb.basis_states(n, L, 0, "cpu")
    parts = [torch.ones(n)]
    for t in range(T - 1):
        parts.append(cycle.cycle_forward_apply(
            st, cycle.fold_cycle_rows(rows[:, t], L), THETA, L=L, q=q)[1])
    got = rb.forward_host_factor(torch.stack(parts, 1), sig, q, 0, 1.0)
    torch.testing.assert_close(got, want, atol=TOL_SUM, rtol=0)

    _, _, ang, K, ug = _general_inputs("circular_left", n)
    grows = general_forward_rows(ug[:, :2 * K], hs, phis, ang, L=L, T=2,
                                 K=K, p=0.6)
    want = rg.general_forward_batch_ref(grows, L=L, T=2, q=q)
    st = rb.basis_states(n, L, 0, "cpu")
    a1 = cycle.general_cycle_forward_apply(
        st, grows[:, :K], cycle.fold_general_rows(grows[:, :K], L), L=L, K=K,
        q=q)[1]
    torch.testing.assert_close(a1, want[:, 1], atol=TOL_SUM, rtol=0)

    tiles = general_echo_rows(ug, [2], hs, phis, ang, L=L, T=2, K=K, p=0.6)
    want = rg.general_echo_batch_ref(tiles, L=L, q=q)[:, 0]
    st = rb.basis_states(n, L, 0, "cpu")
    for k in range(4):
        slots = tiles[:, 0].reshape(n, 4, K, 2, -1)[:, k]
        cycle.general_cycle_inverse_apply(
            st, slots, cycle.fold_general_rows(slots, L, inverse=True), L=L,
            K=K)
    got = (st.real ** 2 + st.imag ** 2) @ rb.angle_table(L, "cpu")[q]
    torch.testing.assert_close(got, want, atol=TOL_SUM, rtol=0)


def test_range_checks_and_cpu_route():
    profiling.reset_counters()
    st = torch.zeros((1, 1 << 16), dtype=torch.complex64)
    with pytest.raises(ValueError, match="17 <= L_loc <= 23"):
        cycle.cycle_forward_apply(st, torch.zeros(1, 2, 32), THETA, L=16,
                                  q=3)
    st, _ = _states(1)
    with pytest.raises(ValueError, match="shard-local probe"):
        cycle.cycle_forward_apply(st, torch.zeros(1, 2, 2 * L), THETA, L=L,
                                  q=L)
    with pytest.raises(ValueError, match="rows must be"):
        cycle.general_cycle_inverse_apply(st, torch.zeros(1, 2, 128),
                                          torch.zeros(1, 3, 2 * L), L=L, K=2)
    with pytest.raises(ValueError, match="rows must be"):
        cycle.general_cycle_forward_apply(st, torch.zeros(1, 2, 128),
                                          torch.zeros(1, 2, 2 * L), L=L, K=2,
                                          q=3)
    with pytest.raises(ValueError, match="rows must be"):
        cycle.cycle_forward_apply(st, torch.zeros(1, 128), THETA, L=L, q=3)
    cycle.cycle_inverse_apply(st, torch.zeros(1, 2, 2 * L), THETA, L=L)
    assert not profiling.LAUNCHES
    assert not profiling.PLAIN_ON_CUDA


def _global_case(L_loc, n_amp, n, seed):
    """A noisy cycle (p=0.6) of n trajectories on shard bits: the compact
    rows at L_loc, and per shard the masks and the global angles as the
    engines take them (every shard at once, ``_tail_phase_angles`` on an
    (A, 1) shard index)."""
    Lg = L_loc + n_amp.bit_length() - 1
    hs, phis = generate_disorder(Lg, 1, seed=9)
    hs, phis = torch.as_tensor(hs[0, :Lg]), torch.as_tensor(phis[0, :Lg - 1])
    u = torch.rand((n, 2, Lg), generator=torch.Generator().manual_seed(seed))
    _, zm, _, csum = presample_noise(u, 0.6, Lg)
    zm, csum = zm[:, 1], csum[:, 1]
    rows = pack_cycle_params_compact(zm, csum, hs[:L_loc], phis[:L_loc - 1],
                                     L_loc)
    th_sc, th_bnd = sh._tail_phase_angles(
        zm[None], csum[None], hs, phis, torch.arange(n_amp)[:, None], L=Lg,
        local_bits=L_loc)                                       # (A, n)
    return Lg, hs, phis, zm, csum, rows, th_sc, th_bnd


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n_amp", [2, 4])
@pytest.mark.parametrize("L_loc", [17, 18])
def test_folded_global_diagonal_matches_the_torch_phase(L_loc, n_amp,
                                                        inverse):
    """On every shard, the plain K8a on ``fold_cycle_rows`` with the shard's
    global angles equals the compact-row cycle (kick, then the row's
    diagonal) followed by ``_global_diag``; the plain K8b equals
    ``_global_diag``, then the row's diagonal and the kick. The forward's
    partial is the same: the global diagonal is a phase."""
    n, q = 2, L_loc - 1
    Lg, hs, phis, zm, csum, rows, th_sc, th_bnd = _global_case(
        L_loc, n_amp, n, seed=L_loc + n_amp)
    table = rb.angle_table(L_loc, "cpu")
    u7, utop = rb._kick_pair(THETA, L_loc, "cpu")
    angles = rb._row_angles(rows, L_loc, table)
    fold = cycle.fold_cycle_rows(rows, L_loc, th_sc, th_bnd, inverse=inverse)
    assert fold.shape == (n_amp, n, 2, 2 * L_loc)
    gen = torch.Generator().manual_seed(L_loc)
    for a in range(n_amp):
        st = torch.randn((n, 1 << L_loc), dtype=torch.complex64,
                         generator=gen)
        st /= st.abs().pow(2).sum(-1, keepdim=True).sqrt()
        want = st.clone()
        if inverse:
            sh._global_diag(want, zm, csum, hs, phis, a, L=Lg,
                            local_bits=L_loc)
            want = rb._kick(rb.apply_phase(want, angles), u7, utop, L_loc)
            got = cycle.cycle_inverse_apply(st, fold[a], THETA, L=L_loc)
        else:
            want = rb.apply_phase(rb._kick(want, u7, utop, L_loc), angles)
            sh._global_diag(want, zm, csum, hs, phis, a, L=Lg,
                            local_bits=L_loc)
            got, part = cycle.cycle_forward_apply(st, fold[a], THETA,
                                                  L=L_loc, q=q)
            wpart = (want.real ** 2 + want.imag ** 2) @ table[q]
            torch.testing.assert_close(part, wpart, atol=TOL_SUM, rtol=0)
        assert float((got - want).abs().max()) < TOL_AMP


def test_fold_of_zero_angles_is_the_plain_fold():
    """Zero global angles fold to the rows without them, bit for bit, and
    the pairs lay the diagonal where K8a (row 1) and K8b (row 0) read it,
    the other row zero."""
    rows = _x_rows(3, seed=12)
    zero = torch.zeros(3)
    for inverse in (False, True):
        plain = cycle.fold_cycle_rows(rows, L, inverse=inverse)
        assert torch.equal(cycle.fold_cycle_rows(rows, L, zero, zero,
                                                 inverse=inverse), plain)
        cz, cb, c0 = rb.row_coeffs(rows.double(), L)
        diag = torch.cat([cz, cb, c0[:, None]], -1).float()
        assert torch.equal(plain[:, 0 if inverse else 1], diag)
        assert not plain[:, 1 if inverse else 0].any()


def test_no_measure_forward_runs_the_same_cycle():
    """q=None: the same state, no partial."""
    st, _ = _states(2, seed=13)
    fold = cycle.fold_cycle_rows(_x_rows(2, seed=14), L)
    a, part = cycle.cycle_forward_apply(st.clone(), fold, THETA, L=L)
    b, _ = cycle.cycle_forward_apply(st.clone(), fold, THETA, L=L, q=3)
    assert part is None
    assert torch.equal(a, b)


def _general_case(pol, L_loc, n_amp, n, mode, seed):
    """A noisy lab-frame cycle (p=0.6) of n trajectories on shard bits: the
    slot rows of cycle 1 (n, K, 128) and the (pre, post) slot pairs of echo
    step 1 at t=1 (n, K, 2, 128) at L_loc, and per shard the global angles
    as the engines take them; in device mode h and phi per trajectory, as
    the device rows give them."""
    Lg = L_loc + n_amp.bit_length() - 1
    hs, phis = generate_disorder(Lg, 1, seed=9)
    hs, phis = torch.as_tensor(hs[0, :Lg]), torch.as_tensor(phis[0, :Lg - 1])
    gen = torch.Generator().manual_seed(seed)
    sched = build_kick_schedule(pol, 0.97, 2)
    K = sched.K
    u = torch.rand((n, 4 * K, L_loc), generator=gen)
    h_loc, p_loc = hs[:L_loc], phis[:L_loc - 1]
    rows = general_forward_rows(u[:, :2 * K], h_loc, p_loc, sched.angles,
                                L=L_loc, T=2, K=K, p=0.6)
    tiles = general_echo_rows(u, [1], h_loc, p_loc, sched.angles, L=L_loc,
                              T=2, K=K, p=0.6)
    if mode == "device":
        hs = hs + torch.rand((n, Lg), generator=gen, dtype=torch.float64)
        phis = phis + torch.rand((n, Lg - 1), generator=gen,
                                 dtype=torch.float64)
    zm, sig = (torch.randint(0, 1 << Lg, (n,), generator=gen)
               & ~((1 << L_loc) - 1) for _ in range(2))
    th = sh._tail_phase_angles(zm[None], sig[None], hs, phis,
                               torch.arange(n_amp)[:, None], L=Lg,
                               local_bits=L_loc)                # (A, n)
    return (Lg, hs, phis, zm, sig, rows.reshape(n, 2, K, -1)[:, 1],
            tiles.reshape(n, 4, K, 2, -1)[:, 1], K, th)


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("mode", ["depolarizing", "device"])
@pytest.mark.parametrize("pol", ["y", "xy"])
@pytest.mark.parametrize("n_amp", [2, 4])
@pytest.mark.parametrize("L_loc", [17, 18])
def test_folded_global_diagonal_matches_the_torch_phase_general(
        L_loc, n_amp, pol, mode, inverse):
    """On every shard, the plain K8c on slot rows folded with the shard's
    global angles (``fold_general_rows``) equals the slot cycle (each slot's
    kick, then its row's diagonal) followed by ``_global_diag``; the plain
    K8d equals the daggered global diagonal, then the daggered cycle (per
    slot the pre diagonal, the kick, the post diagonal). The daggered
    global diagonal is ``_global_diag_inv`` under depolarizing noise and
    ``_global_diag`` on per-trajectory rows in device mode, whose pre rows
    carry the negation (the engines' sign conventions). q = L_loc - 1, the
    local top bit, where th_bnd lands; the forward's partial is the same:
    the global diagonal is a phase."""
    n, q = 2, L_loc - 1
    Lg, hs, phis, zm, sig, rows, tiles, K, (th_sc, th_bnd) = _general_case(
        pol, L_loc, n_amp, n, mode, seed=L_loc + n_amp)
    sign = -1.0 if inverse and mode == "depolarizing" else 1.0
    fold = cycle.fold_general_rows(tiles if inverse else rows, L_loc,
                                   sign * th_sc, sign * th_bnd,
                                   inverse=inverse)
    assert fold.shape == (n_amp, n, K + 1, 2 * L_loc)
    table = rb.angle_table(L_loc, "cpu")
    gkw = dict(L=Lg, local_bits=L_loc)
    gen = torch.Generator().manual_seed(L_loc)
    for a in range(n_amp):
        st = torch.randn((n, 1 << L_loc), dtype=torch.complex64,
                         generator=gen)
        st /= st.abs().pow(2).sum(-1, keepdim=True).sqrt()
        want = st.clone()
        if inverse:
            head = (sh._global_diag_inv if mode == "depolarizing"
                    else sh._global_diag)
            head(want, zm, sig, hs, phis, a, **gkw)
            for j in range(K):
                pre, post = tiles[:, j, 0], tiles[:, j, 1]
                want = rb.apply_phase(want,
                                      rg._row_angles(pre, L_loc, table))
                want = rb.apply_phase(rg._kick(want, pre, L_loc),
                                      rg._row_angles(post, L_loc, table))
            got = cycle.general_cycle_inverse_apply(st, tiles, fold[a],
                                                    L=L_loc, K=K)
        else:
            for j in range(K):
                want = rb.apply_phase(rg._kick(want, rows[:, j], L_loc),
                                      rg._row_angles(rows[:, j], L_loc,
                                                     table))
            sh._global_diag(want, zm, sig, hs, phis, a, **gkw)
            got, part = cycle.general_cycle_forward_apply(st, rows, fold[a],
                                                          L=L_loc, K=K, q=q)
            wpart = (want.real ** 2 + want.imag ** 2) @ table[q]
            torch.testing.assert_close(part, wpart, atol=TOL_SUM, rtol=0)
        assert float((got - want).abs().max()) < TOL_AMP
