"""The plain versions of the per-shard streamed cycle kernels K9a/K9b and
K10's shard-local forms (``ops/cycle_hi.py``) against the reference's Pallas
kernels (``dtc_tpu/ops/pallas_cycle_hi.py``,
``dtc_tpu/ops/pallas_cycle_hi_general.py``) in interpret mode, and against
the port's own K8 plain versions (``ops/cycle.py``) on the same rows.
K9a/K9b take K8's folded row pairs (``cycle.fold_cycle_rows``) of the
compact rows the reference's kernels get, K10's shard-local forms the slot
rows the reference's kernels get and their folded diagonals
(``cycle.fold_general_rows``); folded with a shard's global angles they
are held against the unfolded cycle with the engines' torch global
diagonal (``parallel/sharded.py::_global_diag``, ``_global_diag_inv``).

One cycle at L_loc = 22 (and 23 against K8) on random unit states: the
reference's planar (n, 2, TOP, 16384) f32 state is the port's flat
(n, 2^L) complex64 state, index by index. Probes cover the bands where a
streamed pass sits: q = 0 (pass lo), 11 = L//2, 14 and 16 (the strided
bits) and 21 (the top bit). The wide rows (256 lanes: x forward rows from
L_loc = 27, lab-frame rows at 30) are held bit for bit against the
reference's. Tolerances: amplitudes of a unit state at 2^22 are about
5e-4, and f32 sums of a cycle leave them within 2e-6 (TOL_AMP); partial
sums within 1e-5 (TOL_SUM).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dtc_tpu.core.sigma_evolve import _codes_from_uniform as j_codes
from dtc_tpu.core.sigma_evolve import _masks_from_codes as j_masks
from dtc_tpu.io.disorder import generate_disorder
from dtc_tpu.ops import pallas_cycle_hi as jh
from dtc_tpu.ops import pallas_cycle_hi_general as jhg
from dtc_tpu.ops.pallas_noise import pack_cycle_params_compact as j_pack
from dtc_tpu.ops.pallas_resident import _C
from dtc_tpu.ops.pallas_resident_general import _LANE_U8, _bits_row, slot_u8
from dtc_tpu.ops.pallas_streamed import _rx_kron
from dtc_tpu_torch.core.sigma_evolve import presample_noise
from dtc_tpu_torch.models.drives import build_kick_schedule
from dtc_tpu_torch.ops import cycle
from dtc_tpu_torch.ops import cycle_hi as ch
from dtc_tpu_torch.ops import cycle_hi_general as chg
from dtc_tpu_torch.ops import resident_blocked as rb
from dtc_tpu_torch.ops import resident_general as rg
from dtc_tpu_torch.ops import streamed as sm
from dtc_tpu_torch.ops.echo_fold import fold_rows
from dtc_tpu_torch.ops.kick import apply_uniform_1q_layer
from dtc_tpu_torch.ops.params import (
    WIDE,
    forward_rows,
    forward_width,
    pack_cycle_params_compact,
)
from dtc_tpu_torch.ops.params_general import (
    LANE_MPOS,
    flag_base,
    general_echo_rows,
    general_forward_rows,
    general_hi_width,
)
from dtc_tpu_torch.parallel import sharded as sh
from dtc_tpu_torch.utils import profiling

torch.set_num_threads(2)
L = 22
TOL_AMP, TOL_SUM = 2e-6, 1e-5
THETA = float(np.pi * 0.93)


def _disorder(Lr=L):
    hs, phis = generate_disorder(Lr, 1, seed=9)
    return (torch.as_tensor(hs[0, :Lr]), torch.as_tensor(phis[0, :Lr - 1]))


def _states(n, seed=2, Lr=L):
    """(port (n, 2^L) complex64, reference (n, 2, TOP, C) f32) unit states."""
    rng = np.random.default_rng(seed)
    s = rng.standard_normal((n, 2, 1 << Lr)).astype(np.float32)
    s /= np.sqrt((s ** 2).sum(axis=(1, 2), keepdims=True))
    port = torch.complex(torch.from_numpy(s[:, 0]), torch.from_numpy(s[:, 1]))
    return port, jnp.asarray(s.reshape(n, 2, -1, _C))


def _flat(planar):
    s = np.array(planar).reshape(planar.shape[0], 2, -1)
    return torch.complex(torch.from_numpy(s[:, 0]), torch.from_numpy(s[:, 1]))


def _x_rows(n, seed=4, Lr=L):
    """Noisy compact rows (p=0.6) of cycle 1 for n trajectories."""
    hs, phis = _disorder(Lr)
    u = torch.rand((n, 2, Lr), generator=torch.Generator().manual_seed(seed))
    _, zm, _, csum = presample_noise(u, 0.6, Lr)
    return pack_cycle_params_compact(zm[:, 1], csum[:, 1], hs, phis, Lr,
                                     forward_width(Lr))


def _general(pol, n, seed=5, Lr=L):
    """(forward rows of cycle 1 (n, K, width), inverse tiles of echo step 1
    at t=1 (n, K, 2, width), K) for a p=0.6 run of ``pol``."""
    hs, phis = _disorder(Lr)
    sched = build_kick_schedule(pol, 0.97, 2)
    K = sched.K
    u = torch.rand((n, 4 * K, Lr),
                   generator=torch.Generator().manual_seed(seed))
    w = general_hi_width(Lr)
    rows = general_forward_rows(u[:, :2 * K], hs, phis, sched.angles, L=Lr,
                                T=2, K=K, p=0.6, width=w)
    tiles = general_echo_rows(u, [1], hs, phis, sched.angles, L=Lr, T=2, K=K,
                              p=0.6, width=w)
    return (rows.reshape(n, 2, K, w)[:, 1],
            tiles.reshape(n, 4, K, 2, w)[:, 1], K)


def _kicks():
    u7r, u7i = (m[None] for m in _rx_kron(jnp.float32(THETA), 7))
    utr, uti = (m[None] for m in _rx_kron(jnp.float32(THETA), L - 21))
    return u7r, u7i, utr, uti


@pytest.mark.parametrize("q", [0, 11, 14, 16, 21])
def test_k9a_matches_reference_interpret(q):
    st, jst = _states(1)
    rows = _x_rows(1)
    got, part = ch.hi_cycle_forward_apply(st, cycle.fold_cycle_rows(rows, L),
                                          THETA, L=L, q=q)
    want, jpart = jh.hi_cycle_forward_apply(jst, jnp.asarray(rows.numpy()),
                                            *_kicks(), L=L, q=q,
                                            interpret=True)
    assert float((got - _flat(want)).abs().max()) < TOL_AMP
    np.testing.assert_allclose(part.numpy(), np.asarray(jpart), atol=TOL_SUM)


def test_k9b_matches_reference_interpret():
    st, jst = _states(1, seed=3)
    rows = _x_rows(1, seed=6)
    got = ch.hi_cycle_inverse_apply(
        st, cycle.fold_cycle_rows(rows, L, inverse=True), THETA, L=L)
    want = jh.hi_cycle_inverse_apply(jst, jnp.asarray(rows.numpy()),
                                     *_kicks(), L=L, interpret=True)
    assert float((got - _flat(want)).abs().max()) < TOL_AMP


@pytest.mark.parametrize("pol,q", [("y", 16), ("xy", 11),
                                   ("circular_left", 0)])
def test_k10a_shard_local_matches_reference_interpret(pol, q):
    rows, _, K = _general(pol, 1)
    st, jst = _states(1, seed=7)
    got, part = ch.general_hi_cycle_forward_apply(
        st, rows, cycle.fold_general_rows(rows, L), L=L, K=K, q=q)
    want, jpart = jhg.general_hi_cycle_forward_apply(
        jst, jnp.asarray(rows.numpy()), L=L, K=K, q=q, interpret=True)
    assert float((got - _flat(want)).abs().max()) < TOL_AMP
    np.testing.assert_allclose(part.numpy(), np.asarray(jpart), atol=TOL_SUM)


@pytest.mark.parametrize("pol", ["y", "xy"])
def test_k10b_shard_local_matches_reference_interpret(pol):
    _, tiles, K = _general(pol, 1)
    st, jst = _states(1, seed=8)
    got = ch.general_hi_cycle_inverse_apply(
        st, tiles, cycle.fold_general_rows(tiles, L, inverse=True), L=L, K=K)
    want = jhg.general_hi_cycle_inverse_apply(
        jst, jnp.asarray(tiles.numpy()), L=L, K=K, interpret=True)
    assert float((got - _flat(want)).abs().max()) < TOL_AMP


@pytest.mark.parametrize("Lr", [22, 23])
@pytest.mark.parametrize("kind", ["forward", "inverse", "general_forward",
                                  "general_inverse"])
def test_plain_matches_k8_plain(kind, Lr):
    """On the rows both take (L_loc = 22, 23: K8a/K8b and K9a/K9b the same
    folded row pairs, K10's shard-local forms and K8c/K8d the same 128-lane
    slot rows and their folded diagonals) the streamed family's
    plain versions equal K8's, with the angle tables that K8's plain
    versions build."""
    n, q = 1, Lr - 6
    st, _ = _states(n, seed=Lr, Lr=Lr)
    a, b = st.clone(), st.clone()
    if kind == "forward":
        fold = cycle.fold_cycle_rows(_x_rows(n, seed=Lr, Lr=Lr), Lr)
        _, pa = ch.hi_cycle_forward_apply(a, fold, THETA, L=Lr, q=q)
        _, pb = cycle.cycle_forward_apply(b, fold, THETA, L=Lr, q=q)
    elif kind == "inverse":
        fold = cycle.fold_cycle_rows(_x_rows(n, seed=Lr, Lr=Lr), Lr,
                                     inverse=True)
        ch.hi_cycle_inverse_apply(a, fold, THETA, L=Lr)
        cycle.cycle_inverse_apply(b, fold, THETA, L=Lr)
        pa = pb = torch.zeros(n)
    elif kind == "general_forward":
        rows, _, K = _general("circular_left", n, seed=Lr, Lr=Lr)
        fold = cycle.fold_general_rows(rows, Lr)
        _, pa = ch.general_hi_cycle_forward_apply(a, rows, fold, L=Lr, K=K,
                                                  q=q)
        _, pb = cycle.general_cycle_forward_apply(b, rows, fold, L=Lr, K=K,
                                                  q=q)
    else:
        _, tiles, K = _general("xy", n, seed=Lr, Lr=Lr)
        fold = cycle.fold_general_rows(tiles, Lr, inverse=True)
        ch.general_hi_cycle_inverse_apply(a, tiles, fold, L=Lr, K=K)
        cycle.general_cycle_inverse_apply(b, tiles, fold, L=Lr, K=K)
        pa = pb = torch.zeros(n)
    assert float((a - b).abs().max()) < TOL_AMP
    torch.testing.assert_close(pa, pb, atol=TOL_SUM, rtol=0)


def test_k9b_undoes_k9a_in_the_conjugated_frame():
    """conj(K9b(conj(K9a(s)))) = s on the same row: the inverse applies the
    diagonal before the kick with un-negated angles, (D K)^dag =
    conj(K D)."""
    st, _ = _states(1, seed=9)
    rows = _x_rows(1, seed=10)
    s1, _ = ch.hi_cycle_forward_apply(st.clone(),
                                      cycle.fold_cycle_rows(rows, L), THETA,
                                      L=L, q=8)
    back = ch.hi_cycle_inverse_apply(
        s1.conj().resolve_conj(),
        cycle.fold_cycle_rows(rows, L, inverse=True), THETA, L=L).conj()
    assert float((back - st).abs().max()) < TOL_AMP


def test_chain_equals_the_streamed_forward():
    """With no shard bits a chain of K9a cycles from the basis state is the
    one-card streamed forward: its partials, with the sigma sign, are A(t)
    of ``streamed_forward_batch``'s plain version on the same rows."""
    T, q, n = 3, 14, 1
    hs, phis = _disorder()
    u = torch.rand((n, T, L), generator=torch.Generator().manual_seed(1))
    rows, sig = forward_rows(u, hs[None], phis[None], L=L, T=T, p=0.6)
    want = sm.streamed_forward_batch_ref(rows, sig, THETA, L=L, q=q)
    st = rb.basis_states(n, L, 0, "cpu")
    parts = [torch.ones(n)]
    for t in range(T - 1):
        fold = cycle.fold_cycle_rows(rows[:, t], L)
        parts.append(ch.hi_cycle_forward_apply(st, fold, THETA, L=L, q=q)[1])
    got = rb.forward_host_factor(torch.stack(parts, 1), sig, q, 0, 1.0)
    torch.testing.assert_close(got, want, atol=TOL_SUM, rtol=0)


@pytest.mark.parametrize("Lr", [27, 30])
def test_wide_x_rows_bit_identical(Lr):
    """256-lane compact rows (x forward, L_loc >= 27) equal the reference's
    ``pack_cycle_params_compact(width=256)`` bit for bit."""
    hs, phis = generate_disorder(Lr, 1, seed=3)
    hs, phis = hs[0, :Lr], phis[0, :Lr - 1]
    rng = np.random.default_rng(Lr)
    zm = int(rng.integers(0, 1 << Lr))
    sig = int(rng.integers(0, 1 << Lr))
    assert forward_width(Lr) == WIDE
    got = pack_cycle_params_compact(torch.tensor(zm), torch.tensor(sig),
                                    torch.as_tensor(hs), torch.as_tensor(phis),
                                    Lr, WIDE)
    want = j_pack(jnp.uint32(zm), jnp.uint32(sig), jnp.asarray(hs),
                  jnp.asarray(phis), Lr, width=WIDE)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_wide_general_rows_bit_identical():
    """Lab-frame step rows at L_loc = 30 are 256 lanes wide (4L+9 > 128),
    as ``general_hi_width``; the forward rows equal the ones the
    reference's ``make_sharded_autocorr_forward_general`` builds at that
    width (its ``sample``: Z bits, X-mask bits, h and phi on the final slot,
    then the flag lanes with the slot's 2x2), bit for bit, on the same
    uniforms. The echo rows at 256 lanes are the 128-lane rows zero-padded
    where both exist (L = 29)."""
    Lr, T, p = 30, 3, 0.6
    assert (general_hi_width(29), general_hi_width(Lr)) == (128, WIDE)
    assert jhg.general_hi_width(Lr) == WIDE
    hs, phis = generate_disorder(Lr, 1, seed=4)
    hs, phis = hs[0, :Lr], phis[0, :Lr - 1]
    sched = build_kick_schedule("circular_left", 0.97, T)
    K, S = sched.K, T * sched.K
    u = np.asarray(jax.random.uniform(jax.random.PRNGKey(3), (S, Lr),
                                      dtype=jnp.float32))
    got = general_forward_rows(torch.tensor(u)[None], torch.as_tensor(hs),
                               torch.as_tensor(phis), sched.angles, L=Lr,
                               T=T, K=K, p=p, width=WIDE)[0]
    xm, zm = j_masks(j_codes(jnp.asarray(u), p), Lr)
    ang = jnp.asarray(sched.angles.numpy())
    u8 = jax.vmap(jax.vmap(lambda a: slot_u8(a[0], a[1])))(ang)
    flags = jnp.zeros((T, K, WIDE - (4 * Lr - 1)), jnp.float32)
    flags = flags.at[:, :, _LANE_U8:_LANE_U8 + 8].set(u8)
    final = jnp.zeros((T, K, 1), jnp.float32).at[:, K - 1, :].set(1.0)
    want = jnp.concatenate(
        [_bits_row(zm, Lr).reshape(T, K, Lr),
         _bits_row(xm, Lr).reshape(T, K, Lr),
         final * jnp.asarray(hs, jnp.float32)[None, None],
         final * jnp.asarray(phis, jnp.float32)[None, None], flags],
        axis=-1).reshape(S, WIDE)
    # the port's rows carry MPOS (the reference's kernel computes it)
    want = np.asarray(want).copy()
    mpos = flag_base(Lr) + LANE_MPOS
    want[:, mpos] = got[:, mpos].numpy()
    np.testing.assert_array_equal(got.numpy(), want)
    h29, p29 = torch.as_tensor(hs[:29]), torch.as_tensor(phis[:28])
    narrow = general_echo_rows(None, [2], h29, p29, sched.angles, L=29, T=T,
                               K=K, p=0.0, batch=(1,))
    wide = general_echo_rows(None, [2], h29, p29, sched.angles, L=29, T=T,
                             K=K, p=0.0, batch=(1,), width=WIDE)
    torch.testing.assert_close(wide[..., :128], narrow, atol=0, rtol=0)
    assert not wide[..., 128:].any()
    # K10's folded diagonals read the data lanes only: the same at either
    # width, and at L_loc = 30 row k + 1 is slot k's lab-frame diagonal
    pairs = (wide.reshape(1, 2 * T, K, 2, WIDE),
             narrow.reshape(1, 2 * T, K, 2, 128))
    for inverse in (False, True):
        fw, fn = (cycle.fold_general_rows(x if inverse else x[..., 0, :], 29,
                                          inverse=inverse) for x in pairs)
        torch.testing.assert_close(fw, fn, atol=0, rtol=0)
    fold = cycle.fold_general_rows(got.reshape(T, K, WIDE), Lr)
    assert fold.shape == (T, K + 1, 2 * Lr) and not fold[:, 0].any()
    cz, cb, c0 = rg.row_coeffs(got.reshape(T, K, WIDE).double(), Lr)
    want = torch.cat([cz, cb, c0[..., None]], -1).float()
    torch.testing.assert_close(fold[:, 1:], want, atol=0, rtol=0)


def test_flag_lanes_of_the_wrappers():
    """What K10's CUDA entries are handed: K10a's MPOS only on the final
    slot; K10b's slot pairs need no flag lane (every step runs), and its
    folded rows are ``echo_fold.fold_rows`` with COUNT = K: row 0 the first
    pre diagonal, row k + 1 post(k) + pre(k + 1), row K the last post, at
    256 lanes at L_loc = 30."""
    rows = torch.zeros((2, 3, WIDE))
    rows = cycle.measured_rows(rows, 30, 3)
    assert rows[:, :, flag_base(30) + LANE_MPOS].tolist() == [[-1, -1, 0]] * 2
    _, tiles, K = _general("xy", 2, seed=3)
    fold = cycle.fold_general_rows(tiles, L, inverse=True)
    assert fold.shape == (2, K + 1, 2 * L)
    want = fold_rows(tiles.reshape(2, 2 * K, -1), torch.full((2,), K), L,
                     rg.row_coeffs)
    torch.testing.assert_close(fold, want, atol=0, rtol=0)
    fold = cycle.fold_general_rows(torch.zeros((2, 3, 2, WIDE)), 30,
                                inverse=True)
    assert fold.shape == (2, 4, 60) and not fold.any()


def test_range_checks_and_cpu_route():
    profiling.reset_counters()
    st = torch.zeros((1, 1 << 21), dtype=torch.complex64)
    with pytest.raises(ValueError, match="22 <= L_loc <= 30"):
        ch.hi_cycle_forward_apply(st, torch.zeros(1, 2, 42), THETA, L=21,
                                  q=3)
    with pytest.raises(ValueError, match="22 <= L_loc <= 30"):
        ch.general_hi_cycle_inverse_apply(st, torch.zeros(1, 1, 2, 256),
                                          torch.zeros(1, 2, 62), L=31, K=1)
    st, _ = _states(1)
    with pytest.raises(ValueError, match="shard-local probe"):
        ch.hi_cycle_forward_apply(st, torch.zeros(1, 2, 2 * L), THETA, L=L,
                                  q=L)
    with pytest.raises(ValueError, match="shard-local probe"):
        ch.general_hi_cycle_forward_apply(st, torch.zeros(1, 1, 128),
                                          torch.zeros(1, 2, 2 * L), L=L,
                                          K=1, q=22)
    with pytest.raises(ValueError, match="rows must be"):
        ch.hi_cycle_inverse_apply(st, torch.zeros(1, 128), THETA, L=L)
    with pytest.raises(ValueError, match="rows must be"):
        ch.hi_cycle_forward_apply(st, torch.zeros(1, 2, 2 * L - 2), THETA,
                                  L=L, q=3)
    with pytest.raises(ValueError, match="rows must be"):
        ch.general_hi_cycle_inverse_apply(st, torch.zeros(1, 2, 128),
                                          torch.zeros(1, 3, 2 * L), L=L,
                                          K=2)
    with pytest.raises(ValueError, match="rows must be"):
        ch.general_hi_cycle_forward_apply(st, torch.zeros(1, 2, 128),
                                          torch.zeros(1, 2, 2 * L), L=L,
                                          K=2, q=3)
    ch.hi_cycle_inverse_apply(st, torch.zeros(1, 2, 2 * L), THETA, L=L)
    assert not profiling.LAUNCHES
    assert not profiling.PLAIN_ON_CUDA


def _global_case(n_amp, n, seed):
    """A noisy cycle (p=0.6) of n trajectories at L_loc = L on log2(n_amp)
    shard bits: the compact rows of the local bits, the masks, and every
    shard's global angles as the engines take them (``_tail_phase_angles``
    on an (A, 1) shard index)."""
    Lg = L + n_amp.bit_length() - 1
    hs, phis = _disorder(Lg)
    u = torch.rand((n, 2, Lg), generator=torch.Generator().manual_seed(seed))
    _, zm, _, csum = presample_noise(u, 0.6, Lg)
    zm, csum = zm[:, 1], csum[:, 1]
    rows = pack_cycle_params_compact(zm, csum, hs[:L], phis[:L - 1], L,
                                     forward_width(L))
    th_sc, th_bnd = sh._tail_phase_angles(
        zm[None], csum[None], hs, phis, torch.arange(n_amp)[:, None], L=Lg,
        local_bits=L)                                           # (A, n)
    return Lg, hs, phis, zm, csum, rows, th_sc, th_bnd


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n_amp", [2, 4])
def test_folded_global_diagonal_matches_the_torch_phase(n_amp, inverse):
    """On every shard at L_loc = 22, the plain K9a on ``fold_cycle_rows``
    with the shard's global angles equals the compact-row cycle (kick, then
    the row's diagonal) followed by ``_global_diag``; the plain K9b equals
    ``_global_diag``, then the row's diagonal and the kick. The forward's
    partial is the same: the global diagonal is a phase."""
    n, q = 2, L - 1
    Lg, hs, phis, zm, csum, rows, th_sc, th_bnd = _global_case(
        n_amp, n, seed=L + n_amp)
    rx = sm._rx(THETA, 1.0, "cpu")
    fold = cycle.fold_cycle_rows(rows, L, th_sc, th_bnd, inverse=inverse)
    assert fold.shape == (n_amp, n, 2, 2 * L)
    gen = torch.Generator().manual_seed(L + n_amp)
    for a in range(n_amp):
        st = torch.randn((n, 1 << L), dtype=torch.complex64, generator=gen)
        st /= st.abs().pow(2).sum(-1, keepdim=True).sqrt()
        want = st.clone()
        if inverse:
            sh._global_diag(want, zm, csum, hs, phis, a, L=Lg, local_bits=L)
            for i in range(n):
                want[i] = apply_uniform_1q_layer(
                    sm.phase_grid(want[i], sm._angles(rows[i], L)), rx, L)
            got = ch.hi_cycle_inverse_apply(st, fold[a], THETA, L=L)
        else:
            for i in range(n):
                want[i] = sm.phase_grid(
                    apply_uniform_1q_layer(want[i], rx, L),
                    sm._angles(rows[i], L))
            sh._global_diag(want, zm, csum, hs, phis, a, L=Lg, local_bits=L)
            got, part = ch.hi_cycle_forward_apply(st, fold[a], THETA, L=L,
                                                  q=q)
            wpart = torch.stack([sm.measure_z(w, q, L) for w in want])
            torch.testing.assert_close(part, wpart, atol=TOL_SUM, rtol=0)
        assert float((got - want).abs().max()) < TOL_AMP


def test_no_measure_forward_runs_the_same_cycle():
    """K9a with q=None: the same state, no partial."""
    st, _ = _states(2, seed=13)
    fold = cycle.fold_cycle_rows(_x_rows(2, seed=14), L)
    a, part = ch.hi_cycle_forward_apply(st.clone(), fold, THETA, L=L)
    b, _ = ch.hi_cycle_forward_apply(st.clone(), fold, THETA, L=L, q=3)
    assert part is None
    assert torch.equal(a, b)


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("mode", ["depolarizing", "device"])
@pytest.mark.parametrize("pol", ["y", "xy"])
@pytest.mark.parametrize("n_amp", [2, 4])
def test_folded_global_diagonal_matches_the_torch_phase_general(
        n_amp, pol, mode, inverse):
    """On every shard at L_loc = 22, the plain K10a on slot rows folded with
    the shard's global angles (``fold_general_rows``) equals the slot
    cycle (each slot's kick, then its row's diagonal) followed by
    ``_global_diag``; the plain K10b equals the daggered global diagonal,
    then the daggered cycle (per slot the pre diagonal, the kick, the post
    diagonal). The daggered global diagonal is ``_global_diag_inv`` under
    depolarizing noise and ``_global_diag`` on per-trajectory rows in device
    mode, whose pre rows carry the negation (the engines' sign
    conventions). The forward's partial is the same: the global diagonal
    is a phase."""
    n, q = 2, L - 1
    Lg = L + n_amp.bit_length() - 1
    rows, tiles, K = _general(pol, n, seed=L + n_amp)
    hs, phis = _disorder(Lg)
    gen = torch.Generator().manual_seed(Lg)
    if mode == "device":  # per-trajectory rows, as the device rows give
        hs = hs + torch.rand((n, Lg), generator=gen, dtype=torch.float64)
        phis = phis + torch.rand((n, Lg - 1), generator=gen,
                                 dtype=torch.float64)
    zm, sig = (torch.randint(0, 1 << Lg, (n,), generator=gen)
               & ~((1 << L) - 1) for _ in range(2))
    th_sc, th_bnd = sh._tail_phase_angles(
        zm[None], sig[None], hs, phis, torch.arange(n_amp)[:, None], L=Lg,
        local_bits=L)                                           # (A, n)
    sign = -1.0 if inverse and mode == "depolarizing" else 1.0
    fold = cycle.fold_general_rows(tiles if inverse else rows, L, sign * th_sc,
                                sign * th_bnd, inverse=inverse)
    assert fold.shape == (n_amp, n, K + 1, 2 * L)
    gkw = dict(L=Lg, local_bits=L)
    for a in range(n_amp):
        st = torch.randn((n, 1 << L), dtype=torch.complex64, generator=gen)
        st /= st.abs().pow(2).sum(-1, keepdim=True).sqrt()
        want = st.clone()
        if inverse:
            head = (sh._global_diag_inv if mode == "depolarizing"
                    else sh._global_diag)
            head(want, zm, sig, hs, phis, a, **gkw)
            for i in range(n):
                w = want[i]
                for j in range(K):
                    pre, post = tiles[i, j, 0], tiles[i, j, 1]
                    w = chg._lab_phase(
                        chg._kick_one(chg._lab_phase(w, pre, L), pre, L),
                        post, L)
                want[i] = w
            got = ch.general_hi_cycle_inverse_apply(st, tiles, fold[a], L=L,
                                                    K=K)
        else:
            for i in range(n):
                w = want[i]
                for j in range(K):
                    w = chg._lab_phase(chg._kick_one(w, rows[i, j], L),
                                       rows[i, j], L)
                want[i] = w
            sh._global_diag(want, zm, sig, hs, phis, a, **gkw)
            got, part = ch.general_hi_cycle_forward_apply(st, rows, fold[a],
                                                          L=L, K=K, q=q)
            wpart = torch.stack([sm.measure_z(w, q, L) for w in want])
            torch.testing.assert_close(part, wpart, atol=TOL_SUM, rtol=0)
        assert float((got - want).abs().max()) < TOL_AMP
