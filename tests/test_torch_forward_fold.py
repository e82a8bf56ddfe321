"""The forwards' diagonal rows (``ops/echo_fold.py`` ``forward_fold``)
and their pass order on the step passes of ``csrc/floquet_echo.cuh``: the
lab-frame forwards (K10a, K4) and the sigma-frame x forwards (K6a/K7a, K1,
K3a).

A forward step k of K10a is the kick of step row k, applied pass by pass to
the bits of pass lo [0, a), pass mid [a, a + b) and pass hi [a + b, L),
then row k + 1 of ``forward_fold`` (row k's diagonal) as pass hi stores; a
step whose row has MPOS >= 0 is measured into A(MPOS) there. Row 0 is not
applied: nothing comes before step 0's kick. Here, on the CPU, a plain loop
in that order is held against the plain version
``general_hi_forward_batch_ref`` (1e-5, on both pass plans: the diagonal
rows carry the same coefficients, rounded once) at L = 14, 15, below the
kernel's range (its range check is lowered for the test; its arithmetic
does not depend on L), and against JAX's interpret K4 forward, the same
lab-frame math, at L=14 (1e-4, the bound of ``test_torch_resident.py``).
K4's forward runs the same steps on K2's split (``lo_bits``: pass lo's
bits [0, L - L/2), pass hi's the rest) on the rows its wrapper folds
(``general_forward_scratch``: ``forward_fold`` of the (T-1) K steps it
runs); that loop and ``general_forward_batch_ref`` are each held to the
same loop in complex128 at L = 14, 15 (the plain version's range starts at
14), within float32's rounding over the steps (``f32_rounding.py``), and
the loop against JAX's interpret K4 forward at L=14 (1e-4); the loop with
each diagonal one step late (a planted fault) is off the plain version by
over 100 times that tolerance.

K10's shard-local forms (``ops/cycle_hi.py``: one lab-frame cycle on a
shard's local bits) run the same passes for the K slots of a cycle from the
shard states as they are: K10a's slot k is the kick of slot row k, pass by
pass, then row k + 1 of ``cycle.fold_general_rows`` as pass hi stores (the
final slot's row also carrying the shard's global angles); K10b first
applies fold row 0 (the first pre diagonal and the shard's daggered global
diagonal) in pass lo before its first kick, then per slot the kick of the
pre row and row k + 1. That loop is held against the plain versions on
rows folded with random global angles (1e-5 on amplitudes and partials,
both plans, L = 14, 15, the range check lowered as above). K8c and K8d
(``ops/cycle.py``) run the same cycle on K2's split (``lo_bits``, as K1
below); the loop on that split is held against their plain versions at
L_loc = 17 the same way.

The x forward's step k is RX(theta) on the bits of pass lo, mid and hi,
then row k + 1 of ``forward_fold`` with the sigma-frame coefficients
(``ops/resident_blocked.py::row_coeffs``) as pass hi stores, measured into
A(k + 1) there, and the host's sigma/ancilla factor after the kernel. The
same kind of loop is held against ``streamed_forward_batch_ref`` (1e-5, both
plans, L = 14, 15, the range check lowered as above) and against JAX's sigma
engine ``sigma_forward_batch`` at L=14 on uniforms drawn in JAX (1e-4, the
bound of ``test_torch_streamed.py``).

The resident x forwards, K1 and K3a, run the same steps on their own
split (``lo_bits``: pass lo's bits [0, L - L/2), pass hi's the rest), K3a
with the step's kick read from its table (cycle k its row k, bounded by
the table's rows). That loop is held against ``blocked_forward_batch_ref``
at L=17 and ``resident_forward_batch_ref`` at L = 14, 15 with a ramp whose
every cycle differs and with a constant schedule (1e-5; probes in each
pass's bits), and against JAX's interpret K1 at L=17 and K3a at L=14 on
the same uniforms (1e-4). The kernels themselves are held against the
plain versions on the card by ``test_torch_kernels_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dtc_tpu.core.sigma_evolve import sigma_forward_batch as j_sigma_forward
from dtc_tpu.io.disorder import generate_disorder
from dtc_tpu.models.drives import build_kick_schedule as j_sched
from dtc_tpu.ops.pallas_resident import (
    resident_forward_batch as j_resident_forward,
)
from dtc_tpu.ops.pallas_resident_blocked import (
    blocked_forward_batch as j_blocked_forward,
)
from dtc_tpu.ops.pallas_resident_general import (
    general_forward_batch as j_forward,
)
from dtc_tpu_torch.core.statevector import basis_index
from dtc_tpu_torch.models.drives import build_kick_schedule
from dtc_tpu_torch.ops import cycle
from dtc_tpu_torch.ops import cycle_hi as ch
from dtc_tpu_torch.ops import cycle_hi_general as chg
from dtc_tpu_torch.ops import resident as rs
from dtc_tpu_torch.ops import resident_blocked as rb
from dtc_tpu_torch.ops import resident_general as rg
from dtc_tpu_torch.ops import streamed as sm
from dtc_tpu_torch.ops.echo_fold import forward_fold
from dtc_tpu_torch.ops.params import forward_rows
from dtc_tpu_torch.ops.params_general import (
    LANE_MPOS,
    LANE_U8,
    flag_base,
    general_echo_rows,
    general_forward_rows,
)

from f32_rounding import expectation_error

torch.set_num_threads(2)

T = 3
DRIVES = ["y", "xy", "circular_left", "xy_cycle"]


def _disorder(L):
    hs, phis = generate_disorder(L, 1, seed=7)
    return hs[:, :L], phis[:, :L - 1]


def _rows(drive, L, uniforms=None, n=2, p=0.3, seed=11):
    """(1, n, T*K, 128) forward step rows of ``drive`` on the suite's
    disorder, uniforms from a numpy seed unless given."""
    hs, phis = _disorder(L)
    angles = build_kick_schedule(drive, 0.97, T, xy_cycle_period=1).angles
    K = angles.shape[1]
    if uniforms is None:
        rng = np.random.default_rng(seed)
        uniforms = torch.from_numpy(
            rng.random((1, n, T * K, L), dtype=np.float32))
    return general_forward_rows(
        uniforms, torch.from_numpy(hs)[:, None],
        torch.from_numpy(phis)[:, None], angles, L=L, T=T, K=K, p=p)


def _plan(L, passes):
    """(a, b): pass lo's bits [0, a), pass mid's [a, a + b) (b = 0: none),
    as ``csrc/floquet_plan.cuh`` cuts them (two passes to L = 24, three
    from 25), either plan at any L."""
    if passes == 2:
        c = (L - 2) // 2
        return L - c, 0
    c = (L - 2) // 3
    return L - 2 * c, c


def _kick_bits(state, row, L, lo, hi):
    """The step's 2x2 (U, rows swapped where the X-mask bit is 1) on qubits
    [lo, hi) of the (n, 2^L) states, one qubit at a time."""
    u8 = row[:, flag_base(L) + LANE_U8:flag_base(L) + LANE_U8 + 8]
    u = torch.complex(u8[:, 0::2], u8[:, 1::2]).reshape(-1, 2, 2)
    n = state.shape[0]
    for j in range(lo, hi):
        m = torch.where(row[:, L + j, None, None] > 0.5, u.flip(-2), u)
        s = state.reshape(n, 1 << (L - j - 1), 2, 1 << j)
        state = torch.einsum("nab,nhbl->nhal", m.to(state.dtype), s)
    return state.reshape(n, 1 << L)


def _step_pass_loop(rows, L, q, initial_state, split, fold=None,
                    dtype=torch.complex64):
    """A(t) of the forward in the kernel's order on the split (a, b): per
    step the kick on pass lo's bits [0, a), mid's [a, a + b) and hi's
    [a + b, L), then fold row k + 1 (``fold``, default ``forward_fold`` of
    every row); the measure after it where the row names a time; A(0) the
    basis state's z_q; times the host's sign, as the wrappers. In ``dtype``
    (complex64, or complex128 on the same rows and a float64 ``fold``)."""
    real = torch.float64 if dtype == torch.complex128 else torch.float32
    flat = rows.reshape(-1, *rows.shape[-2:])
    n, S = flat.shape[:2]
    K = S // T
    a, b = split
    if fold is None:
        fold = forward_fold(flat, L, rg.row_coeffs, dtype=real)
    table = rb.angle_table(L, flat.device).to(real)
    b0 = basis_index(L, initial_state)
    state = rb.basis_states(n, L, b0, flat.device).to(dtype)
    a_raw = torch.zeros((n, T), dtype=real)
    a_raw[:, 0] = rb.basis_sign(b0, q)
    for k in range((T - 1) * K):
        row = flat[:, k]
        for lo, hi in ((0, a), (a, a + b), (a + b, L)):
            state = _kick_bits(state, row, L, lo, hi)
        f = fold[:, k + 1]
        theta = f[:, -1:] + f[:, :-1] @ table
        state = state * torch.polar(torch.ones_like(theta), theta)
        mpos = row[:, flag_base(L) + LANE_MPOS].to(torch.int64)
        for i in torch.nonzero(mpos >= 0)[:, 0].tolist():
            a_raw[i, mpos[i]] = (state[i].abs() ** 2) @ table[q]
    return (rb.basis_sign(b0, q) * a_raw).reshape(*rows.shape[:-2], T)


@pytest.mark.parametrize("L", [14, 15])
@pytest.mark.parametrize("drive", DRIVES)
def test_forward_fold_layout(drive, L):
    """(n, S + 1, 2L) f32: row 0 zero, row k + 1 = row_coeffs of step row
    k (cz [0, L), cb [L, 2L-1), c0 at 2L-1)."""
    rows = _rows(drive, L)
    flat = rows.reshape(-1, *rows.shape[-2:])
    n, S = flat.shape[:2]
    fold = forward_fold(flat, L, rg.row_coeffs)
    assert fold.shape == (n, S + 1, 2 * L)
    assert fold.dtype == torch.float32
    assert not fold[:, 0].any()
    cz, cb, c0 = rg.row_coeffs(flat.double(), L)
    want = torch.cat([cz, cb, c0[..., None]], -1)
    np.testing.assert_allclose(fold[:, 1:].numpy(), want.numpy(), atol=1e-6,
                               rtol=0)


@pytest.mark.parametrize("passes", [2, 3])
@pytest.mark.parametrize("initial_state", ["vacuum", "neel"])
@pytest.mark.parametrize("L", [14, 15])
@pytest.mark.parametrize("drive", DRIVES)
def test_step_pass_order_matches_plain(drive, L, initial_state, passes,
                                       monkeypatch):
    monkeypatch.setattr(chg, "MIN_L", 14)
    rows = _rows(drive, L)
    for q in (0, L // 2, L - 1):
        got = _step_pass_loop(rows, L, q, initial_state, _plan(L, passes))
        want = chg.general_hi_forward_batch_ref(
            rows, L=L, T=T, q=q, initial_state=initial_state)
        assert got.shape == want.shape == (1, 2, T)
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5,
                                   rtol=0)


def _uniforms(keys, shape):
    return torch.from_numpy(np.array(jax.vmap(jax.vmap(
        lambda k: jax.random.uniform(k, shape, dtype=jnp.float32)))(keys)))


@pytest.mark.parametrize("drive", ["y", "circular_left"])
def test_step_pass_order_matches_reference_interpret(drive):
    L, q = 14, 9
    hs, phis = _disorder(L)
    sched = j_sched(drive, 0.97, T)
    K = sched.angles.shape[1]
    keys = jax.random.split(jax.random.PRNGKey(3), 2)[None]
    ref = np.asarray(j_forward(
        jnp.asarray(hs), jnp.asarray(phis), sched.angles, keys, L=L, T=T,
        K=K, p=0.3, q=q, interpret=True))
    rows = _rows(drive, L, uniforms=_uniforms(keys, (T * K, L)))
    got = _step_pass_loop(rows, L, q, "vacuum", _plan(L, 3)).numpy()
    assert got.shape == ref.shape == (1, 2, T)
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)


# --- K4's forward on the step passes (K2's split)


@pytest.mark.parametrize("L", [14, 15])
@pytest.mark.parametrize("drive", DRIVES)
def test_k4_forward_scratch_layout(drive, L):
    """What K4's forward wrapper hands the kernel beside the rows:
    n_steps = (T-1) K, ``forward_fold`` of rows 0..n_steps-1 (n, n_steps + 1,
    2L) with row 0 zero and row k + 1 step k's ``row_coeffs``, and zeroed
    partials (n, T, blocks)."""
    rows = _rows(drive, L)
    flat = rows.reshape(-1, *rows.shape[-2:])
    n, S = flat.shape[:2]
    K = S // T
    fold, partials, n_steps = rg.general_forward_scratch(flat, L, T, 5)
    assert n_steps == (T - 1) * K
    assert fold.shape == (n, n_steps + 1, 2 * L)
    assert fold.dtype == torch.float32
    assert not fold[:, 0].any()
    cz, cb, c0 = rg.row_coeffs(flat[:, :n_steps].double(), L)
    want = torch.cat([cz, cb, c0[..., None]], -1)
    np.testing.assert_allclose(fold[:, 1:].numpy(), want.numpy(), atol=1e-6,
                               rtol=0)
    assert partials.shape == (n, T, 5) and not partials.any()


def _k4_fold(rows, L, dtype=torch.float32):
    """The folded rows K4's forward wrapper builds; in float64, the same
    rows' ``forward_fold`` of the (T-1) K steps it runs, rounded never."""
    flat = rows.reshape(-1, *rows.shape[-2:])
    if dtype == torch.float32:
        return rg.general_forward_scratch(flat, L, T, 1)[0]
    steps = (T - 1) * (flat.shape[1] // T)
    return forward_fold(flat[:, :steps], L, rg.row_coeffs, dtype=dtype)


def _k4_tolerance(fold64, L) -> float:
    """The float32 tolerance of A(t) (``f32_rounding.py``, |z_q| = 1) after
    the steps of the float64 folded rows, their sum |c| the largest over
    the trajectories."""
    return expectation_error(fold64[:, 1:].abs().sum(-1).amax(0).tolist(), L)


@pytest.mark.parametrize("initial_state", ["vacuum", "neel"])
@pytest.mark.parametrize("L", [14, 15])
@pytest.mark.parametrize("drive", DRIVES)
def test_k4_forward_step_pass_order_matches_plain(drive, L, initial_state):
    """K4's forward in the step passes' order on K2's split (``lo_bits``,
    two passes) and the wrapper's folded rows, and
    ``general_forward_batch_ref``, each held to the same loop in complex128
    within float32's rounding over the steps; probes in pass lo's bits, at
    the split and in pass hi's."""
    rows = _rows(drive, L)
    fold64 = _k4_fold(rows, L, torch.float64)
    tol = _k4_tolerance(fold64, L)
    for q in (0, L // 2, L - 1):
        got = _step_pass_loop(rows, L, q, initial_state, _resident_split(L),
                              _k4_fold(rows, L))
        want = rg.general_forward_batch_ref(rows, L=L, T=T, q=q,
                                            initial_state=initial_state)
        ref = _step_pass_loop(rows, L, q, initial_state, _resident_split(L),
                              fold64, torch.complex128)
        assert got.shape == want.shape == ref.shape == (1, 2, T)
        for side in (got, want):
            np.testing.assert_allclose(side.double().numpy(), ref.numpy(),
                                       atol=tol, rtol=0)


@pytest.mark.parametrize("drive", ["xy", "circular_left"])
def test_k4_forward_pass_order_fault_fails_by_orders_of_magnitude(drive):
    """A planted fault, each step's diagonal applied after the next step's
    kick (the folded rows one row late), on the two-slot drives (with one
    slot a cycle, T=3 leaves one late diagonal before a measure): the plain
    version is off the faulty loop by over 100 times the float32
    tolerance."""
    L, q = 15, 0
    rows = _rows(drive, L)
    fold64 = _k4_fold(rows, L, torch.float64)
    bad = _step_pass_loop(rows, L, q, "vacuum", _resident_split(L),
                          fold64.roll(1, 1), torch.complex128)
    want = rg.general_forward_batch_ref(rows, L=L, T=T, q=q)
    gap = float((want.double() - bad).abs().max())
    assert gap > 100 * _k4_tolerance(fold64, L), gap


@pytest.mark.parametrize("drive", ["y", "circular_left"])
def test_k4_forward_step_pass_order_matches_reference_interpret(drive):
    """The same loop against JAX's interpret K4 forward at L=14 on the same
    uniforms (1e-4)."""
    L, q = 14, 9
    hs, phis = _disorder(L)
    sched = j_sched(drive, 0.97, T)
    K = sched.angles.shape[1]
    keys = jax.random.split(jax.random.PRNGKey(3), 2)[None]
    ref = np.asarray(j_forward(
        jnp.asarray(hs), jnp.asarray(phis), sched.angles, keys, L=L, T=T,
        K=K, p=0.3, q=q, interpret=True))
    rows = _rows(drive, L, uniforms=_uniforms(keys, (T * K, L)))
    got = _step_pass_loop(rows, L, q, "vacuum", _resident_split(L),
                          _k4_fold(rows, L)).numpy()
    assert got.shape == ref.shape == (1, 2, T)
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)


# --- K10's shard-local forms: one cycle on a shard's local bits


def _cycle_rows(drive, L, n=2, seed=17):
    """(forward slot rows (n, K, 128) of cycle 1, inverse slot pairs
    (n, K, 2, 128) of echo step 1 at t=1, K, global angles (th_sc, th_bnd)
    (n,) each uniform in [-pi, pi)) of a p=0.3 run of ``drive``."""
    hs, phis = _disorder(L)
    angles = build_kick_schedule(drive, 0.97, 2, xy_cycle_period=1).angles
    K = angles.shape[1]
    rng = np.random.default_rng(seed)
    u = torch.from_numpy(rng.random((n, 4 * K, L), dtype=np.float32))
    h, ph = torch.from_numpy(hs[0]), torch.from_numpy(phis[0])
    rows = general_forward_rows(u[:, :2 * K], h, ph, angles, L=L, T=2, K=K,
                                p=0.3)
    tiles = general_echo_rows(u, [1], h, ph, angles, L=L, T=2, K=K, p=0.3)
    th = torch.from_numpy(rng.uniform(-np.pi, np.pi, (2, n)))
    return (rows.reshape(n, 2, K, -1)[:, 1],
            tiles.reshape(n, 4, K, 2, -1)[:, 1], K, th)


def _cycle_pass_loop(state, slots, fold, L, split, inverse):
    """One per-shard lab-frame cycle (K8c/K8d, K10's shard-local forms) in
    the step passes' order on the split (a, b): the inverse's fold row 0
    before its first kick (pass lo); per slot k the kick of its row (the
    pre row of the inverse's pair) on pass lo's, mid's and hi's bits, then
    fold row k + 1 as pass hi stores."""
    a, b = split
    table = rb.angle_table(L, state.device)

    def diag(st, f):
        theta = f[:, -1:] + f[:, :-1] @ table
        return st * torch.polar(torch.ones_like(theta), theta)

    if inverse:
        state = diag(state, fold[:, 0])
    for k in range(slots.shape[1]):
        row = slots[:, k, 0] if inverse else slots[:, k]
        for lo, hi in ((0, a), (a, a + b), (a + b, L)):
            state = _kick_bits(state, row, L, lo, hi)
        state = diag(state, fold[:, k + 1])
    return state


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("passes", [2, 3])
@pytest.mark.parametrize("L", [14, 15])
@pytest.mark.parametrize("drive", ["y", "xy", "circular_left"])
def test_cycle_step_pass_order_matches_plain(drive, L, passes, inverse,
                                             monkeypatch):
    monkeypatch.setattr(ch, "MIN_L", 14)
    rows, tiles, K, th = _cycle_rows(drive, L)
    slots = tiles if inverse else rows
    fold = cycle.fold_general_rows(slots, L, *th, inverse=inverse)
    st = _unit_states(L)
    got = _cycle_pass_loop(st, slots, fold, L, _plan(L, passes), inverse)
    if inverse:
        want = ch.general_hi_cycle_inverse_apply_ref(st.clone(), tiles, fold,
                                                     L=L, K=K)
    else:
        table = rb.angle_table(L, st.device)
        for q in (0, L // 2, L - 1):
            want, part = ch.general_hi_cycle_forward_apply_ref(
                st.clone(), rows, fold, L=L, K=K, q=q)
            np.testing.assert_allclose(part.numpy(),
                                       ((got.abs() ** 2) @ table[q]).numpy(),
                                       atol=1e-5, rtol=0)
    assert float((got - want).abs().max()) < 1e-5


def _unit_states(L, n=2):
    """n random unit states (n, 2^L) complex64 from a numpy seed."""
    rng = np.random.default_rng(L)
    s = rng.standard_normal((n, 2, 1 << L)).astype(np.float32)
    s /= np.sqrt((s ** 2).sum(axis=(1, 2), keepdims=True))
    return torch.complex(torch.from_numpy(s[:, 0]), torch.from_numpy(s[:, 1]))


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("drive", ["y", "xy", "circular_left"])
def test_k8_cycle_step_pass_order_matches_plain(drive, inverse):
    """K8c/K8d's pass order on K2's split (a = L - L/2, two passes) at
    L_loc = 17 against their plain versions, on rows folded with random
    global angles; probes in pass lo's bits, pass hi's and the local top
    bit, where th_bnd lands."""
    L = 17
    rows, tiles, K, th = _cycle_rows(drive, L)
    slots = tiles if inverse else rows
    fold = cycle.fold_general_rows(slots, L, *th, inverse=inverse)
    st = _unit_states(L)
    got = _cycle_pass_loop(st, slots, fold, L, (L - L // 2, 0), inverse)
    if inverse:
        want = cycle.general_cycle_inverse_apply_ref(st.clone(), tiles, fold,
                                                     L=L, K=K)
    else:
        table = rb.angle_table(L, st.device)
        for q in (0, L // 2, L - 1):
            want, part = cycle.general_cycle_forward_apply_ref(
                st.clone(), rows, fold, L=L, K=K, q=q)
            np.testing.assert_allclose(part.numpy(),
                                       ((got.abs() ** 2) @ table[q]).numpy(),
                                       atol=1e-5, rtol=0)
    assert float((got - want).abs().max()) < 1e-5


# --- the sigma-frame x forward (K6a/K7a)

THETA = 0.97 * np.pi


def _x_rows(L, uniforms=None, n=2, T_=T, p=0.3, seed=13):
    """(1, n, T, width) compact rows and (1, n, T) sigma of n trajectories
    of different uniforms (numpy seed unless given) on the suite's
    disorder."""
    hs, phis = _disorder(L)
    if uniforms is None:
        rng = np.random.default_rng(seed)
        uniforms = torch.from_numpy(
            rng.random((1, n, T_, L), dtype=np.float32))
    return forward_rows(uniforms, torch.from_numpy(hs)[:, None],
                        torch.from_numpy(phis)[:, None], L=L, T=T_, p=p)


def _rx_bits(state, L, lo, hi, cs=None):
    """RX from the kernels' f32 (cos, sin) of theta/2 (``cs``, default
    THETA's) on qubits [lo, hi) of the (n, 2^L) states, one qubit at a
    time."""
    c, s = rb.kick_cs(THETA) if cs is None else cs
    rx = torch.tensor([[c, -1j * s], [-1j * s, c]], dtype=state.dtype)
    n = state.shape[0]
    for j in range(lo, hi):
        st = state.reshape(n, 1 << (L - j - 1), 2, 1 << j)
        state = torch.einsum("ab,nhbl->nhal", rx, st)
    return state.reshape(n, 1 << L)


def _x_step_pass_loop(rows, sig, L, q, initial_state, split, cs=None):
    """A(t) of the x forward in the kernel's order on the split (a, b): per
    cycle k < T-1 the kick on pass lo's bits [0, a), mid's [a, a + b) and
    hi's [a + b, L), then fold row k + 1 of the wrapper's ``forward_fold``
    (rows 0..T-2), measured into A(k + 1); A(0) the basis state's z_q; then
    the host's sigma/ancilla factor. ``cs``: K3a's (tu, 2) table of (cos,
    sin) of theta/2, cycle k reading row min(k, tu - 1) (``TableKick``);
    default THETA every cycle (K1's ``ConstKick``)."""
    flat = rows.reshape(-1, *rows.shape[-2:])
    n, T_ = flat.shape[:2]
    a, b = split
    fold = forward_fold(flat[:, :T_ - 1], L, rb.row_coeffs)
    assert fold.shape == (n, T_, 2 * L)
    table = rb.angle_table(L, flat.device)
    b0 = basis_index(L, initial_state)
    state = rb.basis_states(n, L, b0, flat.device)
    a_raw = torch.zeros((n, T_))
    a_raw[:, 0] = rb.basis_sign(b0, q)
    for k in range(T_ - 1):
        ck = None if cs is None else cs[min(k, cs.shape[0] - 1)].tolist()
        for lo, hi in ((0, a), (a, a + b), (a + b, L)):
            state = _rx_bits(state, L, lo, hi, ck)
        f = fold[:, k + 1]
        theta = f[:, -1:] + f[:, :-1] @ table
        state = state * torch.polar(torch.ones_like(theta), theta)
        a_raw[:, k + 1] = (state.abs() ** 2) @ table[q]
    return rb.forward_host_factor(a_raw.reshape(*rows.shape[:-2], T_), sig,
                                  q, b0, 1.0)


@pytest.mark.parametrize("L", [14, 15])
def test_x_forward_fold_layout(L):
    """``forward_fold`` on compact rows (the wrapper passes rows 0..T-2):
    (n, T, 2L) f32, row 0 zero, row k + 1 = the sigma-frame row_coeffs of
    cycle row k."""
    rows, _ = _x_rows(L)
    flat = rows.reshape(-1, *rows.shape[-2:])
    n = flat.shape[0]
    fold = forward_fold(flat[:, :T - 1], L, rb.row_coeffs)
    assert fold.shape == (n, T, 2 * L)
    assert fold.dtype == torch.float32
    assert not fold[:, 0].any()
    cz, cb, c0 = rb.row_coeffs(flat[:, :T - 1].double(), L)
    want = torch.cat([cz, cb, c0[..., None]], -1)
    np.testing.assert_allclose(fold[:, 1:].numpy(), want.numpy(), atol=1e-6,
                               rtol=0)
    assert not torch.equal(fold[0], fold[1])  # the trajectories differ


@pytest.mark.parametrize("passes", [2, 3])
@pytest.mark.parametrize("initial_state", ["vacuum", "neel"])
@pytest.mark.parametrize("L", [14, 15])
def test_x_step_pass_order_matches_plain(L, initial_state, passes,
                                         monkeypatch):
    monkeypatch.setattr(sm, "MIN_L", 14)
    rows, sig = _x_rows(L)
    for q in (0, L // 2, L - 1):
        got = _x_step_pass_loop(rows, sig, L, q, initial_state,
                                _plan(L, passes))
        want = sm.streamed_forward_batch_ref(rows, sig, THETA, L=L, q=q,
                                             initial_state=initial_state)
        assert got.shape == want.shape == (1, 2, T)
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5,
                                   rtol=0)


@pytest.mark.parametrize("initial_state", ["vacuum", "neel"])
def test_x_step_pass_order_matches_reference_sigma_engine(initial_state):
    L, q, p = 14, 9, 0.3
    hs, phis = _disorder(L)
    keys = jax.random.split(jax.random.PRNGKey(5), 2)[None]
    ref = np.asarray(j_sigma_forward(
        jnp.asarray(hs), jnp.asarray(phis), j_sched("x", 0.97, T).angles,
        keys, L=L, T=T, K=1, p=p, q=q, initial_state=initial_state,
        dtype_name="complex64", ancilla_factor=1.0, has_y=False))
    rows, sig = _x_rows(L, uniforms=_uniforms(keys, (T, L)), p=p)
    got = _x_step_pass_loop(rows, sig, L, q, initial_state,
                            _plan(L, 3)).numpy()
    assert got.shape == ref.shape == (1, 2, T)
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)


# --- the resident x forwards (K1, K3a) on the same step passes

def _resident_split(L):
    """K1's and K3a's split (``floquet_common.cuh::lo_bits``, two passes):
    pass lo's bits [0, L - L/2), pass hi's the rest."""
    return L - L // 2, 0


@pytest.mark.parametrize("T_", [1, 3])
def test_resident_forward_scratch_layout(T_):
    """What K1's and K3a's wrappers hand the kernel beside the rows:
    ``forward_fold`` of rows 0..T-2, (n, T, 2L) with row 0 zero (T = 1: no
    cycle runs, one unread row), and zeroed partials (n, T, blocks)."""
    L = 17
    rows, _ = _x_rows(L, T_=T_)
    flat = rows.reshape(-1, *rows.shape[-2:])
    fold, partials = rb.forward_scratch(flat, L, 5)
    assert fold.shape == (2, T_, 2 * L) and fold.dtype == torch.float32
    assert partials.shape == (2, T_, 5) and not partials.any()
    assert not fold[:, 0].any()
    torch.testing.assert_close(
        fold, forward_fold(flat[:, :T_ - 1], L, rb.row_coeffs), rtol=0,
        atol=0)


@pytest.mark.parametrize("q_at", ["lo", "mid", "hi"])
@pytest.mark.parametrize("initial_state", ["vacuum", "neel"])
def test_resident_x_step_pass_order_matches_plain(initial_state, q_at):
    """K1's pass order on its split at L=17 (probes in pass lo's bits, at
    the split and in pass hi's) against ``blocked_forward_batch_ref``, 2
    trajectories of different rows."""
    L = 17
    q = {"lo": 0, "mid": L // 2, "hi": L - 1}[q_at]
    rows, sig = _x_rows(L)
    got = _x_step_pass_loop(rows, sig, L, q, initial_state,
                            _resident_split(L))
    want = rb.blocked_forward_batch_ref(rows, sig, THETA, L=L, q=q,
                                        initial_state=initial_state)
    assert got.shape == want.shape == (1, 2, T)
    assert not torch.equal(got[0, 0], got[0, 1])  # the rows differ
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=0)


@pytest.mark.parametrize("initial_state", ["vacuum", "neel"])
def test_resident_x_step_pass_order_matches_reference_interpret(
        initial_state):
    """The same loop against JAX's interpret K1 (``blocked_forward_batch``)
    on the same uniforms, L=17 (1e-4, ``test_torch_resident_blocked.py``'s
    bound)."""
    L, q, p = 17, 11, 0.3
    hs, phis = _disorder(L)
    keys = jax.random.split(jax.random.PRNGKey(3), 2)[None]
    ref = np.asarray(j_blocked_forward(
        jnp.asarray(hs), jnp.asarray(phis), j_sched("x", 0.97, T).angles,
        keys, L=L, T=T, p=p, q=q, initial_state=initial_state,
        ancilla_factor=1.0, interpret=True))
    rows, sig = _x_rows(L, uniforms=_uniforms(keys, (T, L)), p=p)
    got = _x_step_pass_loop(rows, sig, L, q, initial_state,
                            _resident_split(L)).numpy()
    assert got.shape == ref.shape == (1, 2, T)
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)


RAMP = np.linspace(0.86, 0.99, T)


def _ramp(time_dependent):
    """The (T, 1, 2) x schedule (a ramp whose every cycle differs, or the
    constant g = 0.97) and K3a's kick table from it, as the wrapper builds
    it (``ops/resident.py::kick_table``)."""
    g = torch.from_numpy(RAMP) if time_dependent else 0.97
    angles = build_kick_schedule("x", g, T).angles
    cs = rs.kick_table(angles, time_dependent, "cpu")
    assert cs.shape == ((T, 2) if time_dependent else (1, 2))
    assert len({tuple(r) for r in cs.tolist()}) == cs.shape[0]
    return angles, cs


@pytest.mark.parametrize("initial_state", ["vacuum", "neel"])
@pytest.mark.parametrize("time_dependent", [False, True])
@pytest.mark.parametrize("L", [14, 15])
def test_resident_x_ramp_step_pass_order_matches_plain(L, time_dependent,
                                                       initial_state):
    """K3a's pass order: K1's loop with the step's kick read from the table
    (cycle k its row k, every row different on the ramp), against
    ``resident_forward_batch_ref``; probes in pass lo's bits, at the split
    and in pass hi's."""
    rows, sig = _x_rows(L)
    angles, cs = _ramp(time_dependent)
    for q in (0, L // 2, L - 1):
        got = _x_step_pass_loop(rows, sig, L, q, initial_state,
                                _resident_split(L), cs)
        want = rs.resident_forward_batch_ref(
            rows, sig, angles, L=L, q=q, initial_state=initial_state,
            time_dependent=time_dependent)
        assert got.shape == want.shape == (1, 2, T)
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5,
                                   rtol=0)


@pytest.mark.parametrize("time_dependent", [False, True])
def test_resident_x_ramp_step_pass_order_matches_reference_interpret(
        time_dependent):
    """The same against JAX's interpret K3a (``resident_forward_batch``) at
    L=14 on the same uniforms and schedule (1e-4)."""
    L, q, p = 14, 7, 0.6
    hs, phis = _disorder(L)
    keys = jax.random.split(jax.random.PRNGKey(9), 2)[None]
    _, cs = _ramp(time_dependent)
    g = jnp.asarray(RAMP) if time_dependent else 0.97
    ref = np.asarray(j_resident_forward(
        jnp.asarray(hs), jnp.asarray(phis), j_sched("x", g, T).angles, keys,
        L=L, T=T, p=p, q=q, initial_state="neel", ancilla_factor=1.0,
        time_dependent=time_dependent, interpret=True))
    rows, sig = _x_rows(L, uniforms=_uniforms(keys, (T, L)), p=p)
    got = _x_step_pass_loop(rows, sig, L, q, "neel", _resident_split(L),
                            cs).numpy()
    assert got.shape == ref.shape == (1, 2, T)
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)
