"""The streamed lab-frame forward's diagonal rows (``ops/echo_fold.py``
``forward_fold``) and its pass order on the step passes of
``csrc/floquet_echo.cuh``.

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
The kernel itself is held against the plain version on the card by
``test_torch_kernels_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dtc_tpu.io.disorder import generate_disorder
from dtc_tpu.models.drives import build_kick_schedule as j_sched
from dtc_tpu.ops.pallas_resident_general import (
    general_forward_batch as j_forward,
)
from dtc_tpu_torch.core.statevector import basis_index
from dtc_tpu_torch.models.drives import build_kick_schedule
from dtc_tpu_torch.ops import cycle_hi_general as chg
from dtc_tpu_torch.ops import resident_blocked as rb
from dtc_tpu_torch.ops import resident_general as rg
from dtc_tpu_torch.ops.echo_fold import forward_fold
from dtc_tpu_torch.ops.params_general import (
    LANE_MPOS,
    LANE_U8,
    flag_base,
    general_forward_rows,
)

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


def _step_pass_loop(rows, L, q, initial_state, passes):
    """A(t) of the forward in the kernel's order: per step the kick on pass
    lo's, mid's and hi's bits, then fold row k + 1; the measure after it
    where the row names a time; A(0) the basis state's z_q; times the
    host's sign, as the wrappers."""
    flat = rows.reshape(-1, *rows.shape[-2:])
    n, S = flat.shape[:2]
    K = S // T
    a, b = _plan(L, passes)
    fold = forward_fold(flat, L, rg.row_coeffs)
    table = rb.angle_table(L, flat.device)
    b0 = basis_index(L, initial_state)
    state = rb.basis_states(n, L, b0, flat.device)
    a_raw = torch.zeros((n, T))
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
        got = _step_pass_loop(rows, L, q, initial_state, passes)
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
    got = _step_pass_loop(rows, L, q, "vacuum", 3).numpy()
    assert got.shape == ref.shape == (1, 2, T)
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)
