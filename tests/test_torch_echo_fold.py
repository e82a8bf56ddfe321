"""The echo kernels' folded diagonals (``ops/echo_fold.py``).

K2, K3b and K4's echo apply one diagonal per step: folded row 0 before step 0's
kick, folded row k+1 (post(k) + pre(k+1), post(COUNT-1) at the end) after
step k's kick. Here, on the CPU, a plain loop over the folded rows is held
against the unfolded plain step loop state by state (after step k the
folded state carries pre(k+1) already; 1e-5 on the f32 state: the folded
angles are the same sums, rounded once), against the
plain versions ``resident_echo_batch_ref`` / ``general_echo_batch_ref``
/ ``blocked_echo_batch_ref`` (1e-5) and against JAX's interpret kernels (1e-4, the bound of
``test_torch_resident.py``). The kernels themselves are held against the plain versions
on the card by ``test_torch_kernels_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dtc_tpu.io.disorder import generate_disorder
from dtc_tpu.models.drives import build_kick_schedule as j_sched
from dtc_tpu.ops.pallas_resident import resident_echo_batch as j_x_echo
from dtc_tpu.ops.pallas_resident_blocked import (
    blocked_echo_batch as j_blocked_echo,
)
from dtc_tpu.ops.pallas_resident_general import general_echo_batch as j_echo
from dtc_tpu_torch.core.statevector import basis_index
from dtc_tpu_torch.models.drives import build_kick_schedule
from dtc_tpu_torch.ops import resident as rs
from dtc_tpu_torch.ops import resident_blocked as rb
from dtc_tpu_torch.ops import resident_general as rg
from dtc_tpu_torch.ops.echo_fold import echo_plan, fold_rows
from dtc_tpu_torch.ops.params import WIDTH, echo_pair_tiles, kick_matrices
from dtc_tpu_torch.ops.params_general import (
    LANE_COUNT,
    flag_base,
    general_echo_rows,
)

torch.set_num_threads(2)

T = 3
DRIVES = ["x", "x_ramp", "y", "xy"]


def _disorder(L):
    hs, phis = generate_disorder(L, 1, seed=7)
    return torch.as_tensor(hs[:, :L]), torch.as_tensor(phis[:, :L - 1])


def _schedule(drive, T_):
    g = (torch.linspace(0.86, 0.99, T_, dtype=torch.float64)
         if drive == "x_ramp" else 0.97)
    return build_kick_schedule("y" if drive == "y" else
                               "xy" if drive == "xy" else "x", g, T_).angles


class Family:
    """A drive's step rows, count lane, coefficients and kick."""

    def __init__(self, drive, L, T_=T, p=0.6, seed=3):
        self.L, self.x = L, drive.startswith("x") and drive != "xy"
        self.td = drive == "x_ramp"
        self.angles = _schedule(drive, T_)
        hs, phis = _disorder(L)
        gen = torch.Generator().manual_seed(seed)
        ts = torch.tensor([0, 1, T_])        # counts 0, small, the largest
        if self.x:
            u = torch.rand((1, 2, 2 * T_, L), generator=gen)
            self.tiles, self.sfin = echo_pair_tiles(
                u, ts, hs[:, None], phis[:, None], L=L, T=T_, p=p)
            self.lane = WIDTH - 4
            u7r, u7i, utr, uti = kick_matrices(self.angles, L,
                                               time_dependent=self.td)
            self.u7, self.ut = torch.complex(u7r, u7i), torch.complex(utr,
                                                                      uti)
        else:
            K = self.angles.shape[1]
            u = torch.rand((1, 2, 2 * T_ * K, L), generator=gen)
            self.tiles = general_echo_rows(u, ts, hs[:, None], phis[:, None],
                                           self.angles, L=L, T=T_, K=K, p=p)
            self.lane = flag_base(L) + LANE_COUNT
        # one pair runs a single step: the kernels honour any count
        self.tiles[0, 1, 1, 0, self.lane] = 1.0
        self.flat = self.tiles.reshape(-1, *self.tiles.shape[-2:])
        self.count = self.flat[:, 0, self.lane].to(torch.int64)
        self.coeffs = rb.row_coeffs if self.x else rg.row_coeffs

    def kick(self, state, pre):
        if not self.x:
            return rg._kick(state, pre, self.L)
        out = torch.empty_like(state)
        for i in range(state.shape[0]):
            ui = int(pre[i, WIDTH - 1].clamp(0, self.u7.shape[0] - 1))
            a7, at = self.u7[ui], self.ut[ui]
            if pre[i, WIDTH - 3] < 0:
                a7, at = a7.conj(), at.conj()
            out[i] = rb._kick(state[i:i + 1], a7, at, self.L)[0]
        return out

    def angles_of(self, rows):
        cz, cb, c0 = self.coeffs(rows, self.L)
        return c0[:, None] + torch.cat([cz, cb], -1) @ rb.angle_table(
            self.L, rows.device)


def _phase(state, theta):
    return state * torch.polar(torch.ones_like(theta), theta)


def _folded_loop(fam, initial_state, each=None):
    """The echo on the folded rows, one diagonal per step (the kernels'
    algebra); ``each(k, state)`` after every step."""
    L, flat, count = fam.L, fam.flat, fam.count
    fold = fold_rows(flat, count, L, fam.coeffs)
    table = rb.angle_table(L, flat.device)
    state = rb.basis_states(flat.shape[0], L, basis_index(L, initial_state),
                            flat.device)
    for k in range(int(count.max())):
        idx = torch.nonzero(k < count)[:, 0]
        sub = state[idx]
        if k == 0:
            f = fold[idx, 0]
            sub = _phase(sub, f[:, -1:] + f[:, :-1] @ table)
        sub = fam.kick(sub, flat[idx, 2 * k])
        f = fold[idx, k + 1]
        state[idx] = _phase(sub, f[:, -1:] + f[:, :-1] @ table)
        if each:
            each(k, state)
    return state


def _unfolded_loop(fam, initial_state, each):
    L, flat, count = fam.L, fam.flat, fam.count
    state = rb.basis_states(flat.shape[0], L, basis_index(L, initial_state),
                            flat.device)
    for k in range(int(count.max())):
        idx = torch.nonzero(k < count)[:, 0]
        pre, post = flat[idx, 2 * k], flat[idx, 2 * k + 1]
        sub = fam.kick(_phase(state[idx], fam.angles_of(pre)), pre)
        state[idx] = _phase(sub, fam.angles_of(post))
        each(k, state)
    return state


def _measure(fam, state, q, initial_state):
    """The plain versions' value of a final state (host factor included)."""
    b0 = basis_index(fam.L, initial_state)
    val = (state.real ** 2 + state.imag ** 2) @ rb.angle_table(fam.L,
                                                               state.device)[q]
    shape = fam.tiles.shape[:-2]
    if fam.x:
        return rb.echo_host_factor(val.reshape(shape), fam.sfin, q, b0, 1.0)
    return rb.basis_sign(b0, q) * val.reshape(shape)


@pytest.mark.parametrize("initial_state", ["vacuum", "neel"])
@pytest.mark.parametrize("L", [14, 15])
@pytest.mark.parametrize("drive", DRIVES)
def test_folded_rows_give_the_unfolded_states(drive, L, initial_state):
    fam = Family(drive, L)
    assert sorted(set(fam.count.tolist()))[:2] == [0, 1]
    assert int(fam.count.max()) == fam.flat.shape[1] // 2
    unfolded = {}
    _unfolded_loop(fam, initial_state,
                   lambda k, s: unfolded.__setitem__(k, s.clone()))

    def held(k, state):
        # after step k the folded state already carries pre(k + 1)
        want = unfolded[k].clone()
        idx = torch.nonzero(k + 1 < fam.count)[:, 0]
        if idx.numel():
            want[idx] = _phase(want[idx],
                               fam.angles_of(fam.flat[idx, 2 * k + 2]))
        np.testing.assert_allclose(state.numpy(), want.numpy(), atol=1e-5,
                                   rtol=0)

    final = _folded_loop(fam, initial_state, held)
    ref = rs.resident_echo_batch_ref if fam.x else rg.general_echo_batch_ref
    for q in (0, L // 2, L - 1):
        kw = dict(L=L, q=q, initial_state=initial_state)
        if fam.x:
            want = ref(fam.tiles, fam.sfin, fam.angles, time_dependent=fam.td,
                       **kw)
        else:
            want = ref(fam.tiles, **kw)
        np.testing.assert_allclose(
            _measure(fam, final, q, initial_state).numpy(), want.numpy(),
            atol=1e-5, rtol=0)


def _coef(fam, rows):
    cz, cb, c0 = fam.coeffs(rows.double(), fam.L)
    return torch.cat([cz, cb, c0[..., None]], -1).float()


@pytest.mark.parametrize("L", [14, 15])
@pytest.mark.parametrize("drive", DRIVES)
def test_fold_rows_layout(drive, L):
    """Row 0 = pre(0); row k+1 = post(k) + pre(k+1) while k+1 < COUNT, else
    post(k) alone; (n, S+1, 2L) f32."""
    fam = Family(drive, L)
    fold = fold_rows(fam.flat, fam.count, L, fam.coeffs)
    n, S = fam.flat.shape[0], fam.flat.shape[1] // 2
    assert fold.shape == (n, S + 1, 2 * L)
    assert fold.dtype == torch.float32
    pre = _coef(fam, fam.flat[:, 0:2 * S:2])
    post = _coef(fam, fam.flat[:, 1:2 * S:2])
    np.testing.assert_allclose(fold[:, 0].numpy(), pre[:, 0].numpy(),
                               atol=1e-6, rtol=0)
    for i in range(n):
        c = int(fam.count[i])
        for k in range(S):
            want = post[i, k] + (pre[i, k + 1] if k + 1 < c else 0.0)
            np.testing.assert_allclose(fold[i, k + 1].numpy(), want.numpy(),
                                       atol=1e-5, rtol=0)


def _jax_inputs(L):
    hs, phis = generate_disorder(L, 1, seed=7)
    keys = jax.random.split(jax.random.PRNGKey(9), 2)[None]
    return hs[:, :L], phis[:, :L - 1], keys


def _uniforms(keys, shape):
    return torch.from_numpy(np.array(jax.vmap(jax.vmap(
        lambda k: jax.random.uniform(k, shape, dtype=jnp.float32)))(keys)))


@pytest.mark.parametrize("drive", ["x_ramp", "xy"])
def test_folded_loop_matches_reference_interpret(drive):
    L, q, ts = 14, 7, [1, 3]
    hs, phis, keys = _jax_inputs(L)
    fam = Family(drive, L)
    h, ph = torch.from_numpy(hs), torch.from_numpy(phis)
    if fam.x:
        ang = np.asarray(j_sched("x", jnp.asarray(np.linspace(0.86, 0.99, T)),
                                 T).angles)
        ref = np.asarray(j_x_echo(
            jnp.asarray(hs), jnp.asarray(phis), jnp.asarray(ang), keys,
            jnp.asarray(ts), L=L, T=T, p=0.6, q=q, time_dependent=True,
            interpret=True))
        fam.tiles, fam.sfin = echo_pair_tiles(
            _uniforms(keys, (2 * T, L)), torch.tensor(ts), h[:, None],
            ph[:, None], L=L, T=T, p=0.6)
    else:
        sched = j_sched("xy", 0.97, T)
        K = sched.angles.shape[1]
        ref = np.asarray(j_echo(
            jnp.asarray(hs), jnp.asarray(phis), sched.angles, keys,
            jnp.asarray(ts), L=L, T=T, K=K, p=0.6, q=q, interpret=True))
        fam.tiles = general_echo_rows(
            _uniforms(keys, (2 * T * K, L)), torch.tensor(ts), h[:, None],
            ph[:, None], fam.angles, L=L, T=T, K=K, p=0.6)
    fam.flat = fam.tiles.reshape(-1, *fam.tiles.shape[-2:])
    fam.count = fam.flat[:, 0, fam.lane].to(torch.int64)
    got = _measure(fam, _folded_loop(fam, "vacuum"), q, "vacuum").numpy()
    assert got.shape == ref.shape == (1, 2, 2)
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)


def test_folded_loop_on_k2_rows_matches_plain_and_reference_interpret():
    """K2 on the step passes: the folded loop on K2's rows (constant x,
    ``echo_pair_tiles``) at L=17, 2 pairs, T=3, against
    ``blocked_echo_batch_ref`` (1e-5) and JAX's interpret
    ``blocked_echo_batch`` (1e-4)."""
    L, q, ts = 17, 11, [2, T]
    hs, phis, _ = _jax_inputs(L)
    keys = jax.random.split(jax.random.PRNGKey(5), 1)[None]
    ref = np.asarray(j_blocked_echo(
        jnp.asarray(hs), jnp.asarray(phis), j_sched("x", 0.97, T).angles,
        keys, jnp.asarray(ts), L=L, T=T, p=0.6, q=q, interpret=True))
    fam = Family("x", L)
    fam.tiles, fam.sfin = echo_pair_tiles(
        _uniforms(keys, (2 * T, L)), torch.tensor(ts),
        torch.from_numpy(hs)[:, None], torch.from_numpy(phis)[:, None], L=L,
        T=T, p=0.6)
    fam.flat = fam.tiles.reshape(-1, *fam.tiles.shape[-2:])
    fam.count = fam.flat[:, 0, fam.lane].to(torch.int64)
    assert fam.count.tolist() == [4, 6]
    got = _measure(fam, _folded_loop(fam, "vacuum"), q, "vacuum").numpy()
    plain = rb.blocked_echo_batch_ref(fam.tiles, fam.sfin, 0.97 * np.pi,
                                      L=L, q=q).numpy()
    assert got.shape == ref.shape == (1, 1, 2)
    np.testing.assert_allclose(got, plain, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)


@pytest.mark.parametrize("drive", DRIVES)
def test_echo_plan_gives_the_kernels_inputs(drive):
    """The wrappers' one call before a launch: the folded rows and the
    largest count."""
    fam = Family(drive, 14)
    fold, n_steps = echo_plan(fam.flat, fam.lane, 14, fam.coeffs,
                              "step count")
    assert n_steps == int(fam.count.max()) == fam.flat.shape[1] // 2
    np.testing.assert_array_equal(
        fold.numpy(), fold_rows(fam.flat, fam.count, 14, fam.coeffs).numpy())


@pytest.mark.parametrize("drive", DRIVES)
def test_echo_plan_refuses_a_count_beyond_the_rows(drive):
    fam = Family(drive, 14)
    flat = fam.flat.clone()
    flat[0, 0, fam.lane] = flat.shape[1] // 2 + 1
    with pytest.raises(ValueError, match="count"):
        echo_plan(flat, fam.lane, 14, fam.coeffs, "step count")
