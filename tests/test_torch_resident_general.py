"""Lab-frame general-drive entries (kernel K4 and its plain versions).

On the CPU the entries run the plain versions, which are held against the
JAX Pallas kernels in interpret mode (K4a's full-plane body at L=14, K4b's
blocked body at L=18), fed the same uniforms: 1e-4, the reference's own
bound for its interpret kernels against the sigma engine. The kernel itself
is compared with these plain versions on the card by
``test_torch_kernels_cuda.py``.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dtc_tpu.io.disorder import generate_disorder
from dtc_tpu.models.drives import build_kick_schedule as j_sched
from dtc_tpu.ops.pallas_resident_general import general_echo_batch as j_echo
from dtc_tpu.ops.pallas_resident_general import (
    general_forward_batch as j_forward,
)
from dtc_tpu.ops.pallas_resident_general import slot_u8 as j_slot_u8
from dtc_tpu_torch.models.drives import build_kick_schedule
from dtc_tpu_torch.ops import resident_general as rg
from dtc_tpu_torch.ops.params_general import (
    KICK_KINDS,
    LANE_COUNT,
    LANE_MPOS,
    LANE_U8,
    flag_base,
    general_echo_rows,
    general_forward_rows,
    general_hi_width,
    kick_kind,
    slot_u8,
)
from dtc_tpu_torch.utils import profiling

torch.set_num_threads(2)


def _disorder(L):
    hs, phis = generate_disorder(L, 1, seed=7)
    return hs[:, :L], phis[:, :L - 1]


def _uniforms(keys, shape):
    return torch.from_numpy(np.array(jax.vmap(jax.vmap(
        lambda k: jax.random.uniform(k, shape, dtype=jnp.float32)))(keys)))


CASES = [(14, "y", "vacuum"), (14, "xy", "neel"), (14, "circular_left",
                                                    "vacuum"),
         (18, "y", "neel"), (18, "xy", "vacuum")]


@pytest.mark.parametrize("L,pol,state", CASES)
def test_plain_forward_matches_reference_interpret(L, pol, state):
    T, q, p = 3, L // 2, 0.1
    hs, phis = _disorder(L)
    sched = j_sched(pol, 0.97, T)
    K = sched.angles.shape[1]
    keys = jax.random.split(jax.random.PRNGKey(3), 2)[None]
    ref = np.asarray(j_forward(
        jnp.asarray(hs), jnp.asarray(phis), sched.angles, keys, L=L, T=T, K=K,
        p=p, q=q, initial_state=state, ancilla_factor=0.8, interpret=True))
    h, ph = torch.from_numpy(hs), torch.from_numpy(phis)
    rows = general_forward_rows(
        _uniforms(keys, (T * K, L)), h[:, None], ph[:, None],
        build_kick_schedule(pol, 0.97, T).angles, L=L, T=T, K=K, p=p)
    got = rg.general_forward_batch(rows, L=L, T=T, q=q, initial_state=state,
                                   ancilla_factor=0.8).numpy()
    assert got.shape == (1, 2, T)
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)


@pytest.mark.parametrize("L,pol,state", CASES)
def test_plain_echo_matches_reference_interpret(L, pol, state):
    T, q, ts = 2, L // 2, [1, 2]
    hs, phis = _disorder(L)
    sched = j_sched(pol, 0.97, T)
    K = sched.angles.shape[1]
    keys = jax.random.split(jax.random.PRNGKey(0), 2)[None]
    jargs = (jnp.asarray(hs), jnp.asarray(phis), sched.angles, keys,
             jnp.asarray(ts))
    u = _uniforms(keys, (2 * T * K, L))
    h, ph = torch.from_numpy(hs), torch.from_numpy(phis)
    angles = build_kick_schedule(pol, 0.97, T).angles
    for p in (0.6, 0.0):
        ref = np.asarray(j_echo(*jargs, L=L, T=T, K=K, p=p, q=q,
                                initial_state=state, interpret=True))
        tiles = general_echo_rows(u, torch.tensor(ts), h[:, None],
                                  ph[:, None], angles, L=L, T=T, K=K, p=p)
        got = rg.general_echo_batch(tiles, L=L, q=q,
                                    initial_state=state).numpy()
        assert got.shape == (1, 2, 2)
        np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)
        if p == 0:
            np.testing.assert_allclose(got, 1.0, atol=1e-4)


@pytest.mark.parametrize("inverse", [False, True])
def test_slot_u8_matches_reference(inverse):
    rng = np.random.default_rng(4)
    tx, ty = rng.uniform(-4, 4, (2, 64))
    ref = np.asarray(j_slot_u8(jnp.asarray(tx), jnp.asarray(ty),
                               inverse=inverse))
    got = slot_u8(torch.from_numpy(tx), torch.from_numpy(ty),
                  inverse=inverse).numpy()
    assert got.dtype == np.float32 and got.shape == (64, 8)
    np.testing.assert_allclose(got, ref, atol=1e-7, rtol=0)


def test_slot_u8_inverse_is_the_dagger():
    u = slot_u8(torch.tensor(0.7, dtype=torch.float64),
                torch.tensor(-1.3, dtype=torch.float64))
    ui = slot_u8(torch.tensor(0.7, dtype=torch.float64),
                 torch.tensor(-1.3, dtype=torch.float64), inverse=True)
    m = torch.complex(u[0::2], u[1::2]).reshape(2, 2)
    mi = torch.complex(ui[0::2], ui[1::2]).reshape(2, 2)
    torch.testing.assert_close(mi @ m, torch.eye(2, dtype=torch.complex64),
                               atol=1e-6, rtol=0)


def test_entries_reject_out_of_range():
    rows = torch.zeros((1, 3, 128))
    for L, q in ((13, 3), (24, 3), (14, 14), (14, -1)):
        with pytest.raises(ValueError):
            rg.general_forward_batch(rows, L=L, T=3, q=q)
    with pytest.raises(ValueError):
        rg.general_forward_batch(torch.zeros((1, rg.MAX_STEPS + 1, 128)),
                                 L=14, T=rg.MAX_STEPS + 1, q=3)
    with pytest.raises(ValueError):
        rg.general_echo_batch(torch.zeros((1, 2 * rg.MAX_STEPS + 2, 128)),
                              L=14, q=3)
    with pytest.raises(ValueError):  # neither CPU (plain) nor CUDA (kernel)
        rg.general_forward_batch(rows.to("meta"), L=14, T=3, q=3)
    with pytest.raises(ValueError):
        general_forward_rows(None, torch.zeros(1, 32), torch.zeros(1, 31),
                             torch.zeros(3, 1, 2), L=32, T=3, K=1, p=0.0,
                             batch=(1, 1))


def test_wrapper_routes_cpu_to_plain_version():
    L, T = 14, 2
    hs, phis = _disorder(L)
    rows = general_forward_rows(
        None, torch.from_numpy(hs)[:, None], torch.from_numpy(phis)[:, None],
        build_kick_schedule("y", 0.97, T).angles, L=L, T=T, K=1, p=0.0,
        batch=(1, 1))
    profiling.reset_counters()
    a = rg.general_forward_batch(rows, L=L, T=T, q=3)
    b = rg.general_forward_batch_ref(rows, L=L, T=T, q=3)
    assert torch.equal(a, b)
    assert not profiling.LAUNCHES
    assert not profiling.PLAIN_ON_CUDA


DRIVES = ["x", "y", "xy", "yx", "circular_left", "circular_right",
          "circular_static", "xy_cycle"]


def _u_lanes(rows, L):
    fo = flag_base(L)
    return rows[..., fo + LANE_U8:fo + LANE_U8 + 8]


def _binary_x_mask(rows, L):
    """The X-mask lanes [L, 2L) are exactly 0.0 or 1.0, and some are 1."""
    xm = rows[..., L:2 * L]
    assert bool(((xm == 0.0) | (xm == 1.0)).all())
    assert bool((xm == 1.0).any())


def _flags_beside_u_are_clear(rows, L, lanes):
    """No flag lane but ``lanes`` (offsets from FO) and U's is set."""
    fo = flag_base(L)
    keep = {LANE_U8 + i for i in range(8)} | set(lanes)
    rest = [fo + i for i in range(rows.shape[-1] - fo) if i not in keep]
    assert not rows[..., rest].any()


@pytest.mark.parametrize("pol", DRIVES)
@pytest.mark.parametrize("L", [14, 20, 30])
def test_rows_hold_one_u_and_a_binary_x_mask(L, pol):
    """What the kernels' kick reads of a step row (``LabKick``,
    ``csrc/floquet_lab.cuh``): L <= 32, so the X-mask lanes [L, 2L) pack into
    one 32-bit word, one lane of a warp each; every X-mask lane is exactly
    0.0 or 1.0; and the step's U sits once, in lanes FO+2..9 of its kick
    row: every forward row holds its slot's U, every echo pre row the U of
    its step (the slot's, or on an inverse step the dagger of the slot
    taken in reverse), every echo post row none."""
    assert L <= 32
    T, p = 4, 0.3
    width = general_hi_width(L)
    gen = torch.Generator().manual_seed(L)
    hs = torch.rand((1, L), generator=gen, dtype=torch.float64)
    phis = torch.rand((1, L - 1), generator=gen, dtype=torch.float64)
    angles = build_kick_schedule(pol, 0.97, T).angles
    K = angles.shape[1]
    u8 = slot_u8(angles[..., 0], angles[..., 1])                 # (T, K, 8)
    u8i = slot_u8(angles[..., 0], angles[..., 1], inverse=True)

    u = torch.rand((1, 3, 2 * T * K, L), generator=gen)
    rows = general_forward_rows(u[..., :T * K, :], hs[:, None],
                                phis[:, None], angles, L=L, T=T, K=K, p=p,
                                width=width)
    assert rows.shape == (1, 3, T * K, width)
    _binary_x_mask(rows, L)
    assert torch.equal(_u_lanes(rows, L),
                       u8.reshape(T * K, 8).expand(1, 3, T * K, 8))
    _flags_beside_u_are_clear(rows, L, [LANE_MPOS])

    ts = list(range(T + 1))
    tiles = general_echo_rows(u, torch.tensor(ts), hs[:, None], phis[:, None],
                              angles, L=L, T=T, K=K, p=p, width=width)
    assert tiles.shape == (1, 3, T + 1, 4 * T * K, width)
    _binary_x_mask(tiles, L)
    pre, post = tiles[..., 0::2, :], tiles[..., 1::2, :]
    assert not post[..., L:2 * L].any() and not _u_lanes(post, L).any()
    _flags_beside_u_are_clear(pre[..., 1:, :], L, [])
    _flags_beside_u_are_clear(pre[..., :1, :], L, [LANE_COUNT])
    for i, t in enumerate(ts):
        for k in range(2 * t):  # the steps a pair runs (COUNT = 2tK)
            want = u8[k] if k < t else u8i[2 * t - 1 - k].flip(0)
            got = _u_lanes(pre[..., i, k * K:(k + 1) * K, :], L)
            assert torch.equal(got, want.expand_as(got)), (t, k)


@pytest.mark.parametrize("g", [0.97, 1.0, 0.5, 0.0])
@pytest.mark.parametrize("pol", DRIVES)
def test_every_drive_slot_is_an_rx_or_an_ry(pol, g):
    """The kick kind the kernels choose from a step's U (``load_kick``,
    ``csrc/floquet_lab.cuh``; ``kick_kind`` on the host): every slot of
    every drive, forward and inverse, is a pure RX or RY with exact f32
    zeros, never general, at g = 1.0 too and where circular's sine is zero
    (t = 0): a slot with no y angle is an RX (the identity, both angles
    zero, among them), any other an RY."""
    angles = build_kick_schedule(pol, g, 50).angles
    want = torch.where(angles[..., 1] == 0, 0, 1)
    assert bool((angles[..., 0] == 0).logical_or(angles[..., 1] == 0).all())
    for inverse in (False, True):
        kinds = kick_kind(slot_u8(angles[..., 0], angles[..., 1],
                                  inverse=inverse))
        assert torch.equal(kinds, want), inverse


@pytest.mark.parametrize("u", ["both_angles", "near_rx_0", "near_rx_1",
                               "near_rx_2", "near_rx_3", "near_rx_4",
                               "near_rx_5", "near_rx_6", "near_rx_7",
                               "near_ry_1"])
def test_any_other_u_is_general(u):
    """A U with both angles non-zero (no zero entry), and an RX (or RY) off
    by one lane, take the general 2x2."""
    if u == "both_angles":
        u8 = slot_u8(torch.tensor(0.9), torch.tensor(0.6))
        assert bool((u8 != 0).all())
    else:
        rx = u.startswith("near_rx")
        u8 = slot_u8(torch.tensor(2.0 if rx else 0.0),
                     torch.tensor(0.0 if rx else 2.0))
        assert int(kick_kind(u8)) == (0 if rx else 1)
        u8[int(u[-1])] += 1e-3
    assert KICK_KINDS[int(kick_kind(u8))] == "general"


# The device rule that ``kick_kind`` states on the host (``load_kick``'s
# ``kick_kind``, ``csrc/floquet_lab.cuh``), whitespace made single.
LOAD_KICK_RULE = [
    "const bool diag = u.a00.x == u.a11.x;",
    "if (u.a01.x == 0.0f && u.a10.x == 0.0f && u.a00.y == 0.0f && "
    "u.a11.y == 0.0f && diag && u.a01.y == u.a10.y) { return kKickRx; }",
    "if (u.a00.y == 0.0f && u.a01.y == 0.0f && u.a10.y == 0.0f && "
    "u.a11.y == 0.0f && diag && u.a01.x == -u.a10.x) { return kKickRy; }",
    "return kKickGeneral;",
    "return {mat, m, kick_kind(mat)};"]


@pytest.mark.parametrize("snippet", LOAD_KICK_RULE)
def test_host_kind_rule_is_load_kicks(snippet):
    """The header still holds the rule ``kick_kind`` mirrors."""
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))), "dtc_tpu_torch", "csrc", "floquet_lab.cuh")
    with open(path) as f:
        assert snippet in " ".join(f.read().split())
