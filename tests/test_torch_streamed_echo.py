"""The streamed echoes on folded diagonals (K6b/K7b, K10b) and the swizzle
of the echo passes (``csrc/floquet_echo.cuh``).

The streamed x echo (22 <= L <= 30, compact rows of 128 lanes to L = 25 and
256 from L = 26) and the streamed lab-frame echo (22 <= L <= 29, K4's
128-lane step rows) apply one folded diagonal per step, as K3b and K4's
echo do (``ops/echo_fold.py``). Here, on the CPU:

- the folded rows of both families' step rows at every L of their range:
  row 0 = pre(0), row k+1 = post(k) + pre(k+1) while k+1 < COUNT, COUNT
  read from its lane, and no flag lane (the x rows' trip count and kick
  sign, the lab-frame rows' MPOS, U and COUNT) read as data;
- a plain loop over the folded rows at L = 22 with mixed counts (0, 1, 2,
  4), one diagonal per step, against the plain versions
  ``streamed_echo_batch_ref`` and ``general_hi_echo_batch_ref`` (1e-5;
  ``test_torch_streamed.py`` and ``test_torch_general_hi.py`` hold those
  against JAX's interpret kernels at L = 22);
- the shared-memory swizzle, read from the header: every butterfly round
  of every tile of the resident plan (L = 14-23) and of the streamed plan
  (L = 22-30; strided tiles of 16 columns from L = 25) touches distinct
  8-byte slots of a 128-byte line within each half-warp, so no round has a
  bank conflict (the streamed forwards run the same tiles); the pass
  plans, tiles and rounds that the replay walks are held to the C they
  mirror, the x and lab-frame forwards' ``run_steps`` lines too, so that a
  change there fails the check;
- the lab-frame kick's flip word: a round of U's butterflies whose results
  are placed at j ^ flip is X U on the flipped bits, and the swizzle is
  linear over XOR, so the flipped stores land where they belong.

The kernels themselves are held against the plain versions on the card by
``test_torch_kernels_cuda.py::test_folded_echo_kernels_match_plain_on_card``.
"""

import os
import re

import numpy as np
import pytest
import torch

from dtc_tpu_torch.core.statevector import basis_index
from dtc_tpu_torch.io.disorder import generate_disorder
from dtc_tpu_torch.models.drives import build_kick_schedule
from dtc_tpu_torch.ops import cycle_hi_general as chg
from dtc_tpu_torch.ops import resident_blocked as rb
from dtc_tpu_torch.ops import resident_general as rg
from dtc_tpu_torch.ops import streamed as sm
from dtc_tpu_torch.ops.echo_fold import echo_plan, fold_rows
from dtc_tpu_torch.ops.kick import apply_uniform_1q_layer
from dtc_tpu_torch.ops.params import echo_pair_tiles, echo_width
from dtc_tpu_torch.ops.params_general import (
    LANE_COUNT,
    LANE_U8,
    flag_base,
    general_echo_rows,
)

torch.set_num_threads(2)

THETA = 0.97 * np.pi
CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "dtc_tpu_torch", "csrc")


def _disorder(L):
    hs, phis = generate_disorder(L, 1, seed=7)
    return torch.as_tensor(hs), torch.as_tensor(phis)


class Rows:
    """One family's echo step rows at L: pairs t in ts (one cut to a single
    step), their count lane, the coefficient formula and the flag lanes
    that must not be read as data."""

    def __init__(self, family, L, ts=(0, 1, 1, 2), T=2, p=0.6, seed=3):
        self.family, self.L = family, L
        hs, phis = _disorder(L)
        gen = torch.Generator().manual_seed(seed)
        ts = torch.tensor(ts)
        if family == "x":
            u = torch.rand((1, 2 * T, L), generator=gen)
            self.tiles, self.sfin = echo_pair_tiles(u, ts, hs, phis, L=L, T=T,
                                                    p=p)
            width = self.tiles.shape[-1]
            self.lane = width - 4
            self.flags = [width - 3]           # the kick sign
            self.coeffs = rb.row_coeffs
        else:
            angles = build_kick_schedule(family, 0.97, T).angles
            K = angles.shape[1]
            u = torch.rand((1, 2 * T * K, L), generator=gen)
            self.tiles = general_echo_rows(u, ts, hs, phis, angles, L=L, T=T,
                                           K=K, p=p)
            self.lane = flag_base(L) + LANE_COUNT
            self.flags = [flag_base(L) + LANE_U8 + i for i in range(8)]
            self.coeffs = rg.row_coeffs
        self.tiles[0, 1, 0, self.lane] = 1.0   # a pair of a single step
        self.flat = self.tiles.reshape(-1, *self.tiles.shape[-2:])
        self.count = self.flat[:, 0, self.lane].to(torch.int64)


def _coef(rows, L, coeffs):
    cz, cb, c0 = coeffs(rows.double(), L)
    return torch.cat([cz, cb, c0[..., None]], -1)


@pytest.mark.parametrize("family,L", [("x", L) for L in range(22, 31)]
                         + [("y", L) for L in range(22, 30)])
def test_fold_layout_on_streamed_rows(family, L):
    """The streamed echoes' folded rows: (n, S+1, 2L) f32, the count from
    its lane, the sums of the row coefficients, and the flag lanes above
    the data lanes."""
    r = Rows(family, L)
    n, R, width = r.flat.shape
    S = R // 2
    if family == "x":
        assert width == echo_width(L) == (128 if L <= 25 else 256)
        assert 5 * L - 2 <= width - 4            # data lanes below the flags
    else:
        assert width == 128 and 4 * L - 1 == flag_base(L)
        assert flag_base(L) + LANE_COUNT < width
    assert r.count.tolist() == [0, 1, 2, 4]
    fold, n_steps = echo_plan(r.flat, r.lane, L, r.coeffs, "step count")
    assert n_steps == 4 and fold.shape == (n, S + 1, 2 * L)
    assert fold.dtype == torch.float32
    pre = _coef(r.flat[:, 0:R:2], L, r.coeffs)
    post = _coef(r.flat[:, 1:R:2], L, r.coeffs)
    np.testing.assert_allclose(fold[:, 0].numpy(), pre[:, 0].numpy(),
                               atol=1e-6, rtol=0)
    for i in range(n):
        c = int(r.count[i])
        for k in range(S):
            want = post[i, k] + (pre[i, k + 1] if k + 1 < c else 0.0)
            np.testing.assert_allclose(fold[i, k + 1].numpy(), want.numpy(),
                                       atol=1e-5, rtol=0)
    # the flag lanes (all but COUNT) change nothing
    other = r.flat.clone()
    other[..., r.flags] += 0.25
    np.testing.assert_array_equal(
        fold_rows(other, r.count, L, r.coeffs).numpy(), fold.numpy())


def _phase(state, f, L):
    """exp(i theta(s)) psi(s) for one folded row f = (cz, cb, c0)."""
    return sm.phase_grid(state, sm.angle_grid(f[:L], f[L:2 * L - 1],
                                              f[2 * L - 1], L))


@pytest.mark.parametrize("family", ["x", "y"])
def test_folded_loop_matches_plain_at_l22(family):
    """One diagonal per step on the folded rows (the kernels' algebra) at
    L = 22 equals the plain versions' two diagonals per step, for counts
    0, 1, 2 and 4."""
    L, q = 22, 13
    r = Rows(family, L)
    fold, _ = echo_plan(r.flat, r.lane, L, r.coeffs, "step count")
    b0 = basis_index(L, "neel")
    rx = {s: sm._rx(THETA, s, "cpu") for s in (1.0, -1.0)}
    val = torch.empty(r.flat.shape[0])
    for i, count in enumerate(r.count.tolist()):
        state = rb.basis_states(1, L, b0, "cpu")[0]
        for k in range(count):
            pre = r.flat[i, 2 * k]
            if k == 0:
                state = _phase(state, fold[i, 0], L)
            if family == "x":
                state = apply_uniform_1q_layer(
                    state, rx[float(pre[r.flags[0]])], L)
            else:
                state = chg._kick_one(state, pre, L)
            state = _phase(state, fold[i, k + 1], L)
        val[i] = sm.measure_z(state, q, L)
    val = val.reshape(r.tiles.shape[:-2])
    if family == "x":
        got = rb.echo_host_factor(val, r.sfin, q, b0, 1.0)
        want = sm.streamed_echo_batch_ref(r.tiles, r.sfin, THETA, L=L, q=q,
                                          initial_state="neel")
    else:
        got = rb.basis_sign(b0, q) * val
        want = chg.general_hi_echo_batch_ref(r.tiles, L=L, q=q,
                                             initial_state="neel")
    assert want.shape == (1, 4)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=0)


# ---------------------------------------------------------------------------
# the swizzle of the echo passes' tiles


def _header(name) -> str:
    """A header of ``csrc`` with its whitespace runs made single spaces."""
    with open(os.path.join(CSRC, name)) as f:
        return " ".join(f.read().split())


# The C that the replay below mirrors, whitespace made single: the pass
# plans (``lo_bits`` for the resident forwards and echoes, ``plan_for`` for
# the streamed ones, and the columns each entry's ``run_echo``,
# ``run_steps`` or ``launch_steps`` takes: the streamed forwards and K10's
# shard-local forms run the echo's plan, K8c/K8d the resident split), the
# tile and bits
# each pass hands ``swz_kick`` (K5's passes, ``obs_lo``'s walk of tiles
# and ``obs_hi``, the same), and ``swz_kick``'s rounds. A change to any of
# it fails ``test_echo_swizzle_replay_mirrors_the_headers`` until the replay
# follows it.
MIRRORED = {
    "floquet_common.cuh": ["int lo_bits(int L) { return L - L / 2; }"],
    "floquet_plan.cuh": [
        "Plan plan_for(int L) { if (L <= 24) { const int c = (L - 2) / 2; "
        "return {L - c, 0, c}; } const int c = (L - 2) / 3; "
        "return {L - 2 * c, c, c}; }"],
    "floquet_x_resident.cu": [
        "run_echo<kW>( (float2*)state, L, lo_bits(L), 0,",
        "run_steps<kW>( (float2*)state, L, lo_bits(L), 0,"],
    "floquet_x.cu": ["run_echo<kW>( (float2*)state, L, lo_bits(L), 0,",
                     "run_steps<kW>( (float2*)state, L, lo_bits(L), 0,"],
    "floquet_general.cu": ["run_echo<kW>( (float2*)state, L, lo_bits(L), 0,",
                           "run_steps<kW>( (float2*)state, L, lo_bits(L), 0,"],
    "floquet_x_streamed.cu": [
        "const auto run = p.b > 0 ? run_echo<kWideCols, XEcho<WideRows, "
        "ConstKick>> : run_echo<kW, XEcho<WideRows, ConstKick>>;",
        "const auto run = p.b > 0 ? run_steps<kWideCols, "
        "XEcho<ForwardRows, ConstKick>, Times> : run_steps<kW, "
        "XEcho<ForwardRows, ConstKick>, Times>;",
        "(float2*)state, L, p.a, p.b,"],
    "floquet_general_streamed.cu": [
        "using Forward = GeneralEcho<ForwardRows<kRowWidth>>; "
        "using Echo = GeneralEcho<PairRows<kRowWidth>>;",
        "const auto run = p.b > 0 ? run_echo<kWideCols, Echo> : "
        "run_echo<kW, Echo>;",
        "const auto run = p.b > 0 ? run_steps<kWideCols, Forward, Times> : "
        "run_steps<kW, Forward, Times>;",
        "(float2*)state, L, p.a, p.b,",
        "if (p.b > 0) { return launch_steps<kWideCols, P, M>(st, L, p.a, "
        "p.b, rows,",
        "return launch_steps<kW, P, M>(st, L, p.a, p.b, rows,",
        "Plan resident_plan(int L) { return {lo_bits(L), 0, L - lo_bits(L)}; "
        "}",
        "plan_for(L), width, K, q,", "plan_for(L), width, K,",
        "resident_plan(L), kRowWidth, K, q,",
        "resident_plan(L), kRowWidth, K,"],
    "floquet_echo.cuh": [
        "const int k0 = a + b; const int c = L - k0;",
        "swz_kick(tile, k1, 0, k1, kick, in, out);",
        "swz_kick(tile, k1, 0, k1, k, in, out);",
        "swz_kick(tile, k1, 0, k1, k, in, out, meas);",
        "swz_kick( tile, b + kc, kc, b, kick.from(a),",
        "swz_kick(tile, n2 + kc, kc, n2, kick.from(k0), in, out);",
        "obs_hi(tile, n2 + kc, kc, n2,",
        "const int rounds = (n + 2) / 3; const int nb0 = n / rounds + "
        "(n % rounds > 0 ? 1 : 0); if (rounds == 1) { swz_round_n<true, "
        "true>(n, tile, tbits, b0, b0, kick, in, out, meas); return; } "
        "swz_round_n<true, false>(nb0, tile, tbits, b0, b0, kick, in, out, "
        "meas); int b = b0 + nb0; for (int i = 1; i < rounds - 1; ++i) { "
        "const int nb = n / rounds + (i < n % rounds ? 1 : 0); "
        "swz_round_n<false, false>(nb, tile, tbits, b, b0, kick, in, out, "
        "meas); b += nb; } swz_round_n<false, true>(b0 + n - b, tile, tbits, "
        "b, b0, kick, in, out, meas);",
        "const int flip = bf.flip << b; const int sflip = swz(flip);",
        "out(base, (j << b) ^ flip, v[j]);",
        "tile[sb ^ sflip ^ off[j]] = v[j];"],
    "floquet_rx.cuh": ["struct RxRound { static constexpr int flip = 0;"],
    "floquet_lab.cuh": [
        "return {u, (int)((m >> off) & ((1u << NB) - 1))};",
        "__ballot_sync(0xffffffffu, lane < L && row[L + lane] > 0.5f);"],
}


def _constant(name, header, kind="int") -> int:
    m = re.search(rf"constexpr {kind} {name} = (0x[0-9a-f]+|\d+)(ull)?;",
                  _header(header))
    assert m, f"{name} not found in {header}"
    return int(m.group(1), 0)


def _kswz() -> int:
    return _constant("kSwz", "floquet_echo.cuh", "uint64_t")


def _swz(x, k):
    """``swz``: the low 4 bits of x XORed with F(bits 4..7 of x), F the
    nibbles of k."""
    f = np.array([(k >> (4 * i)) & 15 for i in range(16)])
    return x ^ f[(x >> 4) & 15]


def _rounds(b0, n):
    """``swz_kick``'s rounds over tile bits [b0, b0 + n): (bit, bits, reads
    the tile, writes the tile)."""
    r = (n + 2) // 3
    if r == 1:
        return [(b0, n, False, False)]
    nb0 = n // r + (1 if n % r else 0)
    out, b = [(b0, nb0, False, True)], b0 + nb0
    for i in range(1, r - 1):
        nb = n // r + (1 if i < n % r else 0)
        out.append((b, nb, True, True))
        b += nb
    out.append((b, b0 + n - b, True, False))
    return out


def _plan(L, streamed):
    """Bits (a, b, c) of pass lo, mid and hi and the column bits of the
    strided tiles: the resident echoes' split (``lo_bits``, ``kW`` columns)
    or ``floquet_plan.cuh::plan_for`` (``kW`` columns at L <= 24,
    ``kWideCols`` on the three-pass plan)."""
    kw = _constant("kW", "floquet_common.cuh").bit_length() - 1
    wide = _constant("kWideCols", "floquet_echo.cuh").bit_length() - 1
    if not streamed:
        return L - L // 2, 0, L // 2, kw
    if L <= 24:
        c = (L - 2) // 2
        return L - c, 0, c, kw
    c = (L - 2) // 3
    return L - 2 * c, c, c, wide


def _tiles(L):
    """(tile bits, first kicked bit, kicked bits) of every pass at L."""
    out = []
    for streamed in [s for s in (False, True)
                     if (14 <= L <= 23, 22 <= L <= 30)[s]]:
        a, b, c, kc = _plan(L, streamed)
        out += [(a, 0, a), (c + kc, kc, c)] + ([(b + kc, kc, b)] if b else [])
    return out


def _conflicts(k, tbits, b0, n):
    """The rounds (bit, bits) of a tile in which some half-warp's accesses
    to the tile share an 8-byte slot of a 128-byte line."""
    bad = []
    for b, nb, reads, writes in _rounds(b0, n):
        if not (reads or writes):
            continue
        ntup = 1 << (tbits - nb)
        p = np.arange(ntup)
        base = ((p >> b) << (b + nb)) | (p & ((1 << b) - 1))
        for j in range(1 << nb):
            slot = _swz(base | (j << b), k) & 15
            if any(len(set(h)) < len(h) for h in slot.reshape(-1, 16)):
                bad.append((b, nb))
                break
    return bad


@pytest.mark.parametrize("L", range(14, 31))
def test_echo_swizzle_has_no_bank_conflicts(L):
    k = _kswz()
    tiles = _tiles(L)
    assert tiles
    for tbits, b0, n in tiles:
        assert _conflicts(k, tbits, b0, n) == [], (tbits, b0, n)
        # below 16 columns the plain layout does conflict: the check sees
        # bank conflicts (a half-warp of 16 columns reads one line anyway)
        assert bool(_conflicts(0, tbits, b0, n)) == (b0 < 4)


def test_echo_swizzle_is_linear_over_xor():
    """A round's flip word moves each result by XOR inside its tuple:
    swz_round stores amplitude j at swz(base) ^ swz(flip) ^ swz(j << b),
    which is the place of j ^ flip only because swz is linear over XOR;
    checked on every tile index of up to 13 bits and every bit."""
    k = _kswz()
    x = np.arange(1 << 13)
    assert _swz(0, k) == 0
    for i in range(13):
        assert np.array_equal(_swz(x ^ (1 << i), k),
                              _swz(x, k) ^ _swz(1 << i, k)), i


@pytest.mark.parametrize("nb", [1, 2, 3])
def test_flip_word_places_x_u_results(nb):
    """The lab-frame round (``floquet_lab.cuh::LabRound``): U's butterfly on
    every bit of the round, in ``swz_round``'s order, then each result j
    placed at j ^ flip, equals X U on the bits whose X-mask bit is set and U
    on the others, for every flip word."""
    rng = np.random.default_rng(nb)
    u = rng.normal(size=(2, 2)) + 1j * rng.normal(size=(2, 2))
    xu = u[::-1]
    v0 = rng.normal(size=1 << nb) + 1j * rng.normal(size=1 << nb)

    def butterflies(mats):
        v = v0.copy()
        for k in range(nb):
            for j in range(1 << nb):
                if not j & (1 << k):
                    a, b = v[j], v[j | (1 << k)]
                    m = mats[k]
                    v[j] = m[0, 0] * a + m[0, 1] * b
                    v[j | (1 << k)] = m[1, 0] * a + m[1, 1] * b
        return v

    for flip in range(1 << nb):
        placed = np.empty_like(v0)
        placed[np.arange(1 << nb) ^ flip] = butterflies([u] * nb)
        want = butterflies([xu if flip >> k & 1 else u for k in range(nb)])
        np.testing.assert_allclose(placed, want, rtol=0, atol=1e-12)


def test_echo_swizzle_replay_mirrors_the_headers():
    for header, snippets in MIRRORED.items():
        text = _header(header)
        for snippet in snippets:
            assert snippet in text, (header, snippet)
