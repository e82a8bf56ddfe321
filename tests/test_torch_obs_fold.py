"""K5's measure order on the step passes of ``csrc/floquet_echo.cuh``.

``floquet_general_observables`` runs K4's forward steps on the resident
plan (pass lo on bits [0, a), a = lo_bits(L), pass hi on [a, L)): a step is
the kick, pass by pass in the rounds of ``swz_kick``, then row k + 1 of
``forward_fold``. A pass-lo block walks 2^tb consecutive tiles of its
trajectory (``ops/observables.py::walk_tiles``). A step that opens cycle t
measures the state it loads (``Obs``): pass lo's first round, on the
amplitudes it loads, takes every diagonal sum (``LoObs``): |psi|^2 signed
by the round's bits (by the tuple's index), |psi|^2 E_lo(s) from E's terms
on the tile's bits, and each tuple's sum times the tile's constants (the
z terms of its high bits and their bonds, and the bond (a-1, a) signed by
the tile), into the thread's probability (a base bit's z is that sum
signed by the bit: an xor butterfly over a warp's lanes, then the warps)
and signed by each bit of the tile's place in the walk; every round,
before its butterflies, sums the x pairs of its own bits. The butterflies
before that point act on other qubits, so what each round reads is the
cycle's. One fixed-order reduce a block gives lanes E, x, |psi|^2 and z_q,
q < a + tb; ``obs_reduce_kernel`` expands |psi|^2 into z_q above the walk.
The last cycle is measured only.

Here, on the CPU, a plain loop in that order, with the rounds read from
the header and the load round's sums taken thread by thread as the kernel
takes them, and the plain version ``observables_forward_batch_ref`` are
each held to the same loop run in complex128 on the same rows, within
float32's rounding over the steps (``f32_rounding.py``: from each step's
sum |c| and the observable's norm), at L = 14, 15 and 16 on their own
plans, at L = 15 on the round splits of every L of the range (16-23:
pass lo's split of lo_bits(L) bits and pass hi's of L - lo_bits(L)), and at
L = 15 and 16 with walks of 1, 2 and 8 tiles; two planted faults (a loop
that reads each round's qubits after their butterflies, and one that takes
the bond (a-1, a) with the sign of the walk's first tile) are off the
plain version by over 100 times that tolerance. The loop is also held
against JAX's interpret K5 at L = 17, the lowest L it takes (1e-4, the
bound of ``test_torch_forward_fold.py``).
For every L from 14 to 23 the replay checks that each qubit's x pair is read
exactly once and before its own butterfly, and that the load round's bits
lie below the energy tables' split. The C that the replay mirrors (the
split, the hook's place in ``swz_round``, the walk, the lanes and their
reduce, K5's plan) is held to the headers. Against JAX, e_diag, which
reaches sum|th| + sum|tph| (60-70 here), is held to the bound times that
scale over 10 (the f32 sums on either side round at ~1e-7 of it); z_q and
x_sum to the bound. The kernel itself is held against the plain version on
the card by
``test_torch_kernels_cuda.py::test_observables_kernel_matches_plain_on_card``
and ``::test_observables_walk_matches_plain_on_card``. ``walk_tiles`` is
held to its rule here.
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dtc_tpu.io.disorder import generate_disorder
from dtc_tpu.models import hamiltonian as j_ham
from dtc_tpu.models.drives import build_kick_schedule as j_sched
from dtc_tpu.ops.pallas_observables import (
    observables_forward_batch as j_obs,
)
from dtc_tpu_torch.core.statevector import basis_index
from dtc_tpu_torch.models import hamiltonian
from dtc_tpu_torch.models.drives import build_kick_schedule
from dtc_tpu_torch.ops import observables as obs
from dtc_tpu_torch.ops import resident_blocked as rb
from dtc_tpu_torch.ops import resident_general as rg
from dtc_tpu_torch.ops.echo_fold import forward_fold
from dtc_tpu_torch.ops.params_general import (
    LANE_U8,
    flag_base,
    general_forward_rows,
)

from f32_rounding import expectation_error

torch.set_num_threads(2)

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "dtc_tpu_torch", "csrc")
T = 3


def _header(name) -> str:
    """A header of ``csrc`` with its whitespace runs made single spaces."""
    with open(os.path.join(CSRC, name)) as f:
        return " ".join(f.read().split())


# The C the replay mirrors, whitespace made single: the measure hook of a
# round before its butterflies, pass lo's walk and its sums under Obs
# (LoObs, obs_lo: the load round's diagonal sums, the tiles' constants, the
# lanes and their order), pass hi's call of swz_kick under Obs, the
# reduce's lanes, and K5's plan (a = lo_bits(L), b = 0) with the steps of a
# chunk.
MIRRORED = {
    "floquet_echo.cuh": [
        "meas.template tuple<NB, kIn>(base, b, v); #pragma unroll for (int k "
        "= 0; k < NB; ++k) { #pragma unroll for (int j = 0; j < M; ++j) { if "
        "(!(j & (1 << k))) bf(k, v[j], v[j | (1 << k)]); } }",
        "const float pj = v[j].x * v[j].x + v[j].y * v[j].y; pt += pj; "
        "#pragma unroll for (int k = 0; k < NB; ++k) s[k] += (j & (1 << k)) "
        "? -pj : pj; et += pj * elo[(base | (j << b)) & ((1 << h) - 1)]; } "
        "e += et + pt * (ehi[base >> (h - 1)] + c0 + c1 * zsign(base, a - "
        "1)); p += pt; pit += zsign(base, itb) * pt;",
        "if (k < tb) zt[k] += (tile & (1 << k)) ? -pt : pt;",
        "if (with_x) x += x_pairs<NB>(v);",
        "ct[0][threadIdx.x] = angle_bits(coef, tph, hi, k1, L - k1); "
        "ct[1][threadIdx.x] = tph[k1 - 1] * zsign(hi, 0);",
        "table_angles(coef, tph, 0, k1, 0.0f, 0.0f, 0.0f,",
        "const int rounds = (k1 + 2) / 3; const int nb0 = k1 / rounds + (k1 "
        "% rounds > 0 ? 1 : 0); const int tbits = __ffs(blockDim.x) - 1; "
        "LoObs meas{elo, ehi, h, k1, nb0 + tbits, tb, with_x};",
        "g = sp + ((hi0 + i) << k1); meas.tile = i; meas.c0 = ct[0][i]; "
        "meas.c1 = ct[1][i]; swz_kick(tile, k1, 0, k1, k, in, out, meas);",
        "w = (lane & o) ? y - w : w + y;",
        "red[0][warp] = sums[0]; red[1][warp] = sums[1]; red[2][warp] = w; "
        "for (int k = 0; k < nb0; ++k) red[3 + k][warp] = s[k]; for (int u "
        "= 5; u < tbits && u < nbase; ++u) { red[3 + nb0 + u][warp] = "
        "zsign(warp, u - 5) * w; } if (tbits < nbase) red[3 + nb0 + "
        "tbits][warp] = sums[2]; for (int k = 0; k < tb; ++k) red[3 + k1 + "
        "k][warp] = zt[k]; } else if ((lane & (lane - 1)) == 0 && "
        "__ffs(lane) - 1 < nbase) { red[3 + nb0 + __ffs(lane) - 1][warp] = "
        "w; }",
        "for (int j = threadIdx.x; j < 3 + k1 + tb; j += blockDim.x) {",
        "(int64_t)blockIdx.x << m.tb, m.tb,",
        "obs_hi(tile, n2 + kc, kc, n2,",
        "swz_round_n<true, false>(nb0, tile, tbits, b0, b0, kick, in, out, "
        "meas);",
        "return t < 32 ? 32 : (t > kThreads ? kThreads : t);"],
    "floquet_common.cuh": ["int lo_bits(int L) { return L - L / 2; }",
                           "constexpr int kThreads = 256;"],
    "floquet_general.cu": [
        "const int a = lo_bits(L);",
        "const int last = (T - 1) * K;",
        "const int to = (t0 + c) * K < last + 1 ? (t0 + c) * K : last + 1; "
        "e = launch_steps<kW>( st, L, a, 0, (const float*)rows, "
        "rows_per_traj, f, n_traj, t0 * K, to, policy,",
        "return step % K == 0 ? step / K : -1;",
        "const bool high = j > 1 && q >= a + tb; // one sign a block const "
        "float* lo = s + (j == 0 ? 0 : high ? 2 : 3 + q) * nb; for (int b = "
        "lane; b < nb; b += 32) { acc += (high ? zsign(b, q - a - tb) : "
        "1.0f) * lo[b]; }"],
}


def _split_exprs():
    """swz_kick's round counts, read from the header as Python expressions
    of n (bits), rounds and i (the round): rounds, the first round's bits
    and a middle round's."""
    m = re.search(r"const int rounds = (.+?); const int nb0 = (.+?); .*?"
                  r"const int nb = (.+?); swz_round_n<false, false>",
                  _header("floquet_echo.cuh"))
    assert m, "swz_kick's split not found in floquet_echo.cuh"

    def py(e):
        e = re.sub(r"\((.+?) \? (.+?) : (.+?)\)", r"((\2) if (\1) else (\3))",
                   e)
        return compile(e.replace("/", "//"), "floquet_echo.cuh", "eval")

    return tuple(py(e) for e in m.groups())


ROUNDS, NB0, NB = _split_exprs()


def _rounds(n):
    """The rounds of swz_kick over n bits as (first bit, bits), from the
    header's expressions: the first, the middle ones, the last on the top
    bits."""
    r = eval(ROUNDS, {"n": n})
    if r == 1:
        return [(0, n)]
    nb0 = eval(NB0, {"n": n, "rounds": r})
    out, b = [(0, nb0)], nb0
    for i in range(1, r - 1):
        nb = eval(NB, {"n": n, "rounds": r, "i": i})
        out.append((b, nb))
        b += nb
    out.append((b, n - b))
    return out


def _lo_bits(L):
    return L - L // 2


def _kick_bits(state, row, L, qubits):
    """The step's 2x2 (U, rows swapped where the X-mask bit is 1) on the
    given qubits of the (n, 2^L) states, one qubit at a time."""
    u8 = row[:, flag_base(L) + LANE_U8:flag_base(L) + LANE_U8 + 8]
    u = torch.complex(u8[:, 0::2], u8[:, 1::2]).reshape(-1, 2, 2)
    n = state.shape[0]
    for j in qubits:
        m = torch.where(row[:, L + j, None, None] > 0.5, u.flip(-2), u)
        s = state.reshape(n, 1 << (L - j - 1), 2, 1 << j)
        state = torch.einsum("nab,nhbl->nhal", m.to(state.dtype), s)
    return state.reshape(n, 1 << L)


def _x_pairs(state, q):
    """sum over s with bit q = 0 of Re conj(psi_s) psi_{s + 2^q}, per
    state."""
    s = state.reshape(state.shape[0], -1, 2, 1 << q)
    return (s[:, :, 0].conj() * s[:, :, 1]).real.sum((1, 2))


def _measured_step(L, a):
    """The events of a measuring step in the kernel's order: ("load", -1),
    pass lo's diagonal sums in its load round, before any butterfly; then
    per pass (bits [0, a), then [a, L)), per round, ("read", q) for each of
    its qubits (its x pairs) before ("kick", q) for each."""
    events = [("load", -1)]
    for lo, hi in ((0, a), (a, L)):
        for b, nb in _rounds(hi - lo):
            qs = range(lo + b, lo + b + nb)
            events += [("read", q) for q in qs] + [("kick", q) for q in qs]
    return events


def _read_after_kick(L, a):
    """A wrong pass order, a planted fault: each round reads its qubits
    after their butterflies, the load round its diagonal sums too."""
    events = [(what, q) for lo, hi in ((0, a), (a, L))
              for b, nb in _rounds(hi - lo) for what in ("kick", "read")
              for q in range(lo + b, lo + b + nb)]
    first = _rounds(a)[0][1]
    return events[:first] + [("load", -1)] + events[first:]


def _threads(a):
    """``echo_threads(a)``: one thread a tuple of 8, 32 to kThreads (the
    header's expression, held by the MIRRORED snippets)."""
    return min(max(1 << (a - 3), 32), 256)


def _zsigns(x, bits):
    """(len(x), bits) z_k(x) = 1 - 2 bit_k(x)."""
    x = torch.as_tensor(x, dtype=torch.int64)
    return (1 - 2 * ((x[:, None] >> torch.arange(bits)) & 1)).to(
        torch.float64)


def _own_tile(hi, tb):
    return hi


def _first_tile(hi, tb):
    """A planted fault: the bond (a-1, a) with the sign of the walk's first
    tile."""
    return hi >> tb << tb


def _lo_lanes(prob, coef, L, a, tb, bond_tile=_own_tile):
    """Pass lo's lanes under Obs, as the kernel sums them: (n, blocks,
    3 + a + tb), lane 1 (x) left 0. A block walks 2^tb tiles; thread tid
    holds tuples tid + i * threads of the load round (tile bits [0, nb0) by
    j, the base bits by the tuple, the high bits by the tile) and sums, in
    registers across the walk: s[k] (z_k, k < nb0), e (E_lo of the
    amplitude plus the tile's constants times the tuple's sum), p, pit (p
    signed by base bit itb) and zt[k] (p signed by bit k of the tile's
    place); then each warp: an xor butterfly of p (lane 2^u: p signed by
    lane bit u) and a sum of each other register; then the warps, a warp
    bit's z the warp's p signed by it."""
    real = prob.dtype
    n = prob.shape[0]
    nb0 = _rounds(a)[0][1]
    threads = _threads(a)
    tbits = threads.bit_length() - 1
    ntup, W = 1 << (a - nb0), 1 << tb
    blocks = (1 << (L - a)) >> tb
    pj = prob.reshape(n, blocks, W, ntup, 1 << nb0).to(torch.float64)
    th, tph = coef[:, :L].double(), coef[:, L:2 * L - 1].double()
    # E's terms on the tile's bits, of each tile index
    za = _zsigns(torch.arange(1 << a), a)
    e_lo = th[:, :a] @ za.T + tph[:, :a - 1] @ (za[:, :-1] * za[:, 1:]).T
    # each tile's constants: its high bits' z terms and bonds, and the bond
    # (a-1, a) signed by the tile
    hi = torch.arange(1 << (L - a))
    zh = _zsigns(hi, L - a)
    c0 = th[:, a:] @ zh.T + tph[:, a:] @ (zh[:, :-1] * zh[:, 1:]).T
    c1 = tph[:, a - 1:a] * _zsigns(bond_tile(hi, tb), 1)[:, 0]
    base = torch.arange(ntup) << nb0
    zbase = _zsigns(base, a)[:, a - 1]
    const = (c0[:, :, None] + c1[:, :, None] * zbase).reshape(
        n, blocks, W, ntup)
    pt = pj.sum(-1)
    et = (pj * e_lo.reshape(n, 1, 1, ntup, 1 << nb0)).sum(-1) + pt * const
    zj = _zsigns(torch.arange(1 << nb0), nb0)  # (2^nb0, nb0)
    sk = torch.einsum("nbwtj,jk->nbtk", pj, zj)
    zw = _zsigns(torch.arange(W), tb)  # (W, tb)
    zt = torch.einsum("nbwt,wk->nbtk", pt, zw)
    pit = pt.sum(2) * _zsigns(base, a + 1)[:, min(nb0 + tbits, a)]
    regs = [et.sum(2), pt.sum(2), pit, *sk.unbind(-1), *zt.unbind(-1)]

    def per_thread(r):  # (n, blocks, ntup) -> (n, blocks, warps, 32)
        t = torch.zeros((n, blocks, max(threads, ntup)), dtype=r.dtype)
        t[..., :ntup] = r
        t = t.reshape(n, blocks, -1, threads).sum(2)
        return t.reshape(n, blocks, threads // 32, 32)

    e, p, pit, *rest = [per_thread(r) for r in regs]
    w = p.clone()
    lane = torch.arange(32)
    for o in (1, 2, 4, 8, 16):
        y = w[..., lane ^ o]
        w = torch.where((lane & o) > 0, y - w, w + y)
    red = torch.zeros((n, blocks, threads // 32, 3 + a + tb),
                      dtype=torch.float64)
    red[..., 0] = e.sum(-1)
    red[..., 2] = w[..., 0]
    for k in range(nb0):
        red[..., 3 + k] = rest[k].sum(-1)
    zwarp = _zsigns(torch.arange(threads // 32), max(tbits - 5, 1))
    for u in range(a - nb0):
        if u < min(5, tbits):
            red[..., 3 + nb0 + u] = w[..., 1 << u]
        elif u < tbits:
            red[..., 3 + nb0 + u] = zwarp[:, u - 5] * w[..., 0]
        else:
            red[..., 3 + nb0 + u] = pit.sum(-1)
    for k in range(tb):
        red[..., 3 + a + k] = rest[nb0 + k].sum(-1)
    return red.sum(2).to(real)


def _obs_reduce(lanes, L, a, tb):
    """``obs_reduce_kernel`` on pass lo's lanes (n, blocks, 3 + a + tb):
    e_diag and z_0 .. z_{L-1}, in double, then as the lanes' dtype."""
    lanes = lanes.double()
    blocks = lanes.shape[1]
    zb = _zsigns(torch.arange(blocks), max(L - a - tb, 1))
    zs = [lanes[:, :, 3 + q].sum(1) if q < a + tb
          else (zb[:, q - a - tb] * lanes[:, :, 2]).sum(1)
          for q in range(L)]
    return lanes[:, :, 0].sum(1).to(lanes.dtype), torch.stack(zs, -1)


def _obs_pass_loop(rows, erow, L, a, initial_state, with_x,
                   order=_measured_step, dtype=torch.complex64, tb=0,
                   bond_tile=_own_tile):
    """(e_diag, x_sum, zs) of K5 in the kernel's order on the plan a, pass
    lo's blocks each walking 2^tb tiles: each step kicks pass lo's and pass
    hi's rounds (``order``), then fold row k + 1; a step that opens a cycle
    takes pass lo's lanes at its load (``_lo_lanes``, reduced by
    ``_obs_reduce``) and every round's x pairs at its "read"; the last
    cycle's first step is measured only. In ``dtype`` (complex64, or
    complex128 on the same rows)."""
    real = torch.float64 if dtype == torch.complex128 else torch.float32
    flat = rows.reshape(-1, *rows.shape[-2:])
    n, S = flat.shape[:2]
    K = S // T
    fold = forward_fold(flat, L, rg.row_coeffs, dtype=real)
    table = rb.angle_table(L, flat.device).to(real)
    coef = erow.to(real).expand(*rows.shape[:-2], erow.shape[-1])
    coef = coef.reshape(n, -1)
    state = rb.basis_states(n, L, basis_index(L, initial_state),
                            flat.device).to(dtype)
    out = torch.zeros((n, T, 2 + L), dtype=real)
    for step in range((T - 1) * K + 1):
        t, k = divmod(step, K)
        row = flat[:, step]
        for what, q in order(L, a):
            if what == "kick":
                state = _kick_bits(state, row, L, [q])
            elif k > 0:
                continue
            elif what == "load":  # pass lo's diagonal sums
                prob = state.real ** 2 + state.imag ** 2
                lanes = _lo_lanes(prob, coef, L, a, tb, bond_tile)
                e_diag, zs = _obs_reduce(lanes, L, a, tb)
                out[:, t, 0], out[:, t, 2:] = e_diag, zs.to(real)
            elif with_x:
                out[:, t, 1] += 2 * _x_pairs(state, q)
        if step == (T - 1) * K:
            break  # measured only
        f = fold[:, step + 1]
        theta = f[:, -1:] + f[:, :-1] @ table
        state = state * torch.polar(torch.ones_like(theta), theta)
    out = out.reshape(*rows.shape[:-2], T, 2 + L)
    return out[..., 0], out[..., 1], out[..., 2:]


def _inputs(L, drive, component, uniforms=None, n=2, p=0.3, seed=11):
    """(1, n, T*K, 128) rows of n trajectories of different uniforms (a
    numpy seed unless given), (1, 1, 128) energy rows and with_x."""
    hs, phis = generate_disorder(L, 1, seed=7)
    hs = torch.from_numpy(hs[:, :L])
    phis = torch.from_numpy(phis[:, :L - 1])
    angles = build_kick_schedule(drive, 0.97, T, xy_cycle_period=1).angles
    K = angles.shape[1]
    if uniforms is None:
        rng = np.random.default_rng(seed)
        uniforms = torch.from_numpy(
            rng.random((1, n, T * K, L), dtype=np.float32))
    rows = general_forward_rows(uniforms, hs[:, None], phis[:, None],
                                angles, L=L, T=T, K=K, p=p)
    terms = hamiltonian.hamiltonian_terms(L, 0.97, hs[0], phis[0], component)
    erow = obs.energy_row(terms.hs, terms.phis, L)[None, None]
    return rows, erow, terms.x_coeff != 0.0


def _f32_bounds(rows, erow, L):
    """The float32 tolerances of e_diag, x_sum and zs against complex128
    (``f32_rounding.py``): the steps' sum |c| from their folded rows (the
    largest over the trajectories), and |O| the largest |E(s)|, L (a sum of
    L X_q) and 1."""
    flat = rows.reshape(-1, *rows.shape[-2:])
    steps = (T - 1) * (flat.shape[1] // T)
    fold = forward_fold(flat, L, rg.row_coeffs, dtype=torch.float64)
    thetas = fold[:, 1:steps + 1].abs().sum(-1).amax(0).tolist()
    table = rb.angle_table(L, flat.device).double()
    coef = erow.double().reshape(-1, erow.shape[-1])
    e_norm = float((coef[:, :L] @ table[:L]
                    + coef[:, L:2 * L - 1] @ table[L:]).abs().max())
    return [expectation_error(thetas, L, norm) for norm in (e_norm, L, 1)]


def _held_f32(sides, ref, bounds):
    """Each float32 side within its tolerances of the complex128 run."""
    for side in sides:
        for name, a, b, t in zip(("e_diag", "x_sum", "zs"), side, ref,
                                 bounds):
            assert a.shape == b.shape, name
            np.testing.assert_allclose(a.double().numpy(), b.numpy(),
                                       atol=t, rtol=0, err_msg=name)


def _held(got, want, tol, erow, L):
    scale = float(erow[..., :2 * L - 1].abs().sum())
    for name, a, b, t in zip(("e_diag", "x_sum", "zs"), got, want,
                             (tol * scale / 10, tol, tol)):
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=t, rtol=0,
                                   err_msg=name)


def test_round_split_mirrors_the_headers():
    for header, snippets in MIRRORED.items():
        text = _header(header)
        for snippet in snippets:
            assert snippet in text, (header, snippet)


@pytest.mark.parametrize("L", range(14, 24))
def test_round_split_reads_each_x_pair_once_before_its_butterfly(L):
    a = _lo_bits(L)
    for n in (a, L - a):
        split = _rounds(n)
        assert all(1 <= nb <= 3 for _, nb in split), split
        assert [b for b, _ in split] == list(
            np.cumsum([0] + [nb for _, nb in split[:-1]])), split
        assert sum(nb for _, nb in split) == n, split
    events = _measured_step(L, a)
    assert events[0] == ("load", -1)
    reads = [q for what, q in events if what == "read"]
    kicks = [q for what, q in events if what == "kick"]
    assert sorted(reads) == sorted(kicks) == list(range(L))
    for q in range(L):
        assert events.index(("read", q)) < events.index(("kick", q)), q


CASES = [(drive, comp, state) for drive in ("x", "xy", "xy_cycle")
         for comp, state in (("full", "vacuum"), ("z_zz", "neel"))]


@pytest.mark.parametrize("drive,component,initial_state", CASES)
@pytest.mark.parametrize("L", [14, 15, 16])
def test_obs_pass_order_matches_plain(L, drive, component, initial_state):
    rows, erow, with_x = _inputs(L, drive, component)
    assert with_x == (component == "full")
    got = _obs_pass_loop(rows, erow, L, _lo_bits(L), initial_state, with_x)
    want = obs.observables_forward_batch_ref(
        rows, erow, L=L, T=T, initial_state=initial_state, with_x=with_x)
    ref = _obs_pass_loop(rows, erow, L, _lo_bits(L), initial_state, with_x,
                         dtype=torch.complex128)
    assert want[2].shape == (1, 2, T, L)
    _held_f32((got, want), ref, _f32_bounds(rows, erow, L))
    assert not torch.equal(got[2][0, 0], got[2][0, 1])  # the rows differ
    if not with_x:
        assert not got[1].any()


@pytest.mark.parametrize("pass_", ["lo", "hi"])
@pytest.mark.parametrize("Lp", range(16, 24))
def test_obs_pass_order_on_the_round_splits_of_the_range(Lp, pass_):
    """At L=15, pass lo on lo_bits(Lp) bits or pass hi on Lp - lo_bits(Lp)
    bits: the rounds of the plan at Lp."""
    L = 15
    a = _lo_bits(Lp) if pass_ == "lo" else L - (Lp - _lo_bits(Lp))
    rows, erow, with_x = _inputs(L, "xy", "full", seed=Lp)
    got = _obs_pass_loop(rows, erow, L, a, "neel", with_x)
    want = obs.observables_forward_batch_ref(rows, erow, L=L, T=T,
                                             initial_state="neel")
    ref = _obs_pass_loop(rows, erow, L, a, "neel", with_x,
                         dtype=torch.complex128)
    _held_f32((got, want), ref, _f32_bounds(rows, erow, L))


@pytest.mark.parametrize("pass_", ["lo", "hi"])
def test_obs_pass_order_fault_fails_by_orders_of_magnitude(pass_):
    """A planted fault, reads after their round's butterflies (the load
    round's diagonal sums too), on the plan of L=15 or a round split of
    L=23: the plain version is off the faulty loop by over 100 times the
    float32 tolerance."""
    L = 15
    a = _lo_bits(L) if pass_ == "lo" else L - (23 - _lo_bits(23))
    rows, erow, with_x = _inputs(L, "xy", "full")
    bad = _obs_pass_loop(rows, erow, L, a, "vacuum", with_x,
                         order=_read_after_kick, dtype=torch.complex128)
    want = obs.observables_forward_batch_ref(rows, erow, L=L, T=T)
    worst = max(float((w.double() - b).abs().max()) / t for w, b, t in
                zip(want, bad, _f32_bounds(rows, erow, L)))
    assert worst > 100, worst


@pytest.mark.parametrize("a", range(7, 13))
def test_load_round_lies_below_the_energy_tables_split(a):
    """Pass lo's tile bits a = lo_bits(L), 14 <= L <= 23: the load round's
    bits [0, nb0) lie below the upper energy table's first bit h - 1 (so
    that a tuple's ehi entry is its base's alone), and a thread holds at
    most two tuples of it (one iteration bit, ``pit``)."""
    nb0 = _rounds(a)[0][1]
    assert _rounds(a)[0][0] == 0
    assert nb0 <= (a + 1) // 2 - 1, (a, nb0)
    assert a - nb0 <= _threads(a).bit_length() - 1 + 1, a


WALKS = [(L, tb, drive) for L in (15, 16) for tb, drive in
         ((0, "x"), (1, "xy"), (3, "xy_cycle"))]


@pytest.mark.parametrize("L,tb,drive", WALKS)
def test_obs_walk_matches_plain(L, tb, drive):
    """Pass-lo blocks that walk 1, 2 and 8 tiles at L = 15 and 16: the
    replay of the walk's lanes (the tiles' constants, the walk's z lanes,
    the blocks' probability for the bits above it) and the plain version,
    each within float32's tolerance of the replay in complex128."""
    rows, erow, with_x = _inputs(L, drive, "full", seed=L + tb)
    a = _lo_bits(L)
    got = _obs_pass_loop(rows, erow, L, a, "neel", with_x, tb=tb)
    want = obs.observables_forward_batch_ref(rows, erow, L=L, T=T,
                                             initial_state="neel")
    ref = _obs_pass_loop(rows, erow, L, a, "neel", with_x,
                         dtype=torch.complex128, tb=tb)
    _held_f32((got, want), ref, _f32_bounds(rows, erow, L))


@pytest.mark.parametrize("L", [15, 16])
def test_obs_walk_bond_fault_fails_by_orders_of_magnitude(L):
    """A planted fault: the bond (a-1, a) taken with the sign of the walk's
    first tile, in walks of 2 tiles, on the x drive at p = 0.05 from the
    vacuum (a cycle flips nearly every spin, so the state visits odd
    tiles). The plain version is off the faulty loop by over 100 times the
    float32 tolerance."""
    rows, erow, with_x = _inputs(L, "x", "full", p=0.05)
    bad = _obs_pass_loop(rows, erow, L, _lo_bits(L), "vacuum", with_x,
                         dtype=torch.complex128, tb=1,
                         bond_tile=_first_tile)
    want = obs.observables_forward_batch_ref(rows, erow, L=L, T=T)
    worst = max(float((w.double() - b).abs().max()) / t for w, b, t in
                zip(want, bad, _f32_bounds(rows, erow, L)))
    assert worst > 100, worst


@pytest.mark.parametrize("L", range(14, 24))
def test_walk_tiles_rule(L):
    """``walk_tiles``: a power of two, at most ``MAX_WALK`` and a
    trajectory's tiles, whose blocks keep ``MIN_WALK_THREADS`` threads or
    more (the wave the rule promises), the largest such; one tile for one
    trajectory where its tiles hold at most that many threads (L <= 20:
    the energy study's trajectory at p = 0); ``lo_threads`` is the header's
    ``echo_threads`` of pass lo's tile."""
    tiles = 1 << (L - _lo_bits(L))
    assert obs.lo_threads(L) == _threads(_lo_bits(L))
    if tiles * obs.lo_threads(L) <= obs.MIN_WALK_THREADS:
        assert L <= 20 and obs.walk_tiles(L, 1) == 1
    for n_traj in (1, 2, 3, 16, 32, 100, 256, 1024):
        n = obs.walk_tiles(L, n_traj)
        threads = n_traj * obs.lo_threads(L)
        assert n & (n - 1) == 0 and 1 <= n <= min(obs.MAX_WALK, tiles)
        if n > 1:
            assert tiles // n * threads >= obs.MIN_WALK_THREADS
        if 2 * n <= min(obs.MAX_WALK, tiles):
            assert tiles // (2 * n) * threads < obs.MIN_WALK_THREADS
    assert obs.walk_tiles(L, 1 << 20) == min(obs.MAX_WALK, tiles)


def _j_uniforms(keys, shape):
    return torch.from_numpy(np.array(jax.vmap(jax.vmap(
        lambda k: jax.random.uniform(k, shape, dtype=jnp.float32)))(keys)))


@pytest.mark.parametrize("drive,component", [("y", "full"), ("xy", "z_zz")])
def test_obs_pass_order_matches_reference_interpret(drive, component):
    L, p = 17, 0.3
    hs, phis = generate_disorder(L, 1, seed=7)
    hs, phis = hs[:, :L], phis[:, :L - 1]
    terms = j_ham.hamiltonian_terms(L, 0.97, hs[0], phis[0], component)
    sched = j_sched(drive, 0.97, T)
    K = sched.angles.shape[1]
    with_x = float(terms.x_coeff) != 0.0
    keys = jax.random.split(jax.random.PRNGKey(3), 2)
    ref = j_obs(jnp.asarray(hs), jnp.asarray(phis),
                jnp.asarray(terms.hs)[None], jnp.asarray(terms.phis)[None],
                sched.angles, keys[None], L=L, T=T, K=K, p=p,
                initial_state="vacuum", with_x=with_x, interpret=True)
    rows, erow, port_x = _inputs(L, drive, component,
                                 uniforms=_j_uniforms(keys[None], (T * K, L)),
                                 p=p)
    assert port_x == with_x
    got = _obs_pass_loop(rows, erow, L, _lo_bits(L), "vacuum", with_x)
    _held(got, [torch.from_numpy(np.array(r)) for r in ref], 1e-4, erow,
          L)
