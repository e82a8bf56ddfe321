"""One Floquet cycle on a batch of shard-local states, 22 <= L_loc <= 30,
each shard streamed through device memory.

Port of ``dtc_tpu/ops/pallas_cycle_hi.py`` (``hi_cycle_forward_apply``,
``hi_cycle_inverse_apply``) and ``dtc_tpu/ops/pallas_cycle_hi_general.py``
(``general_hi_cycle_forward_apply``, ``general_hi_cycle_inverse_apply``):
the per-shard engines of the amplitude-sharded path (``parallel/sharded.py``)
where a shard outgrows the per-shard kernels of ``ops/cycle.py`` (K8,
L_loc <= 23). Their four Pallas kernels become hand-written CUDA for one
cycle at L = L_loc on the pass plan of the streamed families
(``csrc/floquet_plan.cuh``) and the step passes of ``csrc/floquet_echo.cuh``:
K9a/K9b in ``csrc/floquet_cycle_hi.cu``, as K8a/K8b and the one-card
streamed x family run them, K10's shard-local forms in
``csrc/floquet_general_streamed.cu``, beside the one-card lab-frame family
whose policy they share:

- K9a ``hi_cycle_forward_apply``: a sigma-frame x cycle, RX(theta) on every
  local bit, then the cycle's diagonal from its folded row pair
  (``ops/cycle.py::fold_cycle_rows``: the local bits of the cycle's
  noise-Z and sigma words, from its compact row
  ``ops/params.py::pack_cycle_params_compact`` at L = L_loc, and the
  shard's global diagonal); returns the partial sum |psi|^2 z_q,
  q < L_loc, or nothing with q=None;
- K9b ``hi_cycle_inverse_apply``: the pre-fold inverse step K.D with the
  same diagonal (folded ``inverse=True``: the shard's global diagonal and
  the local one before the kick) and un-negated angles, for the echo's
  once-conjugated frame;
- K10a, shard-local, ``general_hi_cycle_forward_apply``: a lab-frame cycle
  of K slot rows (``ops/params_general.py`` at ``general_hi_width(L_loc)``:
  256 lanes at L_loc = 30), each slot's kick then its diagonal from the
  folded rows (``cycle.fold_general_rows``, as K8c's: the slots'
  diagonals, the shard's global diagonal on the final slot's), and its
  partial after the final slot;
- K10b, shard-local, ``general_hi_cycle_inverse_apply``: a daggered
  lab-frame cycle, per slot a (pre, post) row pair (K4's echo layout), the
  diagonals folded (``cycle.fold_general_rows(..., inverse=True)``: the
  shard's daggered global diagonal with the first pre diagonal, before the
  first kick).

The reference's split (re, im) state at L_loc = 30 and its per-call
trajectory chunks exist for the TPU's 2^32-byte DMA offset wrap and are not
ported: states are flat (n, 2^L_loc) complex64 with 64-bit offsets, and
the caller sizes its launches (``parallel/sharded.py``). K10a's MPOS flag
lane is set on a copy of the rows (``cycle.measured_rows``): the
reference's rows carry none.
Every entry updates ``state`` in place and returns it. A tensor on the CPU
goes to the plain version (``*_ref``); a CUDA tensor launches the kernel or
raises. Each call is the span ``dtc.entry.K9a`` (``K9b``, ``K10a.local``,
``K10b.local``), counted in the launch registry of ``utils/profiling.py``.

The plain versions hold one state at a time and no table over 2^L_loc: RX
or K4's kick in kron groups of 7 bits and the diagonal as the streamed
families' plain versions factor it (``streamed.angle_grid``). They run at
L_loc = 22 on a CPU in seconds and at L_loc = 30 on the card.

``MIN_ROUTE_L`` stands in for the reference's
``DTC_TPU_SHARDED_HI_MIN_LB``: the sharded engines take these kernels from
L_loc = MIN_ROUTE_L on and K8 below it. Tests lower it to 22 to run this
route at a size a CPU holds.
"""

from __future__ import annotations

import torch

from dtc_tpu_torch.ops import cycle
from dtc_tpu_torch.ops import cycle_hi_general as chg
from dtc_tpu_torch.ops import resident_blocked as rb
from dtc_tpu_torch.ops import streamed as sm
from dtc_tpu_torch.ops.kick import apply_uniform_1q_layer
from dtc_tpu_torch.ops.params_general import general_hi_width
from dtc_tpu_torch.utils.profiling import entry

LIBRARY = "floquet_cycle_hi"  # K9a/K9b; K10's: cycle.LIBRARY_GENERAL
MIN_L, MAX_L = 22, 30
MIN_ROUTE_L = 24  # the reference's DTC_TPU_SHARDED_HI_MIN_LB default


def check_range(L: int, q: int | None = None) -> None:
    """Raise ValueError outside 22 <= L_loc <= 30, or (forwards) for a
    probe that is not shard-local, q >= L_loc."""
    if not (MIN_L <= L <= MAX_L):
        raise ValueError(f"streamed cycle kernels support {MIN_L} <= L_loc <="
                         f" {MAX_L} (got L_loc={L})")
    if q is not None and not (0 <= q < L):
        raise ValueError(f"streamed cycle kernels require a shard-local "
                         f"probe qubit q < L_loc = {L} (got q={q})")


def _check(state, rows, L: int, lead: tuple, width: int) -> int:
    """n after the shape checks of state (n, 2^L) complex64 and rows
    (n, *lead, width)."""
    n = cycle._check_state(state, L)
    cycle._check_rows(rows, n, lead, width)
    return n


def global_phase(state, th_sc, th_bnd, sign: float = 1.0):
    """exp(i sign (th_sc + th_bnd z_top)) on each state of (n, 2^L) in place,
    z_top the sign of its top bit: a shard's global diagonal (th_sc, th_bnd
    (n,), ``parallel/sharded.py::_tail_phase_angles``): the torch form of
    what the per-shard lab-frame kernels carry in their folded rows
    (``cycle.fold_general_rows``), which the tests hold them against
    (``parallel/sharded.py::_global_diag``); no engine calls it."""
    ones = torch.ones_like(th_sc)
    f = torch.stack([torch.polar(ones, sign * (th_sc + th_bnd)),
                     torch.polar(ones, sign * (th_sc - th_bnd))], -1)
    n, M = state.shape
    state.view(n, 2, M >> 1).mul_(f.to(state.device)[:, :, None])
    return state


# ---------------------------------------------------------------------------
# plain versions


def _fold_grid(fold, L: int) -> torch.Tensor:
    """One folded row (2L,) -> its diagonal angle grid
    (``streamed.angle_grid``)."""
    return sm.angle_grid(fold[:L], fold[L:2 * L - 1], fold[2 * L - 1], L)


@entry("K9a", plain=True)
def hi_cycle_forward_apply_ref(state, rows, theta, *, L, q=None):
    """Plain version of ``hi_cycle_forward_apply`` (same arguments)."""
    check_range(L, q)
    n = _check(state, rows, L, (2,), 2 * L)
    rows = rows.to(torch.float32)
    rx = sm._rx(theta, 1.0, state.device)
    part = None if q is None else torch.empty(n, dtype=torch.float32,
                                              device=state.device)
    for i in range(n):
        new = sm.phase_grid(apply_uniform_1q_layer(state[i], rx, L),
                            _fold_grid(rows[i, 1], L))
        state[i].copy_(new)
        if part is not None:
            part[i] = sm.measure_z(new, q, L)
    return state, part


@entry("K9b", plain=True)
def hi_cycle_inverse_apply_ref(state, rows, theta, *, L):
    """Plain version of ``hi_cycle_inverse_apply`` (same arguments)."""
    check_range(L)
    n = _check(state, rows, L, (2,), 2 * L)
    rows = rows.to(torch.float32)
    rx = sm._rx(theta, 1.0, state.device)
    for i in range(n):
        pre = sm.phase_grid(state[i], _fold_grid(rows[i, 0], L))
        state[i].copy_(sm.phase_grid(apply_uniform_1q_layer(pre, rx, L),
                                     _fold_grid(rows[i, 1], L)))
    return state


@entry("K10a.local", plain=True)
def general_hi_cycle_forward_apply_ref(state, rows, fold, *, L, K, q):
    """Plain version of ``general_hi_cycle_forward_apply`` (same
    arguments)."""
    check_range(L, q)
    n = _check(state, rows, L, (K,), general_hi_width(L))
    cycle._check_rows(fold, n, (K + 1,), 2 * L)
    rows, fold = rows.to(torch.float32), fold.to(torch.float32)
    part = torch.empty(n, dtype=torch.float32, device=state.device)
    for i in range(n):
        new = state[i]
        for j in range(K):
            new = sm.phase_grid(chg._kick_one(new, rows[i, j], L),
                                _fold_grid(fold[i, j + 1], L))
        state[i].copy_(new)
        part[i] = sm.measure_z(new, q, L)
    return state, part


@entry("K10b.local", plain=True)
def general_hi_cycle_inverse_apply_ref(state, tiles, fold, *, L, K):
    """Plain version of ``general_hi_cycle_inverse_apply`` (same
    arguments)."""
    check_range(L)
    n = _check(state, tiles, L, (K, 2), general_hi_width(L))
    cycle._check_rows(fold, n, (K + 1,), 2 * L)
    tiles, fold = tiles.to(torch.float32), fold.to(torch.float32)
    for i in range(n):
        new = sm.phase_grid(state[i], _fold_grid(fold[i, 0], L))
        for j in range(K):
            new = sm.phase_grid(chg._kick_one(new, tiles[i, j, 0], L),
                                _fold_grid(fold[i, j + 1], L))
        state[i].copy_(new)
    return state


# ---------------------------------------------------------------------------
# kernel entries


@entry("K9a")
def hi_cycle_forward_apply(state, rows, theta, *, L, q=None):
    """One sigma-frame x cycle (K9a): state (n, 2^L) complex64, rows (n, 2,
    2L) the cycle's folded row pairs at L = L_loc
    (``cycle.fold_cycle_rows``, with the shard's global angles), theta the
    RX angle. Returns (state, the partial sum |psi|^2 z_q (n,) after the
    cycle), or (state, None) with q=None: nothing is measured. The sum over
    the shards and the sigma sign are the caller's."""
    if rb.route(state, "streamed cycle") == "plain":
        return hi_cycle_forward_apply_ref(state, rows, theta, L=L, q=q)
    check_range(L, q)
    _check(state, rows, L, (2,), 2 * L)
    n, lib, stream = cycle._cuda_inputs(state, rows, "hi cycle forward",
                                        LIBRARY, 2 * L)
    c, s = rb.kick_cs(theta)
    if q is None:
        err = lib.floquet_cycle_hi_forward(state.data_ptr(), rows.data_ptr(),
                                           None, None, n, L, -1, c, s, stream)
        out = None
    else:
        partials = torch.empty((n, lib.floquet_cycle_hi_partials(L)),
                               dtype=torch.float32, device=state.device)
        out = torch.empty((n,), dtype=torch.float32, device=state.device)
        err = lib.floquet_cycle_hi_forward(
            state.data_ptr(), rows.data_ptr(), partials.data_ptr(),
            out.data_ptr(), n, L, q, c, s, stream)
    rb.raise_on(err, "floquet_cycle_hi_forward")
    return state, out


@entry("K9b")
def hi_cycle_inverse_apply(state, rows, theta, *, L):
    """One pre-fold inverse x cycle K.D (K9b): rows (n, 2, 2L) the step's
    folded row pairs (``cycle.fold_cycle_rows(..., inverse=True)``, the
    shard's global diagonal with the local one), theta the forward's angle;
    the caller negates the imaginary part once at the echo's turnaround.
    Returns state."""
    if rb.route(state, "streamed cycle") == "plain":
        return hi_cycle_inverse_apply_ref(state, rows, theta, L=L)
    check_range(L)
    _check(state, rows, L, (2,), 2 * L)
    n, lib, stream = cycle._cuda_inputs(state, rows, "hi cycle inverse",
                                        LIBRARY, 2 * L)
    c, s = rb.kick_cs(theta)
    err = lib.floquet_cycle_hi_inverse(state.data_ptr(), rows.data_ptr(), n,
                                       L, c, s, stream)
    rb.raise_on(err, "floquet_cycle_hi_inverse")
    return state


@entry("K10a.local")
def general_hi_cycle_forward_apply(state, rows, fold, *, L, K, q):
    """One lab-frame cycle (K10a, shard-local): rows (n, K,
    general_hi_width(L)), K4's step rows at L = L_loc; fold (n, K + 1, 2L)
    their diagonals (``cycle.fold_general_rows``, with the shard's global
    angles on the final slot). Returns (state, the partial sum |psi|^2 z_q
    (n,) after the final slot)."""
    if rb.route(state, "streamed cycle") == "plain":
        return general_hi_cycle_forward_apply_ref(state, rows, fold, L=L,
                                                  K=K, q=q)
    check_range(L, q)
    width = general_hi_width(L)
    n, lib, stream = cycle._general_inputs(
        state, rows, fold, "general hi cycle forward", (K,), L, K, width)
    rows = cycle.measured_rows(rows, L, K)
    partials = torch.empty((n, lib.floquet_general_streamed_partials(L)),
                           dtype=torch.float32, device=state.device)
    out = torch.empty((n,), dtype=torch.float32, device=state.device)
    err = lib.floquet_cycle_hi_general_forward(
        state.data_ptr(), rows.data_ptr(), fold.data_ptr(),
        partials.data_ptr(), out.data_ptr(), n, L, width, K, q, stream)
    rb.raise_on(err, "floquet_cycle_hi_general_forward")
    return state, out


@entry("K10b.local")
def general_hi_cycle_inverse_apply(state, tiles, fold, *, L, K):
    """One daggered lab-frame cycle (K10b, shard-local): tiles (n, K, 2,
    general_hi_width(L)), per slot the (pre, post) rows of K4's echo
    layout; fold (n, K + 1, 2L) their folded diagonals
    (``cycle.fold_general_rows(..., inverse=True)``, with the shard's
    daggered global angles before the first kick). Returns state."""
    if rb.route(state, "streamed cycle") == "plain":
        return general_hi_cycle_inverse_apply_ref(state, tiles, fold, L=L,
                                                  K=K)
    check_range(L)
    width = general_hi_width(L)
    n, lib, stream = cycle._general_inputs(
        state, tiles, fold, "general hi cycle inverse", (K, 2), L, K, width)
    err = lib.floquet_cycle_hi_general_inverse(
        state.data_ptr(), tiles.data_ptr(), fold.data_ptr(), n, L, width, K,
        stream)
    rb.raise_on(err, "floquet_cycle_hi_general_inverse")
    return state
