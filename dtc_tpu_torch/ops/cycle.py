"""One Floquet cycle on a batch of shard-local states, 17 <= L_loc <= 23.

Port of ``dtc_tpu/ops/pallas_cycle.py`` (``cycle_forward_apply``,
``cycle_inverse_apply``, ``general_cycle_forward_apply``,
``general_cycle_inverse_apply``): the per-shard engines of the
amplitude-sharded path (``parallel/sharded.py``). Its four Pallas kernels
become hand-written CUDA on the step passes of ``csrc/floquet_echo.cuh``
(K2's plan at L = L_loc) for one cycle: K8a/K8b in ``csrc/floquet_cycle.cu``
with the x family's kick policy, K8c/K8d in
``csrc/floquet_general_streamed.cu`` with the lab-frame one, beside K10's
shard-local forms (``ops/cycle_hi.py``):

- K8a ``cycle_forward_apply``: a sigma-frame x cycle, RX(theta) on every
  local bit, then the cycle's diagonal from its folded row pair
  (``fold_cycle_rows``: the local bits of the cycle's noise-Z and sigma
  words, from its compact row ``ops/params.py::pack_cycle_params_compact``
  at L = L_loc, and the shard's global diagonal); returns the partial
  sum |psi|^2 z_q, q < L_loc, or nothing with q=None;
- K8b ``cycle_inverse_apply``: the pre-fold inverse step K.D with the same
  diagonal (folded ``inverse=True``) and un-negated angles, for the echo's
  once-conjugated frame;
- K8c ``general_cycle_forward_apply``: a lab-frame cycle of K slot rows (K4's
  layout, ``ops/params_general.py``), each slot's kick then its diagonal
  from the folded rows (``fold_general_rows``: the slots' diagonals, the
  shard's global diagonal on the final slot's), and its partial after the
  final slot;
- K8d ``general_cycle_inverse_apply``: a daggered lab-frame cycle, per slot
  a (pre, post) row pair (K4's echo layout), the diagonals folded
  (``fold_general_rows(..., inverse=True)``: the shard's daggered global
  diagonal with the first pre diagonal, before the first kick).

K8c's MPOS flag lane is set here, on a copy of the rows
(``measured_rows``): the reference's rows carry none. States are flat
(n, 2^L_loc) complex64, local bit j on bit j of the index. Every entry
updates ``state`` in place, as the reference aliases its state input to its
output, and returns it. A tensor on the CPU goes to the plain version
(``*_ref``); a CUDA tensor launches the kernel or raises. Each call is
the span ``dtc.entry.K8a`` (``K8b``, ``K8c``, ``K8d``), counted in the
launch registry of ``utils/profiling.py``.
"""

from __future__ import annotations

import torch

from dtc_tpu_torch.ops import resident_blocked as rb
from dtc_tpu_torch.ops import resident_general as rg
from dtc_tpu_torch.ops.echo_fold import fold_rows, forward_fold
from dtc_tpu_torch.ops.params import WIDTH
from dtc_tpu_torch.ops.params_general import LANE_MPOS, flag_base
from dtc_tpu_torch.utils.profiling import entry, span

LIBRARY = "floquet_cycle"  # K8a/K8b
LIBRARY_GENERAL = "floquet_general_streamed"  # K8c/K8d, K10 shard-local
MIN_L, MAX_L = 17, 23


def check_range(L: int, q: int | None = None) -> None:
    """Raise ValueError outside 17 <= L_loc <= 23, or (forwards) for a
    probe that is not shard-local, q >= L_loc."""
    if not (MIN_L <= L <= MAX_L):
        raise ValueError(f"cycle kernels support {MIN_L} <= L_loc <= {MAX_L}"
                         f" (got L_loc={L})")
    if q is not None and not (0 <= q < L):
        raise ValueError(f"cycle kernels require a shard-local probe qubit "
                         f"q < L_loc = {L} (got q={q})")


def _check_state(state, L: int) -> int:
    if state.dim() != 2 or state.shape[1] != 1 << L:
        raise ValueError(f"state must be (n, 2^{L}) (got "
                         f"{tuple(state.shape)})")
    if state.dtype != torch.complex64:
        raise ValueError(f"state must be complex64 (got {state.dtype})")
    return state.shape[0]


def _check_rows(rows, n: int, lead: tuple, width: int = WIDTH) -> None:
    if tuple(rows.shape) != (n, *lead, width):
        raise ValueError(f"rows must be {(n, *lead, width)} (got "
                         f"{tuple(rows.shape)})")


def _cuda_inputs(state, rows, what: str, library: str = LIBRARY,
                 width: int = WIDTH) -> tuple:
    """(n, the library, the stream) after the kernel's input checks."""
    if not state.is_contiguous() or state.device != rows.device:
        raise ValueError(f"{what}: state must be contiguous and on the rows'"
                         " device")
    rb.check_cuda_input("rows", rows, 2, width)
    n = rb.batch_size((state.shape[0],), what)
    from dtc_tpu_torch.ops import _build

    lib = _build.load(library)
    return n, lib, torch.cuda.current_stream(state.device).cuda_stream


@span("dtc.feed.fold")
def fold_cycle_rows(rows, L: int, th_sc=None, th_bnd=None, *,
                    inverse: bool = False) -> torch.Tensor:
    """(..., width) compact cycle rows at L = L_loc -> (..., 2, 2L) f32
    folded row pairs of K8a (``inverse=False``: row 0 zero, not read; row 1
    the cycle's diagonal) or K8b (row 0 the step's diagonal, applied before
    its kick; row 1 zero, the identity). A diagonal row is (cz [0, L), cb
    [L, 2L-1), c0 at 2L-1), the x family's ``row_coeffs`` in f64, rounded
    once. th_sc and th_bnd, broadcastable against the rows' leading shape,
    are a shard's global diagonal exp(i (th_sc + th_bnd z_{L-1}))
    (``parallel/sharded.py::_tail_phase_angles``): th_sc joins c0, th_bnd
    cz[L-1]."""
    cz, cb, c0 = rb.row_coeffs(rows[..., :5 * L - 2].to(torch.float64), L)
    if th_sc is not None:
        c0 = c0 + th_sc.to(c0.device, torch.float64)
        cz = cz.expand(*c0.shape, L).clone()
        cz[..., L - 1] += th_bnd.to(cz.device, torch.float64)
        cb = cb.expand(*c0.shape, L - 1)
    diag = torch.cat([cz, cb, c0[..., None]], -1)
    zero = torch.zeros_like(diag)
    return torch.stack([diag, zero] if inverse else [zero, diag],
                       -2).to(torch.float32)


@span("dtc.feed.fold")
def fold_general_rows(rows, L: int, th_sc=None, th_bnd=None, *,
                      inverse: bool = False) -> torch.Tensor:
    """The per-shard lab-frame cycles' folded rows (K8c/K8d, and K10's
    shard-local forms in ``ops/cycle_hi.py``): (..., K, width) slot rows
    (forward) or (..., K, 2, width) (pre, post) slot pairs (``inverse``) at
    L = L_loc -> (..., K + 1, 2L) f32 diagonal rows (cz [0, L), cb
    [L, 2L-1), c0 at 2L-1), the lab-frame ``row_coeffs`` in f64, rounded
    once: the forward's row 0 zero (not read), row k + 1 slot k's diagonal
    (``echo_fold.forward_fold``); the inverse's row 0 the first pre
    diagonal, row k + 1 post(k) + pre(k + 1), row K the last post
    (``echo_fold.fold_rows`` with COUNT = K). th_sc and th_bnd,
    broadcastable against the rows' leading shape, are a shard's global
    diagonal exp(i (th_sc + th_bnd z_{L-1}))
    (``parallel/sharded.py::_tail_phase_angles``), as the launch applies
    it: th_sc joins c0 and th_bnd cz[L-1] of the forward's row K (after the
    final slot) or the inverse's row 0 (before the first kick; the caller
    negates them to dagger it)."""
    lead = rows.shape[:-3 if inverse else -2]
    K = rows.shape[len(lead)]
    flat = rows.reshape(-1, (2 if inverse else 1) * K, rows.shape[-1])
    if inverse:
        count = torch.full((flat.shape[0],), K, device=rows.device)
        fold = fold_rows(flat, count, L, rg.row_coeffs, torch.float64)
    else:
        fold = forward_fold(flat, L, rg.row_coeffs, torch.float64)
    fold, at = fold.reshape(*lead, K + 1, 2 * L), 0 if inverse else -1
    if th_sc is not None:
        lead = torch.broadcast_shapes(fold.shape[:-2], th_sc.shape)
        fold = fold.expand(*lead, *fold.shape[-2:]).clone()
        fold[..., at, 2 * L - 1] += th_sc.to(fold.device, torch.float64)
        fold[..., at, L - 1] += th_bnd.to(fold.device, torch.float64)
    return fold.to(torch.float32)


def measured_rows(rows, L: int, K: int) -> torch.Tensor:
    """The forwards' slot rows as K8c's and K10a's kernels read them (a
    copy): MPOS -1 on slots 0..K-2, 0 on the final slot."""
    rows = rows.clone()
    rows[:, :, flag_base(L) + LANE_MPOS] = -1.0
    rows[:, K - 1, flag_base(L) + LANE_MPOS] = 0.0
    return rows


def _fold_angles(fold, L: int, table):
    """(n, 2L) folded rows -> (n, 2^L) diagonal angles theta(s)."""
    return fold[:, 2 * L - 1, None] + fold[:, :2 * L - 1] @ table


# ---------------------------------------------------------------------------
# plain versions


@entry("K8a", plain=True)
def cycle_forward_apply_ref(state, rows, theta, *, L, q=None):
    """Plain version of ``cycle_forward_apply`` (same arguments)."""
    check_range(L, q)
    _check_rows(rows, _check_state(state, L), (2,), 2 * L)
    table = rb.angle_table(L, state.device)
    u7, utop = rb._kick_pair(theta, L, state.device)
    new = rb.apply_phase(rb._kick(state, u7, utop, L),
                         _fold_angles(rows[:, 1].to(torch.float32), L, table))
    state.copy_(new)
    if q is None:
        return state, None
    return state, (new.real ** 2 + new.imag ** 2) @ table[q]


@entry("K8b", plain=True)
def cycle_inverse_apply_ref(state, rows, theta, *, L):
    """Plain version of ``cycle_inverse_apply`` (same arguments)."""
    check_range(L)
    _check_rows(rows, _check_state(state, L), (2,), 2 * L)
    table = rb.angle_table(L, state.device)
    u7, utop = rb._kick_pair(theta, L, state.device)
    rows = rows.to(torch.float32)
    pre = rb.apply_phase(state, _fold_angles(rows[:, 0], L, table))
    return state.copy_(rb.apply_phase(rb._kick(pre, u7, utop, L),
                                      _fold_angles(rows[:, 1], L, table)))


@entry("K8c", plain=True)
def general_cycle_forward_apply_ref(state, rows, fold, *, L, K, q):
    """Plain version of ``general_cycle_forward_apply`` (same arguments)."""
    check_range(L, q)
    n = _check_state(state, L)
    _check_rows(rows, n, (K,))
    _check_rows(fold, n, (K + 1,), 2 * L)
    table = rb.angle_table(L, state.device)
    rows, fold = rows.to(torch.float32), fold.to(torch.float32)
    new = state
    for j in range(K):
        new = rb.apply_phase(rg._kick(new, rows[:, j], L),
                             _fold_angles(fold[:, j + 1], L, table))
    state.copy_(new)
    return state, (new.real ** 2 + new.imag ** 2) @ table[q]


@entry("K8d", plain=True)
def general_cycle_inverse_apply_ref(state, tiles, fold, *, L, K):
    """Plain version of ``general_cycle_inverse_apply`` (same arguments)."""
    check_range(L)
    n = _check_state(state, L)
    _check_rows(tiles, n, (K, 2))
    _check_rows(fold, n, (K + 1,), 2 * L)
    table = rb.angle_table(L, state.device)
    tiles, fold = tiles.to(torch.float32), fold.to(torch.float32)
    new = rb.apply_phase(state, _fold_angles(fold[:, 0], L, table))
    for j in range(K):
        new = rb.apply_phase(rg._kick(new, tiles[:, j, 0], L),
                             _fold_angles(fold[:, j + 1], L, table))
    return state.copy_(new)


# ---------------------------------------------------------------------------
# kernel entries


@entry("K8a")
def cycle_forward_apply(state, rows, theta, *, L, q=None):
    """One sigma-frame x cycle (K8a): state (n, 2^L) complex64, rows (n, 2,
    2L) the cycle's folded row pairs at L = L_loc (``fold_cycle_rows``),
    theta the RX angle. Returns (state, the partial sum |psi|^2 z_q (n,)
    after the cycle), or (state, None) with q=None: nothing is measured.
    The sum over the shards and the sigma sign are the caller's."""
    if rb.route(state, "cycle") == "plain":
        return cycle_forward_apply_ref(state, rows, theta, L=L, q=q)
    check_range(L, q)
    _check_rows(rows, _check_state(state, L), (2,), 2 * L)
    n, lib, stream = _cuda_inputs(state, rows, "cycle forward",
                                  width=2 * L)
    c, s = rb.kick_cs(theta)
    if q is None:
        err = lib.floquet_cycle_forward(state.data_ptr(), rows.data_ptr(),
                                        None, None, n, L, -1, c, s, stream)
        out = None
    else:
        partials = torch.empty((n, lib.floquet_cycle_partials(L)),
                               dtype=torch.float32, device=state.device)
        out = torch.empty((n,), dtype=torch.float32, device=state.device)
        err = lib.floquet_cycle_forward(state.data_ptr(), rows.data_ptr(),
                                        partials.data_ptr(), out.data_ptr(),
                                        n, L, q, c, s, stream)
    rb.raise_on(err, "floquet_cycle_forward")
    return state, out


@entry("K8b")
def cycle_inverse_apply(state, rows, theta, *, L):
    """One pre-fold inverse x cycle K.D (K8b): rows (n, 2, 2L) the step's
    folded row pairs (``fold_cycle_rows(..., inverse=True)``), theta the
    forward's angle; the caller negates the imaginary part once at the
    echo's turnaround. Returns state."""
    if rb.route(state, "cycle") == "plain":
        return cycle_inverse_apply_ref(state, rows, theta, L=L)
    check_range(L)
    _check_rows(rows, _check_state(state, L), (2,), 2 * L)
    n, lib, stream = _cuda_inputs(state, rows, "cycle inverse", width=2 * L)
    c, s = rb.kick_cs(theta)
    err = lib.floquet_cycle_inverse(state.data_ptr(), rows.data_ptr(), n, L,
                                    c, s, stream)
    rb.raise_on(err, "floquet_cycle_inverse")
    return state


def _general_inputs(state, rows, fold, what: str, lead: tuple, L: int,
                    K: int, width: int = WIDTH) -> tuple:
    """(n, the library, the stream) after the shape and CUDA checks of the
    per-shard lab-frame entries (K8c/K8d; K10's shard-local forms with
    their ``width``): state (n, 2^L), rows (n, *lead, width), fold
    (n, K + 1, 2L) on the state's device."""
    n = _check_state(state, L)
    _check_rows(rows, n, lead, width)
    _check_rows(fold, n, (K + 1,), 2 * L)
    rb.check_cuda_input("fold", fold, 2, 2 * L)
    if fold.device != state.device:
        raise ValueError(f"{what}: fold must be on the state's device")
    return _cuda_inputs(state, rows, what, LIBRARY_GENERAL, width)


@entry("K8c")
def general_cycle_forward_apply(state, rows, fold, *, L, K, q):
    """One lab-frame cycle (K8c): rows (n, K, 128), K4's step rows at
    L = L_loc; fold (n, K + 1, 2L) their diagonals (``fold_general_rows``,
    with the shard's global angles on the final slot). Returns (state, the
    partial sum |psi|^2 z_q (n,) after the final slot)."""
    if rb.route(state, "cycle") == "plain":
        return general_cycle_forward_apply_ref(state, rows, fold, L=L, K=K,
                                               q=q)
    check_range(L, q)
    n, lib, stream = _general_inputs(state, rows, fold,
                                     "general cycle forward", (K,), L, K)
    rows = measured_rows(rows, L, K)
    partials = torch.empty((n, lib.floquet_cycle_general_partials(L)),
                           dtype=torch.float32, device=state.device)
    out = torch.empty((n,), dtype=torch.float32, device=state.device)
    err = lib.floquet_cycle_general_forward(
        state.data_ptr(), rows.data_ptr(), fold.data_ptr(),
        partials.data_ptr(), out.data_ptr(), n, L, K, q, stream)
    rb.raise_on(err, "floquet_cycle_general_forward")
    return state, out


@entry("K8d")
def general_cycle_inverse_apply(state, tiles, fold, *, L, K):
    """One daggered lab-frame cycle (K8d): tiles (n, K, 2, 128), per slot
    the (pre, post) rows of K4's echo layout; fold (n, K + 1, 2L) their
    folded diagonals (``fold_general_rows(..., inverse=True)``, with the
    shard's daggered global angles before the first kick). Returns
    state."""
    if rb.route(state, "cycle") == "plain":
        return general_cycle_inverse_apply_ref(state, tiles, fold, L=L, K=K)
    check_range(L)
    n, lib, stream = _general_inputs(state, tiles, fold,
                                     "general cycle inverse", (K, 2), L, K)
    err = lib.floquet_cycle_general_inverse(
        state.data_ptr(), tiles.data_ptr(), fold.data_ptr(), n, L, K, stream)
    rb.raise_on(err, "floquet_cycle_general_inverse")
    return state
