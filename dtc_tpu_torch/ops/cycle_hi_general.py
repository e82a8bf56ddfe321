"""Lab-frame forward A(t) and echo A0(t) for any kick schedule on large
chains, 22 <= L <= 29 (the engine routes 24 <= L <= 29 here).

Port of the single-chip general-drive route of the JAX package
(``dtc_tpu/experiments/engine.py``: ``_singlechip_general_forward`` :301,
``_singlechip_general_echo`` :330), which runs the cycle scans of
``dtc_tpu/parallel/sharded.py`` (``make_sharded_autocorr_forward_general``
:772, ``make_sharded_echo_general`` :998) on one rank, where every bit is
local, with the HBM-streamed kernels of
``dtc_tpu/ops/pallas_cycle_hi_general.py``: K10a
(``general_hi_cycle_forward_apply`` :463, one forward cycle) and K10b
(``general_hi_cycle_inverse_apply`` :543, one daggered cycle). Here one
hand-written CUDA family, ``csrc/floquet_general_streamed.cu``
(``floquet_general_streamed_forward``, ``floquet_general_streamed_echo``),
runs K4's lab-frame step on the streamed x family's pass plan; both
kernels take, beside the step rows, their diagonals as folded rows
(``ops/echo_fold.py``: ``echo_plan`` for the echo, as K4's does,
``forward_fold`` for the forward). Beside each entry is its plain
PyTorch version (``general_hi_forward_batch_ref``,
``general_hi_echo_batch_ref``).

The entries take the step rows of ``ops/params_general.py``, exactly as
K4's entries (``ops/resident_general.py``) take them: forward (..., T*K,
128), echo (..., 4T*K, 128) (pre, post) pairs with COUNT on row 0. The
semantics are K4's and the reference's single-chip route's: the forward
runs T-1 cycles, the final slot of cycle t measured into A(t+1), A(0) the
initial sign; the echo runs each pair's 2tK steps, the inverse steps with
the slots reversed and daggered and the D0* pre diagonal on their first
slot; the noise is lab frame (no sigma frame, no host sign). The host
factor is ancilla_factor * s0.

A tensor on the CPU goes to the plain version; a CUDA tensor launches the
kernel or raises. Each call is the span ``dtc.entry.K10.forward`` (or
``.echo``), counted in the launch registry of ``utils/profiling.py``.

The plain versions hold one state at a time and no table over 2^L: K4's
kick in kron groups of 7 bits (``resident_general._kick``) and the
lab-frame diagonal angle as the streamed x family's plain versions factor
it (``streamed.angle_grid``). They run at L=22 on a CPU in seconds and at
L=29 on the card.
"""

from __future__ import annotations

import math

import torch

from dtc_tpu_torch.core.statevector import basis_index
from dtc_tpu_torch.ops.echo_fold import echo_plan, forward_fold
from dtc_tpu_torch.ops.params import WIDTH
from dtc_tpu_torch.ops.params_general import LANE_COUNT, LANE_MPOS, flag_base
from dtc_tpu_torch.ops.resident_blocked import (
    basis_sign,
    basis_states,
    batch_size,
    check_cuda_input,
    raise_on,
    route,
)
from dtc_tpu_torch.ops.resident_general import MAX_STEPS, _kick, row_coeffs
from dtc_tpu_torch.ops.streamed import angle_grid, measure_z, phase_grid
from dtc_tpu_torch.utils.profiling import entry

_HALF_PI = math.pi / 2
MIN_L, MAX_L = 22, 29
MIN_ROUTE_L = 24  # below it the engine takes K4 (``resident_general``)


def check_range(L: int, q: int, steps: int) -> None:
    """Raise ValueError outside the kernels' range: 22 <= L <= 29,
    0 <= q < L, 1 <= steps (rows per trajectory or pair) <= MAX_STEPS."""
    if not (MIN_L <= L <= MAX_L):
        raise ValueError(f"streamed general kernels support {MIN_L} <= L <= "
                         f"{MAX_L} (got L={L})")
    if not (0 <= q < L):
        raise ValueError(f"probe qubit q={q} outside [0, {L})")
    if not (1 <= steps <= MAX_STEPS):
        raise ValueError(f"streamed general kernels support 1 <= steps <= "
                         f"{MAX_STEPS} per trajectory (got {steps})")


# ---------------------------------------------------------------------------
# plain versions


def _lab_phase(state, row, L: int) -> torch.Tensor:
    """exp(i theta(s)) of one row on one state: cz_q = -h_q/2 - (pi/2) n_q,
    cb_j = -phi_j/2, c0 = (pi/2) sum_q n_q."""
    n_bits = row[:L]
    cz = -0.5 * row[2 * L:3 * L] - _HALF_PI * n_bits
    cb = -0.5 * row[3 * L:4 * L - 1]
    return phase_grid(state, angle_grid(cz, cb, _HALF_PI * n_bits.sum(), L))


def _kick_one(state, row, L: int) -> torch.Tensor:
    return _kick(state[None], row[None], L)[0]


@entry("K10.forward", plain=True)
def general_hi_forward_batch_ref(rows, *, L, T, q, initial_state="vacuum",
                                 ancilla_factor=1.0):
    """Plain version of ``general_hi_forward_batch`` (same arguments)."""
    batch, S = rows.shape[:-2], rows.shape[-2]
    check_range(L, q, S)
    rows = rows.reshape(-1, S, rows.shape[-1]).to(torch.float32)
    n, dev = rows.shape[0], rows.device
    b0 = basis_index(L, initial_state)
    n_steps = (T - 1) * (S // T)
    mpos = rows[:, :n_steps, flag_base(L) + LANE_MPOS].to(torch.int64).tolist()
    a_raw = torch.zeros((n, T), dtype=torch.float32, device=dev)
    a_raw[:, 0] = basis_sign(b0, q)
    for i in range(n):
        state = basis_states(1, L, b0, dev)[0]
        for step in range(n_steps):
            r = rows[i, step]
            state = _lab_phase(_kick_one(state, r, L), r, L)
            if mpos[i][step] >= 0:
                a_raw[i, mpos[i][step]] = measure_z(state, q, L)
    out = (ancilla_factor * basis_sign(b0, q)) * a_raw
    return out.reshape(*batch, T)


@entry("K10.echo", plain=True)
def general_hi_echo_batch_ref(tiles, *, L, q, initial_state="vacuum",
                              ancilla_factor=1.0):
    """Plain version of ``general_hi_echo_batch`` (same arguments)."""
    batch, R = tiles.shape[:-2], tiles.shape[-2]
    check_range(L, q, R // 2)
    tiles = tiles.reshape(-1, R, tiles.shape[-1]).to(torch.float32)
    n, dev = tiles.shape[0], tiles.device
    b0 = basis_index(L, initial_state)
    counts = tiles[:, 0, flag_base(L) + LANE_COUNT].to(torch.int64).tolist()
    val = torch.empty(n, dtype=torch.float32, device=dev)
    for i, count in enumerate(counts):
        state = basis_states(1, L, b0, dev)[0]
        for k in range(count):
            pre, post = tiles[i, 2 * k], tiles[i, 2 * k + 1]
            state = _lab_phase(_kick_one(_lab_phase(state, pre, L), pre, L),
                               post, L)
        val[i] = measure_z(state, q, L)
    return (ancilla_factor * basis_sign(b0, q)) * val.reshape(batch)


# ---------------------------------------------------------------------------
# kernel entries


@entry("K10.forward")
def general_hi_forward_batch(rows, *, L, T, q, initial_state="vacuum",
                             ancilla_factor=1.0):
    """(..., T*K, 128) step rows -> (..., T) A(t).

    Lab-frame forward autocorrelator of any kick schedule (K slots per
    cycle) at 22 <= L <= 29. CPU tensors take the plain version; CUDA
    tensors launch the forward kernel of ``floquet_general_streamed.cu``."""
    if route(rows, "streamed general") == "plain":
        return general_hi_forward_batch_ref(rows, L=L, T=T, q=q,
                                            initial_state=initial_state,
                                            ancilla_factor=ancilla_factor)
    check_cuda_input("rows", rows, 2, WIDTH)
    batch, S = rows.shape[:-2], rows.shape[-2]
    check_range(L, q, S)
    if S % T:
        raise ValueError(f"{S} step rows are not K per cycle for T={T}")
    n = batch_size(batch, "forward")
    from dtc_tpu_torch.ops import _build

    lib = _build.load("floquet_general_streamed")
    b0 = basis_index(L, initial_state)
    dev = rows.device
    fold = forward_fold(rows.view(n, S, WIDTH), L, row_coeffs)
    state = torch.empty((n, 1 << L), dtype=torch.complex64, device=dev)
    # an A(t) that no row measures sums zeros
    partials = torch.zeros((n, T, lib.floquet_general_streamed_partials(L)),
                           dtype=torch.float32, device=dev)
    a_raw = torch.empty((n, T), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.floquet_general_streamed_forward(
        state.data_ptr(), rows.data_ptr(), fold.data_ptr(),
        partials.data_ptr(), a_raw.data_ptr(), n, L, S, fold.shape[1], T,
        (T - 1) * (S // T), q, b0, stream)
    raise_on(err, "floquet_general_streamed_forward")
    return (ancilla_factor * basis_sign(b0, q)) * a_raw.reshape(*batch, T)


@entry("K10.echo")
def general_hi_echo_batch(tiles, *, L, q, initial_state="vacuum",
                          ancilla_factor=1.0):
    """(..., 4T*K, 128) (pre, post) step rows -> (...) A0.

    Lab-frame echo at 22 <= L <= 29: each pair runs the COUNT steps its row
    0 names. CPU tensors take the plain version; CUDA tensors launch the
    echo kernel of ``floquet_general_streamed.cu``."""
    if route(tiles, "streamed general") == "plain":
        return general_hi_echo_batch_ref(tiles, L=L, q=q,
                                         initial_state=initial_state,
                                         ancilla_factor=ancilla_factor)
    check_cuda_input("tiles", tiles, 2, WIDTH)
    batch, R = tiles.shape[:-2], tiles.shape[-2]
    check_range(L, q, R // 2)
    n = batch_size(batch, "echo")
    from dtc_tpu_torch.ops import _build

    lib = _build.load("floquet_general_streamed")
    b0 = basis_index(L, initial_state)
    dev = tiles.device
    fold, n_steps = echo_plan(tiles.view(n, R, WIDTH),
                              flag_base(L) + LANE_COUNT, L, row_coeffs,
                              "step count")
    state = torch.empty((n, 1 << L), dtype=torch.complex64, device=dev)
    partials = torch.empty(
        (n, lib.floquet_general_streamed_echo_partials(L)),
        dtype=torch.float32, device=dev)
    val = torch.empty((n,), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.floquet_general_streamed_echo(
        state.data_ptr(), tiles.data_ptr(), fold.data_ptr(),
        partials.data_ptr(), val.data_ptr(), n, L, R, fold.shape[1], n_steps,
        q, b0, stream)
    raise_on(err, "floquet_general_streamed_echo")
    return (ancilla_factor * basis_sign(b0, q)) * val.reshape(batch)
