"""Lab-frame forward A(t) and echo A0(t) for any kick schedule.

Port of ``dtc_tpu/ops/pallas_resident_general.py`` (``general_forward_batch``,
``general_echo_batch``). Its two Pallas kernels (K4a full plane, K4b blocked
plane; the same math) become one hand-written CUDA family,
``csrc/floquet_general.cu`` (``floquet_general_forward``,
``floquet_general_echo``); beside each entry is its plain PyTorch version
(``general_forward_batch_ref``, ``general_echo_batch_ref``), which consumes
the same rows and computes the same algebra with tensor ops. Both kernels
run the step passes of ``csrc/floquet_echo.cuh`` on K2's split, each step's
diagonal from a folded row (``ops/echo_fold.py``): the forward's from
``forward_fold`` (``general_forward_scratch``), the echo's from
``echo_plan``.

The entries take the step rows of ``ops/params_general.py``. A tensor on the
CPU goes to the plain version; a CUDA tensor launches the kernel or raises.
Each call is the span ``dtc.entry.K4.forward`` (or ``.echo``), counted in
the launch registry of ``utils/profiling.py``.

Per step: [echo: pre diagonal], the kick B = X_m U^{(x)L} (U the row's
slot unitary, m its X-mask), then the diagonal exp(i theta(s)) with
    theta(s) = c0 + sum_q cz_q z_q(s) + sum_j cb_j z_j(s) z_{j+1}(s),
    cz_q = -h_q/2 - (pi/2) n_q,   cb_j = -phi_j/2,   c0 = (pi/2) sum_q n_q.
Forward: a step whose row has MPOS >= 0 gives A(MPOS) = sum |psi|^2 z_q;
A(0) is the initial sign. Echo: each pair runs the COUNT steps its row 0
names, then sum |psi|^2 z_q. The host factor is ancilla_factor * s0.
"""

from __future__ import annotations

import math

import torch

from dtc_tpu_torch.core.statevector import basis_index
from dtc_tpu_torch.ops.echo_fold import echo_plan, forward_fold
from dtc_tpu_torch.ops.kick import kron
from dtc_tpu_torch.ops.params import WIDTH
from dtc_tpu_torch.ops.params_general import (
    LANE_COUNT,
    LANE_MPOS,
    LANE_U8,
    flag_base,
)
from dtc_tpu_torch.ops.resident_blocked import (
    angle_table,
    apply_phase,
    basis_sign,
    basis_states,
    batch_size,
    check_cuda_input,
    raise_on,
    route,
)
from dtc_tpu_torch.utils.profiling import entry

_HALF_PI = math.pi / 2
_GROUP = 7
MIN_L, MAX_L = 14, 23
# Step rows per trajectory (forward T*K) or per pair (echo 2T*K). The
# kernel reads MPOS/COUNT as f32 (exact far beyond this); the bound keeps
# an echo pair's rows at 4 MiB and a chunk's at a small share of its states.
MAX_STEPS = 4096


def check_range(L: int, q: int, steps: int) -> None:
    """Raise ValueError outside the kernel's range: 14 <= L <= 23,
    0 <= q < L, 1 <= steps (rows per trajectory or pair) <= MAX_STEPS."""
    if not (MIN_L <= L <= MAX_L):
        raise ValueError(f"general kernel supports {MIN_L} <= L <= {MAX_L}"
                         f" (got L={L})")
    if not (0 <= q < L):
        raise ValueError(f"probe qubit q={q} outside [0, {L})")
    if not (1 <= steps <= MAX_STEPS):
        raise ValueError(f"general kernel supports 1 <= steps <= {MAX_STEPS}"
                         f" per trajectory (got {steps})")


# ---------------------------------------------------------------------------
# plain versions


def row_coeffs(rows: torch.Tensor, L: int):
    """(..., 128) step rows -> the diagonal's coefficients (cz (..., L),
    cb (..., L-1), c0 (...)) in the lab frame, which the kernels take
    folded (``ops/echo_fold.py``)."""
    n_bits = rows[..., :L]
    cz = -0.5 * rows[..., 2 * L:3 * L] - _HALF_PI * n_bits
    cb = -0.5 * rows[..., 3 * L:4 * L - 1]
    return cz, cb, _HALF_PI * n_bits.sum(-1)


def _row_angles(rows: torch.Tensor, L: int, table: torch.Tensor):
    """(n, 128) rows -> (n, 2^L) diagonal angles theta(s)."""
    cz, cb, c0 = row_coeffs(rows, L)
    return c0[:, None] + torch.cat([cz, cb], dim=-1) @ table


def _kick(state: torch.Tensor, rows: torch.Tensor, L: int) -> torch.Tensor:
    """X_m U^{(x)L} on (n, 2^L): per qubit U, rows swapped where m_j = 1,
    applied as kron groups of up to 7 qubits."""
    u8 = rows[:, flag_base(L) + LANE_U8:flag_base(L) + LANE_U8 + 8]
    u = torch.complex(u8[:, 0::2], u8[:, 1::2]).reshape(-1, 2, 2)
    mats = torch.where(rows[:, L:2 * L, None, None] > 0.5,
                       u.flip(-2)[:, None], u[:, None])        # (n, L, 2, 2)
    n, total = state.shape
    for q0 in range(0, L, _GROUP):
        k = min(_GROUP, L - q0)
        g = mats[:, q0 + k - 1]
        for j in range(q0 + k - 2, q0 - 1, -1):
            g = kron(g, mats[:, j])
        s = state.reshape(n, total >> (q0 + k), 1 << k, 1 << q0)
        state = torch.einsum("nab,nhbl->nhal", g, s).reshape(n, total)
    return state


@entry("K4.forward", plain=True)
def general_forward_batch_ref(rows, *, L, T, q, initial_state="vacuum",
                              ancilla_factor=1.0):
    """Plain version of ``general_forward_batch`` (same arguments)."""
    batch, S = rows.shape[:-2], rows.shape[-2]
    check_range(L, q, S)
    rows = rows.reshape(-1, S, rows.shape[-1]).to(torch.float32)
    n, dev = rows.shape[0], rows.device
    b0 = basis_index(L, initial_state)
    table = angle_table(L, dev)
    zq = table[q]
    state = basis_states(n, L, b0, dev)
    a_raw = torch.zeros((n, T), dtype=torch.float32, device=dev)
    a_raw[:, 0] = basis_sign(b0, q)
    mpos_lane = flag_base(L) + LANE_MPOS
    for step in range((T - 1) * (S // T)):
        r = rows[:, step]
        state = apply_phase(_kick(state, r, L), _row_angles(r, L, table))
        idx = torch.nonzero(r[:, mpos_lane] >= 0)[:, 0]
        if idx.numel():
            a = (state[idx].real ** 2 + state[idx].imag ** 2) @ zq
            a_raw[idx, r[idx, mpos_lane].to(torch.int64)] = a
    out = (ancilla_factor * basis_sign(b0, q)) * a_raw
    return out.reshape(*batch, T)


@entry("K4.echo", plain=True)
def general_echo_batch_ref(tiles, *, L, q, initial_state="vacuum",
                           ancilla_factor=1.0):
    """Plain version of ``general_echo_batch`` (same arguments)."""
    batch, R = tiles.shape[:-2], tiles.shape[-2]
    check_range(L, q, R // 2)
    tiles = tiles.reshape(-1, R, tiles.shape[-1]).to(torch.float32)
    n, dev = tiles.shape[0], tiles.device
    b0 = basis_index(L, initial_state)
    table = angle_table(L, dev)
    state = basis_states(n, L, b0, dev)
    count = tiles[:, 0, flag_base(L) + LANE_COUNT].to(torch.int64)
    for k in range(int(count.max()) if n else 0):
        idx = torch.nonzero(k < count)[:, 0]
        pre, post = tiles[idx, 2 * k], tiles[idx, 2 * k + 1]
        sub = apply_phase(state[idx], _row_angles(pre, L, table))
        state[idx] = apply_phase(_kick(sub, pre, L),
                                 _row_angles(post, L, table))
    val = (state.real ** 2 + state.imag ** 2) @ table[q]
    return (ancilla_factor * basis_sign(b0, q)) * val.reshape(batch)


# ---------------------------------------------------------------------------
# kernel entries


def general_forward_scratch(flat, L: int, T: int, blocks: int):
    """What the forward kernel takes beside its (n, T*K, 128) step rows:
    the folded diagonals (n, n_steps + 1, 2L) of the steps it runs (row 0
    zero, not read; row k + 1 step k's ``row_coeffs``), the zeroed partials
    (n, T, blocks), one per pass-hi block, trajectory and time (an A(t) that
    no row measures sums zeros), and n_steps = (T-1) K, the steps whose
    results are measured."""
    n, S = flat.shape[:2]
    n_steps = (T - 1) * (S // T)
    fold = forward_fold(flat[:, :n_steps], L, row_coeffs)
    return fold, torch.zeros((n, T, blocks), dtype=torch.float32,
                             device=flat.device), n_steps


@entry("K4.forward")
def general_forward_batch(rows, *, L, T, q, initial_state="vacuum",
                          ancilla_factor=1.0):
    """(..., T*K, 128) step rows -> (..., T) A(t).

    Lab-frame forward autocorrelator of any kick schedule (K slots per
    cycle). CPU tensors take the plain version; CUDA tensors launch the
    K4 forward kernel."""
    if route(rows, "general") == "plain":
        return general_forward_batch_ref(rows, L=L, T=T, q=q,
                                         initial_state=initial_state,
                                         ancilla_factor=ancilla_factor)
    check_cuda_input("rows", rows, 2, WIDTH)
    batch, S = rows.shape[:-2], rows.shape[-2]
    check_range(L, q, S)
    if S % T:
        raise ValueError(f"{S} step rows are not K per cycle for T={T}")
    n = batch_size(batch, "forward")
    from dtc_tpu_torch.ops import _build

    lib = _build.load("floquet_general")
    b0 = basis_index(L, initial_state)
    dev = rows.device
    fold, partials, n_steps = general_forward_scratch(
        rows.view(n, S, WIDTH), L, T, lib.floquet_general_forward_partials(L))
    state = torch.empty((n, 1 << L), dtype=torch.complex64, device=dev)
    a_raw = torch.empty((n, T), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.floquet_general_forward(
        state.data_ptr(), rows.data_ptr(), fold.data_ptr(),
        partials.data_ptr(), a_raw.data_ptr(), n, L, S, fold.shape[1], T,
        n_steps, q, b0, stream)
    raise_on(err, "floquet_general_forward")
    return (ancilla_factor * basis_sign(b0, q)) * a_raw.reshape(*batch, T)


@entry("K4.echo")
def general_echo_batch(tiles, *, L, q, initial_state="vacuum",
                       ancilla_factor=1.0):
    """(..., 4T*K, 128) (pre, post) step rows -> (...) A0.

    Lab-frame echo: each pair runs the COUNT steps its row 0 names. CPU
    tensors take the plain version; CUDA tensors launch the K4 echo
    kernel."""
    if route(tiles, "general") == "plain":
        return general_echo_batch_ref(tiles, L=L, q=q,
                                      initial_state=initial_state,
                                      ancilla_factor=ancilla_factor)
    check_cuda_input("tiles", tiles, 2, WIDTH)
    batch, R = tiles.shape[:-2], tiles.shape[-2]
    check_range(L, q, R // 2)
    n = batch_size(batch, "echo")
    from dtc_tpu_torch.ops import _build

    lib = _build.load("floquet_general")
    b0 = basis_index(L, initial_state)
    dev = tiles.device
    flat = tiles.view(n, R, WIDTH)
    fold, n_steps = echo_plan(flat, flag_base(L) + LANE_COUNT, L, row_coeffs,
                              "step count")
    state = torch.empty((n, 1 << L), dtype=torch.complex64, device=dev)
    partials = torch.empty((n, lib.floquet_general_echo_partials(L)),
                           dtype=torch.float32, device=dev)
    val = torch.empty((n,), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.floquet_general_echo(
        state.data_ptr(), tiles.data_ptr(), fold.data_ptr(),
        partials.data_ptr(), val.data_ptr(), n, L, R, fold.shape[1], n_steps,
        q, b0, stream)
    raise_on(err, "floquet_general_echo")
    return (ancilla_factor * basis_sign(b0, q)) * val.reshape(batch)
