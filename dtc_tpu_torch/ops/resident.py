"""Constant or per-cycle x-drive forward A(t) and echo A0(t), 14 <= L <= 21.

Port of ``dtc_tpu/ops/pallas_resident.py`` (``resident_forward_batch``,
``resident_echo_batch``). The two Pallas kernels (K3a forward, K3b echo)
become the CUDA entries of ``csrc/floquet_x_resident.cu``, both on the step
passes of ``csrc/floquet_echo.cuh`` with the x kick policy
(``csrc/floquet_x_echo.cuh``) and the kick angle read from a table, on
folded diagonals (``ops/echo_fold.py``: the forward's ``forward_fold``, as
K1's, the echo's ``echo_plan``); beside each is its plain PyTorch version
(``resident_forward_batch_ref``, ``resident_echo_batch_ref``), which runs
the reference's kick matrices (``ops/params.py::kick_matrices``, one per
cycle when ``time_dependent``) through K1's kron-group kick.

The entries take K1/K2's rows and host factor (``ops/params.py``,
``ops/resident_blocked.py``: the same sigma frame) and the x schedule
``angles`` (T, 1, 2), theta_t = angles[t, 0, 0]. With ``time_dependent``
False the first angle kicks every cycle (the reference's constant mode);
else cycle t kicks by RX(theta_t), and an echo step by the angle its pre
row's lane 127 names (forward step k: k; inverse step: 2t-1-k), with the
kick's imaginary part flipped on inverse steps (lane 125). The kernels take
the schedule as a table of (cos theta_t/2, sin theta_t/2) in f32
(``kick_table``). Any probe 0 <= q < L; the reference's q < 14 is a TPU
layout limit.

A tensor on the CPU goes to the plain version; a CUDA tensor launches the
kernel or raises. Each call is the span ``dtc.entry.K3.forward`` (or
``.echo``), counted in the launch registry of ``utils/profiling.py``.
"""

from __future__ import annotations

import torch

from dtc_tpu_torch.core.statevector import basis_index
from dtc_tpu_torch.ops.echo_fold import echo_plan
from dtc_tpu_torch.ops.params import WIDTH, kick_matrices
from dtc_tpu_torch.ops.resident_blocked import (
    MAX_T_ECHO,
    MAX_T_FORWARD,
    _kick,
    _row_angles,
    angle_table,
    apply_phase,
    basis_sign,
    basis_states,
    batch_size,
    check_cuda_input,
    echo_host_factor,
    forward_host_factor,
    forward_scratch,
    raise_on,
    route,
    row_coeffs,
)
from dtc_tpu_torch.utils.profiling import entry

MIN_L, MAX_L = 14, 21


def check_range(L: int, q: int, T: int, *, echo: bool) -> None:
    """Raise ValueError outside the kernels' range: 14 <= L <= 21,
    0 <= q < L, and K1/K2's limits on T."""
    if not (MIN_L <= L <= MAX_L):
        raise ValueError(f"resident x kernels support {MIN_L} <= L <= "
                         f"{MAX_L} (got L={L})")
    if not (0 <= q < L):
        raise ValueError(f"probe qubit q={q} outside [0, {L})")
    t_max = MAX_T_ECHO if echo else MAX_T_FORWARD
    if not (1 <= T <= t_max):
        raise ValueError(f"resident {'echo' if echo else 'forward'} kernel "
                         f"supports 1 <= T <= {t_max} (got T={T})")


def _check_schedule(angles, T: int, time_dependent: bool) -> None:
    """A per-cycle schedule must name an angle for each of the T cycles."""
    if angles.dim() != 3 or angles.shape[1:] != (1, 2):
        raise ValueError(f"angles must be an x schedule (T, 1, 2) (got "
                         f"{tuple(angles.shape)})")
    if time_dependent and angles.shape[0] < T:
        raise ValueError(f"a per-cycle schedule of {angles.shape[0]} angles"
                         f" does not cover T={T} cycles")


def kick_table(angles, time_dependent: bool, device) -> torch.Tensor:
    """(Tu, 2) f32 table (cos theta_t/2, sin theta_t/2), Tu = T per cycle
    or 1, rounded to f32 after the f64 trigonometry, as ``kick_matrices``
    rounds."""
    th = angles[:, 0, 0] if time_dependent else angles[:1, 0, 0]
    th = th.to(device=device, dtype=torch.float64)
    return torch.stack([torch.cos(th / 2), torch.sin(th / 2)],
                       -1).to(torch.float32).contiguous()


# ---------------------------------------------------------------------------
# plain versions


def _kick_pairs(angles, L, time_dependent, device):
    """Complex (Tu, 128, 128) U7 and (Tu, TOP, TOP) U_top."""
    u7r, u7i, utr, uti = kick_matrices(angles.to(device), L,
                                       time_dependent=time_dependent)
    return torch.complex(u7r, u7i), torch.complex(utr, uti)


@entry("K3.forward", plain=True)
def resident_forward_batch_ref(rows, sig_after, angles, *, L, q,
                               initial_state="vacuum", ancilla_factor=1.0,
                               time_dependent=False):
    """Plain version of ``resident_forward_batch`` (same arguments)."""
    batch, T = rows.shape[:-2], rows.shape[-2]
    check_range(L, q, T, echo=False)
    _check_schedule(angles, T, time_dependent)
    rows = rows.reshape(-1, T, rows.shape[-1]).to(torch.float32)
    n, dev = rows.shape[0], rows.device
    b0 = basis_index(L, initial_state)
    u7, utop = _kick_pairs(angles, L, time_dependent, dev)
    table = angle_table(L, dev)
    zq = table[q]
    state = basis_states(n, L, b0, dev)
    a_raw = torch.empty((n, T), dtype=torch.float32, device=dev)
    a_raw[:, 0] = basis_sign(b0, q)
    for cyc in range(T - 1):
        ui = cyc if time_dependent else 0
        state = apply_phase(_kick(state, u7[ui], utop[ui], L),
                            _row_angles(rows[:, cyc], L, table))
        a_raw[:, cyc + 1] = (state.real ** 2 + state.imag ** 2) @ zq
    return forward_host_factor(a_raw.reshape(*batch, T), sig_after, q, b0,
                                ancilla_factor)


@entry("K3.echo", plain=True)
def resident_echo_batch_ref(tiles, sig_fin, angles, *, L, q,
                            initial_state="vacuum", ancilla_factor=1.0,
                            time_dependent=False):
    """Plain version of ``resident_echo_batch`` (same arguments)."""
    batch, R = tiles.shape[:-2], tiles.shape[-2]
    check_range(L, q, R // 4, echo=True)
    _check_schedule(angles, R // 4, time_dependent)
    tiles = tiles.reshape(-1, R, tiles.shape[-1]).to(torch.float32)
    n, dev = tiles.shape[0], tiles.device
    b0 = basis_index(L, initial_state)
    u7, utop = _kick_pairs(angles, L, time_dependent, dev)
    table = angle_table(L, dev)
    state = basis_states(n, L, b0, dev)
    trip = tiles[:, 0, WIDTH - 4].to(torch.int64)
    n_steps = int(trip.max()) if n else 0
    for k in range(n_steps):
        pre, post = tiles[:, 2 * k], tiles[:, 2 * k + 1]
        ui = pre[:, WIDTH - 1].to(torch.int64).clamp(0, u7.shape[0] - 1)
        # one kick per (table row, inverse?) among the active pairs
        key = 2 * ui + (pre[:, WIDTH - 3] < 0).to(torch.int64)
        active = k < trip
        for kk in torch.unique(key[active]).tolist():
            idx = torch.nonzero(active & (key == kk))[:, 0]
            i, inverse = divmod(kk, 2)
            a7, at = u7[i], utop[i]
            if inverse:
                a7, at = a7.conj(), at.conj()
            sub = apply_phase(state[idx], _row_angles(pre[idx], L, table))
            state[idx] = apply_phase(_kick(sub, a7, at, L),
                                     _row_angles(post[idx], L, table))
    val = (state.real ** 2 + state.imag ** 2) @ table[q]
    return echo_host_factor(val.reshape(batch), sig_fin, q, b0,
                             ancilla_factor)


# ---------------------------------------------------------------------------
# kernel entries


@entry("K3.forward")
def resident_forward_batch(rows, sig_after, angles, *, L, q,
                           initial_state="vacuum", ancilla_factor=1.0,
                           time_dependent=False):
    """(..., T, 128) rows, (..., T) sigma after each cycle, (T, 1, 2) x
    schedule -> (..., T) A(t).

    Forward autocorrelator of a constant or per-cycle x drive. CPU tensors
    take the plain version; CUDA tensors launch kernel K3a."""
    if route(rows, "resident x") == "plain":
        return resident_forward_batch_ref(
            rows, sig_after, angles, L=L, q=q, initial_state=initial_state,
            ancilla_factor=ancilla_factor, time_dependent=time_dependent)
    check_cuda_input("rows", rows, 2, WIDTH)
    batch, T = rows.shape[:-2], rows.shape[-2]
    check_range(L, q, T, echo=False)
    _check_schedule(angles, T, time_dependent)
    n = batch_size(batch, "forward")
    from dtc_tpu_torch.ops import _build

    lib = _build.load("floquet_x_resident")
    b0 = basis_index(L, initial_state)
    dev = rows.device
    cs = kick_table(angles, time_dependent, dev)
    fold, partials = forward_scratch(
        rows.view(n, T, WIDTH), L, lib.floquet_x_resident_forward_partials(L))
    state = torch.empty((n, 1 << L), dtype=torch.complex64, device=dev)
    a_raw = torch.empty((n, T), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.floquet_x_resident_forward(
        state.data_ptr(), rows.data_ptr(), fold.data_ptr(), cs.data_ptr(),
        partials.data_ptr(), a_raw.data_ptr(), n, L, T, fold.shape[1],
        cs.shape[0], q, b0, stream)
    raise_on(err, "floquet_x_resident_forward")
    return forward_host_factor(a_raw.reshape(*batch, T), sig_after, q, b0,
                                ancilla_factor)


@entry("K3.echo")
def resident_echo_batch(tiles, sig_fin, angles, *, L, q,
                        initial_state="vacuum", ancilla_factor=1.0,
                        time_dependent=False):
    """(..., 4T, 128) (pre, post) step rows, (...) final sigma, (T, 1, 2) x
    schedule -> (...) A0.

    Echo of a constant or per-cycle x drive: each pair runs the 2t steps its
    first row names. CPU tensors take the plain version; CUDA tensors launch
    kernel K3b."""
    if route(tiles, "resident x") == "plain":
        return resident_echo_batch_ref(
            tiles, sig_fin, angles, L=L, q=q, initial_state=initial_state,
            ancilla_factor=ancilla_factor, time_dependent=time_dependent)
    check_cuda_input("tiles", tiles, 2, WIDTH)
    batch, R = tiles.shape[:-2], tiles.shape[-2]
    check_range(L, q, R // 4, echo=True)
    _check_schedule(angles, R // 4, time_dependent)
    n = batch_size(batch, "echo")
    from dtc_tpu_torch.ops import _build

    lib = _build.load("floquet_x_resident")
    b0 = basis_index(L, initial_state)
    dev = tiles.device
    flat = tiles.view(n, R, WIDTH)
    fold, n_steps = echo_plan(flat, WIDTH - 4, L, row_coeffs, "trip count")
    cs = kick_table(angles, time_dependent, dev)
    state = torch.empty((n, 1 << L), dtype=torch.complex64, device=dev)
    partials = torch.empty((n, lib.floquet_x_resident_echo_partials(L)),
                           dtype=torch.float32, device=dev)
    val = torch.empty((n,), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.floquet_x_resident_echo(
        state.data_ptr(), tiles.data_ptr(), fold.data_ptr(), cs.data_ptr(),
        partials.data_ptr(), val.data_ptr(), n, L, R, fold.shape[1], n_steps,
        cs.shape[0], q, b0, stream)
    raise_on(err, "floquet_x_resident_echo")
    return echo_host_factor(val.reshape(batch), sig_fin, q, b0,
                             ancilla_factor)
