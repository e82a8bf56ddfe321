"""Constant x-drive forward A(t) and echo A0(t) for large chains, 22 <= L <= 30.

Port of the HBM-streamed entries of the JAX package:
- ``dtc_tpu/ops/pallas_streamed.py``: ``streamed_forward_batch`` (K6a) and
  ``streamed_echo_batch`` (K6b), 22 <= L <= 28;
- ``dtc_tpu/ops/pallas_streamed_hi.py``: ``streamed_hi_forward_batch`` (K7a)
  and ``streamed_hi_echo_batch`` (K7b), 22 <= L <= 30.
On the TPU the four differ only in how VMEM slabs cut a state held in HBM.
Here one hand-written CUDA family (``csrc/floquet_x_streamed.cu``) with a
forward and an echo entry serves the whole range: two state passes per step
at L <= 24, three above. Both kernels take, beside the step rows, their
diagonals (``ops/echo_fold.py``: ``forward_fold`` for the forward,
``echo_plan`` for the echo). Beside each entry is its plain PyTorch version
(``streamed_forward_batch_ref``, ``streamed_echo_batch_ref``).

The entries take what ``ops/resident_blocked.py``'s take: the compact rows
of ``ops/params.py`` (128 or 256 lanes, ``forward_width``/``echo_width``),
the sigma for the host factor and the kick angle theta. A tensor on the CPU
goes to the plain version; a CUDA tensor launches the kernel or raises.
Each call is the span ``dtc.entry.K6.forward`` (or ``.echo``), counted in
the launch registry of ``utils/profiling.py``.

The plain versions hold one state at a time and no table over 2^L: RX on
every qubit in kron groups of 7 bits (``ops/kick.py``), the diagonal angle
as a low-bits vector plus a high-bits vector plus the straddling bond,
broadcast, as the kernels factor it. They run at L=22 on a CPU in seconds
and at L <= 30 on the card.
"""

from __future__ import annotations

import math

import torch

from dtc_tpu_torch.core.statevector import basis_index
from dtc_tpu_torch.ops.echo_fold import echo_plan
from dtc_tpu_torch.ops.kick import apply_uniform_1q_layer
from dtc_tpu_torch.ops.params import WIDE, WIDTH
from dtc_tpu_torch.ops.resident_blocked import (
    basis_sign,
    batch_size,
    check_cuda_input,
    echo_host_factor,
    forward_host_factor,
    forward_scratch,
    kick_cs,
    raise_on,
    route,
    row_coeffs,
)
from dtc_tpu_torch.utils.profiling import entry

_HALF_PI = math.pi / 2
MIN_L, MAX_L = 22, 30
MAX_T_FORWARD, MAX_T_ECHO = 1024, 512


def check_range(L: int, q: int, T: int, width: int, *, echo: bool) -> None:
    """Raise ValueError outside the kernels' range or for a row width that
    does not hold the L data lanes (and, for echo, the 4 flag lanes)."""
    if not (MIN_L <= L <= MAX_L):
        raise ValueError(f"streamed x kernels support {MIN_L} <= L <= {MAX_L}"
                         f" (got L={L})")
    if not (0 <= q < L):
        raise ValueError(f"probe qubit q={q} outside [0, {L})")
    t_max = MAX_T_ECHO if echo else MAX_T_FORWARD
    if not (1 <= T <= t_max):
        raise ValueError(f"streamed {'echo' if echo else 'forward'} kernel "
                         f"supports 1 <= T <= {t_max} (got T={T})")
    lanes = 5 * L - 2 + (4 if echo else 0)
    if width not in (WIDTH, WIDE) or lanes > width:
        raise ValueError(f"rows of {width} lanes cannot carry L={L} "
                         f"({lanes} lanes)")


# ---------------------------------------------------------------------------
# plain versions


def _rx(theta: float, sign: float, device) -> torch.Tensor:
    """RX(theta) in complex64 from the kernels' f32 cos/sin; sign -1 flips
    its imaginary part (the echo's inverse kick)."""
    c, s = kick_cs(theta)
    off = complex(0.0, -sign * s)
    return torch.tensor([[c, off], [off, c]], dtype=torch.complex64,
                        device=device)


def _part(cz, cb, n: int) -> torch.Tensor:
    """(2^n,) f32: sum_k cz_k z_k(x) + sum_k cb_k z_k(x) z_{k+1}(x)."""
    x = torch.arange(1 << n, dtype=torch.int64, device=cz.device)
    z = torch.stack([1 - 2 * ((x >> k) & 1) for k in range(n)]).to(
        torch.float32)
    return cz @ z + cb @ (z[:-1] * z[1:])


def angle_grid(cz, cb, c0, L: int) -> torch.Tensor:
    """theta(s) = c0 + sum_q cz_q z_q(s) + sum_j cb_j z_j(s) z_{j+1}(s) as a
    (2^(L-k), 2^k) grid over s = (hi << k) | lo, k = L // 2."""
    k = L // 2
    lo = _part(cz[:k], cb[:k - 1], k)
    hi = _part(cz[k:], cb[k:], L - k)
    z_lo = 1.0 - 2.0 * ((torch.arange(1 << k, device=cz.device) >> (k - 1))
                        & 1)
    z_hi = 1.0 - 2.0 * (torch.arange(1 << (L - k), device=cz.device) & 1)
    straddle = cb[k - 1] * z_hi[:, None] * z_lo[None, :]
    return (c0 + hi[:, None]) + lo[None, :] + straddle


def _angles(row, L: int) -> torch.Tensor:
    """One compact row -> its diagonal angle grid (``angle_grid``)."""
    n_bits = row[:L]
    cz = row[3 * L - 1:4 * L - 1] * (row[L:2 * L] - 0.5) - _HALF_PI * n_bits
    cb = row[4 * L - 1:5 * L - 2] * (row[2 * L:3 * L - 1] - 0.5)
    return angle_grid(cz, cb, _HALF_PI * n_bits.sum(), L)


def phase_grid(state, theta) -> torch.Tensor:
    """exp(i theta(s)) psi(s) of one (2^L,) state, theta an angle grid."""
    return (state.view(theta.shape)
            * torch.polar(torch.ones_like(theta), theta)).view(-1)


def measure_z(state, q: int, L: int) -> torch.Tensor:
    """sum_s |psi(s)|^2 z_q(s) of one (2^L,) state."""
    k = L // 2
    prob = (state.real ** 2 + state.imag ** 2).view(1 << (L - k), 1 << k)
    if q < k:
        x = torch.arange(1 << k, device=state.device)
        return (prob.sum(0) * (1 - 2 * ((x >> q) & 1))).sum()
    x = torch.arange(1 << (L - k), device=state.device)
    return (prob.sum(1) * (1 - 2 * ((x >> (q - k)) & 1))).sum()


def _basis_state(L: int, b0: int, device) -> torch.Tensor:
    state = torch.zeros(1 << L, dtype=torch.complex64, device=device)
    state[b0] = 1.0
    return state


@entry("K6.forward", plain=True)
def streamed_forward_batch_ref(rows, sig_after, theta, *, L, q,
                               initial_state="vacuum", ancilla_factor=1.0):
    """Plain version of ``streamed_forward_batch`` (same arguments)."""
    batch, T, width = rows.shape[:-2], rows.shape[-2], rows.shape[-1]
    check_range(L, q, T, width, echo=False)
    rows = rows.reshape(-1, T, width).to(torch.float32)
    dev = rows.device
    b0 = basis_index(L, initial_state)
    rx = _rx(theta, 1.0, dev)
    a_raw = torch.empty((rows.shape[0], T), dtype=torch.float32, device=dev)
    a_raw[:, 0] = basis_sign(b0, q)
    for i in range(rows.shape[0]):
        state = _basis_state(L, b0, dev)
        for cyc in range(T - 1):
            state = phase_grid(apply_uniform_1q_layer(state, rx, L),
                               _angles(rows[i, cyc], L))
            a_raw[i, cyc + 1] = measure_z(state, q, L)
    return forward_host_factor(a_raw.reshape(*batch, T), sig_after, q, b0,
                                ancilla_factor)


@entry("K6.echo", plain=True)
def streamed_echo_batch_ref(tiles, sig_fin, theta, *, L, q,
                            initial_state="vacuum", ancilla_factor=1.0):
    """Plain version of ``streamed_echo_batch`` (same arguments)."""
    batch, R, width = tiles.shape[:-2], tiles.shape[-2], tiles.shape[-1]
    check_range(L, q, R // 4, width, echo=True)
    tiles = tiles.reshape(-1, R, width).to(torch.float32)
    dev = tiles.device
    b0 = basis_index(L, initial_state)
    rx = {s: _rx(theta, s, dev) for s in (1.0, -1.0)}
    trips = tiles[:, 0, width - 4].tolist()
    signs = tiles[:, 0::2, width - 3].tolist()
    val = torch.empty(tiles.shape[0], dtype=torch.float32, device=dev)
    for i, trip in enumerate(trips):
        state = _basis_state(L, b0, dev)
        for k in range(int(trip)):
            state = phase_grid(state, _angles(tiles[i, 2 * k], L))
            state = apply_uniform_1q_layer(state, rx[signs[i][k]], L)
            state = phase_grid(state, _angles(tiles[i, 2 * k + 1], L))
        val[i] = measure_z(state, q, L)
    return echo_host_factor(val.reshape(batch), sig_fin, q, b0,
                             ancilla_factor)


# ---------------------------------------------------------------------------
# kernel entries


@entry("K6.forward")
def streamed_forward_batch(rows, sig_after, theta, *, L, q,
                           initial_state="vacuum", ancilla_factor=1.0):
    """(..., T, width) rows, (..., T) sigma after each cycle -> (..., T) A(t).

    Forward autocorrelator of a constant x-drive (RX(theta) kicks) at
    22 <= L <= 30. CPU tensors take the plain version; CUDA tensors launch
    the forward kernel of ``floquet_x_streamed.cu``."""
    if route(rows, "streamed x") == "plain":
        return streamed_forward_batch_ref(rows, sig_after, theta, L=L, q=q,
                                          initial_state=initial_state,
                                          ancilla_factor=ancilla_factor)
    batch, T, width = rows.shape[:-2], rows.shape[-2], rows.shape[-1]
    check_cuda_input("rows", rows, 2, width)
    check_range(L, q, T, width, echo=False)
    n = batch_size(batch, "forward")
    from dtc_tpu_torch.ops import _build

    lib = _build.load("floquet_x_streamed")
    b0 = basis_index(L, initial_state)
    dev = rows.device
    # the partials take per time 1 / (2^(c+1) CW) of a state's bytes: at
    # T = 1024 at most a quarter of the states' bytes (L = 25: c = 7,
    # CW = 16), 2 GiB beside the engine's 8 GiB a launch
    fold, partials = forward_scratch(rows.view(n, T, width), L,
                                     lib.floquet_x_streamed_partials(L))
    state = torch.empty((n, 1 << L), dtype=torch.complex64, device=dev)
    a_raw = torch.empty((n, T), dtype=torch.float32, device=dev)
    c, s = kick_cs(theta)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.floquet_x_streamed_forward(
        state.data_ptr(), rows.data_ptr(), fold.data_ptr(),
        partials.data_ptr(), a_raw.data_ptr(), n, L, T, width, fold.shape[1],
        q, b0, c, s, stream)
    raise_on(err, "floquet_x_streamed_forward")
    return forward_host_factor(a_raw.reshape(*batch, T), sig_after, q, b0,
                                ancilla_factor)


@entry("K6.echo")
def streamed_echo_batch(tiles, sig_fin, theta, *, L, q,
                        initial_state="vacuum", ancilla_factor=1.0):
    """(..., 4T, width) (pre, post) step rows, (...) final sigma -> (...) A0.

    Echo of a constant x-drive at 22 <= L <= 30: each pair runs the 2t
    steps its first row names. CPU tensors take the plain version; CUDA
    tensors launch the echo kernel of ``floquet_x_streamed.cu``."""
    if route(tiles, "streamed x") == "plain":
        return streamed_echo_batch_ref(tiles, sig_fin, theta, L=L, q=q,
                                       initial_state=initial_state,
                                       ancilla_factor=ancilla_factor)
    batch, R, width = tiles.shape[:-2], tiles.shape[-2], tiles.shape[-1]
    check_cuda_input("tiles", tiles, 2, width)
    check_range(L, q, R // 4, width, echo=True)
    n = batch_size(batch, "echo")
    from dtc_tpu_torch.ops import _build

    lib = _build.load("floquet_x_streamed")
    b0 = basis_index(L, initial_state)
    dev = tiles.device
    fold, n_steps = echo_plan(tiles.view(n, R, width), width - 4, L,
                              row_coeffs, "trip count")
    state = torch.empty((n, 1 << L), dtype=torch.complex64, device=dev)
    partials = torch.empty((n, lib.floquet_x_streamed_echo_partials(L)),
                           dtype=torch.float32, device=dev)
    val = torch.empty((n,), dtype=torch.float32, device=dev)
    c, s = kick_cs(theta)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.floquet_x_streamed_echo(
        state.data_ptr(), tiles.data_ptr(), fold.data_ptr(),
        partials.data_ptr(), val.data_ptr(), n, L, R, fold.shape[1], width,
        n_steps, q, b0, c, s, stream)
    raise_on(err, "floquet_x_streamed_echo")
    return echo_host_factor(val.reshape(batch), sig_fin, q, b0,
                             ancilla_factor)
