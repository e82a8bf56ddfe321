"""Constant x-drive forward A(t) and echo A0(t) on whole trajectories.

Port of ``dtc_tpu/ops/pallas_resident_blocked.py`` (``blocked_forward_batch``,
``blocked_echo_batch``). The two Pallas kernels become the hand-written CUDA
kernels of ``csrc/floquet_x.cu`` (K1 forward, K2 echo); beside each is its
plain PyTorch version (``blocked_forward_batch_ref``,
``blocked_echo_batch_ref``), which consumes the same rows and computes the
same algebra with tensor ops.

The entries take the per-cycle compact rows (``ops/params.py``) and the
constant kick angle theta (RX(theta) on every qubit, theta = pi g), so that
the engine, the tests and the reference can feed identical rows. A tensor on
the CPU goes to the plain version; a CUDA tensor launches the kernel or
raises. Each call is the span ``dtc.entry.K1`` (``K2``), counted in the
launch registry of ``utils/profiling.py``.
Both kernels run on the step passes of ``csrc/floquet_echo.cuh`` and take,
beside the step rows, their folded diagonals (``ops/echo_fold.py``: the
forward's ``forward_fold``, the echo's ``echo_plan``), as K3's do.

Per cycle (forward): RX(theta) on every qubit, then the cycle's diagonal
exp(i theta(s)) with the angle linear in the bits,
    theta(s) = c0 + sum_q cz_q z_q(s) + sum_j cb_j z_j(s) z_{j+1}(s),
    cz_q = h_q (sigma_q - 1/2) - (pi/2) n_q,   cb_j = phi_j (flip_j - 1/2),
    c0 = (pi/2) sum_q n_q,
then A(t+1) = sum |psi|^2 z_q. The host applies
ancilla_factor * s0 * (1 - 2 sigma_q) with sigma at the cycle's start.
Per echo step: pre diagonal, kick (inverse steps flip the kick's imaginary
part), post diagonal; after the pair's 2t steps, sum |psi|^2 z_q, times
ancilla_factor * s0 * (1 - 2 sigma_q(final)).
"""

from __future__ import annotations

import math

import torch

from dtc_tpu_torch.core.statevector import basis_index
from dtc_tpu_torch.ops.echo_fold import echo_plan, forward_fold
from dtc_tpu_torch.ops.params import WIDTH, kick_matrices
from dtc_tpu_torch.utils.profiling import entry

_HALF_PI = math.pi / 2
MIN_L, MAX_L = 17, 23
MAX_T_FORWARD, MAX_T_ECHO = 1024, 512


def check_range(L: int, q: int, T: int, *, echo: bool) -> None:
    """Raise ValueError outside the kernels' range."""
    if not (MIN_L <= L <= MAX_L):
        raise ValueError(f"blocked x kernels support {MIN_L} <= L <= {MAX_L}"
                         f" (got L={L})")
    if not (0 <= q < L):
        raise ValueError(f"probe qubit q={q} outside [0, {L})")
    t_max = MAX_T_ECHO if echo else MAX_T_FORWARD
    if not (1 <= T <= t_max):
        raise ValueError(f"blocked {'echo' if echo else 'forward'} kernel "
                         f"supports 1 <= T <= {t_max} (got T={T})")


def basis_sign(b0: int, q: int) -> float:
    """z_q of the initial basis state b0: the sign of A(0)."""
    return 1.0 - 2.0 * ((b0 >> q) & 1)


def _sigma_sign(sigma: torch.Tensor, q: int) -> torch.Tensor:
    return (1 - 2 * ((sigma >> q) & 1)).to(torch.float32)


# ---------------------------------------------------------------------------
# plain versions


def angle_table(L: int, device) -> torch.Tensor:
    """(2L-1, 2^L) f32: rows z_q(s) (q < L), then z_j z_{j+1}(s) (j < L-1)."""
    s = torch.arange(1 << L, dtype=torch.int64, device=device)
    z = torch.stack([(1 - 2 * ((s >> k) & 1)) for k in range(L)]).to(
        torch.float32)
    return torch.cat([z, z[:-1] * z[1:]])


def row_coeffs(rows: torch.Tensor, L: int):
    """(..., width) compact rows -> the diagonal's coefficients (cz (..., L),
    cb (..., L-1), c0 (...)) in the sigma frame, which the wrappers fold
    into the kernels' diagonal rows (``ops/echo_fold.py``)."""
    n_bits = rows[..., :L]
    cz = rows[..., 3 * L - 1:4 * L - 1] * (rows[..., L:2 * L] - 0.5) \
        - _HALF_PI * n_bits
    cb = rows[..., 4 * L - 1:5 * L - 2] * (rows[..., 2 * L:3 * L - 1] - 0.5)
    return cz, cb, _HALF_PI * n_bits.sum(-1)


def _row_angles(rows: torch.Tensor, L: int, table: torch.Tensor):
    """(n, 128) rows -> (n, 2^L) diagonal angles theta(s)."""
    cz, cb, c0 = row_coeffs(rows, L)
    return c0[:, None] + torch.cat([cz, cb], dim=-1) @ table


def apply_phase(state, theta):
    return state * torch.polar(torch.ones_like(theta), theta)


def _kick(state, u7, utop, L):
    """RX^{(x)L} on (n, 2^L): bits 0..6, 7..13 by U7, bits 14.. by U_top."""
    n = state.shape[0]
    x = state.reshape(n, -1, 128) @ u7.T
    x = torch.einsum("ab,nhbl->nhal", u7, x.reshape(n, -1, 128, 128))
    x = x.reshape(n, 1 << (L - 14), 1 << 14)
    x = torch.einsum("ab,nbl->nal", utop, x)
    return x.reshape(n, 1 << L)


def _kick_pair(theta: float, L: int, device, sign: float = 1.0):
    ang = torch.tensor([[[theta, 0.0]]], dtype=torch.float64, device=device)
    u7r, u7i, utr, uti = kick_matrices(ang, L)
    return (torch.complex(u7r[0], sign * u7i[0]),
            torch.complex(utr[0], sign * uti[0]))


def basis_states(n, L, b0, device):
    state = torch.zeros((n, 1 << L), dtype=torch.complex64, device=device)
    state[:, b0] = 1.0
    return state


@entry("K1", plain=True)
def blocked_forward_batch_ref(rows, sig_after, theta, *, L, q,
                              initial_state="vacuum", ancilla_factor=1.0):
    """Plain version of ``blocked_forward_batch`` (same arguments)."""
    batch, T = rows.shape[:-2], rows.shape[-2]
    check_range(L, q, T, echo=False)
    rows = rows.reshape(-1, T, rows.shape[-1]).to(torch.float32)
    n, dev = rows.shape[0], rows.device
    b0 = basis_index(L, initial_state)
    u7, utop = _kick_pair(theta, L, dev)
    table = angle_table(L, dev)
    zq = table[q]
    state = basis_states(n, L, b0, dev)
    a_raw = torch.empty((n, T), dtype=torch.float32, device=dev)
    a_raw[:, 0] = basis_sign(b0, q)
    for cyc in range(T - 1):
        state = apply_phase(_kick(state, u7, utop, L),
                            _row_angles(rows[:, cyc], L, table))
        a_raw[:, cyc + 1] = (state.real ** 2 + state.imag ** 2) @ zq
    return forward_host_factor(a_raw.reshape(*batch, T), sig_after, q, b0,
                                ancilla_factor)


@entry("K2", plain=True)
def blocked_echo_batch_ref(tiles, sig_fin, theta, *, L, q,
                           initial_state="vacuum", ancilla_factor=1.0):
    """Plain version of ``blocked_echo_batch`` (same arguments)."""
    batch, R = tiles.shape[:-2], tiles.shape[-2]
    check_range(L, q, R // 4, echo=True)
    tiles = tiles.reshape(-1, R, tiles.shape[-1]).to(torch.float32)
    n, dev = tiles.shape[0], tiles.device
    b0 = basis_index(L, initial_state)
    kicks = {s: _kick_pair(theta, L, dev, s) for s in (1.0, -1.0)}
    table = angle_table(L, dev)
    state = basis_states(n, L, b0, dev)
    trip = tiles[:, 0, WIDTH - 4].to(torch.int64)
    n_steps = int(trip.max()) if n else 0
    for k in range(n_steps):
        pre, post = tiles[:, 2 * k], tiles[:, 2 * k + 1]
        for s, (u7, utop) in kicks.items():
            idx = torch.nonzero((k < trip) & (pre[:, WIDTH - 3] == s))[:, 0]
            if idx.numel() == 0:
                continue
            sub = apply_phase(state[idx], _row_angles(pre[idx], L, table))
            sub = apply_phase(_kick(sub, u7, utop, L),
                              _row_angles(post[idx], L, table))
            state[idx] = sub
    val = (state.real ** 2 + state.imag ** 2) @ table[q]
    return echo_host_factor(val.reshape(batch), sig_fin, q, b0,
                             ancilla_factor)


def forward_host_factor(a_raw, sig_after, q, b0, ancilla_factor):
    """A(t) = ancilla_factor * z_q(b0) * (1 - 2 sigma_q at the cycle's
    start) * the kernel's sum."""
    sig_start = torch.cat([torch.zeros_like(sig_after[..., :1]),
                           sig_after[..., :-1]], dim=-1)
    return ((ancilla_factor * basis_sign(b0, q)) * _sigma_sign(sig_start, q)
            * a_raw)


def echo_host_factor(val, sig_fin, q, b0, ancilla_factor):
    """A0 = ancilla_factor * z_q(b0) * (1 - 2 sigma_q final) * the sum."""
    return ((ancilla_factor * basis_sign(b0, q)) * _sigma_sign(sig_fin, q)
            * val)


# ---------------------------------------------------------------------------
# kernel entries


def check_cuda_input(name, x, ndim_min, last):
    if not x.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor (got {x.device})")
    if x.dtype != torch.float32:
        raise ValueError(f"{name} must be float32 (got {x.dtype})")
    if x.dim() < ndim_min or x.shape[-1] != last:
        raise ValueError(f"{name} must have shape (..., {last}) "
                         f"(got {tuple(x.shape)})")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: cudaError {err}")


def kick_cs(theta: float):
    """cos(theta/2), sin(theta/2) rounded to f32, as the kernels take them."""
    return (float(torch.tensor(math.cos(theta / 2), dtype=torch.float32)),
            float(torch.tensor(math.sin(theta / 2), dtype=torch.float32)))


# Trajectories or pairs one launch may take: the grid's y dimension. The
# engines' chunk helpers size every launch within it.
MAX_LAUNCH = 65535


def batch_size(batch, what: str) -> int:
    """Trajectories or pairs of a launch: the grid's y dimension."""
    n = math.prod(batch)
    if not (1 <= n <= MAX_LAUNCH):
        raise ValueError(f"{what} batch of {n} outside [1, {MAX_LAUNCH}]")
    return n


def route(x, what: str) -> str:
    """'plain' for a CPU tensor, 'kernel' for a CUDA tensor; raises for any
    other device."""
    if x.device.type == "cpu":
        return "plain"
    if x.device.type == "cuda":
        return "kernel"
    raise ValueError(f"no {what} kernel for device {x.device}")


def forward_scratch(flat, L: int, blocks: int):
    """What an x forward kernel (K1, K3a, the streamed family) takes
    beside its (n, T, width) compact rows: the folded diagonals (n, T, 2L)
    (cycle k's at row k + 1; the last cycle is not run) and the zeroed
    partials (n, T, blocks): one per pass-hi block, trajectory and time; no
    step measures t = 0."""
    n, T = flat.shape[:2]
    fold = forward_fold(flat[:, :T - 1], L, row_coeffs)
    return fold, torch.zeros((n, T, blocks), dtype=torch.float32,
                             device=flat.device)


@entry("K1")
def blocked_forward_batch(rows, sig_after, theta, *, L, q,
                          initial_state="vacuum", ancilla_factor=1.0):
    """(..., T, 128) rows, (..., T) sigma after each cycle -> (..., T) A(t).

    Forward autocorrelator of a constant x-drive (RX(theta) kicks). CPU
    tensors take the plain version; CUDA tensors launch kernel K1."""
    if route(rows, "blocked x") == "plain":
        return blocked_forward_batch_ref(rows, sig_after, theta, L=L, q=q,
                                         initial_state=initial_state,
                                         ancilla_factor=ancilla_factor)
    check_cuda_input("rows", rows, 2, WIDTH)
    batch, T = rows.shape[:-2], rows.shape[-2]
    check_range(L, q, T, echo=False)
    n = batch_size(batch, "forward")
    from dtc_tpu_torch.ops import _build

    lib = _build.load("floquet_x")
    b0 = basis_index(L, initial_state)
    dev = rows.device
    fold, partials = forward_scratch(rows.view(n, T, WIDTH), L,
                                     lib.floquet_x_forward_partials(L))
    state = torch.empty((n, 1 << L), dtype=torch.complex64, device=dev)
    a_raw = torch.empty((n, T), dtype=torch.float32, device=dev)
    c, s = kick_cs(theta)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.floquet_x_forward(state.data_ptr(), rows.data_ptr(),
                                fold.data_ptr(), partials.data_ptr(),
                                a_raw.data_ptr(), n, L, T, fold.shape[1], q,
                                b0, c, s, stream)
    raise_on(err, "floquet_x_forward")
    return forward_host_factor(a_raw.reshape(*batch, T), sig_after, q, b0,
                                ancilla_factor)


@entry("K2")
def blocked_echo_batch(tiles, sig_fin, theta, *, L, q,
                       initial_state="vacuum", ancilla_factor=1.0):
    """(..., 4T, 128) (pre, post) step rows, (...) final sigma -> (...) A0.

    Echo of a constant x-drive: each pair runs the 2t steps its first row
    names. CPU tensors take the plain version; CUDA tensors launch kernel
    K2."""
    if route(tiles, "blocked x") == "plain":
        return blocked_echo_batch_ref(tiles, sig_fin, theta, L=L, q=q,
                                      initial_state=initial_state,
                                      ancilla_factor=ancilla_factor)
    check_cuda_input("tiles", tiles, 2, WIDTH)
    batch, R = tiles.shape[:-2], tiles.shape[-2]
    check_range(L, q, R // 4, echo=True)
    n = batch_size(batch, "echo")
    from dtc_tpu_torch.ops import _build

    lib = _build.load("floquet_x")
    b0 = basis_index(L, initial_state)
    dev = tiles.device
    fold, n_steps = echo_plan(tiles.view(n, R, WIDTH), WIDTH - 4, L,
                              row_coeffs, "trip count")
    state = torch.empty((n, 1 << L), dtype=torch.complex64, device=dev)
    partials = torch.empty((n, lib.floquet_x_echo_partials(L)),
                           dtype=torch.float32, device=dev)
    val = torch.empty((n,), dtype=torch.float32, device=dev)
    c, s = kick_cs(theta)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.floquet_x_echo(state.data_ptr(), tiles.data_ptr(),
                             fold.data_ptr(), partials.data_ptr(),
                             val.data_ptr(), n, L, R, fold.shape[1], n_steps,
                             q, b0, c, s, stream)
    raise_on(err, "floquet_x_echo")
    return echo_host_factor(val.reshape(batch), sig_fin, q, b0,
                             ancilla_factor)
