"""Per-cycle observables of lab-frame trajectories (kernel K5).

Port of ``dtc_tpu/ops/pallas_observables.py``
(``observables_forward_batch``). Its Pallas kernel (``_make_obs_kernel``)
becomes a third entry of the hand-written CUDA family of K4,
``csrc/floquet_general.cu`` (``floquet_general_observables``), which runs
K4's forward steps on the step passes of ``csrc/floquet_echo.cuh`` and
measures in them; beside it is the plain PyTorch version
``observables_forward_batch_ref``, which consumes the same rows and
computes the same algebra with tensor ops.

Inputs: K4's forward step rows (``ops/params_general.py``,
``general_forward_rows``, unchanged: the MPOS lane is not read) and one
energy row per trajectory (``energy_row``): th at lanes [0, L), tph at
[L, 2L-1), the component-selected Hamiltonian terms, not the evolution's h
and phi. Per trajectory and cycle t = 0..T-1, on the state before the
cycle's kicks:
    e_diag(t) = sum_s |psi_s|^2 E(s),
        E(s) = sum_q th_q z_q(s) + sum_b tph_b z_b(s) z_{b+1}(s),
    z_q(t)    = sum_s |psi_s|^2 z_q(s),
    x_sum(t)  = sum_q 2 Re sum_{s: bit q = 0} conj(psi_s) psi_{s ^ 2^q}
                (with_x; 0 otherwise),
then, for t < T-1, the cycle's K steps of K4 (kick X_m U^{(x)L}, then the
row's diagonal). The caller forms E = e_diag + x_coeff * x_sum.

The kernel takes, beside the rows, their step diagonals
(``ops/echo_fold.py::forward_fold``) and partials for a chunk of cycles
(``chunk_cycles``), summed once a chunk. Each block of its pass lo walks
``walk_tiles(L, n)`` consecutive tiles of 2^lo_bits(L) amplitudes of one
trajectory, with its sums in registers across them, so that the kick row,
the energy tables and the block's reduce are paid once a walk.

A tensor on the CPU goes to the plain version; a CUDA tensor launches the
kernel or raises. Each call is the span ``dtc.entry.K5``, counted in the
launch registry of ``utils/profiling.py``, and each launch in
``profiling.OBS_TILES`` by its walk.
"""

from __future__ import annotations

import torch

from dtc_tpu_torch.core.statevector import basis_index
from dtc_tpu_torch.ops.echo_fold import forward_fold
from dtc_tpu_torch.ops.gates import expect_x
from dtc_tpu_torch.ops.params import WIDTH
from dtc_tpu_torch.ops.resident_blocked import (
    angle_table,
    apply_phase,
    basis_states,
    batch_size,
    check_cuda_input,
    raise_on,
    route,
)
from dtc_tpu_torch.ops.resident_general import (
    MAX_L,
    MAX_STEPS,
    MIN_L,
    _kick,
    _row_angles,
    row_coeffs,
)
from dtc_tpu_torch.utils import profiling
from dtc_tpu_torch.utils.profiling import entry, span

# Tiles a pass-lo block of K5 walks at most (csrc/floquet_echo.cuh:
# 1 << kMaxObsWalk), and the pass-lo threads a launch keeps at least when
# its blocks walk more than one: about one wave of an H100 (132 SMs of 1024
# threads at the passes' 64 registers). Timed on an H100 at L = 14-23 and
# 1-256 trajectories (PERF.md section 6), the best walk was within 3 % of
# the longest that keeps one wave.
MAX_WALK = 16
MIN_WALK_THREADS = 1 << 17


def check_range(L: int, T: int, steps: int) -> None:
    """Raise ValueError outside the kernel's range: 14 <= L <= 23,
    1 <= steps (T*K rows per trajectory) <= MAX_STEPS, K whole."""
    if not (MIN_L <= L <= MAX_L):
        raise ValueError(f"observables kernel supports {MIN_L} <= L <= "
                         f"{MAX_L} (got L={L})")
    if not (1 <= steps <= MAX_STEPS):
        raise ValueError(f"observables kernel supports 1 <= T*K <= "
                         f"{MAX_STEPS} (got {steps})")
    if T < 1 or steps % T:
        raise ValueError(f"{steps} step rows are not K per cycle for T={T}")


def walk_tiles(L: int, n_traj: int) -> int:
    """Tiles a pass-lo block of K5 walks in a launch of ``n_traj``
    trajectories at L: the largest power of two up to ``MAX_WALK`` and a
    trajectory's 2^(L // 2) tiles whose blocks keep at least
    ``MIN_WALK_THREADS`` threads (``lo_threads(L)`` a block); 1 where two
    would keep fewer (one trajectory at L <= 20)."""
    tiles = 1 << (L // 2)  # a trajectory's pass-lo tiles, 2^(L - lo_bits)
    threads = n_traj * lo_threads(L)
    n = 1
    while (2 * n <= min(MAX_WALK, tiles)
           and tiles // (2 * n) * threads >= MIN_WALK_THREADS):
        n *= 2
    return n


def lo_threads(L: int) -> int:
    """Threads of a pass-lo block at L (``echo_threads(lo_bits(L))``,
    csrc/floquet_echo.cuh): one per 8 amplitudes of the tile, 32 to 256."""
    return min(max(1 << (L - L // 2 - 3), 32), 256)


def chunk_cycles(L: int, T: int, slots: int) -> int:
    """Cycles whose partials (``slots`` f32 per trajectory and cycle) one
    launch keeps before a reduce: as many as stay within a quarter of a
    state's bytes (2^L complex64), at least one, at most T."""
    return max(1, min(T, (8 << L) // 4 // (4 * slots)))


@span("dtc.feed.energy_terms")
def energy_row(th, tph, L: int) -> torch.Tensor:
    """(..., L) th and (..., L-1) tph -> (..., 128) f32 energy rows."""
    th, tph = torch.as_tensor(th), torch.as_tensor(tph)
    lead = torch.broadcast_shapes(th.shape[:-1], tph.shape[:-1])
    row = torch.zeros((*lead, WIDTH), dtype=torch.float32, device=th.device)
    row[..., :L] = th[..., :L]
    row[..., L:2 * L - 1] = tph[..., :L - 1]
    return row


def _split_out(out: torch.Tensor):
    """(..., T, 2+L) rows -> (e_diag, x_sum, zs)."""
    return out[..., 0], out[..., 1], out[..., 2:]


@entry("K5", plain=True)
def observables_forward_batch_ref(rows, erow, *, L, T,
                                  initial_state="vacuum", with_x=True):
    """Plain version of ``observables_forward_batch`` (same arguments)."""
    batch, S = rows.shape[:-2], rows.shape[-2]
    check_range(L, T, S)
    rows = rows.reshape(-1, S, rows.shape[-1]).to(torch.float32)
    n, dev, K = rows.shape[0], rows.device, S // T
    coef = erow.to(dev, torch.float32).expand(*batch, WIDTH).reshape(n, WIDTH)
    coef = coef[:, :2 * L - 1]
    table = angle_table(L, dev)
    state = basis_states(n, L, basis_index(L, initial_state), dev)
    out = torch.zeros((n, T, 2 + L), dtype=torch.float32, device=dev)
    for t in range(T):
        # marginals of z_q and z_b z_{b+1}: the z_q and, weighted, e_diag
        m = (state.real ** 2 + state.imag ** 2) @ table.T
        out[:, t, 0] = (m * coef).sum(-1)
        out[:, t, 2:] = m[:, :L]
        if with_x:
            out[:, t, 1] = sum(expect_x(state, q, L) for q in range(L))
        if t == T - 1:
            break
        for r in rows[:, t * K:(t + 1) * K].unbind(1):
            state = apply_phase(_kick(state, r, L), _row_angles(r, L, table))
    return _split_out(out.reshape(*batch, T, 2 + L))


@entry("K5")
def observables_forward_batch(rows, erow, *, L, T, initial_state="vacuum",
                              with_x=True):
    """(..., T*K, 128) K4 forward rows and (..., 128) energy rows (any
    shape that broadcasts to the rows' batch) -> e_diag (..., T),
    x_sum (..., T), zs (..., T, L), f32.

    CPU tensors take the plain version; CUDA tensors launch kernel K5."""
    if route(rows, "observables") == "plain":
        return observables_forward_batch_ref(rows, erow, L=L, T=T,
                                             initial_state=initial_state,
                                             with_x=with_x)
    check_cuda_input("rows", rows, 2, WIDTH)
    batch, S = rows.shape[:-2], rows.shape[-2]
    check_range(L, T, S)
    n = batch_size(batch, "observables")
    tiles = walk_tiles(L, n)
    out = launch(rows, erow, L=L, T=T, initial_state=initial_state,
                 with_x=with_x, tiles=tiles)
    profiling.OBS_TILES[tiles] += 1
    return out


def launch(rows, erow, *, L, T, initial_state, with_x, tiles):
    """One launch of K5 on checked CUDA rows, each pass-lo block walking
    ``tiles`` tiles (``walk_tiles`` in ``observables_forward_batch``; any
    other power of two up to ``MAX_WALK`` and a trajectory's tiles gives
    the same observables up to float32 rounding)."""
    batch, S = rows.shape[:-2], rows.shape[-2]
    n = batch_size(batch, "observables")
    from dtc_tpu_torch.ops import _build

    lib = _build.load("floquet_general")
    dev = rows.device
    coef = erow.to(dev, torch.float32).expand(*batch, WIDTH).contiguous()
    # step k's diagonal is fold row k + 1
    fold = forward_fold(rows.view(n, S, WIDTH), L, row_coeffs)
    slots = lib.floquet_general_observables_slots(L, tiles)
    if slots < 0:
        raise ValueError(f"K5 takes a walk of 1 to {MAX_WALK} tiles, a "
                         f"power of two (got {tiles} at L={L})")
    chunk = chunk_cycles(L, T, slots)
    state = torch.empty((n, 1 << L), dtype=torch.complex64, device=dev)
    part = torch.empty((n, chunk, slots), dtype=torch.float32, device=dev)
    out = torch.empty((n, T, 2 + L), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.floquet_general_observables(
        state.data_ptr(), rows.data_ptr(), fold.data_ptr(), coef.data_ptr(),
        part.data_ptr(), out.data_ptr(), n, L, S, fold.shape[1], T, chunk,
        int(bool(with_x)), tiles, basis_index(L, initial_state), stream)
    raise_on(err, "floquet_general_observables")
    return _split_out(out.reshape(*batch, T, 2 + L))
