"""The folded diagonals of the kernels on the step passes of
``csrc/floquet_echo.cuh``: the echoes (K2, K3b, K4's echo, K6b/K7b, K10b)
and the streamed lab-frame forward (K10a).

An echo step k of a pair applies its pre diagonal D_pre(k), the kick B(k)
and its post diagonal D_post(k). D_post(k) and D_pre(k+1) are adjacent and
both diagonal in the computational basis, and the angle
    theta(s) = c0 + sum_q cz_q z_q(s) + sum_j cb_j z_j(s) z_{j+1}(s)
is linear in (cz, cb, c0), so their product is one diagonal whose
coefficients are the sums. ``fold_rows`` builds, per pair, S + 1 rows of
(cz, cb, c0) from its S (pre, post) step rows and its step count COUNT:
    row 0          = pre(0),
    row k + 1      = post(k) + pre(k + 1)   while k + 1 < COUNT,
    row COUNT      = post(COUNT - 1),
so that step 0 applies row 0 before its kick and every step k applies row
k + 1 after it: one diagonal per step instead of two. Each family's
coefficient formula is its ``row_coeffs`` (``ops/resident_blocked.py``,
sigma frame, for K3b's and the streamed x family's compact rows of 128 or
256 lanes; ``ops/resident_general.py``, lab frame, for K4's and K10's step
rows).

A forward step k is the kick of row k, then row k's diagonal: nothing
comes before step 0's kick, so ``forward_fold`` gives row 0 = zero (not
read: the kernel's pass lo of step 0 applies no diagonal) and row k + 1 =
step k's diagonal, the same (n, S + 1, 2L) layout.
"""

from __future__ import annotations

import torch

from dtc_tpu_torch.utils.profiling import span


def fold_rows(tiles: torch.Tensor, count: torch.Tensor, L: int,
              row_coeffs, dtype=torch.float32) -> torch.Tensor:
    """(n, 2S, width) interleaved (pre, post) step rows and (n,) step counts
    -> (n, S + 1, 2L) folded rows (cz [0, L), cb [L, 2L-1), c0 at 2L-1).

    The sums are taken in f64 and rounded once to ``dtype`` (f64 for a
    caller that adds more terms first). Rows past a pair's COUNT are not
    read by the kernels."""
    n, R = tiles.shape[:2]
    S = R // 2
    # both families' data lanes lie in [0, 5L - 2)
    cz, cb, c0 = row_coeffs(tiles[..., :5 * L - 2].to(torch.float64), L)
    coef = torch.cat([cz, cb, c0[..., None]], -1)
    pre, post = coef[:, 0:2 * S:2], coef[:, 1:2 * S:2]
    nxt = torch.arange(1, S, device=tiles.device)
    live = (nxt < count.to(tiles.device)[:, None]).to(torch.float64)
    out = torch.empty((n, S + 1, 2 * L), dtype=torch.float64,
                      device=tiles.device)
    out[:, 0] = pre[:, 0]
    out[:, 1:S] = post[:, :S - 1] + pre[:, 1:] * live[..., None]
    out[:, S] = post[:, S - 1]
    return out.to(dtype)


@span("dtc.feed.fold")
def echo_plan(flat: torch.Tensor, lane: int, L: int, row_coeffs, what: str):
    """What an echo kernel takes beside its (n, 2S, width) step rows on the
    card, whose COUNT sits at ``lane`` of each pair's row 0: the folded rows
    (n, S + 1, 2L) and the largest COUNT (one read to the host). Raises
    ValueError when it exceeds the S step rows."""
    count = flat[:, 0, lane]
    n_steps = int(count.max().item())
    S = flat.shape[1] // 2
    if n_steps > S:
        raise ValueError(f"{what} {n_steps} exceeds the {S} step rows")
    return fold_rows(flat, count, L, row_coeffs), n_steps


@span("dtc.feed.fold")
def forward_fold(rows: torch.Tensor, L: int, row_coeffs,
                 dtype=torch.float32) -> torch.Tensor:
    """(n, S, width) forward step rows -> (n, S + 1, 2L) diagonal rows
    (cz [0, L), cb [L, 2L-1), c0 at 2L-1): row 0 zero, not read; row k + 1
    step k's. Taken in f64 and rounded once to ``dtype``, as
    ``fold_rows``."""
    n, S = rows.shape[:2]
    cz, cb, c0 = row_coeffs(rows.to(torch.float64), L)
    out = torch.zeros((n, S + 1, 2 * L), dtype=dtype, device=rows.device)
    out[:, 1:] = torch.cat([cz, cb, c0[..., None]], -1).to(dtype)
    return out
