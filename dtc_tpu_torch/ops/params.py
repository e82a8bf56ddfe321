"""Host-side feeders of the blocked x-drive kernels.

Ports of
- ``dtc_tpu/ops/pallas_noise.py::pack_cycle_params_compact`` (the compact
  per-cycle parameter row) and ``::pack_device_cycle_params_compact`` (the
  same row for device-noise events),
- ``dtc_tpu/ops/pallas_resident.py::_kick_matrices`` (RX kron-group kick
  matrices) and ``::echo_pair_tiles`` (the echo's (pre, post) step rows).

All are batched tensor ops (the reference vmaps them per trajectory and
per t); bit masks are int64. Row layout, width 128 or 256:
lanes [0,L) noise-Z bits n_q, [L,2L) sigma bits, [2L,3L-1) bond flips,
[3L-1,4L-1) h_q, [4L-1,5L-2) phi_j. Echo rows carry flags at the tail:
lane width-4 (first row only) = the pair's trip count 2t, width-3 = imag
sign of the step's kick (-1 on inverse steps), width-2 = step active,
width-1 = kick matrix index. K3 (``ops/resident.py``) reads the trip
count, the sign and the kick index; K1/K2 and the streamed family the first
two. The active flag is kept so that the tiles equal the reference's bit for
bit, which the tests check.

Width, the reference's rule (``pallas_streamed.py``): 128 lanes while the
5L-2 data lanes fit (forward: 5L-2 <= 128, L <= 26; echo: 5L-2 <= 124, so
that the flags stay clear, L <= 25), else 256. K1/K2 (L <= 23) always get
128; the streamed family (``ops/streamed.py``) takes either.
"""

from __future__ import annotations

import math

import torch

from dtc_tpu_torch.core.sigma_evolve import (
    _codes_from_uniform,
    _masks_from_codes,
    presample_noise,
    xor_scan,
)
from dtc_tpu_torch.ops.kick import kron
from dtc_tpu_torch.utils.profiling import span

WIDTH = 128
WIDE = 256


def forward_width(L: int) -> int:
    """Lanes of a forward row at L: 128 while 5L-2 <= 128, else 256."""
    return WIDTH if 5 * L - 2 <= WIDTH else WIDE


def echo_width(L: int) -> int:
    """Lanes of an echo step row at L: 128 while 5L-2 <= 124, else 256."""
    return WIDTH if 5 * L - 2 <= WIDTH - 4 else WIDE


def _bit_lanes(mask: torch.Tensor, L: int) -> torch.Tensor:
    sh = torch.arange(L, dtype=torch.int64, device=mask.device)
    return ((mask[..., None] >> sh) & 1).to(torch.float32)


def pack_cycle_params_compact(zm, sigma, hs, phis, L: int,
                              width: int = WIDTH) -> torch.Tensor:
    """(..., width) f32 rows from int64 masks zm, sigma (...) and angles
    hs (..., L), phis (..., L-1); all leading dimensions broadcast."""
    if 5 * L - 2 > width:
        raise ValueError(f"L={L} needs {5 * L - 2} lanes > {width}")
    zm = torch.as_tensor(zm, dtype=torch.int64, device=hs.device)
    sigma = torch.as_tensor(sigma, dtype=torch.int64, device=hs.device)
    batch = torch.broadcast_shapes(zm.shape, sigma.shape, hs.shape[:-1],
                                   phis.shape[:-1])
    zmb = _bit_lanes(zm, L).expand(*batch, L)
    sgb = _bit_lanes(sigma, L).expand(*batch, L)
    flip = (sgb[..., :L - 1] - sgb[..., 1:]).abs()
    pad = torch.zeros((*batch, width - (5 * L - 2)), dtype=torch.float32,
                      device=hs.device)
    return torch.cat([zmb, sgb, flip,
                      hs.to(torch.float32).expand(*batch, L),
                      phis.to(torch.float32).expand(*batch, L - 1), pad], -1)


def pack_device_cycle_params_compact(zm, sig_a, sig_b, sig_c, hs, phis,
                                     L: int, width: int = WIDTH
                                     ) -> torch.Tensor:
    """The compact row of a device-noise cycle (the x kernels read it
    unchanged): the n lanes carry the cycle's combined Z mask, the sigma
    lanes sig_c's bits (the field terms apply last), and bond j's flip comes
    from sig_a for even bonds, from sig_b for odd ones (each RZZ sublayer at
    its own pre-event frame; ``core/device_evolve.py``). int64 masks (...),
    hs (..., L), phis (..., L-1); leading dimensions broadcast."""
    if 5 * L - 2 > width:
        raise ValueError(f"L={L} needs {5 * L - 2} lanes > {width}")
    dev = hs.device
    masks = [torch.as_tensor(m, dtype=torch.int64, device=dev)
             for m in (zm, sig_a, sig_b, sig_c)]
    batch = torch.broadcast_shapes(*(m.shape for m in masks), hs.shape[:-1],
                                   phis.shape[:-1])
    zmb, sab, sbb, scb = (_bit_lanes(m, L).expand(*batch, L) for m in masks)
    flip_a = (sab[..., :L - 1] - sab[..., 1:]).abs()
    flip_b = (sbb[..., :L - 1] - sbb[..., 1:]).abs()
    even = torch.arange(L - 1, device=dev) % 2 == 0
    flip = torch.where(even, flip_a, flip_b)
    pad = torch.zeros((*batch, width - (5 * L - 2)), dtype=torch.float32,
                      device=dev)
    return torch.cat([zmb, scb, flip,
                      hs.to(torch.float32).expand(*batch, L),
                      phis.to(torch.float32).expand(*batch, L - 1), pad], -1)


@span("dtc.feed.forward_rows")
def forward_rows(uniforms, hs, phis, *, L: int, T: int, p: float,
                 batch=None):
    """Per-cycle rows of the forward kernel and the sigma after each cycle.

    uniforms (..., T, L) f32 as ``presample_noise`` draws them; hs (..., L)
    and phis (..., L-1) per row of the batch. With p == 0 the uniforms are
    unused (may be None) and ``batch`` gives the leading shape.
    Returns rows (..., T, forward_width(L)) f32 and sig_after (..., T)
    int64."""
    if p > 0.0:
        _, zm, _, csum = presample_noise(uniforms, p, L)
    else:
        zm = csum = torch.zeros((*batch, T), dtype=torch.int64,
                                device=hs.device)
    rows = pack_cycle_params_compact(zm, csum, hs[..., None, :],
                                     phis[..., None, :], L,
                                     forward_width(L))
    return rows, csum


def kick_matrices(angles, L: int, time_dependent: bool = False):
    """Planar (Tu, 128, 128) U7 and (Tu, TOP, TOP) U_top kick matrices
    (RX(theta_t)^{(x)7} and ^{(x)(L-14)}) of an x schedule (T, 1, 2), f32:
    Tu = T for a per-cycle schedule (``time_dependent``), else 1, from the
    first angle. Returns (u7r, u7i, utr, uti)."""
    TOP = 1 << max(L - 14, 0)
    thetas = angles[:, 0, 0] if time_dependent else angles[:1, 0, 0]
    c = torch.cos(thetas / 2).to(torch.float32)
    s = torch.sin(thetas / 2).to(torch.float32)
    eye = torch.eye(2, dtype=torch.float32, device=angles.device)
    off = torch.tensor([[0.0, -1.0], [-1.0, 0.0]], dtype=torch.float32,
                       device=angles.device)
    rr = eye * c[:, None, None]
    ri = off * s[:, None, None]

    def kpow(k):
        kr, ki = rr, ri
        for _ in range(k - 1):
            kr, ki = (kron(kr, rr) - kron(ki, ri),
                      kron(kr, ri) + kron(ki, rr))
        return kr, ki

    u7r, u7i = kpow(7)
    if TOP > 1:
        utr, uti = kpow(int(math.log2(TOP)))
    else:
        utr = torch.ones((thetas.shape[0], 1, 1), dtype=torch.float32,
                         device=angles.device)
        uti = torch.zeros_like(utr)
    return u7r, u7i, utr, uti


@span("dtc.feed.echo_pair_tiles")
def echo_pair_tiles(uniforms, ts, hs, phis, *, L: int, T: int, p: float,
                    batch=None):
    """Interleaved (pre, post) step rows for every (trajectory, t) pair.

    uniforms (..., 2T, L) f32 — one block per trajectory, shared by every
    t; ts (n_ts,) int; hs (..., L), phis (..., L-1). With p == 0 the
    uniforms are unused (may be None) and ``batch`` gives the leading shape.
    Returns tiles (..., n_ts, 4T, echo_width(L)) f32 and the final sigma
    (..., n_ts) int64.

    pre row: inverse diagonal D0* with the conj-correction at the CURRENT
    sigma (before this step's event) — the kernels apply the forward D0
    sigma correction eagerly, so at the turnaround the inverse must
    conj-correct it back. post row: forward steps carry the cycle's
    diagonal at the sigma after the event; inverse steps only the event's
    Z-signs.
    """
    width = echo_width(L)
    if 5 * L - 2 > width - 4:
        raise ValueError(f"L={L} data lanes collide with the flag lanes")
    dev = hs.device
    T2 = 2 * T
    ts = torch.as_tensor(ts, dtype=torch.int64, device=dev)
    n_ts = ts.shape[0]
    if batch is None:
        batch = uniforms.shape[:-2]
    step = torch.arange(T2, device=dev)
    t_ = ts[:, None]                                           # (n_ts, 1)
    fwd = step < t_                                            # (n_ts, T2)
    inv = (step >= t_) & (step < 2 * t_)
    if p > 0.0:
        codes = _codes_from_uniform(uniforms, p)[..., None, :, :]
        codes = torch.where((fwd | inv)[..., None], codes, 0)
        xm, zm = _masks_from_codes(codes, L)                   # (..., n_ts, T2)
        csum = xor_scan(xm, L)
        sig_b = torch.cat([torch.zeros_like(csum[..., :1]), csum[..., :-1]],
                          dim=-1)
    else:
        zm = sig_b = csum = torch.zeros((*batch, n_ts, T2), dtype=torch.int64,
                                        device=dev)
    h = hs[..., None, None, :]
    ph = phis[..., None, None, :]
    fwd_f = fwd.to(torch.float32)[..., None]
    inv_f = inv.to(torch.float32)[..., None]
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    pre = pack_cycle_params_compact(zero, sig_b, -h, -ph, L, width) * inv_f
    post = (pack_cycle_params_compact(zm, csum, h, ph, L, width) * fwd_f
            + pack_cycle_params_compact(zm, zero, torch.zeros_like(h),
                                        torch.zeros_like(ph), L, width)
            * inv_f)
    aidx = torch.where(fwd, step, torch.clamp(2 * t_ - 1 - step, 0, T - 1))
    pre[..., width - 3] = torch.where(inv, -1.0, 1.0)
    pre[..., width - 2] = (fwd | inv).to(torch.float32)
    pre[..., width - 1] = aidx.to(torch.float32)
    tiles = torch.stack([pre, post], dim=-2).reshape(*pre.shape[:-2],
                                                     2 * T2, width)
    tiles[..., 0, width - 4] = (2 * ts).to(torch.float32)
    return tiles.contiguous(), csum[..., -1]
