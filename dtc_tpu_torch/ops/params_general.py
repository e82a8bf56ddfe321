"""Host-side feeders of the lab-frame general-drive kernel (K4).

Ports of ``dtc_tpu/ops/pallas_resident_general.py``: ``slot_u8`` and the
compact step rows that ``general_forward_batch`` and ``general_echo_batch``
build per trajectory (their ``tiles_one``). The reference vmaps them per
trajectory and per t; here they are batched tensor ops with int64 masks.

Row layout, width 128 (256 where the flag lanes pass lane 127,
``general_hi_width``), one row per kick slot (step):
lanes [0, L) noise-Z bits n_q, [L, 2L) noise-X mask bits, [2L, 3L) h_q,
[3L, 4L-1) phi_j, then flag lanes from FO = 4L-1:
FO+0 MPOS (forward: the A(t) slot this step's state is measured into, -1
for none), FO+2..9 the slot's 2x2 unitary (``slot_u8``), FO+10 COUNT
(echo, row 0: the pair's step count 2tK). FO+1 stays zero: the reference's
ACTIVE flag (step inside the pair's window) is implied by COUNT here. h and
phi sit on the final slot of a forward cycle only.
"""

from __future__ import annotations

import torch

from dtc_tpu_torch.core.sigma_evolve import _codes_from_uniform, _masks_from_codes
from dtc_tpu_torch.ops.params import WIDE, WIDTH, _bit_lanes
from dtc_tpu_torch.utils.profiling import span

LANE_MPOS, LANE_U8, LANE_COUNT = 0, 2, 10


def flag_base(L: int) -> int:
    """First flag lane, FO = 4L - 1."""
    return 4 * L - 1


def general_hi_width(L: int) -> int:
    """Lanes of a step row at L = L_loc on the streamed lab-frame cycle
    kernels: 128 while the 4L+9 lanes fit, else 256 (L_loc = 30). Copy of
    ``dtc_tpu/ops/pallas_cycle_hi_general.py::general_hi_width``."""
    return WIDTH if 4 * L + 9 <= WIDTH else WIDE


def _check_width(L: int, width: int) -> None:
    if flag_base(L) + LANE_COUNT >= width:
        raise ValueError(f"L={L} leaves no room for the flag lanes in "
                         f"{width} lanes")


def slot_u8(theta_x, theta_y, inverse: bool = False) -> torch.Tensor:
    """(..., 8) f32 entries of RY(ty) @ RX(tx) (or its dagger) in the order
    [00r, 00i, 01r, 01i, 10r, 10i, 11r, 11i]; computed in the angles'
    dtype, then rounded to f32, as the reference does."""
    cx, sx = torch.cos(theta_x / 2), torch.sin(theta_x / 2)
    cy, sy = torch.cos(theta_y / 2), torch.sin(theta_y / 2)
    m00 = (cy * cx, sy * sx)
    m01 = (-sy * cx, -cy * sx)
    m10 = (sy * cx, -cy * sx)
    m11 = (cy * cx, -sy * sx)
    if inverse:  # dagger: conjugate and transpose
        m00, m01, m10, m11 = ((m00[0], -m00[1]), (m10[0], -m10[1]),
                              (m01[0], -m01[1]), (m11[0], -m11[1]))
    return torch.stack([m00[0], m00[1], m01[0], m01[1],
                        m10[0], m10[1], m11[0], m11[1]], dim=-1).to(
                            torch.float32)


KICK_KINDS = ("rx", "ry", "general")


def kick_kind(u8) -> torch.Tensor:
    """The kind of each (..., 8) slot unitary (``slot_u8``'s lanes, f32),
    an index into ``KICK_KINDS``, by the rule of the kernels' ``load_kick``
    (``csrc/floquet_lab.cuh``): RX where the real parts of a01 and a10 and
    the imaginary parts of a00 and a11 are exactly 0, a00 = a11 and
    a01 = a10; else RY where every imaginary part is exactly 0, a00 = a11
    and a01 = -a10; else general."""
    a00r, a00i, a01r, a01i, a10r, a10i, a11r, a11i = torch.as_tensor(
        u8, dtype=torch.float32).unbind(-1)
    diag = a00r == a11r
    rx = ((a01r == 0) & (a10r == 0) & (a00i == 0) & (a11i == 0) & diag
          & (a01i == a10i))
    ry = ((a00i == 0) & (a01i == 0) & (a10i == 0) & (a11i == 0) & diag
          & (a01r == -a10r))
    return torch.where(rx, 0, torch.where(ry, 1, 2))


def _noise_masks(uniforms, p, L, shape, dev):
    """(xm, zm) int64 of the codes drawn from ``uniforms`` (..., L); zeros
    of ``shape`` when p == 0."""
    if p > 0.0:
        return _masks_from_codes(_codes_from_uniform(uniforms, p), L)
    zero = torch.zeros(shape, dtype=torch.int64, device=dev)
    return zero, zero


@span("dtc.feed.general_forward_rows")
def general_forward_rows(uniforms, hs, phis, angles, *, L: int, T: int,
                         K: int, p: float, batch=None,
                         width: int = WIDTH, masks=None,
                         phi_rows=None, h_rows=None) -> torch.Tensor:
    """Per-step rows of the forward kernel, (..., T*K, width) f32.

    uniforms (..., T*K, L) f32, drawn per trajectory as the reference's
    ``uniform(key, (T*K, L))``; hs (..., L) and phis (..., L-1) broadcast
    over the leading dimensions; angles (T, K, 2). With p == 0 the uniforms
    are unused (may be None) and ``batch`` gives the leading shape; width
    128 (K4, K10 on one card, K8) or ``general_hi_width(L)``. The
    reference's device-noise hook: ``masks`` = (zm, xm) int64 (..., T*K)
    replace the sampled events, ``phi_rows`` (..., T*K, L-1) the phi lanes
    and ``h_rows`` (..., T*K, L) the h lanes (already zero off the final
    slots)."""
    _check_width(L, width)
    dev = hs.device
    S = T * K
    if masks is not None:
        zm, xm = masks
        lead = zm.shape[:-1]
    else:
        lead = uniforms.shape[:-2] if uniforms is not None else tuple(batch)
        xm, zm = _noise_masks(uniforms, p, L, (*lead, S), dev)
    u8 = slot_u8(angles[..., 0], angles[..., 1]).reshape(S, 8)
    # the final slot of cycle t < T-1 is measured into A(t+1)
    mpos = torch.full((T, K), -1.0, dtype=torch.float32, device=dev)
    mpos[:T - 1, K - 1] = torch.arange(1, T, dtype=torch.float32, device=dev)
    final = torch.zeros((T, K, 1), dtype=torch.float32, device=dev)
    final[:, K - 1] = 1.0
    final = final.reshape(S, 1)
    flags = torch.zeros((S, width - flag_base(L)), dtype=torch.float32,
                        device=dev)
    flags[:, LANE_MPOS] = mpos.reshape(S)
    flags[:, LANE_U8:LANE_U8 + 8] = u8
    h = (final * hs[..., None, :].to(torch.float32) if h_rows is None
         else h_rows.to(torch.float32))
    ph = (final * phis[..., None, :].to(torch.float32) if phi_rows is None
          else phi_rows.to(torch.float32))
    lead = torch.broadcast_shapes(lead, h.shape[:-2], ph.shape[:-2])
    return torch.cat([_bit_lanes(zm, L).expand(*lead, S, L),
                      _bit_lanes(xm, L).expand(*lead, S, L),
                      h.expand(*lead, S, L), ph.expand(*lead, S, L - 1),
                      flags.expand(*lead, S, flags.shape[-1])], -1)


@span("dtc.feed.general_echo_rows")
def general_echo_rows(uniforms, ts, hs, phis, angles, *, L: int, T: int,
                      K: int, p: float, batch=None,
                      width: int = WIDTH, masks=None,
                      diag_rows=None) -> torch.Tensor:
    """Interleaved (pre, post) step rows for every (trajectory, t) pair,
    (..., n_ts, 4T*K, width) f32.

    uniforms (..., 2T*K, L) f32, one block per trajectory shared by every
    t, as the reference's ``uniform(key, (2T, K, L))``; codes past step 2t
    are zeroed. ts (n_ts,) int; hs, phis, angles, ``batch`` and ``width``
    as in ``general_forward_rows``. Step k of a pair is forward cycle k
    (slots in order) while k < t, then inverse cycle 2t-1-k (slots
    reversed, daggered unitaries); each slot j is one row pair. The pre row carries the kick
    (unitary and X-mask) and, on the first slot of an inverse cycle, the
    inverse diagonal D0* (-h, -phi); the post row the event's Z bits and, on
    the final slot of a forward cycle, D0 (h, phi).

    The reference's device-noise hook: ``masks`` = (xm, zm) int64
    (..., n_ts, 2T, K) replace the sampled events, and ``diag_rows`` =
    (pre_h, pre_phi, post_h, post_phi), (..., n_ts, 2T, L or L-1), replace
    the first slot's pre diagonal and the final slot's post diagonal
    (already signed, and zero off the inverse and forward steps)."""
    _check_width(L, width)
    dev = hs.device
    T2 = 2 * T
    ts = torch.as_tensor(ts, dtype=torch.int64, device=dev)
    n_ts = ts.shape[0]
    kstep = torch.arange(T2, device=dev)
    t_ = ts[:, None]
    fwd = kstep < t_                                            # (n_ts, 2T)
    inv = (kstep >= t_) & (kstep < 2 * t_)
    if masks is not None:
        xm, zm = masks
        lead = xm.shape[:-3]
    elif p > 0.0:
        lead = uniforms.shape[:-2]
        u = uniforms.reshape(*lead, 1, T2, K, L)
        codes = torch.where((fwd | inv)[..., None, None],
                            _codes_from_uniform(u, p), 0)
        xm, zm = _masks_from_codes(codes, L)              # (..., n_ts, 2T, K)
    else:
        lead = uniforms.shape[:-2] if uniforms is not None else tuple(batch)
        xm = zm = torch.zeros((*lead, n_ts, T2, K), dtype=torch.int64,
                              device=dev)
    # cycle of step k: forward k, inverse 2t-1-k; slot j runs slot j
    # forward and slot K-1-j (daggered) inverse
    ci = torch.where(fwd, kstep, torch.clamp(2 * t_ - 1 - kstep, 0, T - 1))
    u8f = slot_u8(angles[..., 0], angles[..., 1])[ci]     # (n_ts, 2T, K, 8)
    u8i = slot_u8(angles[..., 0], angles[..., 1], inverse=True)[ci]
    slot_u = torch.where(fwd[..., None, None], u8f, u8i.flip(-2))
    flags = torch.zeros((n_ts, T2, K, width - flag_base(L)),
                        dtype=torch.float32, device=dev)
    flags[..., LANE_U8:LANE_U8 + 8] = slot_u
    first = (torch.arange(K, device=dev) == 0).to(torch.float32)
    last = (torch.arange(K, device=dev) == K - 1).to(torch.float32)
    pre_d = inv.to(torch.float32)[..., None] * first           # (n_ts, 2T, K)
    post_d = fwd.to(torch.float32)[..., None] * last
    h = hs.to(torch.float32)[..., None, None, None, :]
    ph = phis.to(torch.float32)[..., None, None, None, :]
    shape = torch.broadcast_shapes((*lead, n_ts, T2, K), h.shape[:-1])
    zl = torch.zeros((*shape, L), dtype=torch.float32, device=dev)

    def full(x, lanes):
        return x.expand(*shape, lanes)

    if diag_rows is None:
        pre_h, pre_ph = -pre_d[..., None] * h, -pre_d[..., None] * ph
        post_h, post_ph = post_d[..., None] * h, post_d[..., None] * ph
    else:
        # the given rows sit on the first (pre) and final (post) slot
        pre_h, pre_ph, post_h, post_ph = (
            r.to(torch.float32)[..., None, :] * s[..., None]
            for r, s in zip(diag_rows, (first, first, last, last)))
    pre = torch.cat([zl, full(_bit_lanes(xm, L), L),
                     full(pre_h, L), full(pre_ph, L - 1),
                     full(flags, flags.shape[-1])], -1)
    post = torch.cat([full(_bit_lanes(zm, L), L), zl,
                      full(post_h, L), full(post_ph, L - 1),
                      torch.zeros((*shape, flags.shape[-1]),
                                  dtype=torch.float32, device=dev)], -1)
    tiles = torch.stack([pre, post], dim=-2).reshape(*shape[:-2],
                                                     2 * T2 * K, width)
    tiles[..., 0, flag_base(L) + LANE_COUNT] = (2 * K * ts).to(torch.float32)
    return tiles.contiguous()
