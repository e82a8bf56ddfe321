"""Per-cycle noise factor of the planar engine (kernel K11).

Port of ``dtc_tpu/ops/pallas_noise.py`` (``pack_cycle_params``,
``apply_noise_factor``). The Pallas kernel becomes the hand-written CUDA
kernel of ``csrc/noise_factor.cu``, which multiplies two per-block phase
tables (the low qubits', and one phase a row of the high qubits') in place
of an angle sum and a sincos per amplitude; beside it is its plain PyTorch
version ``noise_factor_plain``, which computes the same function with
tensor ops, as the reference does.

For each global index s of a state's (re, im) f32 planes:

    factor(s) = (-1)^popcount(s & zm) * exp(i A(s)),
    A(s) = sum_q sigma_q h_q z_q(s) + sum_b flip_b phi_b z_b(s) z_{b+1}(s),

the sampled Pauli string's Z-sign times the sigma-frame correction of the
cycle's diagonal (``core/planar_evolve.py``). The angle is accumulated in q
order, then one sincos, then the complex multiply. The cycle's inputs are
one (8, 128) f32 tile: rows [zm bits, sigma bits, bond flips, h, phi, 0, 0,
0]. Unlike the reference, which maps one state per call, an entry takes a
batch: states (B, 2, 2^L) with one tile per state, and any L >= 1 (the
reference's ``N < 128`` branch is a TPU tiling detail). A CPU tensor takes
the plain version; a CUDA tensor launches the kernel or raises. Each call
is the span ``dtc.entry.K11``, counted in the launch registry of
``utils/profiling.py``.
"""

from __future__ import annotations

import torch

from dtc_tpu_torch.ops.resident_blocked import check_cuda_input, raise_on
from dtc_tpu_torch.utils.profiling import entry

LANES = 128
MAX_L = 30
PLAIN_CHUNK = 1 << 24


def _bit_rows(mask: torch.Tensor) -> torch.Tensor:
    """(...,) int64 masks -> (..., 128) f32 bits; lanes past 31 are 0, as the
    reference's uint32 shifts give."""
    sh = torch.arange(32, dtype=torch.int64, device=mask.device)
    bits = ((mask[..., None] >> sh) & 1).to(torch.float32)
    pad = torch.zeros((*mask.shape, LANES - 32), dtype=torch.float32,
                      device=mask.device)
    return torch.cat([bits, pad], -1)


def pack_cycle_params(zm, sigma, hs, phis, L: int) -> torch.Tensor:
    """(..., 8, 128) f32 tiles from int64 masks zm, sigma (...) and angles
    hs (..., L), phis (..., L-1); the leading dimensions broadcast (the
    reference packs one cycle of one trajectory per call)."""
    dev = hs.device
    zm = torch.as_tensor(zm, dtype=torch.int64, device=dev)
    sigma = torch.as_tensor(sigma, dtype=torch.int64, device=dev)
    batch = torch.broadcast_shapes(zm.shape, sigma.shape, hs.shape[:-1],
                                   phis.shape[:-1])
    zmb = _bit_rows(zm).expand(*batch, LANES)
    sgb = _bit_rows(sigma).expand(*batch, LANES)
    zeros = torch.zeros((*batch, LANES), dtype=torch.float32, device=dev)
    flip = zeros.clone()
    flip[..., :L - 1] = (sgb[..., :L - 1] - sgb[..., 1:L]).abs()
    hrow = zeros.clone()
    hrow[..., :L] = hs.to(torch.float32)
    prow = zeros.clone()
    prow[..., :L - 1] = phis.to(torch.float32)
    pad = torch.zeros((*batch, 3, LANES), dtype=torch.float32, device=dev)
    return torch.cat([torch.stack([zmb, sgb, flip, hrow, prow], -2), pad],
                     -2)


def _check(state, params, L):
    if not 1 <= L <= MAX_L:
        raise ValueError(f"noise factor supports 1 <= L <= {MAX_L} (got {L})")
    if state.dim() != 3 or state.shape[1] != 2 or state.shape[2] != 1 << L:
        raise ValueError(f"state must be (B, 2, 2^{L}) (got "
                         f"{tuple(state.shape)})")
    if tuple(params.shape) != (state.shape[0], 8, LANES):
        raise ValueError(f"params must be ({state.shape[0]}, 8, {LANES}) "
                         f"(got {tuple(params.shape)})")


@entry("K11", plain=True)
def noise_factor_plain(state, params, *, L: int) -> torch.Tensor:
    """Plain version of ``apply_noise_factor``: a new (B, 2, 2^L) tensor,
    computed over chunks of at most 2^24 amplitudes (to bound the
    temporaries at L = 30)."""
    _check(state, params, L)
    dev = state.device
    par = params.to(torch.float32)
    out = torch.empty_like(state)
    N = 1 << L
    for lo in range(0, N, PLAIN_CHUNK):
        s = torch.arange(lo, min(lo + PLAIN_CHUNK, N), dtype=torch.int64,
                         device=dev)
        zpar = torch.zeros((state.shape[0], s.shape[0]), dtype=torch.float32,
                           device=dev)
        ang = torch.zeros_like(zpar)
        prev_z = None
        for q in range(L):
            bit = ((s >> q) & 1).to(torch.float32)
            z = 1.0 - 2.0 * bit
            zpar = zpar + bit * par[:, 0, q:q + 1]
            ang = ang + (par[:, 1, q:q + 1] * par[:, 3, q:q + 1]) * z
            if q > 0:
                ang = ang + ((par[:, 2, q - 1:q] * par[:, 4, q - 1:q])
                             * (prev_z * z))
            prev_z = z
        sign = 1.0 - 2.0 * torch.remainder(zpar, 2.0)
        fr = sign * torch.cos(ang)
        fi = sign * torch.sin(ang)
        re = state[:, 0, lo:lo + s.shape[0]]
        im = state[:, 1, lo:lo + s.shape[0]]
        out[:, 0, lo:lo + s.shape[0]] = re * fr - im * fi
        out[:, 1, lo:lo + s.shape[0]] = re * fi + im * fr
    return out


@entry("K11")
def apply_noise_factor(state, params, *, L: int) -> torch.Tensor:
    """Multiply each state (B, 2, 2^L) f32 by its cycle's factor; params
    (B, 8, 128) from ``pack_cycle_params``. A CPU tensor returns the plain
    version's new tensor; on a CUDA tensor kernel K11 writes the product in
    place of ``state`` and returns it."""
    if state.device.type == "cpu":
        return noise_factor_plain(state, params, L=L)
    if state.device.type != "cuda":
        raise ValueError(f"no noise factor kernel for device {state.device}")
    _check(state, params, L)
    check_cuda_input("state", state, 3, 1 << L)
    check_cuda_input("params", params, 3, LANES)
    if params.device != state.device:
        raise ValueError("params and state must be on the same device")
    n = state.shape[0]
    if not 1 <= n <= 65535:
        raise ValueError(f"noise factor batch of {n} outside [1, 65535]")
    if state.data_ptr() % 16:
        raise ValueError("state must be 16-byte aligned")
    from dtc_tpu_torch.ops import _build

    lib = _build.load("noise_factor")
    stream = torch.cuda.current_stream(state.device).cuda_stream
    err = lib.noise_factor_apply(state.data_ptr(), params.data_ptr(), n, L,
                                 stream)
    raise_on(err, "noise_factor_apply")
    return state
