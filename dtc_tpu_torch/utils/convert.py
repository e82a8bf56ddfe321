"""Carry the JAX reference's inputs over to the port.

Torch cannot reproduce JAX's threefry stream, so trajectory-exact
comparisons hand both sides the same numbers: the reference's disorder,
kick schedule and per-trajectory uniforms, as numpy arrays.
"""

from __future__ import annotations

import numpy as np
import torch


def _tensor(x, dtype, device):
    return torch.as_tensor(np.array(x, copy=True), dtype=dtype, device=device)


def from_reference(hs, phis, angles, uniforms=None, *, device="cpu",
                   dtype=torch.float64):
    """(hs (inst, L), phis (inst, L-1), angles (T, K, 2)[, uniforms]) as
    the port's tensors: angles and disorder in ``dtype``, uniforms in f32.

    ``uniforms`` is one block or a tuple of blocks (e.g. forward and echo):
    forward (inst, n_traj, T*K, L), echo (inst, n_traj, 2T*K, L), laid out
    as the reference draws them per trajectory key. Returns
    (hs, phis, angles, uniforms) with uniforms None, a tensor or a tuple."""
    out_u = None
    if isinstance(uniforms, (tuple, list)):
        out_u = tuple(_tensor(u, torch.float32, device) for u in uniforms)
    elif uniforms is not None:
        out_u = _tensor(uniforms, torch.float32, device)
    return (_tensor(hs, dtype, device), _tensor(phis, dtype, device),
            _tensor(angles, dtype, device), out_u)
