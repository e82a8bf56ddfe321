"""Kicked-Ising kick-layer schedules for every polarization family.

Port of ``dtc_tpu/models/drives.py`` (``KickSchedule``,
``build_kick_schedule``, ``slot_unitary``, ``slot_unitary_inverse``,
``n_kick_slots``). One Floquet cycle applies K kick slots, each
RY(theta_y) @ RX(theta_x); the schedule is a dense (T, K, 2) angle tensor.
Angles default to float64, as the reference builds them with x64 enabled.
"""

from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class KickSchedule:
    """Per-cycle kick-slot angles: ``angles[t, k] = (theta_x, theta_y)``."""

    angles: torch.Tensor

    @property
    def K(self) -> int:
        return self.angles.shape[1]


def n_kick_slots(polarization: str) -> int:
    return 1 if polarization in ("x", "y", "xy_cycle") else 2


def build_kick_schedule(polarization: str, g, T: int, *,
                        circular_frequency: float = 0.5,
                        xy_cycle_period: int = 5,
                        dtype=torch.float64, device=None) -> KickSchedule:
    """Build the (T, K, 2) kick-angle schedule; ``g`` is a scalar or a
    length-T vector (time-dependent drive)."""
    g = torch.as_tensor(g, dtype=dtype, device=device).broadcast_to((T,))
    t = torch.arange(T, dtype=dtype, device=device)
    zeros = torch.zeros(T, dtype=dtype, device=device)
    pi = math.pi
    r2 = math.sqrt(2)

    if polarization == "x":
        slots = [(pi * g, zeros)]
    elif polarization == "y":
        slots = [(zeros, pi * g)]
    elif polarization == "xy":
        slots = [(pi * g / 2, zeros), (zeros, pi * g / 2)]
    elif polarization == "yx":
        slots = [(zeros, pi * g / 2), (pi * g / 2, zeros)]
    elif polarization == "circular_left":
        w = circular_frequency
        slots = [(pi * g * torch.cos(w * t) / r2, zeros),
                 (zeros, pi * g * torch.sin(w * t) / r2)]
    elif polarization == "circular_right":
        w = circular_frequency
        slots = [(pi * g * torch.cos(w * t) / r2, zeros),
                 (zeros, -pi * g * torch.sin(w * t) / r2)]
    elif polarization == "circular_static":
        slots = [(pi * g / r2, zeros), (zeros, pi * g / r2)]
    elif polarization == "xy_cycle":
        use_x = ((torch.arange(T, device=device) // xy_cycle_period) % 2) == 0
        slots = [(torch.where(use_x, pi * g, zeros),
                  torch.where(use_x, zeros, pi * g))]
    else:
        raise ValueError(f"unknown polarization {polarization!r}")

    angles = torch.stack([torch.stack(s, dim=-1) for s in slots], dim=1)
    return KickSchedule(angles=angles)


def _angle(x) -> torch.Tensor:
    """Python angles become float64 tensors (the reference's x64 scalars)."""
    return x if torch.is_tensor(x) else torch.as_tensor(x, dtype=torch.float64)


def slot_unitary(theta_x, theta_y, dtype=torch.complex64) -> torch.Tensor:
    """(..., 2, 2) unitary RY(theta_y) @ RX(theta_x) in closed form; the
    angles may carry leading batch dimensions."""
    theta_x = _angle(theta_x)
    theta_y = _angle(theta_y)
    cx, sx = torch.cos(theta_x / 2), torch.sin(theta_x / 2)
    cy, sy = torch.cos(theta_y / 2), torch.sin(theta_y / 2)
    m00 = torch.complex(cy * cx, sy * sx)
    m01 = torch.complex(-sy * cx, -(cy * sx))
    m10 = torch.complex(sy * cx, -(cy * sx))
    m11 = torch.complex(cy * cx, -(sy * sx))
    u = torch.stack([torch.stack([m00, m01], -1), torch.stack([m10, m11], -1)],
                    -2)
    return u.to(dtype)


def slot_unitary_inverse(theta_x, theta_y, dtype=torch.complex64) -> torch.Tensor:
    """(RY(ty) RX(tx))^-1 = its conjugate transpose."""
    u = slot_unitary(theta_x, theta_y, dtype)
    return u.conj().transpose(-1, -2).resolve_conj()
