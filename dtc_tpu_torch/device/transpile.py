"""Logical gate counts and depth of the exported circuits.

Port of ``dtc_tpu/device/transpile.py`` (``gate_counts``, ``circuit_depth``,
``noisy_1q_gate_events``, ``write_gate_count_csv``), pure Python on the
port's ``models/drives.n_kick_slots``. The circuits are applied as logical
gates, so the counts are closed forms in the Aer basis {u3, u2, rz, cx,
measure}:

  L=4, t=1, forward:  u3=4 (kicks) rz=7 (3 rzz + 4 rz) cx=8 (2 cz + 2*3 rzz)
                      u2=6 (H + two CZ -> h-cx-h decompositions) measure=1
  L=4, t=1, echo:     u3=8 rz=14 cx=14 u2=6
"""

from __future__ import annotations

from dtc_tpu_torch.io import csvio
from dtc_tpu_torch.models.drives import n_kick_slots


def gate_counts(L: int, t: int, *, echo: bool = False, polarization: str = "x",
                interferometric: bool = True) -> dict:
    """Aer-basis gate counts for the circuit at time t."""
    slots = n_kick_slots(polarization)
    cycles = 2 * t if echo else t
    counts = {
        "u3": slots * L * cycles,
        "rz": cycles * ((L - 1) + L),          # rzz angles + disorder rz
        "cx": 2 * (L - 1) * cycles,            # rzz decompositions
    }
    if interferometric:
        counts["u2"] = 6                        # H + 2x (CZ -> h cx h)
        counts["cx"] += 2                       # the CZs' cx cores
        counts["measure"] = 1
    return {k: v for k, v in counts.items() if v}


def circuit_depth(L: int, t: int, *, echo: bool = False,
                  polarization: str = "x", interferometric: bool = True) -> int:
    """Logical depth: per cycle = K kick layers + 2 RZZ layers + 1 RZ layer."""
    slots = n_kick_slots(polarization)
    per_cycle = slots + 3
    cycles = 2 * t if echo else t
    d = per_cycle * cycles
    if interferometric:
        d += 6  # h, (h cx h), ... boundary layers
    return d


def noisy_1q_gate_events(L: int, t: int, *, echo: bool = False,
                         polarization: str = "x",
                         interferometric: bool = True) -> int:
    """Number of depolarizing events Aer fires (errors attach to u1/u2/u3):
    the quantity that fixes the total noise strength."""
    c = gate_counts(L, t, echo=echo, polarization=polarization,
                    interferometric=interferometric)
    return c.get("u3", 0) + c.get("u2", 0) + c.get("u1", 0)


def write_gate_count_csv(path: str, L: int, t: int, **kw):
    """gate,count CSV in the reference artifact format."""
    c = gate_counts(L, t, **kw)
    csvio.write_columns(path, {"gate": list(c), "count": list(c.values())})
    return path
