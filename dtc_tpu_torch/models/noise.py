"""Aer-equivalent depolarizing noise specification.

Port of ``dtc_tpu/models/noise.py`` (``NoiseSpec``). It is a copy rather
than a re-export: importing ``dtc_tpu.models.noise`` loads jax through
``dtc_tpu/models/__init__.py``. Depolarizing p on every kick u3 (one event
per qubit per slot); the six noisy ancilla u2 gates of the interferometer
contract the measured coherence by the analytic factor (1-p)^6.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class NoiseSpec:
    """Depolarizing-on-1q-gates noise with Aer-faithful placement."""

    p: float = 0.0
    ancilla_u2_events: int = 6

    @property
    def ancilla_factor(self) -> float:
        return (1.0 - self.p) ** self.ancilla_u2_events
