"""Measurement-level observables: counts sampling and expectations.

Port of ``dtc_tpu/observables.py`` (``sample_counts``,
``counts_from_z_probability``, and ``counts_to_z_expectation`` re-exported
from ``device/jobs.py``). Expectations are analytic by default; these give
the counts-level semantics of a hardware run (the shots study, the job
records of the campaign).

``sample_counts`` samples on the device that holds the probabilities, by
inverse CDF: a float64 cumulative sum and ``torch.searchsorted`` of uniform
draws, over any number of basis states (``torch.multinomial`` takes at most
2^24 categories). It cannot reproduce ``jax.random.categorical``'s stream,
so it matches the reference in distribution only.
"""

from __future__ import annotations

import numpy as np
import torch

from dtc_tpu_torch.device.jobs import counts_to_z_expectation  # re-export  # noqa: F401


def sample_counts(probs, shots: int, *, n_qubits: int, seed: int = 0,
                  generator: torch.Generator | None = None) -> dict:
    """Sample a counts histogram {little-endian bitstring: count} from a
    probability vector over 2**n_qubits basis states (normalized here,
    negative entries read as 0), on the device that holds ``probs``; the
    draws come from ``generator``, else from one seeded with ``seed``."""
    cdf = torch.cumsum(torch.as_tensor(probs).to(torch.float64).clamp_min(0.0),
                       dim=0)
    if generator is None:
        generator = torch.Generator(device=cdf.device).manual_seed(seed)
    u = torch.rand(shots, generator=generator, dtype=torch.float64,
                   device=cdf.device) * cdf[-1]
    idx = torch.searchsorted(cdf, u, right=True).clamp_max_(cdf.numel() - 1)
    vals, cnt = torch.unique(idx, return_counts=True)
    return {format(v, f"0{n_qubits}b"): c
            for v, c in zip(vals.tolist(), cnt.tolist())}


def counts_from_z_probability(a_value: float, shots: int, seed: int = 0) -> dict:
    """Single-qubit counts for an ancilla measurement with <Z> = a_value."""
    rng = np.random.default_rng(seed)
    p0 = float(np.clip((1.0 + a_value) / 2.0, 0.0, 1.0))
    n0 = int(rng.binomial(shots, p0))
    return {"0": n0, "1": shots - n0}
