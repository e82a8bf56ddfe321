"""One dataclass config covering the shared CLI vocabulary.

A copy of ``dtc_tpu/utils/config.py`` (``SimConfig``): the port imports
nothing of the JAX package. Field names, defaults and properties are the
reference's, so file names encoded from a config match byte for byte
(``tests/test_torch_io.py`` checks the defaults).
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class SimConfig:
    # Chain / drive
    L: int = 4
    g: float = 0.97
    inst: int = 1
    randomphi: int = 1          # 0 = prethermal (phi=-0.4 fixed), 1 = DTC
    phi_delta: float = 0.0
    phi_amplitude: float = 1.0
    tf: int = 50
    initial_state: str = "vacuum"   # "vacuum" | "neel"
    polarization: str = "x"     # x|y|xy|yx|circular_left|circular_right|circular_static|xy_cycle
    circular_frequency: float = 0.5
    xy_cycle_period: int = 5    # kick axis flips every this many cycles ("xy_cycle")

    # Noise
    noise_prob: float = 0.05
    use_noise: int = 1
    use_fakebackend: int = 0    # device-noise mode
    fake_device: str = "brisbane"  # "brisbane" | "garnet"
    calibration_path: Optional[str] = None
    n_trajectories: int = 256   # Pauli-twirl trajectories per instance
    shots: int = 0              # 0 = analytic expectation; >0 = Bernoulli shot sampling
    estimator_shots: int = 0    # 0 = exact estimator; >0 = gaussian sampling noise
    seed: int = 0

    # Adaptive-g control
    target_echo: float = 1.0
    feedback_gain: float = 0.01
    exponential_feedback: int = 1
    decay_compensation: float = 0.1
    g_min: float = 0.84
    g_max: float = 1.0
    use_optimization: int = 1
    optimization_iterations: int = 5

    # Engine
    ancilla_faithful: bool = False  # literal Hadamard-test ancilla (validation mode)
    dtype: str = "complex64"
    qubit: Optional[int] = None     # autocorrelator site; default L//2

    @property
    def probe_qubit(self) -> int:
        # qubit = int(L/2) in system labels 1..L -> 0-indexed L//2
        return self.L // 2 if self.qubit is None else self.qubit

    @property
    def T(self) -> int:
        return self.tf

    @property
    def noise_p(self) -> float:
        return self.noise_prob if self.use_noise else 0.0

    def replace(self, **kw) -> "SimConfig":
        return dataclasses.replace(self, **kw)
