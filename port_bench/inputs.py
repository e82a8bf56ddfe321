"""The inputs of a call, made from the run's seed and the call's index.

Call i of a run with seed s gets its own disorder, drawn from (s, i), and
its own uniforms: the next block of one device generator a kind of draw,
seeded once in set-up from s. The generator's state at each call's draw is
kept, so the reference can make the inputs of any call of the window again
once it has closed, and a call's draw in the window is one launch. Disorder
follows the upstream study's distributions: h ~ U[-pi, pi] (inst, L) and,
with randomphi=1, phi ~ U[0, amplitude pi) - 1.5 pi + delta pi (inst, L-1),
else phi = -0.4. Uniforms are f32 U(0, 1), drawn on the device.
"""

from __future__ import annotations

import numpy as np
import torch

DISORDER, FORWARD, ECHO = 0, 1, 2  # kinds of draws


def stream(seed: int, i: int, kind: int) -> np.random.SeedSequence:
    """The seed sequence of call i's draws of one kind."""
    return np.random.SeedSequence([seed % (1 << 64), i, kind])


def disorder(cfg: dict, inst: int, seed: int, i: int):
    """(hs (inst, L), phis (inst, L-1)) float64 numpy."""
    rng = np.random.default_rng(stream(seed, i, DISORDER))
    L = cfg["L"]
    hs = rng.uniform(-np.pi, np.pi, size=(inst, L))
    if cfg["randomphi"] == 1:
        phis = (rng.uniform(0.0, cfg["phi_amplitude"] * np.pi,
                            size=(inst, L - 1))
                - 1.5 * np.pi + cfg["phi_delta"] * np.pi)
    else:
        phis = np.full((inst, L - 1), -0.4)
    return hs, phis


class Draws:
    """The uniforms of a run's calls: one generator on ``device`` for each
    kind of draw, and another for set-up's warm-up (``warm``), each seeded
    once from the run's seed."""

    def __init__(self, seed: int, device):
        self.seed, self.dev = seed, device
        self._gens: dict = {}
        self._at: dict = {}  # (kind, call) -> generator state at its draw

    def _gen(self, kind: int, warm: bool) -> torch.Generator:
        key = (kind, warm)
        if key not in self._gens:
            ss = np.random.SeedSequence([self.seed % (1 << 64), kind,
                                         int(warm)])
            word = ss.generate_state(1, np.uint64)[0]
            self._gens[key] = torch.Generator(device=self.dev).manual_seed(
                int(word >> np.uint64(1)))
        return self._gens[key]

    def uniforms(self, shape, i: int, kind: int,
                 warm: bool = False) -> torch.Tensor:
        """f32 U(0, 1) block of ``shape``: call i's of this kind, the same
        block each time it is asked for."""
        gen = self._gen(kind, warm)
        at = self._at.get((kind, i))
        if at is None:
            self._at[(kind, i)] = gen.get_state()
            return torch.rand(shape, generator=gen, dtype=torch.float32,
                              device=self.dev)
        now = gen.get_state()
        gen.set_state(at)
        try:
            return torch.rand(shape, generator=gen, dtype=torch.float32,
                              device=self.dev)
        finally:
            gen.set_state(now)
