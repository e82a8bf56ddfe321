"""One forward dispatch at a time: ``engine.forward_sweep``, the bench shape.

The run's disorder and the sweep's context (kick schedule, parameter
tensors) are built once in set-up, as the bench and the adaptive loops hold
them; a call is one trajectory-averaged A(t) of ``n_trajectories`` fresh
trajectories, on the host. No echo. Counted: T cycles a trajectory.
"""

from __future__ import annotations

import torch

from port_bench import inputs, roofline
from port_bench.reference import floquet
from port_bench.study import WARM_CALL, initial_index, noise_p, sim_config, \
    slots


class ForwardStudy:
    def __init__(self, cfg, traffic, seed, device):
        from dtc_tpu_torch.experiments.engine import build_context, \
            forward_sweep

        self._sweep = forward_sweep
        self.cfg, self.traffic = cfg, traffic
        self.seed, self.dev = seed, device
        self.draws = inputs.Draws(seed, device)
        self.sim = sim_config(cfg, traffic)
        self.hs, self.phis = inputs.disorder(cfg, traffic["inst"], seed, 0)
        self.ctx = build_context(self.sim, self.hs, self.phis, device=device)
        self.K = len(slots(cfg))
        L, T, inst, n = cfg["L"], cfg["tf"], traffic["inst"], \
            traffic["n_trajectories"]
        self.cycles_per_call = inst * n * T
        self.work = dict(
            io_bytes=4 * inst * n * T * self.K * L + 8 * inst * T,
            amp_steps=inst * n * (T - 1) << L,
            flops_per_amp_step=roofline.cycle_flops(L, slots(cfg)))

    def inputs(self, i):
        cfg, tr = self.cfg, self.traffic
        shape = (tr["inst"], tr["n_trajectories"], cfg["tf"] * self.K,
                 cfg["L"])
        return self.draws.uniforms(shape, i, inputs.FORWARD, i == WARM_CALL)

    def call(self, u):
        return {"forward": self._sweep(self.sim, *self.ctx, uniforms=u)}

    def warm(self):
        self.call(self.inputs(WARM_CALL))

    def close(self):
        self.ctx = None

    def reference(self, u, real):
        cfg = self.cfg
        p = noise_p(cfg)
        chain = floquet.Chain(self.hs, self.phis, L=cfg["L"],
                              polarization=cfg["polarization"], g=cfg["g"],
                              T=cfg["tf"], real=real, device=self.dev)
        return {"forward": floquet.forward_autocorr(
            chain, u, p=p, q=cfg["q"], b0=initial_index(cfg),
            af=(1 - p) ** 6 if p > 0 else 1.0)}


def prepare(cfg, traffic, seed, device) -> ForwardStudy:
    return ForwardStudy(cfg, traffic, seed, torch.device(device))
