"""The energy study: ``run_energy``, E(t)/L and every <Z_q(t)> per noise level.

A call is one study: ``inst`` disorder instances of its own, one block of
uniforms shared by every noise level of ``nprobs``, ``n_trajectories``
trajectories at each p > 0 and one at p = 0. Counted: T cycles a
trajectory and level.
"""

from __future__ import annotations

import numpy as np
import torch

from port_bench import inputs, roofline
from port_bench.reference import floquet
from port_bench.study import WARM_CALL, initial_index, sim_config, slots


def _column(p: float) -> str:
    return f"energy_p_{int(p) if p == int(p) else p}"


class EnergyStudy:
    def __init__(self, cfg, traffic, seed, device):
        from dtc_tpu_torch.experiments.energy import run_energy

        self._run = run_energy
        self.cfg, self.traffic = cfg, traffic
        self.seed, self.dev = seed, device
        self.draws = inputs.Draws(seed, device)
        self.sim = sim_config(cfg, traffic)
        self.nprobs = tuple(float(p) for p in traffic["nprobs"])
        self.K = len(slots(cfg))
        L, T, inst, n = cfg["L"], cfg["tf"], traffic["inst"], \
            traffic["n_trajectories"]
        per_level = [n if p > 0 else 1 for p in self.nprobs]
        self.cycles_per_call = inst * T * sum(per_level)
        self.work = dict(
            io_bytes=4 * inst * n * T * self.K * L
            + 8 * inst * len(self.nprobs) * T * (L + 1),
            amp_steps=inst * (T - 1) * sum(per_level) << L,
            flops_per_amp_step=roofline.cycle_flops(L, slots(cfg)),
            extra_ops=(inst * T * sum(per_level) << L)
            * roofline.measure_flops(L))

    def inputs(self, i, T=None):
        cfg, tr = self.cfg, self.traffic
        T = T or cfg["tf"]
        hs, phis = inputs.disorder(cfg, tr["inst"], self.seed, i)
        shape = (tr["inst"], tr["n_trajectories"], T * self.K, cfg["L"])
        return i, hs, phis, self.draws.uniforms(shape, i, inputs.FORWARD,
                                                i == WARM_CALL)

    def call(self, inp, sim=None):
        _, hs, phis, u = inp
        r = self._run(sim or self.sim, hs, phis, nprobs=self.nprobs,
                      device=self.dev, write=False, uniforms=u)
        return {"energy": np.stack([r[_column(p)] for p in self.nprobs]),
                "z": np.stack([r["per_qubit_z"][p] for p in self.nprobs])}

    def warm(self):
        T = self.traffic.get("warm_tf") or self.cfg["tf"]
        self.call(self.inputs(WARM_CALL, T), self.sim.replace(tf=T))

    def close(self):
        self.sim = None

    def reference(self, inp, real):
        cfg = self.cfg
        _, hs, phis, u = inp
        L = cfg["L"]
        chain = floquet.Chain(hs, phis, L=L, polarization=cfg["polarization"],
                              g=cfg["g"], T=cfg["tf"], real=real,
                              device=self.dev)
        levels = [floquet.energy_trace(chain, u, p=p, b0=initial_index(cfg))
                  for p in self.nprobs]
        return {"energy": np.stack([e.mean(0) / L for e, _ in levels]),
                "z": np.stack([z.mean(0) for _, z in levels])}


def prepare(cfg, traffic, seed, device) -> EnergyStudy:
    return EnergyStudy(cfg, traffic, seed, torch.device(device))
