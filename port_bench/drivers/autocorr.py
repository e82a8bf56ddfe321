"""The autocorrelator study: ``run_autocorr``, the program's main path.

A call is one study, as a user runs it: ``inst`` disorder instances of its
own, ``n_trajectories`` Pauli-twirl trajectories each, the forward A(t) and
the echo A0(t) for every t < tf, and the per-instance answers on the host.
Counted: T cycles a forward trajectory and 2t for each echo t < T.
"""

from __future__ import annotations

import numpy as np
import torch

from port_bench import inputs, roofline
from port_bench.reference import floquet
from port_bench.study import (
    WARM_CALL,
    echo_cycles,
    initial_index,
    noise_p,
    sim_config,
    slots,
)


class AutocorrStudy:
    def __init__(self, cfg, traffic, seed, device):
        from dtc_tpu_torch.experiments.autocorr import run_autocorr

        self._run = run_autocorr
        self.cfg, self.traffic = cfg, traffic
        self.seed, self.dev = seed, device
        self.draws = inputs.Draws(seed, device)
        self.sim = sim_config(cfg, traffic)
        self.K = len(slots(cfg))
        L, T, inst, n = cfg["L"], cfg["tf"], traffic["inst"], \
            traffic["n_trajectories"]
        self.cycles_per_call = inst * n * (T + echo_cycles(T))
        amp_cycles = inst * n * ((T - 1) + echo_cycles(T)) << L
        self.work = dict(
            io_bytes=4 * inst * n * 3 * T * self.K * L + 16 * inst * T,
            amp_steps=amp_cycles,
            flops_per_amp_step=roofline.cycle_flops(L, slots(cfg)))

    def inputs(self, i, T=None):
        cfg, tr = self.cfg, self.traffic
        T = T or cfg["tf"]
        shape = (tr["inst"], tr["n_trajectories"], T * self.K, cfg["L"])
        hs, phis = inputs.disorder(cfg, tr["inst"], self.seed, i)
        warm = i == WARM_CALL
        u_fwd = self.draws.uniforms(shape, i, inputs.FORWARD, warm)
        shape = shape[:2] + (2 * T * self.K, cfg["L"])
        u_echo = self.draws.uniforms(shape, i, inputs.ECHO, warm)
        return i, hs, phis, u_fwd, u_echo

    def call(self, inp, sim=None):
        _, hs, phis, u_fwd, u_echo = inp
        r = self._run(sim or self.sim, hs, phis, device=self.dev, write=False,
                      uniforms=(u_fwd, u_echo))
        return {"forward": r["autocorr_per_instance"],
                "echo": r["echo_per_instance"]}

    def warm(self):
        T = self.traffic.get("warm_tf") or self.cfg["tf"]
        self.call(self.inputs(WARM_CALL, T), self.sim.replace(tf=T))

    def close(self):
        self.sim = None

    def reference(self, inp, real):
        """Every forward A(t) and every echo A0(t), t < T."""
        cfg = self.cfg
        _, hs, phis, u_fwd, u_echo = inp
        p, T = noise_p(cfg), cfg["tf"]
        kw = dict(p=p, q=cfg["q"], b0=initial_index(cfg),
                  af=(1 - p) ** 6 if p > 0 else 1.0)
        chain = floquet.Chain(hs, phis, L=cfg["L"],
                              polarization=cfg["polarization"], g=cfg["g"],
                              T=T, real=real, device=self.dev)
        fwd = floquet.forward_autocorr(chain, u_fwd, **kw)
        if p == 0:
            return {"forward": fwd, "echo": np.ones_like(fwd)}
        return {"forward": fwd, "echo": floquet.echo_autocorr(
            chain, u_echo, range(T), **kw)}


def prepare(cfg, traffic, seed, device) -> AutocorrStudy:
    return AutocorrStudy(cfg, traffic, seed, torch.device(device))
