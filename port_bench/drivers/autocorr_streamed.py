"""The autocorrelator study where a state does not fit the L2 cache.

``drivers/autocorr.py``'s study, ``run_autocorr`` as users run it, with two
changes for chains of L >= 23:

- the reference is ``reference/floquet_large.py``'s chain, which holds no
  2^L x L table (``floquet.Chain``'s are 60 GB each at L=28);
- the work adds 16 B an amplitude-step (the state read and written once a
  step) wherever a state of 8 << L bytes exceeds the H100's 50 MB L2. A
  pass that keeps its tile on chip kicks at most about log2(50 MB / 8 B) =
  22 qubits, so at L=28 every implementation streams the whole state
  through HBM at least once a step; below, the state stays in the L2 and
  the count is ``drivers/autocorr.py``'s.
"""

from __future__ import annotations

import numpy as np
import torch

from port_bench.drivers.autocorr import AutocorrStudy
from port_bench.reference import floquet, floquet_large
from port_bench.study import initial_index, noise_p

L2_BYTES = 50e6  # H100 SXM, published


def state_floor_bytes(L: int, amp_steps: int) -> int:
    """The least state traffic of ``amp_steps`` amplitude-steps: 16 B each
    where a complex64 state of 2^L amplitudes exceeds the L2, else none."""
    return 16 * amp_steps if (8 << L) > L2_BYTES else 0


class StreamedAutocorrStudy(AutocorrStudy):
    def __init__(self, cfg, traffic, seed, device):
        super().__init__(cfg, traffic, seed, device)
        self.work["io_bytes"] += state_floor_bytes(cfg["L"],
                                                   self.work["amp_steps"])

    def reference(self, inp, real):
        """Every forward A(t) and every echo A0(t), t < T."""
        cfg = self.cfg
        _, hs, phis, u_fwd, u_echo = inp
        p, T = noise_p(cfg), cfg["tf"]
        kw = dict(p=p, q=cfg["q"], b0=initial_index(cfg),
                  af=(1 - p) ** 6 if p > 0 else 1.0)
        chain = floquet_large.Chain(hs, phis, L=cfg["L"],
                                    polarization=cfg["polarization"],
                                    g=cfg["g"], T=T, real=real,
                                    device=self.dev)
        fwd = floquet.forward_autocorr(chain, u_fwd, **kw)
        if p == 0:
            return {"forward": fwd, "echo": np.ones_like(fwd)}
        return {"forward": fwd, "echo": floquet.echo_autocorr(
            chain, u_echo, range(T), **kw)}


def prepare(cfg, traffic, seed, device) -> StreamedAutocorrStudy:
    return StreamedAutocorrStudy(cfg, traffic, seed, torch.device(device))
