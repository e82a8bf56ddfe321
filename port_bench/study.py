"""What every driver shares: the program's config from a cell's files, the
work a call counts, and the comparison of two answers.

A driver (``drivers/<name>.py``, named by the traffic file) has one
function, ``prepare(cfg, traffic, seed, device)``, that returns a study
with these members:

- ``cycles_per_call``: the trajectory Floquet cycles a call counts;
- ``work``: the work of one call for ``roofline.bound``, as keyword
  arguments (``io_bytes``, ``amp_steps``, ``flops_per_amp_step``,
  ``extra_ops``);
- ``inputs(i)``: the inputs of call i, made again the same from the seed;
- ``call(inputs)``: the program's answer, a dict of numpy arrays;
- ``warm()``: set-up's warm-up of every entry and size the calls use;
- ``close()``: drops the program's state before the reference runs;
- ``reference(inputs, real)``: the plain reference's answer, the same keys,
  its state in ``real`` (torch.float32; torch.bfloat16 for the control).
"""

from __future__ import annotations

import numpy as np

from port_bench.reference import floquet

WARM_CALL = 1 << 40  # the call index of set-up's warm-up inputs


def sim_config(cfg: dict, traffic: dict, **over):
    """The program's SimConfig of a configuration file and a traffic mix."""
    from dtc_tpu_torch.utils.config import SimConfig

    fields = dict(L=cfg["L"], g=cfg["g"], polarization=cfg["polarization"],
                  noise_prob=cfg["noise_prob"], use_noise=cfg["use_noise"],
                  randomphi=cfg["randomphi"],
                  phi_amplitude=cfg["phi_amplitude"],
                  phi_delta=cfg["phi_delta"], tf=cfg["tf"],
                  initial_state=cfg["initial_state"], qubit=cfg["q"],
                  dtype=cfg["dtype"], inst=traffic["inst"],
                  n_trajectories=traffic["n_trajectories"])
    fields.update(over)
    return SimConfig(**fields)


def noise_p(cfg: dict) -> float:
    return cfg["noise_prob"] if cfg["use_noise"] else 0.0


def slots(cfg: dict):
    """The (theta_x, theta_y) of each kick slot of one cycle."""
    return [tuple(s) for s in floquet.schedule(cfg["polarization"], cfg["g"],
                                                1)[0]]


def initial_index(cfg: dict) -> int:
    """Basis index of the initial product state."""
    if cfg["initial_state"] == "vacuum":
        return 0
    if cfg["initial_state"] == "neel":
        return sum(1 << q for q in range(1, cfg["L"], 2))
    raise ValueError(f"unknown initial_state {cfg['initial_state']!r}")


def echo_cycles(T: int) -> int:
    """Cycles of one trajectory's echoes: t forward and t inverse, t < T."""
    return sum(2 * t for t in range(T))


def gaps(answer: dict, ref: dict) -> dict:
    """The widest gap of each answer against the reference, as
    ``<key>_gap``, over the entries that the reference computed (finite);
    NaN where such an answer is not finite."""
    out = {}
    for key, a in answer.items():
        a = np.asarray(a, dtype=np.float64)
        b = np.asarray(ref[key], dtype=np.float64)
        if a.shape != b.shape:
            raise ValueError(f"{key}: answer {a.shape} against reference "
                             f"{b.shape}")
        due = np.isfinite(b)
        d = np.abs(a[due] - b[due])
        out[f"{key}_gap"] = (float(d.max()) if np.isfinite(d).all()
                             else float("nan"))
    return out
