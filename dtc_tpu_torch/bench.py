"""Headline benchmark of the port: noisy Floquet cycles/s at L=20 on a GPU.

Port of the repository's ``bench.py``: the same shape (L=20, T=50, 32
trajectories, p=0.05, g=0.97, vacuum, probe q = L//2), the same metric name
and ``vs_baseline`` (value / 1000), and the same per-repetition validation
(A(0) = (1-p)^6 within 1e-3, |A| <= 1 + 1e-3, all finite). It times the
engine's ``_forward_batch``, noise sampling included, and adds the device
name. It routes once (``ops/routes.py::sweep_route``), as a sweep does.
It runs on CUDA only: a missing card fails, it does not time the CPU.

Run: ``python -m dtc_tpu_torch bench``. Prints ONE JSON line.
"""

from __future__ import annotations

import json
import time

import numpy as np
import torch

from dtc_tpu_torch.core.sigma_evolve import draw_uniforms
from dtc_tpu_torch.experiments.engine import _forward_batch, resolve_device
from dtc_tpu_torch.io.disorder import generate_disorder
from dtc_tpu_torch.models.drives import build_kick_schedule
from dtc_tpu_torch.ops.routes import sweep_route

G = 0.97
N_REP, N_GROUPS = 3, 5  # dispatches per timing group, groups per median


def run_case(L, T, p, n_traj, *, device="cuda"):
    """(cycles/s, seconds per dispatch): median over timing groups."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError(f"the bench measures a GPU; got device {device!r}")
    hs, phis = generate_disorder(L, 1, seed=0)
    sched = build_kick_schedule("x", G, T, device=dev)
    hs_t = torch.as_tensor(hs[:, :L], device=dev)
    phis_t = torch.as_tensor(phis[:, :L - 1], device=dev)
    af = (1 - p) ** 6
    route, theta = sweep_route(sched.angles, L=L, T=T, q=L // 2,
                               dtype_name="complex64", has_y=False,
                               echo=False)
    kw = dict(route=route, theta=theta, L=L, T=T, K=1, p=p, q=L // 2,
              initial_state="vacuum", dtype_name="complex64",
              ancilla_factor=af)

    def dispatch(seed):
        gen = torch.Generator(device=dev).manual_seed(seed)
        u = draw_uniforms((1, n_traj, T, L), generator=gen, device=dev)
        return _forward_batch(hs_t, phis_t, sched.angles, u, **kw)

    def check(a):
        if not np.isfinite(a).all():
            raise RuntimeError("non-finite autocorrelations")
        if not np.all(np.abs(a) <= 1.0 + 1e-3):
            raise RuntimeError("unphysical |A|>1")
        if abs(a[0, :, 0].mean() - af) >= 1e-3:
            raise RuntimeError(f"A(0) != (1-p)^6: {a[0, :, 0].mean()}")

    check(dispatch(0).cpu().numpy())  # build + warm-up + validate
    group_dts = []
    for gi in range(N_GROUPS):
        t0 = time.perf_counter()
        handles = [dispatch(gi * N_REP + i + 1) for i in range(N_REP)]
        arrs = [h.cpu().numpy() for h in handles]
        group_dts.append((time.perf_counter() - t0) / N_REP)
        for a in arrs:
            check(a)
    dt = float(np.median(group_dts))
    return (T * n_traj) / dt, dt


def main(device="cuda"):
    L, T, n_traj = 20, 50, 32
    cycles_per_sec, _ = run_case(L=L, T=T, p=0.05, n_traj=n_traj,
                                 device=device)
    print(json.dumps({
        "metric": "noisy Floquet cycles/sec (L=20 trajectory ensemble, "
                  "p=0.05, validated)",
        "value": round(cycles_per_sec, 1),
        "unit": "cycles/s",
        "vs_baseline": round(cycles_per_sec / 1000.0, 2),
        "device": torch.cuda.get_device_name(torch.device(device)),
    }))


if __name__ == "__main__":
    main()
