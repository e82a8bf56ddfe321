"""Where the device time of the main path goes, from ``torch.profiler``.

Traces, on a CUDA card at the bench shape (L=20, T=50, p=0.05, g=0.97,
vacuum, probe q = L//2, 32 trajectories; ``--L``, ``--tf`` and
``--n_trajectories`` change it) and the drive ``--polarization`` names
(default x, the K1/K2 path; y, xy, yx, circular_* and xy_cycle take K4, and
the streamed lab-frame family K10 at 24 <= L <= 29):

- ``forward``: three ``_forward_batch`` dispatches of n_trajectories, each
  copied to the host as ``bench.py`` does;
- ``echo``: the ``autocorr`` echo sweep of 2 instances x n_trajectories;
- ``energy_level``: one noise level (p=0.05, the full Hamiltonian) of the
  ``energy`` sweep on 1 instance x n_trajectories (K5 on its range: the
  step passes ``echo_lo_kernel`` and ``echo_hi_kernel``, a cycle's first
  step measuring in them, and one ``obs_reduce_kernel`` a chunk of
  cycles).

Above K1/K2's range (L >= 24, the streamed x family, and for the other
drives the streamed lab-frame family) a whole echo sweep takes minutes, so
``echo_chunk`` traces one launch of it instead: its last (t values
T-k..T-1, the longest trip counts, k and the trajectories as
``routes.kernel_chunks`` sizes them for one instance); there is no energy
trace (the energy route is the eager engine there). The x forwards (K1,
K3a and the streamed family) and the lab-frame forwards (K4, K10) run the
step passes of K2, K3b and K4's echo (``echo_lo_kernel``,
``echo_mid_kernel`` from L = 25, ``echo_hi_kernel``, the last measuring as
it stores) and one ``reduce_rows_kernel`` and ``first_kernel`` at the end;
the echoes run the same passes, then ``measure_kernel`` and
``reduce_kernel``.

For each it prints one JSON line: the wall ms, the device-busy ms (the union
of the intervals of every device event, kernels and copies), the idle share
1 - busy / wall, and the device ms and launches of each kernel, costliest
first. With ``--out DIR`` it also writes the profiler's own table to
``DIR/profile_<name>.txt``.

Run: ``python -m dtc_tpu_torch.profile_sweep [--polarization POL]
[--L L --tf T --n_trajectories N] [--out DIR]``, e.g. ``--L 28 --tf 20
--n_trajectories 4``, ``--L 30 --tf 6 --n_trajectories 1`` or
``--polarization y --L 28 --tf 20 --n_trajectories 4``.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import time

import torch

from dtc_tpu_torch.core.sigma_evolve import draw_uniforms
from dtc_tpu_torch.experiments import energy
from dtc_tpu_torch.experiments.engine import (
    _echo_batch,
    _forward_batch,
    build_context,
    echo_sweep,
    resolve_device,
)
from dtc_tpu_torch.io.disorder import generate_disorder
from dtc_tpu_torch.ops import resident_blocked
from dtc_tpu_torch.ops.routes import kernel_chunks, sweep_route
from dtc_tpu_torch.utils.config import SimConfig

P, G, INST = 0.05, 0.97, 2


def short_name(name: str) -> str:
    """A kernel's name without its namespace prefix, template arguments and
    parameter list: ``void ns::k<...>(float*, ...)`` -> ``ns::k``; a leading
    bool template argument stays (``k<true>``: the port's passes that
    measure, against ``k<false>``; the lab-frame passes' row width after it
    goes)."""
    name = name.replace("(anonymous namespace)::", "").removeprefix("void ")
    cut = [i for i in (name.find("<"), name.find("(")) if i > 0]
    if not cut:
        return name
    flag = re.match(r"<(true|false)[,>]", name[min(cut):])
    return name[:min(cut)].strip() + (f"<{flag.group(1)}>" if flag else "")


def busy_summary(events, top: int = 6) -> dict:
    """Busy ms (union of intervals) of the device events among ``events``
    (``FunctionEvent``s, times in us), and the ms and counts of the ``top``
    costliest kernel names; the rest are summed under ``other``."""
    dev = [e for e in events
           if e.device_type == torch.autograd.DeviceType.CUDA]
    spans = sorted((e.time_range.start, e.time_range.end) for e in dev)
    busy, end = 0.0, float("-inf")
    for s, e in spans:
        if e > end:
            busy += e - max(s, end)
            end = e
    per = {}
    for e in dev:
        ms, n = per.get(short_name(e.name), (0.0, 0))
        per[short_name(e.name)] = (
            ms + (e.time_range.end - e.time_range.start) / 1e3, n + 1)
    ranked = sorted(per.items(), key=lambda kv: -kv[1][0])
    kernels = [{"name": k, "ms": ms, "launches": n}
               for k, (ms, n) in ranked[:top]]
    if ranked[top:]:
        kernels.append({"name": "other",
                        "ms": sum(ms for _, (ms, _) in ranked[top:]),
                        "launches": sum(n for _, (_, n) in ranked[top:])})
    return {"busy_ms": busy / 1e3, "kernels": kernels}


def traced(name, fn, out_dir, **info):
    """Run ``fn`` once under the profiler; print and return its summary
    (with ``info`` added)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    summary = busy_summary(prof.events())
    summary = {"trace": name, **info, "wall_ms": wall_ms,
               "idle_share": 1.0 - summary["busy_ms"] / wall_ms, **summary}
    if out_dir:
        with open(os.path.join(out_dir, f"profile_{name}.txt"), "w") as f:
            f.write(prof.key_averages().table(
                sort_by="self_device_time_total", row_limit=40))
    print(json.dumps(summary), flush=True)
    return summary


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None,
                    help="directory for the profiler's tables")
    ap.add_argument("--polarization", default="x",
                    help="drive to trace (x: K1/K2 or the streamed x "
                    "family; any other: K4, or K10 at L >= 24)")
    ap.add_argument("--L", type=int, default=20, help="chain length")
    ap.add_argument("--tf", type=int, default=50, help="cycles T")
    ap.add_argument("--n_trajectories", type=int, default=32,
                    help="trajectories per dispatch and instance")
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")
    if args.out:
        os.makedirs(args.out, exist_ok=True)
    pol, L, T, N_TRAJ = (args.polarization, args.L, args.tf,
                         args.n_trajectories)
    cfg = SimConfig(L=L, tf=T, g=G, inst=INST, noise_prob=P, use_noise=1,
                    n_trajectories=N_TRAJ, polarization=pol)
    hs, phis = generate_disorder(L, INST, seed=0)
    sched, params, noise = build_context(cfg, hs, phis, device=dev)
    shape = dict(L=L, T=T, q=L // 2, dtype_name="complex64", has_y=pol != "x")
    kw = dict(shape, K=sched.K, p=P, initial_state="vacuum",
              ancilla_factor=(1 - P) ** 6)
    engine, theta = sweep_route(sched.angles, echo=False, **shape)

    def forward(reps=3):
        for seed in range(reps):
            gen = torch.Generator(device=dev).manual_seed(seed)
            u = draw_uniforms((1, N_TRAJ, T * sched.K, L), generator=gen,
                              device=dev)
            _forward_batch(params[0][:1], params[1][:1], sched.angles, u,
                           route=engine, theta=theta, **kw).cpu()

    forward(1)  # kernel build and first launch stay out of the trace
    tag = ("" if pol == "x" else f"_{pol}") + ("" if L == 20 else f"_L{L}")
    traced(f"forward_dispatch_x3{tag}", forward, args.out, engine=engine)
    if L > resident_blocked.MAX_L:
        _, c, n_ts = kernel_chunks(1, N_TRAJ, 8, L)
        ts = torch.arange(T - n_ts, T, device=dev)
        gen = torch.Generator(device=dev).manual_seed(0)
        u = draw_uniforms((1, c, 2 * T * sched.K, L), generator=gen,
                          device=dev)
        route, theta = sweep_route(sched.angles, echo=True, **shape)
        traced(f"echo_chunk{tag}", lambda: _echo_batch(
            params[0][:1], params[1][:1], sched.angles, ts, u, route=route,
            theta=theta, **kw).cpu(),
            args.out, engine=engine, pairs=c * n_ts,
            ts=[T - n_ts, T - 1])
        return
    traced(f"echo_sweep{tag}",
           lambda: echo_sweep(cfg, sched, params, noise), args.out,
           engine=engine)
    cfg1 = cfg.replace(inst=1)
    sweep = energy._sweep(cfg1, hs[:1], phis[:1], dev, None)
    energy._energy_single_noise(cfg1, sweep, P)  # first launch: untraced
    traced(f"energy_level{tag}",
           lambda: energy._energy_single_noise(cfg1, sweep, P), args.out,
           engine=energy.energy_engine(cfg1, sched.K))


if __name__ == "__main__":
    main()
