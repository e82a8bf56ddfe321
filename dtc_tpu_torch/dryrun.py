"""Multi-device dry run of the sharded engines on n logical devices.

Counterpart of ``__graft_entry__.dryrun_multichip``:
``dryrun_multichip(n_devices, device="cuda")`` lays a (traj, amp) mesh of
n logical devices over the cards of ``device`` (a device may repeat, as
the reference's virtual host devices do; ``parallel/mesh.py``), amp the
largest power of two that divides n, and checks:

1. at L=6, T=2, p=0.05 (x drive): the sharded forward's A(0) = (1-p)^6
   within 1e-5; the echo at t=1 finite with |echo| <= 1, and at t=0 equal
   to (1-p)^6; the sharded observables of shapes (T,) and (T, L) with
   |<Z_q>| <= 1;
2. for n >= 2, at L=18 on 2 shards (L_loc = 17, p=0.3, q=9): the per-shard
   cycle kernels, K8a/K8b for the x drive and K8c/K8d for the y drive,
   forward and echo at t=T, against the sigma-frame sharded engines on the
   same uniforms, within 1e-4;
3. the L=32 step. The reference only compiles its L=32 sharded forward on
   an n-shard mesh; the port has no compile step. What stands in for it:
   the L=32 x forward's plan on an n-shard mesh (``forward_plan``: the
   engines built, no state allocated), its route (``sharded_route``) and
   the bytes of a shard, and beside it the plans of the two ends of the
   kernel routes on the same mesh, L_loc = 29 (``cycle_hi``) and L_loc =
   17 (``cycle``, 8192 trajectories, so a group runs in many launches).
   On 4 shards of one card the L=32 plan has L_loc = 30 and takes the
   sigma engines, which launch no kernel; the other two launch. Every
   launch is held to the kernels' grid limit
   (``resident_blocked.MAX_LAUNCH``) and to the byte rule of
   ``sharded._launch_traj``: 16 bytes a shard amplitude, times the shards
   of the group on one device, within ``routes.KERNEL_STATE_BYTES`` (or
   one trajectory); the launches of a shard cover its group.

The reference's device-row checks are not repeated here: on the card
``chip_smoke.py`` holds the device rows on K10's shard-local forms through
the one-shard mesh against their plain versions. On the CPU every kernel
runs its plain version, as everywhere in the port. The last line printed is
``dryrun_multichip OK on N devices ...``. Run: ``python -m
dtc_tpu_torch.dryrun N [--device cpu]``.
"""

from __future__ import annotations

import argparse
import math
from collections import Counter

import torch

from dtc_tpu_torch.experiments.sharded_run import forward_plan
from dtc_tpu_torch.io.disorder import generate_disorder
from dtc_tpu_torch.models.drives import build_kick_schedule
from dtc_tpu_torch.models.hamiltonian import hamiltonian_terms
from dtc_tpu_torch.ops.resident_blocked import MAX_LAUNCH
from dtc_tpu_torch.ops.routes import KERNEL_STATE_BYTES
from dtc_tpu_torch.parallel import sharded as sh
from dtc_tpu_torch.parallel.mesh import amp_bits, logical_devices, make_mesh
from dtc_tpu_torch.utils.config import SimConfig


def _check(ok, what, value) -> None:
    if not ok:
        raise RuntimeError(f"dryrun_multichip: {what} failed: {value}")


def _inputs(L, T, seed, n_traj, dev):
    """Disorder, and forward (n, T, L) and echo (n, 2T, 1, L) uniforms."""
    hs, phis = generate_disorder(L, 1, seed=seed)
    gen = torch.Generator(device=dev).manual_seed(seed)
    u_fwd = torch.rand((n_traj, T, L), generator=gen, device=dev)
    u_echo = torch.rand((n_traj, 2 * T, 1, L), generator=gen, device=dev)
    return (torch.as_tensor(hs[0, :L], device=dev),
            torch.as_tensor(phis[0, :L - 1], device=dev), u_fwd, u_echo)


def _small_mesh(mesh, dev):
    """Step 1: forward, echo and observables at L=6 -> a summary."""
    L, T, p, q = 6, 2, 0.05, 3
    af = (1 - p) ** 6
    n = 2 * mesh.shape["traj"]
    hs, phis, u_fwd, u_echo = _inputs(L, T, 0, n, dev)
    angles = build_kick_schedule("x", 0.97, T, device=dev).angles
    kw = dict(L=L, T=T, K=1, p=p, q=q)
    a = sh.make_sharded_autocorr_forward(mesh, **kw)(angles, hs, phis, u_fwd)
    _check(a.shape == (T,) and abs(float(a[0]) - af) < 1e-5,
           "forward A(0) = (1-p)^6", a)
    ech = sh.make_sharded_echo(mesh, **kw)
    e1 = float(ech(angles, hs, phis, u_echo, 1))
    _check(math.isfinite(e1) and abs(e1) <= 1 + 1e-5, "echo(1) bounded", e1)
    e0 = float(ech(angles, hs, phis, u_echo, 0))
    _check(abs(e0 - af) < 1e-5, "echo(0) = (1-p)^6", e0)
    terms = hamiltonian_terms(L, 0.97, hs, phis, "full")
    obs = sh.make_sharded_observables(mesh, L=L, T=T, K=1, p=p)
    en, zs = obs(angles, hs, phis, terms.hs, terms.phis, terms.x_coeff,
                 u_fwd, n_traj=n)
    _check(en.shape == (T,) and zs.shape == (T, L), "observables shapes",
           (tuple(en.shape), tuple(zs.shape)))
    _check(bool((zs.abs() <= 1 + 1e-5).all()) and bool(en.isfinite().all()),
           "|<Z_q>| <= 1, E finite", (en, zs))
    return (f"A={[round(float(x), 4) for x in a]} echo(1)={e1:.4f} "
            f"E(0)={float(en[0]):.4f}")


def _cycle_kernels(devices, dev):
    """Step 2: K8a/K8b and K8c/K8d against the sigma engines, L=18 on 2
    shards."""
    L, T, p, q = 18, 2, 0.3, 9
    mesh = make_mesh(n_amp=2, n_traj=len(devices) // 2, devices=devices)
    n = 2 * mesh.shape["traj"]
    hs, phis, u_fwd, u_echo = _inputs(L, T, 2, n, dev)
    kw = dict(L=L, T=T, p=p, q=q)
    for pol, fk, ek in (
            ("x", sh.make_sharded_autocorr_forward_kernel,
             sh.make_sharded_echo_kernel),
            ("y", sh.make_sharded_autocorr_forward_general,
             sh.make_sharded_echo_general)):
        angles = build_kick_schedule(pol, 0.97, T, device=dev).angles
        extra = {} if pol == "x" else {"K": 1}
        sig = dict(K=1, has_y=pol != "x")
        ak = fk(mesh, **kw, **extra)(angles, hs, phis, u_fwd)
        ax = sh.make_sharded_autocorr_forward(mesh, **kw, **sig)(
            angles, hs, phis, u_fwd)
        err = float((ak.cpu() - ax.cpu()).abs().max())
        _check(err < 1e-4, f"{pol} cycle-kernel forward vs sigma", err)
        vk = float(ek(mesh, **kw, **extra)(angles, hs, phis, u_echo, T))
        vx = float(sh.make_sharded_echo(mesh, **kw, **sig)(
            angles, hs, phis, u_echo, T))
        _check(abs(vk - vx) < 1e-4, f"{pol} cycle-kernel echo vs sigma",
               (vk, vx))


def _plans(devices, n_amp):
    """Step 3: the L=32 x forward's plan and the kernel routes' two ends
    on an n_amp-shard mesh, each launch checked -> a summary."""
    mesh = make_mesh(n_amp=n_amp, n_traj=1, devices=devices)
    k = amp_bits(mesh)
    per_device = max(Counter(mesh.device(0, a)
                             for a in range(n_amp)).values())
    shapes = {32: (1, None), 29 + k: (1, "cycle_hi"), 17 + k: (8192, "cycle")}
    out = []
    for L, (n, route) in shapes.items():
        plan = forward_plan(mesh, SimConfig(L=L, tf=2, noise_prob=0.05,
                                            n_trajectories=n, qubit=11))
        if route is not None:
            _check(plan["route"] == route, f"L={L} route {route}",
                   plan["route"])
            _check(sum(plan["launches"]) == n_amp * plan["group_traj"],
                   f"L={L} launches cover the group", plan["launches"])
        amp_bytes = 16 * per_device << plan["local_bits"]
        for c in plan["launches"]:
            _check(1 <= c <= MAX_LAUNCH, f"L={L} launch within the grid "
                   "limit", c)
            _check(c == 1 or c * amp_bytes <= KERNEL_STATE_BYTES,
                   f"L={L} launch within KERNEL_STATE_BYTES", c)
        out.append(f"L={L}: route={plan['route']} L_loc="
                   f"{plan['local_bits']} {plan['shard_bytes']} B a shard, "
                   f"{len(plan['launches'])} launches a cycle of at most "
                   f"{max(plan['launches'], default=0)} trajectories")
    return f"plans on amp={n_amp}: " + "; ".join(out)


def dryrun_multichip(n_devices: int, device="cuda") -> None:
    """Run the checks of the module doc on ``n_devices`` logical devices;
    raises RuntimeError on the first that fails, prints the OK line. The
    reference compiles its L=32 sharded forward; what stands in for that
    here is the L=32 x forward's plan (route, bytes a shard, every launch
    against MAX_LAUNCH and KERNEL_STATE_BYTES), with the plans of the
    kernel routes' two ends on the same mesh, built with no state."""
    devices = logical_devices(n_devices, device)
    dev = devices[0]
    n_amp = 1
    while n_devices % (n_amp * 2) == 0:
        n_amp *= 2
    mesh = make_mesh(n_amp=n_amp, n_traj=n_devices // n_amp, devices=devices)
    small = _small_mesh(mesh, dev)
    kernels = "skipped (n < 2)"
    if n_devices >= 2:
        _cycle_kernels(devices, dev)
        kernels = "parity OK (amp=2, L=18, K8a/K8b x, K8c/K8d y)"
    plan = _plans(devices, n_amp)
    print(f"dryrun_multichip OK on {n_devices} devices (mesh traj="
          f"{mesh.shape['traj']} x amp={n_amp}); {small}; cycle kernels "
          f"{kernels}; {plan}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m dtc_tpu_torch.dryrun")
    ap.add_argument("n_devices", type=int)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dryrun_multichip(args.n_devices, device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
