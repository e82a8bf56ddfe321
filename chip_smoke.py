"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root: ``python3 chip_smoke.py``. Phases, one line
each; any failure raises and the script exits non-zero without a result:

1. card: CUDA present, name and power limit, TF32 off;
2. build: every CUDA library from ``dtc_tpu_torch/csrc`` (one nvcc per
   source, all started at once, sm_90a);
3. kernel vs plain version on the card, max |diff| <= 1e-4 each (K5's
   e_diag <= 1e-4 * (sum|th| + sum|tph|), x_sum <= 1e-4 * L; from a random
   unit state of 2^L amplitudes 1e-3 * 2^(-L/2), one part in 10^3 of a
   typical amplitude, on the state and the partial): small shapes
   across each kernel's range (K1 also at L=17, 20, 23 with probes in the
   bits of pass lo and of pass hi, at T=1 and T=57; K3a the same at L=14,
   16, 21, constant and ramp), then the main paths' own shapes (K1 on 2
   instances x 32 trajectories at T=50; K2 on the echo sweep's last two
   chunks; K4 forward on 32 trajectories of the xy drive at T=50; K4 echo
   on the xy echo sweep's last two chunks; K5 on 32 trajectories of the x
   drive at T=50, p=0.1; K5 also at L=14-23 on 3 trajectories of different
   rows, K=1 and 2, with and without x pairs, T=1 and T past one reduce
   chunk); and the eager observables engine on the card
   against the same call on the CPU (L=12, complex64 and complex128); the
   streamed x family (K6/K7) against its plain version at L=22, 24 (two
   passes), 26 and 28 (three), probes q = 0, L//2, L-1, vacuum and neel, and
   against K1/K2 on the same rows at L=22 and 23; at L=30 value anchors:
   A(1) = cos(pi g) within 1e-5 from the vacuum at p=0 for q = 0, 15, 29,
   the noiseless echo = 1 within 1e-4 at t=1..3, and a noisy forward
   (p=0.05, T=8) finite with |A| <= 1 (the plain comparison at L=30 is in
   the timing phase, on the main path's own shapes); the streamed lab-frame
   family (K10) against its plain version at L=22, 24, 25, 26, 28 and 29
   (y, circular_left, xy_cycle; q = 0, L//2, L-1; vacuum and neel; echo at
   p=0.6 and 0) and against K4 on the same rows at L=22 and 23 (its L=29
   comparison on the main path's shapes is in the timing phase); the
   resident x family (K3a/K3b) against its plain version, constant x at
   L=14, 15, 16 and a per-cycle ramp (theta_t = pi g_t, g from 0.86 to
   0.99) at L=14, 17, 20, 21 (q = 0, L//2, L-1; vacuum and neel; echo at
   p=0.6 and 0), against K1/K2 on the same rows (constant, L=17) and against
   K4 (the ramp, L=20), and on the main paths' own shapes (constant x at
   L=16, T=50, 2 x 32 trajectories: the forward and every echo chunk; the
   ramp at L=20, T=51 x 32; 32 pairs at t=12); the per-shard cycle kernels
   K8a-d against their plain versions at L_loc = 17, 20, 23 (q = 0, L//2,
   15, L-1; vacuum and neel; chains of T=4 cycles, every partial held; the
   x echo through K8a/K8b and the general echo through K8d at p=0.6 and 0;
   every K8 kernel on rows folded with non-zero global angles, but the
   noiseless echoes', the echo's K8a without a measure; y, xy,
   circular_left, xy_cycle for K8c/K8d), and the
   sharded engines
   (shards sharing the card) against the unsharded kernels on the same
   uniforms: x at L=25 on 4 shards against the streamed x family, xy at
   L=24 on 2 shards against K10, x and xy at L=19 on 4 shards against
   K1/K2 and K4, a (1,1) mesh at L=17 against K1/K2; the per-shard streamed
   cycle kernels K9a/K9b against their plain versions at L_loc = 22, 24,
   25, 27, 29 (q = 0, 14, 16, L//2, L-1 across them; vacuum and neel;
   chains of 3-4 cycles, every partial held; the echo at t=2 at p=0.6 and
   0; K9a/K9b on rows folded with non-zero global angles, the echo's K9a
   without a measure) and K10's shard-local forms at 24, 26, 29 (y, xy,
   circular_left, xy_cycle) and at 27 (xy, the sharded general main path's
   shape; chains of 3 cycles and the echo at t=2, their rows folded with
   non-zero global angles), and one cycle of each at L_loc = 30
   (one trajectory; K9a with and without a probe; K10's 256-lane rows)
   from a random unit state, the forwards' partial also from the neel
   state, with the peak device memory; the sharded engines on them against the unsharded kernels: x at
   L=26 on 2 shards against the streamed x family, xy at L=26 on 2 shards
   against K10, a (1,1) mesh at L=25; and at L=31 on 2 shards (one
   trajectory) the anchors A(1) = cos(pi g) within 1e-5 and the noiseless
   echo = 1 within 1e-4, for x through K9a/K9b and for y through K10's
   shard-local forms with 256-lane rows; the planar engine's noise factor
   K11 against its plain version on random unit states and tiles, L=20 with
   32 states and L=30 with one 8 GiB state, within 1e-5 of the largest
   amplitude; device-noise rows on K4 (xy at L=20: forward and echo) and on
   K10's shard-local forms through the one-shard mesh (xy at L=24, y at
   L=25) against the kernels' plain versions on the same rows;
4. main paths, each through the CLI's ``main(argv)`` with every launch
   count set to 0 just before it and read just after:
   ``autocorr --device cuda`` (x drive: K1/K2) at L=20, T=50, 2 instances x
   32 trajectories; ``campaign --simulate --device cuda`` at the same
   width (4096 shots a job), twice in one job folder: 200 QASM jobs, 100
   completed records of each kind, 50 CSV rows, every decoded slot within
   5/sqrt(4096) of ``run_autocorr``'s value on the card, and a second run
   that finds the export, writes no row and leaves the CSV as it was,
   with the seconds of export, simulate and ingest; ``polarization --device cuda`` (x, y, xy, yx: K1/K2
   and K4) at L=20, T=50, 32 trajectories; physics checks on their CSVs,
   the engine each sweep logged, every kernel of the path launched and no
   plain version called on a CUDA tensor; then ``xy-cycle`` and ``shots``
   at T=20, with checks on their CSVs; then the energy family (K5):
   ``energy``, ``ham-comparison`` and ``per-qubit-z`` at L=20, T=50, 32
   trajectories, ``per-qubit-z`` without noise, and ``per-qubit-z`` of the
   xy drive at T=20, with checks on their CSVs (E(0), z(0), z(1) at p=0);
   then the large-L paths: ``polarization --device cuda`` at L=28 (T=12,
   2 trajectories; x on the streamed x family, y, xy, yx on K10,
   engine=general_hi), ``autocorr --device cuda`` of the x drive at L=28
   (T=20, 4 trajectories) and L=30 (T=6, 1 trajectory), engine=streamed for
   both sweeps, and of the circular_left drive at L=29 (T=6, 1
   trajectory), engine=general_hi; each with its family's kernels launched,
   no other kernel, no plain version on CUDA; then the resident x paths:
   ``autocorr --device cuda`` at L=16 (T=50, 2 instances x 32
   trajectories; engine=resident, K3 only), ``adaptive --device cuda`` at
   L=20 (T=12, 32 trajectories) with the default flags (golden optimizer)
   and with linear feedback, and ``adaptive-batch --device cuda`` at L=20
   (T=50, 32 trajectories): each adaptive sweep logs engine=resident (and
   engine=blocked for its first step, whose schedule is still constant),
   the fixed-g comparisons and the batch's echo pass (constant schedules)
   engine=blocked, K3 launched (in ``adaptive``, once for each forward and
   echo call of a per-cycle schedule), no plain version on CUDA, g within
   [g_min, g_max], |A| and echo <= 1, the g=0.97 comparison alternating,
   and the reference-named CSVs written; then the amplitude-sharded path:
   ``--num_devices 4 autocorr --sharded --n_amp 4`` of the x drive at L=25
   (T=20, 4 trajectories; engine=cycle, K8a/K8b only) and ``--num_devices
   2 autocorr --sharded --n_amp 2 --polarization xy`` at L=24 (T=12, 2
   trajectories; engine=cycle_general, K8c/K8d only), logical devices
   sharing the card, with physics checks and the sweep seconds; then
   ``--num_devices 2 autocorr --sharded --n_amp 2`` of the x drive at L=28
   (L_loc = 27; T=8, 2 trajectories; engine=cycle_hi, K9a/K9b only), and
   the lab-frame sharded engines called directly for xy at L=28 on 2
   shards (T=6, 2 trajectories, the echo at t=1, 3, 5; K10's shard-local
   forms only: the routing sends no drive there, as the reference's); then
   ``DTC_TPU_ENGINE=planar autocorr`` at the bench shape (inst=1): the
   forward on the planar engine, K11 once a measured cycle and no other
   kernel, the echo on the sigma engine, and the planar forward held
   against K1 on the same uniforms within 2.7e-4; then device noise,
   ``autocorr --use_fakebackend 1 --fake_device brisbane``: config 4, x at
   L=27 (T=8, 4 trajectories) on the streamed x family with device rows,
   xy at L=20 (T=20, 8 trajectories) on K4 and xy at L=24 (T=4, 2
   trajectories) on K10's shard-local forms through the one-shard mesh,
   each with its route logged, its kernels only and A(0) = the model's
   ancilla and readout factor; config 4 held against the sigma device
   engine on the same draws (forward, echo at t=1..3) within 2.7e-4;
   then the exact density matrix: its run wrappers on the card against
   the same calls on the CPU (L=8, T=10, x and xy, p=0.05; complex128
   within 1e-10, complex64 within 1e-5) and the literal Hadamard test
   against the direct mode (L=5, t=3, forward and echo, within 1e-6), then
   ``autocorr --device cuda --method exact`` at L=13, T=20 (A(0) = echo(0)
   = (1-p)^6, |A| and |echo| <= 1, no kernel launched; its seconds and
   peak device memory); then the sharded observables on 2 logical shards
   of the card against the unsharded eager engine on the same uniforms
   (L=20, T=10, 4 trajectories, xy: <Z_q> within 1e-4, E within 1e-4 * L),
   ``--num_devices 2 energy --device cuda --sharded --n_amp 2`` at L=24
   (T=10, p = 0 and 0.01, at 4 trajectories and at the CLI's default 256:
   E(0)/L, <Z_q(0)> = 1, the route logged, no kernel launched; seconds and
   peak device memory) and ``dryrun_multichip(4)``
   (``dtc_tpu_torch/dryrun.py``) on four logical shards of the card;
5. timing: the bench shape (``dtc_tpu_torch/bench.py::run_case``) and every
   kernel against its plain version on identical inputs, whose outputs are
   held to the same bound (K1 after the registers and spills of every
   kernel of ``floquet_x.cu`` and ``floquet_x_resident.cu``, with the time
   of its folded rows; the streamed family: forward at L=24, 26, 28 and
   30, echo at L=28 and 30, with the plain version's peak device memory;
   before them the registers and spills of the forward's passes and one
   L=30 forward launch at T=1024 with its peak device memory, its first
   cycles held to a T=6 launch; then K1 beside it on the same L=22 and 23
   rows, and K4's forward (K2's split) beside the streamed lab-frame
   forward (``plan_for``'s split) on the same L=23 rows, y and xy;
   K5: x and xy at L=20, T=50 x 32, after the registers and spills of
   every kernel of ``floquet_general.cu``, then x at the energy cell's
   launch (L=20, T=50 x 256, p=0.1) and pass lo's walk of 1-16 tiles a
   block at 256, 32 and 1 trajectories beside the tiles the entry picks,
   with the launches by walk, then one L=23 launch at the most
   cycles one reduce chunk holds and one at one more, with their peak
   device memory; K10: forward y at L=28 and
   circular_left at L=29, echo y at L=28 and circular_left at L=29, the
   main paths' launches, with the peak memory; K3a on the ramp at L=14, 16
   and 20, T=51 x 32, and K3b on 32 pairs at t=12, each beside K4 on the
   same schedule and rows; K8a-d at L_loc=23 on 2 shards x 4 trajectories,
   one cycle, beside K1 and K4 per cycle at L=23 on 8 trajectories and
   the torch global diagonal pass K8c/K8d no longer need, after the
   registers and spills of every kernel of ``floquet_cycle.cu`` and of
   K8c's and K8d's in ``floquet_general_streamed.cu``; K9a/K9b
   and K10's shard-local forms (y and xy) at L_loc=28 on 2 shards x 2
   trajectories, one cycle, beside K6 and the one-card K10 per cycle at
   L=28 on 4 trajectories, after the registers and spills of every kernel
   of ``floquet_cycle_hi.cu`` and ``floquet_general_streamed.cu``); K11 on
   the planar path's 32 states of L=20, after its registers and spills;
   the planar forward's and K1's
   cycles/s and the config-4 device forward's trajectory-cycles/s; each
   kernel's bound: the larger
   of its bytes (inputs read once, outputs written once; for the streamed
   families, whose states of 64 MiB and more do not fit the L2, at least
   16 B per amplitude and step) over 3.35 TB/s and its f32 operations over
   67 TFLOP/s (the H100 SXM's published peaks), and
   its state floor (16 B per amplitude per pass and step, 2 or 3 passes);
   the entries on the step passes of ``floquet_echo.cuh`` (K1 at the bench
   shape, K4's forward y and xy at L=20, T=50 x 32, K3a on the ramp at
   L=14, 16, 20; K2 and K4's
   echo on 512 x or xy pairs at ts=0..7, K3b on 32 pairs at t=12, L=20;
   the streamed x echo at L=28, ts=0..3, and L=30, t=5; the streamed
   lab-frame echo, y at L=28, ts=0..3, and circular_left at L=29, t=5; the
   streamed forwards, x at L=24-30 and lab-frame at L=24-29) also with
   their launches a call
   and their shares of the state floor and of the bound;
6. the device seconds and calls of each kernel entry summed over every
   main-path run of phase 4 (CUDA events around each entry call), a JSON
   line of the kernels (with those as ``main_s`` and ``main_calls``), then
   the last line ``{"ok": true, "device": {...}}``.

It imports only the standard library, torch and the port.
"""

from __future__ import annotations

import csv
import json
import logging
import math
import os
import subprocess
import sys
import tempfile
import time

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
TOL = 1e-4  # f32 sums over 2^L amplitudes in another order than the plain version
THETA = 0.97 * math.pi
HBM_BYTES_PER_S = 3.35e12   # H100 SXM, published
F32_FLOPS_PER_S = 67e12     # H100 SXM, f32 outside the tensor cores
P = 0.05
# the main paths' shape: the bench shape of the reference (L=20, T=50, 32
# trajectories); the studies run at T=20
MAIN_L, MAIN_T, STUDY_T, N_TRAJ, DEVICE = 20, 50, 20, 32, "cuda"


GENERAL = "dtc_tpu/ops/pallas_resident_general.py"
# (key, C entry, source, the TPU kernel it replaces, a second one or None)
KERNELS = [
    ("K1", "floquet_x_forward", "dtc_tpu_torch/csrc/floquet_x.cu",
     "dtc_tpu/ops/pallas_resident_blocked.py:131", None),
    ("K2", "floquet_x_echo", "dtc_tpu_torch/csrc/floquet_x.cu",
     "dtc_tpu/ops/pallas_resident_blocked.py:374", None),
    ("K3 forward", "floquet_x_resident_forward",
     "dtc_tpu_torch/csrc/floquet_x_resident.cu",
     "dtc_tpu/ops/pallas_resident.py:119", None),
    ("K3 echo", "floquet_x_resident_echo",
     "dtc_tpu_torch/csrc/floquet_x_resident.cu",
     "dtc_tpu/ops/pallas_resident.py:320", None),
    ("K4 forward", "floquet_general_forward",
     "dtc_tpu_torch/csrc/floquet_general.cu", f"{GENERAL}:166",
     f"{GENERAL}:334"),
    ("K4 echo", "floquet_general_echo",
     "dtc_tpu_torch/csrc/floquet_general.cu", f"{GENERAL}:166",
     f"{GENERAL}:334"),
    ("K5", "floquet_general_observables",
     "dtc_tpu_torch/csrc/floquet_general.cu",
     "dtc_tpu/ops/pallas_observables.py:87", None),
    ("K6 forward", "floquet_x_streamed_forward",
     "dtc_tpu_torch/csrc/floquet_x_streamed.cu",
     "dtc_tpu/ops/pallas_streamed.py:58",
     "dtc_tpu/ops/pallas_streamed_hi.py:82"),
    ("K6 echo", "floquet_x_streamed_echo",
     "dtc_tpu_torch/csrc/floquet_x_streamed.cu",
     "dtc_tpu/ops/pallas_streamed.py:322",
     "dtc_tpu/ops/pallas_streamed_hi.py:344"),
    ("K10 forward", "floquet_general_streamed_forward",
     "dtc_tpu_torch/csrc/floquet_general_streamed.cu",
     "dtc_tpu/ops/pallas_cycle_hi_general.py:65", None),
    ("K10 echo", "floquet_general_streamed_echo",
     "dtc_tpu_torch/csrc/floquet_general_streamed.cu",
     "dtc_tpu/ops/pallas_cycle_hi_general.py:250", None),
    ("K8a", "floquet_cycle_forward", "dtc_tpu_torch/csrc/floquet_cycle.cu",
     "dtc_tpu/ops/pallas_cycle.py:51", None),
    ("K8b", "floquet_cycle_inverse", "dtc_tpu_torch/csrc/floquet_cycle.cu",
     "dtc_tpu/ops/pallas_cycle.py:242", None),
    ("K8c", "floquet_cycle_general_forward",
     "dtc_tpu_torch/csrc/floquet_general_streamed.cu",
     "dtc_tpu/ops/pallas_cycle.py:530", None),
    ("K8d", "floquet_cycle_general_inverse",
     "dtc_tpu_torch/csrc/floquet_general_streamed.cu",
     "dtc_tpu/ops/pallas_cycle.py:778", None),
    ("K9a", "floquet_cycle_hi_forward",
     "dtc_tpu_torch/csrc/floquet_cycle_hi.cu",
     "dtc_tpu/ops/pallas_cycle_hi.py:170", None),
    ("K9b", "floquet_cycle_hi_inverse",
     "dtc_tpu_torch/csrc/floquet_cycle_hi.cu",
     "dtc_tpu/ops/pallas_cycle_hi.py:346", None),
    ("K10a local", "floquet_cycle_hi_general_forward",
     "dtc_tpu_torch/csrc/floquet_general_streamed.cu",
     "dtc_tpu/ops/pallas_cycle_hi_general.py:65", None),
    ("K10b local", "floquet_cycle_hi_general_inverse",
     "dtc_tpu_torch/csrc/floquet_general_streamed.cu",
     "dtc_tpu/ops/pallas_cycle_hi_general.py:250", None),
    ("K11", "noise_factor_apply", "dtc_tpu_torch/csrc/noise_factor.cu",
     "dtc_tpu/ops/pallas_noise.py:42", None),
]


def phase(msg: str) -> None:
    print(msg, flush=True)


def card() -> str:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: CUDA is not available")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    phase(smi.splitlines()[0])
    from dtc_tpu_torch.ops.precision import assert_fp32_policy, set_fp32_policy

    set_fp32_policy()
    assert_fp32_policy()
    phase(f"[card] torch {torch.__version__} cuda {torch.version.cuda}; "
          "TF32 off")
    return smi.splitlines()[0]


def build() -> None:
    from dtc_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.load_all()
    phase(f"[build] {len(_build.build_info)} libraries in "
          f"{time.perf_counter() - t0:.2f}s")
    for name, info in _build.build_info.items():
        regs = [ln.strip() for ln in info["log"].splitlines()
                if "registers" in ln]
        phase(f"[build] {name}.cu (nvcc {info['seconds']:.2f}s): "
              + " | ".join(regs))


def disorder(L, dev, inst=1, seed=7):
    """``inst`` instances, distributed as the CLI's default disorder:
    h ~ U[-pi, pi), phi ~ U[-1.5 pi, -0.5 pi)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    u = torch.rand((2, inst, L), generator=gen, dtype=torch.float64,
                   device=dev)
    return (2 * u[0] - 1) * math.pi, (u[1, :, :L - 1] - 1.5) * math.pi


def uniforms(shape, dev, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.rand(shape, generator=gen, device=dev)


def forward_inputs(L, T, c, p, dev, seed, inst=1):
    from dtc_tpu_torch.ops.params import forward_rows

    hs, phis = disorder(L, dev, inst)
    u = uniforms((inst, c, T, L), dev, seed)
    return forward_rows(u, hs[:, None], phis[:, None], L=L, T=T, p=p)


def echo_inputs(L, T, c, p, ts, dev, seed, inst=1):
    from dtc_tpu_torch.ops.params import echo_pair_tiles

    hs, phis = disorder(L, dev, inst)
    u = uniforms((inst, c, 2 * T, L), dev, seed)
    return echo_pair_tiles(u, torch.as_tensor(ts, device=dev), hs[:, None],
                           phis[:, None], L=L, T=T, p=p)


def schedule(pol, T, dev):
    from dtc_tpu_torch.models.drives import build_kick_schedule

    # the xy-cycle drive's axis flips every 2 cycles, inside short runs
    return build_kick_schedule(pol, 0.97, T, xy_cycle_period=2,
                               device=dev).angles


def general_forward_inputs(L, pol, T, c, p, dev, seed, inst=1, width=128):
    from dtc_tpu_torch.ops.params_general import general_forward_rows

    hs, phis = disorder(L, dev, inst)
    angles = schedule(pol, T, dev)
    K = angles.shape[1]
    u = uniforms((inst, c, T * K, L), dev, seed)
    return general_forward_rows(u, hs[:, None], phis[:, None], angles, L=L,
                                T=T, K=K, p=p, width=width)


def general_echo_inputs(L, pol, T, c, p, ts, dev, seed, inst=1, width=128):
    from dtc_tpu_torch.ops.params_general import general_echo_rows

    hs, phis = disorder(L, dev, inst)
    angles = schedule(pol, T, dev)
    K = angles.shape[1]
    u = uniforms((inst, c, 2 * T * K, L), dev, seed)
    return general_echo_rows(u, torch.as_tensor(ts, device=dev), hs[:, None],
                             phis[:, None], angles, L=L, T=T, K=K, p=p,
                             width=width)


def held_obs(what, k, ref, L, scale) -> float:
    """K5's three outputs against the plain version's: e_diag within
    TOL * scale (scale = sum|th| + sum|tph|), x_sum within TOL * L, <Z_q>
    within TOL; prints and returns the largest |diff|, raises above a
    bound."""
    diffs = [float((a - b).abs().max()) for a, b in zip(k, ref)]
    bounds = (TOL * scale, TOL * L, TOL)
    phase(f"[compare] {what}: max|kernel-plain| e_diag {diffs[0]:.3e} "
          f"(<= {bounds[0]:.3e}), x_sum {diffs[1]:.3e} (<= {bounds[1]:.3e}),"
          f" z {diffs[2]:.3e} (<= {bounds[2]:.0e})")
    if not all(d <= b for d, b in zip(diffs, bounds)):
        raise RuntimeError(f"{what}: K5 disagrees with its plain version")
    return max(diffs)


def held(what: str, k, ref) -> float:
    """max |kernel - plain|, printed; raises above TOL."""
    d = float((k - ref).abs().max())
    phase(f"[compare] {what}: max|kernel-plain| = {d:.3e}")
    if not d <= TOL:
        raise RuntimeError(f"{what}: kernel disagrees with its plain version"
                           f" by {d} > {TOL}")
    return d


def against_plain(what, kernel, plain, args, kw) -> tuple:
    """(max |kernel - plain|, kernel output) on identical inputs."""
    k = kernel(*args, **kw)
    torch.cuda.synchronize()
    ref = plain(*args, **kw)
    torch.cuda.synchronize()
    return held(what, k, ref), k


def compare_x(dev, err) -> None:
    from dtc_tpu_torch.ops import resident_blocked as rb

    # small shapes across the range, then the main path's batch:
    # 2 instances x 32 trajectories through all 50 cycles
    for L, T, state, c, inst in ((17, 4, "neel", 3, 1), (20, 8, "vacuum", 3, 1),
                                 (23, 3, "vacuum", 3, 1),
                                 (20, 50, "vacuum", 32, 2)):
        rows, sig = forward_inputs(L, T, c, P if T == 50 else 0.1, dev,
                                   seed=L + T, inst=inst)
        d, _ = against_plain(
            f"K1 L={L} T={T} {state} {inst}x{c}", rb.blocked_forward_batch,
            rb.blocked_forward_batch_ref, (rows, sig, THETA),
            dict(L=L, q=L // 2, initial_state=state))
        err["K1"] = max(err["K1"], d)
    # probes in pass lo's bits (0, a - 1) and pass hi's (a, L - 1) of the
    # step passes' split a = L - L/2, at T = 1 (no cycle runs) and T = 57
    for L in (17, 20, 23):
        a = L - L // 2
        for T, state in ((1, "neel"), (57, "vacuum")):
            rows, sig = forward_inputs(L, T, 3, 0.1, dev, seed=L * T)
            for q in (0, a - 1, a, L - 1):
                d, _ = against_plain(
                    f"K1 L={L} T={T} {state} q={q} 1x3",
                    rb.blocked_forward_batch, rb.blocked_forward_batch_ref,
                    (rows, sig, THETA), dict(L=L, q=q, initial_state=state))
                err["K1"] = max(err["K1"], d)
    for L, q in ((17, 16), (20, 10), (23, 0)):
        for p in (0.6, 0.0):
            tiles, sig = echo_inputs(L, 4, 2, p, [1, 2, 3, 4], dev, seed=2)
            d, k = against_plain(
                f"K2 L={L} T=4 ts=1..4 p={p} q={q}", rb.blocked_echo_batch,
                rb.blocked_echo_batch_ref, (tiles, sig, THETA),
                dict(L=L, q=q))
            if p == 0.0 and not float((k - 1).abs().max()) <= TOL:
                raise RuntimeError(f"noiseless echo != 1: {k.tolist()}")
            err["K2"] = max(err["K2"], d)
    # the main path's last two echo chunks (T=50, t_chunk=8): the longest
    # trip counts, 80..98 steps, on 2 instances x 32 trajectories
    for ts in (list(range(40, 48)), [48, 49]):
        tiles, sig = echo_inputs(20, 50, 32, P, ts, dev, seed=ts[0], inst=2)
        d, _ = against_plain(
            f"K2 L=20 T=50 ts={ts[0]}..{ts[-1]} p={P} 2x32",
            rb.blocked_echo_batch, rb.blocked_echo_batch_ref,
            (tiles, sig, THETA), dict(L=20, q=10))
        err["K2"] = max(err["K2"], d)
        del tiles


def compare_general(dev, err) -> None:
    from dtc_tpu_torch.ops import resident_general as rg

    drives = ("y", "xy", "circular_left", "xy_cycle")
    # every drive at every L, the initial state and probe qubit varied
    for i, L in enumerate((14, 17, 20, 23)):
        for j, pol in enumerate(drives):
            state = ("vacuum", "neel")[(i + j) % 2]
            q = (0, L // 2, L - 1)[(i + j) % 3]
            T = 6 if L < 23 else 3
            rows = general_forward_inputs(L, pol, T, 2, 0.1, dev, seed=L + j)
            d, _ = against_plain(
                f"K4 forward L={L} {pol} T={T} {state} q={q}",
                rg.general_forward_batch, rg.general_forward_batch_ref,
                (rows,), dict(L=L, T=T, q=q, initial_state=state))
            err["K4 forward"] = max(err["K4 forward"], d)
        pol = drives[i]
        for p in (0.6, 0.0):
            tiles = general_echo_inputs(L, pol, 3, 2, p, [0, 1, 2, 3], dev,
                                        seed=L)
            q = (L // 2, L - 1, 0, L // 2)[i]
            d, k = against_plain(
                f"K4 echo L={L} {pol} T=3 ts=0..3 p={p} q={q}",
                rg.general_echo_batch, rg.general_echo_batch_ref, (tiles,),
                dict(L=L, q=q))
            if p == 0.0 and not float((k - 1).abs().max()) <= TOL:
                raise RuntimeError(f"noiseless echo != 1: {k.tolist()}")
            err["K4 echo"] = max(err["K4 echo"], d)
    # the main path's own shapes: the xy forward batch of 32 trajectories
    # through all 50 cycles, and the xy echo sweep's last two chunks (trip
    # counts up to 196 steps)
    rows = general_forward_inputs(20, "xy", 50, 32, P, dev, seed=50)
    d, _ = against_plain("K4 forward L=20 xy T=50 1x32",
                         rg.general_forward_batch,
                         rg.general_forward_batch_ref, (rows,),
                         dict(L=20, T=50, q=10))
    err["K4 forward"] = max(err["K4 forward"], d)
    for ts in (list(range(40, 48)), [48, 49]):
        tiles = general_echo_inputs(20, "xy", 50, 32, P, ts, dev, seed=ts[0])
        d, _ = against_plain(f"K4 echo L=20 xy T=50 ts={ts[0]}..{ts[-1]} 1x32",
                             rg.general_echo_batch, rg.general_echo_batch_ref,
                             (tiles,), dict(L=20, q=10))
        err["K4 echo"] = max(err["K4 echo"], d)
        del tiles


def obs_inputs(L, pol, component, T, c, p, dev, seed, inst=1):
    """(rows, energy rows, with_x, sum|th| + sum|tph|) of K5 on the CLI's
    default disorder."""
    from dtc_tpu_torch.models.hamiltonian import hamiltonian_terms
    from dtc_tpu_torch.ops.observables import energy_row
    from dtc_tpu_torch.ops.params_general import general_forward_rows

    hs, phis = disorder(L, dev, inst)
    angles = schedule(pol, T, dev)
    K = angles.shape[1]
    terms = [hamiltonian_terms(L, 0.97, hs[i], phis[i], component)
             for i in range(inst)]
    u = uniforms((inst, c, T * K, L), dev, seed)
    rows = general_forward_rows(u, hs[:, None], phis[:, None], angles, L=L,
                                T=T, K=K, p=p)
    erow = energy_row(torch.stack([t.hs for t in terms]),
                      torch.stack([t.phis for t in terms]), L)[:, None]
    scale = max(float(t.hs.abs().sum() + t.phis.abs().sum()) for t in terms)
    return rows, erow, terms[0].x_coeff != 0.0, scale


def compare_obs(dev, err) -> None:
    from dtc_tpu_torch.ops import observables as ob

    # every drive, state and component family across the range (3
    # trajectories of different rows), p=0 and p=0.3, the measure only
    # (T=1) and more cycles than one reduce chunk (ob.chunk_cycles: 6 at
    # L=14); then the main path's batch (32 trajectories through 50 cycles)
    cases = [(14, "x", "vacuum", "full", 0.0, 4),
             (14, "circular_left", "neel", "x_only", 0.3, 4),
             (14, "xy", "vacuum", "full", 0.3, 1),
             (14, "xy", "neel", "full", 0.3, 20),
             (17, "y", "neel", "z_zz", 0.3, 4),
             (17, "xy", "vacuum", "full", 0.3, 4),
             (20, "x", "vacuum", "full", 0.3, 4),
             (20, "xy", "neel", "x_only", 0.0, 4),
             (22, "xy_cycle", "neel", "full", 0.3, 3),
             (23, "y", "vacuum", "full", 0.3, 3),
             (23, "circular_left", "vacuum", "z_zz", 0.0, 3)]
    for L, pol, state, comp, p, T in cases:
        rows, erow, with_x, scale = obs_inputs(L, pol, comp, T, 3, p, dev,
                                               seed=L)
        kw = dict(L=L, T=T, initial_state=state, with_x=with_x)
        k = ob.observables_forward_batch(rows, erow, **kw)
        torch.cuda.synchronize()
        ref = ob.observables_forward_batch_ref(rows, erow, **kw)
        err["K5"] = max(err["K5"], held_obs(
            f"K5 L={L} {pol} {state} {comp} p={p} T={T}", k, ref, L, scale))
    # two instances in one launch against two one-instance launches
    rows, erow, _, scale = obs_inputs(17, "xy", "full", 3, 2, 0.3, dev,
                                      seed=3, inst=2)
    both = ob.observables_forward_batch(rows, erow, L=17, T=3)
    for i in range(2):
        one = ob.observables_forward_batch(rows[i:i + 1], erow[i:i + 1],
                                           L=17, T=3)
        err["K5"] = max(err["K5"], held_obs(
            f"K5 L=17 xy 2 instances, instance {i} vs its own launch",
            [a[i:i + 1] for a in both], one, 17, scale))
    rows, erow, _, scale = obs_inputs(MAIN_L, "x", "full", MAIN_T, N_TRAJ,
                                      0.1, dev, seed=50)
    kw = dict(L=MAIN_L, T=MAIN_T)
    k = ob.observables_forward_batch(rows, erow, **kw)
    torch.cuda.synchronize()
    ref = ob.observables_forward_batch_ref(rows, erow, **kw)
    err["K5"] = max(err["K5"], held_obs(
        f"K5 L={MAIN_L} x T={MAIN_T} 1x{N_TRAJ} p=0.1 full", k, ref, MAIN_L,
        scale))


def compare_eager(dev) -> None:
    """The torch eager observables engine (the energy route outside K5's
    range) on the card against the same call on the CPU."""
    from dtc_tpu_torch.core.evolve import (
        evolve_observables,
        make_floquet_params,
    )
    from dtc_tpu_torch.core.statevector import initial_statevector
    from dtc_tpu_torch.models.hamiltonian import hamiltonian_terms
    from dtc_tpu_torch.ops.diag import zz_z_diag_energy

    L, T, c, p = 12, 6, 4, 0.1
    cpu = torch.device("cpu")
    hs, phis = disorder(L, cpu)
    angles = schedule("xy", T, cpu)
    terms = hamiltonian_terms(L, 0.97, hs[0], phis[0])
    u = uniforms((c, T * 2, L), cpu, seed=12)
    for dtype, real in ((torch.complex64, torch.float32),
                        (torch.complex128, torch.float64)):
        out = []
        for d in (dev, cpu):
            psi0 = initial_statevector(L, "neel", dtype=dtype,
                                       device=d).expand(c, -1)
            e, z = evolve_observables(
                psi0, angles.to(d), make_floquet_params(
                    hs[0].to(d), phis[0].to(d), L, dtype=dtype),
                zz_z_diag_energy(terms.hs.to(d), terms.phis.to(d), L,
                                 dtype=real),
                terms.x_coeff, u.to(d), L=L, T=T, K=2, p=p)
            out.append((e.cpu(), z.cpu()))
        d_e = float((out[0][0] - out[1][0]).abs().max())
        d_z = float((out[0][1] - out[1][1]).abs().max())
        phase(f"[compare] eager observables L={L} xy {dtype} cuda vs cpu: "
              f"max|dE| {d_e:.3e}, max|dz| {d_z:.3e}")
        if not (d_e <= TOL and d_z <= TOL):
            raise RuntimeError("the eager observables engine on the card "
                               "disagrees with the CPU")


def compare_streamed(dev, err) -> None:
    """The streamed x family against its plain version (two passes at
    L <= 24, three above), and against K1/K2 on the same rows at L=22, 23;
    its launches here are not the main path's."""
    from dtc_tpu_torch.ops import resident_blocked as rb
    from dtc_tpu_torch.ops import streamed as sm

    for i, L in enumerate((22, 24, 26, 28)):
        c, T = (2, 8) if L < 28 else (1, 4)
        for j, q in enumerate((0, L // 2, L - 1)):
            state = ("vacuum", "neel")[(i + j) % 2]
            rows, sig = forward_inputs(L, T, c, 0.1, dev, seed=L + q)
            d, _ = against_plain(
                f"K6 forward L={L} T={T} {state} q={q} 1x{c}",
                sm.streamed_forward_batch, sm.streamed_forward_batch_ref,
                (rows, sig, THETA), dict(L=L, q=q, initial_state=state))
            err["K6 forward"] = max(err["K6 forward"], d)
        q = (L // 2, L - 1, 0, L // 2)[i]
        state = ("neel", "vacuum")[i % 2]
        for p in (0.6, 0.0):
            tiles, sig = echo_inputs(L, 4, 1, p, [1, 2, 3, 4], dev, seed=L)
            d, k = against_plain(
                f"K6 echo L={L} ts=1..4 p={p} {state} q={q}",
                sm.streamed_echo_batch, sm.streamed_echo_batch_ref,
                (tiles, sig, THETA), dict(L=L, q=q, initial_state=state))
            if p == 0.0 and not float((k - 1).abs().max()) <= TOL:
                raise RuntimeError(f"noiseless echo != 1: {k.tolist()}")
            err["K6 echo"] = max(err["K6 echo"], d)
            del tiles
    for L in (22, 23):
        rows, sig = forward_inputs(L, 8, 4, 0.1, dev, seed=L)
        kw = dict(L=L, q=L // 2)
        err["K6 forward"] = max(err["K6 forward"], held(
            f"K6 forward vs K1 L={L} T=8 1x4",
            sm.streamed_forward_batch(rows, sig, THETA, **kw),
            rb.blocked_forward_batch(rows, sig, THETA, **kw)))
        tiles, sig = echo_inputs(L, 4, 2, 0.6, [1, 2, 3, 4], dev, seed=L)
        err["K6 echo"] = max(err["K6 echo"], held(
            f"K6 echo vs K2 L={L} ts=1..4 p=0.6 1x2",
            sm.streamed_echo_batch(tiles, sig, THETA, **kw),
            rb.blocked_echo_batch(tiles, sig, THETA, **kw)))


def compare_general_hi(dev, err) -> None:
    """The streamed lab-frame family (K10) against its plain version at
    L=22, 24 (two passes), 25, 26, 28 and 29 (three): y (K=1),
    circular_left (K=2) and xy_cycle (x for two cycles, then y) at each L
    with q = 0, L//2, L-1 and vacuum and neel in turn, forward (T=4) at
    p=0.6 and echo (t = 0, 1, 3) at p=0.6 and 0; and
    against K4 on the same rows at L=22, 23. The L=29 comparison on the main
    path's own shapes is in the timing phase; these launches are not the
    main path's."""
    from dtc_tpu_torch.ops import cycle_hi_general as chg
    from dtc_tpu_torch.ops import resident_general as rg

    drives = ("y", "circular_left", "xy_cycle")
    for i, L in enumerate((22, 24, 25, 26, 28, 29)):
        c = 2 if L < 28 else 1
        for j, pol in enumerate(drives):
            state = ("vacuum", "neel")[(i + j) % 2]
            q = (0, L // 2, L - 1)[(i + j) % 3]
            rows = general_forward_inputs(L, pol, 4, c, 0.6, dev, seed=L + j)
            d, _ = against_plain(
                f"K10 forward L={L} {pol} T=4 {state} q={q} 1x{c}",
                chg.general_hi_forward_batch, chg.general_hi_forward_batch_ref,
                (rows,), dict(L=L, T=4, q=q, initial_state=state))
            err["K10 forward"] = max(err["K10 forward"], d)
            del rows
        pol = drives[i % 3]
        state = ("neel", "vacuum")[i % 2]
        q = (L // 2, L - 1, 0)[i % 3]
        for p in (0.6, 0.0):
            tiles = general_echo_inputs(L, pol, 4, 1, p, [0, 1, 3], dev,
                                        seed=L)
            d, k = against_plain(
                f"K10 echo L={L} {pol} T=4 ts=0,1,3 p={p} {state} q={q}",
                chg.general_hi_echo_batch, chg.general_hi_echo_batch_ref,
                (tiles,), dict(L=L, q=q, initial_state=state))
            if p == 0.0 and not float((k - 1).abs().max()) <= TOL:
                raise RuntimeError(f"noiseless echo != 1: {k.tolist()}")
            err["K10 echo"] = max(err["K10 echo"], d)
            del tiles
    for L in (22, 23):
        rows = general_forward_inputs(L, "xy", 8, 4, 0.1, dev, seed=L)
        kw = dict(L=L, q=L // 2)
        err["K10 forward"] = max(err["K10 forward"], held(
            f"K10 forward vs K4 L={L} xy T=8 1x4",
            chg.general_hi_forward_batch(rows, T=8, **kw),
            rg.general_forward_batch(rows, T=8, **kw)))
        tiles = general_echo_inputs(L, "circular_left", 4, 2, 0.6,
                                    [1, 2, 3, 4], dev, seed=L)
        err["K10 echo"] = max(err["K10 echo"], held(
            f"K10 echo vs K4 L={L} circular_left ts=1..4 p=0.6 1x2",
            chg.general_hi_echo_batch(tiles, **kw),
            rg.general_echo_batch(tiles, **kw)))


def x_schedule(T, dev, per_cycle):
    """(T, 1, 2) x schedule: the per-cycle ramp theta_t = pi g_t, g from
    0.86 to 0.99, or the constant g = 0.97."""
    from dtc_tpu_torch.models.drives import build_kick_schedule

    g = (torch.linspace(0.86, 0.99, T, dtype=torch.float64, device=dev)
         if per_cycle else 0.97)
    return build_kick_schedule("x", g, T, device=dev).angles


def ramp_inputs(L, T, c, p, ts, dev, seed):
    """The ramp's schedule with K3's rows and K4's rows from the same
    uniforms: (angles, rows, sig_after, general rows) for the forward, or
    (angles, tiles, sig_fin, general tiles) for the echo at ``ts``."""
    from dtc_tpu_torch.ops.params import echo_pair_tiles, forward_rows
    from dtc_tpu_torch.ops.params_general import (
        general_echo_rows,
        general_forward_rows,
    )

    hs, phis = disorder(L, dev)
    angles = x_schedule(T, dev, True)
    h, ph = hs[:, None], phis[:, None]
    if ts is None:
        u = uniforms((1, c, T, L), dev, seed)
        rows, sig = forward_rows(u, h, ph, L=L, T=T, p=p)
        return angles, rows, sig, general_forward_rows(
            u, h, ph, angles, L=L, T=T, K=1, p=p)
    u = uniforms((1, c, 2 * T, L), dev, seed)
    ts = torch.as_tensor(ts, device=dev)
    tiles, sig = echo_pair_tiles(u, ts, h, ph, L=L, T=T, p=p)
    return angles, tiles, sig, general_echo_rows(u, ts, h, ph, angles, L=L,
                                                 T=T, K=1, p=p)


def compare_resident(dev, err) -> None:
    """The resident x family (K3a/K3b) against its plain version: constant x
    at L=14, 15, 16 (its route) and the per-cycle ramp at L=14, 17, 20, 21
    (q = 0, L//2, L-1 and vacuum and neel in turn; forward T=6 at p=0.1,
    echo t = 0, 1, 2, 4 at p=0.6 and 0), and at the shapes of the L=16
    main path (constant x, T=50, 2 x 32 trajectories, the forward and
    every echo chunk); against K1/K2 on the same rows
    (constant, L=17) and against K4 (the ramp, L=20). These launches are
    not the main path's."""
    from dtc_tpu_torch.ops import resident as rs
    from dtc_tpu_torch.ops import resident_blocked as rb
    from dtc_tpu_torch.ops import resident_general as rg

    cases = [(14, False), (15, False), (16, False), (14, True), (17, True),
             (20, True), (21, True)]
    for i, (L, per_cycle) in enumerate(cases):
        what = "ramp" if per_cycle else "constant"
        for j, q in enumerate((0, L // 2, L - 1)):
            state = ("vacuum", "neel")[(i + j) % 2]
            rows, sig = forward_inputs(L, 6, 3, 0.1, dev, seed=L + q)
            d, _ = against_plain(
                f"K3 forward L={L} {what} T=6 {state} q={q} 1x3",
                rs.resident_forward_batch, rs.resident_forward_batch_ref,
                (rows, sig, x_schedule(6, dev, per_cycle)),
                dict(L=L, q=q, initial_state=state, time_dependent=per_cycle))
            err["K3 forward"] = max(err["K3 forward"], d)
        q, state = (L // 2, L - 1, 0)[i % 3], ("neel", "vacuum")[i % 2]
        for p in (0.6, 0.0):
            tiles, sig = echo_inputs(L, 4, 2, p, [0, 1, 2, 4], dev, seed=L)
            d, k = against_plain(
                f"K3 echo L={L} {what} ts=0,1,2,4 p={p} {state} q={q} 1x2",
                rs.resident_echo_batch, rs.resident_echo_batch_ref,
                (tiles, sig, x_schedule(4, dev, per_cycle)),
                dict(L=L, q=q, initial_state=state, time_dependent=per_cycle))
            if p == 0.0 and not float((k - 1).abs().max()) <= TOL:
                raise RuntimeError(f"noiseless echo != 1: {k.tolist()}")
            err["K3 echo"] = max(err["K3 echo"], d)
    # the forward at T = 1 (no cycle runs) and T = 57, constant and ramp,
    # probes in pass lo's bits and pass hi's (split a = L - L/2)
    for L in (14, 16, 21):
        a = L - L // 2
        for T, per_cycle in ((1, True), (57, False), (57, True)):
            rows, sig = forward_inputs(L, T, 3, 0.1, dev, seed=L + T)
            what = "ramp" if per_cycle else "constant"
            for q, state in ((0, "neel"), (a - 1, "vacuum"), (a, "neel"),
                             (L - 1, "vacuum")):
                d, _ = against_plain(
                    f"K3 forward L={L} {what} T={T} {state} q={q} 1x3",
                    rs.resident_forward_batch, rs.resident_forward_batch_ref,
                    (rows, sig, x_schedule(T, dev, per_cycle)),
                    dict(L=L, q=q, initial_state=state,
                         time_dependent=per_cycle))
                err["K3 forward"] = max(err["K3 forward"], d)
    # the L=16 main path's shapes: the constant drive's forward on 2
    # instances x 32 trajectories through all 50 cycles, and every chunk of
    # its echo sweep (t_chunk=8: ts 0..7, ..., 48..49; trips up to 98)
    rows, sig = forward_inputs(16, MAIN_T, N_TRAJ, P, dev, seed=16, inst=2)
    d, _ = against_plain(
        f"K3 forward L=16 constant T={MAIN_T} 2x{N_TRAJ}",
        rs.resident_forward_batch, rs.resident_forward_batch_ref,
        (rows, sig, x_schedule(MAIN_T, dev, False)), dict(L=16, q=8))
    err["K3 forward"] = max(err["K3 forward"], d)
    for t0 in range(0, MAIN_T, 8):
        ts = list(range(t0, min(t0 + 8, MAIN_T)))
        tiles, sig = echo_inputs(16, MAIN_T, N_TRAJ, P, ts, dev, seed=16,
                                 inst=2)
        d, _ = against_plain(
            f"K3 echo L=16 constant T={MAIN_T} ts={ts[0]}..{ts[-1]} p={P} "
            f"2x{N_TRAJ}", rs.resident_echo_batch, rs.resident_echo_batch_ref,
            (tiles, sig, x_schedule(MAIN_T, dev, False)), dict(L=16, q=8))
        err["K3 echo"] = max(err["K3 echo"], d)
    rows, sig = forward_inputs(17, 8, 4, 0.1, dev, seed=17)
    err["K3 forward"] = max(err["K3 forward"], held(
        "K3 forward vs K1 L=17 constant T=8 1x4",
        rs.resident_forward_batch(rows, sig, x_schedule(8, dev, False),
                                  L=17, q=8),
        rb.blocked_forward_batch(rows, sig, THETA, L=17, q=8)))
    tiles, sig = echo_inputs(17, 4, 2, 0.6, [1, 2, 3, 4], dev, seed=17)
    err["K3 echo"] = max(err["K3 echo"], held(
        "K3 echo vs K2 L=17 constant ts=1..4 p=0.6 1x2",
        rs.resident_echo_batch(tiles, sig, x_schedule(4, dev, False), L=17,
                               q=8),
        rb.blocked_echo_batch(tiles, sig, THETA, L=17, q=8)))
    angles, rows, sig, grows = ramp_inputs(20, 8, 3, 0.1, None, dev, seed=20)
    err["K3 forward"] = max(err["K3 forward"], held(
        "K3 forward vs K4 L=20 ramp T=8 1x3",
        rs.resident_forward_batch(rows, sig, angles, L=20, q=10,
                                  time_dependent=True),
        rg.general_forward_batch(grows, L=20, T=8, q=10)))
    angles, tiles, sig, gtiles = ramp_inputs(20, 8, 2, 0.6, [1, 3, 8], dev,
                                             seed=21)
    err["K3 echo"] = max(err["K3 echo"], held(
        "K3 echo vs K4 L=20 ramp ts=1,3,8 p=0.6 1x2",
        rs.resident_echo_batch(tiles, sig, angles, L=20, q=10,
                               time_dependent=True),
        rg.general_echo_batch(gtiles, L=20, q=10)))


def cycle_x_rows(L, T, c, p, dev, seed):
    """The x cycle engines' rows at L = L_loc from uniforms (c, T, L) (no
    shard bits): forward rows (c, T, forward_width(L)) of (zm, sigma after
    the event);
    inverse rows of (the previous event's zm, zeroed at the turnaround
    t = T // 2; sigma before the event); and the final sigma (c,)."""
    from dtc_tpu_torch.core.sigma_evolve import (
        _codes_from_uniform,
        _masks_from_codes,
        xor_scan,
    )
    from dtc_tpu_torch.ops.params import (
        forward_width,
        pack_cycle_params_compact,
    )

    hs, phis = disorder(L, dev)
    if p > 0:
        xm, zm = _masks_from_codes(_codes_from_uniform(
            uniforms((c, T, L), dev, seed), p), L)
    else:
        xm = zm = torch.zeros((c, T), dtype=torch.int64, device=dev)
    csum = xor_scan(xm, L)

    def prev(w):
        return torch.cat([torch.zeros_like(w[:, :1]), w[:, :-1]], 1)

    zm_prev = prev(zm)
    zm_prev[:, T // 2] = 0
    width = forward_width(L)
    rows_f = pack_cycle_params_compact(zm, csum, hs[0], phis[0], L, width)
    rows_i = pack_cycle_params_compact(zm_prev, prev(csum), hs[0], phis[0], L,
                                       width)
    return rows_f, rows_i, csum[:, -1]


def cycle_fold(rows, L, seed, inverse=False):
    """K8a's (K8b's with ``inverse``) folded row pairs of compact rows (c,
    width) with non-zero global angles: a shard's th_sc and th_bnd per
    trajectory, uniform in [-pi, pi), from ``seed``."""
    from dtc_tpu_torch.ops import cycle as cy

    gen = torch.Generator(device=rows.device).manual_seed(seed)
    th = (torch.rand((2, rows.shape[0]), generator=gen, device=rows.device)
          - 0.5) * (2 * math.pi)
    return cy.fold_cycle_rows(rows, L, *th, inverse=inverse)


def general_fold(rows, L, seed, inverse=False, angles=True):
    """K8c's and K10a's folded rows of slot rows (c, K, width) (K8d's and
    K10b's of slot pairs (c, K, 2, width) with ``inverse``), with non-zero
    global angles as ``cycle_fold`` draws them, or none with
    ``angles=False``."""
    from dtc_tpu_torch.ops import cycle as cy

    th = (None, None)
    if angles:
        gen = torch.Generator(device=rows.device).manual_seed(seed)
        th = (torch.rand((2, rows.shape[0]), generator=gen,
                         device=rows.device) - 0.5) * (2 * math.pi)
    return cy.fold_general_rows(rows, L, *th, inverse=inverse)


def held_chain(what, key, err, steps, L, state, dev, c=2):
    """Run each (kernel, plain) step on two copies of the basis state; a
    step returns its partial or None. Holds every partial and the final
    state within TOL; returns the kernel's final state."""
    from dtc_tpu_torch.core.statevector import basis_index
    from dtc_tpu_torch.ops import resident_blocked as rb

    a = rb.basis_states(c, L, basis_index(L, state), dev)
    b = a.clone()
    d = 0.0
    for kernel, plain in steps:
        ka, pb = kernel(a), plain(b)
        torch.cuda.synchronize()
        if ka is not None:
            d = max(d, float((ka - pb).abs().max()))
    d = max(d, float((a - b).abs().max()))
    phase(f"[compare] {what}: max|kernel-plain| = {d:.3e} (partials and "
          "final state)")
    if not d <= TOL:
        raise RuntimeError(f"{what}: kernel disagrees with its plain version"
                           f" by {d} > {TOL}")
    err[key] = max(err[key], d)
    return a


def no_partial(fn):
    return lambda s: (fn(s), None)[1]


def unit_tol(L):
    """The limit on states drawn as random unit vectors of 2^L amplitudes,
    and on their partials sum |psi|^2 z_q, which are of the same size: one
    part in 10^3 of a typical amplitude, 2^(-L/2). TOL on such a state
    would pass a kernel that is wrong by a typical amplitude."""
    return 1e-3 * 2 ** (-L / 2)


def held_unit(what, key, err, kernel, plain, starts, args, kw, L):
    """One call of ``kernel`` and of ``plain`` on copies of each random unit
    state of ``starts``: the states and the forwards' partials held within
    unit_tol(L). Returns the kernel's states."""
    a = [st.clone() for st in starts]
    b = [st.clone() for st in starts]
    ka = [kernel(st, *args, **kw) for st in a]
    pb = [plain(st, *args, **kw) for st in b]
    torch.cuda.synchronize()
    d = max(float((x - y).abs().max()) for x, y in zip(a, b))
    if isinstance(ka[0], tuple):  # the forwards' partials
        d = max(d, *(float((x[1] - y[1]).abs().max())
                     for x, y in zip(ka, pb)))
    del b, pb
    lim = unit_tol(L)
    phase(f"[compare] {what}: max|kernel-plain| = {d:.3e} (<= {lim:.3e}, "
          "1e-3 of a typical amplitude)")
    if not d <= lim:
        raise RuntimeError(f"{what}: kernel disagrees with its plain version"
                           f" by {d} > {lim}")
    err[key] = max(err[key], d)
    return a


def compare_cycle(dev, err) -> None:
    """K8a-d against their plain versions on one shard's local bits at
    L_loc = 17, 20, 23, 2 trajectories, q = 0, L//2, 15, L-1 with vacuum and
    neel in turn: K8a over T=4 cycles and K8c (y, xy, circular_left,
    xy_cycle in turn) over T=4 cycles from the basis state, every cycle's
    partial (the first is one cycle's) and the final state held; the x echo
    at t=2 (K8a twice without a measure, the turnaround conjugation, K8b
    twice on the inverse rows) and K8d on every step of the general echo
    rows at t=2, at p=0.6 and 0 (the noiseless echo = 1). Every kernel's
    rows are folded with non-zero global angles (``cycle_fold``,
    ``general_fold``; q = L-1 is the local top bit, where th_bnd lands); at
    p=0 the echoes' have none, as on a (1,1) mesh. These launches are not
    the main path's."""
    from dtc_tpu_torch.core.statevector import basis_index
    from dtc_tpu_torch.ops import cycle as cy
    from dtc_tpu_torch.ops import resident_blocked as rb

    drives = ("y", "xy", "circular_left", "xy_cycle")
    c = 2

    def k8a(r, L, q=None):
        return (lambda s: cy.cycle_forward_apply(s, r, THETA, L=L, q=q)[1],
                lambda s: cy.cycle_forward_apply_ref(s, r, THETA, L=L,
                                                     q=q)[1])

    def conj(s):
        s.imag.neg_()

    for i, L in enumerate((17, 20, 23)):
        for j, q in enumerate((0, L // 2, 15, L - 1)):
            state = ("vacuum", "neel")[(i + j) % 2]
            rows = cycle_x_rows(L, 4, c, 0.6, dev, seed=L + q)[0]
            held_chain(f"K8a L_loc={L} T=4 {state} q={q} 1x{c} (global "
                       "angles)", "K8a", err,
                       [k8a(cycle_fold(r, L, seed=L + q + k), L, q)
                        for k, r in enumerate(rows.unbind(1))], L, state, dev)
            pol = drives[(i + j) % 4]
            grows = general_forward_inputs(L, pol, 4, c, 0.6, dev,
                                           seed=L + j)[0]
            K = grows.shape[-2] // 4
            steps = [(lambda s, r=r.contiguous(), f=general_fold(
                          r, L, L + q + k):
                      cy.general_cycle_forward_apply(s, r, f, L=L, K=K,
                                                     q=q)[1],
                      lambda s, r=r, f=general_fold(r, L, L + q + k):
                      cy.general_cycle_forward_apply_ref(s, r, f, L=L, K=K,
                                                         q=q)[1])
                     for k, r in enumerate(grows.reshape(c, 4, K,
                                                         -1).unbind(1))]
            held_chain(f"K8c L_loc={L} {pol} T=4 {state} q={q} 1x{c} (global"
                       " angles)", "K8c", err, steps, L, state, dev)
        q, state = (L // 2, L - 1, 15)[i], ("neel", "vacuum")[i % 2]
        s0 = rb.basis_sign(basis_index(L, state), q)
        zq = rb.angle_table(L, dev)[q]
        for p in (0.6, 0.0):
            rows_f, rows_i, sig = cycle_x_rows(L, 4, c, p, dev, seed=L)

            def fold(r, seed, inverse=False):
                if p == 0.0:
                    return cy.fold_cycle_rows(r, L, inverse=inverse)
                return cycle_fold(r, L, seed, inverse)

            steps = [k8a(fold(r, L + k), L)
                     for k, r in enumerate(rows_f[:, :2].unbind(1))]
            steps.append((conj, conj))
            steps += [(no_partial(lambda s, r=fold(r, L + k, True):
                                  cy.cycle_inverse_apply(s, r, THETA, L=L)),
                       no_partial(lambda s, r=fold(r, L + k, True):
                                  cy.cycle_inverse_apply_ref(s, r, THETA,
                                                             L=L)))
                      for k, r in enumerate(rows_i[:, 2:].unbind(1))]
            st = held_chain(f"K8a/K8b echo L_loc={L} t=2 p={p} {state} q={q}"
                            f" 1x{c}", "K8b", err, steps, L, state, dev)
            echo = (s0 * rb._sigma_sign(sig, q)
                    * ((st.real ** 2 + st.imag ** 2) @ zq))
            if p == 0.0 and not float((echo - 1).abs().max()) <= TOL:
                raise RuntimeError(f"noiseless x echo != 1: {echo.tolist()}")
            pol = drives[(i + 1) % 4]
            tiles = general_echo_inputs(L, pol, 2, c, p, [2], dev, seed=L)
            K = tiles.shape[-2] // 8
            # at p=0 the rows carry no global angles (a (1,1) mesh), so
            # that the echo is 1
            steps = [(no_partial(lambda s, r=r.contiguous(), f=general_fold(
                          r, L, L + k, True, p > 0):
                                 cy.general_cycle_inverse_apply(s, r, f, L=L,
                                                                K=K)),
                      no_partial(lambda s, r=r, f=general_fold(
                          r, L, L + k, True, p > 0):
                                 cy.general_cycle_inverse_apply_ref(
                                     s, r, f, L=L, K=K)))
                     for k, r in enumerate(tiles.reshape(c, 4, K, 2,
                                                         -1).unbind(1))]
            st = held_chain(f"K8d echo L_loc={L} {pol} t=2 p={p} {state} "
                            f"q={q} 1x{c}", "K8d", err, steps, L, state,
                            dev)
            echo = s0 * ((st.real ** 2 + st.imag ** 2) @ zq)
            if p == 0.0 and not float((echo - 1).abs().max()) <= TOL:
                raise RuntimeError(f"noiseless general echo != 1: "
                                   f"{echo.tolist()}")


def z_of(st, q, L):
    """sum |psi|^2 z_q of each state of (c, 2^L), with no table over 2^L."""
    from dtc_tpu_torch.ops import streamed as sm

    return torch.stack([sm.measure_z(s, q, L) for s in st])


# (L_loc, q): every band of the streamed passes at 22 (pass lo 0, the
# strided bits 14 and 16, L//2, the top bit), two of them at each other L
HI_PROBES = [(22, 0), (22, 14), (22, 16), (22, 11), (22, 21), (24, 16),
             (24, 23), (25, 0), (25, 12), (27, 14), (27, 26), (29, 16),
             (29, 28)]


# K10's shard-local forms: (L_loc, forward chains (drive, q, state), echoes
# (drive, q, state, p)); y, xy, circular_left and xy_cycle at 24, 26 and 29,
# and the shape of the sharded general main path (xy, K=2, L_loc = 27, q=14)
GENERAL_HI_PROBES = [
    (24, [("y", 16, "vacuum"), ("xy", 12, "neel")],
     [("circular_left", 23, "neel", 0.6), ("xy_cycle", 14, "vacuum", 0.0)]),
    (26, [("xy", 13, "neel"), ("circular_left", 25, "vacuum")],
     [("xy_cycle", 25, "neel", 0.6), ("y", 14, "vacuum", 0.0)]),
    (27, [("xy", 14, "vacuum")],
     [("xy", 14, "neel", 0.6), ("xy", 14, "vacuum", 0.0)]),
    (29, [("circular_left", 28, "vacuum"), ("xy_cycle", 16, "neel")],
     [("y", 28, "neel", 0.6), ("xy", 14, "vacuum", 0.0)]),
]


def compare_cycle_hi(dev, err) -> None:
    """K9a/K9b and K10's shard-local forms against their plain versions on
    one shard's local bits, 2 trajectories, vacuum and neel in turn: K9a
    over chains of 4 cycles (3 at L_loc = 29) at the (L_loc, q) of
    HI_PROBES, every partial and the final state held; the x echo at t=2
    (K9a twice without a measure, the turnaround conjugation, K9b twice on
    the inverse rows) at L_loc = 22, 24, 25, 27, 29 at p=0.6 and 0 (the
    noiseless echo = 1); at the L_loc of GENERAL_HI_PROBES K10a shard-local
    over chains of 3 cycles, and K10b on every step of the general echo rows
    at t=2 (p=0.6, then 0). The rows of all four are folded with non-zero
    global angles (``cycle_fold``, ``general_fold``); at p=0 the echoes'
    have none, as on a (1,1) mesh. Then L_loc = 30
    (``compare_cycle_hi_l30``). These launches are not the main path's."""
    from dtc_tpu_torch.core.statevector import basis_index
    from dtc_tpu_torch.ops import cycle as cy
    from dtc_tpu_torch.ops import cycle_hi as chi
    from dtc_tpu_torch.ops import resident_blocked as rb
    from dtc_tpu_torch.ops.params_general import general_hi_width

    c = 2

    def k9a(r, L, q=None):
        return (lambda s: chi.hi_cycle_forward_apply(s, r, THETA, L=L,
                                                     q=q)[1],
                lambda s: chi.hi_cycle_forward_apply_ref(s, r, THETA, L=L,
                                                         q=q)[1])

    def k9b(r, L):
        return (no_partial(lambda s: chi.hi_cycle_inverse_apply(s, r, THETA,
                                                                L=L)),
                no_partial(lambda s: chi.hi_cycle_inverse_apply_ref(
                    s, r, THETA, L=L)))

    def conj(s):
        s.imag.neg_()

    for i, (L, q) in enumerate(HI_PROBES):
        state = ("vacuum", "neel")[i % 2]
        T = 3 if L == 29 else 4
        rows = cycle_x_rows(L, T, c, 0.6, dev, seed=L + q)[0]
        held_chain(f"K9a L_loc={L} T={T} {state} q={q} 1x{c} (global "
                   "angles)", "K9a", err,
                   [k9a(cycle_fold(r, L, seed=L + q + k), L, q)
                    for k, r in enumerate(rows.unbind(1))], L, state, dev)
    for i, L in enumerate((22, 24, 25, 27, 29)):
        q, state = (L - 1, 16, 0, L // 2, 14)[i], ("neel", "vacuum")[i % 2]
        s0 = rb.basis_sign(basis_index(L, state), q)
        for p in (0.6, 0.0):
            rows_f, rows_i, sig = cycle_x_rows(L, 4, c, p, dev, seed=L)

            def fold(r, seed, inverse=False):
                if p == 0.0:
                    return cy.fold_cycle_rows(r, L, inverse=inverse)
                return cycle_fold(r, L, seed, inverse)

            steps = [k9a(fold(r, L + k), L)
                     for k, r in enumerate(rows_f[:, :2].unbind(1))]
            steps.append((conj, conj))
            steps += [k9b(fold(r, L + k, True), L)
                      for k, r in enumerate(rows_i[:, 2:].unbind(1))]
            st = held_chain(f"K9a/K9b echo L_loc={L} t=2 p={p} {state} q={q}"
                            f" 1x{c}", "K9b", err, steps, L, state, dev)
            echo = s0 * rb._sigma_sign(sig, q) * z_of(st, q, L)
            if p == 0.0 and not float((echo - 1).abs().max()) <= TOL:
                raise RuntimeError(f"noiseless x echo != 1 at L_loc={L}: "
                                   f"{echo.tolist()}")
            del st
    for L, fwd, ech in GENERAL_HI_PROBES:
        w = general_hi_width(L)
        for j, (pol, q, state) in enumerate(fwd):
            grows = general_forward_inputs(L, pol, 3, c, 0.6, dev, seed=L + j,
                                           width=w)[0]
            K = grows.shape[-2] // 3
            steps = [(lambda s, r=r.contiguous(), f=general_fold(
                          r, L, L + q + k):
                      chi.general_hi_cycle_forward_apply(s, r, f, L=L, K=K,
                                                         q=q)[1],
                      lambda s, r=r, f=general_fold(r, L, L + q + k):
                      chi.general_hi_cycle_forward_apply_ref(
                          s, r, f, L=L, K=K, q=q)[1])
                     for k, r in enumerate(grows.reshape(c, 3, K,
                                                         w).unbind(1))]
            held_chain(f"K10a shard-local L_loc={L} {pol} T=3 {state} q={q} "
                       f"1x{c} ({w} lanes, global angles)", "K10a local",
                       err, steps, L, state, dev)
        for pol, q, state, p in ech:
            s0 = rb.basis_sign(basis_index(L, state), q)
            tiles = general_echo_inputs(L, pol, 2, c, p, [2], dev, seed=L,
                                        width=w)
            K = tiles.shape[-2] // 8
            # at p=0 the rows carry no global angles (a (1,1) mesh), so
            # that the echo is 1
            steps = [(no_partial(lambda s, r=r.contiguous(), f=general_fold(
                          r, L, L + k, True, p > 0):
                                 chi.general_hi_cycle_inverse_apply(
                                     s, r, f, L=L, K=K)),
                      no_partial(lambda s, r=r, f=general_fold(
                          r, L, L + k, True, p > 0):
                                 chi.general_hi_cycle_inverse_apply_ref(
                                     s, r, f, L=L, K=K)))
                     for k, r in enumerate(tiles.reshape(c, 4, K, 2,
                                                         w).unbind(1))]
            st = held_chain(f"K10b shard-local echo L_loc={L} {pol} t=2 "
                            f"p={p} {state} q={q} 1x{c}", "K10b local", err,
                            steps, L, state, dev)
            echo = s0 * z_of(st, q, L)
            if p == 0.0 and not float((echo - 1).abs().max()) <= TOL:
                raise RuntimeError(f"noiseless general echo != 1 at "
                                   f"L_loc={L}: {echo.tolist()}")
            del st
    compare_cycle_hi_l30(dev, err)


def compare_cycle_hi_l30(dev, err) -> None:
    """One cycle of each streamed per-shard kernel at L_loc = 30 (one
    trajectory, 8 GiB a state: offsets past 2^31 elements) against its plain
    version from the same random unit state, the state and the partial held
    within unit_tol(30), K9a also without a probe; the forwards' partials
    again from the neel basis state, where they are O(1) and their weight
    lies past byte 2^31 (at the neel index and its complement), within TOL;
    every kernel's rows folded with non-zero global angles; the peak device
    memory of the kernel/plain pairs."""
    from dtc_tpu_torch.ops import cycle_hi as chi
    from dtc_tpu_torch.ops.params_general import general_hi_width

    L, q = 30, 29
    gen = torch.Generator(device=dev).manual_seed(30)
    start = torch.randn((1, 1 << L), dtype=torch.complex64, generator=gen,
                        device=dev)
    start.div_(start.abs().pow(2).sum().sqrt())
    rows = cycle_x_rows(L, 2, 1, 0.6, dev, seed=30)[0][:, 1]
    fold_f, fold_i = (cycle_fold(rows, L, 30, inverse)
                      for inverse in (False, True))
    w = general_hi_width(L)
    grows = general_forward_inputs(L, "xy", 2, 1, 0.6, dev, seed=30,
                                   width=w)[0].reshape(1, 2, 2, w)[:, 1]
    tiles = general_echo_inputs(L, "circular_left", 2, 1, 0.6, [1], dev,
                                seed=31, width=w)[0].reshape(1, 4, 2, 2, w)
    grows, tiles = grows.contiguous(), tiles[:, 1].contiguous()
    gfold_f = general_fold(grows, L, 30)
    gfold_i = general_fold(tiles, L, 31, inverse=True)
    cases = [
        ("K9a", "forward x", chi.hi_cycle_forward_apply,
         chi.hi_cycle_forward_apply_ref, (fold_f, THETA), dict(L=L, q=q)),
        ("K9a", "forward x, no probe",
         lambda *a, **kw: chi.hi_cycle_forward_apply(*a, **kw)[0],
         lambda *a, **kw: chi.hi_cycle_forward_apply_ref(*a, **kw)[0],
         (fold_f, THETA), dict(L=L)),
        ("K9b", "inverse x", chi.hi_cycle_inverse_apply,
         chi.hi_cycle_inverse_apply_ref, (fold_i, THETA), dict(L=L)),
        ("K10a local", "forward xy", chi.general_hi_cycle_forward_apply,
         chi.general_hi_cycle_forward_apply_ref, (grows, gfold_f),
         dict(L=L, K=2, q=q)),
        ("K10b local", "inverse circular_left",
         chi.general_hi_cycle_inverse_apply,
         chi.general_hi_cycle_inverse_apply_ref, (tiles, gfold_i),
         dict(L=L, K=2)),
    ]
    torch.cuda.reset_peak_memory_stats(dev)
    for key, what, kernel, plain, args, kw in cases:
        what = f"{key} {what} L_loc={L} 1 trajectory"
        if key.startswith("K10"):
            what += f" ({args[0].shape[-1]} lanes)"
        held_unit(f"{what}, random unit state", key, err, kernel, plain,
                  [start], args, kw, L)
        if "q" in kw:
            held_chain(f"{what}, neel: the partial O(1)", key, err,
                       [(lambda s: kernel(s, *args, **kw)[1],
                         lambda s: plain(s, *args, **kw)[1])], L, "neel",
                       dev, c=1)
    phase(f"[compare] L_loc=30: peak device memory of the start state and "
          f"the kernel/plain pairs "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB (a state "
          f"8 GiB)")


def sharded_vs_unsharded(L, n_amp, pol, T, c, ts, dev, err) -> None:
    """The cycle-kernel engines on ``n_amp`` shards that share the card
    against the unsharded route at L on the same uniforms (p=0.6,
    ancilla factor 1, q = L_loc - 1, next to the shard bits): forward A(t)
    and the echo at ``ts``, each within TOL per time point."""
    from dtc_tpu_torch.ops import cycle_hi_general as chg
    from dtc_tpu_torch.ops import resident_blocked as rb
    from dtc_tpu_torch.ops import resident_general as rg
    from dtc_tpu_torch.ops import streamed as sm
    from dtc_tpu_torch.ops.params import echo_pair_tiles, forward_rows
    from dtc_tpu_torch.ops.params_general import (
        general_echo_rows,
        general_forward_rows,
    )
    from dtc_tpu_torch.parallel import sharded as sh
    from dtc_tpu_torch.parallel.mesh import make_mesh

    p = 0.6
    L_loc = L - (n_amp.bit_length() - 1)
    q = L_loc - 1
    hs, phis = disorder(L, dev)
    h, ph = hs[:, None], phis[:, None]
    angles = schedule(pol, T, dev)
    K = angles.shape[1]
    uf = uniforms((c, T * K, L), dev, seed=L)
    ue = uniforms((c, 2 * T, K, L), dev, seed=L + 1)
    tt = torch.as_tensor(ts, device=dev)
    kw = dict(L=L, T=T, p=p, q=q, ancilla_factor=1.0)
    mesh = make_mesh(n_amp, 1, devices=[dev] * n_amp)
    if pol == "x":
        fwd = sh.make_sharded_autocorr_forward_kernel(mesh, **kw)
        ech = sh.make_sharded_echo_kernel(mesh, **kw)
        rows, sig = forward_rows(uf[None], h, ph, L=L, T=T, p=p)
        tiles, sfin = echo_pair_tiles(ue.reshape(1, c, 2 * T, L), tt, h, ph,
                                      L=L, T=T, p=p)
        f_un, e_un, route = ((rb.blocked_forward_batch, rb.blocked_echo_batch,
                              "K1/K2") if L <= 23 else
                             (sm.streamed_forward_batch,
                              sm.streamed_echo_batch, "the streamed x family"))
        a_un = f_un(rows, sig, THETA, L=L, q=q)
        e_un = e_un(tiles, sfin, THETA, L=L, q=q)
    else:
        fwd = sh.make_sharded_autocorr_forward_general(mesh, K=K, **kw)
        ech = sh.make_sharded_echo_general(mesh, K=K, **kw)
        rows = general_forward_rows(uf[None], h, ph, angles, L=L, T=T, K=K,
                                    p=p)
        tiles = general_echo_rows(ue.reshape(1, c, 2 * T * K, L), tt, h, ph,
                                  angles, L=L, T=T, K=K, p=p)
        f_un, e_un, route = ((rg.general_forward_batch,
                              rg.general_echo_batch, "K4") if L <= 23 else
                             (chg.general_hi_forward_batch,
                              chg.general_hi_echo_batch, "K10"))
        a_un = f_un(rows, L=L, T=T, q=q)
        e_un = e_un(tiles, L=L, q=q)
    a_sh = fwd(angles, hs[0], phis[0], uf)
    e_sh = torch.stack([ech(angles, hs[0], phis[0], ue, t) for t in ts])
    torch.cuda.synchronize()
    d = max(float((a_sh - a_un[0].mean(0)).abs().max()),
            float((e_sh - e_un[0].mean(0)).abs().max()))
    what = (f"{pol} L={L} on {n_amp} shards (L_loc={L_loc}, q={q}) vs "
            f"{route} at L={L}, T={T} ts={ts} 1x{c} p={p}")
    phase(f"[compare] sharded {what}: max|sharded-unsharded| = {d:.3e} "
          f"(A[1:3] {a_sh[1:3].tolist()})")
    if not d <= TOL:
        raise RuntimeError(f"sharded {what}: disagrees by {d} > {TOL}")
    hi = L_loc >= 24
    fam = {("x", False): ("K8a", "K8b"), ("x", True): ("K9a", "K9b")}.get(
        (pol, hi), ("K10a local", "K10b local") if hi else ("K8c", "K8d"))
    for k in fam:
        err[k] = max(err[k], d)


def compare_sharded(dev, err) -> None:
    """The sharded route against the unsharded kernels on the card, the
    same uniforms: x at L=25 on 4 shards (L_loc 23: two shard bits and a
    shard-shard bond) against the streamed x family, xy at L=24 on 2 shards
    against K10, x and xy at L=19 on 4 shards against K1/K2 and K4, and a
    (1,1) mesh at L=17 against K1/K2; then through the streamed per-shard
    kernels: x at L=26 on 2 shards (K9a/K9b) against the streamed x family,
    xy at L=26 on 2 shards (K10's shard-local forms) against the one-card
    K10, and a (1,1) mesh at L=25 (K9a/K9b) against the streamed x
    family."""
    for L, n_amp, pol in ((25, 4, "x"), (24, 2, "xy"), (19, 4, "x"),
                          (19, 4, "xy"), (17, 1, "x"), (26, 2, "x"),
                          (26, 2, "xy"), (25, 1, "x")):
        sharded_vs_unsharded(L, n_amp, pol, 4, 2, [1, 2, 4], dev, err)



def compare_noise_factor(dev, err) -> None:
    """K11 against its plain version on identical inputs: L=20, 32 random
    normalised states with random tiles (the planar main path's batch), and
    L=30, one 8 GiB state (two planes of 2^30 f32: 64-bit offsets); max
    |kernel - plain| <= 1e-5 of the largest amplitude."""
    from dtc_tpu_torch.ops import noise_factor as nf

    for L, B in ((20, 32), (30, 1)):
        gen = torch.Generator(device=dev).manual_seed(L)
        st = torch.randn((B, 2, 1 << L), generator=gen, device=dev)
        st /= st.square().sum((1, 2), keepdim=True).sqrt()
        rnd = torch.randint(0, 1 << L, (2, B), generator=gen, device=dev)
        h, ph = ((torch.rand((B, n), generator=gen, device=dev) * 2 - 1)
                 * math.pi for n in (L, L - 1))
        par = nf.pack_cycle_params(rnd[0], rnd[1], h, ph, L)
        plain = nf.noise_factor_plain(st, par, L=L)
        st = nf.apply_noise_factor(st, par, L=L)  # in place on the card
        torch.cuda.synchronize()
        d = float((st - plain).abs().max())
        lim = 1e-5 * float(plain.abs().max())
        phase(f"[compare] K11 L={L} B={B} random unit states and tiles: "
              f"max|kernel-plain| = {d:.3e} (<= {lim:.3e}, 1e-5 of the "
              "largest amplitude)")
        if not d <= lim:
            raise RuntimeError(f"K11 disagrees with its plain version at "
                               f"L={L}: {d} > {lim}")
        err["K11"] = max(err["K11"], d)
        del st, plain
        torch.cuda.empty_cache()


def with_plain(mod, names, fn):
    """``fn()`` with the kernel entries ``names`` of ``mod`` replaced by
    their plain versions (``<name>_ref``), restored after."""
    saved = {n: getattr(mod, n) for n in names}
    try:
        for n in names:
            setattr(mod, n, getattr(mod, n + "_ref"))
        return fn()
    finally:
        for n, f in saved.items():
            setattr(mod, n, f)


def device_case(L, pol, T, dev, seed=7):
    """Disorder, rates (site-varying, dense events), schedule of a
    device-noise comparison."""
    hs, phis = disorder(L, dev, seed=seed)
    p1 = torch.linspace(0.05, 0.3, L, dtype=torch.float64, device=dev)
    p2 = torch.linspace(0.1, 0.4, L - 1, dtype=torch.float64, device=dev)
    return hs[0], phis[0], p1, p2, schedule(pol, T, dev)


def device_blocks(L, steps, e, n, dev, seed):
    from dtc_tpu_torch.core.device_evolve import n_bonds

    ne, no = n_bonds(L)
    return tuple(uniforms((n, steps, *s), dev, seed + i)
                 for i, s in enumerate(((e, L), (ne,), (no,))))


def compare_device(dev, err) -> None:
    """Device-noise rows on the lab-frame kernels against the kernels'
    plain versions on the same rows: K4 at L=20 (xy, T=8, 4 trajectories:
    the forward and the echo at t=1, 4, 8) through
    ``device_general_kernel_*_batch``, and K10's shard-local forms through
    the one-shard mesh engines (the device sweeps' route at 24 <= L <= 30)
    at L=24 (xy) and L=25 (y), T=3, 2 trajectories, the forward and the
    echo at t=1, 3. These launches are not the main path's."""
    from dtc_tpu_torch.core import device_evolve as de
    from dtc_tpu_torch.ops import cycle_hi as chi
    from dtc_tpu_torch.ops import resident_general as rg
    from dtc_tpu_torch.parallel import sharded as sh
    from dtc_tpu_torch.parallel.mesh import make_mesh

    L, T, n, pol = 20, 8, 4, "xy"
    args = device_case(L, pol, T, dev)
    K = args[-1].shape[1]
    kw = dict(L=L, T=T, K=K, q=L // 2, ancilla_factor=0.9)
    uf = device_blocks(L, T, 2 * K, n, dev, 20)
    ue = device_blocks(L, 2 * T, 2 * K, n, dev, 23)
    ts = [1, 4, 8]

    def k4():
        return (de.device_general_kernel_forward_batch(*args, uf, **kw),
                de.device_general_kernel_echo_batch(*args, ue, ts, **kw))

    got = k4()
    ref = with_plain(rg, ("general_forward_batch", "general_echo_batch"), k4)
    for name, g, r in zip(("K4 forward", "K4 echo"), got, ref):
        err[name] = max(err[name], held(
            f"{name} device rows L={L} {pol} T={T} 1x{n}", g, r))
    if not float(got[1].max() - got[1].min()) > 0.05:
        raise RuntimeError("device K4 echo: no event fired")
    mesh = make_mesh(1, 1, devices=[dev])
    for L, pol in ((24, "xy"), (25, "y")):
        T, n = 3, 2
        hs, phis, p1, p2, ang = device_case(L, pol, T, dev, seed=L)
        K = ang.shape[1]
        kw = dict(L=L, T=T, K=K, p=0.0, q=L // 2,
                  device=(p1, p2, 2))
        uf = device_blocks(L, T, 2 * K, n, dev, L)
        ue = device_blocks(L, 2 * T, 2 * K, n, dev, L + 3)

        def k10():
            a = sh.make_sharded_autocorr_forward_general(mesh, **kw)(
                ang, hs, phis, uf)
            echo = sh.make_sharded_echo_general(mesh, **kw)
            return a, torch.stack([echo(ang, hs, phis, ue, t)
                                   for t in (1, 3)])

        got = k10()
        ref = with_plain(chi, ("general_hi_cycle_forward_apply",
                               "general_hi_cycle_inverse_apply"), k10)
        for name, g, r in zip(("K10a local", "K10b local"), got, ref):
            err[name] = max(err[name], held(
                f"{name} device rows, one-shard mesh L={L} {pol} T={T} "
                f"1x{n}", g, r))


def anchors_l30(dev) -> None:
    """L=30, 8 GiB a state: values the physics fixes, which a wrapped 32-bit
    offset would break."""
    from dtc_tpu_torch.ops import streamed as sm
    from dtc_tpu_torch.ops.params import forward_rows

    L = 30
    hs, phis = disorder(L, dev)
    rows, sig = forward_rows(None, hs[:, None], phis[:, None], L=L, T=2,
                             p=0.0, batch=(1, 1))
    for q in (0, 15, L - 1):
        a = sm.streamed_forward_batch(rows, sig, THETA, L=L, q=q)
        d = abs(float(a[0, 0, 1]) - math.cos(THETA))
        phase(f"[anchor] L=30 forward p=0 vacuum q={q}: A(1) = "
              f"{float(a[0, 0, 1]):.7f}, |A(1) - cos(pi g)| = {d:.3e}")
        if not d <= 1e-5:
            raise RuntimeError(f"L=30 A(1) at q={q} is not cos(pi g)")
    tiles, sig = echo_inputs(L, 3, 1, 0.0, [1, 2, 3], dev, seed=30)
    e = sm.streamed_echo_batch(tiles, sig, THETA, L=L, q=15)
    d = float((e - 1).abs().max())
    phase(f"[anchor] L=30 noiseless echo t=1..3 q=15: {e.flatten().tolist()},"
          f" max|A0 - 1| = {d:.3e}")
    if not d <= TOL:
        raise RuntimeError("L=30 noiseless echo != 1")
    del tiles
    rows, sig = forward_inputs(L, 8, 1, P, dev, seed=31)
    a = sm.streamed_forward_batch(rows, sig, THETA, L=L, q=15)
    vals = a.flatten().tolist()
    phase(f"[anchor] L=30 forward p={P} T=8 q=15: {[round(x, 6) for x in vals]}")
    if not all(math.isfinite(x) and abs(x) <= 1 + 1e-5 for x in vals):
        raise RuntimeError("L=30 noisy forward not finite or |A| > 1")


def anchors_l31_sharded(dev) -> None:
    """L=31 on 2 shards of one card (L_loc = 30, 8 GiB a shard, one
    trajectory), the engines called directly: from the vacuum at p=0,
    A(1) = cos(pi g) within 1e-5 for x through K9a (q = 0, 15, 29) and for
    y through K10a's shard-local form with 256-lane rows (q = 15); the
    noiseless echo = 1 within 1e-4 at t=1, 2 through K9a/K9b and through
    K10a/K10b. A wrapped 32-bit offset would break them. Prints the peak
    device memory."""
    from dtc_tpu_torch.parallel import sharded as sh
    from dtc_tpu_torch.parallel.mesh import make_mesh

    L, T = 31, 3
    hs, phis = disorder(L, dev)
    mesh = make_mesh(2, 1, devices=[dev, dev])
    kw = dict(L=L, T=T, p=0.0)
    torch.cuda.reset_peak_memory_stats(dev)
    for pol, fwd, ech, extra, qs, route in (
            ("x", sh.make_sharded_autocorr_forward_kernel,
             sh.make_sharded_echo_kernel, {}, (0, 15, 29), "K9a/K9b"),
            ("y", sh.make_sharded_autocorr_forward_general,
             sh.make_sharded_echo_general, {"K": 1}, (15,),
             "K10a/K10b shard-local, 256-lane rows")):
        angles = schedule(pol, T, dev)
        for q in qs:
            a = fwd(mesh, q=q, **extra, **kw)(angles, hs[0], phis[0], None,
                                               n_traj=1)
            d = abs(float(a[1]) - math.cos(THETA))
            phase(f"[anchor] L=31 on 2 shards {pol} ({route}) p=0 vacuum "
                  f"q={q}: A(1) = {float(a[1]):.7f}, |A(1) - cos(pi g)| = "
                  f"{d:.3e}")
            if not d <= 1e-5:
                raise RuntimeError(f"L=31 sharded {pol} A(1) at q={q} is not"
                                   " cos(pi g)")
        echo = ech(mesh, q=15, **extra, **kw)
        e = torch.stack([echo(angles, hs[0], phis[0], None, t, n_traj=1)
                         for t in (1, 2)])
        d = float((e - 1).abs().max())
        phase(f"[anchor] L=31 on 2 shards {pol} ({route}) noiseless echo "
              f"t=1,2 q=15: {e.tolist()}, max|A0 - 1| = {d:.3e}")
        if not d <= TOL:
            raise RuntimeError(f"L=31 sharded {pol} noiseless echo != 1")
    phase(f"[anchor] L=31 on 2 shards: peak device memory "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB (two "
          "shards 16 GiB)")


class SweepLog(logging.Handler):
    """Seconds of each ``phase_timer`` phase, and the (sweep, engine,
    polarization) of each sweep, from the port's log."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.seconds = {}
        self.sweeps = []

    def emit(self, record):
        msg = record.getMessage()
        if msg.startswith("phase "):
            words = msg.split()
            self.seconds.setdefault(" ".join(words[1:-1]), []).append(
                float(words[-1].rstrip("s")))
        elif "_sweep: engine=" in msg or "sharded_energy: engine=" in msg:
            sweep, engine, pol = msg.split()[:3]
            self.sweeps.append((sweep.rstrip(":"), engine.split("=")[1],
                                pol.split("=")[1]))


def read_csv(path) -> dict:
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    return {k: [float(r[i]) for r in rows[1:]] for i, k in enumerate(rows[0])}


def one_csv(tmp, prefix) -> dict:
    """The columns of the one CSV in ``tmp`` whose name starts with
    ``prefix``."""
    csvs = [f for f in os.listdir(tmp) if f.startswith(prefix)
            and f.endswith(".csv")]
    if len(csvs) != 1:
        raise RuntimeError(f"expected one {prefix}* CSV, got {csvs}")
    return read_csv(os.path.join(tmp, csvs[0]))


def run_cli(argv) -> tuple:
    """Run the CLI with every launch count at 0; returns (launches,
    plain calls on CUDA, sweep log, seconds)."""
    from dtc_tpu_torch.utils.cli import main as cli_main

    return run_counted(lambda: cli_main(argv), " ".join(argv[:3]))


# device seconds and calls of each C entry, summed over every run_counted
# run (the [main] phases): PERF.md's "seconds on the main paths"
MAIN_SECONDS = {key: 0.0 for key, *_ in KERNELS}
MAIN_CALLS = {key: 0 for key, *_ in KERNELS}


class EntryTimer:
    """Inside ``with``, every C entry of KERNELS records a CUDA event pair
    on the current stream around each call (its launches, basis states,
    measures and reduces); ``add_to`` sums them into MAIN_SECONDS and
    MAIN_CALLS."""

    def __enter__(self):
        from dtc_tpu_torch.ops import _build

        self.saved, self.events = [], {key: [] for key, *_ in KERNELS}
        for key, fn, src, *_ in KERNELS:
            lib = _build.load(os.path.splitext(os.path.basename(src))[0])
            entry = getattr(lib, fn)

            def timed(*args, _entry=entry, _ev=self.events[key]):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                rc = _entry(*args)
                end.record()
                _ev.append((start, end))
                return rc

            setattr(lib, fn, timed)
            self.saved.append((lib, fn, entry))
        return self

    def __exit__(self, *exc):
        for lib, fn, entry in self.saved:
            setattr(lib, fn, entry)

    def add_to(self, seconds, calls) -> None:
        torch.cuda.synchronize()
        for key, ev in self.events.items():
            seconds[key] += sum(a.elapsed_time(b) for a, b in ev) / 1e3
            calls[key] += len(ev)


def run_counted(fn, what) -> tuple:
    """Run ``fn`` with every launch count at 0 just before it and read just
    after; returns (launches, plain calls on CUDA, sweep log, seconds),
    each count by KERNELS's key, read from the launch registry of
    ``dtc_tpu_torch/utils/profiling.py`` (entry span ``dtc.entry.<kid>``,
    kid the key with its spaces made dots).
    ``fn`` returns the CLI's exit code, or None."""
    from dtc_tpu_torch.utils import profiling

    log = SweepLog()
    logger = logging.getLogger("dtc_tpu_torch")
    logger.addHandler(log)
    profiling.reset_counters()
    t0 = time.perf_counter()
    try:
        with EntryTimer() as timer:
            rc = fn()
            torch.cuda.synchronize()
    finally:
        logger.removeHandler(log)
    seconds = time.perf_counter() - t0
    timer.add_to(MAIN_SECONDS, MAIN_CALLS)
    span = {key: profiling.ENTRY + key.replace(" ", ".")
            for key, *_ in KERNELS}
    launches = {k: profiling.LAUNCHES[n] for k, n in span.items()}
    plain = {k: profiling.PLAIN_ON_CUDA[n] for k, n in span.items()}
    if rc not in (0, None):
        raise RuntimeError(f"{what} CLI returned {rc}")
    return launches, plain, log, seconds


def physics_checks(a, e, af, alternates) -> dict:
    """A(0), |A|, finiteness, echo <= 1; and period doubling for drives
    that flip the spins each cycle (x, y)."""
    checks = {
        "A(0) = (1-p)^6": abs(a[0] - af) < 1e-3,
        "|A| <= 1": all(abs(x) <= 1 + 1e-3 for x in a),
        "A finite": all(math.isfinite(x) for x in a),
        "echo finite": all(math.isfinite(x) for x in e),
        "echo <= 1": all(x <= 1 + 1e-3 for x in e),
    }
    if alternates:
        checks["A alternates over 4 cycles"] = all(a[t] * a[t + 1] < 0
                                                   for t in range(3))
    return checks


def fail_on(what, checks) -> None:
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise RuntimeError(f"{what} checks failed: {bad}")
    phase(f"[main] {what} checks passed: " + ", ".join(checks))


def common_argv(T, tmp, L=MAIN_L, n_traj=N_TRAJ):
    return ["--device", DEVICE, "--L", str(L), "--tf", str(T), "--g",
            "0.97", "--noise_prob", str(P), "--n_trajectories", str(n_traj),
            "--out_dir", tmp, "--disorder_dir", tmp]


def main_autocorr(smi) -> dict:
    """The x drive's path: ``autocorr`` at 2 instances x 32 trajectories."""
    with tempfile.TemporaryDirectory() as tmp:
        launches, plain, log, seconds = run_cli(
            ["autocorr", "--inst", "2", *common_argv(MAIN_T, tmp)])
        csvs = [f for f in os.listdir(tmp) if f.endswith(".csv")
                and f.startswith("autocorr_data_")]
        if len(csvs) != 1:
            raise RuntimeError(f"expected one result CSV, got {csvs}")
        cols = read_csv(os.path.join(tmp, csvs[0]))
    want = ["time", "av_autocorr", "av_autocorr_echo", "sqrt_av_autocorr_echo"]
    if list(cols) != want:
        raise RuntimeError(f"CSV columns {list(cols)} != {want}")
    a, e = cols["av_autocorr"], cols["av_autocorr_echo"]
    checks = physics_checks(a, e, (1 - P) ** 6, alternates=True)
    checks.update({
        "engine=blocked": {s[1] for s in log.sweeps} == {"blocked"},
        "K1 launched": launches["K1"] > 0,
        "K2 launched": launches["K2"] > 0,
        "no plain version on CUDA": not any(plain.values()),
    })
    phase(f"[main] autocorr L={MAIN_L} T={MAIN_T} inst=2 traj={N_TRAJ} in "
          f"{seconds:.2f}s: "
          f"A[0:4]={[round(x, 6) for x in a[:4]]} "
          f"echo[0:4]={[round(x, 6) for x in e[:4]]} launches={launches}")
    fail_on("autocorr", checks)
    phase(f"[main] autocorr sweep seconds: forward "
          f"{log.seconds['forward'][0]:.3f} s, echo "
          f"{log.seconds['echo'][0]:.3f} s (inst=2 x 32 trajectories) on "
          f"{smi}")
    return launches


def main_campaign(smi) -> dict:
    """[main] campaign: ``campaign --simulate --device cuda`` at the bench
    width (L=20, T=50, 2 instances x 32 trajectories, 4096 shots a job),
    twice in one job folder. The first run exports 200 QASM jobs, writes
    100 completed records of each kind and 50 CSV rows, and each decoded
    slot lies within 5/sqrt(4096) of the forward or echo value that
    ``run_autocorr`` gives for the same config and seed on the card; the
    second finds the export existing, writes no row and leaves the CSV as
    it was. Returns the K1/K2 launches of both runs."""
    from dtc_tpu_torch.experiments import campaign
    from dtc_tpu_torch.experiments.autocorr import run_autocorr
    from dtc_tpu_torch.utils.cli import build_parser, config_from_args

    L, T, inst, shots = MAIN_L, MAIN_T, 2, 4096
    results = []
    run = campaign.run_hardware_campaign

    def keep(*args, **kw):
        results.append(run(*args, **kw))
        return results[-1]

    total = {"K1": 0, "K2": 0}
    with tempfile.TemporaryDirectory() as tmp:
        jobs = os.path.join(tmp, "jobs")
        argv = ["campaign", "--simulate", "--device", DEVICE, "--L", str(L),
                "--tf", str(T), "--inst", str(inst), "--n_trajectories",
                str(N_TRAJ), "--campaign_shots", str(shots), "--job_dir",
                jobs, "--out_dir", os.path.join(tmp, "out"),
                "--disorder_dir", tmp]
        runs = []
        campaign.run_hardware_campaign = keep
        try:
            for _ in range(2):
                runs.append(run_cli(argv))
                with open(results[-1]["csv_path"], "rb") as f:
                    runs[-1] += (f.read(),)
        finally:
            campaign.run_hardware_campaign = run
        qasm = {k: [f for f in os.listdir(os.path.join(jobs, k))
                    if f.endswith(".qasm")] for k in ("forward", "echo")}
        done = {}
        for k in ("forward", "echo"):
            kdir = os.path.join(jobs, "results", k)
            done[k] = 0
            for f in os.listdir(kdir):
                with open(os.path.join(kdir, f)) as fh:
                    done[k] += json.load(fh)["status"] == "completed"
        echo_lines = sum(1 for _ in open(os.path.join(
            jobs, "echo", f"job_inst0_t{T - 1}_echo.qasm")))
        cfg = config_from_args(build_parser().parse_args(argv))
        ref = run_autocorr(cfg, device=DEVICE, write=False, disorder_dir=tmp)
    first, second = results
    tol = 5 / math.sqrt(shots)
    d_fwd = float(abs(first["forward"] - ref["autocorr_per_instance"]).max())
    d_echo = float(abs(first["echo"] - ref["echo_per_instance"]).max())
    rows = runs[0][4].decode().count("\n") - 1
    for launches, *_ in runs:
        for k in total:
            total[k] += launches[k]
    checks = {
        "200 QASM jobs": sum(map(len, qasm.values())) == 2 * inst * T,
        "100 completed records of each kind": done == {
            "forward": inst * T, "echo": inst * T},
        "50 CSV rows": rows == T and first["rows_on_disk"] == T,
        f"slots within {tol:.4f} of run_autocorr's": max(d_fwd, d_echo)
        <= tol,
        "second run: export existing": second["export"] == {
            "forward": "existing", "echo": "existing"},
        "second run: no new row": second["rows_written"] == 0,
        "second run: CSV unchanged": runs[1][4] == runs[0][4],
        "engine=blocked": all({s[1] for s in r[2].sweeps} == {"blocked"}
                              for r in runs),
        "K1 and K2 launched": all(r[0]["K1"] > 0 and r[0]["K2"] > 0
                                  for r in runs),
        "no other kernel": all(not v for r in runs for k, v in r[0].items()
                               if k not in ("K1", "K2")),
        "no plain version on CUDA": not any(v for r in runs
                                            for v in r[1].values()),
    }
    for i, (launches, _, log, seconds, _) in enumerate(runs):
        per = ", ".join(f"{k} {log.seconds[k][0]:.3f} s" for k in (
            "export", "simulate", "forward", "echo", "ingest")
            if k in log.seconds)
        phase(f"[main] campaign --simulate L={L} T={T} inst={inst} "
              f"traj={N_TRAJ} shots={shots} run {i + 1} in {seconds:.2f}s "
              f"({per}; forward and echo inside simulate) on {smi}: "
              f"launches K1 {launches['K1']}, K2 {launches['K2']}")
    phase(f"[main] campaign: {sum(map(len, qasm.values()))} QASM jobs (the "
          f"echo at t={T - 1} {echo_lines} lines), records {done}, {rows} "
          f"rows; max|decoded - run_autocorr| forward {d_fwd:.4f}, echo "
          f"{d_echo:.4f} (bound {tol:.4f})")
    fail_on("campaign", checks)
    return total


def main_polarization(smi, L=MAIN_L, T=MAIN_T, n_traj=N_TRAJ,
                      x_route=("blocked", "K1", "K2"),
                      route=("general", "K4 forward", "K4 echo")) -> dict:
    """``polarization`` over x, y, xy, yx: the x drive on the engine route
    and kernels ``x_route`` names, the others on ``route``'s."""
    from dtc_tpu_torch.io import naming
    from dtc_tpu_torch.utils.config import SimConfig

    pols = ("x", "y", "xy", "yx")
    with tempfile.TemporaryDirectory() as tmp:
        launches, plain, log, seconds = run_cli(
            ["polarization", "--inst", "1",
             *common_argv(T, tmp, L=L, n_traj=n_traj)])
        cfg = SimConfig(L=L, tf=T, g=0.97, noise_prob=P, inst=1)
        path = os.path.join(tmp, naming.autocorr_comparison_csv_name(cfg))
        if not os.path.exists(path):
            raise RuntimeError(f"no {os.path.basename(path)} in "
                               f"{sorted(os.listdir(tmp))}")
        cols = read_csv(path)
    keys = ("av_autocorr", "av_autocorr_echo", "sqrt_av_autocorr_echo",
            "forward_upper_env", "forward_lower_env", "echo_upper_env",
            "echo_lower_env", "sqrt_echo_upper_env", "sqrt_echo_lower_env")
    want = ["time"] + [f"{k}_{pol}" for pol in pols for k in keys]
    if list(cols) != want:
        raise RuntimeError(f"merged CSV columns {list(cols)} != {want}")
    checks = {}
    for pol in pols:
        a, e = cols[f"av_autocorr_{pol}"], cols[f"av_autocorr_echo_{pol}"]
        for k, ok in physics_checks(a, e, (1 - P) ** 6,
                                    alternates=pol in ("x", "y")).items():
            checks[f"{pol}: {k}"] = ok
        phase(f"[main] polarization {pol}: A[0:4]="
              f"{[round(x, 6) for x in a[:4]]} echo[0:4]="
              f"{[round(x, 6) for x in e[:4]]}")
    engines = {(s[2], s[1]) for s in log.sweeps}
    checks.update({
        f"engine={x_route[0]} for x": ("x", x_route[0]) in engines,
        f"engine={route[0]} for y, xy, yx": all(
            (pol, route[0]) in engines for pol in ("y", "xy", "yx")),
        "one engine per polarization": len(engines) == len(pols),
        **{f"{k} launched": launches[k] > 0 for k in (*x_route[1:],
                                                      *route[1:])},
        "no other kernel": not any(
            v for k, v in launches.items()
            if k not in (*x_route[1:], *route[1:])),
        "no plain version on CUDA": not any(plain.values()),
    })
    phase(f"[main] polarization L={L} T={T} inst=1 traj={n_traj}"
          " x,y,xy,yx in "
          f"{seconds:.2f}s: launches={launches} sweeps={sorted(engines)}")
    fail_on("polarization", checks)
    per_pol = " ".join(f"{pol} {f:.3f}/{e:.3f}" for pol, f, e in zip(
        pols, log.seconds["forward"], log.seconds["echo"]))
    phase(f"[main] polarization L={L} sweep seconds (forward/echo): "
          f"{per_pol} on {smi}")
    return launches


def main_studies() -> None:
    """``xy-cycle`` and ``shots`` (y drive) at T=20."""
    for argv, prefix, want, engines in (
            (["xy-cycle"], "autocorr_xy_cycle_",
             ["time", "av_autocorr_x", "av_autocorr_echo_x",
              "av_autocorr_xy_cycle", "av_autocorr_echo_xy_cycle"],
             {("x", "blocked"), ("xy_cycle", "general")}),
            (["shots", "--polarization", "y", "--shots_list", "100,10000"],
             "autocorr_shots_",
             ["time", "av_autocorr_echo_shots100",
              "av_autocorr_echo_shots10000"], {("y", "general")})):
        with tempfile.TemporaryDirectory() as tmp:
            launches, plain, log, seconds = run_cli(
                [*argv, "--inst", "1", *common_argv(STUDY_T, tmp)])
            cols = one_csv(tmp, prefix)
        values = [x for k in want[1:] for x in cols.get(k, [])]
        checks = {
            "columns": list(cols) == want,
            "values finite, |x| <= 1": all(math.isfinite(x)
                                           and abs(x) <= 1 + 1e-3
                                           for x in values),
            "engines": {(s[2], s[1]) for s in log.sweeps} == engines,
            "K4 launched": launches["K4 echo"] > 0,
            "no plain version on CUDA": not any(plain.values()),
        }
        phase(f"[main] {argv[0]} L={MAIN_L} T={STUDY_T} traj={N_TRAJ} in "
              f"{seconds:.2f}s: "
              f"launches={launches}")
        fail_on(argv[0], checks)


def main_energy(smi) -> int:
    """The energy family's path (K5): ``energy``, ``ham-comparison`` and
    ``per-qubit-z`` at L=20, T=50, 32 trajectories (p=0.05), ``per-qubit-z``
    without noise, and ``per-qubit-z`` of the xy drive (K=2) at T=20; each
    run logs engine=obs, launches K5 once per noise level or component and
    calls no plain version on a CUDA tensor. Returns K5's launches."""
    from dtc_tpu_torch.io.disorder import get_disorder
    from dtc_tpu_torch.utils.config import SimConfig

    total = 0
    g = 0.97
    runs = (
        ("energy", [], MAIN_T, "energy_data_", 4),
        ("ham-comparison", [], MAIN_T, "energy_ham_comparison_", 5),
        ("per-qubit-z", [], MAIN_T, "per_qubit_z_", 1),
        ("per-qubit-z", ["--use_noise", "0"], MAIN_T, "per_qubit_z_", 1),
        ("per-qubit-z", ["--polarization", "xy"], STUDY_T, "per_qubit_z_", 1),
    )
    for cmd, extra, T, prefix, want_launches in runs:
        with tempfile.TemporaryDirectory() as tmp:
            launches, plain, log, seconds = run_cli(
                [cmd, "--inst", "1", *common_argv(T, tmp), *extra])
            cols = one_csv(tmp, prefix)
            hs, phis = get_disorder(SimConfig(L=MAIN_L, inst=1), tmp)
        what = " ".join([cmd, *extra])
        e0 = {"full": hs.sum() + phis.sum(), "z_only": hs.sum(),
              "zz_only": phis.sum(), "x_only": 0.0,
              "z_zz": hs.sum() + phis.sum()}
        values = [x for k, v in cols.items() if k != "time" for x in v]
        checks = {
            "engine=obs": {s[1] for s in log.sweeps} == {"obs"},
            f"K5 launched {want_launches}x": launches["K5"] == want_launches,
            "no other kernel": not any(v for k, v in launches.items()
                                       if k != "K5"),
            "no plain version on CUDA": not any(plain.values()),
            "values finite": all(math.isfinite(x) for x in values),
            "time 0..T-1": cols["time"] == list(range(T)),
        }
        if cmd == "energy":
            checks["columns"] = list(cols) == [
                "time", "energy_p_0", "energy_p_0.001", "energy_p_0.01",
                "energy_p_0.1"]
            checks["E(0)/L = (sum h + sum phi)/L"] = all(
                abs(v[0] - e0["full"] / MAIN_L) <= 1e-5
                for k, v in cols.items() if k != "time")
        elif cmd == "ham-comparison":
            checks["columns"] = list(cols) == ["time"] + [
                f"energy_{c}" for c in e0]
            checks["E(0)/L per component"] = all(
                abs(cols[f"energy_{c}"][0] - e / MAIN_L) <= 1e-5
                for c, e in e0.items())
        else:
            zs = [cols[f"z_q{q}"] for q in range(MAIN_L)]
            checks["columns"] = list(cols) == ["time"] + [
                f"z_q{q}" for q in range(MAIN_L)]
            checks["z_q(0) = 1"] = all(abs(z[0] - 1) <= 1e-5 for z in zs)
            checks["|z| <= 1"] = all(abs(x) <= 1 + 1e-5 for x in values)
            if extra == ["--use_noise", "0"]:
                checks["z_q(1) = cos(pi g) at p=0"] = all(
                    abs(z[1] - math.cos(math.pi * g)) <= 1e-5 for z in zs)
        total += launches["K5"]
        first = [(k, round(v[0], 6), round(v[1], 6))
                 for k, v in list(cols.items())[1:4]]
        phase(f"[main] {what} L={MAIN_L} T={T} traj={N_TRAJ} in "
              f"{seconds:.2f}s: launches={launches} t=0,1 of {first}")
        fail_on(what, checks)
        per = ", ".join(f"{k} {v[0]:.3f}" for k, v in log.seconds.items())
        phase(f"[main] {what} seconds per sweep: {per} on {smi}")
    return total


def main_large(smi) -> dict:
    """The large-L paths, one instance each: ``autocorr --device cuda`` of
    the x drive at L=28 (T=20, 4 trajectories) and L=30 (T=6, 1
    trajectory) on the streamed x family (K6), and of the circular_left
    drive at L=29 (T=6, 1 trajectory) on the streamed lab-frame family
    (K10); returns each family's launches."""
    total = {"K6 forward": 0, "K6 echo": 0, "K10 forward": 0, "K10 echo": 0}
    for L, T, n, pol in ((28, 20, 4, "x"), (30, 6, 1, "x"),
                         (29, 6, 1, "circular_left")):
        engine, fam = ("streamed", "K6") if pol == "x" else ("general_hi",
                                                             "K10")
        with tempfile.TemporaryDirectory() as tmp:
            launches, plain, log, seconds = run_cli(
                ["autocorr", "--inst", "1", "--polarization", pol,
                 *common_argv(T, tmp, L=L, n_traj=n)])
            cols = one_csv(tmp, "autocorr_data_")
        a, e = cols["av_autocorr"], cols["av_autocorr_echo"]
        checks = physics_checks(a, e, (1 - P) ** 6, alternates=pol == "x")
        checks.update({
            f"engine={engine} for both sweeps":
                sorted(s[:2] for s in log.sweeps) == [
                    ("echo_sweep", engine), ("forward_sweep", engine)],
            f"{fam} forward launched": launches[f"{fam} forward"] > 0,
            f"{fam} echo launched": launches[f"{fam} echo"] > 0,
            "no other kernel": not any(v for k, v in launches.items()
                                       if k.split()[0] != fam),
            "no plain version on CUDA": not any(plain.values()),
        })
        phase(f"[main] autocorr {pol} L={L} T={T} inst=1 traj={n} in "
              f"{seconds:.2f}s: A[0:4]={[round(x, 6) for x in a[:4]]} "
              f"echo[0:4]={[round(x, 6) for x in e[:4]]} launches="
              f"{ {k: v for k, v in launches.items() if v} }")
        fail_on(f"autocorr {pol} L={L}", checks)
        phase(f"[main] autocorr {pol} L={L} sweep seconds: forward "
              f"{log.seconds['forward'][0]:.3f} s, echo "
              f"{log.seconds['echo'][0]:.3f} s (inst=1 x {n} trajectories) "
              f"on {smi}")
        for k in total:
            total[k] += launches[k]
    return total


def main_resident(smi) -> dict:
    """The resident x paths (K3): ``autocorr`` of the constant x drive at
    L=16 (T=50, 2 instances x 32 trajectories), ``adaptive`` at L=20 (T=12,
    32 trajectories) with the default flags (golden optimizer, 5
    iterations, target 1.0) and with linear feedback, and
    ``adaptive-batch`` at L=20 (T=50, 32 trajectories). Returns K3's
    launches over the four runs."""
    from dtc_tpu_torch.io import naming
    from dtc_tpu_torch.utils.config import SimConfig

    total = {"K3 forward": 0, "K3 echo": 0}
    with tempfile.TemporaryDirectory() as tmp:
        launches, plain, log, seconds = run_cli(
            ["autocorr", "--inst", "2", *common_argv(MAIN_T, tmp, L=16)])
        cols = one_csv(tmp, "autocorr_data_")
    a, e = cols["av_autocorr"], cols["av_autocorr_echo"]
    checks = physics_checks(a, e, (1 - P) ** 6, alternates=True)
    checks.update({
        "engine=resident for both sweeps": sorted(
            s[:2] for s in log.sweeps) == [("echo_sweep", "resident"),
                                           ("forward_sweep", "resident")],
        "K3 forward launched": launches["K3 forward"] > 0,
        "K3 echo launched": launches["K3 echo"] > 0,
        "no other kernel": not any(v for k, v in launches.items()
                                   if not k.startswith("K3")),
        "no plain version on CUDA": not any(plain.values()),
    })
    phase(f"[main] autocorr L=16 T={MAIN_T} inst=2 traj={N_TRAJ} in "
          f"{seconds:.2f}s: A[0:4]={[round(x, 6) for x in a[:4]]} "
          f"echo[0:4]={[round(x, 6) for x in e[:4]]} launches="
          f"{ {k: v for k, v in launches.items() if v} }")
    fail_on("autocorr L=16", checks)
    phase(f"[main] autocorr L=16 sweep seconds: forward "
          f"{log.seconds['forward'][0]:.3f} s, echo "
          f"{log.seconds['echo'][0]:.3f} s (inst=2 x 32 trajectories) on "
          f"{smi}")
    for k in total:
        total[k] += launches[k]
    g_min, g_max = 0.84, 1.0  # the adaptive flags' defaults
    for cmd, T, extra in (("adaptive", 12, []),
                          ("adaptive", 12, ["--use_optimization", "0",
                                            "--exponential_feedback", "0"]),
                          ("adaptive-batch", MAIN_T, [])):
        what = " ".join([cmd, *extra])
        with tempfile.TemporaryDirectory() as tmp:
            launches, plain, log, seconds = run_cli(
                [cmd, "--inst", "1", *common_argv(T, tmp), *extra])
            cfg = SimConfig(L=MAIN_L, tf=T, g=0.97, noise_prob=P, inst=1,
                            use_optimization=int("--use_optimization"
                                                 not in extra),
                            exponential_feedback=int(
                                "--exponential_feedback" not in extra))
            name = naming.adaptive_csv_name(cfg)
            if cmd == "adaptive":
                names = [name, naming.adaptive_comparison_csv_name(cfg),
                         naming.g_history_csv_name(cfg)]
            else:
                names = [name.replace("realtime_adaptive", "batch_adaptive")]
            written = sorted(os.listdir(tmp))
            missing = [n for n in names if n not in written]
            if missing:
                raise RuntimeError(f"{what}: no {missing} in {written}")
            cols = read_csv(os.path.join(tmp, names[0]))
        engines = {s[:2] for s in log.sweeps}
        if cmd == "adaptive":
            a = cols["av_autocorr_adaptive"] + cols["av_autocorr_standard_g97"]
            e = (cols["av_autocorr_echo_adaptive"]
                 + cols["av_autocorr_echo_standard_g97"])
            g97 = cols["av_autocorr_standard_g97"]
            checks = {
                "adaptive sweep engine=resident (first step: blocked)": {
                    en for sw, en in engines if sw == "adaptive_sweep"}
                    == {"blocked", "resident"},
                "fixed-g comparisons engine=blocked": {
                    en for sw, en in engines if sw.startswith("fixed_g")}
                    == {"blocked"},
                "av_autocorr_standard_g97 alternates": all(
                    g97[t] * g97[t + 1] < 0 for t in range(T - 1)),
            }
        else:
            a = cols["av_autocorr_adaptive"]
            e = cols["av_autocorr_echo_adaptive"]
            checks = {
                "adaptive forward engine=resident":
                    ("adaptive_batch_forward_sweep", "resident") in engines,
                "echo pass (constant schedule) engine=blocked":
                    ("adaptive_batch_echo_sweep", "blocked") in engines,
            }
        g = cols["av_g_values"]
        checks.update({
            "g in [g_min, g_max]": all(g_min <= x <= g_max for x in g),
            "|A| <= 1, finite": all(math.isfinite(x) and abs(x) <= 1 + 1e-3
                                    for x in a),
            "echo <= 1, finite": all(math.isfinite(x) and x <= 1 + 1e-3
                                     for x in e),
            "K3 forward launched": launches["K3 forward"] > 0,
            "no plain version on CUDA": not any(plain.values()),
        })
        if cmd == "adaptive":
            # every step after the first runs a per-cycle schedule: its
            # forward and echo, and under the golden optimizer (5
            # iterations: max(5 * 3, 12) = 15 rounds) 2 + 15 candidates
            calls = 1 + (17 if "--use_optimization" not in extra else 0)
            checks[f"K3 launches = {T - 1} forward, {(T - 1) * calls} echo"] \
                = (launches["K3 forward"], launches["K3 echo"]) == (
                    T - 1, (T - 1) * calls)
        phase(f"[main] {what} L={MAIN_L} T={T} traj={N_TRAJ} in "
              f"{seconds:.2f}s on {smi}: g[0:4]="
              f"{[round(x, 6) for x in g[:4]]} A[0:4]="
              f"{[round(x, 6) for x in cols['av_autocorr_adaptive'][:4]]}"
              f" launches={ {k: v for k, v in launches.items() if v} }")
        fail_on(what, checks)
        for k in total:
            total[k] += launches[k]
    return total


def main_sharded(smi) -> dict:
    """The amplitude-sharded path through the CLI, logical devices sharing
    the card: ``--num_devices 4 autocorr --sharded --n_amp 4`` of the x
    drive at L=25 (T=20, 4 trajectories; engine=cycle, K8a/K8b) and
    ``--num_devices 2 ... --n_amp 2 --polarization xy`` at L=24 (T=12, 2
    trajectories; engine=cycle_general, K8c/K8d). Returns K8's launches."""
    total = {"K8a": 0, "K8b": 0, "K8c": 0, "K8d": 0}
    for pol, L, n_amp, T, n in (("x", 25, 4, 20, 4), ("xy", 24, 2, 12, 2)):
        route, fam = (("cycle", ("K8a", "K8b")) if pol == "x"
                      else ("cycle_general", ("K8c", "K8d")))
        with tempfile.TemporaryDirectory() as tmp:
            launches, plain, log, seconds = run_cli(
                ["--num_devices", str(n_amp), "autocorr", "--sharded",
                 "--n_amp", str(n_amp), "--inst", "1", "--polarization", pol,
                 *common_argv(T, tmp, L=L, n_traj=n)])
            cols = one_csv(tmp, "autocorr_data_")
        a, e = cols["av_autocorr"], cols["av_autocorr_echo"]
        checks = physics_checks(a, e, (1 - P) ** 6, alternates=pol == "x")
        checks.update({
            f"engine={route} mesh=(1,{n_amp})": log.sweeps == [
                ("sharded_sweep", route, f"(1,{n_amp})")],
            **{f"{k} launched": launches[k] > 0 for k in fam},
            "no other kernel": not any(v for k, v in launches.items()
                                       if k not in fam),
            "no plain version on CUDA": not any(plain.values()),
        })
        phase(f"[main] autocorr --sharded {pol} L={L} n_amp={n_amp} T={T} "
              f"inst=1 traj={n} in {seconds:.2f}s: "
              f"A[0:4]={[round(x, 6) for x in a[:4]]} "
              f"echo[0:4]={[round(x, 6) for x in e[:4]]} launches="
              f"{ {k: v for k, v in launches.items() if v} }")
        fail_on(f"autocorr --sharded {pol} L={L}", checks)
        phase(f"[main] autocorr --sharded {pol} L={L} sweep seconds: forward "
              f"{log.seconds['sharded forward inst 0'][0]:.3f} s, echo "
              f"{log.seconds['sharded echo inst 0'][0]:.3f} s (inst=1 x {n} "
              f"trajectories, {n_amp} shards on one card) on {smi}")
        for k in total:
            total[k] += launches[k]
    return total


def main_sharded_hi(smi) -> dict:
    """The amplitude-sharded path on the streamed per-shard kernels through
    the CLI: ``--num_devices 2 autocorr --sharded --n_amp 2`` of the x drive
    at L=28 (L_loc = 27: three passes, 256-lane rows), T=8, 2 trajectories,
    both shards on the card (engine=cycle_hi, K9a/K9b only). Returns their
    launches."""
    L, n_amp, T, n = 28, 2, 8, 2
    with tempfile.TemporaryDirectory() as tmp:
        launches, plain, log, seconds = run_cli(
            ["--num_devices", str(n_amp), "autocorr", "--sharded", "--n_amp",
             str(n_amp), "--inst", "1", *common_argv(T, tmp, L=L, n_traj=n)])
        cols = one_csv(tmp, "autocorr_data_")
    a, e = cols["av_autocorr"], cols["av_autocorr_echo"]
    fam = ("K9a", "K9b")
    checks = physics_checks(a, e, (1 - P) ** 6, alternates=True)
    checks.update({
        f"engine=cycle_hi mesh=(1,{n_amp})": log.sweeps == [
            ("sharded_sweep", "cycle_hi", f"(1,{n_amp})")],
        **{f"{k} launched": launches[k] > 0 for k in fam},
        "no other kernel": not any(v for k, v in launches.items()
                                   if k not in fam),
        "no plain version on CUDA": not any(plain.values()),
    })
    phase(f"[main] autocorr --sharded x L={L} n_amp={n_amp} T={T} inst=1 "
          f"traj={n} in {seconds:.2f}s: A[0:4]={[round(x, 6) for x in a[:4]]}"
          f" echo[0:4]={[round(x, 6) for x in e[:4]]} launches="
          f"{ {k: v for k, v in launches.items() if v} }")
    fail_on(f"autocorr --sharded x L={L}", checks)
    phase(f"[main] autocorr --sharded x L={L} sweep seconds: forward "
          f"{log.seconds['sharded forward inst 0'][0]:.3f} s, echo "
          f"{log.seconds['sharded echo inst 0'][0]:.3f} s (inst=1 x {n} "
          f"trajectories, {n_amp} shards on one card) on {smi}")
    return {k: launches[k] for k in fam}


def main_sharded_general_hi(smi) -> dict:
    """K10's shard-local forms on their path: the lab-frame engines
    ``make_sharded_autocorr_forward_general`` / ``make_sharded_echo_general``
    called directly, as the routing sends no drive there (the reference's
    own), for xy at L=28 on 2 shards of the card (L_loc = 27), T=6, 2
    trajectories, p=0.05: the forward and the echo at t=1, 3, 5. Checks
    A(0) = (1-p)^6, |A| <= 1, the echo within [-1, 1], K10a/K10b shard-local
    launched, no other kernel, no plain version on CUDA. Returns their
    launches."""
    from dtc_tpu_torch.parallel import sharded as sh
    from dtc_tpu_torch.parallel.mesh import make_mesh

    dev = torch.device(DEVICE)
    L, n_amp, T, n, pol = 28, 2, 6, 2, "xy"
    hs, phis = disorder(L, dev)
    angles = schedule(pol, T, dev)
    K = angles.shape[1]
    mesh = make_mesh(n_amp, 1, devices=[dev] * n_amp)
    kw = dict(L=L, T=T, K=K, p=P, q=L // 2)
    uf = uniforms((n, T * K, L), dev, seed=28)
    ue = uniforms((n, 2 * T, K, L), dev, seed=29)
    ts = (1, 3, 5)
    out = {}

    def run():
        out["a"] = sh.make_sharded_autocorr_forward_general(mesh, **kw)(
            angles, hs[0], phis[0], uf)
        echo = sh.make_sharded_echo_general(mesh, **kw)
        out["e"] = torch.stack([echo(angles, hs[0], phis[0], ue, t)
                                for t in ts])

    launches, plain, _, seconds = run_counted(run, "sharded general engines")
    a, e = out["a"].tolist(), out["e"].tolist()
    fam = ("K10a local", "K10b local")
    checks = {
        "A(0) = (1-p)^6": abs(a[0] - (1 - P) ** 6) < 1e-3,
        "|A| <= 1": all(abs(x) <= 1 + 1e-3 for x in a),
        "finite": all(math.isfinite(x) for x in a + e),
        "|echo| <= 1": all(abs(x) <= 1 + 1e-3 for x in e),
        **{f"{k} launched": launches[k] > 0 for k in fam},
        "no other kernel": not any(v for k, v in launches.items()
                                   if k not in fam),
        "no plain version on CUDA": not any(plain.values()),
    }
    phase(f"[main] sharded general engines {pol} L={L} n_amp={n_amp} T={T} "
          f"traj={n} in {seconds:.2f}s (forward + echo at t={ts}): "
          f"A[0:4]={[round(x, 6) for x in a[:4]]} echo="
          f"{[round(x, 6) for x in e]} launches="
          f"{ {k: v for k, v in launches.items() if v} } on {smi}")
    fail_on(f"sharded general engines {pol} L={L}", checks)
    return {k: launches[k] for k in fam}


def main_planar(smi, dev) -> dict:
    """``DTC_TPU_ENGINE=planar autocorr --device cuda`` at the bench shape
    (L=20, T=50, 32 trajectories, p=0.05, g=0.97): the forward on the
    planar engine (K11 once per measured cycle, no other kernel), the echo
    on the sigma engine, as the reference routes them; physics checks on
    the CSV. Then the planar forward against the blocked route (K1) on the
    same uniforms, within 2.7e-4 (the reference's kernels against its sigma
    engine on its chip), each timed. Returns K11's launches and the
    times."""
    from dtc_tpu_torch.experiments.engine import build_context, forward_sweep
    from dtc_tpu_torch.utils.config import SimConfig

    os.environ["DTC_TPU_ENGINE"] = "planar"
    try:
        with tempfile.TemporaryDirectory() as tmp:
            launches, plain, log, seconds = run_cli(
                ["autocorr", "--inst", "1", *common_argv(MAIN_T, tmp)])
            cols = one_csv(tmp, "autocorr_data_")
    finally:
        del os.environ["DTC_TPU_ENGINE"]
    a, e = cols["av_autocorr"], cols["av_autocorr_echo"]
    checks = physics_checks(a, e, (1 - P) ** 6, alternates=True)
    checks.update({
        "forward engine=planar, echo engine=sigma": sorted(
            s[:2] for s in log.sweeps) == [("echo_sweep", "sigma"),
                                           ("forward_sweep", "planar")],
        f"K11 launched once a measured cycle ({MAIN_T - 1})":
            launches["K11"] == MAIN_T - 1,
        "no other kernel": not any(v for k, v in launches.items()
                                   if k != "K11"),
        "no plain version on CUDA": not any(plain.values()),
    })
    phase(f"[main] DTC_TPU_ENGINE=planar autocorr L={MAIN_L} T={MAIN_T} "
          f"inst=1 traj={N_TRAJ} in {seconds:.2f}s: "
          f"A[0:4]={[round(x, 6) for x in a[:4]]} "
          f"echo[0:4]={[round(x, 6) for x in e[:4]]} launches="
          f"{ {k: v for k, v in launches.items() if v} }")
    fail_on("planar autocorr", checks)
    phase(f"[main] planar autocorr sweep seconds: forward "
          f"{log.seconds['forward'][0]:.3f} s (planar), echo "
          f"{log.seconds['echo'][0]:.3f} s (sigma) on {smi}")
    cfg = SimConfig(L=MAIN_L, tf=MAIN_T, n_trajectories=N_TRAJ,
                    noise_prob=P, g=0.97)
    hs, phis = disorder(MAIN_L, "cpu")
    sched, params, noise = build_context(cfg, hs.numpy(), phis.numpy(),
                                         device=dev)
    u = uniforms((1, N_TRAJ, MAIN_T, MAIN_L), dev, seed=50)
    sweeps = {}
    for engine in ("planar", "auto", "planar", "auto"):
        t0 = time.perf_counter()
        vals = forward_sweep(cfg, sched, params, noise, uniforms=u,
                             engine=engine)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        best = sweeps.get(engine, (math.inf, None))[0]
        sweeps[engine] = (min(best, dt), vals)
    d = float(abs(sweeps["planar"][1] - sweeps["auto"][1]).max())
    rates = {k: MAIN_T * N_TRAJ / v[0] for k, v in sweeps.items()}
    phase(f"[main] planar forward vs the blocked route (K1), same uniforms, "
          f"L={MAIN_L} T={MAIN_T} 1x{N_TRAJ}: max|planar-K1| = {d:.3e} "
          f"(<= 2.7e-4); forward sweep {sweeps['planar'][0] * 1e3:.3f} ms = "
          f"{rates['planar']:.1f} cycles/s (planar) against "
          f"{sweeps['auto'][0] * 1e3:.3f} ms = {rates['auto']:.1f} "
          f"cycles/s (K1) on {smi}")
    if not d <= 2.7e-4:
        raise RuntimeError(f"planar forward disagrees with K1 by {d}")
    return {"K11": launches["K11"], "planar_cycles_per_s": rates["planar"],
            "k1_cycles_per_s": rates["auto"]}


def device_af(L, seed=0):
    """A(0) of a device-noise run: the brisbane model's ancilla and
    readout contraction at q = L//2."""
    from dtc_tpu_torch.models.device_noise import fake_device_model

    m = fake_device_model(L, "brisbane", seed=seed + 7)
    return m.ancilla_interferometric_factor() * m.readout_z_factor(L // 2)


def main_device(smi, dev) -> dict:
    """``autocorr --use_fakebackend 1 --fake_device brisbane`` through the
    CLI: config 4, the x drive at L=27 (T=8, 4 trajectories) on the
    streamed x family with device rows (route x_kernel); xy at L=20 (T=20,
    8 trajectories) on K4 with lab-frame device rows (route general); xy at
    L=24 (T=4, 2 trajectories) on K10's shard-local forms through the
    one-shard mesh (route general_mesh). Each: the route logged for both
    sweeps, its kernels launched and no other, no plain version on CUDA,
    A(0) = the ancilla and readout factor, |A| <= 1, the echo <= 1. Then
    config 4 held against the sigma device engine on the same draws: the
    forward sweeps (the kernel route timed, in trajectory-cycles/s) and the
    echo at t=1..3, within 2.7e-4. Returns the launches and the rate."""
    from dtc_tpu_torch.core import device_evolve as de
    from dtc_tpu_torch.experiments import device_sweeps as ds
    from dtc_tpu_torch.experiments.engine import build_context
    from dtc_tpu_torch.utils.config import SimConfig

    out = {}
    for pol, L, T, n, route, fam in (
            ("x", 27, 8, 4, "x_kernel", ("K6 forward", "K6 echo")),
            ("xy", 20, 20, 8, "general", ("K4 forward", "K4 echo")),
            ("xy", 24, 4, 2, "general_mesh", ("K10a local", "K10b local"))):
        with tempfile.TemporaryDirectory() as tmp:
            launches, plain, log, seconds = run_cli(
                ["autocorr", "--inst", "1", "--polarization", pol,
                 "--use_fakebackend", "1", "--fake_device", "brisbane",
                 *common_argv(T, tmp, L=L, n_traj=n)])
            cols = one_csv(tmp, "autocorr_data_")
        a, e = cols["av_autocorr"], cols["av_autocorr_echo"]
        af = device_af(L)
        checks = physics_checks(a, e, af, alternates=pol == "x")
        checks.update({
            f"engine={route} for both sweeps": sorted(
                s[:2] for s in log.sweeps) == [
                    ("device_echo_sweep", route),
                    ("device_forward_sweep", route)],
            **{f"{k} launched": launches[k] > 0 for k in fam},
            "no other kernel": not any(v for k, v in launches.items()
                                       if k not in fam),
            "no plain version on CUDA": not any(plain.values()),
        })
        phase(f"[main] autocorr --use_fakebackend 1 {pol} L={L} T={T} "
              f"inst=1 traj={n} in {seconds:.2f}s: A(0) = {a[0]:.6f} "
              f"(the model's {af:.6f}), A[0:4]={[round(x, 6) for x in a[:4]]}"
              f" echo[0:4]={[round(x, 6) for x in e[:4]]} launches="
              f"{ {k: v for k, v in launches.items() if v} }")
        fail_on(f"autocorr --use_fakebackend 1 {pol} L={L}", checks)
        phase(f"[main] device {pol} L={L} sweep seconds: forward "
              f"{log.seconds['forward(device)'][0]:.3f} s, echo "
              f"{log.seconds['echo(device)'][0]:.3f} s on {smi}")
        out[route] = {k: launches[k] for k in fam}
    L, T, n = 27, 8, 4
    cfg = SimConfig(L=L, tf=T, n_trajectories=n, use_fakebackend=1, g=0.97)
    hs, phis = disorder(L, "cpu")
    sched, params, _ = build_context(cfg, hs.numpy(), phis.numpy(),
                                     device=dev)
    vals, secs = {}, {}
    for engine in ("auto", "sigma", "auto"):
        t0 = time.perf_counter()
        vals[engine] = ds.device_forward_sweep(cfg, sched, params,
                                               device_engine=engine)
        torch.cuda.synchronize()
        secs[engine] = min(secs.get(engine, math.inf),
                           time.perf_counter() - t0)
    d = float(abs(vals["auto"] - vals["sigma"]).max())
    rate = T * n / secs["auto"]
    phase(f"[main] config 4 (x, L={L}, brisbane) device forward: streamed "
          f"family with device rows {secs['auto']:.3f} s = {rate:.1f} "
          f"traj-cycles/s, sigma device engine {secs['sigma']:.3f} s; "
          f"max|kernel route - sigma| = {d:.3e} (<= 2.7e-4) on {smi}")
    if not d <= 2.7e-4:
        raise RuntimeError(f"config 4 forward: kernel route vs sigma {d}")
    p1, p2, af = ds._rates(cfg, dev)
    ub = device_blocks(L, 2 * T, 2, n, dev, 70)
    ts = [1, 2, 3]
    kw = dict(L=L, T=T, q=L // 2, ancilla_factor=af)
    ek = de.device_kernel_echo_batch(hs[0].to(dev), phis[0].to(dev), p1, p2,
                                     sched.angles, ub, ts, **kw)
    es = de.device_sigma_echo_batch(hs[0].to(dev), phis[0].to(dev), p1, p2,
                                    sched.angles, ub, ts, **kw)
    d = float((ek - es).abs().max())
    phase(f"[main] config 4 device echo t=1..3 1x{n}: max|kernel route - "
          f"sigma| = {d:.3e} (<= 2.7e-4)")
    if not d <= 2.7e-4:
        raise RuntimeError(f"config 4 echo: kernel route vs sigma {d}")
    out["config4_traj_cycles_per_s"] = rate
    return out


def time_ms(fn, reps=3):
    """(ms per call, the last call's output)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, out


def timed_pair(kernel, plain, reps) -> tuple:
    """Best ms of kernel and plain, timed in turns (plain, kernel, kernel,
    plain), and their outputs."""
    p_a, ref = time_ms(plain, reps)
    k_a, out = time_ms(kernel)
    k_b, _ = time_ms(kernel)
    p_b, _ = time_ms(plain, reps)
    return min(k_a, k_b), min(p_a, p_b), out, ref


def bound(io_bytes, amp_steps, flops_per_amp_step, extra_ops=0) -> tuple:
    """(bound ms, what bounds it): the larger of the bytes that must move
    (inputs read once, outputs written once) over the HBM rate and the f32
    operations over the f32 peak."""
    t_bytes = io_bytes / HBM_BYTES_PER_S
    t_ops = (amp_steps * flops_per_amp_step + extra_ops) / F32_FLOPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def report(name, what, ms, plain_ms, amp_steps, unit, units, io_bytes,
           flops, smi, extra_ops=0, passes=2, spills=False) -> dict:
    """Print one kernel's timing line; return its numbers. The state floor:
    ``passes`` read+write sweeps of the state per step, 16 B per amplitude
    each. ``spills``: the state (L >= 23, 64 MiB and more) does not fit the
    L2, so every step reads and writes it at least once, and the bytes of
    the bound are at least 16 B per amplitude and step."""
    bound_ms, bound_by = bound(max(io_bytes, 16 * amp_steps * spills),
                               amp_steps, flops, extra_ops)
    floor_ms = amp_steps * 16 * passes / HBM_BYTES_PER_S * 1e3
    gbps = amp_steps * 16 * passes / (ms / 1e3) / 1e9
    phase(f"[timing] {name} {what}: kernel {ms:.3f} ms = "
          f"{units / (ms / 1e3):.1f} {unit}/s, plain {plain_ms:.3f} ms = "
          f"{units / (plain_ms / 1e3):.1f} {unit}/s; state {gbps:.1f} GB/s"
          f" = {100 * floor_ms / ms:.1f}% of the {passes}-sweep floor "
          f"({floor_ms:.3f} ms at {16 * passes} B/amp/step; one sweep "
          f"{floor_ms / passes:.3f} ms); bound {bound_ms:.3f} ms "
          f"({bound_by}) on {smi}")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "state_floor_ms": floor_ms}


def timing(dev, smi, err) -> dict:
    """Times of every kernel and its plain version at the main paths'
    shapes; the outputs are held to the same bound."""
    from dtc_tpu_torch.bench import run_case
    from dtc_tpu_torch.ops import _build
    from dtc_tpu_torch.ops import resident_blocked as rb
    from dtc_tpu_torch.ops import resident_general as rg

    L, T, c = 20, 50, 32
    N = 1 << L
    cps, dt = run_case(L=L, T=T, p=P, n_traj=c, device=dev)
    phase(f"[timing] bench shape L=20 T=50 traj=32 p=0.05 via run_case: "
          f"{cps:.1f} cycles/s ({dt * 1e3:.3f} ms/dispatch) on {smi}")
    for name in ("floquet_x", "floquet_x_resident"):
        for kernel, regs, st, ld in ptxas_kernels(name):
            phase(f"[build] {name}.cu {kernel}: {regs} registers, spill "
                  f"stores {st} B, spill loads {ld} B")
    out = {}
    rows, sig = forward_inputs(L, T, c, P, dev, seed=5)
    k_ms, p_ms, k, ref = timed_pair(
        lambda: rb.blocked_forward_batch(rows, sig, THETA, L=L, q=L // 2),
        lambda: rb.blocked_forward_batch_ref(rows, sig, THETA, L=L, q=L // 2),
        3)
    err["K1"] = max(err["K1"], held("K1 L=20 T=50 1x32 (timed inputs)", k,
                                    ref))
    what = "forward L=20 T=50 traj=32"
    out["K1"] = report("K1", what, k_ms, p_ms, c * (T - 1) * N, "cycles",
                       T * c, 4 * (rows.numel() + k.numel()), 6 * L + 6, smi)
    shares("K1", what, out["K1"], 2 * (T - 1) + 3, smi)
    blocks = _build.load("floquet_x").floquet_x_forward_partials(L)
    fold_ms, _ = time_ms(lambda: rb.forward_scratch(
        rows.view(c, T, rows.shape[-1]), L, blocks))
    phase(f"[timing] K1 {what}: its folded rows and zeroed partials "
          f"{fold_ms:.3f} ms of the {k_ms:.3f} ms call on {smi}")
    # the main path's first echo call: 2 instances x 32 trajectories x t=0..7
    tiles, sfin = echo_inputs(L, T, c, P, list(range(8)), dev, seed=6,
                              inst=2)
    steps = 2 * c * sum(2 * t for t in range(8))  # inst x traj x 2t
    out["K2"] = timed_echo(
        "K2", f"echo L=20 ts=0..7 pairs=512 steps={steps}",
        lambda: rb.blocked_echo_batch(tiles, sfin, THETA, L=L, q=L // 2),
        lambda: rb.blocked_echo_batch_ref(tiles, sfin, THETA, L=L, q=L // 2),
        2 * 7, err, "K2", steps * N, steps, 4 * (tiles.numel() + 512),
        6 * L + 6, smi)
    del tiles
    for pol in ("y", "xy"):
        rows = general_forward_inputs(L, pol, T, c, P, dev, seed=7)
        K = rows.shape[-2] // T
        k_ms, p_ms, k, ref = timed_pair(
            lambda: rg.general_forward_batch(rows, L=L, T=T, q=L // 2),
            lambda: rg.general_forward_batch_ref(rows, L=L, T=T, q=L // 2),
            1)
        err["K4 forward"] = max(err["K4 forward"], held(
            f"K4 forward L=20 {pol} T=50 1x32 (timed inputs)", k, ref))
        what = f"forward {pol} L=20 T=50 traj=32 steps/cycle={K}"
        out[f"K4 forward {pol}"] = report(
            "K4", what, k_ms, p_ms, c * (T - 1) * K * N, "cycles", T * c,
            4 * (rows.numel() + k.numel()), 14 * L + 6, smi)
        shares("K4", what, out[f"K4 forward {pol}"], 2 * (T - 1) * K + 3,
               smi)
    out["K4 echo"] = timing_k4_echo(dev, smi, err)
    out.update(timing_obs(dev, smi, err))
    return out


def timed_echo(name, what, kernel, plain, n_steps, err, key, amp_steps,
               units, io_bytes, flops, smi, passes=2, spills=False) -> dict:
    """One echo entry's timing row: kernel and plain in turns, and the
    shares of the state floor and of the bound. Every pair runs in lockstep,
    ``n_steps`` steps of ``passes`` launches, with the basis state, the
    measure and the reduce. ``spills`` as in ``report``."""
    k_ms, p_ms, k, ref = timed_pair(kernel, plain, 1)
    err[key] = max(err[key], held(f"{name} {what} (timed inputs)", k, ref))
    row = report(name, what, k_ms, p_ms, amp_steps, "steps", units, io_bytes,
                 flops, smi, passes=passes, spills=spills)
    shares(name, what, row, passes * n_steps + 3, smi)
    return row


def shares(name, what, row, launches, smi) -> None:
    """The launches a call of an entry on the step passes and its shares
    of the state floor and of the bound."""
    phase(f"[timing] {name} {what}: {launches} launches a call; "
          f"{100 * row['state_floor_ms'] / row['ms']:.1f}% of the state "
          f"floor, {100 * row['bound_ms'] / row['ms']:.1f}% of the bound on "
          f"{smi}")


def timing_k4_echo(dev, smi, err) -> dict:
    """K4's echo on the main path's first echo call: 2 instances x 32
    trajectories x t=0..7 of the xy drive at L=20 (512 pairs)."""
    from dtc_tpu_torch.ops import resident_general as rg
    from dtc_tpu_torch.ops.params_general import LANE_COUNT, flag_base

    L, T, c = MAIN_L, MAIN_T, N_TRAJ
    tiles = general_echo_inputs(L, "xy", T, c, P, list(range(8)), dev,
                                seed=8, inst=2)
    steps = 2 * c * sum(2 * 2 * t for t in range(8))  # inst x traj x 2tK
    n_steps = int(tiles.reshape(-1, *tiles.shape[-2:])[
        :, 0, flag_base(L) + LANE_COUNT].max())
    return timed_echo(
        "K4", f"echo xy L=20 ts=0..7 pairs=512 steps={steps}",
        lambda: rg.general_echo_batch(tiles, L=L, q=L // 2),
        lambda: rg.general_echo_batch_ref(tiles, L=L, q=L // 2), n_steps,
        err, "K4 echo", steps << L, steps, 4 * (tiles.numel() + 512),
        14 * L + 6, smi)


def timing_k3_echo(dev, smi, err) -> dict:
    """K3b on one ``echo_value`` of the T=12 adaptive loop: 32 trajectories
    x t=12 of the per-cycle ramp at L=20, beside K4 on the same rows."""
    from dtc_tpu_torch.ops import resident as rs
    from dtc_tpu_torch.ops import resident_general as rg

    L, c = MAIN_L, N_TRAJ
    angles, tiles, sfin, gtiles = ramp_inputs(L, 13, c, P, [12], dev,
                                              seed=12)
    kw = dict(L=L, q=L // 2, time_dependent=True)
    steps = c * 2 * 12
    what = f"echo ramp L={L} t=12 pairs={c} steps={steps}"
    row = timed_echo(
        "K3", what, lambda: rs.resident_echo_batch(tiles, sfin, angles, **kw),
        lambda: rs.resident_echo_batch_ref(tiles, sfin, angles, **kw), 2 * 12,
        err, "K3 echo", steps << L, steps,
        4 * (tiles.numel() + 2 * angles.shape[0] + c), 6 * L + 6, smi)
    # K4 and K3 in turns, so that the two times are compared alike
    k4_ms, k3_ms, k4, k = timed_pair(
        lambda: rg.general_echo_batch(gtiles, L=L, q=L // 2),
        lambda: rs.resident_echo_batch(tiles, sfin, angles, **kw), 3)
    held(f"K3 {what} vs K4 (timed inputs)", k, k4)
    row["k4_ms"] = k4_ms
    phase(f"[timing] K4 on the same ramp and rows, {what}: {k4_ms:.3f} ms = "
          f"{steps / (k4_ms / 1e3):.1f} steps/s ({k4_ms / k3_ms:.3f} x "
          f"K3 at {k3_ms:.3f} ms, in turns) on {smi}")
    return row


def timing_obs(dev, smi, err) -> dict:
    """K5 against its plain version at the energy path's shape (L=20, T=50,
    32 trajectories, p=0.05, the full Hamiltonian), x and xy drives. Its
    operations: K4's steps, (T-1) K per trajectory at 14 L + 6 per
    amplitude, and the measure, T per trajectory at 5 + 2 k1 + 2 L per
    amplitude, k1 = L - L // 2 (|psi|^2 3, the E accumulation 2, the z_q
    sums of the k1 tile bits 2 k1: a high bit's z_q is the block's
    probability times one sign; the x pairs 2 L: 4 flops per pair, 2^L / 2
    pairs per bit)."""
    from dtc_tpu_torch.ops import _build
    from dtc_tpu_torch.ops import observables as ob

    lib = _build.load("floquet_general")
    for kernel, regs, st, ld in ptxas_kernels("floquet_general"):
        phase(f"[build] floquet_general.cu {kernel}: {regs} registers, "
              f"spill stores {st} B, spill loads {ld} B")
    L, T, c = MAIN_L, MAIN_T, N_TRAJ
    N = 1 << L
    k1 = L - L // 2
    out = {}
    for pol in ("x", "xy"):
        rows, erow, _, scale = obs_inputs(L, pol, "full", T, c, P, dev,
                                          seed=9)
        K = rows.shape[-2] // T
        k_ms, p_ms, k, ref = timed_pair(
            lambda: ob.observables_forward_batch(rows, erow, L=L, T=T),
            lambda: ob.observables_forward_batch_ref(rows, erow, L=L, T=T),
            1)
        err["K5"] = max(err["K5"], held_obs(
            f"K5 L=20 {pol} T=50 1x32 (timed inputs)", k, ref, L, scale))
        io_bytes = 4 * (rows.numel() + c * 128 + sum(a.numel() for a in k))
        out[f"K5 {pol}"] = report(
            "K5", f"observables {pol} L=20 T=50 traj=32 steps/cycle={K}",
            k_ms, p_ms, c * (T - 1) * K * N, "cycles", T * c, io_bytes,
            14 * L + 6, smi, extra_ops=c * T * N * (5 + 2 * k1 + 2 * L))
    timing_obs_walk(dev, smi, err, lib)
    # L=23, one trajectory: the most cycles one reduce chunk holds (x, K=1)
    # and one more (two chunks), each one launch with its peak memory
    L = 23
    slots = lib.floquet_general_observables_slots(L, ob.walk_tiles(L, 1))
    one = ob.chunk_cycles(L, ob.MAX_STEPS, slots)
    for T in (one, one + 1):
        rows, erow, _, scale = obs_inputs(L, "x", "full", T, 1, P, dev,
                                          seed=T)
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        k = ob.observables_forward_batch(rows, erow, L=L, T=T)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        mem = torch.cuda.max_memory_allocated(dev) / 2**30
        ref = ob.observables_forward_batch_ref(rows, erow, L=L, T=T)
        err["K5"] = max(err["K5"], held_obs(
            f"K5 L=23 x T={T} 1x1 ({-(-T // one)} reduce chunks)", k, ref, L,
            scale))
        phase(f"[timing] K5 L=23 x T={T} traj=1, one launch in "
              f"{-(-T // one)} chunks of at most {one} cycles: {sec:.3f} s, "
              f"peak device memory {mem:.4f} GiB (a state "
              f"{2 ** (L + 3) / 2**30:.4f} GiB, partials "
              f"{one * slots * 4 / 2**30:.4f} GiB) on {smi}")
        del rows, k, ref
    return out


def timing_obs_walk(dev, smi, err, lib) -> None:
    """K5 x at L=20, T=50, p=0.1: the energy cell's launch (256
    trajectories, held to the plain version on three of them) and its
    share of the state floor; then pass lo's walk of 1, 2, 4, 8 and 16
    tiles a block at 256, 32 and 1 trajectories through ``launch``, beside
    the tiles ``walk_tiles`` picks, and the entry's launches by walk
    (``profiling.OBS_TILES``)."""
    from dtc_tpu_torch.ops import observables as ob
    from dtc_tpu_torch.utils import profiling

    L, T, N = MAIN_L, MAIN_T, 1 << MAIN_L
    kw = dict(L=L, T=T, initial_state="vacuum", with_x=True)
    for c in (256, 32, 1):
        rows, erow, _, scale = obs_inputs(L, "x", "full", T, c, 0.1, dev,
                                          seed=c)
        pick = ob.walk_tiles(L, c)
        if c == 256:
            ms, k = time_ms(lambda: ob.observables_forward_batch(
                rows, erow, L=L, T=T), reps=2)
            some = [0, 1, c - 1]
            ref = ob.observables_forward_batch_ref(rows[:, some], erow, L=L,
                                                   T=T)
            err["K5"] = max(err["K5"], held_obs(
                "K5 L=20 x T=50 1x256 p=0.1 (the energy cell's launch)",
                [a[:, some] for a in k], ref, L, scale))
            floor = c * (T - 1) * N * 32 / HBM_BYTES_PER_S * 1e3
            phase(f"[timing] K5 observables x L=20 T=50 traj=256 p=0.1 "
                  f"(walks of {pick} tiles): kernel {ms:.3f} ms = "
                  f"{T * c / (ms / 1e3):.1f} cycles/s; "
                  f"{100 * floor / ms:.1f}% of the 2-sweep state floor "
                  f"({floor:.3f} ms) on {smi}")
        times = {}
        for tiles in (1, 2, 4, 8, 16):
            times[tiles], _ = time_ms(
                lambda: ob.launch(rows, erow, tiles=tiles, **kw),
                reps=2 if c > 1 else 5)
        phase(f"[timing] K5 walk x L=20 T=50 traj={c} p=0.1: "
              + ", ".join(f"{n} tiles {ms:.3f} ms" for n, ms in
                          times.items())
              + f"; walk_tiles picks {pick} ({times[pick]:.3f} ms, best "
              f"{min(times, key=times.get)}) on {smi}")
        del rows, erow
    phase(f"[timing] K5 launches by walk (profiling.OBS_TILES): "
          f"{dict(sorted(profiling.OBS_TILES.items()))}")


def peak(name, what, L, dev, smi) -> None:
    phase(f"[timing] {name} {what}: peak device memory of the kernel and "
          f"plain calls {torch.cuda.max_memory_allocated(dev) / 2**30:.2f}"
          f" GiB (a state {2 ** (L + 3) / 2**30:.3f} GiB) on {smi}")


def ptxas_kernels(name: str) -> list:
    """(mangled kernel name, registers, spill stores, spill loads) of each
    kernel of library ``name``, from the ``nvcc -Xptxas -v`` log of this
    run's build (empty if the library was found built)."""
    from dtc_tpu_torch.ops import _build

    found, cur = {}, None
    for ln in _build.build_info[name]["log"].splitlines():
        if "Compiling entry function" in ln:
            cur = ln.split("'")[1]
            found[cur] = [0, 0, 0]
        elif cur and "spill stores" in ln:
            nums = [int(w) for w in ln.replace(",", " ").split()
                    if w.isdigit()]
            found[cur][1:] = nums[1:3]
        elif cur and "Used" in ln and "registers" in ln:
            found[cur][0] = int(ln.split("Used")[1].split()[0])
    return [(k, *v) for k, v in found.items()]


def timing_streamed(dev, smi, err) -> dict:
    """The streamed family's forward at L=24, 26, 28 (4 trajectories, T=8)
    and 30 (1 trajectory, T=6: the main path's launch) against its plain
    version on the same inputs, with the peak device memory of each
    kernel/plain pair, the launches a call and the shares of the state
    floor and of the bound; before them the registers and spills of every
    kernel of the library (the forward's passes are those of
    ``XEcho<ForwardRows, ...>``, K1's and K3a's reader), and one L=30
    launch at T = MAX_T_FORWARD (1024) with its peak device
    memory (the partials grow with T), its first cycles held to a T=6
    launch on the same rows. Returns the L=28 numbers; the echo's rows are
    ``timing_streamed_echo``'s."""
    from dtc_tpu_torch.ops import _build
    from dtc_tpu_torch.ops import streamed as sm

    lib = _build.load("floquet_x_streamed")
    for kernel, regs, st, ld in ptxas_kernels("floquet_x_streamed"):
        phase(f"[build] floquet_x_streamed.cu {kernel}: {regs} registers, "
              f"spill stores {st} B, spill loads {ld} B")
    L, T = 30, sm.MAX_T_FORWARD
    rows, sig = forward_inputs(L, T, 1, P, dev, seed=L)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    a = sm.streamed_forward_batch(rows, sig, THETA, L=L, q=L // 2)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    vals = a.flatten()
    if not (bool(torch.isfinite(vals).all())
            and float(vals.abs().max()) <= 1 + 1e-5):
        raise RuntimeError("L=30 T=1024 forward not finite or |A| > 1")
    held(f"K6 forward L=30 T={T} 1x1, its first 6 cycles vs a T=6 launch",
         a[..., :6], sm.streamed_forward_batch(
             rows[..., :6, :].contiguous(), sig[..., :6], THETA, L=L,
             q=L // 2))
    phase(f"[timing] K6 forward L=30 T={T} traj=1, one launch: {sec:.3f} s, "
          f"peak device memory "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB (a state "
          f"{2 ** (L + 3) / 2**30:.3f} GiB, partials "
          f"{T * lib.floquet_x_streamed_partials(L) * 4 / 2**30:.3f} GiB) "
          f"on {smi}")
    del rows, sig, a
    out = {}
    for L, c, T in ((24, 4, 8), (26, 4, 8), (28, 4, 8), (30, 1, 6)):
        rows, sig = forward_inputs(L, T, c, P, dev, seed=L)
        kw = dict(L=L, q=L // 2)
        torch.cuda.reset_peak_memory_stats(dev)
        k_ms, p_ms, k, ref = timed_pair(
            lambda: sm.streamed_forward_batch(rows, sig, THETA, **kw),
            lambda: sm.streamed_forward_batch_ref(rows, sig, THETA, **kw), 1)
        what = f"forward L={L} T={T} traj={c}"
        err["K6 forward"] = max(err["K6 forward"], held(
            f"K6 {what} (timed inputs)", k, ref))
        peak("K6", what, L, dev, smi)
        passes = lib.floquet_x_streamed_passes(L)
        out[f"forward {L}"] = report(
            "K6", what, k_ms, p_ms, c * (T - 1) << L, "cycles", T * c,
            4 * (rows.numel() + k.numel()), 6 * L + 6, smi, passes=passes,
            spills=True)
        shares("K6", what, out[f"forward {L}"], passes * (T - 1) + 3, smi)
    return {"K6 forward": out["forward 28"]}


def timing_route(dev, smi) -> None:
    """K1 beside the streamed x forward on the same rows (32 trajectories,
    T=20) at L=22 and 23, where both run (the engine routes L <= 23 to
    K1), in turns, their outputs held to each other."""
    from dtc_tpu_torch.ops import resident_blocked as rb
    from dtc_tpu_torch.ops import streamed as sm

    c, T = 32, 20
    for L in (22, 23):
        rows, sig = forward_inputs(L, T, c, P, dev, seed=L)
        kw = dict(L=L, q=L // 2)
        s_ms, k1_ms, a, b = timed_pair(
            lambda: sm.streamed_forward_batch(rows, sig, THETA, **kw),
            lambda: rb.blocked_forward_batch(rows, sig, THETA, **kw), 3)
        held(f"K6 forward vs K1 L={L} T={T} 1x{c} (timed inputs)", a, b)
        phase(f"[timing] forward L={L} T={T} traj={c}, same rows: streamed "
              f"family {s_ms:.3f} ms, K1 {k1_ms:.3f} ms "
              f"({c * (T - 1) / (s_ms / 1e3):.1f} / "
              f"{c * (T - 1) / (k1_ms / 1e3):.1f} cycles/s) on {smi}")
        del rows, sig, a, b


def timing_general_route(dev, smi) -> None:
    """K4's forward (K2's split, a = L - L/2) beside the streamed
    lab-frame forward (K10a; ``plan_for``'s two-pass split, a = L - (L-2)/2)
    on the same L=23 rows (y and xy, 32 trajectories, T=20), where both
    run, in turns, their outputs held to each other."""
    from dtc_tpu_torch.ops import cycle_hi_general as chg
    from dtc_tpu_torch.ops import resident_general as rg

    L, c, T = 23, 32, 20
    for pol in ("y", "xy"):
        rows = general_forward_inputs(L, pol, T, c, P, dev, seed=L)
        kw = dict(L=L, T=T, q=L // 2)
        s_ms, k4_ms, a, b = timed_pair(
            lambda: chg.general_hi_forward_batch(rows, **kw),
            lambda: rg.general_forward_batch(rows, **kw), 3)
        held(f"K10 forward vs K4 L={L} {pol} T={T} 1x{c} (timed inputs)",
             a, b)
        phase(f"[timing] forward {pol} L={L} T={T} traj={c}, same rows: "
              f"K4 (split a={L - L // 2}) {k4_ms:.3f} ms, streamed family "
              f"(split a={L - (L - 2) // 2}) {s_ms:.3f} ms "
              f"({c * (T - 1) / (k4_ms / 1e3):.1f} / "
              f"{c * (T - 1) / (s_ms / 1e3):.1f} cycles/s) on {smi}")
        del rows, a, b


def timing_streamed_echo(dev, smi, err) -> dict:
    """The streamed echoes (K6b/K7b, K10b) on the main paths' launches
    against their plain versions on the same inputs, with the peak device
    memory of each kernel/plain pair, the launches a call and the shares of
    the state floor and of the bound: the x echo at L=28 (the ``autocorr``
    run's first launch: ts=0..3, 1 trajectory) and L=30 (its last: t=5), the
    lab-frame echo y at L=28 (the ``polarization`` run's first launch:
    ts=0..3, 1 trajectory) and circular_left at L=29 (the ``autocorr`` run's
    last: t=5). Operations per amplitude and step: the kick and one folded
    diagonal (6 L + 6 for RX, 14 L + 6 for the general 2x2). Returns the
    L=28 numbers."""
    from dtc_tpu_torch.ops import _build
    from dtc_tpu_torch.ops import cycle_hi_general as chg
    from dtc_tpu_torch.ops import streamed as sm
    from dtc_tpu_torch.ops.params import echo_width
    from dtc_tpu_torch.ops.params_general import LANE_COUNT, flag_base

    passes = _build.load("floquet_x_streamed").floquet_x_streamed_passes
    out = {}
    for L, T, ts in ((28, 20, [0, 1, 2, 3]), (30, 6, [5])):
        tiles, sfin = echo_inputs(L, T, 1, P, ts, dev, seed=L)
        kw = dict(L=L, q=L // 2)
        steps = sum(2 * t for t in ts)
        n_steps = int(tiles.reshape(-1, *tiles.shape[-2:])[
            :, 0, echo_width(L) - 4].max())
        what = (f"echo L={L} ts={ts[0]}..{ts[-1]} pairs={len(ts)} "
                f"steps={steps}")
        torch.cuda.reset_peak_memory_stats(dev)
        out[f"K6 {L}"] = timed_echo(
            "K6", what,
            lambda: sm.streamed_echo_batch(tiles, sfin, THETA, **kw),
            lambda: sm.streamed_echo_batch_ref(tiles, sfin, THETA, **kw),
            n_steps, err, "K6 echo", steps << L, steps,
            4 * (tiles.numel() + len(ts)), 6 * L + 6, smi,
            passes=passes(L), spills=True)
        peak("K6", what, L, dev, smi)
        del tiles
    for L, pol, T, ts in ((28, "y", 12, [0, 1, 2, 3]),
                          (29, "circular_left", 6, [5])):
        tiles = general_echo_inputs(L, pol, T, 1, P, ts, dev, seed=L)
        K = tiles.shape[-2] // (4 * T)
        kw = dict(L=L, q=L // 2)
        steps = sum(2 * t * K for t in ts)
        n_steps = int(tiles.reshape(-1, *tiles.shape[-2:])[
            :, 0, flag_base(L) + LANE_COUNT].max())
        what = (f"echo {pol} L={L} ts={ts[0]}..{ts[-1]} pairs={len(ts)} "
                f"steps={steps}")
        torch.cuda.reset_peak_memory_stats(dev)
        out[f"K10 {L}"] = timed_echo(
            "K10", what, lambda: chg.general_hi_echo_batch(tiles, **kw),
            lambda: chg.general_hi_echo_batch_ref(tiles, **kw), n_steps, err,
            "K10 echo", steps << L, steps, 4 * (tiles.numel() + len(ts)),
            14 * L + 6, smi, passes=passes(L), spills=True)
        peak("K10", what, L, dev, smi)
        del tiles
    return {"K6 echo": out["K6 28"], "K10 echo": out["K10 28"]}


def timing_general_hi(dev, smi, err) -> dict:
    """The streamed lab-frame family's forward against its plain version on
    the main paths' shapes, with the peak device memory of each kernel/plain
    pair: L=24, 26 and 28 (y, 4 trajectories, T=8) and L=29 (circular_left,
    1 trajectory, T=6: the ``autocorr`` run's launch), with the launches a
    call (the basis state, two or three passes a step, the reduce and A(0))
    and the shares of the state floor and of the bound. Operations per
    amplitude and step: K4's forward, 14 L + 6. Returns the L=28 numbers;
    the echo's rows are ``timing_streamed_echo``'s."""
    from dtc_tpu_torch.ops import _build
    from dtc_tpu_torch.ops import cycle_hi_general as chg

    lib = _build.load("floquet_general_streamed")
    out = {}
    for L, pol, T, c in ((24, "y", 8, 4), (26, "y", 8, 4), (28, "y", 8, 4),
                         (29, "circular_left", 6, 1)):
        rows = general_forward_inputs(L, pol, T, c, P, dev, seed=L)
        K = rows.shape[-2] // T
        kw = dict(L=L, T=T, q=L // 2)
        torch.cuda.reset_peak_memory_stats(dev)
        k_ms, p_ms, k, ref = timed_pair(
            lambda: chg.general_hi_forward_batch(rows, **kw),
            lambda: chg.general_hi_forward_batch_ref(rows, **kw), 1)
        what = f"forward {pol} L={L} T={T} traj={c} steps/cycle={K}"
        err["K10 forward"] = max(err["K10 forward"], held(
            f"K10 {what} (timed inputs)", k, ref))
        peak("K10", what, L, dev, smi)
        passes = lib.floquet_general_streamed_passes(L)
        out[f"forward {L}"] = report(
            "K10", what, k_ms, p_ms, c * (T - 1) * K << L, "cycles", T * c,
            4 * (rows.numel() + k.numel()), 14 * L + 6, smi, passes=passes,
            spills=True)
        shares("K10", what, out[f"forward {L}"], passes * (T - 1) * K + 3,
               smi)
        del rows
    return {"K10 forward": out["forward 28"]}


def timing_resident(dev, smi, err) -> dict:
    """K3 against its plain version on the adaptive path's shapes, each
    beside K4 (the kernel that served these schedules before) on the same
    schedule and rows: K3a on the per-cycle ramp at L=20, T=51 x 32 (one
    ``forward_value`` of the L=20 loop at T=50) and at L=14 and 16; K3b on
    32 pairs at t=12 (one ``echo_value`` of the T=12 loop). Operations per
    amplitude and step: 6 L for RX on every bit, 6 for the diagonal (one a
    step; the echo's two fold into one). Returns the L=20 numbers."""
    from dtc_tpu_torch.ops import resident as rs
    from dtc_tpu_torch.ops import resident_general as rg

    out = {}
    c = N_TRAJ
    for L in (14, 16, 20):
        T = 51
        angles, rows, sig, grows = ramp_inputs(L, T, c, P, None, dev,
                                               seed=L)
        kw = dict(L=L, q=L // 2, time_dependent=True)
        k_ms, p_ms, k, ref = timed_pair(
            lambda: rs.resident_forward_batch(rows, sig, angles, **kw),
            lambda: rs.resident_forward_batch_ref(rows, sig, angles, **kw),
            3 if L < 20 else 1)
        what = f"forward ramp L={L} T={T} traj={c}"
        err["K3 forward"] = max(err["K3 forward"], held(
            f"K3 {what} (timed inputs)", k, ref))
        k4_ms, k4 = time_ms(lambda: rg.general_forward_batch(
            grows, L=L, T=T, q=L // 2))
        held(f"K3 {what} vs K4 (timed inputs)", k, k4)
        out[f"forward {L}"] = report(
            "K3", what, k_ms, p_ms, c * (T - 1) << L, "cycles", T * c,
            4 * (rows.numel() + 2 * angles.shape[0] + k.numel()), 6 * L + 6,
            smi)
        out[f"forward {L}"]["k4_ms"] = k4_ms
        shares("K3", what, out[f"forward {L}"], 2 * (T - 1) + 3, smi)
        phase(f"[timing] K4 on the same ramp and rows, {what}: {k4_ms:.3f}"
              f" ms = {T * c / (k4_ms / 1e3):.1f} cycles/s ({k4_ms / k_ms:.3f}"
              f" x K3) on {smi}")
    out["echo"] = timing_k3_echo(dev, smi, err)
    return {"K3 forward": out[f"forward {MAIN_L}"], "K3 echo": out["echo"]}


def timing_cycle(dev, smi, err) -> dict:
    """K8a-d at L_loc=23 on 2 shards of 4 trajectories (the engines' launch:
    one per shard and cycle, here 2 per timed call) against their plain
    versions on identical inputs, noisy rows (p=0.6), xy for K8c/K8d (K=2
    slots); K1 and K4 at L=23 on 8 trajectories beside them (the same
    amplitudes, no shard bits; their time per cycle). Bytes: the shard
    states read and written once (16 B per amplitude) and the rows.
    Operations per amplitude and cycle: 6 L + 6 (K8a, K8b: RX on every bit,
    one diagonal), per slot 14 L + 6 (K8c, K8d: the 2x2 on every bit, one
    folded diagonal), and 6 more for K8d's row 0. State floor: two sweeps
    per slot. Every kernel's rows are the engines' folded rows with a
    shard's global angles; beside K8c/K8d, the torch pass that applied the
    global diagonal before they carried it (``cycle_hi.global_phase``, once
    on each shard). Before the timing, the registers and spills of every
    kernel of ``floquet_cycle.cu`` (K8a's and K8b's are the
    ``echo_lo_kernel`` and ``echo_hi_kernel`` instances of
    ``XEcho<CycleRows, ...>``) and K8c's and K8d's instances in
    ``floquet_general_streamed.cu`` (``GeneralEcho<ForwardRows<128>>`` with
    ``Times``, ``GeneralEcho<SlotPairRows<128>>``; their 4-column ones run
    here)."""
    from dtc_tpu_torch.ops import cycle as cy
    from dtc_tpu_torch.ops import cycle_hi as chi
    from dtc_tpu_torch.ops import resident_blocked as rb
    from dtc_tpu_torch.ops import resident_general as rg

    for kernel, regs, st, ld in ptxas_kernels("floquet_cycle"):
        phase(f"[build] floquet_cycle.cu {kernel}: {regs} registers, "
              f"spill stores {st} B, spill loads {ld} B")
    for kernel, regs, st, ld in ptxas_kernels("floquet_general_streamed"):
        if "ForwardRowsILi128" in kernel or "SlotPairRowsILi128" in kernel:
            phase(f"[build] floquet_general_streamed.cu (K8c/K8d) {kernel}: "
                  f"{regs} registers, spill stores {st} B, spill loads "
                  f"{ld} B")
    L, c, n_sh = 23, 4, 2
    N = 1 << L
    gen = torch.Generator(device=dev).manual_seed(23)
    start = [torch.randn((c, N), dtype=torch.complex64, generator=gen,
                         device=dev) for _ in range(n_sh)]
    start = [s / s.abs().pow(2).sum(-1, keepdim=True).sqrt() for s in start]
    rows = cycle_x_rows(L, 2, c, 0.6, dev, seed=23)[0][:, 1].contiguous()
    fold_f, fold_i = (cycle_fold(rows, L, 23, inverse)
                      for inverse in (False, True))
    grows = general_forward_inputs(L, "xy", 2, c, 0.6, dev, seed=23)[0]
    grows = grows.reshape(c, 2, 2, -1)[:, 1].contiguous()
    tiles = general_echo_inputs(L, "xy", 2, c, 0.6, [1], dev, seed=24)[0]
    tiles = tiles.reshape(c, 4, 2, 2, -1)[:, 1].contiguous()
    cases = {
        "K8a": ("forward x", cy.cycle_forward_apply,
                cy.cycle_forward_apply_ref,
                (fold_f, THETA), dict(L=L, q=L // 2), 1, 6 * L + 6),
        "K8b": ("inverse x", cy.cycle_inverse_apply,
                cy.cycle_inverse_apply_ref,
                (fold_i, THETA), dict(L=L), 1, 6 * L + 6),
        "K8c": ("forward xy", cy.general_cycle_forward_apply,
                cy.general_cycle_forward_apply_ref,
                (grows, general_fold(grows, L, 23)),
                dict(L=L, K=2, q=L // 2), 2, 14 * L + 6),
        "K8d": ("inverse xy", cy.general_cycle_inverse_apply,
                cy.general_cycle_inverse_apply_ref,
                (tiles, general_fold(tiles, L, 24, inverse=True)),
                dict(L=L, K=2), 2, 14 * L + 6),
    }
    out = {}
    for key, (what, kernel, plain, args, kw, K, flops) in cases.items():
        a = held_unit(f"{key} {what} L_loc={L} {n_sh} shards x {c} (timed "
                      "inputs)", key, err, kernel, plain, start, args, kw, L)
        k_ms, _ = time_ms(lambda: [kernel(s, *args, **kw) for s in a])
        p_ms, _ = time_ms(lambda: [plain(s, *args, **kw) for s in a], 1)
        amp_steps = n_sh * c * K * N
        io_bytes = 16 * n_sh * c * N + 4 * sum(
            x.numel() for x in args if torch.is_tensor(x))
        # K8d's row 0 (the first pre diagonal) before its first kick
        extra = 6 * n_sh * c * N if key == "K8d" else 0
        out[key] = report(key, f"{what} L_loc={L} {n_sh} shards x {c} traj, "
                          f"one cycle ({K} slot{'s' * (K > 1)})", k_ms, p_ms,
                          amp_steps, "cycles", 1, io_bytes, flops, smi,
                          extra_ops=extra)
        del a
    th = torch.rand((2, c), generator=gen, device=dev)
    g_ms, _ = time_ms(lambda: [chi.global_phase(s, *th) for s in start])
    phase(f"[timing] K8c/K8d's former torch pass, global_phase once on each"
          f" of the {n_sh} shards x {c} at L_loc={L}: {g_ms:.3f} ms (K8c "
          f"{out['K8c']['ms']:.3f} ms and K8d {out['K8d']['ms']:.3f} ms now "
          f"carry it in their rows) on {smi}")
    T = 9
    rows1, sig = forward_inputs(L, T, n_sh * c, P, dev, seed=25)
    k1_ms, _ = time_ms(lambda: rb.blocked_forward_batch(rows1, sig, THETA,
                                                        L=L, q=L // 2))
    rows4 = general_forward_inputs(L, "xy", T, n_sh * c, P, dev, seed=26)
    k4_ms, _ = time_ms(lambda: rg.general_forward_batch(rows4, L=L, T=T,
                                                        q=L // 2))
    k1_ms, k4_ms = k1_ms / (T - 1), k4_ms / (T - 1)
    for key in ("K8a", "K8b"):
        out[key]["k1_ms"] = k1_ms
    for key in ("K8c", "K8d"):
        out[key]["k4_ms"] = k4_ms
    phase(f"[timing] beside K8 at L={L}, {n_sh * c} states of 2^{L}, per "
          "cycle:"
          f" K1 (x) {k1_ms:.3f} ms against K8a {out['K8a']['ms']:.3f} ms; K4"
          f" (xy, 2 slots) {k4_ms:.3f} ms against K8c {out['K8c']['ms']:.3f}"
          f" ms on {smi}")
    return out


def timing_cycle_hi(dev, smi, err) -> dict:
    """K9a/K9b and K10's shard-local forms (y: one slot; xy: two) at
    L_loc = 28 on 2 shards of 2 trajectories (the engines' launch: one per
    shard and cycle, here 2 per timed call) against their plain versions on
    identical inputs, noisy rows (p=0.6); the streamed x family (K6) and the
    one-card K10 at L=28 on the same four states beside them (no shard bits;
    their time per cycle over T-1 = 4 cycles). Bytes: the shard states read
    and written once (16 B per amplitude) and the rows. Operations per
    amplitude and cycle: 6 L + 6 (K9a, K9b: RX on every bit, one diagonal),
    per slot 14 L + 6 (K10a, K10b: the 2x2 on every bit, one folded
    diagonal), and 6 more for K10b's row 0. State floor: three sweeps per
    slot. Every kernel's rows are the engines' folded rows with a shard's
    global angles; before the timing, the
    registers and spills of every kernel of ``floquet_cycle_hi.cu`` (K9a's
    and K9b's are the ``echo_*_kernel`` instances of ``XEcho<CycleRows,
    ...>``) and of ``floquet_general_streamed.cu`` (K10's shard-local forms
    are its ``echo_*_kernel`` instances of ``GeneralEcho<ForwardRows<...>>``
    with ``Times`` and ``GeneralEcho<SlotPairRows<...>>``; the 128-lane
    forward's are the one-card forward's). The JSON line takes the xy
    numbers for K10a/K10b."""
    from dtc_tpu_torch.ops import cycle_hi as chi
    from dtc_tpu_torch.ops import cycle_hi_general as chg
    from dtc_tpu_torch.ops import streamed as sm
    from dtc_tpu_torch.ops.params_general import general_hi_width

    for lib in ("floquet_cycle_hi", "floquet_general_streamed"):
        for kernel, regs, st, ld in ptxas_kernels(lib):
            phase(f"[build] {lib}.cu {kernel}: {regs} registers, "
                  f"spill stores {st} B, spill loads {ld} B")
    L, c, n_sh = 28, 2, 2
    N = 1 << L
    w = general_hi_width(L)
    gen = torch.Generator(device=dev).manual_seed(28)
    start = []
    for _ in range(n_sh):
        st = torch.randn((c, N), dtype=torch.complex64, generator=gen,
                         device=dev)
        start.append(st.div_(st.abs().pow(2).sum(-1, keepdim=True).sqrt()))
    rows = cycle_x_rows(L, 2, c, 0.6, dev, seed=28)[0][:, 1]
    fold_f, fold_i = (cycle_fold(rows, L, 28, inverse)
                      for inverse in (False, True))
    cases = {
        "K9a": ("forward x", chi.hi_cycle_forward_apply,
                chi.hi_cycle_forward_apply_ref, (fold_f, THETA),
                dict(L=L, q=L // 2), 1, 6 * L + 6),
        "K9b": ("inverse x", chi.hi_cycle_inverse_apply,
                chi.hi_cycle_inverse_apply_ref, (fold_i, THETA), dict(L=L), 1,
                6 * L + 6),
    }
    for pol in ("y", "xy"):
        grows = general_forward_inputs(L, pol, 2, c, 0.6, dev, seed=29,
                                       width=w)[0]
        K = grows.shape[-2] // 2
        grows = grows.reshape(c, 2, K, w)[:, 1].contiguous()
        tiles = general_echo_inputs(L, pol, 2, c, 0.6, [1], dev, seed=30,
                                    width=w)[0]
        tiles = tiles.reshape(c, 4, K, 2, w)[:, 1].contiguous()
        cases[f"K10a local {pol}"] = (
            f"forward {pol}", chi.general_hi_cycle_forward_apply,
            chi.general_hi_cycle_forward_apply_ref,
            (grows, general_fold(grows, L, 28)), dict(L=L, K=K, q=L // 2),
            K, 14 * L + 6)
        cases[f"K10b local {pol}"] = (
            f"inverse {pol}", chi.general_hi_cycle_inverse_apply,
            chi.general_hi_cycle_inverse_apply_ref,
            (tiles, general_fold(tiles, L, 29, inverse=True)),
            dict(L=L, K=K), K, 14 * L + 6)
    passes = 3  # L_loc = 28
    out = {}
    for key, (what, kernel, plain, args, kw, K, flops) in cases.items():
        err_key = " ".join(key.split()[:2]) if "local" in key else key
        a = held_unit(f"{key} {what} L_loc={L} {n_sh} shards x {c} (timed "
                      "inputs)", err_key, err, kernel, plain, start, args,
                      kw, L)
        k_ms, _ = time_ms(lambda: [kernel(st, *args, **kw) for st in a])
        p_ms, _ = time_ms(lambda: [plain(st, *args, **kw) for st in a], 1)
        amp_steps = n_sh * c * K * N
        io_bytes = 16 * n_sh * c * N + 4 * sum(
            x.numel() for x in args if torch.is_tensor(x))
        # K10b's row 0 (the first pre diagonal) before its first kick
        extra = 6 * n_sh * c * N if key.startswith("K10b") else 0
        out[key] = report(key, f"{what} L_loc={L} {n_sh} shards x {c} traj, "
                          f"one cycle ({K} slot{'s' * (K > 1)})", k_ms, p_ms,
                          amp_steps, "cycles", 1, io_bytes, flops, smi,
                          extra_ops=extra, passes=passes)
        del a
    T = 5
    rows6, sig = forward_inputs(L, T, n_sh * c, P, dev, seed=31)
    k6_ms, _ = time_ms(lambda: sm.streamed_forward_batch(
        rows6, sig, THETA, L=L, q=L // 2), 1)
    del rows6
    per = {"K6": k6_ms / (T - 1)}
    for pol in ("y", "xy"):
        rows10 = general_forward_inputs(L, pol, T, n_sh * c, P, dev, seed=32)
        k10_ms, _ = time_ms(lambda: chg.general_hi_forward_batch(
            rows10, L=L, T=T, q=L // 2), 1)
        per[f"K10 {pol}"] = k10_ms / (T - 1)
        del rows10
    for key in ("K9a", "K9b"):
        out[key]["k6_ms"] = per["K6"]
    for key in out:
        if "local" in key:
            out[key]["k10_ms"] = per[f"K10 {key.split()[-1]}"]
    phase(f"[timing] beside K9/K10 shard-local at L={L}, {n_sh * c} states "
          f"of 2^{L}, per cycle: K6 (x) {per['K6']:.3f} ms against K9a "
          f"{out['K9a']['ms']:.3f} ms; one-card K10 y {per['K10 y']:.3f} ms"
          f" against K10a local {out['K10a local y']['ms']:.3f} ms; xy "
          f"{per['K10 xy']:.3f} ms against "
          f"{out['K10a local xy']['ms']:.3f} ms on {smi}")
    out["K10a local"] = out["K10a local xy"]
    out["K10b local"] = out["K10b local xy"]
    return {k: out[k] for k in ("K9a", "K9b", "K10a local", "K10b local")}


def timing_noise_factor(dev, smi, launches) -> dict:
    """K11 against its plain version at the planar main path's shape: 32
    states of L=20 and their tiles (one launch of the forward sweep; the
    outputs were held in ``compare_noise_factor``), with the kernel's
    registers and spills. Bytes: the state read and written once (16 B per
    amplitude) and the tiles. Operations: 12 per amplitude (one complex
    product of two table phases and the state multiply), and per table
    entry (2^(a+1) of the low qubits, a = 8, a block; one per row of 2^a
    amplitudes) its angle and a precise sincos, about 3L + 20, counted once
    per state."""
    from dtc_tpu_torch.ops import noise_factor as nf

    for kernel, regs, st, ld in ptxas_kernels("noise_factor"):
        phase(f"[build] noise_factor.cu {kernel}: {regs} registers, spill "
              f"stores {st} B, spill loads {ld} B")
    L, B = MAIN_L, N_TRAJ
    N = 1 << L
    gen = torch.Generator(device=dev).manual_seed(3)
    st = torch.randn((B, 2, N), generator=gen, device=dev)
    st /= st.square().sum((1, 2), keepdim=True).sqrt()
    rnd = torch.randint(0, N, (2, B), generator=gen, device=dev)
    h, ph = ((torch.rand((B, n), generator=gen, device=dev) * 2 - 1)
             * math.pi for n in (L, L - 1))
    par = nf.pack_cycle_params(rnd[0], rnd[1], h, ph, L)
    k_ms, p_ms, _, _ = timed_pair(
        lambda: nf.apply_noise_factor(st, par, L=L),
        lambda: nf.noise_factor_plain(st, par, L=L), 3)
    out = report("K11", f"noise factor L={L} B={B} (planar forward, one "
                 f"of {launches} launches a sweep)", k_ms, p_ms, B * N,
                 "states", B, 16 * B * N + 4 * par.numel(), 12, smi,
                 extra_ops=B * ((2 << 8) + (N >> 8)) * (3 * L + 20),
                 passes=1)
    del st
    return out


def compare_exact(dev) -> None:
    """[compare] exact: the density-matrix run wrappers on the card against
    the same calls on the CPU (L=8, T=10, x and xy, p=0.05; complex128
    within 1e-10, complex64 within 1e-5), and the literal Hadamard test on
    the card against the direct mode (L=5, t=3, forward and echo, within
    1e-6)."""
    from dtc_tpu_torch.core import density

    cpu = torch.device("cpu")
    L, T, p = 8, 10, 0.05
    hs, phis = disorder(L, cpu)
    for pol in ("x", "xy"):
        angles = schedule(pol, T, cpu)
        for name, tol in (("complex128", 1e-10), ("complex64", 1e-5)):
            kw = dict(L=L, T=T, K=angles.shape[1], p=p, q=L // 2,
                      dtype_name=name)
            out = []
            for d in (dev, cpu):
                args = (hs[0].to(d), phis[0].to(d), angles.to(d))
                out.append(torch.cat([
                    density.dm_autocorr_forward_run(*args, **kw),
                    density.dm_autocorr_echo_run(*args, range(T), **kw)
                ]).cpu())
            diff = float((out[0] - out[1]).abs().max())
            phase(f"[compare] exact L={L} T={T} {pol} {name} cuda vs cpu: "
                  f"max|d(A, echo)| {diff:.3e} (bound {tol:g})")
            if not diff <= tol:
                raise RuntimeError(f"exact DM {pol} {name} on the card "
                                   "disagrees with the CPU")
    L, t = 5, 3
    hs, phis = disorder(L, dev)
    angles = schedule("xy", T, dev)
    psi0, diag = density._run_inputs(hs[0], phis[0], L, "vacuum",
                                     "complex128")
    kw = dict(L=L, K=2, p=p, q=L // 2)
    for echo in (False, True):
        lit = density.dm_autocorr_interferometric(psi0, angles, diag, t,
                                                  echo=echo, **kw)
        direct = float(
            density.dm_autocorr_echo(psi0, angles, diag, t, T=T, **kw)
            if echo else density.dm_autocorr_forward(
                psi0, angles, diag, T=T, **kw)[t])
        phase(f"[compare] exact interferometric L={L} t={t} "
              f"{'echo' if echo else 'forward'} on the card: {lit:.10f} "
              f"against the direct mode's {direct:.10f}")
        if not abs(lit - direct) <= 1e-6:
            raise RuntimeError("the literal Hadamard test disagrees with "
                               "the direct mode")


def main_exact(smi, L=13, T=20) -> None:
    """[main] exact: ``autocorr --device cuda --method exact`` at L=13
    (4^13 amplitudes, 512 MiB a complex64 density vector), T=20, one
    instance; A(0) = echo(0) = (1-p)^6, |A| and |echo| <= 1, no kernel
    launched (the path has none)."""
    dev = torch.device(DEVICE)
    torch.cuda.reset_peak_memory_stats(dev)
    with tempfile.TemporaryDirectory() as tmp:
        launches, plain, log, seconds = run_cli(
            ["autocorr", "--method", "exact", "--inst", "1",
             *common_argv(T, tmp, L=L)])
        cols = one_csv(tmp, "autocorr_data_")
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    a, e = cols["av_autocorr"], cols["av_autocorr_echo"]
    af = (1 - P) ** 6
    checks = {
        "A(0) = (1-p)^6": abs(a[0] - af) <= 1e-5,
        "echo(0) = (1-p)^6": abs(e[0] - af) <= 1e-5,
        "|A| <= 1": all(abs(x) <= 1 + 1e-5 for x in a),
        "|echo| <= 1": all(abs(x) <= 1 + 1e-5 for x in e),
        "A alternates over 4 cycles": all(a[i] * a[i + 1] < 0
                                          for i in range(3)),
        "no kernel launched": not any(launches.values()),
        "no plain version on CUDA": not any(plain.values()),
    }
    phase(f"[main] autocorr --method exact L={L} T={T} inst=1 in "
          f"{seconds:.2f}s (exact phase {log.seconds['exact'][0]:.3f} s), "
          f"peak device memory {peak:.2f} GiB on {smi}: "
          f"A[0:4]={[round(x, 6) for x in a[:4]]} "
          f"echo[0:4]={[round(x, 6) for x in e[:4]]} "
          f"echo[T-1]={e[-1]:.6f}")
    fail_on(f"autocorr --method exact L={L}", checks)


def compare_sharded_observables(dev, L=20) -> None:
    """[compare] sharded observables: make_sharded_observables on 2
    logical shards of the card against the unsharded evolve_observables on
    the same uniforms (L=20, T=10, 4 trajectories, p=0.05, xy, complex64):
    <Z_q> within 1e-4, E within 1e-4 * L."""
    from dtc_tpu_torch.core.evolve import (
        evolve_observables,
        make_floquet_params,
    )
    from dtc_tpu_torch.core.statevector import initial_statevector
    from dtc_tpu_torch.models.hamiltonian import hamiltonian_terms
    from dtc_tpu_torch.ops.diag import zz_z_diag_energy
    from dtc_tpu_torch.parallel import sharded as sh
    from dtc_tpu_torch.parallel.mesh import make_mesh

    T, c, p = 10, 4, 0.05
    hs, phis = disorder(L, dev)
    angles = schedule("xy", T, dev)
    terms = hamiltonian_terms(L, 0.97, hs[0], phis[0])
    u = uniforms((c, T * 2, L), dev, seed=21)
    t0 = time.perf_counter()
    e_s, z_s = sh.make_sharded_observables(
        make_mesh(2, 1, devices=[dev, dev]), L=L, T=T, K=2, p=p)(
        angles, hs[0], phis[0], terms.hs, terms.phis, terms.x_coeff, u,
        n_traj=c)
    torch.cuda.synchronize()
    sharded_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    e, z = evolve_observables(
        initial_statevector(L, device=dev).expand(c, -1), angles,
        make_floquet_params(hs[0], phis[0], L),
        zz_z_diag_energy(terms.hs, terms.phis, L, dtype=torch.float32),
        terms.x_coeff, u, L=L, T=T, K=2, p=p)
    torch.cuda.synchronize()
    eager_s = time.perf_counter() - t0
    d_e = float((e_s - e.mean(0)).abs().max())
    d_z = float((z_s - z.mean(0)).abs().max())
    phase(f"[compare] sharded observables L={L} T={T} xy {c} trajectories "
          f"on 2 shards of the card vs unsharded: max|dE| {d_e:.3e} "
          f"(bound {1e-4 * L:g}), max|dz| {d_z:.3e} (bound 1e-4); "
          f"{sharded_s:.3f} s sharded, {eager_s:.3f} s unsharded")
    if not (d_e <= 1e-4 * L and d_z <= 1e-4):
        raise RuntimeError("the sharded observables disagree with the "
                           "unsharded engine")


def main_energy_sharded(smi, L=24, T=10) -> None:
    """[main] energy sharded: ``--num_devices 2 energy --device cuda
    --sharded --n_amp 2`` at L=24 (2^23 amplitudes a shard), T=10, p = 0
    and 0.01, at 4 trajectories and at the CLI's default count (256, in
    runs of ``_launch_traj(mesh, 23, OBS_AMP_BYTES)``): E(0)/L = (sum h +
    sum phi)/L and <Z_q(0)> = 1 for the vacuum at each level, the route
    logged, no kernel launched; the seconds and peak device memory of
    each."""
    from dtc_tpu_torch.experiments import sharded_run
    from dtc_tpu_torch.io.disorder import get_disorder
    from dtc_tpu_torch.utils.config import SimConfig

    results = []
    run = sharded_run.run_energy_sharded

    def keep(*args, **kw):
        results.append(run(*args, **kw))
        return results[-1]

    for n in (4, SimConfig().n_trajectories):
        results.clear()
        sharded_run.run_energy_sharded = keep
        torch.cuda.reset_peak_memory_stats(DEVICE)
        try:
            with tempfile.TemporaryDirectory() as tmp:
                launches, plain, log, seconds = run_cli(
                    ["--num_devices", "2", "energy", "--sharded", "--n_amp",
                     "2", "--inst", "1", "--nprobs", "0,0.01",
                     *common_argv(T, tmp, L=L, n_traj=n)])
                cols = one_csv(tmp, "energy_data_")
                hs, phis = get_disorder(SimConfig(L=L, inst=1), tmp)
        finally:
            sharded_run.run_energy_sharded = run
        peak = torch.cuda.max_memory_allocated(DEVICE) / 2**30
        e0 = float(hs[0, :L].sum() + phis[0, :L - 1].sum()) / L
        zq0 = [float(z[0].min()) for z in results[0]["per_qubit_z"].values()]
        checks = {
            "columns": list(cols) == ["time", "energy_p_0", "energy_p_0.01"],
            "E(0)/L = (sum h + sum phi)/L": all(
                abs(v[0] - e0) <= 1e-5 for k, v in cols.items()
                if k != "time"),
            "values finite": all(math.isfinite(x) for k, v in cols.items()
                                 for x in v),
            "z_q(0) = 1": all(abs(z - 1) <= 1e-5 for z in zq0),
            "mesh (1,2)": results[0]["mesh_shape"] == {"traj": 1, "amp": 2},
            "engine=sharded_obs mesh=(1,2)": log.sweeps == [
                ("sharded_energy", "sharded_obs", "(1,2)")] * 2,
            "no kernel launched": not any(launches.values()),
            "no plain version on CUDA": not any(plain.values()),
        }
        per = ", ".join(f"{k} {v[0]:.3f} s" for k, v in log.seconds.items())
        phase(f"[main] energy --sharded L={L} T={T} traj={n} on 2 shards "
              f"of one card in {seconds:.2f}s ({per}), peak {peak:.2f} GiB "
              f"on {smi}: E/L t=0,1: "
              + ", ".join(f"{k} {v[0]:.6f} {v[1]:.6f}"
                          for k, v in cols.items() if k != "time"))
        fail_on(f"energy --sharded L={L} traj={n}", checks)


def dryrun(smi) -> None:
    """[dryrun]: ``dryrun_multichip(4)`` on four logical shards of the
    card, its seconds."""
    from dtc_tpu_torch.dryrun import dryrun_multichip

    t0 = time.perf_counter()
    dryrun_multichip(4, device=DEVICE)
    torch.cuda.synchronize()
    phase(f"[dryrun] dryrun_multichip(4) on one card in "
          f"{time.perf_counter() - t0:.2f}s on {smi}")


def main() -> None:
    csrc = os.path.join(HERE, "dtc_tpu_torch", "csrc")
    if not all(os.path.isfile(os.path.join(csrc, f))
               for f in ("floquet_x.cu", "floquet_x_resident.cu",
                         "floquet_x_streamed.cu", "floquet_general.cu",
                         "floquet_general_streamed.cu", "floquet_cycle.cu",
                         "floquet_cycle_hi.cu", "noise_factor.cu")):
        sys.exit("chip_smoke: run it from the root of a checkout of the"
                 " repository (dtc_tpu_torch/csrc not found beside it)")
    smi = card()
    dev = torch.device("cuda")
    build()
    err = {"K1": 0.0, "K2": 0.0, "K3 forward": 0.0, "K3 echo": 0.0,
           "K4 forward": 0.0, "K4 echo": 0.0,
           "K5": 0.0, "K6 forward": 0.0, "K6 echo": 0.0,
           "K10 forward": 0.0, "K10 echo": 0.0,
           "K8a": 0.0, "K8b": 0.0, "K8c": 0.0, "K8d": 0.0,
           "K9a": 0.0, "K9b": 0.0, "K10a local": 0.0, "K10b local": 0.0,
           "K11": 0.0}
    compare_x(dev, err)
    compare_general(dev, err)
    compare_obs(dev, err)
    compare_eager(dev)
    compare_streamed(dev, err)
    compare_general_hi(dev, err)
    compare_resident(dev, err)
    compare_cycle(dev, err)
    compare_cycle_hi(dev, err)
    compare_sharded(dev, err)
    compare_noise_factor(dev, err)
    compare_device(dev, err)
    anchors_l30(dev)
    anchors_l31_sharded(dev)
    launches = main_autocorr(smi)
    for k, v in main_campaign(smi).items():
        launches[k] += v
    launches.update({k: v for k, v in main_polarization(smi).items()
                     if k.startswith("K4")})
    main_studies()
    launches["K5"] = main_energy(smi)
    large = main_polarization(
        smi, L=28, T=12, n_traj=2, x_route=("streamed", "K6 forward",
                                            "K6 echo"),
        route=("general_hi", "K10 forward", "K10 echo"))
    for k, v in main_large(smi).items():
        launches[k] = v + large[k]
    launches.update(main_resident(smi))
    launches.update(main_sharded(smi))
    launches.update(main_sharded_hi(smi))
    launches.update(main_sharded_general_hi(smi))
    planar = main_planar(smi, dev)
    launches["K11"] = planar["K11"]
    device = main_device(smi, dev)
    compare_exact(dev)
    main_exact(smi)
    compare_sharded_observables(dev)
    main_energy_sharded(smi)
    dryrun(smi)
    times = timing(dev, smi, err)
    times.update(timing_streamed(dev, smi, err))
    timing_route(dev, smi)
    timing_general_route(dev, smi)
    times.update(timing_general_hi(dev, smi, err))
    times.update(timing_streamed_echo(dev, smi, err))
    times.update(timing_resident(dev, smi, err))
    times.update(timing_cycle(dev, smi, err))
    times.update(timing_cycle_hi(dev, smi, err))
    times["K11"] = timing_noise_factor(dev, smi, launches["K11"])
    times["K4 forward"] = times.pop("K4 forward xy")
    times["K5"] = times.pop("K5 x")
    line = []
    for key, fn, src, where, also in KERNELS:
        entry = {"name": f"{key.split()[0]} {fn}", "route": "cuda",
                 "source": src, "replaces": where,
                 "launches": launches[key], "max_abs_err": err[key],
                 "ms": times[key]["ms"], "plain_ms": times[key]["plain_ms"],
                 "bound_ms": times[key]["bound_ms"],
                 "bound_by": times[key]["bound_by"], "library_ms": None,
                 "main_s": MAIN_SECONDS[key], "main_calls": MAIN_CALLS[key]}
        if also:
            entry["also_replaces"] = also
        # K3, K8: K1/K4 beside them; K9, K10 shard-local: K6, one-card K10
        for extra in ("k1_ms", "k4_ms", "k6_ms", "k10_ms"):
            if extra in times[key]:
                entry[extra] = times[key][extra]
        line.append(entry)
    phase(f"[timing] planar forward {planar['planar_cycles_per_s']:.1f} "
          f"cycles/s against K1's {planar['k1_cycles_per_s']:.1f} at the "
          f"bench shape; config 4 device forward "
          f"{device['config4_traj_cycles_per_s']:.1f} traj-cycles/s on "
          f"{smi}")
    phase("[main] device seconds of each entry over the main paths: "
          + ", ".join(f"{k} {MAIN_SECONDS[k]:.3f} s ({MAIN_CALLS[k]} calls)"
                      for k in MAIN_SECONDS) + f" on {smi}")
    print(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
