"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root: ``python3 chip_smoke.py``. Phases, one line
each; any failure raises and the script exits non-zero without a result:

1. card: CUDA present, name and power limit, TF32 off;
2. build: the CUDA kernels from ``dtc_tpu_torch/csrc`` (nvcc, sm_90a);
3. kernel vs plain version on the card, max |diff| <= 1e-4 each: small
   shapes across the kernels' range, then the main path's own shapes (K1 on
   2 instances x 32 trajectories at T=50; K2 on the echo sweep's last two
   chunks, trip counts up to 98);
4. main path: ``python -m dtc_tpu_torch autocorr --device cuda`` at L=20,
   T=50, p=0.05, 2 instances x 32 trajectories, through the CLI's
   ``main(argv)``; physics checks on its CSV; every kernel of the path
   launched, no plain version called on a CUDA tensor; the forward and echo
   sweep seconds from the run's own phase log;
5. timing: the bench shape (``dtc_tpu_torch/bench.py::run_case``) and the
   kernels against their plain versions on identical inputs, whose outputs
   are held to the same bound;
6. a JSON line of the kernels, then the last line
   ``{"ok": true, "device": {...}}``.

It imports only torch and the port; the port itself reuses the JAX
package's jax-free modules (disorder, CSV, config).
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
    _build.load()
    info = _build.build_info["floquet_x"]
    regs = [ln.strip() for ln in info["log"].splitlines() if "registers" in ln]
    phase(f"[build] floquet_x.cu in {time.perf_counter() - t0:.2f}s "
          f"(nvcc {info['seconds']:.2f}s); " + " | ".join(regs))


def disorder(L, dev, inst=1, seed=7):
    """``inst`` instances, distributed as the CLI's default disorder:
    h ~ U[-pi, pi), phi ~ U[-1.5 pi, -0.5 pi)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    u = torch.rand((2, inst, L), generator=gen, dtype=torch.float64,
                   device=dev)
    return (2 * u[0] - 1) * math.pi, (u[1, :, :L - 1] - 1.5) * math.pi


def forward_inputs(L, T, c, p, dev, seed, inst=1):
    from dtc_tpu_torch.ops.params import forward_rows

    hs, phis = disorder(L, dev, inst)
    gen = torch.Generator(device=dev).manual_seed(seed)
    u = torch.rand((inst, c, T, L), generator=gen, device=dev)
    return forward_rows(u, hs[:, None], phis[:, None], L=L, T=T, p=p)


def echo_inputs(L, T, c, p, ts, dev, seed, inst=1):
    from dtc_tpu_torch.ops.params import echo_pair_tiles

    hs, phis = disorder(L, dev, inst)
    gen = torch.Generator(device=dev).manual_seed(seed)
    u = torch.rand((inst, c, 2 * T, L), generator=gen, device=dev)
    return echo_pair_tiles(u, torch.as_tensor(ts, device=dev), hs[:, None],
                           phis[:, None], L=L, T=T, p=p)


def held(what: str, k, ref) -> float:
    """max |kernel - plain|, printed; raises above TOL."""
    d = float((k - ref).abs().max())
    phase(f"[compare] {what}: max|kernel-plain| = {d:.3e}")
    if not d <= TOL:
        raise RuntimeError(f"{what}: kernel disagrees with its plain version"
                           f" by {d} > {TOL}")
    return d


def compare(dev) -> dict:
    from dtc_tpu_torch.ops import resident_blocked as rb

    err = {"forward": 0.0, "echo": 0.0}
    # small shapes across the range, then the main path's batch:
    # 2 instances x 32 trajectories through all 50 cycles
    for L, T, state, c, inst in ((17, 4, "neel", 3, 1), (20, 8, "vacuum", 3, 1),
                                 (23, 3, "vacuum", 3, 1),
                                 (20, 50, "vacuum", 32, 2)):
        rows, sig = forward_inputs(L, T, c, 0.05 if T == 50 else 0.1, dev,
                                   seed=L + T, inst=inst)
        k = rb.blocked_forward_batch(rows, sig, THETA, L=L, q=L // 2,
                                     initial_state=state)
        torch.cuda.synchronize()
        ref = rb.blocked_forward_batch_ref(rows, sig, THETA, L=L, q=L // 2,
                                           initial_state=state)
        torch.cuda.synchronize()
        d = held(f"K1 L={L} T={T} {state} {inst}x{c}", k, ref)
        err["forward"] = max(err["forward"], d)
    for p in (0.6, 0.0):
        tiles, sig = echo_inputs(20, 4, 2, p, [1, 2, 3, 4], dev, seed=2)
        k = rb.blocked_echo_batch(tiles, sig, THETA, L=20, q=10)
        torch.cuda.synchronize()
        ref = rb.blocked_echo_batch_ref(tiles, sig, THETA, L=20, q=10)
        torch.cuda.synchronize()
        d = held(f"K2 L=20 T=4 ts=1..4 p={p} (min A0 {float(k.min()):.6f})",
                 k, ref)
        if p == 0.0 and not float((k - 1).abs().max()) <= TOL:
            raise RuntimeError(f"noiseless echo != 1: {k.tolist()}")
        err["echo"] = max(err["echo"], d)
    # the main path's last two echo chunks (T=50, t_chunk=8): the longest
    # trip counts, 80..98 steps, on 2 instances x 32 trajectories
    for ts in (list(range(40, 48)), [48, 49]):
        tiles, sig = echo_inputs(20, 50, 32, 0.05, ts, dev, seed=ts[0],
                                 inst=2)
        k = rb.blocked_echo_batch(tiles, sig, THETA, L=20, q=10)
        torch.cuda.synchronize()
        ref = rb.blocked_echo_batch_ref(tiles, sig, THETA, L=20, q=10)
        torch.cuda.synchronize()
        d = held(f"K2 L=20 T=50 ts={ts[0]}..{ts[-1]} p=0.05 2x32", k, ref)
        err["echo"] = max(err["echo"], d)
        del tiles, k, ref
    return err


class PhaseLog(logging.Handler):
    """Seconds of each ``phase_timer`` phase the run logs."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.seconds = {}

    def emit(self, record):
        if record.msg.startswith("phase ") and len(record.args) == 2:
            self.seconds[record.args[0]] = record.args[1]


def read_csv(path) -> dict:
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    return {k: [float(r[i]) for r in rows[1:]] for i, k in enumerate(rows[0])}


def main_path(smi) -> dict:
    from dtc_tpu_torch.ops import resident_blocked as rb
    from dtc_tpu_torch.utils.cli import main as cli_main

    p = 0.05
    with tempfile.TemporaryDirectory() as tmp:
        argv = ["autocorr", "--device", "cuda", "--L", "20", "--tf", "50",
                "--g", "0.97", "--noise_prob", str(p), "--inst", "2",
                "--n_trajectories", "32", "--out_dir", tmp,
                "--disorder_dir", tmp]
        phases = PhaseLog()
        logging.getLogger("dtc_tpu").addHandler(phases)
        rb.reset_counters()
        t0 = time.perf_counter()
        rc = cli_main(argv)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = dict(rb.LAUNCHES)
        plain_on_cuda = dict(rb.PLAIN_ON_CUDA)
        logging.getLogger("dtc_tpu").removeHandler(phases)
        if rc != 0:
            raise RuntimeError(f"autocorr CLI returned {rc}")
        csvs = [f for f in os.listdir(tmp) if f.endswith(".csv")
                and f.startswith("autocorr_data_")]
        if len(csvs) != 1:
            raise RuntimeError(f"expected one result CSV, got {csvs}")
        cols = read_csv(os.path.join(tmp, csvs[0]))
    want = ["time", "av_autocorr", "av_autocorr_echo", "sqrt_av_autocorr_echo"]
    if list(cols) != want:
        raise RuntimeError(f"CSV columns {list(cols)} != {want}")
    a, e = cols["av_autocorr"], cols["av_autocorr_echo"]
    af = (1 - p) ** 6
    checks = {
        "A(0) = (1-p)^6": abs(a[0] - af) < 1e-3,
        "|A| <= 1": all(abs(x) <= 1 + 1e-3 for x in a),
        "A finite": all(math.isfinite(x) for x in a),
        "A alternates over 4 cycles": all(a[t] * a[t + 1] < 0
                                          for t in range(3)),
        "echo finite": all(math.isfinite(x) for x in e),
        "echo <= 1": all(x <= 1 + 1e-3 for x in e),
        "K1 launched": launches["forward"] > 0,
        "K2 launched": launches["echo"] > 0,
        "no plain version on CUDA": not any(plain_on_cuda.values()),
    }
    phase(f"[main] autocorr L=20 T=50 inst=2 traj=32 in {seconds:.2f}s: "
          f"A[0:4]={[round(float(x), 6) for x in a[:4]]} "
          f"echo[0:4]={[round(float(x), 6) for x in e[:4]]} "
          f"launches={launches}")
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise RuntimeError(f"main-path checks failed: {bad}")
    phase("[main] checks passed: " + ", ".join(checks))
    phase(f"[main] sweep seconds: forward {phases.seconds['forward']:.3f} s, "
          f"echo {phases.seconds['echo']:.3f} s (inst=2 x 32 trajectories) "
          f"on {smi}")
    return launches


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
    plain), and the max |kernel - plain| of their outputs."""
    p_a, ref = time_ms(plain, reps)
    k_a, out = time_ms(kernel)
    k_b, _ = time_ms(kernel)
    p_b, _ = time_ms(plain, reps)
    return min(k_a, k_b), min(p_a, p_b), out, ref


def timing(dev, smi):
    """Times and max |kernel - plain| of both kernels at the main path's
    shapes."""
    from dtc_tpu_torch.bench import run_case
    from dtc_tpu_torch.ops import resident_blocked as rb

    L, T, c = 20, 50, 32
    cps, dt = run_case(L=L, T=T, p=0.05, n_traj=c, device=dev)
    phase(f"[timing] bench shape L=20 T=50 traj=32 p=0.05 via run_case: "
          f"{cps:.1f} cycles/s ({dt * 1e3:.3f} ms/dispatch) on {smi}")
    rows, sig = forward_inputs(L, T, c, 0.05, dev, seed=5)
    k1_ms, p1_ms, out, ref = timed_pair(
        lambda: rb.blocked_forward_batch(rows, sig, THETA, L=L, q=L // 2),
        lambda: rb.blocked_forward_batch_ref(rows, sig, THETA, L=L, q=L // 2),
        3)
    err = {"forward": held("K1 L=20 T=50 vacuum 1x32 (timed inputs)", out, ref)}
    phase(f"[timing] K1 forward batch L=20 T=50 traj=32: kernel {k1_ms:.3f} "
          f"ms = {T * c / (k1_ms / 1e3):.1f} cycles/s, plain {p1_ms:.3f} ms "
          f"= {T * c / (p1_ms / 1e3):.1f} cycles/s on {smi}")
    # the main path's first echo call: 2 instances x 32 trajectories x t=0..7
    tiles, sfin = echo_inputs(L, T, c, 0.05, list(range(8)), dev, seed=6,
                              inst=2)
    k2_ms, p2_ms, out, ref = timed_pair(
        lambda: rb.blocked_echo_batch(tiles, sfin, THETA, L=L, q=L // 2),
        lambda: rb.blocked_echo_batch_ref(tiles, sfin, THETA, L=L, q=L // 2),
        1)
    err["echo"] = held("K2 L=20 T=50 ts=0..7 p=0.05 2x32 (timed inputs)",
                       out, ref)
    steps = 2 * c * sum(2 * t for t in range(8))  # inst x traj x 2t
    phase(f"[timing] K2 echo batch L=20 ts=0..7 pairs=512 steps={steps}: "
          f"kernel {k2_ms:.3f} ms = {steps / (k2_ms / 1e3):.1f} steps/s, plain "
          f"{p2_ms:.3f} ms = {steps / (p2_ms / 1e3):.1f} steps/s on {smi}")
    return {"forward": (k1_ms, p1_ms), "echo": (k2_ms, p2_ms)}, err


def main() -> None:
    if not os.path.isfile(os.path.join(HERE, "dtc_tpu_torch", "csrc",
                                       "floquet_x.cu")):
        sys.exit("chip_smoke: run it from the root of a checkout of the"
                 " repository (dtc_tpu_torch/ not found beside it)")
    smi = card()
    dev = torch.device("cuda")
    build()
    err = compare(dev)
    launches = main_path(smi)
    times, timed_err = timing(dev, smi)
    err = {k: max(err[k], timed_err[k]) for k in err}
    src = "dtc_tpu_torch/csrc/floquet_x.cu"
    replaced = {"forward": ("K1", "dtc_tpu/ops/pallas_resident_blocked.py:131"),
                "echo": ("K2", "dtc_tpu/ops/pallas_resident_blocked.py:374")}
    kernels = [{"name": f"{kid} floquet_x_{name}", "route": "cuda",
                "source": src, "replaces": where,
                "launches": launches[name], "max_abs_err": err[name],
                "ms": times[name][0], "plain_ms": times[name][1]}
               for name, (kid, where) in replaced.items()]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
