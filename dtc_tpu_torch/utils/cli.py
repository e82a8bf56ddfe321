"""CLI of the port: ``python -m dtc_tpu_torch {autocorr,polarization,shots,
xy-cycle,energy,ham-comparison,per-qubit-z,adaptive,adaptive-batch,bench}``.

Port of those subcommands of ``dtc_tpu/utils/cli.py``, with its flag
vocabulary (``add_common_flags``, ``add_adaptive_flags`` and
``config_from_args`` are copies), plus ``--device`` (default cuda; a CUDA
request on a machine without CUDA raises, it does not run on the CPU).
``autocorr --sharded`` / ``--n_amp`` and ``energy --sharded`` / ``--n_amp``
run the amplitude-sharded sweeps (``experiments/sharded_run.py``) on a
mesh of the visible cards, or of ``--num_devices`` logical devices (before
the subcommand) laid round-robin over them: the counterpart of the
reference's virtual host devices, so that ``--num_devices 4 autocorr
--sharded --n_amp 4`` runs four shards on one card. ``autocorr --method
exact`` runs the density-matrix superoperator (``core/density.py``).
"""

from __future__ import annotations

import argparse
import logging

from dtc_tpu_torch.utils.config import SimConfig


def add_common_flags(p: argparse.ArgumentParser):
    p.add_argument("--L", type=int, default=4, help="Number of qubits")
    p.add_argument("--inst", type=int, default=1, help="Number of disorder instances")
    p.add_argument("--randomphi", type=int, default=1, help="Prethermal=0 or DTC=1")
    p.add_argument("--phi_delta", type=float, default=0.0)
    p.add_argument("--phi_amplitude", type=float, default=1.0)
    p.add_argument("--tf", type=int, default=50, help="End time (cycles)")
    p.add_argument("--g", type=float, default=0.97)
    p.add_argument("--noise_prob", type=float, default=0.05)
    p.add_argument("--use_noise", type=int, default=1)
    p.add_argument("--initial_state", type=str, default="vacuum",
                   choices=["vacuum", "neel"])
    p.add_argument("--use_fakebackend", type=int, default=0,
                   help="1 = device-noise model mode")
    p.add_argument("--fake_device", type=str, default="brisbane",
                   choices=["brisbane", "garnet"],
                   help="which QPU calibration use_fakebackend=1 mimics")
    p.add_argument("--calibration_path", type=str, default=None,
                   help="real calibration snapshot JSON overriding the "
                        "synthetic calibration")
    p.add_argument("--polarization", type=str, default="x")
    p.add_argument("--circular_frequency", type=float, default=0.5)
    p.add_argument("--n_trajectories", type=int, default=256)
    p.add_argument("--shots", type=int, default=0,
                   help="0 = analytic; >0 = Bernoulli-sampled measurement")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--dtype", type=str, default="complex64",
                   choices=["complex64", "complex128"])
    p.add_argument("--out_dir", type=str, default=None)
    p.add_argument("--disorder_dir", type=str, default=".",
                   help="Folder with hs_L{L}.csv / phis_L{L}.csv (generated if absent)")


def add_adaptive_flags(p: argparse.ArgumentParser):
    p.add_argument("--target_echo", type=float, default=1.0)
    p.add_argument("--feedback_gain", type=float, default=0.01)
    p.add_argument("--exponential_feedback", type=int, default=1)
    p.add_argument("--decay_compensation", type=float, default=0.1)
    p.add_argument("--g_min", type=float, default=0.84)
    p.add_argument("--g_max", type=float, default=1.0)
    p.add_argument("--use_optimization", type=int, default=1)
    p.add_argument("--optimization_iterations", type=int, default=5)
    p.add_argument("--optimizer_method", type=str, default="golden",
                   choices=["golden", "bounded", "grid"])


def config_from_args(args) -> SimConfig:
    fields = set(SimConfig.__dataclass_fields__)
    kw = {k: v for k, v in vars(args).items() if k in fields and v is not None}
    return SimConfig(**kw)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m dtc_tpu_torch",
        description="PyTorch/CUDA kicked-Ising DTC simulation")
    ap.add_argument("--num_devices", type=int, default=None,
                    help="logical devices of the sharded mesh, laid "
                         "round-robin over the cards of --device")
    sub = ap.add_subparsers(dest="command", required=True)
    for name, hlp in [
        ("autocorr", "forward+echo interferometric autocorrelator sweep"),
        ("polarization", "x/y/xy/yx comparison with envelopes"),
        ("shots", "echo vs shot-count convergence study"),
        ("xy-cycle", "XY-alternating vs pure-X comparison"),
        ("energy", "energy sweep over noise probabilities"),
        ("ham-comparison", "component-Hamiltonian energy comparison"),
        ("per-qubit-z", "per-qubit <Z_i(t)> sweep"),
        ("adaptive", "real-time adaptive-g control loop"),
        ("adaptive-batch", "batch (non-causal) adaptive-g control"),
    ]:
        p = sub.add_parser(name, help=hlp)
        add_common_flags(p)
        p.add_argument("--device", type=str, default="cuda")
        if name.startswith("adaptive"):
            add_adaptive_flags(p)
            p.add_argument("--realtime_csv", action="store_true",
                           help="append+flush per completed timestep")
    p = sub.choices["autocorr"]
    p.add_argument("--with_envelopes", action="store_true")
    p.add_argument("--method", type=str, default="trajectories",
                   choices=["trajectories", "exact"],
                   help="exact = density-matrix superoperator (L<=13)")
    p.add_argument("--emit_gate_counts", action="store_true",
                   help="transpiled gate-count CSVs (not ported)")
    p.add_argument("--sharded", action="store_true",
                   help="amplitude-shard over all devices")
    p.add_argument("--n_amp", type=int, default=None)
    sub.choices["polarization"].add_argument(
        "--polarizations", type=str, default="x,y,xy,yx")
    sub.choices["shots"].add_argument(
        "--shots_list", type=str, default="100,1000,10000,100000,1000000")
    for name in ("energy", "ham-comparison"):
        # BackendEstimatorV2 precision=1/sqrt(shots) emulation
        sub.choices[name].add_argument(
            "--estimator_shots", type=int, default=None,
            help="gaussian estimator sampling noise with sigma ="
                 " 1/sqrt(shots); 0 = exact")
    p = sub.choices["energy"]
    p.add_argument("--nprobs", type=str, default="0,0.001,0.01,0.1")
    p.add_argument("--checkpoint", type=str, default=None,
                   help="journal path for crash-safe resume")
    p.add_argument("--sharded", action="store_true",
                   help="amplitude-shard over all devices")
    p.add_argument("--n_amp", type=int, default=None)
    p = sub.add_parser("bench", help="headline benchmark on the GPU")
    p.add_argument("--device", type=str, default="cuda")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(name)s: %(message)s")
    from dtc_tpu_torch.ops.precision import set_fp32_policy

    set_fp32_policy()
    if args.command == "bench":
        from dtc_tpu_torch import bench

        bench.main(device=args.device)
        return 0
    from dtc_tpu_torch.experiments import adaptive, autocorr, energy

    cfg = config_from_args(args)
    kw = dict(device=args.device, out_dir=args.out_dir,
              disorder_dir=args.disorder_dir)
    sharded = getattr(args, "sharded", False) or getattr(args, "n_amp", None)
    if sharded:
        from dtc_tpu_torch.experiments import sharded_run
        from dtc_tpu_torch.parallel.mesh import logical_devices

        devices = (logical_devices(args.num_devices, args.device)
                   if args.num_devices else None)
    if args.command == "autocorr":
        autocorr.refuse_gate_counts(args.emit_gate_counts)
        if sharded:
            r = sharded_run.run_autocorr_sharded(cfg, n_amp=args.n_amp,
                                                 devices=devices, **kw)
            print(f"mesh={r['mesh_shape']}")
        else:
            r = autocorr.run_autocorr(cfg,
                                      with_envelopes=args.with_envelopes,
                                      method=args.method, **kw)
    elif args.command == "polarization":
        r = autocorr.run_polarization_comparison(
            cfg, polarizations=tuple(args.polarizations.split(",")), **kw)
    elif args.command == "shots":
        r = autocorr.run_shots_study(
            cfg, shots_list=[int(s) for s in args.shots_list.split(",")],
            **kw)
    elif args.command == "energy":
        nprobs = [float(s) for s in args.nprobs.split(",")]
        if sharded:
            r = sharded_run.run_energy_sharded(cfg, n_amp=args.n_amp,
                                               devices=devices,
                                               nprobs=nprobs, **kw)
            print(f"mesh={r['mesh_shape']}")
        else:
            r = energy.run_energy(cfg, nprobs=nprobs,
                                  checkpoint_path=args.checkpoint, **kw)
    elif args.command == "ham-comparison":
        r = energy.run_ham_comparison(cfg, **kw)
    elif args.command == "per-qubit-z":
        r = energy.run_per_qubit_z(cfg, **kw)
    elif args.command == "adaptive":
        r = adaptive.run_adaptive_realtime(
            cfg, optimizer_method=args.optimizer_method,
            realtime_csv=args.realtime_csv, **kw)
    elif args.command == "adaptive-batch":
        r = adaptive.run_adaptive_batch(cfg, **kw)
    else:
        r = autocorr.run_xy_cycle_comparison(cfg, **kw)
    print(f"wrote {r['csv_path']}")
    return 0
