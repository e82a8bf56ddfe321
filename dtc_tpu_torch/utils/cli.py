"""CLI of the port: ``python -m dtc_tpu_torch {autocorr,bench}``.

Port of the ``autocorr`` and ``bench`` subcommands of
``dtc_tpu/utils/cli.py``; the flag vocabulary is the reference's own
(``add_common_flags``), plus ``--device`` (default cuda; a CUDA request on
a machine without CUDA raises, it does not run on the CPU).
"""

from __future__ import annotations

import argparse
import logging

from dtc_tpu.utils.cli import add_common_flags, config_from_args


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m dtc_tpu_torch",
        description="PyTorch/CUDA kicked-Ising DTC simulation")
    sub = ap.add_subparsers(dest="command", required=True)
    p = sub.add_parser("autocorr",
                       help="forward+echo interferometric autocorrelator sweep")
    add_common_flags(p)
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--with_envelopes", action="store_true")
    p.add_argument("--method", type=str, default="trajectories",
                   choices=["trajectories", "exact"],
                   help="exact = density-matrix superoperator (not ported)")
    p.add_argument("--emit_gate_counts", action="store_true",
                   help="transpiled gate-count CSVs (not ported)")
    p.add_argument("--sharded", action="store_true",
                   help="amplitude-shard over all devices (not ported)")
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
    if args.sharded or args.n_amp:
        raise NotImplementedError(
            "--sharded / --n_amp (amplitude sharding) is not ported yet:"
            " ROADMAP.md queue 1, item 7")
    if args.emit_gate_counts:
        raise NotImplementedError(
            "--emit_gate_counts is not ported yet: ROADMAP.md queue 1, item 8")
    cfg = config_from_args(args)
    from dtc_tpu_torch.experiments.autocorr import run_autocorr

    r = run_autocorr(cfg, device=args.device, out_dir=args.out_dir,
                     disorder_dir=args.disorder_dir,
                     with_envelopes=args.with_envelopes, method=args.method)
    print(f"wrote {r['csv_path']}")
    return 0
