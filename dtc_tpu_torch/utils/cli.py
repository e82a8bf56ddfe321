"""CLI of the port: ``python -m dtc_tpu_torch {autocorr,polarization,shots,
xy-cycle,energy,ham-comparison,per-qubit-z,adaptive,adaptive-batch,campaign,
disorder,params,draw,layout,qasm,bench}``.

Port of ``dtc_tpu/utils/cli.py``: every subcommand, with its flag
vocabulary (``add_common_flags``, ``add_adaptive_flags`` and
``config_from_args`` are copies) and printed lines, plus ``--device`` on
the commands that simulate (default cuda; a CUDA request on a machine
without CUDA raises, it does not run on the CPU). ``campaign --simulate``
runs the forward and echo sweeps on ``--device``; ``disorder``, ``params``,
``qasm`` and ``campaign`` without ``--simulate`` are host code, and
``draw`` and ``layout`` need matplotlib (an ImportError naming it
otherwise). The reference's ``--platform`` (a JAX platform switch) is left
out: ``--device`` takes its place.
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
import os

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
        ("campaign", "hardware campaign: QASM export -> ingest -> CSV, "
                     "resumable"),
    ]:
        p = sub.add_parser(name, help=hlp)
        add_common_flags(p)
        p.add_argument("--device", type=str, default="cuda")
        if name.startswith("adaptive"):
            add_adaptive_flags(p)
            p.add_argument("--realtime_csv", action="store_true",
                           help="append+flush per completed timestep")
    p = sub.choices["campaign"]
    p.add_argument("--job_dir", type=str, required=True,
                   help="folder for exported QASM jobs + manifests")
    p.add_argument("--results_dir", type=str, default=None,
                   help="folder the external runner drops raw job-record "
                        "JSONs into (default <job_dir>/results)")
    p.add_argument("--campaign_shots", type=int, default=1024)
    p.add_argument("--simulate", action="store_true",
                   help="execute the manifests on the port's engines (on "
                        "--device) instead of real hardware")
    p.add_argument("--measurement_key", type=str, default="c_1_0_0")
    p = sub.choices["autocorr"]
    p.add_argument("--with_envelopes", action="store_true")
    p.add_argument("--method", type=str, default="trajectories",
                   choices=["trajectories", "exact"],
                   help="exact = density-matrix superoperator (L<=13)")
    p.add_argument("--emit_gate_counts", action="store_true",
                   help="also write the per-t gate-count CSVs")
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

    p = sub.add_parser("disorder", help="generate disorder instance CSVs")
    p.add_argument("--L", type=int, default=None,
                   help="single L (default: batch L=4..130 like the reference)")
    p.add_argument("--L_max", type=int, default=130)
    p.add_argument("--inst", type=int, default=3)
    p.add_argument("--phi_amplitude", type=float, default=1.0)
    p.add_argument("--phi_delta", type=float, default=0.0)
    p.add_argument("--randomphi", type=int, default=1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out_dir", type=str, default="disorder_data")

    p = sub.add_parser("params", help="write the (g, amplitude, delta) sweep grid")
    p.add_argument("--out", type=str, default="params.csv")

    p = sub.add_parser("draw", help="render plots from experiment CSVs "
                                    "(needs matplotlib)")
    p.add_argument("csv", type=str, nargs="+",
                   help="input experiment CSV(s); multi-CSV kinds "
                        "(energy-all, fit-grid, xy-cycle, sub-echo) overlay them")
    p.add_argument("--kind", type=str, default="autocorr",
                   choices=["autocorr", "sincos-fit", "fft", "envelope",
                            "quicklook", "power-law", "energy-all",
                            "sub-echo", "fit-grid", "polarization-comparison",
                            "xy-cycle", "adaptive"])
    p.add_argument("--key", type=str, default="av_autocorr")
    p.add_argument("--out", type=str, default=None)
    p.add_argument("--per_qubit", action="store_true",
                   help="normalize energies by L")
    p.add_argument("--echo_csv", type=str, nargs="*", default=[],
                   help="echo CSVs for the sub-echo inset")
    p.add_argument("--period", type=int, default=5,
                   help="xy-cycle gridline period")
    p.add_argument("--row", type=str, default="phi_delta",
                   help="fit-grid row key (parsed from filenames)")
    p.add_argument("--col", type=str, default="phi_amplitude",
                   help="fit-grid column key (parsed from filenames)")
    p.add_argument("--fit_csv", type=str, default=None,
                   help="fit-grid: write fit-results CSV here")

    p = sub.add_parser("layout", help="design + render a QPU snake layout "
                                      "(needs matplotlib)")
    p.add_argument("--device", type=str, default="brisbane",
                   choices=["brisbane", "torino", "garnet", "linear"])
    p.add_argument("--L", type=int, default=27)
    p.add_argument("--out", type=str, default=None)

    p = sub.add_parser("qasm", help="export the circuit as OpenQASM 2.0")
    add_common_flags(p)
    p.add_argument("--t", type=int, default=None, help="cycles (default tf)")
    p.add_argument("--echo", action="store_true")
    p.add_argument("--out", type=str, default=None)

    p = sub.add_parser("bench", help="headline benchmark on the GPU")
    p.add_argument("--device", type=str, default="cuda")
    return ap


def run_disorder(args) -> int:
    from dtc_tpu_torch.io.disorder import (
        disorder_filenames,
        generate_disorder,
        save_disorder,
    )

    ls = [args.L] if args.L else range(4, args.L_max + 1)
    for L in ls:
        hs, phis = generate_disorder(
            L, args.inst, phi_amplitude=args.phi_amplitude,
            phi_delta=args.phi_delta, randomphi=args.randomphi,
            seed=args.seed + L)
        hp, pp = disorder_filenames(L, args.inst, args.phi_amplitude,
                                    args.phi_delta, args.randomphi,
                                    args.out_dir)
        save_disorder(hs, phis, hp, pp)
        print(f"wrote {hp}")
    return 0


def run_params(args) -> int:
    """The 11 x 8 x 9 (g, amplitude, delta) grid, one config a line."""
    from itertools import product

    deltas = [0.0, 0.1, 0.2, 0.3, 0.4, 0.5, 1.0, 1.5, 2.0]
    amps = [0.1, 0.2, 0.3, 0.4, 0.5, 1.0, 1.5, 2.0]
    gs = [0.5, 0.55, 0.6, 0.65, 0.7, 0.75, 0.8, 0.85, 0.9, 0.95, 1.0]
    with open(args.out, "w") as f:
        for g, amp, d in product(gs, amps, deltas):
            f.write(f"{g},{amp},{d}\n")
    print(f"wrote {args.out} ({len(gs)*len(amps)*len(deltas)} configs)")
    return 0


def _stem(path):
    return os.path.basename(path).rsplit(".", 1)[0]


def _series(path, keys=("av_autocorr_echo", "av_autocorr")):
    """(t, y) from a CSV: first matching key, else first numeric col."""
    from dtc_tpu_torch.io import csvio

    c = csvio.read_columns(path)
    for k in keys:
        if k in c:
            return c["time"], c[k]
    k = next((k for k in c if k != "time"), None)
    if k is None:
        raise ValueError(
            f"{path}: no data column besides 'time' "
            f"(columns: {sorted(c)})")
    return c["time"], c[k]


def run_draw(args) -> int:
    from dtc_tpu_torch.analysis import plots
    from dtc_tpu_torch.io import csvio
    from dtc_tpu_torch.io.naming import parse_config_from_name

    plots.pyplot()  # an ImportError naming matplotlib before any work
    csv0 = args.csv[0]
    out = args.out or (csv0.rsplit(".", 1)[0] + f"_{args.kind}.png")
    if args.kind == "quicklook":
        plots.plot_csv_quicklook(csv0, out)
    elif args.kind == "energy-all" or args.kind == "power-law":
        sources = {}
        meta_L = None
        for path in args.csv:
            c = csvio.read_columns(path)
            meta = parse_config_from_name(path)
            meta_L = meta.get("L", meta_L)
            ecols = [k for k in c if k.startswith("energy")] or \
                    [k for k in c if k not in ("time",)]
            for k in ecols:
                label = k if len(args.csv) == 1 else f"{_stem(path)}:{k}"
                sources[label] = (c["time"], c[k])
        r = plots.plot_energy_comparison(
            sources, out, per_qubit=args.per_qubit, L=meta_L,
            with_envelope_fit=(args.kind == "energy-all"),
            with_power_law=(args.kind == "power-law"))
        rep = r["min_energy"]
        for lab, row in rep.get("per_source", {}).items():
            print(f"{lab}: min energy = {row['min_energy']:.6f}, "
                  f"per qubit = {row['min_energy_per_qubit']:.6f} "
                  f"at t = {row['t_min']:.0f}")
        if rep.get("per_source"):
            print(f"OVERALL MINIMUM: {rep['overall_min']:.6f} "
                  f"({rep['overall_min_source']}); per qubit "
                  f"{rep['overall_min_per_qubit']:.6f} "
                  f"({rep['overall_min_per_qubit_source']})")
    elif args.kind == "sub-echo":
        energy_sources = {_stem(p): _series(p, ("energy", "energy_p_0.05"))
                          for p in args.csv}
        echo_sources = {_stem(p): _series(p) for p in args.echo_csv}
        meta_L = parse_config_from_name(csv0).get("L")
        plots.plot_energy_with_echo_inset(
            energy_sources, echo_sources, out,
            per_qubit=args.per_qubit, L=meta_L)
    elif args.kind == "fit-grid":
        records = []
        for path in args.csv:
            meta = parse_config_from_name(path)
            meta["row"] = meta.get(args.row, 0.0)
            meta["col"] = meta.get(args.col, 0.0)
            meta["file"] = _stem(path)
            records.append((meta, csvio.read_columns(path)))
        _, fit_rows = plots.plot_fit_grid(records, out,
                                          fit_csv=args.fit_csv,
                                          key=args.key)
        n_ok = sum(1 for r in fit_rows if r.get("fit_success"))
        print(f"fits: {n_ok}/{len(fit_rows)} converged")
    elif args.kind == "polarization-comparison":
        merged = csvio.read_columns(csv0)
        pols = [k[len("av_autocorr_"):] for k in merged
                if k.startswith("av_autocorr_")
                and not k.startswith("av_autocorr_echo_")]
        plots.plot_polarization_comparison(merged, out, pols)
    elif args.kind == "xy-cycle":
        curves = {_stem(p): _series(p, ("av_autocorr",)) for p in args.csv}
        plots.plot_xy_cycle_comparison(curves, out, period=args.period)
    else:
        cols = csvio.read_columns(csv0)
        if args.kind == "autocorr":
            plots.plot_autocorr(cols, out)
        elif args.kind == "sincos-fit":
            _, res = plots.plot_sincos_fit(cols, out, key=args.key)
            if res.success:
                print(f"fit: f={res.params['frequency']:.4f} "
                      f"gamma={res.params['gamma']:.4f} R2={res.r_squared:.4f}")
        elif args.kind == "fft":
            plots.plot_fft_subharmonics(cols, out, key=args.key)
        elif args.kind == "envelope":
            plots.plot_with_envelopes(cols, out, key=args.key)
        elif args.kind == "adaptive":
            plots.plot_adaptive_comparison(cols, out)
    print(f"wrote {out}")
    return 0


def run_layout(args) -> int:
    from dtc_tpu_torch.analysis.plots import pyplot
    from dtc_tpu_torch.device.layouts import render_layout, snake_layout

    pyplot()  # an ImportError naming matplotlib before the search
    lay = snake_layout(args.L, args.device)
    out = args.out or f"layout_{args.device}_L{args.L}.png"
    render_layout(lay, out, f"L={args.L} snake on {args.device}")
    print(f"path: {lay['path']}")
    print(f"ancilla: {lay['ancilla']}")
    print(f"wrote {out}")
    return 0


def run_qasm(args) -> int:
    from dtc_tpu_torch.device.qasm import circuit_to_qasm
    from dtc_tpu_torch.io.disorder import get_disorder
    from dtc_tpu_torch.models.drives import build_kick_schedule

    cfg = config_from_args(args)
    hs, phis = get_disorder(cfg, args.disorder_dir)
    t = args.t if args.t is not None else cfg.tf
    sched = build_kick_schedule(
        cfg.polarization, cfg.g, max(t, 1),
        circular_frequency=cfg.circular_frequency,
        xy_cycle_period=cfg.xy_cycle_period)
    text = circuit_to_qasm(cfg.L, hs[0], phis[0], t, sched, echo=args.echo,
                           initial_state=cfg.initial_state)
    out = args.out or (f"dtc_L{cfg.L}_t{t}"
                       f"{'_echo' if args.echo else ''}.qasm")
    with open(out, "w") as f:
        f.write(text)
    print(f"wrote {out}")
    return 0


def run_campaign(args, cfg) -> int:
    from dtc_tpu_torch.experiments.campaign import run_hardware_campaign

    r = run_hardware_campaign(
        cfg, job_dir=args.job_dir, device=args.device,
        results_dir=args.results_dir, out_dir=args.out_dir,
        shots=args.campaign_shots, simulate=args.simulate,
        measurement_key=args.measurement_key,
        disorder_dir=args.disorder_dir)
    c = r["completed"]
    print(f"export: {r['export']}")
    print(f"completed: forward {c['forward']}/{c['total_per_kind']}, "
          f"echo {c['echo']}/{c['total_per_kind']}")
    print(f"rows on disk: {r['rows_on_disk']}/{cfg.tf} -> {r['csv_path']}")
    return 0


HOST_COMMANDS = {"disorder": run_disorder, "params": run_params,
                 "draw": run_draw, "layout": run_layout, "qasm": run_qasm}


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(name)s: %(message)s")
    from dtc_tpu_torch.ops.precision import set_fp32_policy

    set_fp32_policy()
    if args.command in HOST_COMMANDS:
        return HOST_COMMANDS[args.command](args)
    if args.command == "bench":
        from dtc_tpu_torch import bench

        bench.main(device=args.device)
        return 0
    from dtc_tpu_torch.experiments import adaptive, autocorr, energy

    cfg = config_from_args(args)
    if args.command == "campaign":
        return run_campaign(args, cfg)
    kw = dict(device=args.device, out_dir=args.out_dir,
              disorder_dir=args.disorder_dir)
    sharded = getattr(args, "sharded", False) or getattr(args, "n_amp", None)
    if sharded:
        from dtc_tpu_torch.experiments import sharded_run
        from dtc_tpu_torch.parallel.mesh import logical_devices

        devices = (logical_devices(args.num_devices, args.device)
                   if args.num_devices else None)
    if args.command == "autocorr":
        if sharded:
            r = sharded_run.run_autocorr_sharded(cfg, n_amp=args.n_amp,
                                                 devices=devices, **kw)
            print(f"mesh={r['mesh_shape']}")
        else:
            r = autocorr.run_autocorr(cfg,
                                      with_envelopes=args.with_envelopes,
                                      method=args.method,
                                      emit_gate_counts=args.emit_gate_counts,
                                      **kw)
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
