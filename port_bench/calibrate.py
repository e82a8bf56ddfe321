"""Readings that a cell's correctness limits are set from; not run by the
benchmark's own runs.

For each seed: the program's widest gaps against the float32 reference on
the inputs of as many calls as a run checks (the lower readings), and, on
the control seeds, the reference computed in bfloat16 against the float32
one on the same inputs (the control's, upper readings). One JSON line per
seed and kind, then the largest program reading and the smallest control
reading of each number.

    python3 -m port_bench.calibrate --workload <cell> --seeds 1 2 ... \
        --control-seeds 1 2 3
"""

from __future__ import annotations

import argparse
import json
import sys


def readings(spec, name: str, seeds, control_seeds, device="cuda"):
    """(program readings, control readings): lists of {gap: value}."""
    import torch

    from port_bench.run import _sample
    from port_bench.spec import driver
    from port_bench.study import gaps

    cell = spec.cell(name)
    cfg, traffic = spec.config(cell), spec.traffic(cell)
    drv = driver(traffic)
    prog, ctrl = [], []
    for seed in sorted(set(seeds) | set(control_seeds)):
        study = drv.prepare(cfg, traffic, seed, device)
        calls = _sample(seed, traffic["checked_calls"],
                        traffic["checked_calls"])
        worst_p, worst_c = {}, {}
        answers = {i: study.call(study.inputs(i)) for i in calls
                   if seed in seeds}
        for i in calls:
            inp = study.inputs(i)
            ref = study.reference(inp, torch.float32)
            if seed in seeds:
                for k, v in gaps(answers[i], ref).items():
                    worst_p[k] = max(worst_p.get(k, 0.0), v)
            if seed in control_seeds:
                low = study.reference(inp, torch.bfloat16)
                for k, v in gaps(low, ref).items():
                    worst_c[k] = max(worst_c.get(k, 0.0), v)
        for kind, worst, out in (("program", worst_p, prog),
                                 ("control", worst_c, ctrl)):
            if worst:
                out.append(worst)
                print(json.dumps({"cell": name, "seed": seed, "kind": kind,
                                  **worst}), flush=True)
    return prog, ctrl


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)

    from port_bench.spec import Spec

    prog, ctrl = readings(Spec(), args.workload, args.seeds,
                          args.control_seeds)
    keys = sorted(prog[0])
    print(json.dumps({"cell": args.workload,
                      "lower": {k: max(r[k] for r in prog) for k in keys},
                      "control_min": {k: min(r[k] for r in ctrl)
                                      for k in keys}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
