"""The benchmark of ``dtc_tpu_torch`` on one NVIDIA GPU.

Run from the root of a checkout:

    python3 -m port_bench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

It finds the cell's configuration, traffic mix, driver and metrics by the
names in ``BENCHMARK.json`` (``port_bench/spec.py``), builds the study and
warms it up (set-up), then calls the cell's entry back to back as one
caller that waits for each answer, and closes the window at the end of the
first call that ends after ``--seconds``. With ``--trace 1`` the window
runs under ``torch.profiler`` and the per-layer metrics are read from the
trace. After the window, the program's state is dropped and the plain
reference (``port_bench/reference``) recomputes a sample of the window's
calls, drawn from the seed, on the same inputs; ``correct`` holds each
widest gap to its limit (``port_bench/limits/<cell>.json``).

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``checks`` (each number compared and its limit);
the last lines of standard error repeat the checks. Everything else goes to
standard error. A run that finds no CUDA card, or fewer than the cell asks
for, exits 2 and prints no result; one that finds JAX or the JAX package
loaded after the window exits 3.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import logging  # noqa: E402
import math  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "dtc_tpu")  # whole top-level names


def leaked(modules=None) -> list:
    """The forbidden top-level names among ``modules`` (sys.modules)."""
    names = {m.split(".")[0] for m in (sys.modules if modules is None
                                       else modules)}
    return sorted(names & set(FORBIDDEN))


def err(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


class PhaseLog(logging.Handler):
    """The program's ``phase <name> <seconds>s`` lines, one dict a call,
    and its ``engine=`` lines."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.calls: list = [{}]
        self.engines: set = set()

    def emit(self, rec):
        msg = str(rec.msg)
        if msg.startswith("phase") and len(rec.args or ()) == 2:
            name, dt = rec.args
            cur = self.calls[-1]
            cur[name] = cur.get(name, 0.0) + float(dt)
        elif "engine=" in msg:
            self.engines.add(rec.getMessage())


def _sample(seed: int, n: int, k: int) -> list:
    import numpy as np

    rng = np.random.default_rng(np.random.SeedSequence([seed % (1 << 64), 3]))
    return sorted(int(i) for i in rng.choice(n, size=min(k, n),
                                             replace=False))


def _smi() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,"
             "clocks.max.sm,temperature.gpu", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi: {e}"
    return out.stdout.strip()


def run_cell(spec, name: str, seed: int, seconds: float, traced: bool,
             device: str = "cuda", t0: float | None = None) -> dict:
    """One run of a cell; the result line's object."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from port_bench import trace as tracing
    from port_bench.record import Record
    from port_bench.spec import driver
    from port_bench.study import gaps

    t0 = time.perf_counter() if t0 is None else t0
    cuda = torch.device(device).type == "cuda"
    cell = spec.cell(name)
    cfg, traffic = spec.config(cell), spec.traffic(cell)
    limits = spec.limits(cell)
    log = PhaseLog()
    logger = logging.getLogger("dtc_tpu_torch")
    logger.setLevel(logging.INFO)
    logger.addHandler(log)

    def sync():
        if cuda:
            torch.cuda.synchronize()

    try:
        marks = [time.perf_counter()]
        study = driver(traffic).prepare(cfg, traffic, seed, device)
        marks.append(time.perf_counter())
        study.warm()
        sync()
        marks.append(time.perf_counter())
        record = Record(marks[-1] - t0, study.cycles_per_call, study.work)
        err(f"[setup] before the study {marks[0] - t0:.3f} s, study "
            f"{marks[1] - marks[0]:.3f} s, warm-up {marks[2] - marks[1]:.3f}"
            " s")
        log.calls = []
        answers, failed = [], 0
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                         else [])
        prof = profile(activities=acts) if traced else \
            contextlib.nullcontext()
        with prof:
            with record_function(tracing.WINDOW):
                while True:
                    with record_function(tracing.INPUTS):
                        inp = study.inputs(len(answers))
                    log.calls.append({})
                    start = time.perf_counter()
                    try:
                        with record_function(tracing.CALL):
                            ans = study.call(inp)
                    except (RuntimeError, ValueError) as exc:
                        failed += 1
                        ans = None
                        err(f"call {len(answers)} failed: {exc!r}")
                    end = time.perf_counter()
                    record.calls.append((start, end))
                    answers.append(ans)
                    if end - record.calls[0][0] >= seconds:
                        break
        record.phases = log.calls
    finally:
        logger.removeHandler(log)
    if traced:
        record.trace = tracing.read(prof)
        err(f"[trace] {len(record.trace.kernels())} kernels on the device,"
            f" {record.trace.launches} launched in the calls")
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    study.close()
    if cuda:
        torch.cuda.empty_cache()

    durs = [e - s for s, e in record.calls]
    half = len(durs) // 2
    rates = [n * record.cycles_per_call / (c[-1][1] - c[0][0])
             for n, c in ((half, record.calls[:half]),
                          (len(durs) - half, record.calls[half:])) if n]
    err(f"[run] {name} seed {seed}: set-up {record.setup_s:.3f} s, "
        f"{len(durs)} calls in {record.window_s:.3f} s, median call "
        f"{1e3 * float(np.median(durs)):.3f} ms, cycles/s by half "
        f"{rates}, peak {peak} B")
    for eng in sorted(log.engines):
        err(f"[run] {eng}")
    phase_names = sorted({k for p in record.phases for k in p})
    for k in phase_names:
        vals = [p[k] for p in record.phases if k in p]
        err(f"[run] phase {k}: mean {1e3 * sum(vals) / len(vals):.3f} ms "
            f"over {len(vals)} calls")

    t_ref = time.perf_counter()
    readings: dict = {}
    checked = [i for i in _sample(seed, len(answers),
                                  traffic["checked_calls"])
               if answers[i] is not None]
    for i in checked:
        ref = study.reference(study.inputs(i), torch.float32)
        for k, v in gaps(answers[i], ref).items():
            readings.setdefault(k, []).append(v)
    # the widest gap of each number; None where one was not finite
    worst = {k: max(v) if all(math.isfinite(x) for x in v) else None
             for k, v in readings.items()}
    err(f"[run] reference: calls {checked}, "
        f"{time.perf_counter() - t_ref:.3f} s")
    correct = (failed == 0 and bool(checked) and set(worst) == set(limits)
               and all(worst[k] is not None and worst[k] <= limits[k]
                       for k in limits))

    metrics = {}
    for m in spec.metrics(cell, traced):
        v = spec.reader(m).read(record)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(torch.device(device)) if cuda
           else "cpu", "count": cell["chips"], "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": len(answers),
              "failed": failed, "metrics": metrics, "device": dev}
    if traced:
        tr = record.trace
        dev["busy_s"], dev["window_s"] = tr.busy_s(), tr.window_s
        result["breakdown"] = {"device_ops": tr.device_ops(),
                               "idle_gaps": tr.idle_by_host()}
    result["checks"] = {k: {"value": worst.get(k), "limit": limits[k]}
                        for k in limits}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from port_bench.spec import Spec

    spec = Spec()
    cell = spec.cell(args.workload)
    import torch

    err(f"[setup] torch imported at {time.perf_counter() - T0:.3f} s")
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        err(f"{args.workload} needs {cell['chips']} CUDA card(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    result = run_cell(spec, args.workload, args.seed, args.seconds,
                      bool(args.trace), "cuda", T0)
    found = leaked()
    if found:
        err(f"modules of JAX or the JAX package loaded: {', '.join(found)}")
        return 3
    err(f"[run] {_smi()}")
    for k, c in result["checks"].items():
        err(f"check {k} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
