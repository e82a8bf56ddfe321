"""K5 of this checkout against K5 of another checkout, on one card, in turns.

Run from the repository root on a machine with an H100 and nvcc:

    python3 benchmarks/obs_walk_ab.py --other <checkout>

``<checkout>`` is another commit of this repository unpacked in a directory
(``git archive <commit> | tar -x -C <dir>``) whose
``dtc_tpu_torch/csrc/floquet_general.cu`` exports K5 without the walk
argument: ``floquet_general_observables(..., chunk, with_x, b0, stream)``
and ``floquet_general_observables_slots(L)``. The script

1. builds ``floquet_x.cu`` (K1/K2), ``floquet_general.cu`` (K4/K5) and
   ``floquet_x_streamed.cu`` (K6/K7) of both checkouts with the flags of
   ``ops/_build.py`` and prints each kernel's registers and spills, then
   every kernel whose use differs between the two (the kernels that
   measure with ``Obs`` are K5's; any other line is a change outside it);
2. times K5 x at L=20, T=50, p=0.1 on 256, 32 and 1 trajectories, the
   other checkout's library and this one's through
   ``ops/observables.py::launch`` with the tiles ``walk_tiles`` picks, in
   turns (other, this, this, other) three times, CUDA events, and prints
   the medians and the largest gap between the two outputs;
3. times this checkout's K5 x (T=50, p=0.1) with pass-lo blocks that walk
   each power of two of tiles up to 16, at L and trajectories either side
   of ``walk_tiles``'s thresholds, the walks in turns forward and back
   three times, and prints each median beside the walk it picks.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import re
import statistics
import subprocess
import sys
import tempfile

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

LIBS = ("floquet_x", "floquet_general", "floquet_x_streamed")


def build(csrc: str, out_dir: str) -> dict:
    """{library: (path, nvcc log)} of LIBS built from ``csrc`` at once."""
    from dtc_tpu_torch.ops import _build

    procs = {}
    for name in LIBS:
        so = os.path.join(out_dir, f"lib{name}.so")
        procs[name] = (so, subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", so,
             os.path.join(csrc, f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    out = {}
    for name, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {csrc}/{name}.cu:\n{log}")
        out[name] = (so, log)
    return out


def resources(log: str) -> dict:
    """{kernel: (registers, spill stores, spill loads)} of an nvcc -Xptxas
    -v log, the kernels' names without their anonymous namespace's (a hash
    of the source's path)."""
    found, cur = {}, None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            cur = re.sub(r"\d+_GLOBAL__N__[0-9a-f]+_\d+_\w+?_cu_[0-9a-f]+",
                         "_GLOBAL__N_", ln.split("'")[1])
            found[cur] = [0, 0, 0]
        elif cur and "spill stores" in ln:
            nums = [int(w) for w in ln.replace(",", " ").split()
                    if w.isdigit()]
            found[cur][1:] = nums[1:3]
        elif cur and "Used" in ln and "registers" in ln:
            found[cur][0] = int(ln.split("Used")[1].split()[0])
    return {k: tuple(v) for k, v in found.items()}


def other_k5(so: str):
    """K5 of the other checkout's library: f(rows, erow, L, T) ->
    (e_diag, x_sum, zs), the wrapper of ``ops/observables.py`` without the
    walk."""
    from dtc_tpu_torch.core.statevector import basis_index
    from dtc_tpu_torch.ops import observables as ob
    from dtc_tpu_torch.ops.echo_fold import forward_fold
    from dtc_tpu_torch.ops.resident_general import row_coeffs

    lib = ctypes.CDLL(so)
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.floquet_general_observables_slots.argtypes = [i32]
    lib.floquet_general_observables.argtypes = [vp] * 6 + [i32] * 7 + [
        i64, vp]

    def run(rows, erow, L, T):
        batch, S = rows.shape[:-2], rows.shape[-2]
        n = rows[..., 0, 0].numel()
        coef = erow.expand(*batch, 128).contiguous()
        fold = forward_fold(rows.view(n, S, 128), L, row_coeffs)
        slots = lib.floquet_general_observables_slots(L)
        chunk = ob.chunk_cycles(L, T, slots)
        dev = rows.device
        state = torch.empty((n, 1 << L), dtype=torch.complex64, device=dev)
        part = torch.empty((n, chunk, slots), device=dev)
        out = torch.empty((n, T, 2 + L), device=dev)
        err = lib.floquet_general_observables(
            state.data_ptr(), rows.data_ptr(), fold.data_ptr(),
            coef.data_ptr(), part.data_ptr(), out.data_ptr(), n, L, S,
            fold.shape[1], T, chunk, 1, basis_index(L, "vacuum"),
            torch.cuda.current_stream(dev).cuda_stream)
        assert err == 0, err
        out = out.reshape(*batch, T, 2 + L)
        return out[..., 0], out[..., 1], out[..., 2:]

    return run


def ms_of(fn, reps) -> float:
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", required=True)
    args = ap.parse_args()
    import chip_smoke as cs
    from dtc_tpu_torch.ops import observables as ob
    from dtc_tpu_torch.ops.precision import set_fp32_policy

    set_fp32_policy()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    tmp = tempfile.mkdtemp(dir=os.path.join(args.other))
    built = {
        "other": build(os.path.join(args.other, "dtc_tpu_torch", "csrc"),
                       tmp),
        "this": build(os.path.join(HERE, "dtc_tpu_torch", "csrc"),
                      tempfile.mkdtemp(dir=tmp))}
    for name in LIBS:
        res = {side: resources(built[side][name][1]) for side in built}
        for side in built:
            for k, (r, st, ld) in sorted(res[side].items()):
                print(f"[build] {side} {name}.cu {k}: {r} registers, spill "
                      f"stores {st} B, spill loads {ld} B")
        for k in sorted(set(res["other"]) | set(res["this"])):
            if res["other"].get(k) != res["this"].get(k):
                print(f"[build] differs {name}.cu {k}: other "
                      f"{res['other'].get(k)}, this {res['this'].get(k)}")
    other = other_k5(built["other"]["floquet_general"][0])
    dev = torch.device("cuda")
    L, T = 20, 50
    for c in (256, 32, 1):
        rows, erow, _, _ = cs.obs_inputs(L, "x", "full", T, c, 0.1, dev,
                                         seed=100 + c)
        tiles = ob.walk_tiles(L, c)
        runs = {
            "other": lambda: other(rows, erow, L, T),
            "this": lambda: ob.launch(rows, erow, L=L, T=T,
                                      initial_state="vacuum", with_x=True,
                                      tiles=tiles)}
        reps = 2 if c > 1 else 10
        ms = {"other": [], "this": []}
        for _ in range(3):
            for side in ("other", "this", "this", "other"):
                ms[side].append(ms_of(runs[side], reps))
        a, b = runs["other"](), runs["this"]()
        gap = max(float((x - y).abs().max()) for x, y in zip(a, b))
        mo, mt = statistics.median(ms["other"]), statistics.median(ms["this"])
        print(f"[ab] K5 x L=20 T=50 traj={c} p=0.1 walk {tiles}: other "
              f"{mo:.3f} ms, this {mt:.3f} ms ({mo / mt:.4f}x; other "
              f"{[round(v, 3) for v in ms['other']]}, this "
              f"{[round(v, 3) for v in ms['this']]}); largest gap of the "
              f"outputs {gap:.3e} on {smi}", flush=True)
        del rows, erow
    for L, c in ((20, 256), (20, 32), (20, 8), (20, 1), (23, 1), (23, 4),
                 (23, 16), (17, 256), (17, 16), (14, 256), (14, 32)):
        rows, erow, _, _ = cs.obs_inputs(L, "x", "full", T, c, 0.1, dev,
                                         seed=200 + c)
        walks = [n for n in (1, 2, 4, 8, 16) if n <= 1 << (L // 2)]
        ms = {n: [] for n in walks}
        for order in (walks, walks[::-1]) * 3:
            for n in order:
                ms[n].append(ms_of(lambda: ob.launch(
                    rows, erow, L=L, T=T, initial_state="vacuum",
                    with_x=True, tiles=n), 1 if c > 1 else 5))
        med = {n: statistics.median(v) for n, v in ms.items()}
        print(f"[sweep] K5 x L={L} T=50 traj={c} p=0.1: "
              + ", ".join(f"{n} tiles {v:.3f} ms" for n, v in med.items())
              + f"; walk_tiles picks {ob.walk_tiles(L, c)}, best "
              f"{min(med, key=med.get)} on {smi}", flush=True)
        del rows, erow


if __name__ == "__main__":
    main()
