"""What a run loads: no JAX and nothing of the JAX package, compared by
whole top-level names (``dtc_tpu_torch`` begins with ``dtc_tpu``); the
reference loads nothing of the program."""

from __future__ import annotations

import json
import subprocess
import sys

from port_bench.run import leaked
from port_bench.spec import ROOT


def test_leaked_compares_whole_top_level_names():
    assert leaked(["dtc_tpu_torch", "dtc_tpu_torch.ops", "jaxtyping",
                   "numpy"]) == []
    assert leaked(["dtc_tpu.ops.kick", "jax.numpy", "jaxlib", "flax.nn",
                   "torch"]) == ["dtc_tpu", "flax", "jax", "jaxlib"]


def _modules_after(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=ROOT, capture_output=True, text=True, timeout=600, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax_nor_the_jax_package(small_root):
    mods = _modules_after(
        "from port_bench.spec import Spec\n"
        "from port_bench.run import run_cell\n"
        f"for c in ('l20_x.autocorr', 'l20_xy.autocorr', 'l20_x.energy'):\n"
        f"    run_cell(Spec({str(small_root)!r}), c, 1, 0.0, True, 'cpu')\n")
    assert "dtc_tpu_torch" in mods
    assert not mods & {"jax", "jaxlib", "flax", "dtc_tpu"}


def test_the_reference_loads_nothing_of_the_program():
    mods = _modules_after(
        "import numpy as np, torch\n"
        "from port_bench.reference import floquet\n"
        "ch = floquet.Chain(np.zeros((1, 6)), np.zeros((1, 5)), L=6,"
        " polarization='xy', g=0.97, T=4, real=torch.float32,"
        " device='cpu')\n"
        "u = torch.rand((1, 2, 8, 6))\n"
        "floquet.forward_autocorr(ch, u[:, :, :8], p=0.05, q=3, b0=0,"
        " af=1.0)\n"
        "floquet.echo_autocorr(ch, torch.rand((1, 2, 16, 6)), [3], p=0.05,"
        " q=3, b0=0, af=1.0)\n"
        "floquet.energy_trace(ch, u, p=0.05, b0=0)\n")
    assert not mods & {"dtc_tpu_torch", "dtc_tpu", "jax", "jaxlib", "flax"}
