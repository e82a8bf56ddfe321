"""On the card: a short run of each cell is correct and reports every
end-to-end and per-layer metric the cell lists.

    python -m pytest -q -m cuda port_bench/tests/test_port_bench_cuda.py
"""

from __future__ import annotations

import pytest

from port_bench.run import run_cell
from port_bench.spec import Spec

CELLS = ["l20_x.autocorr", "l20_xy.autocorr", "l20_x.energy"]


@pytest.mark.cuda
@pytest.mark.parametrize("traced", [False, True])
@pytest.mark.parametrize("cell", CELLS)
def test_a_short_run_on_the_card(cuda_card, cell, traced):
    spec = Spec()
    res = run_cell(spec, cell, 2**31 + 101, 1.0, traced, "cuda")
    assert res["correct"] is True, res["checks"]
    assert res["device"]["platform"] == "gpu"
    want = {m["name"] for m in spec.metrics(spec.cell(cell), traced)}
    assert set(res["metrics"]) == want
    if traced:
        assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
        roofline = [v["value"] for k, v in res["metrics"].items()
                    if k.endswith("_roofline")]
        assert roofline and all(0 < v <= 100 for v in roofline)
