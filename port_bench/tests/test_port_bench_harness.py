"""The harness's runs on the CPU at a small size, and a new cell taken up
from files and BENCHMARK.json entries alone."""

from __future__ import annotations

import hashlib
import json
import math

import pytest

from port_bench.run import run_cell
from port_bench.spec import Spec
from port_bench.tests.conftest import copy_bench, shrink

CELLS = ["l20_x.autocorr", "l20_xy.autocorr", "l20_x.energy"]


@pytest.mark.parametrize("traced", [False, True])
@pytest.mark.parametrize("cell", CELLS)
def test_a_run_prints_the_contract_line(small_root, cell, traced):
    spec = Spec(small_root)
    res = run_cell(spec, cell, 2**31 + 77, 0.2, traced, "cpu")
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"] and list(res)[-1] == "checks"
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] >= 1
    want = {m["name"] for m in spec.metrics(spec.cell(cell), traced)}
    if traced:  # no device on the CPU: the readers of the trace find no
        # kernel, and the roofline none to divide by
        assert set(res["metrics"]) == want - {"kernels_roofline"}
        assert "breakdown" in res and "busy_s" in res["device"]
    else:
        assert set(res["metrics"]) == want
        assert all(v["value"] > 0 for v in res["metrics"].values())
    for k, c in res["checks"].items():
        assert c["value"] <= c["limit"], k
    json.loads(json.dumps(res, allow_nan=False))


def _tree_digest(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((root / "port_bench").rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def test_a_new_cell_is_taken_up_from_added_files(tmp_path):
    root = shrink(copy_bench(tmp_path))
    before = _tree_digest(root)
    pb = root / "port_bench"
    cfg = json.loads((pb / "configs/l20_x.json").read_text())
    (pb / "configs/l16_y.json").write_text(json.dumps(
        {**cfg, "L": 16, "q": 8, "tf": 5, "polarization": "y"}))
    (pb / "traffic/two_forwards.json").write_text(json.dumps(
        {"driver": "forward", "why": "two instances a dispatch", "inst": 2,
         "n_trajectories": 3, "warm_tf": None, "checked_calls": 2}))
    (pb / "metrics/calls_per_s.py").write_text(
        "def read(record):\n    return len(record.calls) / "
        "record.window_s\n")
    (pb / "limits/l16_y.two_forwards.json").write_text(json.dumps(
        {"limits": {"forward_gap": 1e-4}}))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "l16_y", "source": "a test",
                             "file": "port_bench/configs/l16_y.json",
                             "reduced": ["L"], "why": "a y drive"})
    bench["workloads"].append({"name": "l16_y.two_forwards",
                               "config": "l16_y", "traffic": "two_forwards",
                               "chips": 1, "why": "a test"})
    bench["end_to_end"].append({"name": "calls_per_s", "unit": "1/s",
                                "better": "higher", "bound": 0.05,
                                "source": "host_clock",
                                "workloads": ["l16_y.two_forwards"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    res = run_cell(Spec(root), "l16_y.two_forwards", 5, 0.2, False, "cpu")
    assert res["correct"] is True
    assert {"setup_s", "calls_per_s"} <= set(res["metrics"])
    assert res["metrics"]["calls_per_s"]["unit"] == "1/s"
    after = _tree_digest(root)
    assert {k: after[k] for k in before} == before  # nothing edited


def test_a_missing_limit_is_not_correct(tmp_path):
    root = shrink(copy_bench(tmp_path))
    (root / "port_bench/limits/l20_x.energy.json").write_text(json.dumps(
        {"limits": {"energy_gap": 1e-2, "z_gap": 5e-3, "other_gap": 1.0}}))
    res = run_cell(Spec(root), "l20_x.energy", 5, 0.0, False, "cpu")
    assert res["correct"] is False
    assert res["checks"]["other_gap"]["value"] is None
    assert math.isfinite(res["checks"]["energy_gap"]["value"])
