"""The counted work, the frozen roofline and the trace arithmetic."""

from __future__ import annotations

import json

import pytest

from port_bench import roofline, trace
from port_bench.record import Record
from port_bench.spec import ROOT, Spec, driver


def _study(cell):
    spec = Spec(ROOT)
    c = spec.cell(cell)
    return driver(spec.traffic(c)).prepare(spec.config(c), spec.traffic(c),
                                           1, "cpu")


def test_cycles_counted_per_call():
    # forward: T a trajectory; autocorr: T + sum_{t<T} 2t a trajectory;
    # energy: T a trajectory and level, one trajectory at p = 0
    forward = {"driver": "forward", "inst": 1, "n_trajectories": 32}
    spec = Spec(ROOT)
    cfg = spec.config(spec.cell("l20_x.autocorr"))
    assert driver(forward).prepare(cfg, forward, 1, "cpu").cycles_per_call \
        == 32 * 50
    T = 50
    assert _study("l20_x.autocorr").cycles_per_call == 256 * (
        T + sum(2 * t for t in range(T))) == 640_000
    assert _study("l20_xy.autocorr").cycles_per_call == 640_000
    assert _study("l20_x.energy").cycles_per_call == 3 * 256 * 50 + 50


def test_bound_matches_the_k2_row():
    # PERF.md section 6, K2: 512 pairs (2 x 32 x t=0..7) at L=20, 7.067 ms,
    # bounded by its operations
    steps = 2 * 32 * sum(2 * t for t in range(8))
    ms, by = roofline.bound(4 * 512, steps << 20,
                            roofline.cycle_flops(20, [(0.97 * 3.14, 0.0)]))
    assert by == "operations"
    assert ms == pytest.approx(7.067, abs=5e-4)


def test_cycle_flops_by_drive():
    assert roofline.cycle_flops(20, [(1.0, 0.0)]) == 126
    assert roofline.cycle_flops(20, [(1.0, 0.0), (0.0, 1.0)]) == 246
    assert roofline.cycle_flops(20, [(1.0, 0.5)]) == 286
    assert roofline.measure_flops(20) == 5 + 20 + 40


def test_busy_union_and_gaps():
    spans = [(0, 10), (5, 15), (20, 25), (22, 23), (40, 50)]
    assert trace.busy(spans) == 10 + 5 + 5 + 10
    assert trace.idle_gaps(spans, 0, 60) == [(15, 20), (25, 40), (50, 60)]
    assert trace.idle_gaps(spans, -5, 45) == [(-5, 0), (15, 20), (25, 40)]


def test_idle_gaps_labelled_by_the_innermost_host_op():
    host = [("call", 0, 100), ("aten::copy_", 10, 30),
            ("cudaStreamSynchronize", 12, 28), ("aten::sum", 50, 60)]
    gaps = [(14, 20), (40, 44), (52, 58), (200, 210)]
    got = trace.host_labels(gaps, host)
    assert got == pytest.approx({"cudaStreamSynchronize": 6e-9,
                                 "call": 4e-9, "aten::sum": 6e-9,
                                 "(no host op)": 10e-9})


def test_short_name():
    assert trace.short_name("void ns::echo_lo_kernel<true, 128>(float*)") \
        == "ns::echo_lo_kernel<true>"
    assert trace.short_name("void (anonymous namespace)::k<4>(int)") == "k"
    assert trace.short_name("Memcpy DtoH (Device -> Pinned)") == "Memcpy DtoH"


def _record(n_calls=4, call_s=0.5, gap_s=0.1):
    calls, t = [], 10.0
    for _ in range(n_calls):
        calls.append((t, t + call_s))
        t += call_s + gap_s
    return Record(setup_s=3.0, cycles_per_call=1000,
                  work={"io_bytes": 0, "amp_steps": 1 << 30,
                        "flops_per_amp_step": 67}, calls=calls,
                  phases=[{"forward": 0.1, "echo": 0.3}] * n_calls)


def test_metric_readers_on_a_record():
    spec = Spec(ROOT)
    rec = _record()
    got = {m["name"]: spec.reader(m).read(rec)
           for m in spec.bench["end_to_end"] + spec.bench["per_layer"]}
    rate = 4000 / (4 * 0.5 + 3 * 0.1)
    assert got["cycles_per_s"] == pytest.approx(rate)
    assert got["setup_s"] == 3.0
    assert got["phase_ms.forward"] == pytest.approx(100)
    assert got["phase_ms.echo"] == pytest.approx(300)
    device = ("launches_per_kcycle", "kernels_roofline", "device_idle_pct")
    # no trace: the device metrics find nothing to read
    for name in device:
        assert got[name] is None
    rec.trace = trace.Trace(0, 2e9, device=[
        ("k", 0, 1e9, "kernel"), ("k", 1.2e9, 1.5e9, "kernel"),
        ("Memcpy DtoH", 1.5e9, 1.6e9, "gpu_memcpy")], launches=2)
    got = {m["name"]: spec.reader(m).read(rec)
           for m in spec.bench["per_layer"]}
    assert got["launches_per_kcycle"] == pytest.approx(2 / 4)
    assert got["device_idle_pct"] == pytest.approx(100 * (1 - 1.4 / 2))
    # 4 calls x 2^30 amp-steps x 67 ops at 67 TFLOP/s over 1.3 s of kernels
    assert got["kernels_roofline"] == pytest.approx(
        100 * 4 * (1 << 30) / 1e12 / 1.3)


def test_each_cell_reports_what_its_metrics_move():
    spec = Spec(ROOT)
    for cell in spec.bench["workloads"]:
        e2e = {m["name"] for m in spec.metrics(cell, False)}
        layer = spec.metrics(cell, True)
        assert "setup_s" in e2e and len(e2e) >= 2 and layer, cell["name"]
        assert all(m["moves"] in e2e for m in layer), cell["name"]


def test_every_metric_has_a_reader():
    spec = Spec(ROOT)
    for m in spec.bench["end_to_end"] + spec.bench["per_layer"]:
        assert hasattr(spec.reader(m), "read"), m["name"]


def test_benchmark_json_keeps_to_its_names_and_limits():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    import re

    name = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
    unit = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
    metrics = bench["end_to_end"] + bench["per_layer"]
    for m in metrics:
        assert name.match(m["name"]) and unit.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for w in bench["workloads"]:
        assert name.match(w["name"]) and len(w["why"]) <= 200
        assert w["chips"] == 1
        assert (ROOT / f"port_bench/limits/{w['name']}.json").exists()
    for c in bench["configs"]:
        assert len(c["source"]) <= 200 and c["file"].startswith("port_bench/")
    layers = {m["layer"] for m in bench["per_layer"]}
    assert all(len(x) <= 200 for x in layers)
    assert {m["moves"] for m in bench["per_layer"]} == {"cycles_per_s"}
    assert any(m["name"] == "setup_s" and m["bound"] <= 0.25
               for m in bench["end_to_end"])
