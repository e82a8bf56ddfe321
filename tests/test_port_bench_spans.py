"""The benchmark's readers of the program's spans
(``port_bench/program_spans.py``, ``port_bench/metrics/idle_ms.*.py`` and
``launches_per_kcycle.feed.py``) on a trace built by hand: known device
intervals, nested ``dtc.`` spans, torch ops and launches on the host.

Window [0, 1000] ns, two calls, device busy [100, 200], [300, 350],
[400, 600], [700, 950]; the idle gaps and the innermost ``dtc.`` span at
each middle:

    [0, 100]    mid 50   dtc.driver.autocorr        driver 100
    [200, 300]  mid 250  dtc.feed.echo_pair_tiles   feed 100 (a torch op
                                                    there is skipped)
    [350, 400]  mid 375  dtc.entry.K2               entry 50
    [600, 700]  mid 650  dtc.sweep.forward_batch    sweep 100 (a launch
                                                    there is skipped)
    [950, 1000] mid 975  none: past the study's span, inside the call

Launches: two inside the echo rows' feeder, one inside a fold feeder
nested in K2's entry (the innermost span decides: feed), one in K2's entry
and one in the forward batch: 3 a 1000 cycles.
"""

import pytest

from port_bench import program_spans
from port_bench.record import Record
from port_bench.spec import Spec
from port_bench.trace import CALL, Trace

NAMES = ["idle_ms.driver", "idle_ms.sweep", "idle_ms.feed", "idle_ms.entry",
         "launches_per_kcycle.feed"]

DEVICE = [("k", 100, 200, "kernel"), ("k", 300, 350, "kernel"),
          ("k", 400, 600, "kernel"), ("Memcpy DtoH", 700, 950,
                                       "gpu_memcpy")]
HOST = [
    (CALL, 0, 500),
    ("dtc.driver.autocorr", 10, 490),
    ("dtc.sweep.echo_batch", 150, 480),
    ("dtc.feed.echo_pair_tiles", 220, 290),
    ("cudaLaunchKernel", 230, 232),
    ("aten::mul", 240, 260),
    ("cudaLaunchKernel", 250, 252),
    ("dtc.entry.K2", 290, 470),
    ("cudaLaunchKernel", 300, 302),
    ("dtc.feed.fold", 310, 330),
    ("cudaLaunchKernel", 320, 322),
    (CALL, 500, 1000),
    ("dtc.driver.autocorr", 520, 960),
    ("dtc.sweep.forward_batch", 600, 955),
    ("cudaLaunchKernel", 640, 660),
    ("dtc.entry.K1", 660, 940),
]
WANT = {"idle_ms.driver": 100, "idle_ms.sweep": 100, "idle_ms.feed": 100,
        "idle_ms.entry": 50}


def _record(host=HOST):
    rec = Record(1.0, 500, {}, calls=[(0.0, 0.5), (0.5, 1.0)])
    rec.trace = Trace(0, 1000, device=list(DEVICE), host=list(host))
    return rec


@pytest.fixture(scope="module")
def readers():
    spec = Spec()
    entries = {m["name"]: m for m in spec.bench["per_layer"]}
    return {n: spec.reader(entries[n]) for n in NAMES}


def test_idle_is_charged_to_the_innermost_span_layer(readers):
    rec = _record()
    for name, ns in WANT.items():
        # ms a call: ns / 1e6, over two calls
        assert readers[name].read(rec) == pytest.approx(ns / 1e6 / 2)


def test_gaps_outside_every_span_are_charged_to_no_layer():
    per = program_spans.idle_by_layer(_record().trace)
    assert per == pytest.approx({k.split(".")[1]: v / 1e9
                                 for k, v in WANT.items()})
    total = sum(e - s for s, e in program_spans.idle_gaps(
        [(s, e) for _, s, e, _ in DEVICE], 0, 1000)) / 1e9
    assert total - sum(per.values()) == pytest.approx(50 / 1e9)


def test_feeder_launches_per_kcycle(readers):
    # 2 calls of 500 cycles: 3 launches a 1000 cycles
    assert readers["launches_per_kcycle.feed"].read(_record()) == 3.0


def test_a_trace_without_program_spans_reads_none(readers):
    rec = _record([h for h in HOST if not h[0].startswith("dtc.")])
    assert all(readers[n].read(rec) is None for n in NAMES)
    rec.trace = None
    assert all(readers[n].read(rec) is None for n in NAMES)


def test_entries_are_program_spans_of_every_cell():
    spec = Spec()
    cells = [w["name"] for w in spec.bench["workloads"]]
    entries = {m["name"]: m for m in spec.bench["per_layer"]}
    for n in NAMES:
        m = entries[n]
        assert m["source"] == "program_span" and m["moves"] == "cycles_per_s"
        assert m["workloads"] == cells
