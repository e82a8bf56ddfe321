"""The port's tracing (``dtc_tpu_torch/utils/profiling.py``): spans on the
profiler's clock, nested driver > sweep > entry, never user annotations, and
one launch registry that counts each entry's span.

With no profiler running a span constructs nothing: ``_RecordFunctionFast``
patched to raise is never reached, and ``phase_timer`` logs its line as
before. Under ``torch.profiler`` (CPU activity) the autocorrelator study at
L=17 (the plain blocked route: K1's and K2's plain versions, T=4, two
trajectories at p>0) and the energy study at L=14 (K5's plain version) leave
every ``dtc.entry.*`` span inside a ``dtc.sweep.*`` span inside a
``dtc.driver.*`` span, each feeder span inside its driver, no ``dtc.`` event
marked a user annotation (those the profiler mirrors onto the device's
timeline), and as many entry spans of each name as the registry's
``CALLS``.
"""

import logging

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from dtc_tpu_torch.experiments.autocorr import run_autocorr
from dtc_tpu_torch.experiments.energy import run_energy
from dtc_tpu_torch.ops import resident_blocked as rb
from dtc_tpu_torch.utils import profiling
from dtc_tpu_torch.utils.config import SimConfig

torch.set_num_threads(2)


def _raise(name):
    raise AssertionError(f"span {name!r} built a record with no profiler")


def test_span_with_the_profiler_off_builds_nothing(monkeypatch, caplog):
    monkeypatch.setattr(profiling, "_RecordFunctionFast", _raise)

    @profiling.span("dtc.feed.test")
    def twice(x):
        return 2 * x

    with profiling.span("dtc.sweep.test"):
        assert twice(3) == 6
    sink = {}
    with caplog.at_level(logging.INFO, logger="dtc_tpu_torch"):
        with profiling.phase_timer("forward", sink):
            pass
    (rec,) = caplog.records
    assert rec.msg == "phase %-12s %8.3fs"
    assert rec.args == ("forward", sink["forward"])
    assert list(sink) == ["forward"]


def test_span_names_its_layer_in_the_trace():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("dtc.sweep.test"):
            with profiling.phase_timer("inner"):
                torch.ones(4).sum()
    names = [e.name() for e in prof.profiler.kineto_results.events()]
    assert "dtc.sweep.test" in names and "dtc.driver.inner" in names


STUDIES = {
    "autocorr": (lambda: run_autocorr(
        SimConfig(L=17, tf=4, inst=1, n_trajectories=2, noise_prob=0.05),
        device="cpu", write=False), {"dtc.entry.K1", "dtc.entry.K2"}),
    "energy": (lambda: run_energy(
        SimConfig(L=14, tf=3, inst=1, n_trajectories=2, noise_prob=0.05),
        nprobs=(0.0, 0.01), device="cpu", write=False), {"dtc.entry.K5"}),
}


def _inside(span, outer) -> bool:
    return any(o[1] <= span[1] and span[2] <= o[2] for o in outer)


@pytest.mark.parametrize("study", list(STUDIES))
def test_study_spans_nest_by_layer(study):
    run, entries = STUDIES[study]
    profiling.reset_counters()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run()
    own = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
           for e in prof.profiler.kineto_results.events()
           if e.name().startswith("dtc.")]
    by = {layer: [s for s in own if s[0].split(".")[1] == layer]
          for layer in ("driver", "sweep", "feed", "entry")}
    assert sum(map(len, by.values())) == len(own)
    assert all(by.values()), {k: len(v) for k, v in by.items()}
    assert {s[0] for s in by["entry"]} == entries
    assert all(_inside(s, by["sweep"]) for s in by["entry"])
    assert all(_inside(s, by["driver"]) for s in by["sweep"] + by["feed"])
    # the registry counts each entry span, and no launch on the CPU
    assert {n: sum(s[0] == n for s in own) for n in entries} == {
        n: profiling.CALLS[n] for n in entries}
    assert not profiling.LAUNCHES and not profiling.PLAIN_ON_CUDA
    marked = [e for e in prof.events() if e.name.startswith("dtc.")]
    assert marked and not any(e.is_user_annotation for e in marked)


def test_registry_counts_the_route_taken():
    """An entry's plain route on the CPU is one span and one call; a kernel
    entry hands a CPU tensor to its plain version without a span of its
    own; ``reset_counters`` empties the one store."""
    rows = torch.zeros((1, 2, 128))
    sig = torch.zeros((1, 2), dtype=torch.int64)
    profiling.reset_counters()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        rb.blocked_forward_batch(rows, sig, 0.97 * torch.pi, L=17, q=3)
    names = [e.name() for e in prof.profiler.kineto_results.events()
             if e.name().startswith("dtc.entry.")]
    assert names == ["dtc.entry.K1"]
    assert profiling.CALLS == {"dtc.entry.K1": 1}
    assert not profiling.LAUNCHES and not profiling.PLAIN_ON_CUDA
    profiling.reset_counters()
    assert not profiling.CALLS
