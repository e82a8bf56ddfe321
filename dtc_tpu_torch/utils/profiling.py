"""The port's tracing: spans on the profiler's clock, the launch registry
and the phase timer.

``span(name)`` marks a host range in a ``torch.profiler`` trace. With no
profiler running it costs one check, ``torch.autograd._profiler_enabled()``;
with one running it is ``torch._C._profiler._RecordFunctionFast(name)``, a
host-only range on the clock that the trace's device events share. It is
not ``torch.profiler.record_function``: that makes a user annotation, which
the profiler mirrors onto the device's timeline, where a reader of device
time would count it as device work. Names are ``dtc.<layer>.<what>``, one
layer of the program each: ``driver`` (the studies, ``phase_timer``),
``sweep`` (one batch of a sweep's chunk loop, from its slicing to its
read-back), ``feed`` (the host's torch feeders: step rows, folds, energy
terms, uniforms) and ``entry`` (a kernel entry's call, on either route).
A span belongs to its innermost ``dtc.`` span's layer.

``entry(kid)`` is the span ``dtc.entry.<kid>`` of a kernel entry and the
launch registry's one counter: each call counts once in ``CALLS`` and, on
CUDA tensors, in ``LAUNCHES`` (the kernel route) or in ``PLAIN_ON_CUDA``
(the plain version), keyed by the span's name. ``OBS_TILES`` counts K5's
launches by the tiles each pass-lo block walks
(``ops/observables.py::walk_tiles``). ``reset_counters()`` zeroes all four.

``phase_timer`` is a copy of ``dtc_tpu/utils/profiling.py``'s: wall
seconds of a named phase, logged as ``phase <name> <seconds>s`` on the
port's logger ``dtc_tpu_torch`` and optionally stored in ``sink``; it also
opens the span ``dtc.driver.<name>``.
"""

from __future__ import annotations

import contextlib
import functools
import logging
import time
from collections import Counter

import torch

log = logging.getLogger("dtc_tpu_torch")

_profiling = torch.autograd._profiler_enabled
_RecordFunctionFast = torch._C._profiler._RecordFunctionFast

ENTRY = "dtc.entry."

CALLS: Counter = Counter()          # entry span -> calls, either route
LAUNCHES: Counter = Counter()       # entry span -> kernel-route calls
PLAIN_ON_CUDA: Counter = Counter()  # entry span -> plain calls on CUDA
OBS_TILES: Counter = Counter()      # K5's tiles a pass-lo block -> launches


def reset_counters() -> None:
    for c in (CALLS, LAUNCHES, PLAIN_ON_CUDA, OBS_TILES):
        c.clear()


class span:
    """A host range ``name`` in a running profiler's trace, nothing
    otherwise; a context manager, or a decorator that opens it around each
    call."""

    __slots__ = ("name", "_rf")

    def __init__(self, name: str):
        self.name = name
        self._rf = None

    def __enter__(self):
        if _profiling():
            self._rf = _RecordFunctionFast(self.name)
            self._rf.__enter__()
        return self

    def __exit__(self, *exc):
        rf, self._rf = self._rf, None
        if rf is not None:
            rf.__exit__(*exc)
        return False

    def __call__(self, fn):
        name = self.name

        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)

        return spanned


def entry(kid: str, *, plain: bool = False):
    """Decorator of a kernel entry whose first argument is the tensor it
    routes by: the span ``dtc.entry.<kid>`` around each call that the
    decorated function serves, counted when it returns.

    A kernel entry (``plain`` False) serves the kernel route, a CUDA
    tensor; on any other tensor it hands the call to its plain version,
    which opens the span itself. A plain version (``plain`` True) serves
    every call it gets."""
    name = ENTRY + kid

    def decorate(fn):
        @functools.wraps(fn)
        def counted(x, *args, **kwargs):
            if not (plain or x.is_cuda):
                return fn(x, *args, **kwargs)
            with span(name):
                out = fn(x, *args, **kwargs)
            CALLS[name] += 1
            if x.is_cuda:
                (PLAIN_ON_CUDA if plain else LAUNCHES)[name] += 1
            return out

        return counted

    return decorate


@contextlib.contextmanager
def phase_timer(name: str, sink: dict | None = None):
    t0 = time.perf_counter()
    with span(f"dtc.driver.{name}"):
        yield
    dt = time.perf_counter() - t0
    if sink is not None:
        sink[name] = dt
    log.info("phase %-12s %8.3fs", name, dt)
