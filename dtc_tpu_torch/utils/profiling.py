"""Phase timers.

A copy of ``phase_timer`` from ``dtc_tpu/utils/profiling.py``: wall seconds
of a named phase, logged as ``phase <name> <seconds>s`` on the port's
logger ``dtc_tpu_torch`` and optionally stored in ``sink``.
"""

from __future__ import annotations

import contextlib
import logging
import time

log = logging.getLogger("dtc_tpu_torch")


@contextlib.contextmanager
def phase_timer(name: str, sink: dict | None = None):
    t0 = time.perf_counter()
    yield
    dt = time.perf_counter() - t0
    if sink is not None:
        sink[name] = dt
    log.info("phase %-12s %8.3fs", name, dt)
