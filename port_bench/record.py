"""What one run leaves for the metric readers (``metrics/<name>.py``).

A reader is a module with ``read(record) -> float | None``; None, where it
finds nothing to read, leaves the metric out of the result line.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from port_bench.roofline import bound


@dataclass
class Record:
    setup_s: float
    cycles_per_call: int
    work: dict                                   # one call's, for roofline
    calls: list = field(default_factory=list)    # (start s, end s) host clock
    phases: list = field(default_factory=list)   # per call {phase: seconds}
    trace: object = None                         # trace.Trace of the window

    @property
    def cycles(self) -> int:
        """The cycles that the window's calls counted."""
        return len(self.calls) * self.cycles_per_call

    @property
    def window_s(self) -> float:
        """From the first call's start to the last call's end."""
        return self.calls[-1][1] - self.calls[0][0]

    def cycles_per_s(self) -> float:
        """Every cycle the window's calls counted, over the window."""
        return self.cycles / self.window_s

    def launches_per_kcycle(self):
        """Kernel launches of the traced calls per 1000 counted cycles."""
        if self.trace is None or not self.cycles:
            return None
        return self.trace.launches / (self.cycles / 1000)

    def kernels_roofline(self):
        """The least time the chip could take for the traced window's
        counted work, over the summed device time of its kernels, in %."""
        if self.trace is None:
            return None
        kernel_ns = sum(e - s for _, s, e, _ in self.trace.kernels())
        if kernel_ns <= 0:
            return None
        n = len(self.calls)
        work = {k: n * v for k, v in self.work.items()
                if k != "flops_per_amp_step"}
        ms, _ = bound(flops_per_amp_step=self.work["flops_per_amp_step"],
                      **work)
        return 100 * ms * 1e6 / kernel_ns

    def device_idle_pct(self):
        """Share of the traced window with no device op running, in %."""
        if self.trace is None or self.trace.window_s <= 0:
            return None
        return 100 * (1 - self.trace.busy_s() / self.trace.window_s)
