"""What a ``torch.profiler`` trace of the window says.

``short_name`` and the busy union of ``busy`` are frozen copies of
``dtc_tpu_torch/profile_sweep.py::short_name`` and ``busy_summary``: busy
time is the union of the device events' intervals, and kernels are summed
by short name. Here they read the profiler's raw events
(``kineto_results.events()``), which is fast enough for a window of many
thousand launches.

The harness marks its own spans with ``record_function``: the window
(``port_bench.window``), each call (``port_bench.call``) and the making of
each call's inputs (``port_bench.inputs``). The window's span fixes the
traced window on the trace's own clock; the device work that the harness's
inputs launched is left out; and the kernel launches are counted on the
host, inside the calls' spans, where the profiler drops none (it can drop
a few device events of a long window).
"""

from __future__ import annotations

import bisect
import re
from dataclasses import dataclass, field

import torch

WINDOW = "port_bench.window"
CALL = "port_bench.call"
INPUTS = "port_bench.inputs"
OWN = "port_bench."  # the harness's spans, mirrored on the device's timeline


def short_name(name: str) -> str:
    """A kernel's name without its namespace prefix, template arguments and
    parameter list: ``void ns::k<...>(float*, ...)`` -> ``ns::k``; a leading
    bool template argument stays (``k<true>``: the port's passes that
    measure, against ``k<false>``; the lab-frame passes' row width after it
    goes)."""
    name = name.replace("(anonymous namespace)::", "").removeprefix("void ")
    cut = [i for i in (name.find("<"), name.find("(")) if i > 0]
    if not cut:
        return name
    flag = re.match(r"<(true|false)[,>]", name[min(cut):])
    return name[:min(cut)].strip() + (f"<{flag.group(1)}>" if flag else "")


def busy(spans) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(spans):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def idle_gaps(spans, w0: float, w1: float):
    """The (start, end) intervals of [w0, w1] that no span covers."""
    out, cur = [], w0
    for s, e in sorted(spans):
        if s > cur:
            out.append((cur, min(s, w1)))
        cur = max(cur, e)
        if cur >= w1:
            break
    if cur < w1:
        out.append((cur, w1))
    return [(s, e) for s, e in out if e > s]


def host_labels(gaps, host):
    """Seconds of idle device time by the innermost host op running at each
    gap's middle; ``host``: properly nested (name, start, end) of one
    thread, times in the gaps' unit (ns)."""
    mids = sorted(((s + e) / 2, e - s) for s, e in gaps)
    ops = sorted(host, key=lambda h: (h[1], -h[2]))
    out: dict[str, float] = {}
    stack: list = []
    j = 0
    for m, length in mids:
        while j < len(ops) and ops[j][1] <= m:
            while stack and stack[-1][2] <= ops[j][1]:
                stack.pop()
            stack.append(ops[j])
            j += 1
        while stack and stack[-1][2] < m:
            stack.pop()
        label = stack[-1][0] if stack else "(no host op)"
        out[label] = out.get(label, 0.0) + length / 1e9
    return out


@dataclass
class Trace:
    """The device events and the host ops of the window's thread, clipped
    to the window; times in ns on the trace's clock."""
    w0: float
    w1: float
    device: list = field(default_factory=list)   # (name, start, end, kind)
    host: list = field(default_factory=list)     # (name, start, end)
    launches: int = 0  # kernel launches the host made inside the calls

    @property
    def window_s(self) -> float:
        return (self.w1 - self.w0) / 1e9

    def busy_s(self) -> float:
        return busy([(s, e) for _, s, e, _ in self.device]) / 1e9

    def kernels(self):
        return [d for d in self.device if d[3] == "kernel"]

    def device_ops(self, top: int = 10):
        """[[short name, seconds], ...] of the costliest device ops."""
        per: dict[str, float] = {}
        for name, s, e, _ in self.device:
            k = short_name(name)
            per[k] = per.get(k, 0.0) + (e - s) / 1e9
        return [[k, v] for k, v in sorted(per.items(), key=lambda kv: -kv[1])
                [:top]]

    def idle_by_host(self, top: int = 10):
        """[[host op, seconds], ...]: idle device time by what the host
        was doing, the longest first."""
        gaps = idle_gaps([(s, e) for _, s, e, _ in self.device],
                         self.w0, self.w1)
        per = host_labels(gaps, self.host)
        return [[k, v] for k, v in sorted(per.items(), key=lambda kv: -kv[1])
                [:top]]


def _kind(name: str) -> str:
    """A device event's kind by its name (the profiler of torch 2.11 gives
    no activity type): copies, fills and kernels."""
    return ("gpu_memcpy" if name.startswith("Memcpy") else
            "gpu_memset" if name.startswith("Memset") else "kernel")


def read(prof) -> Trace:
    """The window's events of a finished ``torch.profiler.profile``; the
    device work launched while the harness made a call's inputs
    (``port_bench.inputs``) is left out."""
    cuda = torch.autograd.DeviceType.CUDA
    raw = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns(),
            e.device_type() == cuda, e)
           for e in prof.profiler.kineto_results.events()]
    win = [r for r in raw if r[0] == WINDOW and not r[3]]
    if len(win) != 1:
        raise RuntimeError(f"the trace holds {len(win)} window spans")
    _, w0, w1, _, we = win[0]
    tid = we.start_thread_id()
    host = [r for r in raw if not r[3] and r[4].start_thread_id() == tid]

    def spans(label):
        iv = sorted((s, e) for name, s, e, _, _ in host if name == label)
        starts = [s for s, _ in iv]

        def inside(t):
            k = bisect.bisect_right(starts, t) - 1
            return k >= 0 and t <= iv[k][1]
        return inside

    in_inputs, in_call = spans(INPUTS), spans(CALL)
    harness = {ev.correlation_id() for _, s, _, _, ev in host
               if ev.correlation_id() and in_inputs(s)}
    launches = sum(1 for name, s, _, _, _ in host
                   if "LaunchKernel" in name and in_call(s))
    tr = Trace(w0, w1, launches=launches)
    for name, s, e, on_dev, ev in raw:
        if e <= w0 or s >= w1:
            continue
        if on_dev:
            if not name.startswith(OWN) and ev.correlation_id() not in harness:
                tr.device.append((name, max(s, w0), min(e, w1), _kind(name)))
        elif ev.start_thread_id() == tid and name != WINDOW:
            tr.host.append((name, s, e))
    return tr
