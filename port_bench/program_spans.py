"""The program's own spans in a traced window.

``dtc_tpu_torch/utils/profiling.py::span`` marks the program's host layers
as ``dtc.<layer>.<what>`` ranges on the trace's clock: ``driver`` (the
studies and their phases), ``sweep`` (one batch of a sweep's chunk loop,
its read-back included), ``feed`` (the host's torch feeders) and ``entry``
(a kernel entry's call). They are host events only, never on the device's
timeline. A moment belongs to the layer of the innermost ``dtc.`` span
running then; torch ops and the harness's own spans own nothing here. A
window without any ``dtc.`` span (a program that has none) reads None.
"""

from __future__ import annotations

from port_bench.trace import CALL, idle_gaps

PREFIX = "dtc."
LAYERS = ("driver", "sweep", "feed", "entry")


def layer(name: str) -> str:
    """``dtc.<layer>.<what>`` -> ``<layer>``."""
    return name.split(".", 2)[1]


def spans(trace) -> list:
    """The window's ``dtc.`` spans, (name, start, end), properly nested."""
    return [h for h in trace.host if h[0].startswith(PREFIX)]


def owners(points, nested) -> list:
    """For each time in ``points``, the name of the innermost span of
    ``nested`` (properly nested (name, start, end)) that covers it, or
    None; in the order of ``points``."""
    order = sorted(range(len(points)), key=lambda i: points[i])
    ops = sorted(nested, key=lambda h: (h[1], -h[2]))
    out: list = [None] * len(points)
    stack: list = []
    j = 0
    for i in order:
        t = points[i]
        while j < len(ops) and ops[j][1] <= t:
            while stack and stack[-1][2] <= ops[j][1]:
                stack.pop()
            stack.append(ops[j])
            j += 1
        while stack and stack[-1][2] < t:
            stack.pop()
        out[i] = stack[-1][0] if stack else None
    return out


def idle_by_layer(trace):
    """{layer: seconds} of the window's idle device time, each gap charged
    to the layer of the innermost ``dtc.`` span at its middle (gaps outside
    every one are charged to none); None without a ``dtc.`` span."""
    own = spans(trace)
    if not own:
        return None
    gaps = idle_gaps([(s, e) for _, s, e, _ in trace.device], trace.w0,
                     trace.w1)
    out = dict.fromkeys(LAYERS, 0.0)
    for (s, e), name in zip(gaps, owners([(s + e) / 2 for s, e in gaps],
                                         own)):
        if name is not None:
            out[layer(name)] = out.get(layer(name), 0.0) + (e - s) / 1e9
    return out


def idle_ms(record, name: str):
    """ms a call of idle device time owned by layer ``name``."""
    if record.trace is None or not record.calls:
        return None
    per = idle_by_layer(record.trace)
    return None if per is None else 1e3 * per[name] / len(record.calls)


def launches_in(trace, name: str):
    """Kernel launches that the host made inside the calls, each in a span
    of layer ``name`` as its innermost ``dtc.`` span; None without a
    ``dtc.`` span."""
    own = spans(trace)
    if not own:
        return None
    starts = [s for n, s, _ in trace.host if "LaunchKernel" in n]
    calls = [h for h in trace.host if h[0] == CALL]
    return sum(1 for o, c in zip(owners(starts, own), owners(starts, calls))
               if o is not None and c is not None and layer(o) == name)
