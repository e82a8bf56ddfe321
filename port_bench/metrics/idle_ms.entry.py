"""ms a call of the traced window's idle device time that the program spent in
the kernel entries (``dtc.entry.*``: checks, buffers, the C call, the host
factor): each idle gap charged to the layer of the innermost ``dtc.`` span
at its middle (``program_spans.py``), over the window's calls."""

from port_bench.program_spans import idle_ms

LAYER = "entry"


def read(record):
    return idle_ms(record, LAYER)
