"""ms a call of the traced window's idle device time that the program spent in
the sweep host loop (``dtc.sweep.*``: one batch of a sweep's chunk loop, its
routing and read-back): each idle gap charged to the layer of the innermost
``dtc.`` span at its middle (``program_spans.py``), over the window's calls."""

from port_bench.program_spans import idle_ms

LAYER = "sweep"


def read(record):
    return idle_ms(record, LAYER)
