"""ms a call of the traced window's idle device time that the program spent in
the host feeders (``dtc.feed.*``: step rows, folds, energy terms, uniforms):
each idle gap charged to the layer of the innermost ``dtc.`` span at its
middle (``program_spans.py``), over the window's calls."""

from port_bench.program_spans import idle_ms

LAYER = "feed"


def read(record):
    return idle_ms(record, LAYER)
