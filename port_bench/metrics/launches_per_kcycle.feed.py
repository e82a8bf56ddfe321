"""Kernel launches of the traced window's calls that the host feeders made
(``dtc.feed.*`` the innermost ``dtc.`` span of the launch), per 1000
counted cycles: the torch feeders' share of ``launches_per_kcycle``."""

from port_bench.program_spans import launches_in


def read(record):
    if record.trace is None or not record.cycles:
        return None
    n = launches_in(record.trace, "feed")
    return None if n is None else n / (record.cycles / 1000)
