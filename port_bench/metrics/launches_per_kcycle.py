"""Kernel launches of the traced window's calls per 1000 counted cycles (the
harness's own input draws left out): a count, counted on the host."""


def read(record):
    return record.launches_per_kcycle()
