"""Mean ms a call of the program's ``forward`` phase (``utils/profiling.py::
phase_timer``, read from its log line), over the window's calls."""

PHASE = "forward"


def read(record):
    vals = [p[PHASE] for p in record.phases if PHASE in p]
    return 1e3 * sum(vals) / len(vals) if vals else None
