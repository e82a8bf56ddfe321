"""Mean ms a call of the program's ``echo`` phase (``utils/profiling.py::
phase_timer``, read from its log line), over the window's calls."""

PHASE = "echo"


def read(record):
    vals = [p[PHASE] for p in record.phases if PHASE in p]
    return 1e3 * sum(vals) / len(vals) if vals else None
