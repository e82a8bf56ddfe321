"""Trajectory Floquet cycles per second: every cycle that the window's calls
counted, over all the window's time from the first call's start to the last
call's end."""


def read(record):
    return record.cycles_per_s()
