"""Share of the traced window in which no device operation ran, in %:
1 - busy / window, busy the union of the device events' intervals."""


def read(record):
    return record.device_idle_pct()
