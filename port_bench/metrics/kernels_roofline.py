"""The least time the chip could take for the traced window's counted work
(``roofline.bound`` on the cell's shapes and cycles), as a share of the
summed device time of the window's kernels, in %."""


def read(record):
    return record.kernels_roofline()
