"""Set-up seconds: from the harness's start (before torch is imported) to
the window's first call: imports, the CUDA context, the kernels' build and
load, the study's context and the warm-up."""


def read(record):
    return record.setup_s
