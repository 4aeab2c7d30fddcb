"""setup_s: seconds from the process's start to the first timed call:
imports, the CUDA context, the kernels' build or load, the cell's
inputs and the warm-up of its shapes (host clock)."""


def read(run):
    return run.setup_s
