"""setup_s: seconds from the start of run.py to the window's start
(imports, CUDA, inputs and weights, the program's build or load of its
kernels, calibration, one warm-up request)."""


def read(run):
    return run.setup_s
