"""Set-up: from the process's start to the window's first timed step
(imports, the CUDA context, the kernels' build or load, the levels, the
weights, the warm-up and, in the training cells, the checked
iterations)."""


def read(t):
    return t.setup_s
