"""``setup_s``: from the process's start to the first timed map: imports,
CUDA's start, the kernels' build or load, the data, the warm-up."""


def read(ctx):
    return ctx["setup_s"]
