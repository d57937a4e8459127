"""Set-up seconds: from the process's start to the window's first call
(imports, CUDA's start, the kernels' build or load, the bag made on the
device, the warm call)."""


def read(run):
    return run.setup_s
