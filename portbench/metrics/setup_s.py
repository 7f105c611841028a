"""setup_s: seconds from the process's start to the opening of the
measured window (imports, the model's build and weights, the kernels'
build and capture in ``warmup`` or the first step, and the traffic's
ramp). Host clock."""


def read(run):
    return run.setup_s
