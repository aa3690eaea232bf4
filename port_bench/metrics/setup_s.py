"""setup_s: seconds from the process's start to the first timed call:
imports, the pool read (built in a new checkout), the files joined, the
kernels built or loaded, the warm-up call."""


def read(run):
    return run.setup_s
