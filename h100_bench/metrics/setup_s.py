"""From the process's start to the first timed step (host clock): kernels
built or loaded, weights made, the cache allocated and prefilled, the
warm-up steps."""


def read(run):
    return run.setup_s
