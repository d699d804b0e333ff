"""Device kernels in the traced stretch, divided by its steps (a count)."""


def read(run):
    if run.trace is None:
        return None
    return len(run.trace.kernels) / run.trace.steps
