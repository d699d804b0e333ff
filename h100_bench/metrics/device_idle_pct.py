"""The share of the traced stretch's wall time in which no device operation
runs (the union of kernel, copy and set intervals)."""


def read(run):
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
