"""The median, over the profiler-off window, of the host's time from the
call of decode_step to its return (the benchmark's span)."""

import numpy as np


def read(run):
    if not run.enqueue_ms:
        return None
    return float(np.median(run.enqueue_ms))
