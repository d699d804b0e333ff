"""token_gap_ms_p95's statistic on the host's clock: the gaps between the
host's returns from each step's token copy, over the profiler-off window."""

import numpy as np


def read(run):
    if not run.host_gap_ms:
        return None
    return float(np.percentile(run.host_gap_ms, 95))
