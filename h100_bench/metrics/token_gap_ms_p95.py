"""The 95th percentile, over every step of the window, of the gap between
two successive arrivals of a step's tokens in host memory: CUDA events
recorded after each step's copy to the host, read on the device's clock."""

import numpy as np


def read(run):
    if not run.gap_ms:
        return None
    return float(np.percentile(run.gap_ms, 95))
