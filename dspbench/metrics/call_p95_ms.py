"""The 95th percentile over all calls of the window of the time from a
call's issue to its result being ready (host clock)."""
import numpy as np

UNIT = "ms"
END_TO_END = True


def read(t):
    return float(np.percentile(np.asarray(t.latency_s), 95)) * 1e3
