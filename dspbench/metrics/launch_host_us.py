"""Host dispatch, at the C entries: the median over the profiled second's
roots (a call, or a stream's chunk) of the host us of the root's C-entry
calls, its records' ``launch_ns`` (``dspbench.host_split``).  None where
no root counts a launch."""
from dspbench import host_split

UNIT = "us"
END_TO_END = False


def value(recs: list):
    return host_split.median_us(recs, 0)


def read(t):
    return value(host_split.records())
