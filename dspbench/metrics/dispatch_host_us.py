"""Host dispatch, the program's own Python: the median over the profiled
second's roots (a call, or a stream's chunk) of the root's host us less
the recorder's own time in it and less its C-entry calls' time
(``dspbench.host_split``): checks, routing and allocations.  None where
no root counts a launch."""
from dspbench import host_split

UNIT = "us"
END_TO_END = False


def value(recs: list):
    return host_split.median_us(recs, 1)


def read(t):
    return value(host_split.records())
