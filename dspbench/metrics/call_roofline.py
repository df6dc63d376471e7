"""The whole call's share of its roofline: the floor of the call (its
capture read once and its result written once; the operations of the
cheapest known algorithm; held constants left out) over the device ms of
the call by CUDA-graph replay, in percent.  None where no replay was read."""
from dspbench import floors

UNIT = "%"
END_TO_END = False


def read(t):
    if "call" not in t.device_ms:
        return None
    return floors.share_pct(*t.work["call"], t.device_ms["call"])
