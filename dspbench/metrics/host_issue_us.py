"""Host dispatch: the median over the window of the time from a call
until it returns to the caller, before the wait for the device (the
benchmark's own spans, host clock)."""
import statistics

UNIT = "us"
END_TO_END = False


def read(t):
    return statistics.median(t.issue_s) * 1e6
