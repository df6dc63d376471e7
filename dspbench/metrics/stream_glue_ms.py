"""The device ms a streamed chunk spends outside the FIR: the median
stream ms of the ``dsp.extend`` records (the tail and chunk joined, the new
tail) plus that of the ``dsp.assemble`` records (the valid outputs sliced
out and assembled), from the records the profiled second of a traced run
leaves in the process (``basic_dsp_tpu_torch.profiling``: each from the
CUDA marker before the stage to the one at its end, on the device's
timeline).  None where either has no record with markers (a program
without these spans, a cell that streams nothing)."""
import statistics

UNIT = "ms"
END_TO_END = False
SPANS = ("dsp.extend", "dsp.assemble")


def records() -> list:
    """The program's span records, none where it has no spans."""
    try:
        from basic_dsp_tpu_torch.profiling import spans
    except ImportError:
        return []
    return spans()


def value(recs: list):
    total = 0.0
    for name in SPANS:
        ms = [r["stream_ms"] for r in recs
              if r["name"] == name and r["stream_ms"] is not None]
        if not ms:
            return None
        total += statistics.median(ms)
    return total


def read(t):
    return value(records())
