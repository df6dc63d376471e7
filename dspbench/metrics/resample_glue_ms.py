"""The device ms a streamed resampler chunk spends joining its tail and
chunk into the rotated extension and keeping the new tail: the median
stream ms of the ``dsp.rotate`` records the profiled second of a traced
run leaves in the process (``basic_dsp_tpu_torch.profiling``: from the
CUDA marker before the stage to the one at its end, on the device's
timeline).  None where no such record has markers (a program without the
span, a cell that streams no resampler)."""
import statistics

UNIT = "ms"
END_TO_END = False
SPAN = "dsp.rotate"


def records() -> list:
    """The program's span records, none where it has no spans."""
    try:
        from basic_dsp_tpu_torch.profiling import spans
    except ImportError:
        return []
    return spans()


def value(recs: list):
    ms = [r["stream_ms"] for r in recs
          if r["name"] == SPAN and r["stream_ms"] is not None]
    return statistics.median(ms) if ms else None


def read(t):
    return value(records())
