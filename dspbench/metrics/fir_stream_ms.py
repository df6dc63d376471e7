"""The device ms of the Toeplitz FIR (its banded sgemms and adds) in a
call of the chain: the median stream ms of the ``dsp.fir`` span
records the profiled second of a traced run leaves in the
process (``basic_dsp_tpu_torch.profiling``: from the CUDA
marker before the stage to the one at its end, on the device's
timeline).  None where no such record has markers (a program without
spans, a cell whose call has no such stage)."""
import statistics

UNIT = "ms"
END_TO_END = False
SPAN = "dsp.fir"


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
