"""The device's idle share inside a call on one card: 1 - the call's
device ms by CUDA-graph replay / the median stream ms of the root spans of
the profiled second's calls.  A root span's CUDA markers
(``basic_dsp_tpu_torch.profiling``) run from the call's start to its end
on the device's timeline, the device's waits for the host inside the call
included, so this is the idle share the program's own dispatch causes;
``device_idle_share`` less this is the caller's wait and wake.  The
records are the ones the profiled second of a traced run leaves in the
process.  None where no root span with markers was recorded (a program
without spans, a mesh) or no replay was read."""
import statistics

UNIT = "share"
END_TO_END = False


def records() -> list:
    """The program's span records, none where it has no spans."""
    try:
        from basic_dsp_tpu_torch.profiling import spans
    except ImportError:
        return []
    return spans()


def value(recs: list, call_ms):
    roots = [r["stream_ms"] for r in recs
             if r["parent"] is None and r["stream_ms"] is not None]
    if not roots or not call_ms:
        return None
    return 1.0 - call_ms / statistics.median(roots)


def read(t):
    return value(records(), t.device_ms.get("call"))
