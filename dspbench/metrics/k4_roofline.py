"""K4 (``kernels.resample_cuda.resample_direct_cuda``) alone as the
stream's first ``process`` issues it: a (carriers, chunk) complex64 chunk
and its zero tail read where they lie, the outputs and the next tail
written, by CUDA-graph replay, against its floor (chunk and tail read
once, the next tail and the outputs written once, the taps and offsets
read once; a multiply and an add a tap for each plane of an output; bytes
binding), in percent.  None in a cell whose stream launches no K4 on
complex64 chunks read in place."""
from dspbench import floors

UNIT = "%"
END_TO_END = False


def read(t):
    if "k4" not in t.device_ms:
        return None
    return floors.share_pct(*t.work["k4"], t.device_ms["k4"])
