"""K5 (``kernels.resample_cuda.resample_rowblock_cuda``) alone at the
shape the stream gives it, a (channels, chunk + T) rotated extension, by
CUDA-graph replay, against its floor (the rows and the taps read once,
the outputs written once; a multiply and an add a tap an output; bytes
binding), in percent.  None in a cell whose call launches no K5."""
from dspbench import floors

UNIT = "%"
END_TO_END = False


def read(t):
    if "k5" not in t.device_ms:
        return None
    return floors.share_pct(*t.work["k5"], t.device_ms["k5"])
