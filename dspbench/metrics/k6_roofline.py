"""K6 (``kernels.channelizer_cuda.channelize_demod_cuda``) alone at the
shapes the call gives it, by CUDA-graph replay, against its floor (the
planes and the merged taps read once, the angles written once), in
percent.  None in a cell whose call launches no K6 on one card."""
from dspbench import floors

UNIT = "%"
END_TO_END = False


def read(t):
    if "k6" not in t.device_ms:
        return None
    return floors.share_pct(*t.work["k6"], t.device_ms["k6"])
