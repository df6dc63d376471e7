"""K1 (``kernels.spectrum_cuda.rowfft_mag``) alone at the shapes the call
gives it, by CUDA-graph replay, against its floor (each input, twiddles
included, read once, the magnitudes written once), in percent.  None in a
cell whose call launches no K1."""
from dspbench import floors

UNIT = "%"
END_TO_END = False


def read(t):
    if "k1" not in t.device_ms:
        return None
    return floors.share_pct(*t.work["k1"], t.device_ms["k1"])
