"""K3 (``kernels.overlap_save_cuda.conv_blocks_cuda``) alone at the shape
the call gives it, by CUDA-graph replay, against its floor (the
extension's planes and the spectra read once, the rows written once; the
operations of the cheapest known work, bytes binding), in percent.  None
in a cell whose call launches no K3."""
from dspbench import floors

UNIT = "%"
END_TO_END = False


def read(t):
    if "k3" not in t.device_ms:
        return None
    return floors.share_pct(*t.work["k3"], t.device_ms["k3"])
