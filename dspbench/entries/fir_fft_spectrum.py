"""The program's FIR + FFT spectrum chain as the benchmark drives it:
``pipelines.FirFftChainPlanar`` built once from the taps and the window,
then called on (re, im) float32 planes, one capture a call.

The only code of the benchmark, with the other entries, that touches the
program's API.
"""
from __future__ import annotations

import contextlib
import math

from basic_dsp_tpu_torch import config, pipelines
from basic_dsp_tpu_torch.kernels import spectrum_cuda

from dspbench import floors
from dspbench.probes import Probe


def local(out):
    """This rank's part of a call's output: all of it."""
    return out


@contextlib.contextmanager
def lower_precision():
    """The program's own lower-precision path: its float32 matmuls (the
    FIR's and stage 1's) in TF32, ``config.set_matmul_precision("high")``;
    K1 has no such switch."""
    before = config.matmul_precision()
    config.set_matmul_precision("high")
    try:
        yield
    finally:
        config.set_matmul_precision(before)


def mesh(ranks: int, device):
    raise ValueError("fir_fft_spectrum has no entry on a mesh")


class Entry:
    def __init__(self, cfg: dict, consts: dict, traffic: dict, device,
                 mesh=None):
        if mesh is not None:
            raise ValueError("fir_fft_spectrum has no entry on a mesh")
        self.n = int(traffic["samples"])
        self.samples = self.n
        self.m = int(consts["taps"].shape[-1])
        self.chain = pipelines.FirFftChainPlanar(
            consts["taps"], consts["window"], n1=int(cfg["n1"]),
            fused=bool(cfg["fused"]))

    def prepare(self, xr, xi):
        return xr, xi

    def __call__(self, inp):
        return self.chain(*inp)

    def probes(self, inputs: list) -> dict:
        """``call``: the whole call; ``k1``: the row kernel alone on planes
        of the shape the call gives it (a pool capture viewed as the
        (n1, n2) stage-1 output), with the chain's own twiddle planes."""
        n, ch = self.n, self.chain
        n1, n2 = ch.n1, ch.n2
        call = Probe(lambda i: self(inputs[i]), 12.0 * n,
                     (floors.fir_flops(self.m) + 2 + 5 * math.log2(n) + 3)
                     * n)
        out = {"call": call}
        if ch.fused:
            return out
        Tfac = (ch.tw_ar, ch.tw_ai, ch.tw_br, ch.tw_bi)
        W = (ch.w_r, ch.w_i)
        held = sum(4.0 * p.numel() for p in (*Tfac, *W))

        def k1(i):
            xr, xi = inputs[i]
            return spectrum_cuda.rowfft_mag(xr.view(n1, n2), xi.view(n1, n2),
                                            shift=True, Tfac=Tfac, W=W)
        # the planes in, the twiddles in, the magnitudes out; row FFTs,
        # the twiddle and the magnitude
        out["k1"] = Probe(k1, 8.0 * n + held + 4.0 * n,
                          (5 * math.log2(n2) + 6 + 3) * n)
        return out

    def close(self):
        del self.chain
