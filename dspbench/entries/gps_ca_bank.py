"""The program's GPS L1 C/A matched-filter bank as the benchmark drives it:
``streaming.StreamingFir`` built once from the bank's (P, m) taps, then
called on each capture as a stream of ``chunk``-sample pieces, the state
carried through the call from a zero tail, one ``process`` a chunk.

The only code of the benchmark, with the other entries, that touches the
program's API.
"""
from __future__ import annotations

import torch

from basic_dsp_tpu_torch import streaming
from basic_dsp_tpu_torch.kernels import overlap_save_cuda

from dspbench import floors
from dspbench.probes import Probe


def local(out):
    """A call's output as one (P, n) tensor: its chunks joined."""
    return torch.cat(list(out), dim=-1)


def mesh(ranks: int, device):
    raise ValueError("gps_ca_bank has no entry on a mesh")


def bank_flops(n: int, m: int, rows: int) -> float:
    """The operations of ``n`` complex output samples of ``rows`` real
    ``m``-tap filters on one signal: the fewer of the direct sum's (4 m a
    row) and overlap-save's at its best power-of-two length N > m (one
    forward transform a block for the whole bank, then a product of 6 a
    bin and an inverse for each row, over the N - m + 1 outputs of a
    block)."""
    direct = 4.0 * m * rows
    blocks = (1 << k for k in range(m.bit_length(), m.bit_length() + 16))
    return n * min(direct, *((floors.fft_flops(N) + rows
                              * (floors.fft_flops(N) + 6.0 * N))
                             / (N - m + 1) for N in blocks))


class Entry:
    def __init__(self, cfg: dict, consts: dict, traffic: dict, device,
                 mesh=None):
        if mesh is not None:
            raise ValueError("gps_ca_bank has no entry on a mesh")
        self.chunk = int(cfg["chunk"])
        self.samples = int(traffic["samples"])
        self.taps = consts["taps"]
        self.rows, self.m = (int(s) for s in self.taps.shape)
        self.fir = streaming.StreamingFir(self.taps)

    def prepare(self, xr, xi):
        """The capture as the stream's complex64 samples."""
        return torch.complex(xr, xi)

    def __call__(self, x):
        state = self.fir.init_state(x.dtype, x.device)
        outs = []
        for s in range(0, x.shape[-1], self.chunk):
            out, state = self.fir.process(x[s:s + self.chunk], state)
            outs.append(out)
        return outs

    def probes(self, inputs: list) -> dict:
        """``call``: the whole call; ``k3``: the bank's one K3 launch
        alone on a pool capture's first chunk, extended by the zero tail,
        as the stream's first ``process`` hands it over."""
        P, m, n = self.rows, self.m, self.samples
        out = {"call": Probe(lambda i: self(inputs[i]),
                             8.0 * n + 8.0 * P * n,
                             bank_flops(n, m, P))}
        fl = self.fir.fft_len
        if not overlap_save_cuda.fits(m, fl):
            return out
        H = overlap_save_cuda.spectrum(self.taps.to(torch.complex64), fl)
        tail = self.fir.init_state().tail
        exts = [torch.cat([tail, x[:self.chunk]]) for x in inputs]
        ext = exts[0].shape[-1]
        lim = ext + m - 1

        def k3(i):
            return overlap_save_cuda.conv_blocks_cuda(exts[i], None, H, m,
                                                      fl, linear=True)
        # the extension and the spectra in, the rows out
        out["k3"] = Probe(k3, 8.0 * ext + 8.0 * H.numel() + 8.0 * P * lim,
                          bank_flops(lim, m, P))
        return out

    def close(self):
        del self.fir
        self.taps = None
