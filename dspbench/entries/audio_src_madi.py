"""The program's multichannel 44.1 -> 48 kHz conversion as the benchmark
drives it: ``streaming.StreamingResampler`` built once at the
configuration's factor and ``conv_len`` with the sinc pulse, then called
on each capture, viewed as (channels, n) rows, as a stream of
(channels, ``chunk``) pieces, the state carried through the call from a
zero (channels, T) tail, one ``process`` a chunk.

The only code of the benchmark, with the other entries, that touches the
program's API.
"""
from __future__ import annotations

from fractions import Fraction

import torch

from basic_dsp_tpu_torch import conv_types, streaming
from basic_dsp_tpu_torch.kernels import resample_cuda

from dspbench import floors
from dspbench.probes import Probe


def local(out):
    """A call's output as one (channels, n') tensor: its chunks joined."""
    return torch.cat(list(out), dim=-1)


def mesh(ranks: int, device):
    raise ValueError("audio_src_madi has no entry on a mesh")


def k5_work(rows: int, n_in: int, n_out: int, P: int, taps: int) -> tuple:
    """(nbytes, flops, floor) of one K5 launch: ``rows`` float32 rows of
    ``n_in`` samples read once and of ``n_out`` written once, the (P,
    taps) float32 taps and P int32 offsets read once; a multiply and an
    add a tap for each output; ``floor`` is ``floors.floor_ms`` of the
    two."""
    nbytes = 4.0 * rows * (n_in + n_out) + 4.0 * P * (taps + 1)
    flops = 2.0 * taps * rows * n_out
    return nbytes, flops, floors.floor_ms(nbytes, flops)


class Entry:
    def __init__(self, cfg: dict, consts: dict, traffic: dict, device,
                 mesh=None):
        if mesh is not None:
            raise ValueError("audio_src_madi has no entry on a mesh")
        self.C = int(cfg["channels"])
        self.chunk = int(cfg["chunk"])
        n = 2 * int(traffic["samples"])
        if n % self.C or (n // self.C) % self.chunk:
            raise ValueError(f"{n} samples do not make {self.C} channels of "
                             f"whole {self.chunk}-sample chunks")
        self.n = n // self.C
        self.samples = self.C * self.n
        self.device = torch.device(device)
        self.rs = streaming.StreamingResampler(
            conv_types.SincFunction(), float(Fraction(cfg["factor"])), 0.0,
            int(cfg["conv_len"]), device=self.device)
        # every call starts from this zero state; `process` never writes
        # a state's tail, so one serves them all
        self.zero = self.rs.init_state(torch.float32, self.device,
                                       channels=self.C)

    def prepare(self, xr, xi):
        """The capture's planes as one contiguous (channels, n) float32
        tensor, re plane first."""
        return torch.stack([xr, xi]).reshape(self.C, self.n).contiguous()

    def __call__(self, x):
        state = self.zero
        outs = []
        for s in range(0, self.n, self.chunk):
            out, state = self.rs.process(x[:, s:s + self.chunk], state)
            outs.append(out)
        return outs

    def probes(self, inputs: list) -> dict:
        """``call``: the whole call; ``k5``: the one K5 launch alone on a
        pool capture's first rotated (channels, chunk + T) extension, as
        the stream's first ``process`` hands it over; left out unless that
        ``process`` launches K5 exactly once."""
        rs, C, S = self.rs, self.C, self.chunk
        n_out = self.n * rs.P // rs.Q
        taps = rs.taps.shape[-1]
        out = {"call": Probe(lambda i: self(inputs[i]),
                             4.0 * C * (self.n + n_out),
                             2.0 * taps * C * n_out)}
        L, s_out, ext = rs.L, S * rs.P // rs.Q, S + rs.T
        before = resample_cuda.resample_rowblock_cuda.launches
        rs.process(inputs[0][:, :S], self.zero)
        if resample_cuda.resample_rowblock_cuda.launches - before != 1:
            return out          # the stream launches no K5, or more than one
        tail = self.zero.tail
        exts = [torch.cat([tail[:, L:], x[:, :S], tail[:, :L]], dim=-1)
                for x in inputs]

        def k5(i):
            return resample_cuda.resample_rowblock_cuda(
                exts[i], rs.taps, rs.P, rs.Q, rs.offs, L, s_out)
        nbytes, flops, _ = k5_work(C, ext, s_out, rs.P, taps)
        out["k5"] = Probe(k5, nbytes, flops)
        return out

    def close(self):
        del self.rs, self.zero
