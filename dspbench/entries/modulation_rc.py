"""The program's multi-carrier IQ pulse shaper as the benchmark drives it:
``streaming.StreamingResampler`` built once at the configuration's factor
and ``conv_len`` with the raised-cosine pulse, then called on each
capture's QPSK symbols, (carriers, n) complex64 rows, as a stream of
(carriers, ``chunk``) pieces, the state carried through the call from a
zero (carriers, T) complex64 tail, one ``process`` a chunk.

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
    """A call's output as one (carriers, n') tensor: its chunks joined."""
    return torch.cat(list(out), dim=-1)


def mesh(ranks: int, device):
    raise ValueError("modulation_rc has no entry on a mesh")


def k4_work(rows: int, S: int, T: int, n_out: int, P: int,
            taps: int) -> tuple:
    """(nbytes, flops, floor) of one K4 launch on a stream's complex64
    chunk read in place: ``rows`` rows of the chunk's ``S`` samples and
    the tail's ``T`` read once, the next tail's T and the ``n_out``
    outputs written once (8 bytes a sample), the (P, taps) float32 taps
    and P int32 offsets read once; a multiply and an add a tap for each
    plane of an output; ``floor`` is ``floors.floor_ms`` of the two."""
    nbytes = (8.0 * rows * (S + T) + 8.0 * rows * (T + n_out)
              + 4.0 * P * (taps + 1))
    flops = 2.0 * taps * 2 * rows * n_out
    return nbytes, flops, floors.floor_ms(nbytes, flops)


class Entry:
    def __init__(self, cfg: dict, consts: dict, traffic: dict, device,
                 mesh=None):
        if mesh is not None:
            raise ValueError("modulation_rc has no entry on a mesh")
        self.C = int(cfg["carriers"])
        self.chunk = int(cfg["chunk"])
        n = int(traffic["samples"])
        if n % self.C or (n // self.C) % self.chunk:
            raise ValueError(f"{n} symbols do not make {self.C} carriers "
                             f"of whole {self.chunk}-symbol chunks")
        self.n = n // self.C
        self.samples = self.C * self.n
        self.device = torch.device(device)
        self.rs = streaming.StreamingResampler(
            conv_types.RaisedCosineFunction(float(cfg["rolloff"])),
            float(Fraction(cfg["factor"])), 0.0, int(cfg["conv_len"]),
            device=self.device)
        # every call starts from this zero state; `process` never writes
        # a state's tail, so one serves them all
        self.zero = self.rs.init_state(torch.complex64, self.device,
                                       channels=self.C)

    def prepare(self, xr, xi):
        """The capture's QPSK symbols, 0.5 (sign(xr) + i sign(xi)), as one
        contiguous (carriers, n) complex64 tensor."""
        return torch.complex(0.5 * torch.sign(xr),
                             0.5 * torch.sign(xi)).reshape(self.C, self.n)

    def __call__(self, x):
        state = self.zero
        outs = []
        for s in range(0, self.n, self.chunk):
            out, state = self.rs.process(x[:, s:s + self.chunk], state)
            outs.append(out)
        return outs

    def probes(self, inputs: list) -> dict:
        """``call``: the whole call; ``k4``: the one K4 launch alone as the
        stream's first ``process`` issues it, on each pool capture's first
        chunk with the zero tail and a fresh next tail; left out unless
        that ``process`` launches K4 exactly once and reads the chunk in
        place."""
        rs, C, S = self.rs, self.C, self.chunk
        n_out = self.n * rs.P // rs.Q
        taps = rs.taps.shape[-1]
        out = {"call": Probe(lambda i: self(inputs[i]),
                             8.0 * C * (self.n + n_out)
                             + 4.0 * rs.P * (taps + 1),
                             2.0 * taps * 2 * C * n_out)}
        s_out = S * rs.P // rs.Q
        before = resample_cuda.resample_direct_cuda.launches
        in_place0 = streaming.StreamingResampler.in_place
        rs.process(inputs[0][:, :S], self.zero)
        if (resample_cuda.resample_direct_cuda.launches - before != 1
                or streaming.StreamingResampler.in_place - in_place0 != 1):
            return out    # no K4, more than one, or the chunk not in place
        tail = self.zero.tail

        def k4(i):
            return resample_cuda.resample_direct_cuda(
                inputs[i][:, :S], rs.taps, rs.P, rs.Q, rs.offs, rs.L, s_out,
                tail=tail, next_tail=torch.empty_like(tail))
        nbytes, flops, _ = k4_work(C, S, rs.T, s_out, rs.P, taps)
        out["k4"] = Probe(k4, nbytes, flops)
        return out

    def close(self):
        del self.rs, self.zero
