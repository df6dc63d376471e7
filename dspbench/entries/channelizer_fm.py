"""The program's 1024-channel polyphase channelizer with FM demodulation
as the benchmark drives it.  On one card ``parallel.channelizer.
ChannelizeAndDemodPlanar`` (K6), built once from the prototype and called
on (re, im) float32 planes; on a mesh ``sharded_channelize_and_demod`` on a
complex64 ``DTensor`` sharded on time, the prototype on the card.

The only code of the benchmark, with the other entries, that touches the
program's API.
"""
from __future__ import annotations

import math

import torch

from basic_dsp_tpu_torch import config
from basic_dsp_tpu_torch.kernels import channelizer_cuda
from basic_dsp_tpu_torch.parallel import channelizer

from dspbench.probes import Probe


def local(out):
    """This rank's part of a call's output: its shard on a mesh."""
    return out.to_local() if hasattr(out, "to_local") else out


def mesh(ranks: int, device):
    """A 1-D mesh of ``ranks`` ranks (the process group is up)."""
    return config.make_mesh(ranks, device_type=torch.device(device).type)


class Entry:
    def __init__(self, cfg: dict, consts: dict, traffic: dict, device,
                 mesh=None):
        self.C = int(cfg["channels"])
        self.t = int(cfg["taps_per_phase"])
        self.samples = int(traffic["samples"])
        self.mesh = mesh
        self.proto = consts["prototype"]
        if mesh is None:
            self.mod = channelizer.ChannelizeAndDemodPlanar(self.proto,
                                                            self.C)

    def prepare(self, xr, xi):
        """The call's input from a whole capture: the planes on one card,
        on a mesh this rank's shard of the complex capture as a DTensor
        (a copy, so that the whole capture can be freed)."""
        if self.mesh is None:
            return xr, xi
        from torch.distributed.tensor import DTensor
        from basic_dsp_tpu_torch.parallel import sharded
        dt = sharded.shard_time_axis(torch.complex(xr, xi), self.mesh)
        return DTensor.from_local(dt.to_local().clone(), dt.device_mesh,
                                  dt.placements, run_check=False,
                                  shape=dt.shape, stride=dt.stride())

    def __call__(self, inp):
        if self.mesh is None:
            return self.mod(*inp)
        return channelizer.sharded_channelize_and_demod(
            inp, self.proto, self.C, self.mesh)

    def _work(self, n: int):
        """Bytes and operations of n samples: the planes in, the angles
        out; the polyphase FIR (t real taps a complex sample), the DFT of
        the phases and the conjugate product."""
        return 12.0 * n, (4.0 * self.t + 5 * math.log2(self.C) + 6) * n

    def probes(self, inputs: list) -> dict:
        """One card: ``call``, the whole call, and ``k6``, the kernel alone
        on the call's planes and the module's merged taps.  On a mesh:
        ``halo``, the call's own halo ((t + 1) C complex samples) shifted
        from the left neighbour alone."""
        if self.mesh is None:
            nb, fl = self._work(self.samples)
            taps = self.mod.taps_merged

            def k6(i):
                xr, xi = inputs[i]
                return channelizer_cuda.channelize_demod_cuda(
                    xr, xi, taps, self.C, demod=True)
            return {"call": Probe(lambda i: self(inputs[i]), nb, fl),
                    "k6": Probe(k6, nb + 4.0 * taps.numel(), fl)}
        from basic_dsp_tpu_torch.parallel import collectives
        axes = collectives.resolve_axes(self.mesh, None)
        halo_n = (self.t + 1) * self.C

        def halo(i):
            with collectives.on_mesh(self.mesh):
                return collectives.shift_from_left(
                    inputs[i].to_local()[-halo_n:], axes, wrap=False)
        return {"halo": Probe(halo, 16.0 * halo_n, 0.0, replay="events")}

    def close(self):
        self.__dict__.pop("mod", None)
        self.proto = None
