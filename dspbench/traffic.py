"""The one generator of the benchmark's traffic: captures of complex
baseband made on the device from the seed, as the parameters of a traffic
file (``traffic/<name>.json``) describe them.

A capture is complex Gaussian noise plus narrowband components: tones at
frequencies drawn from the seed, or FM carriers at the centres of a grid of
channels, each frequency-modulated by a sinusoidal message.  Every seed
gives the same sizes and the same kinds and counts of components; the seed
draws only their values and the order in which the caller takes the
captures.  Capture ``k`` of a seed is the same whoever makes it and
whatever else was made before, so a reference can make it again after the
window, and every rank of a mesh makes the whole capture and keeps its
own shard of it.

Traffic keys:

- ``samples``: complex samples of a capture (on a mesh: of the whole
  capture, each rank holding ``samples / ranks``);
- ``pool``: distinct captures the caller cycles through;
- ``keep``: calls of the window whose outputs are kept for the check;
- ``signal``: ``noise_rms`` (each plane's), then either ``tones`` (count)
  with ``tone_amplitude`` ([low, high]), or ``fm_grid`` (channels),
  ``fm_carriers`` (count), ``fm_amplitude`` ([low, high]),
  ``fm_deviation`` and ``fm_message`` (peak deviation and message
  frequency, in channel spacings).
"""
from __future__ import annotations

import math

import numpy as np
import torch


def _seed_state(seed: int, *key: int) -> int:
    """A 63-bit generator seed for ``(seed, *key)``: different keys give
    independent streams, and seeds above 2**32 are taken whole."""
    ss = np.random.SeedSequence([seed % (1 << 64), *key])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def order(traffic: dict, seed: int) -> list:
    """The order, drawn from the seed, in which the caller takes the pool's
    captures; the window cycles through it."""
    rng = np.random.default_rng(_seed_state(seed, 1))
    return [int(i) for i in rng.permutation(int(traffic["pool"]))]


def keep_phase(seed: int) -> int:
    """The offset, drawn from the seed, of the calls whose outputs the
    window keeps (:class:`Keeper`)."""
    return int(np.random.default_rng(_seed_state(seed, 2)).integers(1 << 20))


def _components(signal: dict, rng: np.random.Generator):
    """(frequency, amplitude, phase, fm_index, message_frequency,
    message_phase) rows of the narrowband components, frequencies in
    cycles a sample."""
    rows = []
    for _ in range(int(signal.get("tones", 0))):
        lo, hi = signal["tone_amplitude"]
        rows.append((rng.uniform(-0.5, 0.5), rng.uniform(lo, hi),
                     rng.uniform(0, 2 * math.pi), 0.0, 0.0, 0.0))
    carriers = int(signal.get("fm_carriers", 0))
    if carriers:
        grid = int(signal["fm_grid"])
        lo, hi = signal["fm_amplitude"]
        fdev = float(signal["fm_deviation"]) / grid
        fmsg = float(signal["fm_message"]) / grid
        for ch in rng.choice(grid, size=carriers, replace=False):
            centre = ((int(ch) + grid // 2) % grid - grid // 2) / grid
            f = fmsg * rng.uniform(0.5, 1.5)
            rows.append((centre, rng.uniform(lo, hi),
                         rng.uniform(0, 2 * math.pi), fdev / f, f,
                         rng.uniform(0, 2 * math.pi)))
    return rows


def capture(traffic: dict, seed: int, k: int, device) -> tuple:
    """Capture ``k`` of ``seed``: its (re, im) float32 planes of
    ``traffic["samples"]`` on ``device``, made there."""
    n = int(traffic["samples"])
    signal = traffic["signal"]
    gen = torch.Generator(device=device)
    gen.manual_seed(_seed_state(seed, 3, k))
    planes = torch.randn((2, n), generator=gen, device=device,
                         dtype=torch.float32)
    planes *= float(signal["noise_rms"])
    rng = np.random.default_rng(_seed_state(seed, 4, k))
    rows = _components(signal, rng)
    if rows:
        # the turns of each phase reduced mod 1 in float64, so that they
        # stay exact over 2^24 samples; the rest in float32
        t = torch.arange(n, dtype=torch.float64, device=device)
        for f, a, ph, beta, fm, phm in rows:
            arg = torch.remainder(t * f, 1.0).to(torch.float32)
            arg.mul_(2 * math.pi).add_(ph)
            if beta:
                msg = torch.remainder(t * fm, 1.0).to(torch.float32)
                arg.add_(torch.sin(msg.mul_(2 * math.pi).add_(phm)),
                         alpha=beta)
            planes[0].add_(torch.cos(arg), alpha=a)
            planes[1].add_(torch.sin(arg), alpha=a)
        del t
    return planes[0], planes[1]


class Keeper:
    """The outputs of a sample of the window's calls, for the check: the
    calls ``i`` with ``i % stride == phase % stride``, ``stride`` a power of
    two that doubles whenever more than ``cap`` are held, so that the
    sample spans the whole window however many calls it holds."""

    def __init__(self, cap: int, phase: int):
        self.cap, self.phase, self.stride = int(cap), int(phase), 1
        self.kept = {}

    def offer(self, i: int, out) -> None:
        if i % self.stride != self.phase % self.stride:
            return
        self.kept[i] = out
        if len(self.kept) > self.cap:
            self.stride *= 2
            self.kept = {j: o for j, o in self.kept.items()
                         if j % self.stride == self.phase % self.stride}
