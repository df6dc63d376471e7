"""Plain reference of the polyphase channelizer with per-channel FM
demodulation, and the comparison that decides whether the program's
angles are correct.

With C channels and a real prototype h of m = t C taps, channel k of a
complex capture x, decimated by C, is

    y[s, k] = sum_j h[j] exp(-2 pi i j k / C) x[s C - j]   (x[<0] = 0),

computed as the polyphase split reads it: u[s, q] = sum_r h[r C + q]
x[(s - r) C - q] for each phase q, then a DFT over q (``plain.dft``).  The
demodulator's output is angle(y[s, k] conj(y[s - 1, k])) with y[-1] = 0,
stored channel-major, (C, S).  In float64 (the reference) or with every
product's operands in TF32 (the control).  It imports nothing of the
program, and derives the merged tap rows the program holds from the
prototype again.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from dspbench import plain


def constants(cfg: dict, n: int, device) -> dict:
    """The prototype, made by the benchmark and handed alike to the
    program and to the reference: a Hamming window of ``channels *
    taps_per_phase`` points over ``channels``, as float32."""
    C = int(cfg["channels"])
    m = C * int(cfg["taps_per_phase"])
    h = np.hamming(m) / C
    return {"prototype": torch.tensor(h, dtype=torch.float32,
                                      device=device)}


def _filterbank(xr, xi, h, C: int, precision: str):
    """(S, C) planes of u[s, q] = sum_r h[r C + q] x[(s - r) C - q]."""
    n = xr.shape[-1]
    S, t = n // C, h.shape[-1] // C
    xr, xi = plain.operand(xr, precision), plain.operand(xi, precision)
    h = plain.operand(h, precision).reshape(t, C)
    s = torch.arange(S, device=xr.device)[:, None]
    q = torch.arange(C, device=xr.device)[None, :]
    ur = torch.zeros((S, C), dtype=xr.dtype, device=xr.device)
    ui = torch.zeros_like(ur)
    for r in range(t):
        idx = (s - r) * C - q
        live = idx >= 0
        idx = idx.clamp(min=0)
        ur += torch.where(live, h[r] * xr[idx], 0.0)
        ui += torch.where(live, h[r] * xi[idx], 0.0)
    return ur, ui


def reference(cfg: dict, consts: dict, xr: torch.Tensor, xi: torch.Tensor,
              precision: str = "float64"):
    """(angles, |z|): the (C, S) demodulated angles in ``precision`` and
    the magnitude of z = y[s] conj(y[s - 1]) whose angle they are, which
    the comparison weighs a gap by."""
    C = int(cfg["channels"])
    ur, ui = _filterbank(xr, xi, consts["prototype"], C, precision)
    yr, yi = plain.dft(ur, ui, precision)                 # (S, C)
    del ur, ui
    pr = torch.cat([torch.zeros_like(yr[:1]), yr[:-1]])
    pi = torch.cat([torch.zeros_like(yi[:1]), -yi[:-1]])   # conj(y[s-1])
    zr, zi = plain.cmul(yr, yi, pr, pi, precision)
    del yr, yi, pr, pi
    mag = torch.sqrt(zr * zr + zi * zi)
    ang = torch.where(mag > 0, torch.atan2(zi, zr), 0.0)   # angle(0) = 0
    return ang.T.contiguous(), mag.T.contiguous()


def errors(out: torch.Tensor, ref: tuple) -> dict:
    """The numbers the check compares: the widest gap between the
    program's angle and the reference's, wrapped to (-pi, pi] and weighed
    by |z| over the largest |z| of its channel, so that a gap counts by
    how far z turned in units of the channel's own scale: an angle whose
    |z| is near 0 turns far under float32 rounding alone while z moves no
    more than elsewhere.  Where the reference's z is exactly 0 (each
    channel's first sample, whose look-back is the zero before the
    capture) the angle says nothing and weighs nothing.  A non-finite
    output reads inf."""
    ang, mag = (r.to(torch.float64) for r in ref)
    got = out.to(torch.float64)
    if got.shape != ang.shape or not bool(torch.isfinite(got).all()):
        return {"angle_weighted_err": math.inf}
    gap = torch.remainder(got - ang + math.pi, 2 * math.pi) - math.pi
    scale = mag.max(dim=-1, keepdim=True).values
    w = mag / torch.where(scale > 0, scale, 1.0)
    err = float((gap.abs() * w).max())
    return {"angle_weighted_err": err if math.isfinite(err) else math.inf}
