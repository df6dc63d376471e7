"""Plain reference of the FIR + FFT spectrum chain, and the comparison
that decides whether the program's spectra are correct.

The chain: the centered circular FIR of a complex capture x (n samples)
with m real taps h, c = m - m // 2,

    y[i] = sum_k h[k] x[(i + c - 1 - k) mod n],

then the window w, then |fftshift(DFT(y w))|.  Computed here as the
definition reads: the FIR as m shifted copies of x, the DFT by matrix
products (``plain.dft``), in float64 (the reference) or with every
product's operands in TF32 (the control).  It imports nothing of the
program and takes nothing the program made: the Toeplitz bands, DFT planes
and twiddles the program derives are derived here again from the taps,
the window and the length.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from dspbench import plain


def _raised_cosine(t: np.ndarray, rolloff: float) -> np.ndarray:
    """sinc(t) cos(pi r t) / (1 - (2 r t)^2), its limits at t = 0 and at
    |2 r t| = 1 patched in."""
    arg = 2.0 * rolloff * t
    pole = np.abs(np.abs(arg) - 1.0) < 1e-12
    safe = np.where(pole, 0.0, t)
    out = np.sinc(safe) * np.cos(math.pi * rolloff * safe) / np.where(
        pole, 1.0, 1.0 - arg * arg)
    return np.where(pole, math.pi / 4.0 * np.sinc(1.0 / (2.0 * rolloff)),
                    out)


def constants(cfg: dict, n: int, device) -> dict:
    """The chain's inputs besides the capture, made by the benchmark and
    handed alike to the program and to the reference: the taps
    (raised cosine at t = (k - m/2) * spacing, normalised to unit sum) and
    the generalized Hamming window of n points, as float32."""
    m = int(cfg["taps"])
    t = (np.arange(m) - m // 2) * float(cfg["tap_spacing"])
    h = _raised_cosine(t, float(cfg["rolloff"]))
    h /= h.sum()
    a = float(cfg["window_alpha"])
    w = a - (1.0 - a) * np.cos(2.0 * math.pi * np.arange(n) / (n - 1.0))
    return {"taps": torch.tensor(h, dtype=torch.float32, device=device),
            "window": torch.tensor(w, dtype=torch.float32, device=device)}


def reference(cfg: dict, consts: dict, xr: torch.Tensor, xi: torch.Tensor,
              precision: str = "float64"):
    """The (n,) magnitude spectrum of the chain on the capture (xr, xi),
    in ``precision`` (``plain.PRECISIONS``); a 1-tuple, as the comparison
    takes it."""
    h = consts["taps"]
    m, n = h.shape[-1], xr.shape[-1]
    c = m - m // 2
    xr, xi = plain.operand(xr, precision), plain.operand(xi, precision)
    hk = plain.operand(h, precision)
    yr = torch.zeros_like(xr)
    yi = torch.zeros_like(xi)
    for k in range(m):
        s = (k - (c - 1)) % n            # y[i] += h[k] x[i - s]
        yr += hk[k] * torch.roll(xr, s)
        yi += hk[k] * torch.roll(xi, s)
    w = plain.operand(consts["window"], precision)
    yr = plain.operand(yr, precision) * w
    yi = plain.operand(yi, precision) * w
    Xr, Xi = plain.dft(yr, yi, precision)
    Xr, Xi = torch.roll(Xr, n // 2), torch.roll(Xi, n // 2)
    return (torch.sqrt(Xr * Xr + Xi * Xi),)


def errors(out: torch.Tensor, ref: tuple) -> dict:
    """The numbers the check compares: the widest gap between the
    program's spectrum and the reference's, over the reference's peak
    (a non-finite output reads inf)."""
    spec = ref[0].to(torch.float64)
    got = out.to(torch.float64)
    if got.shape != spec.shape:
        return {"spectrum_max_rel_err": math.inf}
    gap = torch.abs(got - spec).max() / spec.abs().max()
    gap = float(gap)
    return {"spectrum_max_rel_err": gap if math.isfinite(gap) else math.inf}
