"""Plain reference of the multichannel 44.1 -> 48 kHz sample-rate
conversion, and the comparison that decides whether the program's output
is correct.

The capture's two planes are viewed as ``channels`` rows of real samples,
as the entry views them.  Each channel is resampled by the rational factor
P/Q with the upstream crate's ``interpolatef`` (interpolation.rs:387-482)
against the sinc pulse ``sin(pi x) / (pi x)`` over 2L + 1 taps::

    center = i Q / P;  r = floor(center);  frac = center - r
    out[i] = sum_{t=0..2L} x[r - L + t] * sinc(t - L - frac)

with x zero before the capture and after it: the linear resample.  With
i = k P + p, r = k Q + offs[p] and frac = frac[p], offs[p] = (p Q) // P and
frac[p] = (p Q mod P) / P, so every output of phase p takes the same taps.
A stream carries a tail of T samples between chunks, which delays its
concatenated output by D = (T - L) / Q * P samples (D / P * Q = T - L input
samples); T is the band reach of the streaming resampler's documented
contract: the larger of 2L and W - 128, W = 128 ceil((128 Q + 2L) / 128),
rounded up so that (T - L) % Q == 0 (20480 samples of delay at 160/147,
L = 10).  So the stream's output is the resample of the capture prefixed
with T - L zeros, which is what this computes, in blocks of output blocks,
each tap's strided slice of the channels at once: in float64 (the
reference) or with every product's operands in TF32 (the control).  It
imports nothing of the program.
"""
from __future__ import annotations

import math
from fractions import Fraction

import torch

from dspbench import plain

BLOCKS_A_STEP = 512      # output blocks of P outputs a step


def tail_len(P: int, Q: int, L: int) -> int:
    """T, the samples a stream carries between chunks (module docstring)."""
    W = 128 * -(-(128 * Q + 2 * L) // 128)
    T0 = max(2 * L, W - 128)
    return T0 + (L - T0) % Q


def constants(cfg: dict, n: int, device) -> dict:
    """The geometry and the float64 taps, built from the definition:
    ``taps`` (P, 2L + 1), ``offs`` (P,), ``P``, ``Q``, ``L``, ``delay``
    (input samples of zeros before the capture)."""
    f = Fraction(cfg["factor"])
    P, Q, L = f.numerator, f.denominator, int(cfg["conv_len"])
    p = torch.arange(P, dtype=torch.int64)
    frac = ((p * Q) % P).to(torch.float64) / P
    x = (torch.arange(2 * L + 1, dtype=torch.float64)[None, :] - L
         - frac[:, None])
    taps = torch.where(x == 0, torch.ones_like(x),
                       torch.sin(math.pi * x) / (math.pi * x))
    return {"taps": taps.to(device), "offs": ((p * Q) // P).to(device),
            "P": P, "Q": Q, "L": L, "delay": tail_len(P, Q, L) - L}


def resample(consts: dict, x: torch.Tensor,
             precision: str = "float64") -> torch.Tensor:
    """The stream's output for the (C, n) channels ``x`` (n % Q == 0), from
    a zero tail: (C, n / Q * P), each product's operands in
    ``precision``."""
    P, Q, L, D = consts["P"], consts["Q"], consts["L"], consts["delay"]
    C, n = x.shape
    if n % Q:
        raise ValueError(f"{n} samples a channel are not whole blocks of "
                         f"{Q}")
    K = n // Q
    taps = plain.operand(consts["taps"], precision)
    offs = consts["offs"].to(x.device)
    # z[j] = x[j - D - L], so out[k P + p] = sum_t taps[p, t]
    # z[k Q + offs[p] + t]
    z = torch.nn.functional.pad(plain.operand(x, precision), (D + L, 0))
    out = torch.empty((C, K, P), dtype=z.dtype, device=z.device)
    for k0 in range(0, K, BLOCKS_A_STEP):
        k1 = min(K, k0 + BLOCKS_A_STEP)
        acc = None
        for t in range(taps.shape[-1]):
            rows = z[:, k0 * Q + t:k1 * Q + t].reshape(C, k1 - k0, Q)
            term = rows[:, :, offs] * taps[:, t]
            acc = term if acc is None else acc + term
        out[:, k0:k1] = acc
    return out.reshape(C, K * P)


def reference(cfg: dict, consts: dict, xr: torch.Tensor, xi: torch.Tensor,
              precision: str = "float64"):
    """The (channels, n / Q * P) output of streaming the capture (xr, xi),
    its planes viewed as channels (re plane first), from a zero tail, in
    ``precision`` (``plain.PRECISIONS``); a 1-tuple, as the comparison
    takes it."""
    x = torch.stack([xr, xi]).reshape(int(cfg["channels"]), -1)
    return (resample(consts, x, precision),)


def errors(out: torch.Tensor, ref: tuple) -> dict:
    """The numbers the check compares: each channel's widest gap between
    the program's output and the reference's, over that channel's
    reference peak, the largest over channels; a non-finite output or one
    of the wrong shape reads inf."""
    want = ref[0].to(torch.float64)
    got = out.to(torch.float64)
    if got.shape != want.shape:
        return {"out_max_rel_err": math.inf}
    gap = (got - want).abs().amax(dim=-1) / want.abs().amax(dim=-1)
    err = float(gap.max())
    return {"out_max_rel_err": err if math.isfinite(err) else math.inf}
