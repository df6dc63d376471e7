"""Plain reference of the multi-carrier IQ pulse shaper, and the
comparison that decides whether the program's output is correct.

The capture's two planes are mapped to QPSK symbols, ``0.5 (sign(xr) + i
sign(xi))``, and viewed as ``carriers`` rows of complex symbols, as the
entry maps them.  Each carrier is interpolated by the integer factor P
(Q = 1) with the upstream crate's ``interpolatef`` (interpolation.rs:
387-482) against the raised-cosine pulse of roll-off b over 2L + 1 taps::

    rc(x) = sinc(x) cos(pi b x) / (1 - (2 b x)^2),  sinc(x) = sin(pi x) / (pi x)
    out[k P + p] = sum_{t=0..2L} z[k - L + t] * rc(t - L - p / P)

with rc(0) = 1 and, at |x| = 1 / (2 b), the limit pi / 4 sinc(1 / (2 b))
(at P = 10 and b = 0.35 no tap falls there), and z zero before the
capture and after it: the linear resample, the real taps applied to the
real and the imaginary plane alike.  A stream carries a tail of T samples
between chunks (``references/audio_src_madi.tail_len``), so its output
is the resample of the symbols prefixed with T - L zeros, which is what
this computes with ``references/audio_src_madi.resample``, in blocks:
in float64 (the reference) or with every product's operands in TF32 (the
control).  It imports nothing of the program.
"""
from __future__ import annotations

import math
from fractions import Fraction

import torch

from dspbench.references import audio_src_madi as polyphase


def rc_taps(P: int, L: int, rolloff: float) -> torch.Tensor:
    """The (P, 2L + 1) float64 raised-cosine taps rc(t - L - p / P)."""
    p = torch.arange(P, dtype=torch.float64)
    x = (torch.arange(2 * L + 1, dtype=torch.float64)[None, :] - L
         - p[:, None] / P)
    b = float(rolloff)
    arg = 2.0 * b * x
    pole = (arg.abs() - 1.0).abs() < 1e-12
    safe = torch.where((x == 0) | pole, torch.ones_like(x), x)
    sinc = torch.sin(math.pi * safe) / (math.pi * safe)
    general = sinc * torch.cos(math.pi * b * safe) / torch.where(
        pole, torch.ones_like(x), 1.0 - arg * arg)
    xp = 1.0 / (2.0 * b)
    limit = math.pi / 4.0 * math.sin(math.pi * xp) / (math.pi * xp)
    return torch.where(x == 0, torch.ones_like(x),
                       torch.where(pole, torch.full_like(x, limit), general))


def constants(cfg: dict, n: int, device) -> dict:
    """The geometry and the float64 taps, built from the definition:
    ``taps`` (P, 2L + 1), ``offs`` (P,), ``P``, ``Q`` (1), ``L``,
    ``delay`` (input samples of zeros before the capture)."""
    f = Fraction(cfg["factor"])
    P, Q, L = f.numerator, f.denominator, int(cfg["conv_len"])
    if Q != 1:
        raise ValueError(f"modulation_rc interpolates by an integer, not "
                         f"{f}")
    return {"taps": rc_taps(P, L, cfg["rolloff"]).to(device),
            "offs": torch.zeros(P, dtype=torch.int64, device=device),
            "P": P, "Q": Q, "L": L,
            "delay": polyphase.tail_len(P, Q, L) - L}


def symbols(xr: torch.Tensor, xi: torch.Tensor, carriers: int):
    """The (carriers, n) QPSK symbols of the capture's planes, as the
    (re, im) float64 planes."""
    return (0.5 * torch.sign(xr.to(torch.float64)).reshape(carriers, -1),
            0.5 * torch.sign(xi.to(torch.float64)).reshape(carriers, -1))


def reference(cfg: dict, consts: dict, xr: torch.Tensor, xi: torch.Tensor,
              precision: str = "float64"):
    """The (carriers, n P) complex output of streaming the capture's
    symbols from a zero tail, each product's operands in ``precision``
    (``plain.PRECISIONS``); a 1-tuple, as the comparison takes it."""
    C = int(cfg["carriers"])
    re, im = symbols(xr, xi, C)
    out = polyphase.resample(consts, torch.cat([re, im]), precision)
    return (torch.complex(out[:C], out[C:]),)


def errors(out: torch.Tensor, ref: tuple) -> dict:
    """The numbers the check compares: each carrier's widest |gap| between
    the program's complex output and the reference's, over that carrier's
    reference peak |z|, the largest over carriers; a non-finite output or
    one of the wrong shape or not complex reads inf."""
    want = ref[0].to(torch.complex128)
    if out.shape != want.shape or not out.is_complex():
        return {"out_max_rel_err": math.inf}
    got = out.to(torch.complex128)
    gap = (got - want).abs().amax(dim=-1) / want.abs().amax(dim=-1)
    err = float(gap.max())
    return {"out_max_rel_err": err if math.isfinite(err) else math.inf}
