"""Plain reference of the GPS L1 C/A matched-filter bank, and the
comparison that decides whether the program's correlations are correct.

The C/A code of a PRN (IS-GPS-200, 3.3.2.3) is G1 xor a delayed G2, each a
10-stage shift register started at all ones, G1 = 1 + x^3 + x^10 and G2 =
1 + x^2 + x^3 + x^6 + x^8 + x^9 + x^10, the delay formed as the xor of the
two G2 stages of the PRN's row of Table 3-Ia; 1023 chips a period.  A chip
of value 0 is +1, of value 1 is -1.  The replica of a PRN at s samples a
chip holds each chip s times (m = 1023 s samples); the bank's taps are the
replicas time-reversed, so that the filter's output

    y[p, i] = sum_k h[p, k] x[i - k]   (x[<0] = 0)

is the correlation of the capture with replica p ending at sample i.  It is
computed here as that direct sum, in blocks of outputs, each block's
windows of the capture against every row at once: in float64 (the
reference) or with every product's operands in TF32 (the control).  It
imports nothing of the program.
"""
from __future__ import annotations

import math

import torch

from dspbench import plain

# Table 3-Ia: the two G2 stages whose xor gives each PRN's delayed G2
G2_TAPS = {1: (2, 6), 2: (3, 7), 3: (4, 8), 4: (5, 9), 5: (1, 9),
           6: (2, 10), 7: (1, 8), 8: (2, 9), 9: (3, 10), 10: (2, 3),
           11: (3, 4), 12: (5, 6), 13: (6, 7), 14: (7, 8), 15: (8, 9),
           16: (9, 10), 17: (1, 4), 18: (2, 5), 19: (3, 6), 20: (4, 7),
           21: (5, 8), 22: (6, 9), 23: (1, 3), 24: (4, 6), 25: (5, 7),
           26: (6, 8), 27: (7, 9), 28: (8, 10), 29: (1, 6), 30: (2, 7),
           31: (3, 8), 32: (4, 9)}

OUTPUTS_A_BLOCK = 1 << 14


def ca_code(prn: int, chips: int = 1023) -> list:
    """The first ``chips`` chips (0 or 1) of the C/A code of ``prn``."""
    s1, s2 = G2_TAPS[prn]
    g1, g2 = [1] * 10, [1] * 10
    out = []
    for _ in range(chips):
        out.append(g1[9] ^ g2[s1 - 1] ^ g2[s2 - 1])
        f1 = g1[2] ^ g1[9]
        f2 = g2[1] ^ g2[2] ^ g2[5] ^ g2[7] ^ g2[8] ^ g2[9]
        g1, g2 = [f1] + g1[:9], [f2] + g2[:9]
    return out


def replicas(prns, samples_per_chip: int, chips: int = 1023) -> torch.Tensor:
    """(P, chips * samples_per_chip) float64 replicas of +-1."""
    codes = torch.tensor([ca_code(p, chips) for p in prns],
                         dtype=torch.float64)
    return (1.0 - 2.0 * codes).repeat_interleave(samples_per_chip, dim=-1)


def constants(cfg: dict, n: int, device) -> dict:
    """The bank's taps, made by the benchmark and handed alike to the
    program and to the reference: each PRN's replica time-reversed, (P, m)
    float32 of +-1."""
    r = replicas(cfg["prns"], int(cfg["samples_per_chip"]),
                 int(cfg["chips"]))
    return {"taps": r.flip(-1).to(torch.float32).to(device)}


def reference(cfg: dict, consts: dict, xr: torch.Tensor, xi: torch.Tensor,
              precision: str = "float64"):
    """The (P, n) complex correlations of the capture (xr, xi) with every
    replica, the direct sum in ``precision`` (``plain.PRECISIONS``); a
    1-tuple, as the comparison takes it."""
    h = plain.operand(consts["taps"], precision)          # (P, m)
    P, m = h.shape
    n = xr.shape[-1]
    x = torch.stack([plain.operand(xr, precision),
                     plain.operand(xi, precision)])       # (2, n)
    x = torch.nn.functional.pad(x, (m - 1, 0))            # x[<0] = 0
    hf = h.flip(-1).T.contiguous()                        # (m, P)
    y = torch.empty((2, n, P), dtype=x.dtype, device=x.device)
    for s in range(0, n, OUTPUTS_A_BLOCK):
        e = min(n, s + OUTPUTS_A_BLOCK)
        # windows[c, i, j] = x[c, s + i + j - (m - 1)]
        windows = x[:, s:e + m - 1].unfold(-1, m, 1)
        y[:, s:e] = windows @ hf
    return (torch.complex(y[0].T, y[1].T),)


def errors(out: torch.Tensor, ref: tuple) -> dict:
    """The numbers the check compares: the widest gap between the
    program's correlations and the reference's in each row, over that
    row's peak magnitude, the largest over rows; a non-finite output or
    one of the wrong shape reads inf."""
    want = ref[0].to(torch.complex128)
    got = out.to(torch.complex128)
    if got.shape != want.shape:
        return {"corr_max_rel_err": math.inf}
    gap = (got - want).abs().amax(dim=-1) / want.abs().amax(dim=-1)
    err = float(gap.max())
    return {"corr_max_rel_err": err if math.isfinite(err) else math.inf}
