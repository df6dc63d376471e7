"""The least time the card could take for a piece of work: the roofline
arithmetic of the benchmark, frozen here so that the yardstick does not
move with the program.

Peaks are NVIDIA's published figures for one H100 SXM at 700 W: 3.35 TB/s
of HBM3 and 67 TFLOP/s of FP32 outside the tensor cores (the program runs
float32 with TF32 off).  A floor counts each input byte read once and each
output byte written once, and the operations of the cheapest algorithm
known for the work (a FIR the fewer of the direct sum's and
overlap-save's), so that it counts the same work whatever implements it.
"""
from __future__ import annotations

import math

PEAK_BYTES = 3.35e12   # H100 SXM HBM3, bytes/s
PEAK_FP32 = 67e12      # H100 SXM FP32 outside the tensor cores, FLOP/s


def fft_flops(n: int, real: bool = False) -> float:
    """5 n log2 n for a complex FFT of n points, half of it for a real
    input."""
    return (2.5 if real else 5.0) * n * math.log2(n)


def fir_flops(m: int, complex_taps: bool = False) -> float:
    """The floating-point operations an output sample of an m-tap FIR on
    complex data needs: the fewer of the direct sum's (4 m for real taps,
    8 m for complex ones) and overlap-save's at its best power-of-two
    length N > m (a complex FFT and its inverse, 5 N log2 N each, and the
    product by the taps' transform, made once, 6 a bin, over the N - m + 1
    outputs of a block)."""
    direct = (8.0 if complex_taps else 4.0) * m
    blocks = (1 << k for k in range(m.bit_length(), m.bit_length() + 16))
    return min(direct, *((2 * fft_flops(N) + 6.0 * N) / (N - m + 1)
                         for N in blocks))


def floor_ms(nbytes: float, flops: float):
    """``(floor_ms, bound, bytes_ms, flops_ms)``: the least time the work
    could take, the larger of ``nbytes`` over PEAK_BYTES and ``flops`` over
    PEAK_FP32, and which of the two binds ("bytes" or "operations")."""
    bt = nbytes / PEAK_BYTES * 1e3
    ft = flops / PEAK_FP32 * 1e3
    return max(bt, ft), ("bytes" if bt >= ft else "operations"), bt, ft


def share_pct(nbytes: float, flops: float, device_ms: float):
    """The floor of the work as a percentage of ``device_ms``, the time
    the device took for it; None where no time was read."""
    if not device_ms or device_ms <= 0:
        return None
    return 100.0 * floor_ms(nbytes, flops)[0] / device_ms
