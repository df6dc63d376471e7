"""The flagship benchmark: Msamples/s of the FIR + FFT spectrum chain on the
card (twin of the JAX repository's ``bench.py``).

The workload is the reference's: 2^22 complex samples from numpy's
``default_rng(0)``, 128 raised-cosine taps (rolloff 0.35 at t = (k - 64) *
0.25, unit DC gain, which keeps the feedback loop stable) and a Hamming
window.  The chain is :class:`pipelines.FirFftChainPlanar`, which holds its
constants (the Toeplitz bands, the window, the DFT and twiddle planes) on
the card, as the reference closes over them as constants of its jitted
loop.  Each iteration scales the signal by the previous spectrum on the
way in and carries the whole spectrum times 1e-3, so every output
element is live.

The loop is captured in a CUDA graph and replayed, the twin of the
reference's loop inside ``jit``; the time an iteration is the slope
between a loop of 50 and one of 150, pairs measured back to back, the
median over 15 pairs (``timing.slope``).  The timed iterations run back to
back with nothing flushed: each reads the L2 that the one before left.

The four-step split is n1 = 128; ``BENCH_FUSED=1`` (environment) runs
stage 1 and the row stage as one kernel (K2).

Prints one JSON line on stdout, ``{"metric": "fir_fft_chain_throughput",
"value", "unit": "Msamples/s", "vs_baseline"}``, ``vs_baseline`` the floor
over the measured time (1.0 would be the card's bound).  stderr holds the
pair slopes, the floor's two halves, the knobs, the kernels one call
launched, the card and what the L2 held.

    python3 bench_torch.py [--device cpu]

runs on the card, and without one exits non-zero unless ``--device cpu``
asks for a rehearsal at 2^15 samples, whose line carries ``"device":
"cpu"`` and no throughput.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys

import numpy as np
import torch

from dspbench import floors

from .. import config, pipelines
from ..conv_types import RaisedCosineFunction
from ..kernels import spectrum_cuda
from ..ops import conv_ops
from ..windows import HammingWindow
from . import timing

N = 1 << 22
CPU_N = 1 << 15
TAPS = 128
N1 = 128
ITERS, PAIRS = 50, 15
CPU_ITERS, CPU_PAIRS = 2, 3
KNOBS = config.DspConfig()


def workload(n: int, device):
    """(x_re, x_im, taps, window) of the reference's bench on ``device``:
    numpy seed 0, float32."""
    rng = np.random.default_rng(0)
    x_re = rng.normal(size=n).astype(np.float32)
    x_im = rng.normal(size=n).astype(np.float32)
    t = ((np.arange(TAPS) - TAPS // 2) * 0.25).astype(np.float32)
    taps = RaisedCosineFunction(0.35).calc(torch.from_numpy(t)).numpy()
    taps = taps.astype(np.float32)
    taps /= taps.sum()
    window = HammingWindow().sample(n, dtype=torch.float32, device=device)
    return (torch.from_numpy(x_re).to(device),
            torch.from_numpy(x_im).to(device),
            torch.from_numpy(taps).to(device), window)


def chain_loop(chain, xr, xi):
    """``loop(k)``: k iterations of the chain, each scaling the signal by
    the carry on the way in, the carry the spectrum times 1e-3."""
    n = xr.shape[-1]

    def loop(k):
        fb = torch.zeros(n, dtype=torch.float32, device=xr.device)
        for _ in range(k):
            fb = chain(xr * (1.0 + fb * 1e-30), xi) * 1e-3
        return fb
    return loop


def work(n: int, m: int):
    """(bytes, flops) the chain needs for a call: the planes, the window
    and the taps read once, the spectrum and the carry written once; the
    FIR of real taps on complex data (``floors.fir_flops``: overlap-save's
    count at these sizes), the window (2 a sample), an FFT (5 log2 n) and
    the magnitude (3)."""
    nbytes = 8 * n + 4 * n + 4 * m + 4 * n + 4 * n
    flops = (floors.fir_flops(m) + 2 + 5 * math.log2(n) + 3) * n
    return nbytes, flops


def formulation_flops(n: int, m: int, n1: int, fused: bool) -> dict:
    """The FLOPs the port's formulation runs, by stage: the Toeplitz FIR's
    matmuls (2 planes x 128-wide bands, each sample against every band),
    stage 1 as column FFTs where ``spectrum_cuda.stage1_supported`` takes
    the geometry (K8, or K2's panels), else as K2's direct sum or the
    three Karatsuba matmuls (K2 adds its twiddle), the row stage's FFTs,
    twiddle and magnitude."""
    n2 = n // n1
    _, m_eff, _ = conv_ops._clip_kernel(n, m)
    shifts = -(-(m_eff + 127) // 128)
    if spectrum_cuda.stage1_supported(n1, n2):
        stage1 = 5 * n * math.log2(n1)
    else:
        stage1 = 8 * n1 * n if fused else 3 * 2 * n1 * n
    stage1 += 6 * n if fused else 0
    return {"toeplitz": 2 * shifts * 2 * 128 * n, "stage1": stage1,
            "rows": 5 * n * math.log2(n2) + 6 * n + 3 * n}


def _log(*parts):
    print("#", *parts, file=sys.stderr, flush=True)


def main(argv=None, env=None) -> dict:
    """Runs the benchmark, prints its line, and returns its record (the
    line's keys and the measurements behind them)."""
    ap = argparse.ArgumentParser(prog="bench_torch.py",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="cpu for a rehearsal on the CPU (default: the card)")
    args = ap.parse_args(argv)
    dev = timing.device_of(args.device, "bench_torch.py")
    fused = (os.environ if env is None else env).get("BENCH_FUSED") == "1"
    on_card = dev.type == "cuda"
    n = N if on_card else CPU_N
    iters, pairs = (ITERS, PAIRS) if on_card else (CPU_ITERS, CPU_PAIRS)
    config.set_default_config(KNOBS)

    xr, xi, taps, window = workload(n, dev)
    chain = pipelines.FirFftChainPlanar(taps, window, n1=N1, fused=fused)
    loop = chain_loop(chain, xr, xi)
    card = timing.card_line(dev)
    _log(f"card: {card}; torch {torch.__version__}, CUDA "
         f"{torch.version.cuda}")
    _log(f"knobs: {dataclasses.asdict(KNOBS)}; n1 {chain.n1} x n2 "
         f"{chain.n2}, fused {fused}; numeric mode {timing.NUMERIC_MODE}: "
         f"{timing.tf32_off()}")
    launched = timing.launches(lambda: loop(1))
    _log(f"kernels one call launched: {launched}")
    if on_card:
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        loop(1)
        torch.cuda.synchronize()
        peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
        l2 = getattr(torch.cuda.get_device_properties(dev), "L2_cache_size",
                     0) / 2 ** 20
        _log(f"L2 {l2:.0f} MiB: the {8 * n / 2 ** 20:.0f} MiB input planes "
             f"fit, but a call allocates {peak:.1f} MiB of intermediates, "
             f"so little of the input is still there when the next call "
             f"reads it; the timed calls run back to back with no flush "
             f"(a warm L2, the steady state of the reference's loop)")

    def log(t1, t3, s):
        _log(f"slope {s * 1e3:.4f} ms/iter from t({iters})={t1 * 1e3:.2f} "
             f"ms, t({3 * iters})={t3 * 1e3:.2f} ms")

    t = timing.timed_loop(loop, dev, iters, pairs, log)
    if on_card and t.graph is None:
        raise SystemExit(f"bench: the chain's loop did not capture into a "
                         f"CUDA graph: {t.no_graph}")
    sec = t.graph if on_card else t.eager
    spread = t.graph_spread if on_card else t.eager_spread
    _log(f"median of {pairs} pairs: {sec * 1e3:.4f} ms/iter "
         f"({'graph replay' if on_card else 'eager, CPU'}; spread "
         f"{spread:.3f}x); eager loop {t.eager * 1e3:.4f} ms/iter")

    nbytes, flops = work(n, TAPS)
    fl, bound, bms, fms = floors.floor_ms(nbytes, flops)
    form = formulation_flops(n, TAPS, chain.n1, fused)
    _log(f"floor: bytes {nbytes / 2 ** 20:.1f} MiB -> {bms:.4f} ms at "
         f"{floors.PEAK_BYTES / 1e12} TB/s, operations {flops / 1e9:.3f} "
         f"GFLOP -> {fms:.4f} ms at {floors.PEAK_FP32 / 1e12:.0f} TFLOP/s "
         f"({timing.NUMERIC_MODE}): bound by {bound}, floor {fl:.4f} ms; "
         f"the formulation runs {sum(form.values()) / 1e9:.3f} GFLOP ("
         + ", ".join(f"{k} {v / 1e9:.3f}" for k, v in form.items())
         + f"); measured {sec * 1e3:.4f} ms")
    record = {"metric": "fir_fft_chain_throughput"}
    if on_card:
        record.update({"value": round(n / sec / 1e6, 2),
                       "unit": "Msamples/s",
                       "vs_baseline": round(fl / (sec * 1e3), 4)})
    else:
        record.update({"device": "cpu", "n": n,
                       "rehearsal_ms": round(sec * 1e3, 4)})
    print(json.dumps(record), flush=True)
    record.update({"card": card, "graph_ms": None if t.graph is None
                   else t.graph * 1e3, "eager_ms": t.eager * 1e3,
                   "spread": spread, "floor_ms": fl, "bound": bound,
                   "bytes_ms": bms, "flops_ms": fms, "launches": launched,
                   "fused": fused, "knobs": dataclasses.asdict(KNOBS)})
    return record


if __name__ == "__main__":
    main()
