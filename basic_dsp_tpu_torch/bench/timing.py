"""What the port's benchmark programs share: the slope timer, the floor
model, the health probe and the card line (counterpart of the timing,
floor and probe code of the JAX repository's ``bench.py`` and
``bench_all.py``).

A loop of ``iters`` calls and one of ``3 * iters`` calls are timed back to
back, and the time a call is the slope between them, so the costs paid once
a loop cancel.  Each call's output folds into the carry that the next call
adds to its input, so no call can be skipped or hoisted.  On the card a
loop is timed two ways:

- eager: CUDA events at the two ends of the Python loop, what a caller pays
  for a call, host dispatch included;
- graph: the loop captured once in a CUDA graph and replayed between two
  CUDA events, the twin of the JAX repository's loop inside ``jit``, with
  no host dispatch a call.  A loop that copies from the host or reads a
  value back inside it does not capture; it has no graph time, and the
  first line of the capture's error says why.

On the CPU both loops run under ``time.perf_counter`` and there is no graph
time: a CPU run rehearses the programs and measures nothing of the card.

The floor is the least time the card could take for a call: the larger of
the compulsory bytes (each input read once, each output and the carry
written once) over the H100 SXM's 3.35 TB/s and the floating-point
operations the cheapest algorithm needs (``fir_flops``: a FIR counts the
fewer of the direct sum's and overlap-save's) over its 67 TFLOP/s of FP32
outside the tensor cores (TF32 is off in the port), NVIDIA's published
peaks at 700 W.
"""
from __future__ import annotations

import collections
import math
import time

import torch

from .. import config

PEAK_BYTES = 3.35e12   # H100 SXM HBM3, bytes/s
PEAK_FP32 = 67e12      # H100 SXM FP32 outside the tensor cores, FLOP/s
NUMERIC_MODE = "fp32, TF32 off"

Slope = collections.namedtuple("Slope", "seconds spread")
Slope.__doc__ = """``seconds`` a call: the median of the positive pair
slopes, or with none positive the last 3x loop's time a call (``spread``
then inf); ``spread`` max / min of the positive slopes."""

Timing = collections.namedtuple(
    "Timing", "eager graph eager_spread graph_spread no_graph")
Timing.__doc__ = """Seconds a call of the eager loop and of the CUDA-graph
replay (None on the CPU or where the loop did not capture), the spread of
each, and why the loop did not capture (None where it did, or on the
CPU)."""


def fold(out: torch.Tensor, n: int) -> torch.Tensor:
    """Every element of ``out`` into an n-long float32 carry: |out| padded
    to a multiple of n, summed down the short axis, times 1e-20 (the fold
    of the JAX repository's ``bench_all.timed``)."""
    flat = torch.abs(out.reshape(-1)).to(torch.float32)
    rows = -(-flat.shape[0] // n)
    if rows * n != flat.shape[0]:
        flat = torch.nn.functional.pad(flat, (0, rows * n - flat.shape[0]))
    return flat.reshape(rows, n).sum(dim=0) * 1e-20


def folded_loop(fn, args, n: int):
    """``loop(k)``: k calls of ``fn(*args, carry)``, each output folded
    into the n-long carry of the next; returns the last carry."""
    def loop(k):
        carry = torch.zeros(n, dtype=torch.float32, device=args[0].device)
        for _ in range(k):
            carry = fold(fn(*args, carry), n)
        return carry
    return loop


def eager_seconds(loop, k: int, device: torch.device) -> float:
    """Wall seconds of ``loop(k)``: CUDA events on the card (the host's
    dispatch included), ``time.perf_counter`` on the CPU."""
    if device.type != "cuda":
        t0 = time.perf_counter()
        loop(k)
        return time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    loop(k)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3


class Graphs:
    """``loop(k)`` captured once in a CUDA graph for each k, replayed
    between two CUDA events; ``close`` frees the graphs and their memory
    pools.  The capture leaves the launch counts as they were (the
    wrappers count no launch while a graph is captured)."""

    def __init__(self, loop):
        self.loop = loop
        self.graphs = {}
        self.stream = torch.cuda.Stream()
        self.stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(self.stream):   # warm up where it captures
            loop(2)
        torch.cuda.current_stream().wait_stream(self.stream)

    def seconds(self, k: int) -> float:
        if k not in self.graphs:
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g, stream=self.stream):
                out = self.loop(k)
            self.graphs[k] = (g, out)
            g.replay()
        g = self.graphs[k][0]
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        g.replay()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3

    def close(self):
        self.graphs.clear()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def slope(run, iters: int, pairs: int = 3, log=None) -> Slope:
    """The pair discipline of the JAX repository's ``bench.py``: ``pairs``
    times, ``run(iters)`` and ``run(3 * iters)`` back to back, so that a
    drift of the device's state between the two stays within one pair; the
    median over the positive pair slopes, whose spread is returned.  With
    no positive slope, the last 3x loop's time a call, an upper bound that
    still holds the costs paid once a loop.  ``log(t1, t3, slope)`` is
    called for each pair."""
    positive, t3 = [], None
    for _ in range(pairs):
        t1 = run(iters)
        t3 = run(3 * iters)
        s = (t3 - t1) / (2 * iters)
        if log is not None:
            log(t1, t3, s)
        if s > 0:
            positive.append(s)
    if not positive:
        return Slope(t3 / (3 * iters), float("inf"))
    positive.sort()
    return Slope(positive[len(positive) // 2], positive[-1] / positive[0])


def timed(fn, *args, iters: int = 10, pairs: int = 3) -> Timing:
    """The eager and (on the card) graph slopes of ``fn(*args, carry)``,
    the carry n-long with n the last axis of ``args[0]``, after two
    warm-up loops."""
    n = args[0].shape[-1]
    return timed_loop(folded_loop(fn, args, n), args[0].device, iters, pairs)


def timed_loop(loop, device: torch.device, iters: int = 10,
               pairs: int = 3, log=None) -> Timing:
    """:func:`timed` for any ``loop(k)``; ``log`` sees the graph's pairs
    on the card and the eager ones on the CPU."""
    for _ in range(2):
        loop(iters)
    on_card = device.type == "cuda"
    eager = slope(lambda k: eager_seconds(loop, k, device), iters, pairs,
                  None if on_card else log)
    graph, no_graph = None, None
    if on_card:
        graphs = Graphs(loop)
        try:
            graph = slope(graphs.seconds, iters, pairs, log)
        except RuntimeError as e:
            no_graph = str(e).strip().splitlines()[0]
        finally:
            graphs.close()
    return Timing(eager.seconds, None if graph is None else graph.seconds,
                  eager.spread, None if graph is None else graph.spread,
                  no_graph)


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
    """``(floor_ms, bound, bytes_ms, flops_ms)``: the least time a call
    could take on the card, the larger of ``nbytes`` over PEAK_BYTES and
    ``flops`` over PEAK_FP32, and which of the two binds ("bytes" or
    "operations"); the twin of the JAX repository's ``bench_all.floor_ms``
    with the H100's figures."""
    bt = nbytes / PEAK_BYTES * 1e3
    ft = flops / PEAK_FP32 * 1e3
    return max(bt, ft), ("bytes" if bt >= ft else "operations"), bt, ft


PROBE_SHAPE = (512, 1024)


def health_probe(device: torch.device, iters: int = 100) -> float:
    """Microseconds an iteration of a loop bound by the device's elementwise
    throughput: 8 chained ``|c| * 0.999 + 1e-6`` on a (512, 1024) float32
    tensor, slope-timed (the JAX repository's ``tunnel_probe``); the graph
    slope on the card.  A capture's merge keeps it beside the capture, so
    that sessions on a degraded device can be told apart."""
    x = torch.ones(PROBE_SHAPE, dtype=torch.float32, device=device)

    def loop(k):
        c = x
        for _ in range(k):
            for _ in range(8):
                c = torch.abs(c) * 0.999 + 1e-6
        return c

    t = timed_loop(loop, device, iters)
    return (t.eager if t.graph is None else t.graph) * 1e6


def card_line(device: torch.device) -> str:
    """The card's name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them, or
    "cpu" for the CPU."""
    return config.device_name(device) if device.type == "cuda" else "cpu"


def device_of(name, prog: str) -> torch.device:
    """The device a program runs on: the card unless ``name`` asks for
    another; without a card it exits non-zero with a message, never
    falling back to the CPU."""
    if name is None and not torch.cuda.is_available():
        raise SystemExit(f"{prog}: no CUDA device; the benchmarks run on "
                         f"the card, pass --device cpu for a rehearsal on "
                         f"the CPU")
    return config.resolve_device(name)


def tf32_off() -> bool:
    """Whether float32 matmuls and convolutions run at full FP32."""
    return (not torch.backends.cuda.matmul.allow_tf32
            and not torch.backends.cudnn.allow_tf32
            and torch.get_float32_matmul_precision() == "highest")


def launches(fn) -> dict:
    """The kernels one eager call of ``fn()`` launched, by kernel (K1-K6),
    as the wrappers count them; only those it launched."""
    from ..kernels import launch_counts
    before = launch_counts()
    fn()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    after = launch_counts()
    return {k: after[k] - before[k] for k in after if after[k] != before[k]}


def device_ms(fn, calls: int = 10):
    """Device ms a call from one ``torch.profiler`` window over ``calls``
    eager calls (the CUDA events' time, summed over the kernels), and the
    ms of each kernel; (0.0, {}) where the profiler saw no device time.
    The profiler has dropped kernel events on the H100 (PERF.md, Open
    questions): a time below the work's floor is such a dropout."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    per_kernel = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA \
                and e.self_device_time_total > 0:
            per_kernel[e.key] = e.self_device_time_total / calls / 1e3
    return sum(per_kernel.values()), per_kernel
