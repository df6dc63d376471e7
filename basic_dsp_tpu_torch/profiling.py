"""Timing and profiling helpers (counterpart of
``basic_dsp_tpu/profiling.py``): a per-op timing harness that waits for
the device, and a thin wrapper over ``torch.profiler`` for trace capture.

Eager PyTorch runs every call it is given and eliminates no dead code, so
:func:`time_op` needs no fold of the outputs into a loop carry (the JAX
harness's guard against XLA dropping the work).
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Dict

import torch


def _on_card(args) -> bool:
    return any(isinstance(a, torch.Tensor) and a.is_cuda for a in args)


def time_op(fn: Callable, *args, iters: int = 10) -> Dict[str, float]:
    """Times ``iters`` calls of ``fn(*args)`` after one warm-up call:
    between two CUDA events when an argument lies on the card, with
    ``perf_counter`` after a ``synchronize`` otherwise.  Returns
    ``{"total_s", "per_iter_s"}``."""
    fn(*args)
    if _on_card(args):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn(*args)
        stop.record()
        stop.synchronize()
        total = start.elapsed_time(stop) / 1e3
    else:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(*args)
        total = time.perf_counter() - t0
    return {"total_s": total, "per_iter_s": total / iters}


def throughput(fn: Callable, samples: int, *args,
               iters: int = 10) -> Dict[str, float]:
    """Msamples/s for an op over ``samples``-element data."""
    t = time_op(fn, *args, iters=iters)
    t["msamples_per_s"] = samples / t["per_iter_s"] / 1e6
    return t


@contextlib.contextmanager
def trace(log_dir: str):
    """``torch.profiler`` trace context: the CPU ops, and the card's
    kernels where there is a card, written on exit as a Chrome trace
    ``trace_<pid>_<ns>.json`` into ``log_dir`` (view it in Perfetto or
    ``chrome://tracing``).  Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))
