"""Device readings taken after the window in a traced run: the time of a
piece of work on the device by CUDA-graph replay or between CUDA events,
and one window of the caller's loop under ``torch.profiler``.

A probe is the work of one call on pool capture ``i`` (``Probe.fn(i)``)
with the bytes and operations its floor counts (``floors``).  Its device
time is the work run over the pool in the window's order, so that the
captures come from memory as they do in the window, not from the L2.
"""
from __future__ import annotations

import bisect
import collections
import math
import statistics
import time

import torch

Probe = collections.namedtuple("Probe", "fn nbytes flops replay",
                               defaults=("graph",))
Probe.__doc__ = """``fn(i)`` runs the work on pool capture i; ``nbytes`` and
``flops`` are what its floor counts; ``replay`` "graph" (captured in a
CUDA graph and replayed) or "events" (each run alone between CUDA
events, for work that does not capture, such as a message)."""


def graph_ms(fn, order: list, min_calls: int = 200) -> float:
    """Device ms a run of ``fn``: ``fn(i)`` for i in ``order`` captured
    once in a CUDA graph, replayed between CUDA events until at least
    ``min_calls`` runs (three replays or more); the median replay over
    ``len(order)``."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for i in order:
            fn(i)
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        for i in order:
            fn(i)
    graph.replay()
    times = []
    for _ in range(max(3, math.ceil(min_calls / len(order)))):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / len(order))
    del graph
    torch.cuda.synchronize()
    return statistics.median(times)


def events_ms(fn, order: list, min_calls: int = 200) -> float:
    """Device ms a run of ``fn``: each ``fn(i)`` alone between CUDA
    events, the device idle before it; the median over at least
    ``min_calls`` runs."""
    times = []
    while len(times) < min_calls:
        for i in order:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            fn(i)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(probe: Probe, order: list) -> float:
    return (graph_ms if probe.replay == "graph" else events_ms)(probe.fn,
                                                                order)


WINDOW_SPAN = "dspbench.window"
CALL_SPAN = "dspbench.call"
SYNC_SPAN = "dspbench.sync"


def profiled(loop, seconds: float = None, calls: int = None) -> dict:
    """Runs ``loop(deadline, calls)`` (the window's loop, with the spans
    ``CALL_SPAN`` and ``SYNC_SPAN`` around each call and its wait) under
    ``torch.profiler`` inside ``WINDOW_SPAN``, and reads the trace:
    ``busy_s`` (the union of the device's activity), ``window_s``,
    ``calls``, ``kernel_s`` (the sum of the device operations),
    ``device_ops`` and ``idle_gaps`` (the ten largest, by operation name
    and by the host operation innermost at each gap's start)."""
    from torch.profiler import ProfilerActivity, profile, record_function
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW_SPAN):
            deadline = None if seconds is None \
                else time.perf_counter() + seconds
            n = loop(deadline, calls)
    return dict(read_trace(prof.profiler.kineto_results.events()), calls=n)


def _top(sums: dict, k: int = 10) -> list:
    return [[name, s] for name, s in
            sorted(sums.items(), key=lambda kv: -kv[1])[:k]]


def read_trace(events) -> dict:
    """The readings of :func:`profiled` from kineto events."""
    cuda = torch.autograd.DeviceType.CUDA
    window = [e for e in events if e.name() == WINDOW_SPAN]
    if not window:
        return {"busy_s": None, "window_s": None, "kernel_s": None,
                "device_ops": [], "idle_gaps": []}
    ws = window[0].start_ns()
    we = ws + window[0].duration_ns()
    thread = window[0].start_thread_id()
    dev, host = [], []
    ops = collections.Counter()
    spans = (WINDOW_SPAN, CALL_SPAN, SYNC_SPAN)
    for e in events:
        if e.device_type() == cuda:
            # the host's spans mirrored on the device's timeline are no
            # device work
            if e.is_user_annotation() or e.name() in spans:
                continue
            s, d = e.start_ns(), e.duration_ns()
            if d > 0 and s < we and s + d > ws:
                dev.append((max(s, ws), min(s + d, we)))
                ops[e.name()] += d / 1e9
        elif e.start_thread_id() == thread and e.name() != WINDOW_SPAN:
            host.append((e.start_ns(), e.start_ns() + e.duration_ns(),
                         e.name()))
    dev.sort()
    busy, gaps, cursor = 0, [], ws
    for s, f in dev:
        if s > cursor:
            gaps.append((cursor, s))
        if f > cursor:
            busy += f - max(s, cursor)
            cursor = f
    if we > cursor:
        gaps.append((cursor, we))
    host.sort()
    starts = [h[0] for h in host]
    idle = collections.Counter()
    for g0, g1 in gaps:
        label = "host idle"
        j = bisect.bisect_right(starts, g0) - 1
        for k in range(j, max(j - 4096, -1), -1):
            if host[k][1] > g0:
                label = host[k][2]
                break
        idle[label] += (g1 - g0) / 1e9
    return {"busy_s": busy / 1e9, "window_s": (we - ws) / 1e9,
            "kernel_s": sum(ops.values()), "device_ops": _top(ops),
            "idle_gaps": _top(idle)}
