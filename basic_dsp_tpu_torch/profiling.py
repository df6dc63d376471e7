"""Timing and profiling helpers (counterpart of
``basic_dsp_tpu/profiling.py``): a per-op timing harness that waits for
the device, a thin wrapper over ``torch.profiler`` for trace capture, and
the spans the port opens in its own call path.

Eager PyTorch runs every call it is given and eliminates no dead code, so
:func:`time_op` needs no fold of the outputs into a loop carry (the JAX
harness's guard against XLA dropping the work).

Spans (:func:`span`, :func:`spanned`) are off unless a ``torch.profiler``
is active in the process; off, a span is one shared no-op context.  On,
each span is also a ``torch.profiler.record_function`` of its name, so the
profiler's trace holds it on the device trace's clock, and it leaves a
record in a bounded ring in memory (:func:`spans`, :func:`reset_spans`):
its name, its call id (a span opened with none open is a root and starts a
call; its descendants share the id), its parent's index, its host start
and end, ``trace_ns``, ``launch_ns`` and ``launches``.  A span takes its
host start before its ``record_function`` opens and before any of the
recorder's bookkeeping, and its host end last, after its
``record_function`` closed, so the profiler's event of the span and all
the recorder's work for it lie inside the record's host interval;
``trace_ns`` is the recorder's own host time inside that interval, its
descendants' included: the host interval less ``trace_ns`` is the
program's own time.  The host clock is ``time.perf_counter_ns``.  A
kernel's C entry is called through ``kernels._build.launch`` or
``kernels._build.call``, which, while a profiler is active, add the host
ns of the call (the device lookup, the stream and the ctypes call) to the
innermost open span's ``launch_ns`` and count it in its ``launches``
(:func:`launched`): the wrapper's ``dsp.K*`` span.  That costs two clock
reads and no ``record_function``.

On a CUDA input, and not while the stream captures a CUDA graph,
a root records a CUDA event on the current stream as its code starts, and
each of its direct children one on the same stream as its code ends; the
root ends at its last child's event (at its own, recorded as its code
ends, where it has no child), so nothing the device should count may
follow the last child inside a root.  A record's stream ms runs from the
event before it to its own: a root's is the whole call on the device's
timeline, the device's waits for the host included, and its children's
add up to it.  Deeper spans and CPU calls have no stream ms.  The events
come from a pool: a root takes back, before its first event, the events
of the finished calls that the device has passed, their stream ms read.
"""
from __future__ import annotations

import collections
import contextlib
import functools
import itertools
import os
import threading
import time
from typing import Callable, Dict, List, Optional

import torch
import torch.autograd.profiler as _autograd_profiler


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


# Records the ring holds: a profiled second of the chain (~3,000 calls of
# 6 records), of the channelizer (~9,000 calls of 2) or of a stream cell
# (~2,500 chunks of up to 5) with room to spare.
RING_RECORDS = 1 << 16


class _Call:
    """The records of one root and its descendants, and the CUDA events
    they recorded (``device`` None: no events)."""

    __slots__ = ("id", "records", "events", "device", "stream", "last",
                 "open")

    def __init__(self, call_id: int, device: Optional[int]):
        self.id = call_id
        self.records: list = []
        self.events: list = []
        self.device = device
        # the stream current as the root opened takes every marker
        self.stream = (None if device is None
                       else torch.cuda.current_stream(device))
        self.last = None      # the call's newest event
        self.open = True

    def resolve(self) -> list:
        """Reads each record's stream ms from its events and hands the
        events back (the device has passed them)."""
        for r in self.records:
            if r.before is not None and r.end is not None:
                r.stream_ms = r.before.elapsed_time(r.end)
            r.before = r.end = None
        events, self.events, self.last = self.events, [], None
        return events


class _Span:
    """One span: its own record once entered."""

    __slots__ = ("recorder", "name", "on", "call", "index", "parent",
                 "depth", "start_ns", "end_ns", "trace_ns", "launch_ns",
                 "launches", "before", "end", "stream_ms", "_stack", "_rf")

    def __init__(self, recorder: "SpanRecorder", name: str, on=None):
        self.recorder, self.name, self.on = recorder, name, on
        self.before = self.end = self.stream_ms = self.end_ns = None
        self.launch_ns = self.launches = 0

    def __enter__(self):
        self.start_ns = time.perf_counter_ns()
        self._rf = torch.profiler.record_function(self.name)
        self._rf.__enter__()
        rec = self.recorder
        self._stack = stack = rec._stack()
        if stack:
            parent = stack[-1]
            self.call = parent.call
            self.parent, self.depth = parent.index, parent.depth + 1
            if self.depth == 1:
                self.before = self.call.last
        else:
            self.call = rec._open_call(self.on)
            self.parent, self.depth = None, 0
        self.on = None        # the ring holds no tensor
        self.index = next(rec._indices)
        self.call.records.append(self)
        stack.append(self)
        if self.depth == 0:
            self.before = rec._mark(self.call)
        self.trace_ns = time.perf_counter_ns() - self.start_ns
        return self

    def __exit__(self, *exc):
        code_end = time.perf_counter_ns()
        call = self.call
        if self.depth == 1 or (self.depth == 0 and call.last is self.before):
            self.end = self.recorder._mark(call)
        elif self.depth == 0:
            self.end = call.last          # its last child's
        if self.depth == 0:
            self.recorder._close_call(call)
        self._rf.__exit__(*exc)
        stack = self._stack
        stack.pop()
        self.end_ns = time.perf_counter_ns()
        self.trace_ns += self.end_ns - code_end
        if stack:
            stack[-1].trace_ns += self.trace_ns
        return False

    def as_dict(self) -> dict:
        return {"name": self.name, "call": self.call.id, "index": self.index,
                "parent": self.parent, "start_ns": self.start_ns,
                "end_ns": self.end_ns, "trace_ns": self.trace_ns,
                "launch_ns": self.launch_ns, "launches": self.launches,
                "stream_ms": self.stream_ms}


class SpanRecorder:
    """The ring of span records and the pool of CUDA events their markers
    take (one pool a device).  A root first takes back the events of the
    finished calls the device has passed, so that no span creates an event
    once the pool holds a call's worth.  The ring keeps whole calls and
    drops the oldest finished call to stay within ``capacity`` records of
    finished calls."""

    def __init__(self, capacity: int = RING_RECORDS):
        self.capacity = capacity
        self._calls: collections.deque = collections.deque()
        self._unread: collections.deque = collections.deque()
        self._records = 0     # of the finished calls in the ring
        self._call_ids = itertools.count()
        self._indices = itertools.count()
        self._pool: Dict[int, list] = collections.defaultdict(list)
        self._lock = threading.Lock()
        self._local = threading.local()

    def span(self, name: str, on=None) -> _Span:
        return _Span(self, name, on)

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _open_call(self, on) -> _Call:
        device = getattr(on, "device", on)
        index = None
        if (isinstance(device, torch.device) and device.type == "cuda"
                and not torch.cuda.is_current_stream_capturing()):
            index = (torch.cuda.current_device() if device.index is None
                     else device.index)
        call = _Call(next(self._call_ids), index)
        with self._lock:
            self._calls.append(call)
            while self._unread and (not self._unread[0].events
                                    or self._unread[0].last.query()):
                self._take_back(self._unread.popleft())
        return call

    def _close_call(self, call: _Call) -> None:
        with self._lock:
            call.open = False
            self._records += len(call.records)
            if call.events:
                self._unread.append(call)
            while self._records > self.capacity and not self._calls[0].open \
                    and self._calls[0] is not call:
                self._drop(self._calls.popleft())

    def _mark(self, call: _Call):
        """A CUDA event recorded on the call's stream, or None for a call
        without markers."""
        if call.device is None:
            return None
        pool = self._pool[call.device]
        event = pool.pop() if pool else torch.cuda.Event(enable_timing=True)
        event.record(call.stream)
        call.events.append(event)
        call.last = event
        return event

    def _take_back(self, call: _Call) -> None:
        if call.events:
            self._pool[call.device].extend(call.resolve())

    def _drop(self, call: _Call) -> None:
        self._records -= len(call.records)
        if call.device is not None:
            # events not taken back yet leave unread with the call
            self._pool[call.device].extend(call.events)
            call.events = []

    def records(self) -> List[dict]:
        """The records of every finished call in the ring, in the order
        the spans opened, as plain dicts (``name``, ``call``, ``index``,
        ``parent`` (the parent's ``index``, None for a root),
        ``start_ns``, ``end_ns`` (``time.perf_counter_ns``),
        ``trace_ns`` (the recorder's own ns inside them), ``launch_ns``
        and ``launches`` (its C entries' calls) and ``stream_ms`` (None
        without markers)).  Waits once for each device whose events are still
        unread."""
        with self._lock:
            for device in sorted({c.device for c in self._unread
                                  if c.events}):
                torch.cuda.synchronize(device)
            while self._unread:
                self._take_back(self._unread.popleft())
            calls = [c for c in self._calls if not c.open]
        return [r.as_dict() for c in calls for r in c.records]

    def reset(self) -> None:
        """Empties the ring of finished calls; their events go back to the
        pool."""
        with self._lock:
            while self._calls and not self._calls[0].open:
                self._drop(self._calls.popleft())
            self._unread.clear()


_OFF = contextlib.nullcontext()
_RECORDER = SpanRecorder()


def span(name: str, on=None):
    """A span named ``name`` around a ``with`` block: the shared no-op
    context unless a ``torch.profiler`` is active (module docstring).
    ``on``: a tensor or device; where a root's lies on the card, the call
    records CUDA markers."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Span(_RECORDER, name, on)


def spanned(name: str):
    """Decorates a function so that each call is a span named ``name``, its
    first positional argument the span's ``on``."""
    def decorate(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if not _autograd_profiler._is_profiler_enabled:
                return fn(*args, **kwargs)
            with _Span(_RECORDER, name, args[0] if args else None):
                return fn(*args, **kwargs)
        return wrapper
    return decorate


def launched(start_ns: int) -> None:
    """Adds one C entry's call, from ``start_ns`` (``time.perf_counter_ns``)
    to now, to the innermost open span's ``launch_ns`` and counts it in its
    ``launches``; this bookkeeping counts in the span's ``trace_ns``.
    Nothing where no span is open."""
    end = time.perf_counter_ns()
    stack = _RECORDER._stack()
    if stack:
        inner = stack[-1]
        inner.launch_ns += end - start_ns
        inner.launches += 1
        inner.trace_ns += time.perf_counter_ns() - end


def spans() -> List[dict]:
    """The records in the ring (:meth:`SpanRecorder.records`)."""
    return _RECORDER.records()


def reset_spans() -> None:
    """Empties the ring of span records."""
    _RECORDER.reset()
