"""The host time of each benchmark cell's call on an NVIDIA GPU, split
at the program's C entries, with the profiler off and on:

    python3 -m dspbench.host_probe [--cells a,b] [--seed 1] [--calls 300]
        [--rounds 3] [--out host_probe.json]

from the root of a checkout.

Each cell (``dspbench/workloads/``; those of ``BENCHMARK.json`` that run
on one card when ``--cells`` is not given) is built as
``dspbench/harness.py`` builds it: the entry, a pool of captures from
``--seed``, every capture called twice to warm up.  Then, each call
waited for with ``torch.cuda.synchronize()`` after its return, as in the
benchmark's window:

- ``issue_us``: the median host time of a call until it returns, in each
  of ``--rounds`` rounds of ``--calls`` calls, the profiler off and the
  program untouched.
- off, split: each root (a call of the chain or the channelizer, each
  ``process`` of a stream) and each C entry's call timed by wrapping the
  root's function and ``kernels._build._launch`` and ``_build.call``:
  ``launch_us``, the median over roots of its entries' time, and
  ``dispatch_us``, of the root's time less that, less the timers' own
  cost (``timer_ns`` a timer, calibrated on a no-op).  The function
  holds a few checks that the root span leaves out (a stream's chunk
  checks before its root opens).
- on: one second of the benchmark's traced loop under ``torch.profiler``
  (the spans on): ``launch_host_us`` and ``dispatch_host_us`` as the
  benchmark reads them (``dspbench/host_split.py``), each over the off
  split's value, the profiled ``issue_us``, the recorder's own
  ``trace_ns`` a root (median), and the launches the records count a
  root against the wrappers' ``launches`` a root.

Prints the card's name and power limit first, then a JSON line a cell;
``--out`` also writes them as one JSON file.
"""
import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

from basic_dsp_tpu_torch import kernels, profiling
from basic_dsp_tpu_torch.kernels import _build

from dspbench import cells, traffic as traffic_mod

REPO = cells.ROOT.parent

# the function each cell's root span opens in
ROOTS = {"fir_fft_spectrum": ("pipelines", "FirFftChainPlanar", "forward"),
         "channelizer_fm": ("parallel.channelizer",
                            "ChannelizeAndDemodPlanar", "forward"),
         "gps_ca_bank": ("streaming", "StreamingFir", "process"),
         "audio_src_madi": ("streaming", "StreamingResampler", "process"),
         "modulation_rc": ("streaming", "StreamingResampler", "process")}


def _build_cell(name, seed, device):
    cell = cells.load(name)
    cfg, tr = cell.config, cell.traffic
    consts = cell.reference.constants(cfg, int(tr["samples"]), device)
    entry = cell.entry.Entry(cfg, consts, tr, device, None)
    inputs = [entry.prepare(*traffic_mod.capture(tr, seed, k, device))
              for k in range(int(tr["pool"]))]
    order = traffic_mod.order(tr, seed)
    for _ in range(2):
        for k in order:
            entry(inputs[k])
            torch.cuda.synchronize()
    return cell, entry, inputs, order


def _issue_us(entry, inputs, order, calls):
    times = []
    for i in range(calls):
        a = time.perf_counter_ns()
        out = entry(inputs[order[i % len(order)]])
        b = time.perf_counter_ns()
        torch.cuda.synchronize()
        del out
        times.append(b - a)
    return statistics.median(times) / 1e3


class _Timers:
    """Wraps a root's function and the C-entry calls with host timers."""

    def __init__(self, config):
        import importlib
        mod, cls, fn = ROOTS[config]
        owner = getattr(importlib.import_module(
            f"basic_dsp_tpu_torch.{mod}"), cls)
        self.saved = [(owner, fn, getattr(owner, fn)),
                      (_build, "_launch", _build._launch),
                      (_build, "call", _build.call)]
        self.roots, self.launches, self.launch, self.depth = [], [], 0, 0

    def _timed_root(self, fn):
        def root(*args, **kwargs):
            self.depth += 1
            if self.depth > 1:      # a root inside a root (a sharded path)
                try:
                    return fn(*args, **kwargs)
                finally:
                    self.depth -= 1
            self.launch, n = 0, len(self.launches)
            a = time.perf_counter_ns()
            try:
                return fn(*args, **kwargs)
            finally:
                b = time.perf_counter_ns()
                self.depth -= 1
                self.roots.append((b - a, self.launch,
                                   len(self.launches) - n))
        return root

    def _timed_entry(self, fn):
        def entry(*args):
            a = time.perf_counter_ns()
            rc = fn(*args)
            b = time.perf_counter_ns()
            self.launch += b - a
            self.launches.append(b - a)
            return rc
        return entry

    def __enter__(self):
        (owner, fn, root), (_, _, launch), (_, _, call) = self.saved
        setattr(owner, fn, self._timed_root(root))
        _build._launch = self._timed_entry(launch)
        _build.call = self._timed_entry(call)
        return self

    def __exit__(self, *exc):
        for obj, name, orig in self.saved:
            setattr(obj, name, orig)
        return False


def _timer_ns(n=20000):
    """A timer's own host ns outside the interval it reads: a timed no-op
    called, less the interval it reports."""
    t = _Timers("fir_fft_spectrum")     # not entered: nothing wrapped
    timed = t._timed_entry(lambda *a: 0)
    outer = []
    for _ in range(n):
        a = time.perf_counter_ns()
        timed(1)
        outer.append(time.perf_counter_ns() - a)
    return statistics.median(o - i for o, i in zip(outer, t.launches))


def _off_split(config, entry, inputs, order, calls, timer_ns):
    with _Timers(config) as t:
        for i in range(calls):
            out = entry(inputs[order[i % len(order)]])
            torch.cuda.synchronize()
            del out
    launch = [lu for _, lu, _ in t.roots]
    dispatch = [d - lu - k * timer_ns for d, lu, k in t.roots]
    return {"launch_us": statistics.median(launch) / 1e3,
            "dispatch_us": statistics.median(dispatch) / 1e3,
            "entries_per_root": statistics.median(k for *_, k in t.roots)}


def _on(entry, inputs, order, device, seconds=1.0):
    from torch.profiler import ProfilerActivity, profile, record_function
    from dspbench import host_split, probes
    profiling.reset_spans()
    before = kernels.launch_counts()
    issue = []
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]):
        with record_function(probes.WINDOW_SPAN):
            deadline = time.perf_counter() + seconds
            i = 0
            while time.perf_counter() < deadline:
                with record_function(probes.CALL_SPAN):
                    a = time.perf_counter_ns()
                    res = entry(inputs[order[i % len(order)]])
                    issue.append(time.perf_counter_ns() - a)
                with record_function(probes.SYNC_SPAN):
                    torch.cuda.synchronize(device)
                del res
                i += 1
    after = kernels.launch_counts()
    recs = profiling.spans()
    roots = [r for r in recs if r["parent"] is None]
    # the ring may have dropped the oldest calls: launches over the roots
    # it holds, the wrappers' launches over all the loop's roots
    return {"calls": i, "issue_us": statistics.median(issue) / 1e3,
            "launch_host_us": host_split.median_us(recs, 0),
            "dispatch_host_us": host_split.median_us(recs, 1),
            "trace_us": statistics.median(r["trace_ns"] for r in roots)
            / 1e3,
            "launches_per_root": sum(r["launches"] for r in recs)
            / len(roots),
            "launches_per_call": sum(after[k] - before[k] for k in after)
            / i,
            "roots_in_ring": len(roots)}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cells", default=None)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--calls", type=int, default=300)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("host_probe: needs an NVIDIA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"# {smi}; torch {torch.__version__}; tree {REPO}", flush=True)
    device = torch.device("cuda")
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    names = (args.cells.split(",") if args.cells else
             [w["name"] for w in bench["workloads"] if w["chips"] == 1])
    timer_ns = _timer_ns()
    results = {}
    for name in names:
        cell, entry, inputs, order = _build_cell(name, args.seed, device)
        res = {"issue_us": [_issue_us(entry, inputs, order, args.calls)
                            for _ in range(args.rounds)],
               "off": _off_split(cell.config["name"], entry, inputs, order,
                                 args.calls, timer_ns),
               "timer_ns": timer_ns,
               "on": _on(entry, inputs, order, device)}
        for part, key in (("launch", "launch_host_us"),
                          ("dispatch", "dispatch_host_us")):
            off, on = res["off"][f"{part}_us"], res["on"][key]
            if on is not None and off > 0:
                res[f"{part}_on_over_off"] = on / off
        results[name] = res
        print(json.dumps({"cell": name, **res}), flush=True)
        entry.close()
        del cell, entry, inputs
        torch.cuda.empty_cache()
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            {"card": smi, "torch": torch.__version__, "seed": args.seed,
             "cells": results}, indent=1))


if __name__ == "__main__":
    main()
