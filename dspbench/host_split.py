"""The host time of the program's roots split at its C entries, from the
span records the profiled second of a traced run leaves in the process
(``basic_dsp_tpu_torch.profiling``; host clock, ``time.perf_counter_ns``).

A root is a call of the chain or the channelizer and a chunk of a stream.
Each record carries ``trace_ns``, the recorder's own host ns inside its
interval, its descendants' included, and ``launch_ns`` and ``launches``:
the host ns and the count of the C entries' calls made inside it (each
with its device lookup and stream).  Over the roots whose records count a
launch:

- launch: the ``launch_ns`` of the root's records;
- dispatch: the root's host ns less its ``trace_ns`` and less that launch
  time: the program's own Python (checks, routing, allocations).

The readers of ``launch_host_us`` and ``dispatch_host_us`` take the median
over roots of each.  Both are None where no root counts a launch: a
program whose records carry no launches, or without spans.  Profiled, the
host runs slower than in the window (PERF.md §3 gives the ratio)."""
from __future__ import annotations

import statistics


def records() -> list:
    """The program's span records, none where it has no spans."""
    try:
        from basic_dsp_tpu_torch.profiling import spans
    except ImportError:
        return []
    return spans()


def split_ns(recs: list) -> list:
    """(launch ns, dispatch ns) of each root whose records count a launch,
    in the order the roots opened."""
    roots, launch = {}, {}
    for r in recs:
        if r["parent"] is None:
            roots[r["call"]] = r
        if r.get("launches"):
            launch[r["call"]] = launch.get(r["call"], 0) + r["launch_ns"]
    return [(launch[c], root["end_ns"] - root["start_ns"]
             - root["trace_ns"] - launch[c])
            for c, root in roots.items() if c in launch]


def median_us(recs: list, part: int):
    """The median over roots of part 0 (launch) or 1 (dispatch) of
    :func:`split_ns`, in us; None without a root that launched."""
    split = split_ns(recs)
    if not split:
        return None
    return statistics.median(s[part] for s in split) / 1e3
