#!/usr/bin/env python3
"""Whether ``profiling.trace`` keeps every kernel, on an NVIDIA GPU: the
chain (``FirFftChainPlanar``, 2^22 samples, n1 = 128) called under
``profiling.trace``, and in the Chrome trace it writes the
``rowfft_cluster`` kernel events (K1) and the ``dsp.K1`` spans (host and
their device-side copies) counted against ``rowfft_mag.launches``, with
the trace's kernel time a call, and the profiler's ``key_averages()``
device time a call (what ``bench/timing.device_ms`` sums), beside the
call's CUDA-graph replay.

    python3 basic_dsp_tpu_torch/probes/trace_count.py [CALLS]

Three windows: ``CALLS`` calls (200 by default) after an eager warm-up,
``CALLS`` calls right after the call was captured in a CUDA graph and
replayed (the order of the timing programs' profiler windows), and 10
calls (``device_ms``'s window).  Prints one JSON line; the traces go to a
temporary directory, which is deleted.
"""
import collections
import json
import shutil
import sys
import tempfile
from pathlib import Path

import torch


def _read(path: Path) -> dict:
    """Counts and device times of one exported Chrome trace."""
    events = json.loads(path.read_text())["traceEvents"]
    counts, kernel_us = collections.Counter(), 0.0
    for e in events:
        cat, name = e.get("cat", ""), e.get("name", "")
        if cat == "kernel":
            kernel_us += float(e.get("dur", 0))
            if "rowfft_cluster" in name:
                counts["rowfft_cluster"] += 1
        elif name == "dsp.K1":
            counts[f"dsp.K1 ({cat})"] += 1
    return {"counts": dict(counts), "kernel_us": kernel_us}


def _graph_ms(fn, calls: int = 50) -> float:
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(calls):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def main(calls: int) -> None:
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    from basic_dsp_tpu_torch import pipelines, profiling
    from basic_dsp_tpu_torch.kernels import spectrum_cuda

    if not torch.cuda.is_available():
        raise SystemExit("trace_count: no CUDA device")
    n = 1 << 22
    g = torch.Generator().manual_seed(0)
    chain = pipelines.FirFftChainPlanar(
        torch.randn(128, generator=g).cuda(), torch.hamming_window(n).cuda(),
        n1=128)
    xr, xi = (torch.randn(n, generator=g).cuda() for _ in range(2))

    def call():
        return chain(xr, xi)

    out = {"card": torch.cuda.get_device_name(0)}
    tmp = Path(tempfile.mkdtemp(prefix="trace_count_"))
    try:
        for _ in range(20):
            call()
        torch.cuda.synchronize()
        windows = (("eager", calls), ("after_graph", calls), ("ten", 10))
        for window, k in windows:
            if window == "after_graph":
                out["graph_ms"] = _graph_ms(call)
            before = spectrum_cuda.rowfft_mag.launches
            log_dir = tmp / window
            with profiling.trace(str(log_dir)) as prof:
                for _ in range(k):
                    call()
            rec = _read(next(log_dir.glob("trace_*.json")))
            rec["calls"] = k
            rec["launches"] = spectrum_cuda.rowfft_mag.launches - before
            rec["kernel_ms_a_call"] = rec.pop("kernel_us") / 1e3 / k
            rec["key_averages_ms_a_call"] = sum(
                e.self_device_time_total for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3 / k
            out[window] = rec
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for window, _ in windows:
        for key in ("kernel_ms_a_call", "key_averages_ms_a_call"):
            out[window][key.replace("ms_a_call", "of_replay")] = (
                out[window][key] / out["graph_ms"])
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 200)
