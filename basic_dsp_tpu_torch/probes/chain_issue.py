#!/usr/bin/env python3
"""How long the host takes to issue one call of the flagship chain
(``pipelines.FirFftChainPlanar``) on an NVIDIA GPU, by route and by part.

    python3 basic_dsp_tpu_torch/probes/chain_issue.py [--n 4194304]
        [--calls 400] [--rounds 6]

The routes: ``plan``, the module's call, which issues K7, K8 and K1 from
its held plan; ``wrappers``, the same call through ``_planar_chain`` and
the three kernel wrappers (the route every call took before the plan).
Each round times ``--calls`` calls of each route in turn (the order
alternates between rounds), each call on the next of 8 captures and
waited for with ``torch.cuda.synchronize()`` after its return, so the
host never waits on a full queue: the median host-clock time from the
call to its return.  Then the parts, each call timed in pieces: the
plan's checks (its lookup and ``admits``), its two allocations and its
three ctypes launches; each C entry alone (its ctypes call, its launch
set-up and launch) and a ctypes call of a trivial entry; each wrapper's
whole call, and the wrappers' five allocations alone.  Prints the card's
name and power limit first.
"""
import argparse
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from basic_dsp_tpu_torch import pipelines  # noqa: E402
from basic_dsp_tpu_torch.kernels import fir_cuda, spectrum_cuda  # noqa: E402

POOL = 8


def _median_us(fn, pool, calls):
    """The median over ``calls`` of the host time of ``fn(*capture)``, or
    of each piece when ``fn`` returns a list of perf_counter_ns marks."""
    spans = []
    for i in range(calls):
        a = time.perf_counter_ns()
        marks = fn(*pool[i % POOL])
        b = time.perf_counter_ns()
        torch.cuda.synchronize()
        ends = marks if isinstance(marks, list) else [b]
        spans.append([t1 - t0 for t0, t1 in zip([a, *ends], ends)])
    return [statistics.median(s) / 1e3 for s in zip(*spans)]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1 << 22)
    ap.add_argument("--calls", type=int, default=400)
    ap.add_argument("--rounds", type=int, default=6)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("chain_issue: needs an NVIDIA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"# {smi}; torch {torch.__version__}")
    dev, n = torch.device("cuda"), args.n
    g = torch.Generator().manual_seed(0)
    chain = pipelines.FirFftChainPlanar(
        torch.randn(128, generator=g), torch.hamming_window(n),
        n1=128).to(dev)
    pool = [tuple(torch.randn(n, generator=g).to(dev) for _ in range(2))
            for _ in range(POOL)]
    n1, n2, L2 = chain.n1, chain.n2, chain.n2 // spectrum_cuda.LANES
    Tfac = (chain.tw_ar, chain.tw_ai, chain.tw_br, chain.tw_bi)
    W = (chain.w_r, chain.w_i)

    def wrappers(xr, xi):
        # the module's call before the plan: its shape check, then the
        # wrappers
        if xr.shape != (n,) or xi.shape != (n,):
            raise ValueError("shape")
        return pipelines._planar_chain(xr, xi, chain.taps, chain.bands,
                                       chain.window, Tfac, W, n1, n2, False)

    def plan_parts(xr, xi):
        marks = []
        plan = chain._plan(xr)
        assert plan is not None and plan.admits(xr, xi)
        marks.append(time.perf_counter_ns())
        s = torch.empty(5 * n, dtype=torch.float32, device=dev)
        out = torch.empty(n, dtype=torch.float32, device=dev)
        marks.append(time.perf_counter_ns())
        plan._issue(xr.data_ptr(), xi.data_ptr(), s.data_ptr(),
                    out.data_ptr())
        marks.append(time.perf_counter_ns())
        return marks

    def entries(xr, xi):
        # the three C entries alone, as the plan calls them
        plan, marks = chain._plan(xr), []
        scratch = torch.empty(5 * n, dtype=torch.float32, device=dev)
        out = torch.empty(n, dtype=torch.float32, device=dev)
        s = scratch.data_ptr()
        b, stream = 4 * n, torch.cuda.current_stream().cuda_stream
        marks.append(time.perf_counter_ns())
        plan.k7(xr.data_ptr(), xi.data_ptr(), *plan.k7_held, s, s + b,
                *plan.k7_tail, stream)
        marks.append(time.perf_counter_ns())
        plan.k8(s, s + b, s + 2 * b, s + 3 * b, n1, n2, stream)
        marks.append(time.perf_counter_ns())
        plan.k1(s + 2 * b, s + 3 * b, *plan.k1_held, s + 4 * b,
                out.data_ptr(), *plan.k1_tail, stream)
        marks.append(time.perf_counter_ns())
        plan.fir.fir_window_error_string(0)
        marks.append(time.perf_counter_ns())
        return marks

    def wrapper_parts(xr, xi):
        marks = []
        fr, fi = fir_cuda.fir_window_cuda(xr, xi, chain.taps, chain.window)
        marks.append(time.perf_counter_ns())
        Br, Bi = spectrum_cuda.stage1_cuda(fr.reshape(n1, n2),
                                           fi.reshape(n1, n2))
        marks.append(time.perf_counter_ns())
        spectrum_cuda.rowfft_mag_natural(Br, Bi, shift=True, Tfac=Tfac, W=W)
        marks.append(time.perf_counter_ns())
        return marks

    def wrapper_allocs(xr, xi):
        f32 = torch.float32
        held = [torch.empty((2, n), dtype=f32, device=dev),   # noqa: F841
                torch.empty((n1, n2), dtype=f32, device=dev),
                torch.empty((n1, n2), dtype=f32, device=dev),
                torch.empty((n1, L2, 128), dtype=f32, device=dev),
                torch.empty(n, dtype=f32, device=dev)]
        return [time.perf_counter_ns()]

    routes = {"plan": chain, "wrappers": wrappers}
    for fn in (*routes.values(), plan_parts, entries, wrapper_parts,
               wrapper_allocs):
        _median_us(fn, pool, 20)                  # builds and warms
    planned = pipelines.FirFftChainPlanar.planned_calls
    times = {k: [] for k in routes}
    for r in range(args.rounds):
        for k in (list(routes) if r % 2 == 0 else list(routes)[::-1]):
            times[k].append(_median_us(routes[k], pool, args.calls)[0])
    for k, v in times.items():
        print(f"{k}: issue us, median of each round: "
              + " ".join(f"{t:.1f}" for t in v)
              + f"; median {statistics.median(v):.1f}")
    print(f"planned calls in the rounds: "
          f"{pipelines.FirFftChainPlanar.planned_calls - planned} of "
          f"{args.rounds * args.calls} plan calls")
    c, a, i = _median_us(plan_parts, pool, args.calls)
    print(f"plan parts (us): checks {c:.1f}, allocations (2) {a:.1f}, "
          f"ctypes launches (3) with spans and counters {i:.1f}")
    _, e7, e8, e1, trivial = _median_us(entries, pool, args.calls)
    print(f"C entries alone (us): K7 {e7:.1f}, K8 {e8:.1f}, K1n {e1:.1f}; "
          f"a ctypes call of a trivial entry {trivial:.1f}")
    k7, k8, k1 = _median_us(wrapper_parts, pool, args.calls)
    (al,) = _median_us(wrapper_allocs, pool, args.calls)
    print(f"wrapper parts (us): K7 {k7:.1f}, K8 {k8:.1f}, K1n {k1:.1f}; "
          f"their allocations (5) alone {al:.1f}; checks and the rest "
          f"{k7 + k8 + k1 - al - i:.1f} beside the same ctypes launches")


if __name__ == "__main__":
    main()
