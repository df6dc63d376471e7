#!/usr/bin/env python3
"""The flagship chain's FIR and window, each way the port can compute
them, alone, inside the whole chain and against the benchmark's float64
reference, on an NVIDIA GPU.

    python3 basic_dsp_tpu_torch/probes/fir_paths.py [--seconds S]
        [--rounds R] [--seeds K] [--json FILE]

At the benchmark cell ``fir_fft_spectrum.capture_4m``'s shape (2^22
complex samples, 128 raised-cosine taps, a Hamming window, n1 = 128), the
routes of the FIR and window stage are:

- ``K7``: ``kernels.fir_cuda.fir_window_cuda``, the direct sum with the
  window as its epilogue (the chain's route);
- ``K3 + window``: the overlap-save kernel in circular mode with the
  window multiplied as it stores, at fft_len 2048, 4096 (the convolution
  dispatch's choice at 128 taps) and 8192.  The port's K3 has no window:
  this is a build of ``csrc/overlap_save.cu`` with the edits in
  ``K3_WINDOW`` (each thread loads its window points before the inverse's
  in-place passes), into ``basic_dsp_tpu_torch/_build/cuts/``, launched
  through its C entry with no wrapper's checks;
- ``K3, then multiply``: the port's K3, then one broadcast multiply of its
  (2, n) planes;
- ``Toeplitz``: ``conv_ops.toeplitz_conv_planar`` with held band
  matrices, then the window multiply (the chain's FIR before K7).

Each route alone: its error against a float64 FFT oracle (max abs gap
over the oracle's largest magnitude), its host issue (``perf_counter``
from the call to its return, median of 200 calls, each waited for) and
its device time (CUDA-graph replay, the slope of 20 and 60 calls).  The
whole chain with each route (stage 1, K1 and the flatten as
``pipelines._planar_chain`` runs them, all in the same Python frame; and
the module as built, with its spans and checks): the replay's device ms a
call,
and a closed loop like the benchmark's (one caller, each call on the next
of 8 pool captures, waited for) for ``--seconds`` a turn, the routes in
turns forward then backward, ``--rounds`` times: Msamples/s, the median
and 95th percentile call ms and the host issue a call.  Then, for
``--seeds`` seeds of the cell's traffic (``dspbench.traffic``, one capture
a seed), the chain's spectrum with each route against the benchmark's
float64 reference (``dspbench/references/fir_fft_spectrum.py``), as the
cell's ``spectrum_max_rel_err`` reads it (limit 1e-5).
"""
import argparse
import ctypes
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

import basic_dsp_tpu_torch as bt  # noqa: E402
from basic_dsp_tpu_torch import pipelines  # noqa: E402
from basic_dsp_tpu_torch.bench import timing  # noqa: E402
from basic_dsp_tpu_torch.kernels import _build  # noqa: E402
from basic_dsp_tpu_torch.kernels import fir_cuda  # noqa: E402
from basic_dsp_tpu_torch.kernels import overlap_save_cuda as osc  # noqa: E402
from basic_dsp_tpu_torch.kernels import spectrum_cuda  # noqa: E402
from basic_dsp_tpu_torch.ops import conv_ops, fourstep  # noqa: E402

N = 1 << 22
TAPS = 128
N1 = 128
POOL = 8
CELL = "fir_fft_spectrum.capture_4m"
FFT_LENS = (2048, 4096, 8192)
SEED0 = 3300000000

_PREFETCH = """    // the window at the last pass's output points, loaded before the
    // inverse's in-place passes so that their latency hides under them
    float wv[K0][R0];
#pragma unroll
    for (int u = 0; u < K0; ++u) {
#pragma unroll
      for (int q = 0; q < R0; ++q) {
        const int t = threadIdx.x + u * T + q * PL;
        const long long g = b * L + t - pad;
        long long o = g - shift;
        if (o < 0) o += n;
        wv[u][q] = w != nullptr && t >= pad && g < lim ? __ldg(w + o) : 1.0f;
      }
    }

"""
_INVERSE = ("    fft_core::passes_inplace<1, LOG2N, T, I.count, I.bits, 1, "
            "I.count - 1>(\n        dr, di, tl);")
# csrc/overlap_save.cu with a window w (n,) multiplied at the store, the
# C entry taking w after h (null: no window)
K3_WINDOW = [
    ("const float2* __restrict__ h, float* __restrict__ yr,",
     "const float2* __restrict__ h, const float* __restrict__ w,\n"
     "                    float* __restrict__ yr,"),
    (_INVERSE, _PREFETCH + _INVERSE),
    ("          yr[o] = vr[q] * kInvN;\n"
     "          if (yi != nullptr) yi[o] = vi[q] * kInvN;",
     "          yr[o] = vr[q] * kInvN * wv[u][q];\n"
     "          if (yi != nullptr) yi[o] = vi[q] * kInvN * wv[u][q];"),
    ("int launch(const float* xr, const float* xi, const float* h, float* yr,",
     "int launch(const float* xr, const float* xi, const float* h,\n"
     "           const float* w, float* yr,"),
    ("reinterpret_cast<const float2*>(h), yr, yi,",
     "reinterpret_cast<const float2*>(h), w, yr, yi,"),
    ("int launch_len(int log2n, const float* xr, const float* xi, "
     "const float* h,\n               float* yr,",
     "int launch_len(int log2n, const float* xr, const float* xi, "
     "const float* h,\n               const float* w, float* yr,"),
    ("(xr, xi, h, yr, yi, n, L, pad, lim, shift, s)",
     "(xr, xi, h, w, yr, yi, n, L, pad, lim, shift, s)"),
    ("int overlap_save_launch(const float* xr, const float* xi, "
     "const float* h,\n                        float* yr,",
     "int overlap_save_launch(const float* xr, const float* xi, "
     "const float* h,\n                        const float* w, float* yr,"),
    ("(log2n, xr, xi, h, yr, yi,", "(log2n, xr, xi, h, w, yr, yi,"),
]


def build_k3_window():
    """The K3 + window library's C entry, built from csrc/overlap_save.cu
    and ``K3_WINDOW`` (each edit must match the source)."""
    text = (_build.CSRC / "overlap_save.cu").read_text()
    for old, new in K3_WINDOW:
        if old not in text:
            raise SystemExit(f"fir_paths: overlap_save.cu no longer holds:\n"
                             f"{old}")
        text = text.replace(old, new)
    out = _build.BUILD_DIR / "cuts"
    out.mkdir(parents=True, exist_ok=True)
    src, lib = out / "overlap_save_window.cu", out / "liboverlap_save_window.so"
    src.write_text(text)
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS,
                           f"-I{_build.CSRC}", "-o", str(lib), str(src)],
                          capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"fir_paths: nvcc failed:\n{proc.stderr[-3000:]}")
    fn = ctypes.CDLL(str(lib)).overlap_save_launch
    vp, ci, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [vp] * 6 + [ll, ci, ci, ll, ll, ci, ci, vp]
    fn.restype = ci
    return fn


def rc_taps(m, dev):
    """m raised-cosine taps (roll-off 0.35) at t = (k - m/2) / 4, unit DC
    gain."""
    t = torch.from_numpy(((np.arange(m) - m // 2) * 0.25).astype(np.float32))
    taps = bt.RaisedCosineFunction(0.35).calc(t)
    return (taps / taps.sum()).to(dev)


def oracle(xr, xi, taps, window):
    """The centered circular convolution times the window, in float64 by
    FFT: out[i] = w[i] sum_k x[(i + c - 1 - k) mod n] h[k]."""
    n, m = xr.shape[0], taps.shape[0]
    c = m - m // 2
    x = torch.complex(xr.double(), xi.double())
    hp = torch.zeros(n, dtype=torch.complex128, device=xr.device)
    hp[:m] = taps.double()
    y = torch.roll(torch.fft.ifft(torch.fft.fft(x) * torch.fft.fft(hp)),
                   -(c - 1))
    return y * window.double()


def device_us(fn):
    """Device us a call of ``fn()``: the slope of 20 and 60 calls captured
    in CUDA graphs and replayed, median of 3 pairs."""
    def loop(k):
        for _ in range(k):
            out = fn()
        return out
    graphs = timing.Graphs(loop)
    try:
        return timing.slope(graphs.seconds, 20, 3).seconds * 1e6
    finally:
        graphs.close()


def issue_us(fn, calls=200):
    """Median us from the call of ``fn()`` to its return, each call waited
    for before the next."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(calls):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
    return statistics.median(times) * 1e6


def closed_loop(call, pool, order, seconds):
    """One caller for ``seconds``: each call on the next pool capture,
    waited for.  Returns (Msamples/s, median ms, p95 ms, issue us)."""
    lat, issue = [], []
    k = 0
    start = time.perf_counter()
    while time.perf_counter() - start < seconds:
        xr, xi = pool[order[k % len(order)]]
        t0 = time.perf_counter()
        call(xr, xi)
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        lat.append(t2 - t0)
        issue.append(t1 - t0)
        k += 1
    window = time.perf_counter() - start
    p95 = statistics.quantiles(lat, n=20)[-1]
    return (k * N / window / 1e6, statistics.median(lat) * 1e3, p95 * 1e3,
            statistics.median(issue) * 1e6)


def routes_for(taps, window, launch):
    """The FIR and window routes (module docstring) for these taps and
    this window, by name: each maps (xr, xi) to (out_re, out_im).
    ``launch`` is the K3 + window build's C entry."""
    m_eff = conv_ops._clip_kernel(N, taps.shape[-1])[1]
    H = {fl: osc.spectrum(taps.to(torch.complex64), fl) for fl in FFT_LENS}
    bands = conv_ops.toeplitz_bands(taps, N)

    def k3_window(fl):
        pad, L, lim, shift = osc._mode(N, m_eff, fl, False)

        def fir(xr, xi):
            y = torch.empty(2, N, device=xr.device)
            rc = _build.launch(xr.device, launch, xr.data_ptr(),
                               xi.data_ptr(), H[fl].data_ptr(),
                               window.data_ptr(), y.data_ptr(),
                               y.data_ptr() + 4 * N, N, L, pad, lim, shift,
                               fl.bit_length() - 1, 0)
            if rc:
                raise SystemExit(f"fir_paths: K3 + window launch error {rc}")
            return y[0], y[1]
        return fir

    def k3_then_multiply(xr, xi):
        y = osc.conv_blocks_cuda(xr, xi, H[4096], m_eff, 4096) * window
        return y[0], y[1]

    def toeplitz(xr, xi):
        fr, fi = conv_ops.toeplitz_conv_planar(xr, xi, taps, bands)
        return fr * window, fi * window

    routes = {"K7": lambda xr, xi: fir_cuda.fir_window_cuda(xr, xi, taps,
                                                            window)}
    routes.update({f"K3 + window, fft_len {fl}": k3_window(fl)
                   for fl in FFT_LENS})
    routes["K3, then multiply"] = k3_then_multiply
    routes["Toeplitz"] = toeplitz
    return routes


def chain_with(chain, fir):
    """``chain``'s call with its FIR and window stage replaced by ``fir``."""
    n1, n2 = chain.n1, chain.n2
    dft = (chain.dft_r, chain.dft_p, chain.dft_m)
    Tfac = (chain.tw_ar, chain.tw_ai, chain.tw_br, chain.tw_bi)
    W = (chain.w_r, chain.w_i)

    def call(xr, xi):
        fr, fi = fir(xr, xi)
        Br, Bi = fourstep.stage1_planar(*dft, fr.reshape(n1, n2),
                                        fi.reshape(n1, n2))
        M = spectrum_cuda.rowfft_mag(Br, Bi, shift=True, Tfac=Tfac, W=W)
        return spectrum_cuda.natural_flatten(M)
    return call


def accuracy(seeds, launch, dev, smi, record):
    """The chain's ``spectrum_max_rel_err`` with K7, K3 + window (fft_len
    4096) and the Toeplitz route, on one capture of each seed of the
    cell's traffic, against the benchmark's float64 reference."""
    from dspbench import cells, traffic
    cell = cells.load(CELL)
    consts = cell.reference.constants(cell.config, N, dev)
    taps, window = consts["taps"], consts["window"]
    chain = pipelines.FirFftChainPlanar(taps, window, n1=N1)
    routes = routes_for(taps, window, launch)
    calls = {name: chain_with(chain, routes[name])
             for name in ("K7", "K3 + window, fft_len 4096", "Toeplitz")}
    errs = {name: [] for name in calls}
    for i in range(seeds):
        seed = SEED0 + i
        k = traffic.order(cell.traffic, seed)[0]
        xr, xi = traffic.capture(cell.traffic, seed, k, dev)
        ref = cell.reference.reference(cell.config, consts, xr, xi)
        for name, call in calls.items():
            err = cell.reference.errors(call(xr, xi), ref)
            errs[name].append(err["spectrum_max_rel_err"])
        del ref, xr, xi
    for name, v in errs.items():
        record["accuracy"][name] = v
        print(f"chain spectrum_max_rel_err, {name}, {seeds} seeds from "
              f"{SEED0}: max {max(v):.3e}, median {statistics.median(v):.3e}"
              f"; each {', '.join(f'{e:.2e}' for e in v)} on {smi}",
              flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seconds", type=float, default=1.5)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--seeds", type=int, default=24)
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("fir_paths: no CUDA device")
    dev = torch.device("cuda")
    smi = timing.card_line(dev)
    launch = build_k3_window()
    gen = torch.Generator(device=dev).manual_seed(1)
    pool = [tuple(torch.randn(N, device=dev, generator=gen)
                  for _ in range(2)) for _ in range(POOL)]
    order = torch.randperm(POOL * 16, generator=torch.Generator()
                           .manual_seed(2)).remainder(POOL).tolist()
    taps = rc_taps(TAPS, dev)
    window = bt.HammingWindow().sample(N, device=dev)
    chain = pipelines.FirFftChainPlanar(taps, window, n1=N1)
    routes = routes_for(taps, window, launch)

    record = {"card": smi, "n": N, "taps": TAPS, "alone": {}, "chain": {},
              "accuracy": {}}
    xr, xi = pool[0]
    ref = oracle(xr, xi, taps, window)
    peak = float(ref.abs().max())
    for name, fir in routes.items():
        fr, fi = fir(xr, xi)
        err = float(torch.maximum((fr.double() - ref.real).abs().max(),
                                  (fi.double() - ref.imag).abs().max()))
        rec = {"err": err / peak, "issue_us": issue_us(lambda: fir(xr, xi)),
               "device_us": device_us(lambda: fir(xr, xi))}
        record["alone"][name] = rec
        print(f"FIR alone, {name}: device {rec['device_us']:.1f} us "
              f"(CUDA-graph replay), host issue {rec['issue_us']:.1f} us, "
              f"error {rec['err']:.3e} of the peak, on {smi}", flush=True)
    del ref

    calls = {"the module as built (K7)": chain}
    for name in ("K7", "K3 + window, fft_len 4096", "K3, then multiply",
                 "Toeplitz"):
        calls[name] = chain_with(chain, routes[name])
    want = chain(xr, xi)
    for name, call in calls.items():
        got = call(xr, xi)
        gap = float((got - want).abs().max() / want.abs().max())
        k = iter(range(1 << 30))
        rep = device_us(lambda: call(*pool[next(k) % POOL])) / 1e3
        record["chain"][name] = {"gap_to_module": gap, "replay_ms": rep,
                                 "runs": []}
        print(f"chain, {name}: replay {rep:.4f} ms a call, gap to the "
              f"module's output {gap:.3e} of its peak", flush=True)
    names = list(calls)
    for _ in range(args.rounds):
        for name in names + names[::-1]:
            msps, med, p95, iss = closed_loop(calls[name], pool, order,
                                              args.seconds)
            record["chain"][name]["runs"].append(
                {"msps": msps, "median_ms": med, "p95_ms": p95,
                 "issue_us": iss})
    for name in names:
        runs = record["chain"][name]["runs"]
        print(f"chain, {name}: Msamples/s "
              + ", ".join(f"{x['msps']:.1f}" for x in runs)
              + f" (median {statistics.median(x['msps'] for x in runs):.1f}"
              f"), p95 ms median "
              f"{statistics.median(x['p95_ms'] for x in runs):.4f}, issue "
              f"us median {statistics.median(x['issue_us'] for x in runs):.1f}"
              f", on {smi}", flush=True)
    del pool, routes, calls, chain, want
    if args.seeds:
        accuracy(args.seeds, launch, dev, smi, record)
    if args.json:
        Path(args.json).write_text(json.dumps(record, indent=1))


if __name__ == "__main__":
    sys.exit(main())
