#!/usr/bin/env python3
"""Runs the PyTorch port's main path once on an NVIDIA GPU and checks it.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):

0. device: requires CUDA, prints the card's name and power limit;
1. build: compiles and loads the rowfft_mag CUDA kernel;
2. kernel vs plain: ``rowfft_mag`` against ``rowfft_mag_plain`` on the card
   at four geometries, <= 2e-6 relative to the maximum;
3. main path: ``FirFftChainPlanar`` at n = 2^22 with 128 raised-cosine
   taps and a Hamming window, checked against a float64 oracle
   (<= 5e-6 relative), with the kernel's launch count read around it;
   then ``fir_fft_chain`` and ``windowed_spectrum`` once each;
4. times with CUDA events (median of 20 after warm-up).

The line before the last is a JSON object describing each kernel; the
last line is ``{"ok": true, "device": {...}}``.
"""
import json
import subprocess
import sys
import time

import numpy as np
import torch

N = 1 << 22
TAPS = 128
GEOMETRIES = [(8, 256), (8, 16384), (128, 32768), (64, 131072)]
KERNEL_TOL = 2e-6
CHAIN_TOL = 5e-6
REPS = 20


def rel_err(got, ref):
    return float((got - ref).abs().max() / ref.abs().max())


def median_ms(fn, reps=REPS, warmup=3):
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return float(np.median(times))


def oracle(xr, xi, taps, window, fir=True):
    """|fftshift(fft(circular_centered_fir(x) * w))| in complex128."""
    x = torch.complex(xr.double(), xi.double())
    n, m = x.shape[-1], taps.shape[-1]
    if fir:
        c = m - m // 2
        g = torch.roll(torch.nn.functional.pad(taps.double(), (0, n - m)),
                       -(c - 1))
        x = torch.fft.ifft(torch.fft.fft(x) * torch.fft.fft(g))
    return torch.fft.fftshift(torch.fft.fft(x * window.double())).abs()


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    smi = smi.splitlines()[0]
    print(smi)   # the card's name and power limit, as nvidia-smi gives them
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}")

    import basic_dsp_tpu_torch as bt
    from basic_dsp_tpu_torch.kernels import _build, spectrum_cuda as sc
    from basic_dsp_tpu_torch.ops import fourstep

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)

    def planes(*shape):
        return (torch.from_numpy(rng.standard_normal(shape, np.float32))
                .to(dev) for _ in range(2))

    def tfac(n1, n2):
        return tuple(torch.from_numpy(p).to(dev)
                     for p in fourstep._dif_twiddle_factored(n1, n2))

    # 1. build
    t0 = time.perf_counter()
    sc._lib()
    print(f"build: {time.perf_counter() - t0:.2f} s "
          f"({_build.library_path('rowfft_mag').name})")

    # 2. kernel against its plain version, on the card
    abs_err_4m = None
    for n1, n2 in GEOMETRIES:
        Br, Bi = planes(n1, n2)
        T = tfac(n1, n2)
        got = sc.rowfft_mag(Br, Bi, shift=True, Tfac=T)
        ref = sc.rowfft_mag_plain(Br, Bi, shift=True, Tfac=T)
        torch.cuda.synchronize()
        err = rel_err(got, ref)
        print(f"rowfft_mag vs plain at ({n1}, {n2}): {err:.3e} relative "
              f"to max (tol {KERNEL_TOL})")
        assert got.shape == ref.shape == (n1, n2 // 128, 128)
        assert err <= KERNEL_TOL, (n1, n2, err)
        if (n1, n2) == (128, 32768):
            abs_err_4m = float((got - ref).abs().max())

    # 3. main path at full size
    rc = bt.RaisedCosineFunction(0.35)
    t = torch.from_numpy(((np.arange(TAPS) - TAPS // 2) * 0.25)
                         .astype(np.float32))
    taps = rc.calc(t)
    taps = (taps / taps.sum()).to(dev)
    window = bt.HammingWindow().sample(N, device=dev)
    xr, xi = planes(N)
    chain = bt.FirFftChainPlanar(taps, window)
    ref = oracle(xr, xi, taps, window)

    sc.rowfft_mag.launches = 0
    out = chain(xr, xi)
    torch.cuda.synchronize()
    launches = sc.rowfft_mag.launches
    print(f"main path: FirFftChainPlanar n={N} (n1={chain.n1}, "
          f"n2={chain.n2}), rowfft_mag launches: {launches}")
    assert launches >= 1, "the main path did not launch rowfft_mag"
    assert out.shape == (N,) and out.dtype == torch.float32
    assert bool(torch.isfinite(out).all())
    err = rel_err(out.double(), ref)
    print(f"FirFftChainPlanar vs float64 oracle: {err:.3e} relative to max "
          f"(tol {CHAIN_TOL})")
    assert err <= CHAIN_TOL, err

    before = sc.rowfft_mag.launches
    got = bt.fir_fft_chain(torch.complex(xr, xi), taps, window)
    torch.cuda.synchronize()
    err = rel_err(got.double(), ref)
    print(f"fir_fft_chain vs oracle: {err:.3e}")
    assert got.shape == (N,) and err <= CHAIN_TOL, err
    got = bt.windowed_spectrum(torch.complex(xr, xi), window)
    torch.cuda.synchronize()
    err = rel_err(got.double(), oracle(xr, xi, taps, window, fir=False))
    print(f"windowed_spectrum vs oracle: {err:.3e}")
    assert got.shape == (N,) and err <= CHAIN_TOL, err
    assert sc.rowfft_mag.launches == before + 2
    del ref, got

    # 4. times (CUDA events, median of REPS after warm-up)
    chain_ms = median_ms(lambda: chain(xr, xi))
    print(f"chain: {chain_ms:.4f} ms/call, {N / chain_ms / 1e3:.1f} "
          f"Msamples/s (n={N}, {TAPS} taps) on {smi}")
    Br, Bi = planes(128, 32768)
    T = tfac(128, 32768)
    W = sc.inner_twiddle(256, 32768, dev)

    def run_plain():
        return median_ms(lambda: sc.rowfft_mag_plain(Br, Bi, True, T))

    def run_kernel():
        return median_ms(lambda: sc.rowfft_mag(Br, Bi, True, T, W))

    # in turns: plain, kernel, kernel, plain
    plain = [run_plain()]
    kern = [run_kernel(), run_kernel()]
    plain.append(run_plain())
    kernel_ms, plain_ms = float(np.median(kern)), float(np.median(plain))
    print(f"rowfft_mag (128, 32768): kernel {kernel_ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms (each a median of {REPS}; runs {kern} / "
          f"{plain}) on {smi}")
    print(f"peak device memory: "
          f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")

    print(json.dumps({"kernels": [{
        "name": "rowfft_mag", "route": "cuda",
        "source": "basic_dsp_tpu_torch/csrc/rowfft_mag.cu",
        "replaces": "basic_dsp_tpu/kernels/spectrum_pallas.py:471",
        "launches": launches, "max_abs_err": abs_err_4m,
        "ms": kernel_ms, "plain_ms": plain_ms}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
