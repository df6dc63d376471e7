#!/usr/bin/env python3
"""Runs the PyTorch port's main path once on an NVIDIA GPU and checks it.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):

0. device: requires CUDA, prints the card's name and power limit;
1. build: compiles and loads both CUDA kernels (rowfft_mag, overlap_save),
   one nvcc each, started together;
2. kernels vs plain, on the card, <= 2e-6 relative to the maximum:
   ``rowfft_mag`` against ``rowfft_mag_plain`` at four geometries, and
   ``blocked_linear_conv_cuda`` against ``blocked_linear_conv_plain`` at
   five (n, taps, fft_len), with complex and with real taps;
3. main paths, each with every launch count set to 0 just before it and
   read just after:
   a. the spectrum chain: ``FirFftChainPlanar`` at n = 2^22 with 128
      raised-cosine taps and a Hamming window, checked against a float64
      oracle (<= 5e-6 relative); then ``fir_fft_chain`` and
      ``windowed_spectrum`` once each;
   b. the long-tap convolution: ``conv_ops.convolve_signal_planar`` at
      n = 2^22 with 384 complex taps (fft_len 4096), against a float64
      oracle (<= 5e-6); then ``convolve_signal`` once, and
      ``fir_fft_chain`` with 384 raised-cosine taps (its overlap-save FIR
      runs on ``torch.fft``, its spectrum through ``rowfft_mag``);
4. times with CUDA events (median of 20 after warm-up).

The line before the last is a JSON object describing each kernel; the
last line is ``{"ok": true, "device": {...}}``.
"""
import concurrent.futures
import json
import subprocess
import sys
import time

import numpy as np
import torch

N = 1 << 22
TAPS = 128
GEOMETRIES = [(8, 256), (8, 16384), (128, 32768), (64, 131072)]
CONV_TAPS = 384
CONV_FFT_LEN = 4096
# (n, taps, fft_len); the last needs the kernel's large shared-memory opt-in.
OS_GEOMETRIES = [(4096, 33, 1024), (8192, 129, 2048), (5000, 63, 1024),
                 (N, CONV_TAPS, CONV_FFT_LEN), (1 << 20, 4097, 16384)]
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


def planes_err(got, ref):
    """max |got - ref| / max |ref| over both (re, im) planes."""
    diff = max(float((g - r).abs().max()) for g, r in zip(got, ref))
    return diff / max(float(r.abs().max()) for r in ref), diff


def conv_oracle(xr, xi, taps):
    """Centered circular convolution ifft(fft(x) fft(g)) in complex128, g
    the taps laid out on the circle (taps no longer than the signal)."""
    x = torch.complex(xr.double(), xi.double())
    n, m = x.shape[-1], taps.shape[-1]
    c = m - m // 2
    g = torch.roll(torch.nn.functional.pad(taps.to(torch.complex128),
                                           (0, n - m)), -(c - 1))
    return torch.fft.ifft(torch.fft.fft(x) * torch.fft.fft(g))


def oracle(xr, xi, taps, window, fir=True):
    """|fftshift(fft(circular_centered_fir(x) * w))| in complex128."""
    x = (conv_oracle(xr, xi, taps) if fir
         else torch.complex(xr.double(), xi.double()))
    return torch.fft.fftshift(torch.fft.fft(x * window.double())).abs()


def rc_taps(m, dev):
    """m raised-cosine taps (rolloff 0.35) at t = (k - m/2) * 0.25, unit
    DC gain."""
    import basic_dsp_tpu_torch as bt
    t = torch.from_numpy(((np.arange(m) - m // 2) * 0.25).astype(np.float32))
    taps = bt.RaisedCosineFunction(0.35).calc(t)
    return (taps / taps.sum()).to(dev)


def in_turns(name, plain_fn, kernel_fn, smi):
    """Median ms of the plain and the kernel version, in turns plain,
    kernel, kernel, plain; each run a median of REPS."""
    plain = [median_ms(plain_fn)]
    kern = [median_ms(kernel_fn), median_ms(kernel_fn)]
    plain.append(median_ms(plain_fn))
    kernel_ms, plain_ms = float(np.median(kern)), float(np.median(plain))
    print(f"{name}: kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms "
          f"(each a median of {REPS}; runs {kern} / {plain}) on {smi}")
    return kernel_ms, plain_ms


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
    from basic_dsp_tpu_torch.kernels import _build
    from basic_dsp_tpu_torch.kernels import overlap_save_cuda as osc
    from basic_dsp_tpu_torch.kernels import spectrum_cuda as sc
    from basic_dsp_tpu_torch.ops import conv_ops, fourstep

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)

    def planes(*shape):
        return (torch.from_numpy(rng.standard_normal(shape, np.float32))
                .to(dev) for _ in range(2))

    def tfac(n1, n2):
        return tuple(torch.from_numpy(p).to(dev)
                     for p in fourstep._dif_twiddle_factored(n1, n2))

    def reset_counts():
        sc.rowfft_mag.launches = 0
        osc.blocked_linear_conv_cuda.launches = 0

    # 1. build, one nvcc per source, all started together
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        for f in [pool.submit(lib) for lib in (sc._lib, osc._lib)]:
            f.result()
    print(f"build: {time.perf_counter() - t0:.2f} s "
          f"({_build.library_path('rowfft_mag').name}, "
          f"{_build.library_path('overlap_save').name})")

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

    os_abs_err_4m = None
    for n, m, fl in OS_GEOMETRIES:
        xr, xi = planes(n)
        hr, hi = planes(m)
        for kind in ("complex", "real"):
            if kind == "real":
                hi = torch.zeros_like(hr)
            got = osc.blocked_linear_conv_cuda(xr, xi, hr, hi, fl)
            ref = osc.blocked_linear_conv_plain(xr, xi, hr, hi, fl)
            torch.cuda.synchronize()
            err, abs_err = planes_err(got, ref)
            print(f"blocked_linear_conv_cuda vs plain at (n={n}, taps={m}, "
                  f"fft_len={fl}), {kind} taps: {err:.3e} relative to max "
                  f"(tol {KERNEL_TOL})")
            assert got[0].shape == ref[0].shape == (
                osc._geometry(n, m, fl)[2], fl)
            assert err <= KERNEL_TOL, (n, m, fl, kind, err)
            if (n, m, fl, kind) == (N, CONV_TAPS, CONV_FFT_LEN, "complex"):
                os_abs_err_4m = abs_err
    del got, ref

    # 3a. main path: the spectrum chain at full size
    taps = rc_taps(TAPS, dev)
    window = bt.HammingWindow().sample(N, device=dev)
    xr, xi = planes(N)
    chain = bt.FirFftChainPlanar(taps, window)
    ref = oracle(xr, xi, taps, window)

    reset_counts()
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

    # 3b. main path: the long-tap convolution at full size, complex64 taps
    # from numpy seed 0
    h = torch.from_numpy(np.random.default_rng(0).normal(size=CONV_TAPS)
                         .astype(np.float32).astype(np.complex64)).to(dev)
    assert conv_ops.pick_fft_len(CONV_TAPS) == CONV_FFT_LEN
    conv_ref = conv_oracle(xr, xi, h)
    reset_counts()
    cr, ci = conv_ops.convolve_signal_planar(xr, xi, h)
    torch.cuda.synchronize()
    os_launches = osc.blocked_linear_conv_cuda.launches
    print(f"main path: convolve_signal_planar n={N}, {CONV_TAPS} complex "
          f"taps, blocked_linear_conv_cuda launches: {os_launches}, "
          f"rowfft_mag launches: {sc.rowfft_mag.launches}")
    assert os_launches == 1, "the conv path did not launch overlap_save"
    assert cr.shape == ci.shape == (N,) and cr.dtype == torch.float32
    assert bool(torch.isfinite(cr).all() and torch.isfinite(ci).all())
    err, _ = planes_err((cr.double(), ci.double()),
                        (conv_ref.real, conv_ref.imag))
    print(f"convolve_signal_planar vs float64 oracle: {err:.3e} relative "
          f"to max (tol {CHAIN_TOL})")
    assert err <= CHAIN_TOL, err
    got = conv_ops.convolve_signal(torch.complex(xr, xi), h, True)
    torch.cuda.synchronize()
    err = rel_err(got.to(torch.complex128), conv_ref)
    print(f"convolve_signal vs oracle: {err:.3e}")
    assert got.shape == (N,) and got.dtype == torch.complex64
    assert err <= CHAIN_TOL, err
    assert osc.blocked_linear_conv_cuda.launches == 2
    del conv_ref, got, cr, ci
    taps_long = rc_taps(CONV_TAPS, dev)
    before = sc.rowfft_mag.launches
    got = bt.fir_fft_chain(torch.complex(xr, xi), taps_long, window)
    torch.cuda.synchronize()
    err = rel_err(got.double(), oracle(xr, xi, taps_long, window))
    print(f"fir_fft_chain, {CONV_TAPS} taps (torch.fft overlap-save FIR) "
          f"vs oracle: {err:.3e}")
    assert got.shape == (N,) and err <= CHAIN_TOL, err
    assert sc.rowfft_mag.launches == before + 1
    del got

    # 4. times (CUDA events, median of REPS after warm-up)
    chain_ms = median_ms(lambda: chain(xr, xi))
    print(f"chain: {chain_ms:.4f} ms/call, {N / chain_ms / 1e3:.1f} "
          f"Msamples/s (n={N}, {TAPS} taps) on {smi}")
    conv_ms = median_ms(lambda: conv_ops.convolve_signal_planar(xr, xi, h))
    print(f"convolve_signal_planar: {conv_ms:.4f} ms/call, "
          f"{N / conv_ms / 1e3:.1f} Msamples/s (n={N}, {CONV_TAPS} complex "
          f"taps, fft_len {CONV_FFT_LEN}) on {smi}")
    x = torch.complex(xr, xi)
    fft_ms = median_ms(lambda: conv_ops.overlap_save(x, h, True,
                                                     CONV_FFT_LEN))
    print(f"overlap_save on torch.fft (same convolution, complex in and "
          f"out): {fft_ms:.4f} ms/call on {smi}")
    Br, Bi = planes(128, 32768)
    T = tfac(128, 32768)
    W = sc.inner_twiddle(256, 32768, dev)
    kernel_ms, plain_ms = in_turns(
        "rowfft_mag (128, 32768)",
        lambda: sc.rowfft_mag_plain(Br, Bi, True, T),
        lambda: sc.rowfft_mag(Br, Bi, True, T, W), smi)
    hr, hi = h.real.contiguous(), h.imag.contiguous()
    os_ms, os_plain_ms = in_turns(
        f"blocked_linear_conv_cuda (n={N}, {CONV_TAPS} taps, fft_len "
        f"{CONV_FFT_LEN})",
        lambda: osc.blocked_linear_conv_plain(xr, xi, hr, hi, CONV_FFT_LEN),
        lambda: osc.blocked_linear_conv_cuda(xr, xi, hr, hi, CONV_FFT_LEN),
        smi)
    print(f"peak device memory: "
          f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")

    print(json.dumps({"kernels": [{
        "name": "rowfft_mag", "route": "cuda",
        "source": "basic_dsp_tpu_torch/csrc/rowfft_mag.cu",
        "replaces": "basic_dsp_tpu/kernels/spectrum_pallas.py:471",
        "launches": launches, "max_abs_err": abs_err_4m,
        "ms": kernel_ms, "plain_ms": plain_ms}, {
        "name": "overlap_save", "route": "cuda",
        "source": "basic_dsp_tpu_torch/csrc/overlap_save.cu",
        "replaces": "basic_dsp_tpu/kernels/overlap_save_pallas.py:192",
        "launches": os_launches, "max_abs_err": os_abs_err_4m,
        "ms": os_ms, "plain_ms": os_plain_ms}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
