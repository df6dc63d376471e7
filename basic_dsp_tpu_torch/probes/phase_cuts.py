#!/usr/bin/env python3
"""Where the time of K1 and K2 (``csrc/rowfft_mag.cu``), K3
(``csrc/overlap_save.cu``), K6 (``csrc/channelizer.cu``) and the
resampler RS (``csrc/resample.cu``, K4 and K5) goes, on an NVIDIA GPU.

    python3 basic_dsp_tpu_torch/probes/phase_cuts.py [K1] [K2] [K3] [K6] [RS]

(no argument: all five).
Builds each kernel as it is and in variants with one phase cut out by an
edit of its source (the edits are listed below; each must match the
source, or the probe stops), then times every build at its main path's
shape: CUDA events around 50 back-to-back launches through the C entry,
after 3 warm-up launches.  The cuts change what the kernels compute: they
only say how much device time a phase holds.  K2 also times its row stage
alone, untwiddled as K2 launches it, once right after stage 1 (B*T in L2,
as on the path) and once after a 64 MiB flush; its "T in the row stage"
build is the other design, stage 1 a pure column FFT and the row kernel
applying the factored twiddle on load, as K1 does.  The variant sources
and libraries go to ``basic_dsp_tpu_torch/_build/cuts/`` (git-ignored).
"""
import concurrent.futures
import ctypes
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from basic_dsp_tpu_torch.kernels import _build  # noqa: E402
from basic_dsp_tpu_torch.kernels import overlap_save_cuda as osc  # noqa: E402
from basic_dsp_tpu_torch.kernels import spectrum_cuda as sc  # noqa: E402
from basic_dsp_tpu_torch.ops import fourstep  # noqa: E402
from basic_dsp_tpu_torch.parallel import channelizer as chz  # noqa: E402

OUT = _build.BUILD_DIR / "cuts"
REPS = 50

# K1 with the twiddle: the step-1 FFT with T in its first pass
K1_FFT1 = ("in_y = run_16_twiddled<LOG2_L2>(col, xr, xi, yr, yi, tw1, fa_r, "
           "fa_i,\n                                    fb_r, fb_i, nc);",
           "in_y = 0;")
K1_FFT2 = ("const int in_f = fft_core::run_16<-1, 7>(RowLayout<G::kLog2Rows>{}, "
           "gr,\n                                           gi, fr, fi, tw2, "
           "rows);", "const int in_f = 0;")
K1_LOADS = ("    cp_async::copy16((plane ? xi : xr) + col.word(j1, m),\n"
            "                     (plane ? bi : br) + g);", "")
K1_CUTS = {
    "as built": [],
    "no step-1 FFT": [K1_FFT1],
    "no step-2 FFT": [K1_FFT2],
    "no FFTs": [K1_FFT1, K1_FFT2],
    "no device loads": [K1_LOADS],
    "no device loads, no FFTs": [K1_LOADS, K1_FFT1, K1_FFT2],
    "gather from its own shared memory": [
        ("cluster.map_shared_rank(hr, j2 >> log2nc)[src]", "hr[src]"),
        ("cluster.map_shared_rank(hi, j2 >> log2nc)[src]", "hi[src]")],
    "no gather (no DSMEM or W reads)": [
        ("        vr[u] = cluster.map_shared_rank(hr, j2 >> log2nc)[src];\n"
         "        vi[u] = cluster.map_shared_rank(hi, j2 >> log2nc)[src];",
         "        vr[u] = src;\n        vi[u] = src;"),
        ("const float w_r = wr[w], w_i = wi[w];",
         "const float w_r = w, w_i = w;")],
    "no magnitude stores": [("    o[idx] = sqrtf(vr * vr + vi * vi);",
                             "    if (vr == 1234.5f) o[idx] = vi;")],
    "no twiddle tables": [("  fft_core::fill_tables<-1>(tw1, plan1);\n"
                           "  fft_core::fill_tables<-1>(tw2, plan2);", "")],
}
K6_CUTS = {
    "as built": [],
    "no FFT": [("const int in_b = inverse_dft<NL>(RowLayout{r0, rs}, log2c, "
                "ar, ai, br,\n                                     bi, tw, "
                "nv + 1 - r0);", "const int in_b = 0;")],
    "no atan2": [("atan2f(zi, zr)", "(zi + zr)")],
    "no angle stores": [
        ("out0[o] = (zr == 0.0f && zi == 0.0f) ? 0.0f : atan2f(zi, zr);",
         "if (zr == 1234.5f) out0[o] = zi;")],
    "no cp.async staging": [("constexpr bool kStage = NL == 2;",
                             "constexpr bool kStage = false;")],
    "no twiddle tables": [("  fft_core::fill_tables<1>(tw, plan);", "")],
}


K2_ROWS_OFF = ("  if (e != cudaSuccess) return static_cast<int>(e);\n"
               "  return static_cast<int>(launch_rows(cr, ci,",
               "  if (e != cudaSuccess) return static_cast<int>(e);\n"
               "  if (n1 > 0) return 0;\n"
               "  return static_cast<int>(launch_rows(cr, ci,")
K2_NO_T = ("        twiddle(vr.x, vi.x, a_r, a_i, b_r.x, b_i.x);\n"
           "        twiddle(vr.y, vi.y, a_r, a_i, b_r.y, b_i.y);\n"
           "        twiddle(vr.z, vi.z, a_r, a_i, b_r.z, b_i.z);\n"
           "        twiddle(vr.w, vi.w, a_r, a_i, b_r.w, b_i.w);", "")
K2_CUTS = {
    "as built": [],
    "T in the row stage (design b)": [
        K2_NO_T,
        ("launch_rows(cr, ci, nullptr, nullptr, nullptr,\n"
         "                                      nullptr, wr, wi,",
         "launch_rows(cr, ci, tar, tai, tbr, tbi,\n"
         "                                      wr, wi,")],
    "no twiddle": [K2_NO_T],
    "no row stage": [K2_ROWS_OFF],
    "no row stage, no stage-1 passes": [
        K2_ROWS_OFF,
        ("const int in_y = fft_core::run_16<-1, LOG2_N1>(col, xr, xi, yr, "
         "yi, tw,\n                                                   nc);",
         "const int in_y = 0;")],
    "no row stage, no stage-1 loads": [
        K2_ROWS_OFF,
        ("    cp_async::copy16((plane ? xi : xr) + col.word(j1, m),\n"
         "                     (plane ? ai : ar) + g);", "")],
    "no row stage, no stage-1 stores": [
        K2_ROWS_OFF,
        ("      *reinterpret_cast<float4*>(cr + g) = vr;\n"
         "      *reinterpret_cast<float4*>(ci + g) = vi;",
         "      if (vr.x == 1234.5f) *reinterpret_cast<float4*>(cr + g) = vi;")],
    "no row stage, no cp.async staging": [
        K2_ROWS_OFF,
        ("  if (static_cast<int>(blockIdx.x) < panels) {\n"
         "    load_panel<G>(col, ar, ai, bufs, bufs + words, n2, "
         "blockIdx.x * nc);\n  }", ""),
        ("    cp_async::wait_all();\n    __syncthreads();\n"
         "    if (p + static_cast<int>(gridDim.x) < panels) {\n"
         "      float* nr = bufs + 2 * (cur ^ 1) * words;   // free since the "
         "barrier\n"
         "      load_panel<G>(col, ar, ai, nr, nr + words, n2,\n"
         "                    (p + gridDim.x) * nc);\n    }",
         "    __syncthreads();             // the last panel's store read it\n"
         "    load_panel<G>(col, ar, ai, xr, xi, n2, p * nc);\n"
         "    cp_async::wait_all();\n    __syncthreads();")],
}
RS_CUTS = {
    "as built": [],
    "no window staging": [
        ("    if ((reinterpret_cast<uintptr_t>(xr + g) & 15) == 0 && g + 4 <= n) "
         "{\n      cp_async::copy16(d, xr + g);\n    } else {",
         "    if (g >= 0) {\n    } else {")],
    "no taps staging": [
        ("for (int c = threadIdx.x; c < (raw + 3) / 4; c += blockDim.x) {",
         "for (int c = threadIdx.x; c < 0; c += blockDim.x) {")],
    "no compute (every task skipped)": [
        ("for (int task = warp; task < tasks && QF != 0; task += kWarps) {",
         "for (int task = warp; task < 0 && QF != 0; task += kWarps) {"),
        ("for (int task = warp; task < tasks && QF == 0; task += kWarps) {",
         "for (int task = warp; task < 0 && QF == 0; task += kWarps) {")],
    "two blocks an SM (128 registers)": [
        ("__global__ void __launch_bounds__(kThreads, kCplx ? 2 : 3)\n"
         "resample_runs(",
         "__global__ void __launch_bounds__(kThreads, 2)\nresample_runs(")],
    "a quarter of the FMAs (one a float4 of taps)": [
        ("          acc = fma_tap(w[4 * q], c.x, acc);\n"
         "          acc = fma_tap(w[4 * q + 1], c.y, acc);\n"
         "          acc = fma_tap(w[4 * q + 2], c.z, acc);\n"
         "          acc = fma_tap(w[4 * q + 3], c.w, acc);",
         "          acc = fma_tap(w[4 * q], c.x, acc);"),
        ("        for (int t = 0; t < TW; ++t) {\n"
         "          acc = fma_tap(w[j * QF + t], tap[t], acc);",
         "        for (int t = 0; t < TW; t += 4) {\n"
         "          acc = fma_tap(w[j * QF + t], tap[t], acc);")],
    # the first float of each output decides (complex forms: the real
    # plane), so that the sums stay live
    "no output staging (no shared stores)": [
        ("        ov[padded((k + j) * P + p)] = acc;",
         "        if (reinterpret_cast<const float*>(&acc)[0] == 1234.5f)\n"
         "          ov[padded((k + j) * P + p)] = acc;"),
        ("        ov[padded(k * P + p)] = acc;",
         "        if (reinterpret_cast<const float*>(&acc)[0] == 1234.5f)\n"
         "          ov[padded(k * P + p)] = acc;")],
    "no stores to device memory": [
        ("for (int j = threadIdx.x; j < m; j += blockDim.x) o[j] = ov[padded(j)];",
         "for (int j = threadIdx.x; j < m; j += blockDim.x) {\n"
         "      if (reinterpret_cast<const float*>(ov + padded(j))[0]\n"
         "          == 1234.5f) o[j] = V{};\n    }")],
    "no register shifts (a reload every move)": [
        ("        if (d == 1) {", "        if (d == 1234) {"),
        ("        } else if (d == 2) {", "        } else if (d == 1235) {")],
    "one tile a block (no persistent blocks)": [
        ("const long long grid = tiles < resident ? tiles : resident;",
         "const long long grid = tiles;")],
}


K3_CUTS = {
    "as built": [],
    "no FFT passes (the in-place ones)": [
        ("    fft_core::passes_inplace<-1, LOG2N, T, F.count, F.bits, 1, "
         "F.count - 1>(\n        dr, di, tl);", ""),
        ("    fft_core::passes_inplace<1, LOG2N, T, I.count, I.bits, 1, "
         "I.count - 1>(\n        dr, di, tl);", "")],
    "no loads": [("      cp_async::copy16(dr, xr + g);\n"
                  "      if (xi != nullptr) cp_async::copy16(di, xi + g);",
                  "")],
    "no stores": [("          yr[o] = vr[q] * kInvN;\n"
                   "          if (yi != nullptr) yi[o] = vi[q] * kInvN;",
                   "          if (vr[q] == 1234.5f) yr[o] = vi[q];")],
    "no H loads": [("G::kHShared ? hs[i + q * PM] : __ldg(h + i + q * PM);",
                    "make_float2(0.5f, 0.25f);")],
    "H from L2, not shared memory": [
        ("static constexpr bool kHShared = !BANK && LOG2N <= 13;",
         "static constexpr bool kHShared = false;")],
    "no twiddle table fill": [("  fft_core::TwoLevel<LOG2N>::fill(tab);\n",
                               "")],
    "no cp.async staging": [("static constexpr bool kStage = LOG2N <= 12;",
                             "static constexpr bool kStage = false;")],
    "three blocks an SM (85 registers), H from L2": [
        ("static constexpr int kMinBlocks = LOG2N <= 12 ? 2 : 1;",
         "static constexpr int kMinBlocks = LOG2N <= 12 ? 3 : 1;"),
        ("static constexpr bool kHShared = !BANK && LOG2N <= 13;",
         "static constexpr bool kHShared = false;")],
}


def build(kernel, label, edits):
    """The library of ``csrc/<kernel>.cu`` with ``edits`` applied."""
    text = (_build.CSRC / f"{kernel}.cu").read_text()
    for old, new in edits:
        if old not in text:
            raise SystemExit(f"phase_cuts: {kernel}.cu no longer holds the "
                             f"text that '{label}' cuts:\n{old}")
        text = text.replace(old, new)
    name = f"{kernel}_{re.sub(r'[^0-9A-Za-z]+', '_', label)}"
    src, lib = OUT / f"{name}.cu", OUT / f"lib{name}.so"
    src.write_text(text)
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS,
                           f"-I{_build.CSRC}", "-o", str(lib), str(src)],
                          capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"phase_cuts: nvcc failed on '{label}':\n"
                         f"{proc.stderr[-3000:]}")
    return ctypes.CDLL(str(lib))


def events_us(fn):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(REPS):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / REPS * 1e3


def single_us(before, fn):
    """Median us of ``fn`` alone, CUDA events around each launch, each
    after ``before`` (outside the events)."""
    times = []
    for _ in range(REPS + 3):
        before()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) * 1e3)
    return float(np.median(times[3:]))


def main():
    if not torch.cuda.is_available():
        raise SystemExit("phase_cuts: torch.cuda.is_available() is False")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    OUT.mkdir(parents=True, exist_ok=True)
    which = set(sys.argv[1:]) or {"K1", "K2", "K3", "K6", "RS"}
    jobs = []
    for tag, kernel, cuts in (("K1", "rowfft_mag", K1_CUTS),
                              ("K2", "rowfft_mag", K2_CUTS),
                              ("K3", "overlap_save", K3_CUTS),
                              ("K6", "channelizer", K6_CUTS),
                              ("RS", "resample", RS_CUTS)):
        if tag in which:
            jobs += [(tag, kernel, k, v) for k, v in cuts.items()]
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        libs = list(pool.map(lambda j: build(j[1], f"{j[0]} {j[2]}", j[3]),
                             jobs))

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    stream = torch.cuda.current_stream().cuda_stream
    vp, ci, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong

    n1, n2 = 128, 32768
    L2 = n2 // 128
    Br, Bi = (torch.from_numpy(rng.standard_normal((n1, n2), np.float32))
              .to(dev) for _ in range(2))
    T = tuple(torch.from_numpy(p).to(dev)
              for p in fourstep._dif_twiddle_factored(n1, n2))
    W = sc.inner_twiddle(L2, n2, dev)
    M = torch.empty(n1, L2, 128, device=dev)
    k1_args = [Br.data_ptr(), Bi.data_ptr(), *[t.data_ptr() for t in T],
               W[0].data_ptr(), W[1].data_ptr(), M.data_ptr(), n1, L2, 64,
               stream]

    C, S, taps = 1024, 4096, 8
    xr, xi = (torch.from_numpy(rng.standard_normal(C * S)
                               .astype(np.float32)).to(dev) for _ in range(2))
    proto = torch.from_numpy((np.hamming(C * taps) / C)
                             .astype(np.float32)).to(dev)
    ts = chz._merged_tap_rows(proto, C)
    ang = torch.empty(C, S, device=dev)
    from basic_dsp_tpu_torch.kernels import channelizer_cuda as cc
    k6_args = [xr.data_ptr(), xi.data_ptr(), ts.data_ptr(), None, None,
               ang.data_ptr(), None, S, C, taps + 1, cc.strip_rows(C, S),
               stream]

    n3, m3, fl3 = 1 << 22, 384, 4096
    pad3, L3, _ = osc._geometry(n3, m3, fl3)
    x3r, x3i = (torch.from_numpy(rng.standard_normal(n3)
                                 .astype(np.float32)).to(dev)
                for _ in range(2))
    H3 = osc.spectrum(torch.from_numpy(
        rng.standard_normal(m3).astype(np.complex64)).to(dev), fl3)
    y3 = torch.empty(2, n3, device=dev)
    k3_args = [x3r.data_ptr(), x3i.data_ptr(), H3.data_ptr(), y3.data_ptr(),
               y3.data_ptr() + 4 * n3, n3, L3, pad3, n3, m3 - m3 // 2 - 1,
               fl3.bit_length() - 1, 0, stream]

    Ar, Ai = (torch.from_numpy(rng.standard_normal((n1, n2), np.float32))
              .to(dev) for _ in range(2))
    Cs = torch.empty(2, n1, n2, device=dev)
    k2_args = [Ar.data_ptr(), Ai.data_ptr(), *[t.data_ptr() for t in T],
               W[0].data_ptr(), W[1].data_ptr(), Cs[0].data_ptr(),
               Cs[1].data_ptr(), M.data_ptr(), n1, L2, 64, stream]

    from basic_dsp_tpu_torch.kernels import resample_cuda as rsc
    from basic_dsp_tpu_torch.ops import interp_ops
    import basic_dsp_tpu_torch as bt
    rs_shapes = []
    for P, Q, R in ((3, 2, 2), (160, 147, 1)):
        taps, offs = interp_ops.polyphase_taps(bt.SincFunction(), P, Q, 0.0,
                                               10, torch.float32, dev)
        n = 1 << 20
        out_len = n * P // Q + (n * P // Q) % 2
        x = torch.from_numpy(rng.standard_normal((R, n), np.float32)).to(dev)
        o = torch.tensor(offs, dtype=torch.int32, device=dev)
        y = torch.empty(R, out_len, device=dev)
        geometry = rsc._launch_geometry(P, Q, 10, tuple(offs))
        rs_shapes.append((f"RS {P}/{Q} (K{4 if Q < 64 else 5}, {R} x {n})",
                          [x.data_ptr(), taps.data_ptr(), o.data_ptr(),
                           y.data_ptr(), n, out_len, R, P, Q, 10, *geometry,
                           stream], (x, taps, o, y)))

    stage1_only = None
    for (tag, kernel, label, _), lib in zip(jobs, libs):
        if tag == "K2" and label == "no row stage":
            stage1_only = lib.fourstep_mag_fused_launch
    for (tag, kernel, label, _), lib in zip(jobs, libs):
        runs = []
        if tag == "K1":
            fn = lib.rowfft_mag_launch
            fn.argtypes = [vp] * 9 + [ci] * 3 + [vp]
            runs = [(k1_args, f"K1 rowfft_mag ({n1}, {n2})")]
        elif tag == "K2":
            fn = lib.fourstep_mag_fused_launch
            fn.argtypes = [vp] * 11 + [ci] * 3 + [vp]
            runs = [(k2_args, f"K2 fourstep_mag_fused ({n1}, {n2})")]
        elif tag == "RS":
            fn = lib.resample_launch
            fn.argtypes = [vp] * 4 + [ll, ll] + [ci] * 10 + [vp]
            runs = [(a, name) for name, a, _ in rs_shapes]
        elif kernel == "overlap_save":
            fn = lib.overlap_save_launch
            fn.argtypes = [vp] * 5 + [ll, ci, ci, ll, ll, ci, ci, vp]
            runs = [(k3_args, f"K3 overlap_save (n={n3}, {m3} taps, "
                              f"fft_len {fl3})")]
        else:
            fn = lib.channelizer_launch
            fn.argtypes = [vp] * 7 + [ll, ci, ci, ci, vp]
            runs = [(k6_args, f"K6 channelize_demod (C={C}, S={S})")]
        fn.restype = ci
        for args, shape in runs:
            rc = fn(*args)
            torch.cuda.synchronize()
            if rc:
                raise SystemExit(f"phase_cuts: {shape} {label}: launch error "
                                 f"{rc}")
            us = events_us(lambda: fn(*args))
            print(f"{shape}, {label}: {us:.1f} us/launch (CUDA events, {REPS} "
                  f"back-to-back launches) on {smi}", flush=True)
        if tag == "K2" and label == "as built" and stage1_only is not None:
            # The row stage alone, untwiddled as K2 launches it (K1's entry
            # with no T), its B*T just written by stage 1 or flushed from
            # L2 by 64 MiB of writes.
            rows = lib.rowfft_mag_launch
            rows.argtypes, rows.restype = [vp] * 9 + [ci] * 3 + [vp], ci
            stage1_only.argtypes = fn.argtypes
            stage1_only.restype = ci
            row_args = [Cs[0].data_ptr(), Cs[1].data_ptr(), None, None, None,
                        None, W[0].data_ptr(), W[1].data_ptr(), M.data_ptr(),
                        n1, L2, 64, stream]
            flush = torch.empty(16 << 20, device=dev)
            for when, before in (
                    ("right after stage 1", lambda: stage1_only(*k2_args)),
                    ("after a 64 MiB flush", lambda: flush.zero_())):
                us = single_us(before, lambda: rows(*row_args))
                print(f"K2 row stage alone, untwiddled ({n1}, {n2}), {when}: "
                      f"{us:.1f} us/launch (CUDA events around each launch, "
                      f"median of {REPS}) on {smi}", flush=True)


if __name__ == "__main__":
    sys.exit(main())
