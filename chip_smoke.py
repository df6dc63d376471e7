#!/usr/bin/env python3
"""Runs the PyTorch port's main path once on an NVIDIA GPU and checks it.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):

0. device: requires CUDA, prints the card's name and power limit;
1. build: compiles and loads the five CUDA libraries (rowfft_mag, which
   holds K1 and K2, overlap_save, resample, channelizer, fir_window), one
   nvcc each,
   and the C ABI library (``libbasic_dsp_tpu_torch.so``, the host C++
   compiler), all started together;
2. kernels vs plain, on the card, <= 2e-6 relative to the maximum:
   ``rowfft_mag`` (K1) against ``rowfft_mag_plain`` at five geometries,
   ``rowfft_mag_natural`` (K1's entry in spectrum order) against
   ``natural_flatten(rowfft_mag(...))`` bit for bit at those and the
   ten below, and without the twiddle or the shift at the 4M geometry,
   ``fourstep_mag_fused`` (K2) against ``fourstep_mag_fused_plain`` at
   ten, among them two non-power-of-two n1 (the direct sum), every
   power-of-two n1 from 8 to 1024 (each a compiled stage-1 plan), the 4M
   geometry and L2 = 1024, ``stage1_cuda`` (K8) against ``stage1_planar``
   in float64 at the 4M geometry and at n1 = 8 and 1024 (and against
   ``stage1_plain``, its float32 run, at the 4M geometry),
   K3 in both modes, ``circular_conv_cuda`` against
   ``circular_conv_plain`` and ``blocked_linear_conv_cuda`` against
   ``blocked_linear_conv_plain``, at eight (n, taps, fft_len), among them
   the 4M geometry, 8192, 16384, an n below fft_len (the circular loads
   wrap more than once) and an n that 4 does not divide, with complex and
   with real taps, and ``conv_blocks_cuda`` on a real signal (no imaginary
   plane in or out) against ``conv_blocks_plain``; and the
   resampler's two wrappers against their plain versions on one row and
   on two: ``resample_direct_cuda`` (K4) at thirteen (P, Q, L, n), among them
   interpolate_lin's 2-tap geometry with zero offsets, each branch of the
   kernel (one phase a lane, phases walked, P > 32, a reload, the direct
   stencil, the extended shapes of phases l and m), and
   ``resample_rowblock_cuda`` (K5) at four, among them an n that 147
   does not divide and phase l's extended chunk, the latter also on the
   64 rows of the audio block and, with chunk and tail apart, read in
   place (bit-equal to the rotated launch); ``channelize_demod_cuda``
   (K6) against ``channelize_demod_plain`` at five (C, S, taps per phase),
   among them config #5's with no prefix and with phase m's zero one, and
   a ragged S with a non-zero prefix, with ``demod`` True (angles, by the
   |z|-weighted wrapped error) and False (z), both (C, S); K3 also at the
   extended shapes of phases k and m (n + 383); ``fir_window_cuda`` (K7)
   against ``fir_window_plain`` at six (n, taps, window): the chain's 2^22
   with 128 and with 202 taps, a length below one tile (its loads wrap at
   both ends of the signal), a length 4 does not divide without a window,
   a ragged last tile and taps longer than the signal (clipped);
3. main paths, each with every launch count set to 0 just before it and
   read just after:
   a. the spectrum chain: ``FirFftChainPlanar`` at n = 2^22 with 128
      raised-cosine taps and a Hamming window (one K7, one K8 and one K1n
      launch, no ``rowfft_mag`` launch; its profiled call runs no
      ``aten::mm``, no gemm kernel, one ``rowfft_cluster`` with the
      twiddle folded, one ``natural_order`` and no elementwise copy),
      checked against a float64 oracle (<= 5e-6 relative); then
      ``fir_fft_chain`` and ``windowed_spectrum`` once each (no K7, one K8
      and one K1n each: their complex stage 1 and the row stage);
   b. the long-tap convolution: ``conv_ops.convolve_signal_planar`` at
      n = 2^22 with 384 complex taps (fft_len 4096), against a float64
      oracle (<= 5e-6), one K3 launch, and its profile must show K3 and
      the ops of the taps' spectrum H alone; then ``convolve_signal``
      once, and
      ``fir_fft_chain`` with 384 raised-cosine taps (its overlap-save FIR
      runs on ``torch.fft``, its spectrum through ``rowfft_mag_natural``);
   c. config #3: ``interp_ops.interpolatef`` of 2^20 complex samples x 1.5
      with ``SincFunction``, conv_len 10 (K4);
   d. config #4: ``ModulationChainPlanar(0.35, 10.0, 0.0, 10)`` on 2^17
      +-0.5 PRBS symbols per plane, then ``modulation_chain_planar`` once
      (K4); every 10th output sample must be its symbol within 1e-5;
   e. 44.1 -> 48 kHz audio: ``interpolatef`` of 2^20 real samples at
      160/147 (K5);
   c-e are checked against the defining sum in float64 on the card, with
   taps sampled in float64 (<= 5e-6 relative);
   f. config #5: ``channelize_and_demod_planar`` of 2^22 samples into
      1024 channels, prototype ``hamming(8192) / 1024`` (K6 once), against
      a float64 oracle (the stencil in float64, ``C * ifft`` in
      complex128, the demod; |z|-weighted angle error <= 5e-6); then
      ``channelize_and_demod``, ``ChannelizeAndDemodPlanar`` and
      ``polyphase_channelizer`` (no kernel, against the oracle's channels
      at 5e-6) once each; the module's profile must show K6 alone (no
      transpose);
   g. the fused spectrum chain: ``FirFftChainPlanar(..., fused=True)`` as
      in a (one K7 and one K2 launch, no K1 or K8 launch), against the float64
      oracle (<=
      5e-6); then ``fir_fft_chain_planar(..., fused=True)`` once;
   h. the typed vectors at full width: ``to_complex_time_vec`` of 2^22
      complex64 samples (numpy seed 0, copied to the card by the
      constructor) ``.convolve_signal`` with 384 complex taps (one K3
      launch, against the float64 oracle <= 5e-6), then
      ``.windowed_fft(HammingWindow()).magnitude()`` (<= 5e-6), then
      ``.statistics()`` (<= 1e-5 of float64 on the host, indices exact)
      and ``.sum_prec()`` (<= 1e-12 of ``math.fsum``); config #3's x1.5
      through ``to_complex_time_vec(...).interpolatef`` (one K4 launch) and
      the audio path's 160/147 through ``to_real_time_vec(...)`` (one K5
      launch), against the float64 oracle (<= 5e-6);
   i. a matrix: ``to_complex_time_mat`` of (8, 2^19) complex64 samples,
      ``.fft().magnitude().statistics()`` (8 ``Statistics`` from one host
      fetch, against float64) and ``.convolve_mat`` with an (8, 8, 33)
      complex grid against a float64 einsum oracle (<= 5e-6); no kernel;
   j. the flagship API: ``fourstep.dit_spectrum_mag`` at 2^22 (<= 5e-6,
      no kernel); ``fir_fft_chain_planar`` with each budget (None, "high",
      "high-xla", "high-kernel"), unfused (one K7, one K8 and one K1n
      launch each) and fused (one K7 and one K2 launch each), against the
      float64
      oracle (<= 5e-6, every
      budget bit-equal to None: all run f32-exact); then budget None again
      with TF32 off afterwards;
   k. ``streaming.StreamingFir`` with cell 2's 384 complex taps over 2^22
      complex64 samples (numpy seed 0) in 64 chunks of 2^16: 64 K3 launches
      (linear mode) and no others; the concatenation against the float64
      linear convolution (<= 5e-6);
   l. ``streaming.StreamingResampler``: x1.5 (Sinc, conv_len 10) of config
      #3's 2^20 complex samples in 16 chunks of 2^16 (16 K4 launches), and
      160/147 of 7 chunks of 150528 real samples (7 K5 launches: the
      row-block geometry fits the extended chunk); a (64, 150528) block
      of real channels in 3 chunks (3 K5 launches, the counters
      ``StreamingResampler.chunks`` 3 and ``.rows`` 192), its channel 0
      bit-equal to that channel streamed alone; each concatenation
      against the float64 zero-padded linear resample delayed by
      ``output_delay`` (<= 5e-6);
   m. the sharded functions on a one-rank NCCL mesh (``init_process_group``
      over an in-process ``HashStore``, then ``make_mesh(1)``):
      ``sharded_convolve_signal`` at 2^22 with 384 taps (one K3 launch),
      ``sharded_interpolatef`` x1.5 of 2^20 complex (one K4),
      ``sharded_channelize_and_demod`` at config #5 (one K6, zero prefix),
      ``sharded_sum`` and ``sharded_statistics`` of the 2^22 signal (no
      kernel); each against its single-device function (<= 1e-6) and the
      float64 oracle (<= 5e-6; sums relative to sum |x|, sums of squares to
      sum |x|^2); the process group ends just before phase 4;
   p. the rest of the multi-device layer on the same mesh:
      ``sharded_fft`` of 2^22 complex64 and of 2^22 real float32 samples,
      natural order and not ((n1, n2) sharded over rows),
      ``sharded_fft_planar``, ``four_step_fft`` and ``four_step_ifft`` at
      2^22, each against ``torch.fft.fft`` (<= 1e-6 of max |X|) and the
      float64 numpy FFT (<= 2e-6); ``sharded_convolve_mat`` of (8, 2^19)
      complex64 and float32 with an (8, 8, 64) grid (no kernel) against
      ``matrix._convolve_mat`` (<= 1e-6) and a float64 einsum (<= 5e-6);
      ``to_complex_time_vec_par`` of the 2^22 signal: ``sum``, ``scale``,
      ``magnitude`` (no kernel), ``convolve_signal`` with 384
      raised-cosine taps (one K3 launch), ``plain_fft`` (no kernel) and
      the gathering ``fft``, each against the plain vector's (<= 1e-6) and
      the convolution and the FFT against float64 (<= 5e-6); config #3's
      x1.5 through ``to_complex_time_vec_par(...).interpolatef`` (one K4
      launch); ``StreamingFir`` with cell 2's 384 taps over 16 sharded
      chunks of 2^16 (16 K3 launches) against the plain-chunk stream (<=
      1e-6) and the float64 linear convolution (<= 5e-6).  K3's and K4's
      launch counts in the ``kernels`` line include phase p's;
   q. the C ABI: ``libbasic_dsp_tpu_torch.so`` loaded with ctypes and
      initialised with ``BDSP_PLATFORM`` unset (every vector on the card;
      the knobs from the temporary autotune cache): ``from_data32`` of
      h's 2^22 complex64 signal and 384 taps, ``convolve_signal32`` (one
      K3 launch), ``get_data32`` against the typed call (<= 1e-6) and the
      float64 oracle (<= 5e-6); ``interpolatef32`` x1.5 of config #3 (one
      K4 launch), checked the same two ways; ``interpolatef32`` of the
      audio signal at float32(160/147) and 129/128, the factors the 32-bit
      facade can pass for K5, which take the per-sample gather (no kernel),
      against the typed call with the same factor (<= 1e-6);
      ``windowed_fft32`` (Hamming), ``magnitude32`` and
      ``real_statistics32`` at 2^22 (no kernel) against float64;
      ``map_inplace_real32`` and ``apply_custom_window32`` with ctypes C
      callbacks at 4096 samples; then ``examples/c_example.c`` compiled
      with ``cc`` against the library and run without ``BDSP_PLATFORM``
      (exit 0, ``vec[0] = 25``, ``ok``).  K3's and K4's launch counts in
      the ``kernels`` line include phase q's;
   r. the entry points outside the package, each with the counts set to
      0 just before it and read just after: ``entry.entry()``'s step (one
      K1 launch) against the float64 oracle (<= 5e-6);
      ``entry.dryrun_multichip(1)`` (one spawned NCCL rank on this card,
      every step within 1e-6 of its single-device call, K4 in the
      resampler); ``multihost.run(1, 1, 2^22, 384)`` (a host process and
      its rank: the five checks ok, one K3 in the sharded FIR and one K4
      in the sharded resampler, as the rank's record reports them); the
      examples: ``slow_down_music`` on a 60 s, 44.1 kHz stereo PCM16 WAV
      (2,646,000 frames, numpy seed 0, amplitude 0.25) with exactly one K4
      launch, its output within one PCM16 code of the float64 resample's;
      ``modulation`` (three blocks of 10000 float32 symbols, three K4
      launches, every 10th sample its symbol within 1e-5); ``crosstalk``
      on the same WAV (no kernel) within one code of a float64 einsum's;
      ``streaming_pipeline(8)`` (eight K4 launches; its 64-tap FIR runs
      the whole-extent FFT, no K3), the resampled stream against the
      float64 linear resample delayed by ``output_delay`` and the filtered
      one against the float64 causal linear convolution (<= 5e-6); then
      each of the eight wrappers (K3's through ``circular_conv_cuda`` and
      ``blocked_linear_conv_cuda``) called with an input that requires
      grad must raise, and the same call under ``torch.no_grad()`` equal
      its plain version (<= 2e-6).  The ``kernels`` line's launches
      include phase r's, the dry run's and the rank's among them;
   s. the per-op size sweep and the device smokes' checks, with the counts
      set to 0 just before and read just after (``phase_s``):
      ``examples.bench_tables.main(6, ..., with_f64=True)`` (the JAX
      example's 30 ops, ``vector_creation`` and the two float64 ops at
      10^3..10^6, into a temporary CSV): every row a finite positive eager
      time, its device time (CUDA graph) finite and positive where its
      loop captures, K4 the only kernel launched; one untimed
      ``interpolatef`` call a size launching exactly one K4; every op body
      at n = 4096 on the card within 1e-5 of the same body on CPU copies
      of its inputs (the plain versions).  Then ``smoke_checks``:
      ``smoke_tpu.py``'s 14 families (elementary, trig, fft_roundtrip,
      windowed_fft, convolve_signal, convolve_fn, interpolatef,
      interpolatei, interpft, correlate, statistics, sum_prec,
      matrix_mimo, sfft), each on the card within 1e-5 of the same call
      on the CPU (the JAX smoke asks only that each runs), and
      ``smoke_accuracy_tpu.py``'s checks at its tolerances: the ten
      ``interpolatef`` cases against its scalar oracle (<= 2e-4; "rational
      1.5x real 64k" exactly one K4 launch), ``convolve_signal`` Toeplitz
      at n = 3000, m = 31 (<= 1e-5), ``decimatei`` and ``zero_interleave``
      (exact), ``plain_fft`` at 4096 and 2^20 (<= 5e-5), and
      ``interpolate_lin`` / ``interpolate_hermite`` in four cases
      (<= 2e-4).  Every one of the two smokes' checks runs here; the
      ``kernels`` line's launches include phase s's;
4. the kernels line, the script's one timing output: each kernel (K1-K8,
   and K1n, K1's entry in spectrum order, beside its yardstick K1 and the
   flatten's copy) at its main path's shape against its plain version and
   its library call (one PyTorch call computing the same function, where
   there is one), in turns (CUDA-event medians of 20 after warm-up); its
   device time from a CUDA-graph replay of its calls (``graph_ms``; the row's
   ``device_ms``, null below the kernel's bound) beside what
   ``torch.profiler`` reads, which has dropped kernel events on the card;
   and its bound, the larger of its compulsory bytes over 3.35 TB/s and
   its FP32 operations over 67 TFLOP/s (``dspbench/floors.py``, the
   benchmark's roofline arithmetic), from this run's shapes (a FIR's
   operations the cheaper of the direct sum's and overlap-save's).  K3
   also with its taps' spectrum H computed in the call and against the
   block call ``ifft(fft(blocks) * H)``; K7 beside its yardsticks, the
   Toeplitz FIR and window it replaced (its plain version, with the
   chain's held band matrices) and K3 in circular mode on the same planes
   and taps (fft_len 4096), also by CUDA-graph replay; K8 beside its plain
   version, the Karatsuba matmuls it replaced, and ``torch.fft.fft`` down
   the columns.  The paths are timed by the benchmark's cells
   (``dspbench/``), not here;
   o. ``profiling``: ``time_op`` and ``throughput`` of ``FirFftChainPlanar``
      within 2x of a CUDA-event median of the same call taken beside
      them, and ``trace`` writing a non-empty Chrome trace into a
      temporary directory;
   t. the benchmark programs (``basic_dsp_tpu_torch/bench/``), with the
      counts set to 0 just before and read just after (``phase_t``):
      ``bench_torch.py``'s ``main()``, then with ``BENCH_FUSED=1``, each printing exactly one stdout line
      ``{"metric": "fir_fft_chain_throughput", "value", "unit",
      "vs_baseline"}``, its one eager call launching K7, K8 and K1 (K7
      and K2 when fused);
      ``bench_all`` over the five configs and the overlap-save A/B
      (``BDSP_BENCH_AB=1``), ``--json`` into the work directory, each
      config launching the kernels of its row (K1, none, K4, K4, K6; K3 in
      the A/B's kernel body, none in its library body);
      ``bench_scaling`` at d = 1 on one NCCL rank (each workload within
      1e-5 of its single-device function); ``round_summary`` over the
      work directory.  Every slope is positive, every ``vs_baseline`` at
      or below 1.0 (no capture beats its floor) and TF32 off.  It runs
      after phase 4, whose profiler windows it would otherwise follow
      with its own and with its CUDA-graph captures; a capture leaves
      the launch counts as they were (the wrappers count no launch while
      a graph is captured), so the
      ``kernels`` line's launches include phase t's eager ones only;
   u. K3's bank (``phase_u``; alone: ``python3 -c "import chip_smoke,
      tempfile; chip_smoke.phase_u(tempfile.mkdtemp())"``):
      ``conv_blocks_cuda`` with (P, fft_len) spectra, one launch each,
      against ``conv_blocks_plain`` at five geometries, among them the GPS
      L1 C/A bank's chunk (12 rows of 4092 taps over 2^20 + 4091 samples
      at 16384), a circular real signal and one row; the 1-D launch at
      cell 2's shape against its plain version; ``StreamingFir`` with the
      (12, 4092) bank over four 2^20 chunks, one launch a chunk, against
      twelve 1-D streams; the bank launch and twelve 1-D launches timed by
      replay;
   n. last, so that no earlier phase runs tuned knobs: ``autotune.calibrate()``
      with JAX's defaults into a temporary cache (every earlier phase reads
      the default knobs from it), the table printed beside the card's name
      and power limit, ``ensure_calibrated`` from a reset state reporting
      "cache", a typed ``convolve_signal`` under the tuned knobs (<= 5e-6),
      and the default config restored.

The line before the last is a JSON object describing each kernel; the
last line is ``{"ok": true, "device": {...}}``.
"""
import concurrent.futures
import contextlib
import ctypes
import glob
import io
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

N = 1 << 22
TAPS = 128
GEOMETRIES = [(8, 256), (8, 16384), (128, 32768), (16, 65536), (64, 131072)]
# K1, K2: (16, 65536) and (64, 131072) run the row kernel's 16-block
# clusters, three blocks an SM and one; K2's n1 = 24 and 1016 take stage 1's
# direct sum, and the power-of-two n1 reach every stage1_panels<n1>
# compiled (8 to 1024; 1024: the narrowest panel, 4 columns).
FUSED_GEOMETRIES = [(8, 256), (24, 4096), (128, 32768), (64, 131072),
                    (16, 512), (32, 1024), (256, 2048), (512, 256),
                    (1024, 256), (1016, 256)]
# K8: the chain's stage 1 at 2^22, the widest panel (n1 = 8, 128 columns)
# and the narrowest (n1 = 1024, 4 columns).
STAGE1_GEOMETRIES = [(8, 4096), (128, 32768), (1024, 4096)]
CONV_TAPS = 384
CONV_FFT_LEN = 4096
# K3 (n, taps, fft_len): n below fft_len (700) and n not a multiple of 4
# (5001) take the kernel's single loads; 8192 and 16384 its unstaged blocks.
# The streaming FIR (phase k) and the sharded convolution (phase m) run K3 in
# linear mode on the extended signal, n + CONV_TAPS - 1.
STREAM_CHUNK, STREAM_CHUNKS = 1 << 16, 64
OS_GEOMETRIES = [(4096, 33, 1024), (8192, 129, 2048), (5000, 63, 1024),
                 (N, CONV_TAPS, CONV_FFT_LEN), (1 << 20, 385, 8192),
                 (1 << 20, 4097, 16384), (700, 129, 1024), (5001, 63, 1024),
                 (STREAM_CHUNK + CONV_TAPS - 1, CONV_TAPS, CONV_FFT_LEN),
                 (N + CONV_TAPS - 1, CONV_TAPS, CONV_FFT_LEN)]
# K7 (n, taps, window): the chain's two lengths of taps at 2^22; 1500, one
# tile (2048 outputs) whose loads wrap at both ends; 5001, which 4 does not
# divide (single loads and stores), no window; a ragged last tile; taps
# longer than the signal (clipped to 100).
FIR_GEOMETRIES = [(N, TAPS, True), (N, 202, True), (1500, 202, True),
                  (5001, 7, False), (2 * 2048 + 36, TAPS, True),
                  (100, 301, True)]
KERNEL_TOL = 2e-6
SHARD_TOL = 1e-6       # a sharded function against its single-device one
FFT_TOL = 1e-6         # an FFT against torch.fft.fft, of max |X|
FFT64_TOL = 2e-6       # an FFT against the float64 numpy FFT, of max |X|
MIMO_TAPS = 64
PAR_CHUNKS = 16
CHAIN_TOL = 5e-6
STATS_TOL = 1e-5
PREC_TOL = 1e-12
MAT_ROWS, MAT_N, MAT_TAPS = 8, 1 << 19, 33
BUDGETS = (None, "high", "high-xla", "high-kernel")
REPS = 20
# Resampler geometries (P, Q, L, n); K4 also at interpolate_lin's 2-tap
# geometry (5/2, delay 0.3, zero offsets) below.  resample_runs at one
# phase a lane (Q <= 2: 3/2, x10, 2/1, P > 32 at 64/1, a 32-word window at
# L = 15) and with the phases walked (5/4, 6/5; P > 32 in ragged groups at
# 41/33; steps of 2 and 3 words, a reload, at 7/16); the direct stencil
# for 2L+1 > 32 (2/1 at L = 20).
K4_GEOMETRIES = [(3, 2, 10, 1 << 20), (10, 1, 10, 1 << 17), (2, 1, 5, 4096),
                 (5, 4, 10, 8192), (6, 5, 10, 1 << 16), (64, 1, 10, 20001),
                 (3, 2, 15, 1 << 16), (41, 33, 7, 20001),
                 (7, 16, 10, 1 << 16), (2, 1, 20, 5000)]
K5_GEOMETRIES = [(160, 147, 10, 1 << 20), (160, 147, 10, (1 << 20) + 37),
                 (147, 160, 10, 1 << 16)]
CFG3_N = 1 << 20
CFG4_SYMBOLS = 1 << 17
AUDIO_N = 1 << 20
AUDIO_CHUNK, AUDIO_CHUNKS = 150528, 7     # 8 * 128 * 147 samples a chunk
AUDIO_CHANNELS, AUDIO_BLOCK_CHUNKS = 64, 3   # the audio cell's MADI block
CHAN_N = 1 << 22
CHAN_C = 1024
CHAN_TAPS = 8
# K6 geometries (C, S, taps per phase, prefix: None, "zero" as phase m's
# first rank passes, or "random")
K6_GEOMETRIES = [(CHAN_C, CHAN_N // CHAN_C, CHAN_TAPS, None),
                 (CHAN_C, CHAN_N // CHAN_C, CHAN_TAPS, "zero"),
                 (256, 1024, 4, None), (512, 4099, CHAN_TAPS, "random"),
                 (2048, 64, 15, None)]


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


def resample_oracle(x, fun, P, Q, L, out_len, delay=0.0, circular=True):
    """out[i] = sum_t x[((i//P)*Q + offs[p] + t - L) mod n]
    * fun(t - L - frac[p] + delay), p = i % P, offs[p] = (p*Q)//P,
    frac[p] = (p*Q mod P)/P, in float64 (complex128) on x's device, with
    the taps sampled in float64; not ``circular``: x zero outside [0, n)
    (the linear resample)."""
    n, dev = x.shape[-1], x.device
    p = np.arange(P)
    offs = torch.from_numpy((p * Q) // P).to(dev)
    frac = torch.from_numpy(((p * Q) % P) / P).to(dev)
    s = torch.arange(-L, L + 1, dtype=torch.float64, device=dev)
    taps = fun.calc(s[None, :] - frac[:, None] + delay)
    i = torch.arange(out_len, device=dev)
    ph = i % P
    idx = ((i // P) * Q + offs[ph])[:, None] + s.long()[None, :]
    xd = x.to(torch.complex128 if x.is_complex() else torch.float64)
    if circular:
        return (xd[..., idx % n] * taps[ph]).sum(-1)
    inside = (idx >= 0) & (idx < n)
    xs = torch.where(inside, xd[..., idx.clamp(0, n - 1)], 0)
    return (xs * taps[ph]).sum(-1)


def evened(n, P, Q):
    """interpolatef's output length of a real signal: round(n P/Q),
    evened."""
    m = int(round(n * P / Q))
    return m + m % 2


def z_err(got, ref):
    """max |z - z_ref| / max |z_ref| of (zr, zi) plane pairs, and the
    maximum absolute error."""
    d = float(torch.hypot(got[0] - ref[0], got[1] - ref[1]).max())
    return d / float(torch.hypot(ref[0], ref[1]).max()), d


def angle_err(ang, ang_ref, zr, zi):
    """max(|z| * |wrap(ang - ang_ref)|) / max |z|, in float64: an angle
    where |z| ~ 0 has no defined phase to disagree about."""
    d = ang.double() - ang_ref.double()
    d = torch.atan2(torch.sin(d), torch.cos(d)).abs()
    amp = torch.hypot(zr.double(), zi.double())
    return float((amp * d).max() / amp.max())


def chan_oracle(xr, xi, taps_merged, C):
    """The channelizer in float64 on the card: the merged-tap stencil over
    zero-padded rows, C * ifft in complex128, and z = y * conj(prev) with
    prev[0] = y[0].  Returns the channels y and z, both (C, S)."""
    S = xr.shape[-1] // C
    tp1 = taps_merged.shape[0]
    X = torch.complex(xr.double(), xi.double()).reshape(S, C)
    ext = torch.cat([torch.zeros((tp1 - 1, C), dtype=X.dtype,
                                 device=X.device), X])
    ts = taps_merged.double()
    u = sum(ts[p] * ext[tp1 - 1 - p:tp1 - 1 - p + S] for p in range(tp1))
    y = C * torch.fft.ifft(u, dim=-1)
    z = y * torch.cat([y[:1], y[:-1]]).conj()
    return y.T, z.T


def pcm16_steps(frames, want):
    """The largest difference in PCM16 codes between the (n, 2) frames of
    a PCM16 file as read (code / 32768) and the codes that the writer
    gives the (2, n) float64 result ``want`` (rint(clip(want) * 32767),
    half to even)."""
    got = torch.from_numpy(frames.T.copy()).to(want.device).double() * 32768
    return float((got - torch.round(want.clamp(-1, 1) * 32767)).abs().max())


def graph_ms(fn, calls=20, pairs=3):
    """Device ms a call of ``fn()``: ``calls`` and 3 x ``calls`` calls
    captured in CUDA graphs and replayed between CUDA events, the median
    of ``pairs`` pair slopes (``bench/timing.py``), so no host dispatch
    and no profiler; None where the calls do not capture."""
    from basic_dsp_tpu_torch.bench import timing

    def loop(k):
        for _ in range(k):
            out = fn()
        return out
    graphs = timing.Graphs(loop)
    try:
        return timing.slope(graphs.seconds, calls, pairs).seconds * 1e3
    except RuntimeError:
        return None
    finally:
        graphs.close()


def in_turns(name, fns, smi):
    """Median ms of each function of ``fns`` (label -> fn), run in turns:
    in order, then in reverse (plain, kernel, kernel, plain for two); each
    run a median of REPS."""
    runs = {label: [] for label in fns}
    for label in list(fns) + list(reversed(fns)):
        runs[label].append(median_ms(fns[label]))
    med = {label: float(np.median(r)) for label, r in runs.items()}
    print(f"{name}: " + ", ".join(f"{k} {v:.4f} ms" for k, v in med.items())
          + f" (each a median of {REPS}; runs "
          + "; ".join(f"{k} {r}" for k, r in runs.items()) + f") on {smi}")
    return med


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


class CVectorResult(ctypes.Structure):
    _fields_ = [("result_code", ctypes.c_int32), ("vector", ctypes.c_void_p)]


class CRealStatistics(ctypes.Structure):
    _fields_ = [("sum", ctypes.c_double), ("count", ctypes.c_uint64),
                ("average", ctypes.c_double), ("rms", ctypes.c_double),
                ("min", ctypes.c_double), ("min_index", ctypes.c_uint64),
                ("max", ctypes.c_double), ("max_index", ctypes.c_uint64)]


C_MAP = ctypes.CFUNCTYPE(ctypes.c_double, ctypes.c_double, ctypes.c_size_t,
                         ctypes.c_void_p)
C_WINDOW = ctypes.CFUNCTYPE(ctypes.c_double, ctypes.c_void_p,
                            ctypes.c_size_t, ctypes.c_size_t)


def c_abi(lib):
    """Argument and result types of the C ABI calls phase q makes
    (interop/include/basic_dsp_tpu.h)."""
    handle, f32, size = ctypes.c_void_p, ctypes.c_float, ctypes.c_size_t
    i32 = ctypes.c_int32
    for name, restype, argtypes in (
            ("bdsp_init", i32, []),
            ("bdsp_last_error", ctypes.c_char_p, []),
            ("from_data32", handle, [i32, i32, f32, ctypes.POINTER(f32),
                                     size]),
            ("get_data32", i32, [handle, ctypes.POINTER(f32), size]),
            ("get_len32", size, [handle]),
            ("clone32", handle, [handle]),
            ("delete_vector32", None, [handle]),
            ("convolve_signal32", CVectorResult, [handle, handle]),
            ("interpolatef32", CVectorResult, [handle, i32, f32, f32, f32,
                                               size]),
            ("windowed_fft32", CVectorResult, [handle, i32]),
            ("magnitude32", CVectorResult, [handle]),
            ("real_statistics32", i32, [handle,
                                        ctypes.POINTER(CRealStatistics)]),
            ("map_inplace_real32", CVectorResult, [handle, C_MAP, handle]),
            ("apply_custom_window32", CVectorResult, [handle, C_WINDOW,
                                                      handle, i32])):
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes
    return lib


def c_array(handle):
    """The tensor of the vector behind a C ABI handle (a DspVec's first
    member is its Python vector)."""
    obj = ctypes.cast(handle, ctypes.POINTER(ctypes.c_void_p))[0]
    return ctypes.cast(obj, ctypes.py_object).value.array


SWEEP_MAX_EXP = 6      # phase s: the per-op sweep at 10^3 .. 10^6
SWEEP_TOL = 1e-5       # an op body on the card against its CPU run
SWEEP_CHECK_N = 4096
SMOKE_TOL = 1e-5       # a smoke family on the card against its CPU run


def phase_s(work):
    """s. the per-op size sweep (``examples/bench_tables.py``) and the
    checks of the JAX repository's device smokes (``smoke_checks``) on the
    card; returns the phase's launches by kernel."""
    from basic_dsp_tpu_torch import kernels as bkernels
    from basic_dsp_tpu_torch import smoke_checks
    from basic_dsp_tpu_torch.examples import bench_tables

    t0 = time.perf_counter()
    dev = torch.device("cuda")
    bkernels.reset_launch_counts()
    csv = os.path.join(work, "bench_tables.csv")
    with contextlib.redirect_stdout(io.StringIO()):   # its rows, below
        rows, no_graph = bench_tables.main(SWEEP_MAX_EXP, csv, with_f64=True)
    sweep = bkernels.launch_counts()
    with open(csv) as f:
        first = f.readline().strip()
    ops = list(bench_tables.build_ops()) + ["vector_creation"] \
        + list(bench_tables.F64_OPS)
    sizes = [10 ** e for e in range(3, SWEEP_MAX_EXP + 1)]
    print(f"s: sweep 10^3..10^{SWEEP_MAX_EXP} --with-f64: {len(rows)} rows "
          f"in {time.perf_counter() - t0:.2f} s, {first!r}; launches "
          f"{sweep}; no CUDA graph: {no_graph}")
    assert len(rows) == len(ops) * len(sizes), len(rows)
    assert {(r[0], r[1]) for r in rows} == {(o, n) for o in ops
                                            for n in sizes}
    for name, n, sec, dev_sec in rows:
        assert math.isfinite(sec) and sec > 0, (name, n, sec)
        assert dev_sec is None or (math.isfinite(dev_sec) and dev_sec > 0)
    assert sweep["K4"] > 0 and sum(sweep.values()) == sweep["K4"], sweep
    by = {(r[0], r[1]): r for r in rows}
    print("s: op, eager us / device us a call at " + ", ".join(
        f"10^{e}" for e in range(3, SWEEP_MAX_EXP + 1)))
    for name in ops:
        print(f"s:   {name}: " + ", ".join(
            f"{by[(name, n)][2] * 1e6:.2f} / "
            + ("-" if by[(name, n)][3] is None
               else f"{by[(name, n)][3] * 1e6:.2f}") for n in sizes))

    # each interpolatef row's call launches K4 once
    rng = np.random.default_rng(0)
    body = bench_tables.build_ops()["interpolatef"]
    for n in sizes:
        x_re, x_im, h, win = bench_tables.inputs(n, rng, dev)
        before = bkernels.launch_counts()
        out = body(x_re, x_im, (win, win), torch.zeros_like(x_re))
        torch.cuda.synchronize()
        after = bkernels.launch_counts()
        delta = {k: after[k] - before[k] for k in after}
        assert out.shape == (n * 3 // 2,) and delta["K4"] == 1 \
            and sum(delta.values()) == 1, (n, delta)
    print(f"s: interpolatef x1.5 at {sizes}: one K4 launch a call")

    # each op body on the card against the same body on CPU copies of its
    # inputs (the plain versions)
    x_re, x_im, h, win = bench_tables.inputs(SWEEP_CHECK_N, rng, dev)
    carry = torch.from_numpy((rng.normal(size=SWEEP_CHECK_N) * 1e-3)
                             .astype(np.float32)).to(dev)
    x64 = torch.from_numpy(rng.normal(size=SWEEP_CHECK_N)).to(dev)
    worst = (-1.0, "")
    for name, body in {**bench_tables.build_ops(),
                       **bench_tables.F64_OPS}.items():
        r, i = (x64, x64) if name in bench_tables.F64_OPS else (x_re, x_im)
        aux = bench_tables.aux_for(name, h, win)
        got = body(r, i, aux, carry)
        ref = body(r.cpu(), i.cpu(), tuple(a.cpu() for a in aux),
                   carry.cpu())
        err = rel_err(got.cpu().to(ref.dtype), ref)
        assert got.shape == ref.shape and err <= SWEEP_TOL, (name, err)
        worst = max(worst, (err, name))
    print(f"s: every op body at n = {SWEEP_CHECK_N} on the card against its "
          f"CPU run: worst {worst[0]:.3e} ({worst[1]}; tol {SWEEP_TOL})")

    # smoke_tpu.py's families: on the card, against the same call on the CPU
    card = smoke_checks.families(dev)
    host = smoke_checks.families("cpu")
    for name, got in card.items():
        ref = host[name]
        err = float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))
        print(f"s: smoke family {name}: shape {got.shape}, {err:.3e} from "
              f"its CPU run (tol {SMOKE_TOL})")
        assert got.shape == ref.shape and np.all(np.isfinite(got))
        assert err <= SMOKE_TOL, (name, err)
    assert len(card) == 14
    # smoke_accuracy_tpu.py's checks against its numpy oracles
    for rec in smoke_checks.accuracy(dev):
        ran = {k: v for k, v in rec["launches"].items() if v}
        print(f"s: {rec['name']}: {rec['err']:.3e} (tol {rec['tol']}), "
              f"launches {ran}")
        assert rec["ok"], rec
        if rec["name"].startswith("rational 1.5x real 64k"):
            assert ran == {"K4": 1}, ran
    counts = bkernels.launch_counts()
    print(f"s: phase s took {time.perf_counter() - t0:.2f} s; its launches "
          f"{counts}")
    return counts


# K3's bank (rows, taps, n, fft_len, mode, real signal): the L1 C/A
# matched-filter bank's chunk, 12 rows of 4092 taps over 2^20 + 4091
# samples at 16384 (unstaged blocks); a staged length, circular, a real
# signal, then a complex one of odd length (its loads wrap onto odd
# points); more rows than resident blocks need; one row.  Each complex
# signal also goes in whole, as a complex64 tensor.
BANK_GEOMETRIES = [(12, 4092, (1 << 20) + 4091, 16384, "linear", False),
                   (5, 300, 50001, 2048, "circular", True),
                   (4, 300, 50001, 2048, "circular", False),
                   (3, 129, 4096 * 300 + 17, 1024, "linear", False),
                   (1, 385, 1 << 18, 8192, "linear", False)]
BANK_CHUNK, BANK_CHUNKS = 1 << 20, 4


def phase_u(work):
    """u. K3's bank: ``conv_blocks_cuda`` with (P, fft_len) spectra, one
    launch, against ``conv_blocks_plain`` at ``BANK_GEOMETRIES``; the 1-D
    launch at cell 2's shape against its plain version (the route the bank
    leaves as it was); ``StreamingFir`` with the (12, 4092) bank over four
    2^20 chunks, one launch a chunk, against twelve 1-D streams; the bank
    launch's device time by replay against twelve 1-D launches.  Returns
    the phase's launches by kernel."""
    from basic_dsp_tpu_torch import kernels as bkernels
    from basic_dsp_tpu_torch import streaming
    from basic_dsp_tpu_torch.kernels import overlap_save_cuda as osc

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(20)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    bkernels.reset_launch_counts()
    for rows, m, n, fl, mode, real in BANK_GEOMETRIES:
        xr = randn(n)
        xi = None if real else randn(n)
        H = osc.spectrum(randn(rows, m), fl)
        linear = mode == "linear"
        before = osc.conv_blocks_cuda.launches
        got = osc.conv_blocks_cuda(xr, xi, H, m, fl, linear=linear)
        ref = osc.conv_blocks_plain(xr, xi, H, m, fl, linear=linear)
        torch.cuda.synchronize()
        err = rel_err(got, ref)
        pad, L, _ = osc._geometry(n, m, fl)
        lim = ref.shape[-1]
        group = osc.bank_group(-(-lim // L), rows, osc._bank_resident(
            dev, fl.bit_length() - 1, linear, False))
        print(f"u: K3 bank vs plain at (rows={rows}, taps={m}, n={n}, "
              f"fft_len={fl}, {mode}, {'real' if real else 'complex'} "
              f"signal): {err:.3e} relative to max (tol {KERNEL_TOL}), "
              f"{osc.conv_blocks_cuda.launches - before} launch, rows a "
              f"work item {group}")
        assert got.shape == ref.shape == (rows, lim) and got.dtype == \
            torch.complex64, (got.shape, got.dtype)
        assert err <= KERNEL_TOL, (rows, m, n, fl, err)
        assert osc.conv_blocks_cuda.launches - before == 1
        if not real:
            # the complex64 signal whole, as StreamingFir hands it over
            whole = osc.conv_blocks_cuda(torch.complex(xr, xi), None, H, m,
                                         fl, linear=linear)
            err = rel_err(whole, ref)
            print(f"u: K3 bank, the complex signal whole: {err:.3e}, "
                  f"bit-equal to the planes' launch: "
                  f"{bool(torch.equal(whole, got))}")
            assert whole.shape == ref.shape and err <= KERNEL_TOL, err
            assert torch.equal(whole, got)
            del whole
        if real:
            got = osc.conv_blocks_cuda(xr, None, H, m, fl, linear=linear,
                                       imag=False)
            err = rel_err(got, ref.real)
            print(f"u: K3 bank, real parts only: {err:.3e}")
            assert got.dtype == torch.float32 and err <= KERNEL_TOL
    del got, ref, xr, xi, H

    # the 1-D route at cell 2's shape, as before
    xr, xi, h = randn(N + CONV_TAPS - 1), randn(N + CONV_TAPS - 1), \
        randn(CONV_TAPS)
    H1 = osc.spectrum(h, CONV_FFT_LEN)
    got = osc.conv_blocks_cuda(xr, xi, H1, CONV_TAPS, CONV_FFT_LEN,
                               linear=True)
    ref = osc.conv_blocks_plain(xr, xi, H1, CONV_TAPS, CONV_FFT_LEN,
                                linear=True)
    torch.cuda.synchronize()
    err, _ = planes_err(got, ref)
    print(f"u: K3 1-D linear at (n={N + CONV_TAPS - 1}, taps={CONV_TAPS}, "
          f"fft_len={CONV_FFT_LEN}): {err:.3e} (tol {KERNEL_TOL}), shape "
          f"{tuple(got.shape)}")
    assert got.shape == ref.shape == (2, N + 2 * CONV_TAPS - 2)
    assert err <= KERNEL_TOL, err
    del got, ref, xr, xi

    # StreamingFir: the bank against twelve 1-D streams
    rows, m = BANK_GEOMETRIES[0][:2]
    taps = torch.where(randn(rows, m) > 0, 1.0, -1.0)
    x = torch.complex(randn(BANK_CHUNK * BANK_CHUNKS),
                      randn(BANK_CHUNK * BANK_CHUNKS))
    bank = streaming.StreamingFir(taps)
    state = bank.init_state(x.dtype)
    before = osc.conv_blocks_cuda.launches
    chunks0, rows0 = streaming.StreamingFir.chunks, streaming.StreamingFir.rows
    outs = []
    for k in range(BANK_CHUNKS):
        out, state = bank.process(x[k * BANK_CHUNK:(k + 1) * BANK_CHUNK],
                                  state)
        outs.append(out)
    torch.cuda.synchronize()
    bank_launches = osc.conv_blocks_cuda.launches - before
    y = torch.cat(outs, dim=-1)
    del outs
    worst = 0.0
    before = osc.conv_blocks_cuda.launches
    for p in range(rows):
        one = streaming.StreamingFir(taps[p])
        st = one.init_state(x.dtype)
        pieces = []
        for k in range(BANK_CHUNKS):
            o, st = one.process(x[k * BANK_CHUNK:(k + 1) * BANK_CHUNK], st)
            pieces.append(o)
        worst = max(worst, rel_err(y[p], torch.cat(pieces)))
    row_launches = osc.conv_blocks_cuda.launches - before
    print(f"u: StreamingFir bank ({rows}, {m}) over {BANK_CHUNKS} chunks of "
          f"{BANK_CHUNK}: conv_blocks_cuda launches {bank_launches} (twelve "
          f"1-D streams: {row_launches}), StreamingFir.chunks "
          f"{streaming.StreamingFir.chunks - chunks0}, rows "
          f"{streaming.StreamingFir.rows - rows0} (both with the 1-D "
          f"streams'); bank vs 1-D streams {worst:.3e} relative to max")
    assert y.shape == (rows, BANK_CHUNK * BANK_CHUNKS)
    assert bank_launches == BANK_CHUNKS and row_launches == rows * BANK_CHUNKS
    assert worst <= KERNEL_TOL, worst
    del y

    # device time: the bank launch (the complex signal whole, as
    # StreamingFir hands it over, and planes) against twelve 1-D launches
    n = BANK_CHUNK + m - 1
    xr, xi = randn(n), randn(n)
    xc = torch.complex(xr, xi)
    H = osc.spectrum(taps, 16384)
    bank_ms = graph_ms(lambda: osc.conv_blocks_cuda(xc, None, H, m, 16384,
                                                    linear=True))
    planes_ms = graph_ms(lambda: osc.conv_blocks_cuda(xr, xi, H, m, 16384,
                                                      linear=True))
    rows_ms = graph_ms(lambda: [osc.conv_blocks_cuda(xr, xi, H[p], m, 16384,
                                                     linear=True)
                                for p in range(rows)])
    print(f"u: device ms by replay, one chunk: bank {bank_ms} (planes "
          f"{planes_ms}), twelve 1-D launches {rows_ms}")
    return bkernels.launch_counts()


def phase_t(work):
    """t. the benchmark programs on the card; returns the phase's launches
    by kernel."""
    from basic_dsp_tpu_torch import kernels as bkernels
    from basic_dsp_tpu_torch.bench import (bench, bench_all, bench_scaling,
                                           round_summary, timing)

    import basic_dsp_tpu_torch as bt

    t0 = time.perf_counter()
    bkernels.reset_launch_counts()
    assert timing.tf32_off(), "TF32 must be off"
    saved = bt.default_config()     # the programs pin their knobs
    for env, want in (({}, {"K7": 1, "K8": 1, "K1n": 1}),
                      ({"BENCH_FUSED": "1"}, {"K7": 1, "K2": 1})):
        out, err = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rec = bench.main([], env=env)
        lines = out.getvalue().splitlines()
        print(f"t: bench_torch.py {env or '(unfused)'}: stdout "
              f"{lines}; graph {rec['graph_ms']:.4f} ms/iter (spread "
              f"{rec['spread']:.3f}x), eager {rec['eager_ms']:.4f}, floor "
              f"{rec['floor_ms']:.4f} ms ({rec['bound']}: bytes "
              f"{rec['bytes_ms']:.4f}, operations {rec['flops_ms']:.4f}); "
              f"launches {rec['launches']}; on {rec['card']}")
        for line in err.getvalue().splitlines():
            if line.startswith(("# L2", "# floor", "# median")):
                print(f"t:   {line[2:]}")
        assert len(lines) == 1, lines
        line = json.loads(lines[0])
        assert list(line) == ["metric", "value", "unit", "vs_baseline"]
        assert line["metric"] == "fir_fft_chain_throughput"
        assert line["unit"] == "Msamples/s" and line["value"] > 0
        assert 0 < line["vs_baseline"] <= 1.0, line
        assert rec["graph_ms"] > 0 and rec["eager_ms"] > 0
        assert rec["launches"] == want, rec["launches"]
        print(f"t:   at {time.perf_counter() - t0:.2f} s of phase t")

    path = os.path.join(work, round_summary.BENCH_ALL)
    os.environ["BDSP_BENCH_AB"] = "1"
    try:
        with contextlib.redirect_stderr(io.StringIO()):
            session = bench_all.main(["--json", path])
    finally:
        del os.environ["BDSP_BENCH_AB"]
    print(f"t: bench_all: health probe {session['probe_us']:.3f} us/iter "
          f"on {session['card']}; at {time.perf_counter() - t0:.2f} s of "
          f"phase t")
    for rec in session["configs"]:
        print(f"t:   {rec['metric']}: {rec['measured_ms']:.4f} ms "
              f"({rec['timing']}; eager {rec['eager_ms']:.4f}, graph "
              f"{rec['graph_ms']}), {rec['value']} Msamples/s, floor "
              f"{rec['floor_ms']:.4f} ms ({rec['bound']}), vs_baseline "
              f"{rec['vs_baseline']}, spread {rec['slope_spread']}, launches "
              f"{rec['launches']}, idle share {rec['idle_share']}"
              + (f"; io bound {rec['model']['io_bound_ms'] * 1e3:.2f} us"
                 if "io_bound_ms" in rec["model"] else "")
              + (f"; no graph: {rec['no_graph']}" if rec["no_graph"]
                 else ""))
        assert rec["measured_ms"] > 0 and rec["eager_ms"] > 0
        assert 0 < rec["vs_baseline"] <= rec["max_vs_floor"] == 1.0, rec
        assert rec["launches"] == dict.fromkeys(rec["kernels"], 1), rec
    assert len(session["configs"]) == 7
    with open(path) as f:
        assert json.load(f)["configs"] == session["configs"]

    scaling = os.path.join(work, round_summary.SCALING)
    with contextlib.redirect_stdout(io.StringIO()):
        record = bench_scaling.main(["--devices", "1", "--out", scaling])
    for name, e in record["workloads"].items():
        p = e["strong"][0]
        print(f"t: bench_scaling d=1 {name}: strong {p['ms']:.4f} ms "
              f"({p['msamples_per_s']:.1f} Msamples/s), weak "
              f"{e['weak'][0]['ms']:.4f} ms, {p['err']:.3e} from its "
              f"single-device function, on {record['card']}")
        assert p["ms"] > 0 and p["err"] <= bench_scaling.TOL, (name, p)
    print(f"t: bench_scaling at {time.perf_counter() - t0:.2f} s of phase t")
    table = round_summary.lines(work)
    assert len(table) == 2 + 7 + 1 + 4, table
    for line in table:
        print(f"t: round_summary: {line}")
    bt.set_default_config(saved)
    counts = bkernels.launch_counts()
    print(f"t: phase t took {time.perf_counter() - t0:.2f} s; its launches "
          f"{counts}")
    return counts


def main(work):
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
    from basic_dsp_tpu_torch import kernels as bkernels
    from basic_dsp_tpu_torch import profiling, streaming
    from basic_dsp_tpu_torch.bench import timing
    from basic_dsp_tpu_torch.kernels import _build
    from basic_dsp_tpu_torch.kernels import channelizer_cuda as chc
    from basic_dsp_tpu_torch.kernels import fir_cuda as fcu
    from basic_dsp_tpu_torch.kernels import overlap_save_cuda as osc
    from basic_dsp_tpu_torch.kernels import resample_cuda as rsc
    from basic_dsp_tpu_torch.kernels import spectrum_cuda as sc
    from basic_dsp_tpu_torch.ops import conv_ops, fourstep, interp_ops
    from basic_dsp_tpu_torch.parallel import channelizer as chz
    from dspbench import floors

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    # The typed convolutions calibrate at their first large call: a
    # temporary cache holding the default knobs for this card keeps every
    # phase before n on them (n calibrates into the same cache).
    os.environ["BDSP_AUTOTUNE_CACHE"] = os.path.join(work, "autotune.json")
    kind = torch.cuda.get_device_name(0)
    with open(os.environ["BDSP_AUTOTUNE_CACHE"], "w") as f:
        json.dump({kind: {"device_kind": kind, "fft_block_len": 0,
                          "direct_conv_max_imp_len": 202}}, f)
    default_cfg = bt.default_config()

    def planes(*shape):
        return (torch.from_numpy(rng.standard_normal(shape, np.float32))
                .to(dev) for _ in range(2))

    def tfac(n1, n2):
        return tuple(torch.from_numpy(p).to(dev)
                     for p in fourstep._dif_twiddle_factored(n1, n2))

    reset_counts = bkernels.reset_launch_counts

    def other_launches():
        return (sc.rowfft_mag.launches + sc.rowfft_mag_natural.launches
                + sc.fourstep_mag_fused.launches
                + osc.conv_blocks_cuda.launches
                + rsc.resample_direct_cuda.launches
                + rsc.resample_rowblock_cuda.launches)

    # 1. build, one nvcc per source, all started together
    t0 = time.perf_counter()
    libs = (sc._lib, osc._lib, rsc._lib, chc._lib, fcu._lib,
            _build.interop_library)
    with concurrent.futures.ThreadPoolExecutor(len(libs)) as pool:
        for f in [pool.submit(lib) for lib in libs]:
            f.result()
    print(f"build: {time.perf_counter() - t0:.2f} s "
          f"({_build.library_path('rowfft_mag').name}, "
          f"{_build.library_path('overlap_save').name}, "
          f"{_build.library_path('resample').name}, "
          f"{_build.library_path('channelizer').name}, "
          f"{_build.library_path('fir_window').name}, "
          f"{_build.interop_library().relative_to(_build.BUILD_DIR)})")

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

    # K1's natural entry: the same launch storing in spectrum order, bit
    # for bit what the flatten of rowfft_mag's layout gives
    k1n_abs_err_4m = None
    natural_cases = [(n1, n2, True, True) for n1, n2 in dict.fromkeys(
        GEOMETRIES + FUSED_GEOMETRIES)] + [(128, 32768, False, False)]
    for n1, n2, shift, twiddled in natural_cases:
        Br, Bi = planes(n1, n2)
        T = tfac(n1, n2) if twiddled else None
        got = sc.rowfft_mag_natural(Br, Bi, shift=shift, Tfac=T)
        ref = sc.natural_flatten(sc.rowfft_mag(Br, Bi, shift=shift, Tfac=T))
        torch.cuda.synchronize()
        same = bool(torch.equal(got, ref))
        print(f"rowfft_mag_natural vs natural_flatten(rowfft_mag) at ({n1}, "
              f"{n2}), shift {shift}, Tfac {twiddled}: bit for bit {same}")
        assert got.shape == (n1 * n2,) and same, (n1, n2, shift, twiddled)
        if (n1, n2, twiddled) == (128, 32768, True):
            plain = sc.rowfft_mag_natural_plain(Br, Bi, True, T)
            k1n_abs_err_4m = float((got - plain).abs().max())
    assert sc.rowfft_mag_natural.launches == len(natural_cases)

    k2_abs_err_4m = None
    row_launches = sc.rowfft_mag.launches
    for n1, n2 in FUSED_GEOMETRIES:
        Ar, Ai = planes(n1, n2)
        got = sc.fourstep_mag_fused(Ar, Ai, shift=True)
        ref = sc.fourstep_mag_fused_plain(Ar, Ai, shift=True)
        torch.cuda.synchronize()
        err = rel_err(got, ref)
        print(f"fourstep_mag_fused vs plain at ({n1}, {n2}): {err:.3e} "
              f"relative to max (tol {KERNEL_TOL})")
        assert got.shape == ref.shape == (n1, n2 // 128, 128)
        assert err <= KERNEL_TOL, (n1, n2, err)
        if (n1, n2) == (128, 32768):
            k2_abs_err_4m = float((got - ref).abs().max())
    assert sc.fourstep_mag_fused.launches == len(FUSED_GEOMETRIES)
    assert sc.rowfft_mag.launches == row_launches

    # K8 against stage1_planar: in float32 (the plain version, itself a
    # dense DFT whose error grows with n1, ~1.8e-6 at 1024) and in float64
    # on the same planes, which the tolerance holds it to
    k8_abs_err_4m = None
    for n1, n2 in STAGE1_GEOMETRIES:
        Ar, Ai = planes(n1, n2)
        got = torch.stack(sc.stage1_cuda(Ar, Ai))
        ref = torch.stack(sc.stage1_plain(Ar, Ai))
        ref64 = torch.stack(fourstep.stage1_planar(
            *(p.double() for p in sc._held_dft(n1, dev)), Ar.double(),
            Ai.double()))
        torch.cuda.synchronize()
        err, abs_err = planes_err(got, ref)
        err64, _ = planes_err(got.double(), ref64)
        print(f"stage1_cuda vs plain at ({n1}, {n2}): {err:.3e} relative "
              f"to max; vs float64 {err64:.3e} (tol {KERNEL_TOL}); plain "
              f"vs float64 {planes_err(ref.double(), ref64)[0]:.3e}")
        assert got.shape == ref.shape == (2, n1, n2)
        assert err64 <= KERNEL_TOL, (n1, n2, err64)
        if (n1, n2) == (128, 32768):
            assert err <= KERNEL_TOL, (n1, n2, err)
            k8_abs_err_4m = abs_err
    assert sc.stage1_cuda.launches == len(STAGE1_GEOMETRIES)
    assert sc.rowfft_mag.launches == row_launches

    os_abs_err_4m = None
    for n, m, fl in OS_GEOMETRIES:
        xr, xi = planes(n)
        hr, hi = planes(m)
        for kind in ("complex", "real"):
            if kind == "real":
                hi = torch.zeros_like(hr)
            for mode, kernel, plain, length in (
                    ("circular", osc.circular_conv_cuda,
                     osc.circular_conv_plain, n),
                    ("linear", osc.blocked_linear_conv_cuda,
                     osc.blocked_linear_conv_plain, n + m - 1)):
                got = kernel(xr, xi, hr, hi, fl)
                ref = plain(xr, xi, hr, hi, fl)
                torch.cuda.synchronize()
                err, abs_err = planes_err(got, ref)
                print(f"K3 {mode} vs plain at (n={n}, taps={m}, "
                      f"fft_len={fl}), {kind} taps: {err:.3e} relative to "
                      f"max (tol {KERNEL_TOL})")
                assert got.shape == ref.shape == (2, length)
                assert err <= KERNEL_TOL, (n, m, fl, kind, mode, err)
                if (n, m, fl, kind, mode) == (N, CONV_TAPS, CONV_FFT_LEN,
                                              "complex", "circular"):
                    os_abs_err_4m = abs_err
        H = osc.spectrum(torch.complex(hr, hi), fl)
        got = osc.conv_blocks_cuda(xr, None, H, m, fl, imag=False)
        ref = osc.conv_blocks_plain(xr, None, H, m, fl, imag=False)
        torch.cuda.synchronize()
        err = rel_err(got, ref)
        print(f"K3 circular vs plain at (n={n}, taps={m}, fft_len={fl}), "
              f"real signal, real part only: {err:.3e} (tol {KERNEL_TOL})")
        assert got.shape == ref.shape == (1, n)
        assert err <= KERNEL_TOL, (n, m, fl, err)
    assert osc.conv_blocks_cuda.launches == 5 * len(OS_GEOMETRIES)
    del got, ref

    sinc = bt.SincFunction()
    lin_taps, lin_L, _ = interp_ops._lin_taps(5, 2, 0.3)
    # phases l and m: the extended chunk (tail T + chunk) and the extended
    # shard (2L + shard), with their own output lengths
    t_x15 = streaming.StreamingResampler(sinc, 1.5, device=dev).T
    t_audio = streaming.StreamingResampler(sinc, 160 / 147, device=dev).T
    resample_checks = (
        [("direct", P, Q, L, n, None, None) for P, Q, L, n in K4_GEOMETRIES]
        + [("direct", 5, 2, lin_L, 1 << 16, lin_taps, None),
           ("direct", 3, 2, 10, STREAM_CHUNK + t_x15, None,
            STREAM_CHUNK * 3 // 2),
           ("direct", 3, 2, 10, CFG3_N + 20, None, CFG3_N * 3 // 2)]
        + [("rowblock", P, Q, L, n, None, None)
           for P, Q, L, n in K5_GEOMETRIES]
        + [("rowblock", 160, 147, 10, AUDIO_CHUNK + t_audio, None,
            AUDIO_CHUNK * 160 // 147)])
    n_direct = sum(c[0] == "direct" for c in resample_checks)
    rs_abs_err = {}
    for kind, P, Q, L, n, taps_np, out_len in resample_checks:
        if taps_np is None:
            taps_k, offs = interp_ops.polyphase_taps(sinc, P, Q, 0.0, L,
                                                     torch.float32, dev)
        else:
            taps_k, offs = taps_np, (0,) * P
        out_len = evened(n, P, Q) if out_len is None else out_len
        wrapper = getattr(rsc, f"resample_{kind}_cuda")
        audio = (kind, P, Q, n) == ("rowblock", 160, 147,
                                    AUDIO_CHUNK + t_audio)
        for nrows in (1, 2) + ((AUDIO_CHANNELS,) if audio else ()):
            rows = torch.from_numpy(
                rng.standard_normal((nrows, n), np.float32)).to(dev)
            got = wrapper(rows, taps_k, P, Q, offs, L, out_len)
            if kind == "direct":
                ref = rsc.resample_direct_plain(rows, taps_k, P, Q, offs, L,
                                                out_len,
                                                interp_ops._choose_c(P, Q))
            else:
                ref = rsc.resample_rowblock_plain(rows, taps_k, P, Q, offs,
                                                  L, out_len)
            torch.cuda.synchronize()
            err = rel_err(got, ref)
            print(f"resample_{kind}_cuda vs plain at (P={P}, Q={Q}, L={L}, "
                  f"n={n}, offs {'0' if taps_np is not None else 'pQ/P'}), "
                  f"{nrows} row(s): {err:.3e} relative to max "
                  f"(tol {KERNEL_TOL})")
            assert got.shape == ref.shape == (nrows, out_len)
            assert got.dtype == torch.float32
            assert err <= KERNEL_TOL, (kind, P, Q, L, n, nrows, err)
            rs_abs_err[(kind, P, Q, n, nrows)] = float(
                (got - ref).abs().max())
    assert rsc.resample_direct_cuda.launches == 2 * n_direct
    assert rsc.resample_rowblock_cuda.launches == 2 * (len(resample_checks)
                                                       - n_direct) + 1
    # K5's two-source form at the audio cell's shape: a (64, 150528)
    # column slice of a wider capture and a (64, T) tail read where they
    # lie, bit-equal to the one-source launch on the rotated extension,
    # and the next tail the last T samples of [tail, chunk]
    taps_k, offs = interp_ops.polyphase_taps(sinc, 160, 147, 0.0, 10,
                                             torch.float32, dev)
    wide = torch.from_numpy(rng.standard_normal(
        (AUDIO_CHANNELS, 2 * AUDIO_CHUNK), np.float32)).to(dev)
    chunk = wide[:, AUDIO_CHUNK:]
    tail = torch.from_numpy(rng.standard_normal(
        (AUDIO_CHANNELS, t_audio), np.float32)).to(dev)
    nxt = torch.empty_like(tail)
    out_len = AUDIO_CHUNK * 160 // 147
    got = rsc.resample_rowblock_cuda(chunk, taps_k, 160, 147, offs, 10,
                                     out_len, tail=tail, next_tail=nxt)
    ref = rsc.resample_rowblock_cuda(
        torch.cat([tail[:, 10:], chunk, tail[:, :10]], dim=-1), taps_k, 160,
        147, offs, 10, out_len)
    torch.cuda.synchronize()
    same = torch.equal(got, ref)
    tail_same = torch.equal(nxt, chunk[:, AUDIO_CHUNK - t_audio:])
    print(f"resample_rowblock_cuda, tail and chunk in place, at "
          f"({AUDIO_CHANNELS}, {AUDIO_CHUNK}) + T {t_audio}: bit-equal to "
          f"the rotated launch {same}, next tail {tail_same}")
    assert same and tail_same
    assert rsc.resample_rowblock_cuda.launches == 2 * (len(resample_checks)
                                                       - n_direct) + 3
    del got, ref, rows, wide, chunk, tail, nxt

    k6_abs_err = None
    for C, S, taps_pp, prefix in K6_GEOMETRIES:
        xr, xi = planes(S * C)
        proto = torch.from_numpy((np.hamming(C * taps_pp) / C)
                                 .astype(np.float32)).to(dev)
        ts = chz._merged_tap_rows(proto, C)
        pre = {None: None,
               "zero": tuple(torch.zeros((chc.HALO_ROWS, C), device=dev)
                             for _ in range(2)),
               "random": tuple(planes(chc.HALO_ROWS, C))}[prefix]
        got = chc.channelize_demod_cuda(xr, xi, ts, C, False, pre)
        ref = chc.channelize_demod_plain(xr, xi, ts, C, False, pre)
        ang = chc.channelize_demod_cuda(xr, xi, ts, C, True, pre)
        ang_ref = chc.channelize_demod_plain(xr, xi, ts, C, True, pre)
        torch.cuda.synchronize()
        err, abs_err = z_err(got, ref)
        a_err = angle_err(ang, ang_ref, *ref)
        print(f"channelize_demod_cuda vs plain at (C={C}, S={S}, "
              f"taps={taps_pp}, prefix {prefix}): "
              f"z {err:.3e}, angles {a_err:.3e} relative to max |z| "
              f"(tol {KERNEL_TOL})")
        assert got[0].shape == got[1].shape == ang.shape == (C, S)
        assert bool(torch.isfinite(ang).all())
        assert err <= KERNEL_TOL and a_err <= KERNEL_TOL, (C, S, err, a_err)
        if prefix != "random":
            assert bool((ang[:, 0] == 0).all())    # row -1 is 0
        if C == CHAN_C and prefix is None:
            k6_abs_err = abs_err
    assert chc.channelize_demod_cuda.launches == 2 * len(K6_GEOMETRIES)
    del got, ref, ang, ang_ref, xr, xi

    k7_abs_err_4m = None
    for n, m, windowed in FIR_GEOMETRIES:
        xr, xi = planes(n)
        taps_f = rc_taps(m, dev)
        win = bt.HammingWindow().sample(n, device=dev) if windowed else None
        got = torch.stack(fcu.fir_window_cuda(xr, xi, taps_f, win))
        ref = torch.stack(fcu.fir_window_plain(xr, xi, taps_f, win))
        torch.cuda.synchronize()
        err, abs_err = planes_err(got, ref)
        print(f"fir_window_cuda vs plain at (n={n}, taps={m}, window "
              f"{windowed}): {err:.3e} relative to max (tol {KERNEL_TOL})")
        assert got.shape == ref.shape == (2, n)
        assert err <= KERNEL_TOL, (n, m, windowed, err)
        if (n, m) == (N, TAPS):
            k7_abs_err_4m = abs_err
    assert fcu.fir_window_cuda.launches == len(FIR_GEOMETRIES)
    del got, ref, xr, xi

    # 3a. main path: the spectrum chain at full size
    taps = rc_taps(TAPS, dev)
    window = bt.HammingWindow().sample(N, device=dev)
    xr, xi = planes(N)
    chain = bt.FirFftChainPlanar(taps, window)
    ref = oracle(xr, xi, taps, window)

    reset_counts()
    out = chain(xr, xi)
    torch.cuda.synchronize()
    k1n_launches = sc.rowfft_mag_natural.launches
    k7_launches = fcu.fir_window_cuda.launches
    k8_launches = sc.stage1_cuda.launches
    print(f"main path: FirFftChainPlanar n={N} (n1={chain.n1}, "
          f"n2={chain.n2}), rowfft_mag_natural launches: {k1n_launches}, "
          f"rowfft_mag launches: {sc.rowfft_mag.launches}, fir_window_cuda "
          f"launches: {k7_launches}, stage1_cuda launches: {k8_launches}")
    assert k1n_launches == 1, "the chain's row stage: not one K1n"
    assert sc.rowfft_mag.launches == 0, "the chain launched rowfft_mag"
    assert k7_launches == 1, "the chain's FIR and window: not one K7"
    assert k8_launches == 1, "the chain's stage 1: not one K8"
    first = (k1n_launches, k7_launches, k8_launches)
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        chain(xr, xi)
        torch.cuda.synchronize()
    ops = {e.key for e in prof.key_averages()}
    print(f"main path: FirFftChainPlanar's profiled call: aten::mm "
          f"{'aten::mm' in ops}, gemm kernels "
          f"{sorted(k for k in ops if 'gemm' in k.lower())}")
    assert "aten::mm" not in ops and not any("gemm" in k.lower()
                                             for k in ops), sorted(ops)
    # the row stage: one K1 launch with T folded, one natural_order
    # transpose, and no PyTorch copy into spectrum order
    rows_k = [(e.key, e.count) for e in prof.key_averages()
              if "rowfft_cluster" in e.key or "natural_order" in e.key]
    copies = sorted(k for k in ops if "elementwise_kernel" in k)
    print(f"main path: FirFftChainPlanar's profiled call: row-stage kernels "
          f"{[(k[:64], c) for k, c in rows_k]}, elementwise kernels "
          f"{copies}")
    assert sorted(c for _, c in rows_k) == [1, 1], rows_k
    assert any(re.search(r"rowfft_cluster<\d+, true>", k)
               for k, _ in rows_k), rows_k
    assert any("natural_order" in k for k, _ in rows_k), rows_k
    assert not copies, copies
    # the profiled call launches what the first did, read from the counters
    k1n_launches = sc.rowfft_mag_natural.launches
    k7_launches = fcu.fir_window_cuda.launches
    k8_launches = sc.stage1_cuda.launches
    assert (k1n_launches, k7_launches, k8_launches) == tuple(
        2 * c for c in first), (first, k1n_launches, k7_launches,
                                k8_launches)
    assert sc.rowfft_mag.launches == 0
    k1_launches = 0
    assert out.shape == (N,) and out.dtype == torch.float32
    assert bool(torch.isfinite(out).all())
    err = rel_err(out.double(), ref)
    print(f"FirFftChainPlanar vs float64 oracle: {err:.3e} relative to max "
          f"(tol {CHAIN_TOL})")
    assert err <= CHAIN_TOL, err

    before = sc.rowfft_mag_natural.launches
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
    assert sc.rowfft_mag_natural.launches == before + 2
    assert sc.rowfft_mag.launches == 0
    # fir_fft_chain's FIR is conv_ops.toeplitz_conv on complex64: no K7;
    # both spectra's complex stage 1 is K8
    assert fcu.fir_window_cuda.launches == 2
    assert sc.stage1_cuda.launches == 4
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
    os_launches = osc.conv_blocks_cuda.launches
    print(f"main path: convolve_signal_planar n={N}, {CONV_TAPS} complex "
          f"taps, conv_blocks_cuda launches: {os_launches}, "
          f"other kernels: {other_launches() - os_launches}")
    assert os_launches == 1, "the conv path did not launch K3 once"
    assert other_launches() == 1
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
    assert osc.conv_blocks_cuda.launches == 2
    # The path runs K3 and the ops of H (osc.spectrum) and nothing else: no
    # fold, wrap or concatenation.
    _, h_ops = timing.device_ms(lambda: osc.spectrum(h, CONV_FFT_LEN))
    _, path_ops = timing.device_ms(
        lambda: conv_ops.convolve_signal_planar(xr, xi, h))
    k3_ops = [k for k in path_ops if "overlap_save_blocks" in k]
    print(f"convolve_signal_planar's kernels: {sorted(path_ops)}")
    if path_ops:
        assert len(k3_ops) == 1, path_ops
        assert set(path_ops) - set(k3_ops) <= set(h_ops), (path_ops, h_ops)
    del conv_ref, got, cr, ci
    taps_long = rc_taps(CONV_TAPS, dev)
    before = sc.rowfft_mag_natural.launches
    got = bt.fir_fft_chain(torch.complex(xr, xi), taps_long, window)
    torch.cuda.synchronize()
    err = rel_err(got.double(), oracle(xr, xi, taps_long, window))
    print(f"fir_fft_chain, {CONV_TAPS} taps (torch.fft overlap-save FIR) "
          f"vs oracle: {err:.3e}")
    assert got.shape == (N,) and err <= CHAIN_TOL, err
    assert sc.rowfft_mag_natural.launches == before + 1
    del got

    # 3c. main path: config #3, x1.5 of 2^20 complex samples (Sinc, L 10)
    rng0 = np.random.default_rng(0)
    x3 = torch.from_numpy((rng0.standard_normal(CFG3_N)
                           + 1j * rng0.standard_normal(CFG3_N))
                          .astype(np.complex64)).to(dev)
    reset_counts()
    y3 = interp_ops.interpolatef(x3, sinc, 1.5, 0.0, 10, 1.0)
    torch.cuda.synchronize()
    cfg3_launches = rsc.resample_direct_cuda.launches
    print(f"main path: interpolatef x1.5 of {CFG3_N} complex samples, "
          f"resample_direct_cuda launches: {cfg3_launches}, "
          f"resample_rowblock_cuda launches: "
          f"{rsc.resample_rowblock_cuda.launches}")
    assert cfg3_launches >= 1, "config #3 did not launch the K4 kernel"
    assert rsc.resample_rowblock_cuda.launches == 0
    assert y3.shape == (CFG3_N * 3 // 2,) and y3.dtype == torch.complex64
    assert bool(torch.isfinite(torch.view_as_real(y3)).all())
    err = rel_err(y3.to(torch.complex128),
                  resample_oracle(x3, sinc, 3, 2, 10, CFG3_N * 3 // 2))
    print(f"interpolatef x1.5 vs float64 oracle: {err:.3e} relative to max "
          f"(tol {CHAIN_TOL})")
    assert err <= CHAIN_TOL, err
    del y3

    # 3d. main path: config #4, the modulation chain (RC 0.35, x10, L 10)
    rng0 = np.random.default_rng(0)
    sym_r, sym_i = (torch.from_numpy(rng0.choice([-0.5, 0.5], CFG4_SYMBOLS)
                                     .astype(np.float32)).to(dev)
                    for _ in range(2))
    mod = bt.ModulationChainPlanar(0.35, 10.0, 0.0, 10, device=dev)
    reset_counts()
    bb_r, bb_i = mod(sym_r, sym_i)
    torch.cuda.synchronize()
    cfg4_launches = rsc.resample_direct_cuda.launches
    print(f"main path: ModulationChainPlanar on {CFG4_SYMBOLS} symbols per "
          f"plane, resample_direct_cuda launches: {cfg4_launches}")
    assert cfg4_launches == 1, "config #4 did not launch the K4 kernel once"
    assert bb_r.shape == bb_i.shape == (10 * CFG4_SYMBOLS,)
    assert bool(torch.isfinite(bb_r).all() and torch.isfinite(bb_i).all())
    ref4 = resample_oracle(torch.stack((sym_r, sym_i)),
                           bt.RaisedCosineFunction(0.35), 10, 1, 10,
                           10 * CFG4_SYMBOLS)
    err, _ = planes_err((bb_r.double(), bb_i.double()), (ref4[0], ref4[1]))
    print(f"ModulationChainPlanar vs float64 oracle: {err:.3e} relative to "
          f"max (tol {CHAIN_TOL})")
    assert err <= CHAIN_TOL, err
    isi = max(float((bb_r[::10] - sym_r).abs().max()),
              float((bb_i[::10] - sym_i).abs().max()))
    print(f"symbols recovered at every 10th sample: max error {isi:.3e} "
          f"(tol 1e-5)")
    assert isi <= 1e-5, isi
    f_r, f_i = bt.modulation_chain_planar(sym_r, sym_i)
    torch.cuda.synchronize()
    assert rsc.resample_direct_cuda.launches == 2
    assert torch.equal(f_r, bb_r) and torch.equal(f_i, bb_i)
    del ref4, f_r, f_i

    # 3e. main path: 44.1 -> 48 kHz, 160/147 of 2^20 real samples
    xa = torch.from_numpy(np.random.default_rng(0).standard_normal(AUDIO_N)
                          .astype(np.float32)).to(dev)
    audio_len = evened(AUDIO_N, 160, 147)
    reset_counts()
    ya = interp_ops.interpolatef(xa, sinc, 160 / 147, 0.0, 10, 1.0)
    torch.cuda.synchronize()
    audio_launches = rsc.resample_rowblock_cuda.launches
    print(f"main path: interpolatef 160/147 of {AUDIO_N} real samples, "
          f"resample_rowblock_cuda launches: {audio_launches}")
    assert audio_launches == 1, "the audio path did not launch K5 once"
    assert rsc.resample_direct_cuda.launches == 0
    assert ya.shape == (audio_len,) and ya.dtype == torch.float32
    assert bool(torch.isfinite(ya).all())
    err = rel_err(ya.double(),
                  resample_oracle(xa, sinc, 160, 147, 10, audio_len))
    print(f"interpolatef 160/147 vs float64 oracle: {err:.3e} relative to "
          f"max (tol {CHAIN_TOL})")
    assert err <= CHAIN_TOL, err
    del ya

    # 3f. main path: config #5, 2^22 samples into 1024 channels
    rng0 = np.random.default_rng(0)
    xr5, xi5 = (torch.from_numpy(rng0.standard_normal(CHAN_N)
                                 .astype(np.float32)).to(dev)
                for _ in range(2))
    proto5 = torch.from_numpy((np.hamming(CHAN_C * CHAN_TAPS) / CHAN_C)
                              .astype(np.float32)).to(dev)
    y5, z5 = chan_oracle(xr5, xi5, chz._merged_tap_rows(proto5, CHAN_C),
                         CHAN_C)
    S5 = CHAN_N // CHAN_C
    reset_counts()
    ang5 = bt.channelize_and_demod_planar(xr5, xi5, proto5, CHAN_C)
    torch.cuda.synchronize()
    chan_launches = chc.channelize_demod_cuda.launches
    print(f"main path: channelize_and_demod_planar n={CHAN_N}, {CHAN_C} "
          f"channels, {CHAN_TAPS} taps per phase, channelize_demod_cuda "
          f"launches: {chan_launches}, other kernels: {other_launches()}")
    assert chan_launches == 1, "config #5 did not launch K6 once"
    assert other_launches() == 0
    assert ang5.shape == (CHAN_C, S5) and ang5.dtype == torch.float32
    assert bool(torch.isfinite(ang5).all())
    err = angle_err(ang5, torch.angle(z5), z5.real, z5.imag)
    print(f"channelize_and_demod_planar vs float64 oracle: {err:.3e} "
          f"(|z|-weighted angle error relative to max |z|, tol {CHAIN_TOL})")
    assert err <= CHAIN_TOL, err
    x5 = torch.complex(xr5, xi5)
    chan5 = bt.ChannelizeAndDemodPlanar(proto5, CHAN_C)
    assert torch.equal(bt.channelize_and_demod(x5, proto5, CHAN_C), ang5)
    assert torch.equal(chan5(xr5, xi5), ang5)
    y = bt.polyphase_channelizer(x5, proto5, CHAN_C)
    torch.cuda.synchronize()
    err = rel_err(y.to(torch.complex128), y5)
    print(f"polyphase_channelizer (no kernel) vs oracle: {err:.3e} "
          f"(tol {CHAIN_TOL})")
    assert y.shape == (CHAN_C, S5) and err <= CHAIN_TOL, err
    assert chc.channelize_demod_cuda.launches == 3
    assert other_launches() == 0
    # K6 stores (C, S) itself: the module's profile shows no other kernel
    _, per_kernel = timing.device_ms(lambda: chan5(xr5, xi5))
    print(f"ChannelizeAndDemodPlanar's profiled calls: kernels "
          f"{sorted(k[:48] for k in per_kernel) or 'not seen'}")
    assert all("channelize" in k for k in per_kernel), per_kernel
    del y5, z5, y, x5

    # 3g. main path: the fused spectrum chain at full size
    chain_f = bt.FirFftChainPlanar(taps, window, fused=True)
    ref = oracle(xr, xi, taps, window)
    reset_counts()
    out = chain_f(xr, xi)
    torch.cuda.synchronize()
    fused_launches = sc.fourstep_mag_fused.launches
    print(f"main path: FirFftChainPlanar(fused=True) n={N} (n1={chain_f.n1}, "
          f"n2={chain_f.n2}), fourstep_mag_fused launches: {fused_launches}, "
          f"rowfft_mag launches: {sc.rowfft_mag.launches}")
    assert fused_launches == 1, "the fused chain did not launch K2 once"
    assert other_launches() == 1 and sc.rowfft_mag.launches == 0
    assert fcu.fir_window_cuda.launches == 1, "the fused chain: not one K7"
    assert out.shape == (N,) and out.dtype == torch.float32
    assert bool(torch.isfinite(out).all())
    err = rel_err(out.double(), ref)
    print(f"FirFftChainPlanar(fused=True) vs float64 oracle: {err:.3e} "
          f"relative to max (tol {CHAIN_TOL})")
    assert err <= CHAIN_TOL, err
    got = bt.fir_fft_chain_planar(xr, xi, taps, window, fused=True)
    torch.cuda.synchronize()
    err = rel_err(got.double(), ref)
    print(f"fir_fft_chain_planar(fused=True) vs oracle: {err:.3e}")
    assert got.shape == (N,) and err <= CHAIN_TOL, err
    assert sc.fourstep_mag_fused.launches == 2
    assert sc.rowfft_mag.launches == 0 and sc.stage1_cuda.launches == 0
    assert fcu.fir_window_cuda.launches == 2
    del ref, got, out

    # 3h. the typed vectors at full width: K3, K4 and K5 through the
    # vector layer
    rng0 = np.random.default_rng(0)
    xh_np = (rng0.standard_normal(N)
             + 1j * rng0.standard_normal(N)).astype(np.complex64)
    vh = bt.to_complex_time_vec(xh_np)
    imp = bt.to_complex_time_vec(h.cpu().numpy())
    assert vh.array.device.type == "cuda" and imp.array.device.type == "cuda"
    xh = vh.array
    conv_ref = conv_oracle(xh.real, xh.imag, h)
    reset_counts()
    yh = vh.convolve_signal(imp)
    torch.cuda.synchronize()
    typed_os = osc.conv_blocks_cuda.launches
    print(f"main path: ComplexTimeVector.convolve_signal n={N}, {CONV_TAPS} "
          f"complex taps, conv_blocks_cuda launches: {typed_os}, other "
          f"kernels: {other_launches() - typed_os}")
    assert typed_os == 1, "the typed convolution did not launch K3 once"
    assert other_launches() == 1
    assert isinstance(yh, bt.ComplexTimeVector) and yh.points() == N
    assert yh.array.dtype == torch.complex64
    assert bool(torch.isfinite(torch.view_as_real(yh.array)).all())
    err = rel_err(yh.array.to(torch.complex128), conv_ref)
    print(f"typed convolve_signal vs float64 oracle: {err:.3e} relative to "
          f"max (tol {CHAIN_TOL})")
    assert err <= CHAIN_TOL, err
    w64 = bt.HammingWindow().sample(N, dtype=torch.float64, device=dev)
    spec_ref = torch.fft.fftshift(torch.fft.fft(conv_ref * w64)).abs()
    del conv_ref
    mh = yh.windowed_fft(bt.HammingWindow()).magnitude()
    torch.cuda.synchronize()
    assert isinstance(mh, bt.RealFreqVector) and mh.points() == N
    err = rel_err(mh.array.double(), spec_ref)
    print(f"typed windowed_fft().magnitude() vs float64 oracle: {err:.3e} "
          f"relative to max (tol {CHAIN_TOL})")
    assert err <= CHAIN_TOL, err
    del spec_ref
    m64 = mh.to_numpy().astype(np.float64)
    st = mh.statistics()
    want = {"sum": m64.sum(), "average": m64.mean(),
            "rms": math.sqrt(np.mean(m64 * m64)), "min": m64.min(),
            "max": m64.max()}
    st_err = max(abs(getattr(st, k) - v) / abs(v) for k, v in want.items())
    print(f"typed statistics() vs float64 on the host: {st_err:.3e} "
          f"relative (tol {STATS_TOL}), count {st.count}, min index "
          f"{st.min_index}, max index {st.max_index}")
    assert st_err <= STATS_TOL and st.count == N, st
    assert (st.min_index, st.max_index) == (int(m64.argmin()),
                                            int(m64.argmax()))
    exact = math.fsum(m64)
    prec_err = abs(mh.sum_prec() - exact) / abs(exact)
    print(f"typed sum_prec() vs math.fsum: {prec_err:.3e} relative "
          f"(tol {PREC_TOL})")
    assert prec_err <= PREC_TOL, prec_err
    del m64, mh
    reset_counts()
    y4v = bt.to_complex_time_vec(x3).interpolatef(sinc, 1.5, 0.0, 10)
    torch.cuda.synchronize()
    typed_k4 = rsc.resample_direct_cuda.launches
    k5_in_k4_run = rsc.resample_rowblock_cuda.launches
    err = rel_err(y4v.array.to(torch.complex128),
                  resample_oracle(x3, sinc, 3, 2, 10, CFG3_N * 3 // 2))
    print(f"main path: ComplexTimeVector.interpolatef x1.5 of {CFG3_N}, "
          f"resample_direct_cuda launches: {typed_k4}, resample_rowblock_"
          f"cuda: {k5_in_k4_run}; vs float64 oracle {err:.3e} (tol {CHAIN_TOL})")
    assert typed_k4 == 1 and other_launches() == 1, "typed x1.5: not one K4"
    assert y4v.points() == CFG3_N * 3 // 2 and err <= CHAIN_TOL, err
    del y4v
    reset_counts()
    y5v = bt.to_real_time_vec(xa).interpolatef(sinc, 160 / 147, 0.0, 10)
    torch.cuda.synchronize()
    typed_k5 = rsc.resample_rowblock_cuda.launches
    err = rel_err(y5v.array.double(),
                  resample_oracle(xa, sinc, 160, 147, 10, audio_len))
    print(f"main path: RealTimeVector.interpolatef 160/147 of {AUDIO_N}, "
          f"resample_rowblock_cuda launches: {typed_k5}, other kernels: "
          f"{other_launches() - typed_k5}; vs float64 oracle {err:.3e} "
          f"(tol {CHAIN_TOL})")
    assert typed_k5 == 1 and other_launches() == 1, "typed 160/147: not K5"
    assert y5v.points() == audio_len and err <= CHAIN_TOL, err
    del y5v

    # 3i. a matrix: batched FFT, per-row statistics from one host fetch,
    # the MIMO convolution
    from basic_dsp_tpu_torch.ops import stats_ops as tst
    rngm = np.random.default_rng(0)
    xm_np = (rngm.standard_normal((MAT_ROWS, MAT_N))
             + 1j * rngm.standard_normal((MAT_ROWS, MAT_N))).astype(
                 np.complex64)
    grid = (rngm.standard_normal((MAT_ROWS, MAT_ROWS, MAT_TAPS))
            + 1j * rngm.standard_normal((MAT_ROWS, MAT_ROWS, MAT_TAPS))
            ).astype(np.complex64)
    mat = bt.to_complex_time_mat(xm_np)
    x64 = mat.array.to(torch.complex128)
    fetches, host = [], tst._host
    tst._host = lambda t: fetches.append(tuple(t.shape)) or host(t)
    reset_counts()
    try:
        stats8 = mat.fft().magnitude().statistics()
    finally:
        tst._host = host
    mag64 = torch.fft.fftshift(torch.fft.fft(x64, dim=-1), dim=-1).abs()
    mat_err = 0.0
    for i, s8 in enumerate(stats8):
        row = mag64[i]
        hi, lo = float(row.max()), float(row.min())
        mat_err = max(mat_err,
                      abs(s8.sum - float(row.sum())) / float(row.sum()),
                      abs(s8.rms - float(row.square().mean().sqrt()))
                      / hi,
                      abs(s8.max - hi) / hi, abs(s8.min - lo) / hi,
                      abs(float(row[s8.max_index]) - hi) / hi,
                      abs(float(row[s8.min_index]) - lo) / hi)
    print(f"matrix ({MAT_ROWS}, {MAT_N}) fft().magnitude().statistics(): "
          f"{len(stats8)} Statistics from {len(fetches)} host fetch(es) "
          f"{fetches}, {mat_err:.3e} relative to float64 (tol {STATS_TOL})")
    assert len(stats8) == MAT_ROWS and len(fetches) == 1
    assert mat_err <= STATS_TOL, mat_err
    del mag64
    out_m = mat.convolve_mat(grid)
    torch.cuda.synchronize()
    g64 = torch.from_numpy(grid).to(dev, torch.complex128)
    ref_m = torch.fft.ifft(torch.einsum(
        "crn,rn->cn", torch.fft.fft(conv_ops.kernel_layout(g64, MAT_N)),
        torch.fft.fft(x64, dim=-1)), dim=-1)
    err = rel_err(out_m.array.to(torch.complex128), ref_m)
    print(f"matrix convolve_mat ({MAT_ROWS}, {MAT_ROWS}, {MAT_TAPS}) grid vs "
          f"float64 einsum oracle: {err:.3e} relative to max (tol "
          f"{CHAIN_TOL}); kernel launches: {other_launches()}")
    assert isinstance(out_m, bt.ComplexTimeMatrix)
    assert err <= CHAIN_TOL and other_launches() == 0, err
    del x64, g64, ref_m, out_m, mat

    # 3j. the flagship API: the DIT spectrum and the budgets
    xw = torch.complex(xr, xi) * window
    ref_nofir = oracle(xr, xi, taps, window, fir=False)
    reset_counts()
    dit = fourstep.dit_spectrum_mag(xw)
    torch.cuda.synchronize()
    err = rel_err(dit.double(), ref_nofir)
    print(f"fourstep.dit_spectrum_mag n={N} vs float64 oracle: {err:.3e} "
          f"(tol {CHAIN_TOL}); kernel launches: {other_launches()}")
    assert dit.shape == (N,) and err <= CHAIN_TOL, err
    assert other_launches() == 0
    del xw, ref_nofir, dit
    ref = oracle(xr, xi, taps, window)
    for fused in (False, True):
        outs = {}
        counter = (sc.fourstep_mag_fused if fused
                   else sc.rowfft_mag_natural)
        for budget in BUDGETS:
            reset_counts()
            outs[budget] = bt.fir_fft_chain_planar(xr, xi, taps, window,
                                                   budget=budget, fused=fused)
            torch.cuda.synchronize()
            launches = (sc.rowfft_mag_natural.launches,
                        sc.fourstep_mag_fused.launches, other_launches())
            err = rel_err(outs[budget].double(), ref)
            print(f"main path: fir_fft_chain_planar(budget={budget!r}, "
                  f"fused={fused}) rowfft_mag_natural launches: "
                  f"{launches[0]}, "
                  f"fourstep_mag_fused launches: {launches[1]}, K1-K5 together: "
                  f"{launches[2]}; vs float64 oracle: {err:.3e} relative to "
                  f"max (tol {CHAIN_TOL}); allow_tf32 after: "
                  f"{torch.backends.cuda.matmul.allow_tf32}")
            assert counter.launches == 1 and launches[2] == 1, (
                budget, fused, launches)
            assert fcu.fir_window_cuda.launches == 1, (budget, fused)
            assert sc.stage1_cuda.launches == (0 if fused else 1), (
                budget, fused)
            assert chc.channelize_demod_cuda.launches == 0
            assert err <= CHAIN_TOL, (budget, fused, err)
            assert torch.equal(outs[budget], outs[None]), (budget, fused)
            assert torch.backends.cuda.matmul.allow_tf32 is False
        del outs
    out = bt.fir_fft_chain_planar(xr, xi, taps, window)
    torch.cuda.synchronize()
    err = rel_err(out.double(), ref)
    print(f"fir_fft_chain_planar(budget=None) after the budgets: {err:.3e} "
          f"(tol {CHAIN_TOL}), allow_tf32 "
          f"{torch.backends.cuda.matmul.allow_tf32}, float32 matmul "
          f"precision {torch.get_float32_matmul_precision()!r}")
    assert err <= CHAIN_TOL, err
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"
    del ref, out

    # 3k. streaming FIR: 64 chunks of 2^16 with cell 2's taps, K3 in
    # linear mode once a chunk
    rng0 = np.random.default_rng(0)
    xk = torch.from_numpy((rng0.standard_normal(N)
                           + 1j * rng0.standard_normal(N))
                          .astype(np.complex64)).to(dev)
    fir = streaming.StreamingFir(h)
    reset_counts()
    state = fir.init_state(torch.complex64)
    outs = []
    for k in range(STREAM_CHUNKS):
        out, state = fir.process(xk[k * STREAM_CHUNK:(k + 1) * STREAM_CHUNK],
                                 state)
        outs.append(out)
    torch.cuda.synchronize()
    k_launches = osc.conv_blocks_cuda.launches
    print(f"main path: StreamingFir.process, {STREAM_CHUNKS} chunks of "
          f"{STREAM_CHUNK} complex samples, {CONV_TAPS} taps (fft_len "
          f"{fir.fft_len}), conv_blocks_cuda launches: {k_launches}, other "
          f"kernels: {other_launches() - k_launches}, channelizer: "
          f"{chc.channelize_demod_cuda.launches}")
    assert k_launches == STREAM_CHUNKS, "the streaming FIR: not 64 K3"
    assert other_launches() == STREAM_CHUNKS
    assert chc.channelize_demod_cuda.launches == 0
    yk = torch.cat(outs)
    assert yk.shape == (N,) and yk.dtype == torch.complex64
    assert bool(torch.isfinite(torch.view_as_real(yk)).all())
    size = 2 * N
    lin = torch.fft.ifft(torch.fft.fft(xk.to(torch.complex128), n=size)
                         * torch.fft.fft(h.to(torch.complex128), n=size))[:N]
    err = rel_err(yk.to(torch.complex128), lin)
    print(f"StreamingFir vs float64 linear convolution: {err:.3e} relative "
          f"to max (tol {CHAIN_TOL})")
    assert err <= CHAIN_TOL, err
    del outs, yk, lin

    # 3l. streaming resampler: x1.5 of config #3's signal in chunks of
    # 2^16 (K4), 160/147 of 7 chunks of 150528 real samples (K5)
    audio_np = np.random.default_rng(0).standard_normal(
        AUDIO_CHUNK * AUDIO_CHUNKS).astype(np.float32)
    xl_audio = torch.from_numpy(audio_np).to(dev)
    for name, factor, xin, chunk, kernel in (
            ("x1.5", 1.5, x3, STREAM_CHUNK, "resample_direct_cuda"),
            ("160/147", 160 / 147, xl_audio, AUDIO_CHUNK,
             "resample_rowblock_cuda")):
        rs = streaming.StreamingResampler(sinc, factor, 0.0, 10,
                                             device=dev)
        nchunks = xin.shape[-1] // chunk
        reset_counts()
        state = rs.init_state(xin.dtype)
        outs = []
        for k in range(nchunks):
            out, state = rs.process(xin[k * chunk:(k + 1) * chunk], state)
            outs.append(out)
        torch.cuda.synchronize()
        rs_launches = getattr(rsc, kernel).launches
        print(f"main path: StreamingResampler {name}, {nchunks} chunks of "
              f"{chunk} {'complex' if xin.is_complex() else 'real'} samples "
              f"(T {rs.T}, output_delay {rs.output_delay}), {kernel} "
              f"launches: {rs_launches}, other kernels: "
              f"{other_launches() - rs_launches}")
        assert rs_launches == nchunks and other_launches() == nchunks, name
        got = torch.cat(outs)
        out_len = xin.shape[-1] * rs.P // rs.Q
        assert got.shape == (out_len,) and got.dtype == xin.dtype
        assert bool(torch.isfinite(torch.view_as_real(got)
                                   if got.is_complex() else got).all())
        d = rs.output_delay
        ref = resample_oracle(xin, sinc, rs.P, rs.Q, 10, out_len - d,
                              circular=False)
        wide = torch.complex128 if got.is_complex() else torch.float64
        err = rel_err(got[d:].to(wide), ref)
        print(f"StreamingResampler {name} vs float64 linear resample delayed "
              f"by {d}: {err:.3e} relative to max (tol {CHAIN_TOL})")
        assert err <= CHAIN_TOL, (name, err)
        del outs, got, ref

    # a block of 64 real channels at 160/147: one K5 launch a chunk for
    # every row, channel 0 bit-equal to that channel streamed alone
    rs = streaming.StreamingResampler(sinc, 160 / 147, 0.0, 10, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    xb = torch.randn((AUDIO_CHANNELS, AUDIO_CHUNK * AUDIO_BLOCK_CHUNKS),
                     generator=gen, device=dev)
    reset_counts()
    chunks0 = streaming.StreamingResampler.chunks
    rows0 = streaming.StreamingResampler.rows
    in_place0 = streaming.StreamingResampler.in_place
    state = rs.init_state(torch.float32, channels=AUDIO_CHANNELS)
    one = rs.init_state(torch.float32)
    outs, outs0 = [], []
    for k in range(AUDIO_BLOCK_CHUNKS):
        blk = xb[:, k * AUDIO_CHUNK:(k + 1) * AUDIO_CHUNK]
        out, state = rs.process(blk, state)
        outs.append(out)
    torch.cuda.synchronize()
    block_launches = rsc.resample_rowblock_cuda.launches
    block_chunks = streaming.StreamingResampler.chunks - chunks0
    block_rows = streaming.StreamingResampler.rows - rows0
    block_in_place = streaming.StreamingResampler.in_place - in_place0
    assert other_launches() == block_launches
    for k in range(AUDIO_BLOCK_CHUNKS):
        out, one = rs.process(xb[0, k * AUDIO_CHUNK:(k + 1) * AUDIO_CHUNK],
                              one)
        outs0.append(out)
    torch.cuda.synchronize()
    got, got0 = torch.cat(outs, dim=-1), torch.cat(outs0)
    out_len = AUDIO_CHUNK * AUDIO_BLOCK_CHUNKS * rs.P // rs.Q
    print(f"main path: StreamingResampler 160/147, a block of "
          f"{AUDIO_CHANNELS} real channels in {AUDIO_BLOCK_CHUNKS} chunks of "
          f"{AUDIO_CHUNK}: resample_rowblock_cuda launches {block_launches}, "
          f"StreamingResampler.chunks {block_chunks}, rows {block_rows}, "
          f"in_place {block_in_place}")
    assert block_launches == block_chunks == AUDIO_BLOCK_CHUNKS
    assert block_in_place == AUDIO_BLOCK_CHUNKS
    assert block_rows == AUDIO_CHANNELS * AUDIO_BLOCK_CHUNKS
    assert rsc.resample_rowblock_cuda.launches == 2 * AUDIO_BLOCK_CHUNKS
    assert got.shape == (AUDIO_CHANNELS, out_len)
    assert got.dtype == torch.float32 and state.tail.dtype == torch.float32
    assert torch.equal(got[0], got0), "block row 0 != channel 0 alone"
    d = rs.output_delay
    gap = top = 0.0
    for r in range(0, AUDIO_CHANNELS, 16):
        ref = resample_oracle(xb[r:r + 16], sinc, rs.P, rs.Q, 10,
                              out_len - d, circular=False)
        gap = max(gap, float((got[r:r + 16, d:].double() - ref).abs().max()))
        top = max(top, float(ref.abs().max()))
        del ref
    err = gap / top
    print(f"StreamingResampler 160/147 block vs float64 linear resample "
          f"delayed by {d}: {err:.3e} relative to max (tol {CHAIN_TOL})")
    assert err <= CHAIN_TOL, err
    del xb, outs, outs0, got, got0

    # 3m. the sharded functions on a one-rank NCCL mesh
    import torch.distributed as dist
    from basic_dsp_tpu_torch.parallel import sharded as shd
    from torch.distributed.tensor import DTensor
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    mesh = bt.make_mesh(1)
    print(f"mesh: {mesh}, backend {dist.get_backend()}")
    x = torch.complex(xr, xi)
    conv_ref = conv_oracle(xr, xi, h)
    reset_counts()
    ys = shd.sharded_convolve_signal(x, h, mesh)
    torch.cuda.synchronize()
    m_os = osc.conv_blocks_cuda.launches
    print(f"main path: sharded_convolve_signal n={N}, {CONV_TAPS} taps, mesh "
          f"of 1, conv_blocks_cuda launches: {m_os}, other kernels: "
          f"{other_launches() - m_os + chc.channelize_demod_cuda.launches}")
    assert m_os == 1 and other_launches() == 1, "sharded conv: not one K3"
    assert isinstance(ys, DTensor) and ys.shape == (N,)
    ys = ys.to_local()
    assert ys.dtype == torch.complex64
    assert bool(torch.isfinite(torch.view_as_real(ys)).all())
    single = conv_ops.convolve_signal(x, h, True)
    errs = (rel_err(ys, single), rel_err(ys.to(torch.complex128), conv_ref))
    print(f"sharded_convolve_signal vs convolve_signal {errs[0]:.3e} (tol "
          f"{SHARD_TOL}), vs float64 oracle {errs[1]:.3e} (tol {CHAIN_TOL})")
    assert errs[0] <= SHARD_TOL and errs[1] <= CHAIN_TOL, errs
    del ys, single, conv_ref
    reset_counts()
    yi = shd.sharded_interpolatef(x3, sinc, 1.5, 0.0, 10, mesh)
    torch.cuda.synchronize()
    m_k4 = rsc.resample_direct_cuda.launches
    print(f"main path: sharded_interpolatef x1.5 of {CFG3_N} complex, mesh "
          f"of 1, resample_direct_cuda launches: {m_k4}, other kernels: "
          f"{other_launches() - m_k4}")
    assert m_k4 == 1 and other_launches() == 1, "sharded x1.5: not one K4"
    yi = yi.to_local()
    assert yi.shape == (CFG3_N * 3 // 2,) and yi.dtype == torch.complex64
    single = interp_ops.interpolatef(x3, sinc, 1.5, 0.0, 10, 1.0)
    errs = (rel_err(yi, single),
            rel_err(yi.to(torch.complex128),
                    resample_oracle(x3, sinc, 3, 2, 10, CFG3_N * 3 // 2)))
    print(f"sharded_interpolatef vs interpolatef {errs[0]:.3e} (tol "
          f"{SHARD_TOL}), vs float64 oracle {errs[1]:.3e} (tol {CHAIN_TOL})")
    assert errs[0] <= SHARD_TOL and errs[1] <= CHAIN_TOL, errs
    del yi, single
    x5 = torch.complex(xr5, xi5)
    y5, z5 = chan_oracle(xr5, xi5, chz._merged_tap_rows(proto5, CHAN_C),
                         CHAN_C)
    del y5
    reset_counts()
    angs = bt.sharded_channelize_and_demod(x5, proto5, CHAN_C, mesh)
    torch.cuda.synchronize()
    m_k6 = chc.channelize_demod_cuda.launches
    print(f"main path: sharded_channelize_and_demod n={CHAN_N}, {CHAN_C} "
          f"channels, mesh of 1, channelize_demod_cuda launches: {m_k6}, "
          f"other kernels: {other_launches()}")
    assert m_k6 == 1 and other_launches() == 0, "sharded config #5: not K6"
    angs = angs.to_local()
    assert angs.shape == (CHAN_C, S5) and angs.dtype == torch.float32
    assert bool(torch.isfinite(angs).all())
    errs = (angle_err(angs, ang5, z5.real, z5.imag),
            angle_err(angs, torch.angle(z5), z5.real, z5.imag))
    print(f"sharded_channelize_and_demod vs channelize_and_demod_planar "
          f"{errs[0]:.3e} (tol {SHARD_TOL}), vs float64 oracle {errs[1]:.3e} "
          f"(tol {CHAIN_TOL}; |z|-weighted angles)")
    assert errs[0] <= SHARD_TOL and errs[1] <= CHAIN_TOL, errs
    del angs, z5
    from basic_dsp_tpu_torch.ops import stats_ops as tst
    x64 = x.to(torch.complex128)
    abs_sum = float(x64.abs().sum())
    sq_sum = float((x64.abs() ** 2).sum())
    reset_counts()
    ssum = shd.sharded_sum(x, mesh)
    st = shd.sharded_statistics(x, mesh)
    torch.cuda.synchronize()
    assert other_launches() == 0 and chc.channelize_demod_cuda.launches == 0
    single = tst.sum_(x)
    st1 = tst.statistics(x, True)
    errs = (abs(complex(ssum) - single) / abs_sum,
            abs(complex(ssum) - complex(x64.sum())) / abs_sum)
    print(f"sharded_sum vs sum_ {errs[0]:.3e} (tol {SHARD_TOL}), vs float64 "
          f"{errs[1]:.3e} (tol {CHAIN_TOL}; relative to sum |x|)")
    assert errs[0] <= SHARD_TOL and errs[1] <= CHAIN_TOL, errs
    sq = st.rms ** 2 * N
    amax = int(x64.abs().argmax())
    errs = (max(abs(st.sum - st1.sum) / abs_sum,
                abs(sq - st1.rms ** 2 * N) / sq_sum),
            max(abs(st.sum - complex(x64.sum())) / abs_sum,
                abs(sq - complex((x64 * x64).sum())) / sq_sum,
                abs(abs(st.max) - float(x64.abs().max()))
                / float(x64.abs().max())))
    print(f"sharded_statistics vs statistics {errs[0]:.3e} (tol {SHARD_TOL}), "
          f"vs float64 {errs[1]:.3e} (tol {CHAIN_TOL}; sums relative to sum "
          f"|x|, rms^2 n to sum |x|^2); min index {st.min_index} "
          f"({st1.min_index}), max index {st.max_index} ({st1.max_index}, "
          f"float64 {amax}), count {st.count}")
    assert errs[0] <= SHARD_TOL and errs[1] <= CHAIN_TOL, errs
    assert (st.count, st.min_index, st.max_index, st.min, st.max) == (
        N, st1.min_index, st1.max_index, st1.min, st1.max)
    del x64

    # 3p. the rest of the multi-device layer on the same one-rank NCCL
    # mesh: the distributed FFT, the MIMO convolution, the mesh-sharded
    # vectors and StreamingFir over sharded chunks
    from basic_dsp_tpu_torch import matrix as tmatrix
    from basic_dsp_tpu_torch.parallel import sharded_fft as sfft
    X = torch.fft.fft(x)
    X64 = np.fft.fft(x.cpu().numpy().astype(np.complex128))
    Xr = torch.fft.fft(xr)
    Xr64 = np.fft.fft(xr.cpu().numpy().astype(np.float64))
    n1, n2 = sfft._split_factors(N)

    def spectrum_errs(name, got, ref, ref64):
        """``got`` against torch.fft.fft (FFT_TOL of max |X|) and the
        float64 numpy oracle (FFT64_TOL)."""
        assert bool(torch.isfinite(torch.view_as_real(got)).all()), name
        ref64 = torch.from_numpy(ref64).to(dev)
        errs = (rel_err(got, ref), rel_err(got.to(torch.complex128), ref64))
        print(f"{name}: vs torch.fft.fft {errs[0]:.3e} (tol {FFT_TOL}), vs "
              f"float64 numpy {errs[1]:.3e} (tol {FFT64_TOL}) of max |X|")
        assert errs[0] <= FFT_TOL and errs[1] <= FFT64_TOL, (name, errs)

    reset_counts()
    for name, sig, ref, ref64 in (("complex64", x, X, X64),
                                  ("float32", xr, Xr, Xr64)):
        for natural in (True, False):
            ys = sfft.sharded_fft(sig, mesh, natural_order=natural)
            assert isinstance(ys, DTensor) and ys.dtype == torch.complex64
            ys = ys.to_local()
            if natural:
                assert ys.shape == (N,)
                spectrum_errs(f"sharded_fft {name} 2^22, mesh of 1", ys,
                              ref, ref64)
            else:
                assert ys.shape == (n1, n2)
                spectrum_errs(f"sharded_fft {name} 2^22 natural_order=False "
                              f"({n1}, {n2})", ys,
                              ref.reshape(n2, n1).T,
                              ref64.reshape(n2, n1).T)
    pr, pi = sfft.sharded_fft_planar(xr, xi, mesh)
    spectrum_errs("sharded_fft_planar 2^22, mesh of 1",
                  torch.complex(pr.to_local(), pi.to_local()), X, X64)
    spectrum_errs("four_step_fft 2^22", sfft.four_step_fft(x), X, X64)
    spectrum_errs("four_step_ifft 2^22 (n * ifft)", sfft.four_step_ifft(x),
                  torch.fft.ifft(x) * N,
                  np.fft.ifft(x.cpu().numpy().astype(np.complex128)) * N)
    del pr, pi, ys, Xr, Xr64
    torch.cuda.synchronize()
    assert other_launches() == 0 and chc.channelize_demod_cuda.launches == 0

    rngp = np.random.default_rng(1)
    xm_c = torch.from_numpy((rngp.standard_normal((MAT_ROWS, MAT_N))
                             + 1j * rngp.standard_normal((MAT_ROWS, MAT_N)))
                            .astype(np.complex64)).to(dev)
    grid_c = (rngp.standard_normal((MAT_ROWS, MAT_ROWS, MIMO_TAPS))
              + 1j * rngp.standard_normal((MAT_ROWS, MAT_ROWS, MIMO_TAPS))
              ).astype(np.complex64)
    xm_r = torch.from_numpy(rngp.standard_normal((MAT_ROWS, MAT_N)).astype(
        np.float32)).to(dev)
    grid_r = rngp.standard_normal((MAT_ROWS, MAT_ROWS, MIMO_TAPS)).astype(
        np.float32)
    for name, xm, grid, cplx in (("complex64", xm_c, grid_c, True),
                                 ("float32", xm_r, grid_r, False)):
        reset_counts()
        ym = bt.parallel.sharded_convolve_mat(xm, grid, mesh)
        torch.cuda.synchronize()
        assert other_launches() == 0
        assert isinstance(ym, DTensor) and ym.shape == (MAT_ROWS, MAT_N)
        ym = ym.to_local()
        assert ym.dtype == xm.dtype
        assert bool(torch.isfinite(torch.view_as_real(ym) if cplx
                                   else ym).all())
        single = tmatrix._convolve_mat(xm, torch.from_numpy(grid).to(dev),
                                       cplx)
        g64 = torch.from_numpy(grid).to(dev, torch.complex128)
        ref = torch.fft.ifft(torch.einsum(
            "crn,rn->cn", torch.fft.fft(conv_ops.kernel_layout(g64, MAT_N)),
            torch.fft.fft(xm.to(torch.complex128), dim=-1)), dim=-1)
        if not cplx:
            ref = ref.real
        errs = (rel_err(ym, single),
                rel_err(ym.to(ref.dtype), ref))
        print(f"main path: sharded_convolve_mat {name} ({MAT_ROWS}, {MAT_N}) "
              f"with a ({MAT_ROWS}, {MAT_ROWS}, {MIMO_TAPS}) grid, mesh of 1: "
              f"vs matrix._convolve_mat {errs[0]:.3e} (tol {SHARD_TOL}), vs "
              f"float64 oracle {errs[1]:.3e} (tol {CHAIN_TOL}); no kernel")
        assert errs[0] <= SHARD_TOL and errs[1] <= CHAIN_TOL, (name, errs)
    del ym, single, g64, ref, xm_r

    vp = bt.to_complex_time_vec_par(xh_np, mesh)
    assert isinstance(vp.array, DTensor) and vp.points() == N
    assert vp.array.to_local().device.type == "cuda"
    xh64 = xh.to(torch.complex128)
    reset_counts()
    got = vp.sum()
    err = abs(got - vh.sum()) / float(xh64.abs().sum())
    print(f"par vector sum() (sharded_sum) vs the plain vector's: {err:.3e} "
          f"relative to sum |x| (tol {SHARD_TOL})")
    assert err <= SHARD_TOL, err
    for name, par, plain in (
            ("scale(2 - 1j)", vp.scale(2.0 - 1.0j), vh.scale(2.0 - 1.0j)),
            ("magnitude()", vp.magnitude(), vh.magnitude())):
        assert isinstance(par.array, DTensor), name
        err = rel_err(par.array.to_local(), plain.array)
        print(f"par vector {name} (local shards) vs the plain vector's: "
              f"{err:.3e} (tol {SHARD_TOL})")
        assert err <= SHARD_TOL, (name, err)
    torch.cuda.synchronize()
    assert other_launches() == 0
    imp_rc = bt.to_complex_time_vec(rc_taps(CONV_TAPS, dev).to(
        torch.complex64))
    reset_counts()
    yp = vp.convolve_signal(imp_rc)
    torch.cuda.synchronize()
    p_conv = osc.conv_blocks_cuda.launches
    print(f"main path: par ComplexTimeVector.convolve_signal n={N}, "
          f"{CONV_TAPS} raised-cosine taps, mesh of 1, conv_blocks_cuda "
          f"launches: {p_conv}, other kernels: {other_launches() - p_conv}")
    assert p_conv == 1 and other_launches() == 1, "par conv: not one K3"
    assert isinstance(yp.array, DTensor)
    yp = yp.array.to_local()
    errs = (rel_err(yp, vh.convolve_signal(imp_rc).array),
            rel_err(yp.to(torch.complex128),
                    conv_oracle(xh.real, xh.imag, imp_rc.array)))
    print(f"par convolve_signal vs the plain vector's {errs[0]:.3e} (tol "
          f"{SHARD_TOL}), vs float64 oracle {errs[1]:.3e} (tol {CHAIN_TOL})")
    assert errs[0] <= SHARD_TOL and errs[1] <= CHAIN_TOL, errs
    del yp
    reset_counts()
    fp = vp.plain_fft()
    torch.cuda.synchronize()
    assert other_launches() == 0
    assert isinstance(fp, bt.ComplexFreqVector)
    assert isinstance(fp.array, DTensor)
    fp = fp.array.to_local()
    errs = (rel_err(fp, vh.plain_fft().array),
            rel_err(fp.to(torch.complex128), torch.from_numpy(
                np.fft.fft(xh_np.astype(np.complex128))).to(dev)))
    print(f"par plain_fft (sharded_fft) vs the plain vector's {errs[0]:.3e} "
          f"(tol {SHARD_TOL}), vs float64 numpy {errs[1]:.3e} (tol "
          f"{CHAIN_TOL})")
    assert errs[0] <= SHARD_TOL and errs[1] <= CHAIN_TOL, errs
    del fp
    gathered = vp.fft()
    assert not isinstance(gathered.array, DTensor)
    err = rel_err(gathered.array, vh.fft().array)
    print(f"par fft() (gathered: sharded to_complex, then fft on the whole) "
          f"vs the plain vector's: {err:.3e} (tol {SHARD_TOL})")
    assert err <= SHARD_TOL, err
    del gathered, vp, xh64
    reset_counts()
    y4p = bt.to_complex_time_vec_par(x3, mesh).interpolatef(sinc, 1.5, 0.0,
                                                            10)
    torch.cuda.synchronize()
    p_k4 = rsc.resample_direct_cuda.launches
    print(f"main path: par ComplexTimeVector.interpolatef x1.5 of {CFG3_N}, "
          f"mesh of 1, resample_direct_cuda launches: {p_k4}, other kernels: "
          f"{other_launches() - p_k4}")
    assert p_k4 == 1 and other_launches() == 1, "par x1.5: not one K4"
    assert isinstance(y4p.array, DTensor)
    y4p = y4p.array.to_local()
    errs = (rel_err(y4p, bt.to_complex_time_vec(x3).interpolatef(
                sinc, 1.5, 0.0, 10).array),
            rel_err(y4p.to(torch.complex128),
                    resample_oracle(x3, sinc, 3, 2, 10, CFG3_N * 3 // 2)))
    print(f"par interpolatef vs the plain vector's {errs[0]:.3e} (tol "
          f"{SHARD_TOL}), vs float64 oracle {errs[1]:.3e} (tol {CHAIN_TOL})")
    assert errs[0] <= SHARD_TOL and errs[1] <= CHAIN_TOL, errs
    del y4p

    fir_p = streaming.StreamingFir(h)
    state, state1 = fir_p.init_state(torch.complex64), fir.init_state(
        torch.complex64)
    outs, outs1 = [], []
    reset_counts()
    for k in range(PAR_CHUNKS):
        chunk = shd.shard_time_axis(
            xk[k * STREAM_CHUNK:(k + 1) * STREAM_CHUNK], mesh)
        out, state = fir_p.process(chunk, state)
        outs.append(out)
    torch.cuda.synchronize()
    p_stream = osc.conv_blocks_cuda.launches
    print(f"main path: StreamingFir.process over {PAR_CHUNKS} sharded chunks "
          f"of {STREAM_CHUNK}, {CONV_TAPS} taps, mesh of 1, conv_blocks_cuda "
          f"launches: {p_stream}, other kernels: "
          f"{other_launches() - p_stream}")
    assert p_stream == PAR_CHUNKS and other_launches() == PAR_CHUNKS, \
        "sharded stream: not one K3 a chunk"
    assert all(isinstance(o, DTensor) for o in outs)
    yk = torch.cat([o.to_local() for o in outs])
    for k in range(PAR_CHUNKS):
        out, state1 = fir.process(xk[k * STREAM_CHUNK:(k + 1) * STREAM_CHUNK],
                                  state1)
        outs1.append(out)
    n_p = PAR_CHUNKS * STREAM_CHUNK
    lin = torch.fft.ifft(torch.fft.fft(xk[:n_p].to(torch.complex128),
                                       n=2 * n_p)
                         * torch.fft.fft(h.to(torch.complex128),
                                         n=2 * n_p))[:n_p]
    errs = (rel_err(yk, torch.cat(outs1)), rel_err(yk.to(torch.complex128),
                                                   lin))
    print(f"StreamingFir over sharded chunks vs over plain chunks "
          f"{errs[0]:.3e} (tol {SHARD_TOL}), vs float64 linear convolution "
          f"{errs[1]:.3e} (tol {CHAIN_TOL})")
    assert errs[0] <= SHARD_TOL and errs[1] <= CHAIN_TOL, errs
    assert torch.equal(state.tail, state1.tail)
    del outs, outs1, yk, lin
    os_launches += p_conv + p_stream
    cfg3_launches += p_k4

    del xm_c, X, X64

    # 3q. the C ABI: the port's native library, loaded with ctypes into
    # this process with BDSP_PLATFORM unset, so that every vector lives on
    # the card; the dispatch knobs come from the temporary autotune cache
    # (BDSP_AUTOTUNE_CACHE), so no calibration runs inside a C call
    from basic_dsp_tpu_torch import _interop_support as ois
    os.environ.pop("BDSP_PLATFORM", None)
    clib = c_abi(ctypes.CDLL(str(_build.interop_library())))
    assert clib.bdsp_init() == 0, clib.bdsp_last_error()
    assert ois._device == dev, ois._device
    print(f"q: C ABI {_build.interop_library()} initialised, vectors on "
          f"{ois._device}")

    def c_vec(host, is_complex=1):
        """from_data32 of a host array (complex64 read as interleaved
        float32)."""
        flat = np.ascontiguousarray(host).view(np.float32)
        handle = clib.from_data32(is_complex, 0, 1.0, flat.ctypes.data_as(
            ctypes.POINTER(ctypes.c_float)), flat.size)
        assert handle, clib.bdsp_last_error()
        return handle

    def c_data(handle, is_complex=1):
        """get_data32 of a handle, as a tensor on the card."""
        out = np.empty(clib.get_len32(handle), np.float32)
        got = clib.get_data32(handle, out.ctypes.data_as(
            ctypes.POINTER(ctypes.c_float)), out.size)
        assert got == out.size, (got, out.size)
        return torch.from_numpy(out.view(np.complex64) if is_complex
                                else out).to(dev)

    h_np = h.cpu().numpy()
    q_sig, q_taps = c_vec(xh_np), c_vec(h_np)
    assert c_array(q_sig).dtype == torch.complex64
    assert c_array(q_sig).device.type == "cuda"
    reset_counts()
    res = clib.convolve_signal32(q_sig, q_taps)
    torch.cuda.synchronize()
    q_k3 = osc.conv_blocks_cuda.launches
    print(f"main path: convolve_signal32 (C ABI) n={N}, {CONV_TAPS} complex "
          f"taps, conv_blocks_cuda launches: {q_k3}, other kernels: "
          f"{other_launches() - q_k3}")
    assert res.result_code == 0 and q_k3 == 1 and other_launches() == 1, \
        "convolve_signal32 did not launch K3 once"
    yq = c_data(q_sig)
    assert yq.shape == (N,) and bool(torch.isfinite(
        torch.view_as_real(yq)).all())
    errs = (rel_err(yq, vh.convolve_signal(imp).array),
            rel_err(yq.to(torch.complex128),
                    conv_oracle(xh.real, xh.imag, h)))
    print(f"convolve_signal32 vs the typed call {errs[0]:.3e} (tol "
          f"{SHARD_TOL}), vs float64 oracle {errs[1]:.3e} (tol {CHAIN_TOL})")
    assert errs[0] <= SHARD_TOL and errs[1] <= CHAIN_TOL, errs
    clib.delete_vector32(q_sig)
    clib.delete_vector32(q_taps)
    del yq

    x3_np = x3.cpu().numpy()
    q3 = c_vec(x3_np)
    reset_counts()
    res = clib.interpolatef32(q3, 0, 0.0, 1.5, 0.0, 10)
    torch.cuda.synchronize()
    q_k4 = rsc.resample_direct_cuda.launches
    print(f"main path: interpolatef32 (C ABI) x1.5 of {CFG3_N} complex, sinc, "
          f"conv_len 10, resample_direct_cuda launches: {q_k4}, other "
          f"kernels: {other_launches() - q_k4}")
    assert res.result_code == 0 and q_k4 == 1 and other_launches() == 1, \
        "interpolatef32 did not launch K4 once"
    y3q = c_data(q3)
    assert y3q.shape == (CFG3_N * 3 // 2,)
    errs = (rel_err(y3q, bt.to_complex_time_vec(x3).interpolatef(
                sinc, 1.5, 0.0, 10).array),
            rel_err(y3q.to(torch.complex128),
                    resample_oracle(x3, sinc, 3, 2, 10, CFG3_N * 3 // 2)))
    print(f"interpolatef32 vs the typed call {errs[0]:.3e} (tol {SHARD_TOL}), "
          f"vs float64 oracle {errs[1]:.3e} (tol {CHAIN_TOL})")
    assert errs[0] <= SHARD_TOL and errs[1] <= CHAIN_TOL, errs
    clib.delete_vector32(q3)
    del y3q

    # K5 through the 32-bit facade: the factor arrives as a float32.
    # float32(160/147) is no ratio with a denominator up to 512 within
    # 1e-9, and 129/128, which float32 holds, fails the polyphase
    # resampler's size gate: both take the per-sample gather branch, as in
    # the JAX package, and launch no resampler kernel.
    xa_np = xa.cpu().numpy()
    for label, factor in (("160/147", 160 / 147), ("129/128", 129 / 128)):
        f32 = float(np.float32(factor))
        n_out = int(round(AUDIO_N * f32))
        branch = interp_ops._branch(AUDIO_N, f32, 10, n_out + n_out % 2)
        qa = c_vec(xa_np, 0)
        reset_counts()
        res = clib.interpolatef32(qa, 0, 0.0, f32, 0.0, 10)
        torch.cuda.synchronize()
        launches = (rsc.resample_direct_cuda.launches,
                    rsc.resample_rowblock_cuda.launches)
        print(f"q: interpolatef32 {label} (float32 {f32!r}) of {AUDIO_N} real "
              f"samples: _branch {branch}, resample_direct_cuda / "
              f"resample_rowblock_cuda launches {launches}: the per-sample "
              f"gather ran, no K5")
        assert res.result_code == 0 and launches == (0, 0)
        yaq = c_data(qa, 0)
        err = rel_err(yaq, bt.to_real_time_vec(xa).interpolatef(
            sinc, f32, 0.0, 10).array)
        print(f"q: interpolatef32 {label} vs the typed call with the same "
              f"float32 factor: {err:.3e} (tol {SHARD_TOL})")
        assert err <= SHARD_TOL, err
        clib.delete_vector32(qa)
    del yaq

    qs = c_vec(xh_np)
    reset_counts()
    res = clib.windowed_fft32(qs, 1)
    assert res.result_code == 0
    res = clib.magnitude32(qs)
    assert res.result_code == 0
    stats = CRealStatistics()
    assert clib.real_statistics32(qs, ctypes.byref(stats)) == 0
    torch.cuda.synchronize()
    assert other_launches() == 0 and chc.channelize_demod_cuda.launches == 0
    mq = c_data(qs, 0)
    w64 = bt.HammingWindow().sample(N, dtype=torch.float64, device=dev)
    err = rel_err(mq.double(), torch.fft.fftshift(torch.fft.fft(
        xh.to(torch.complex128) * w64)).abs())
    print(f"q: windowed_fft32(Hamming) -> magnitude32 of {N} (C ABI) vs "
          f"float64 oracle: {err:.3e} (tol {CHAIN_TOL}); no kernel")
    assert mq.shape == (N,) and err <= CHAIN_TOL, err
    m64 = mq.cpu().numpy().astype(np.float64)
    want = {"sum": m64.sum(), "average": m64.mean(),
            "rms": math.sqrt(np.mean(m64 * m64)), "min": m64.min(),
            "max": m64.max()}
    st_err = max(abs(getattr(stats, k) - v) / abs(v) for k, v in want.items())
    print(f"q: real_statistics32 (C ABI) vs float64 on the host: "
          f"{st_err:.3e} (tol {STATS_TOL}), count {stats.count}, indices "
          f"({stats.min_index}, {stats.max_index})")
    assert st_err <= STATS_TOL and stats.count == N, st_err
    assert (stats.min_index, stats.max_index) == (int(m64.argmin()),
                                                  int(m64.argmax()))
    clib.delete_vector32(qs)
    del mq, m64, w64

    cb_x = rng.standard_normal(4096).astype(np.float32)
    double_plus_one = C_MAP(lambda value, idx, _: 2.0 * value + 1.0)
    hann = C_WINDOW(lambda _, n, points: 0.5 - 0.5 * math.cos(
        2 * math.pi * n / (points - 1)))
    qc = c_vec(cb_x, 0)
    res = clib.map_inplace_real32(qc, double_plus_one, None)
    assert res.result_code == 0
    res = clib.apply_custom_window32(qc, hann, None, 1)
    assert res.result_code == 0
    got = c_data(qc, 0).double()
    n_cb = np.arange(4096)
    want = torch.from_numpy((2.0 * cb_x.astype(np.float64) + 1.0) * (
        0.5 - 0.5 * np.cos(2 * np.pi * n_cb / 4095))).to(dev)
    err = rel_err(got, want)
    print(f"q: map_inplace_real32 and apply_custom_window32 with ctypes C "
          f"callbacks at 4096 samples vs float64: {err:.3e} (tol "
          f"{KERNEL_TOL}); the result on {c_array(qc).device}, "
          f"{c_array(qc).dtype}")
    assert err <= KERNEL_TOL and c_array(qc).dtype == torch.float32, err
    clib.delete_vector32(qc)

    exe = os.path.join(work, "c_example")
    subprocess.run(["cc", os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "examples", "c_example.c"), *_build.interop_c_flags(),
                    "-o", exe], check=True)
    env = {k: v for k, v in os.environ.items() if k != "BDSP_PLATFORM"}
    t0 = time.perf_counter()
    proc = subprocess.run([exe], capture_output=True, text=True, env=env,
                          cwd=work, timeout=300)
    print(f"q: examples/c_example.c linked against {_build.INTEROP_LIB}, run "
          f"without BDSP_PLATFORM: exit {proc.returncode} in "
          f"{time.perf_counter() - t0:.2f} s (process start, torch import, "
          f"CUDA init); stdout {proc.stdout!r}")
    assert proc.returncode == 0, proc.stderr
    assert "vec[0] = 25" in proc.stdout and proc.stdout.endswith("ok\n")
    os_launches += q_k3
    cfg3_launches += q_k4

    # 3r. the entry points outside the package: entry(), the
    # multi-chip dry run on this card, the multi-host harness as one host
    # of one rank at full width, and the user examples
    r_t0 = time.perf_counter()
    from basic_dsp_tpu_torch import entry as bentry
    from basic_dsp_tpu_torch import multihost
    from basic_dsp_tpu_torch.examples import (crosstalk, modulation,
                                              slow_down_music,
                                              streaming_pipeline)
    r_launches = dict.fromkeys(bkernels.wrappers(), 0)

    def tally(counts):
        for k, v in counts.items():
            r_launches[k] += v

    e_fn, e_args = bentry.entry()
    reset_counts()
    e_out = e_fn(*e_args)
    torch.cuda.synchronize()
    fired = bkernels.launch_counts()
    tally(fired)
    ex, etaps, ewin = e_args
    err = rel_err(e_out.double(), oracle(ex.real, ex.imag, etaps, ewin))
    print(f"r: entry() fir_fft_chain, n={bentry.ENTRY_N}, {bentry.ENTRY_TAPS} "
          f"complex taps, Hamming: {err:.3e} from the float64 oracle (tol "
          f"{CHAIN_TOL}); launches {fired}")
    assert e_out.shape == (bentry.ENTRY_N,) and err <= CHAIN_TOL, err
    assert fired["K1n"] == fired["K8"] == 1 and sum(fired.values()) == 2, \
        fired

    t0 = time.perf_counter()
    dry = bentry.dryrun_multichip(1)
    dry_s = time.perf_counter() - t0
    for name, st in dry["steps"].items():
        fired = {k: v for k, v in st["launches"].items() if v}
        tally(fired)
        print(f"r: dryrun_multichip(1) {name}: {st['max_err']:.3e} of max "
              f"from the single-device call (tol {bentry.DRYRUN_TOL}); "
              f"launches {fired}")
        assert st["max_err"] <= bentry.DRYRUN_TOL, (name, st)
    print(f"r: dryrun_multichip(1): {len(dry['steps'])} steps on "
          f"{dry['device']}, wall {dry_s:.2f} s (one spawned rank)")
    assert dry["steps"]["mesh of 1: sharded_interpolatef"]["launches"][
        "K4"] == 1

    t0 = time.perf_counter()
    mh = multihost.run(1, 1, N, CONV_TAPS, timeout=300)
    mh_s = time.perf_counter() - t0
    for name, chk in mh["checks"].items():
        tally(chk["launches"])
        print(f"r: multihost.run(1, 1, {N}, {CONV_TAPS}) {name}: {chk}")
    print(f"r: multihost timing {mh['timing']}; device {mh['device']}; wall "
          f"{mh_s:.2f} s (one host process, one spawned rank)")
    assert mh["ok"] and mh["global_devices"] == 1, mh
    assert mh["checks"]["sharded_convolve_signal"]["launches"] == {"K3": 1}
    assert mh["checks"]["sharded_interpolatef"]["launches"] == {"K4": 1}

    # a 60 s, 44.1 kHz stereo PCM16 WAV from numpy seed 0, at an amplitude
    # (0.25) that the x1.5 sinc resample and the crosstalk keep inside the
    # PCM16 range: a clipped sample would differ from the float64 result
    frames = 60 * 44100
    src = os.path.join(work, "music.wav")
    wav = np.random.default_rng(0).uniform(-0.25, 0.25, (frames, 2))
    bt.io.write_wav(src, wav.astype(np.float32), 44100)
    held, _ = bt.io.read_wav(src)          # the PCM16 frames as read back
    slow = os.path.join(work, "slow.wav")
    reset_counts()
    t0 = time.perf_counter()
    slow_down_music.main(src, slow)
    slow_s = time.perf_counter() - t0
    fired = bkernels.launch_counts()
    tally(fired)
    got, rate = bt.io.read_wav(slow)
    x_wav = torch.complex(torch.from_numpy(held[:, 0]).double(),
                       torch.from_numpy(held[:, 1]).double()).to(dev)
    want = resample_oracle(x_wav, sinc, 3, 2, 10, frames * 3 // 2)
    step = pcm16_steps(got, torch.stack((want.real, want.imag)))
    branch = interp_ops._branch(frames, 1.5, 10, frames * 3 // 2)
    print(f"r: slow_down_music on {frames} stereo PCM16 frames (60 s at "
          f"44.1 kHz): _branch {branch}, "
          f"launches {fired}, output {got.shape[0]} frames at {rate} Hz "
          f"{step:.0f} PCM16 codes from the float64 resample's (tol 1); wall "
          f"{slow_s:.2f} s (WAV read and write included)")
    assert got.shape == (frames * 3 // 2, 2) and step <= 1.0, step
    assert fired["K4"] == 1 and sum(fired.values()) == 1, fired
    del x_wav, want

    mod_dir = os.path.join(work, "modulation")
    os.makedirs(mod_dir)
    reset_counts()
    modulation.main(mod_dir)
    fired = bkernels.launch_counts()
    tally(fired)
    prbs = modulation.Prbs15()
    worst = 0.0
    for i in range(3):
        bits = np.array([prbs.next() for _ in range(
            2 * modulation.NUMBER_OF_SYMBOLS)])
        real = np.loadtxt(os.path.join(mod_dir, f"modulated_time{i}.csv"))
        assert real.shape == (10 * modulation.NUMBER_OF_SYMBOLS,)
        worst = max(worst, float(np.abs(real[::10] - bits[1::2]).max()))
    print(f"r: modulation, 3 blocks of {modulation.NUMBER_OF_SYMBOLS} "
          f"float32 symbols x10: every 10th sample {worst:.3e} from its "
          f"symbol (tol 1e-5); launches {fired}")
    assert worst <= 1e-5 and fired["K4"] == 3 and sum(fired.values()) == 3

    cross = os.path.join(work, "cross.wav")
    reset_counts()
    crosstalk.main(src, cross)
    fired = bkernels.launch_counts()
    got, _ = bt.io.read_wav(cross)
    att = np.array([0.2, 0.0, 0.0, 0.5, 0.0, 0.0, 0.0])
    ctk = np.array([0.0, 0.0, 0.0, 0.3, 0.0, 0.0, 0.0])
    imp_x = torch.from_numpy(np.stack([np.stack([att, ctk]),
                                       np.stack([ctk, att])])).to(dev)
    rows_x = torch.from_numpy(held.T.astype(np.float64)).to(dev)
    G = torch.fft.fft(torch.stack([torch.stack([
        conv_ops.kernel_layout(imp_x[c, r].to(torch.complex128), frames)
        for r in range(2)]) for c in range(2)]), dim=-1)
    want = torch.fft.ifft(torch.einsum("crn,rn->cn", G, torch.fft.fft(
        rows_x.to(torch.complex128), dim=-1)), dim=-1).real
    step = pcm16_steps(got, want)
    print(f"r: crosstalk on the same WAV: {step:.0f} PCM16 codes from the "
          f"float64 einsum's (tol 1); launches {fired}")
    assert got.shape == (frames, 2) and step <= 1.0, step
    assert sum(fired.values()) == 0, fired
    del G, want, rows_x

    reset_counts()
    sp = streaming_pipeline.main(8)
    torch.cuda.synchronize()
    fired = bkernels.launch_counts()
    tally(fired)
    rs_sp, fir_sp = sp["resampler"], sp["fir"]
    up, filt = sp["resampled"], sp["filtered"]
    d = rs_sp.output_delay
    ref = resample_oracle(sp["input"], sinc, 3, 2, 10, up.shape[-1] - d,
                          circular=False)
    err_up = rel_err(up[d:].double(), ref)
    lin = np.convolve(up.double().cpu().numpy(),
                      sp["taps"].double().cpu().numpy())[:filt.shape[-1]]
    err_f = rel_err(filt.double().cpu(), torch.from_numpy(lin))
    print(f"r: streaming_pipeline(8): launches {fired} (K4 a chunk; the "
          f"64-tap FIR's extended chunk of {768 + fir_sp.m - 1} is shorter "
          f"than its block length {fir_sp.fft_len}: the whole-extent FFT, "
          f"no K3); resampled vs the float64 linear resample delayed by {d}: "
          f"{err_up:.3e}, filtered vs the float64 causal linear convolution "
          f"of the resampled stream: {err_f:.3e} (tol {CHAIN_TOL})")
    assert fired["K4"] == 8 and sum(fired.values()) == 8, fired
    assert err_up <= CHAIN_TOL and err_f <= CHAIN_TOL, (err_up, err_f)

    # the gradient refusal: each wrapper, given an input that requires
    # grad, raises; the same call under no_grad runs and equals its plain
    # version
    taps_k4, offs_k4 = interp_ops.polyphase_taps(sinc, 3, 2, 0.0, 10,
                                                 torch.float32, dev)
    taps_k5, offs_k5 = interp_ops.polyphase_taps(sinc, 147, 160, 0.0, 10,
                                                 torch.float32, dev)
    proto_g = torch.from_numpy((np.hamming(256 * 4) / 256)
                               .astype(np.float32)).to(dev)
    ts_g = chz._merged_tap_rows(proto_g, 256)
    Br, Bi = planes(8, 256)
    Ar, Ai = planes(8, 256)
    gx, gy = planes(4096)
    ghr, ghi = planes(33)
    gw = bt.HammingWindow().sample(4096, device=dev)
    rows_g = torch.from_numpy(rng.standard_normal((2, 4096), np.float32)
                              ).to(dev)
    rows_5 = torch.from_numpy(rng.standard_normal((1, 1 << 16), np.float32)
                              ).to(dev)
    cr, ci = planes(256 * 1024)
    n5 = evened(1 << 16, 147, 160)
    refusals = [
        ("rowfft_mag", lambda a: sc.rowfft_mag(a, Bi),
         lambda a: sc.rowfft_mag_plain(a, Bi), Br),
        ("rowfft_mag_natural", lambda a: sc.rowfft_mag_natural(a, Bi),
         lambda a: sc.rowfft_mag_natural_plain(a, Bi), Br),
        ("fourstep_mag_fused", lambda a: sc.fourstep_mag_fused(a, Ai),
         lambda a: sc.fourstep_mag_fused_plain(a, Ai), Ar),
        ("conv_blocks_cuda (circular_conv_cuda)",
         lambda a: osc.circular_conv_cuda(gx, gy, a, ghi, 1024),
         lambda a: osc.circular_conv_plain(gx, gy, a, ghi, 1024), ghr),
        ("conv_blocks_cuda (blocked_linear_conv_cuda)",
         lambda a: osc.blocked_linear_conv_cuda(a, gy, ghr, ghi, 1024),
         lambda a: osc.blocked_linear_conv_plain(a, gy, ghr, ghi, 1024), gx),
        ("resample_direct_cuda",
         lambda a: rsc.resample_direct_cuda(a, taps_k4, 3, 2, offs_k4, 10,
                                            6144),
         lambda a: rsc.resample_direct_plain(a, taps_k4, 3, 2, offs_k4, 10,
                                             6144,
                                             interp_ops._choose_c(3, 2)),
         rows_g),
        ("resample_rowblock_cuda",
         lambda a: rsc.resample_rowblock_cuda(a, taps_k5, 147, 160, offs_k5,
                                              10, n5),
         lambda a: rsc.resample_rowblock_plain(a, taps_k5, 147, 160,
                                               offs_k5, 10, n5), rows_5),
        ("channelize_demod_cuda (z, demod=False)",
         lambda a: chc.channelize_demod_cuda(a, ci, ts_g, 256, False),
         lambda a: chc.channelize_demod_plain(a, ci, ts_g, 256, False), cr),
        ("fir_window_cuda",
         lambda a: fcu.fir_window_cuda(a, gy, ghr, gw),
         lambda a: fcu.fir_window_plain(a, gy, ghr, gw), gx),
        ("stage1_cuda", lambda a: sc.stage1_cuda(a, Ai),
         lambda a: sc.stage1_plain(a, Ai), Ar),
    ]
    for name, kernel, plain, arg in refusals:
        leaf = arg.clone().requires_grad_()
        reset_counts()
        try:
            kernel(leaf)
        except RuntimeError as e:
            assert "has no backward" in str(e), e
            refused = str(e).split(";")[0]
        else:
            raise AssertionError(f"{name} accepted an input that requires "
                                 f"grad")
        assert (other_launches() + chc.channelize_demod_cuda.launches
                + fcu.fir_window_cuda.launches
                + sc.stage1_cuda.launches) == 0
        with torch.no_grad():
            got = kernel(leaf)
            ref = plain(leaf)
        torch.cuda.synchronize()
        got = torch.stack(got) if isinstance(got, tuple) else got
        ref = torch.stack(ref) if isinstance(ref, tuple) else ref
        err = rel_err(got, ref)
        print(f"r: gradient refusal, {name}: raised \"{refused}\"; under "
              f"torch.no_grad() {err:.3e} from the plain version (tol "
              f"{KERNEL_TOL})")
        assert err <= KERNEL_TOL, (name, err)
    del Br, Bi, Ar, Ai, cr, ci, rows_5, rows_g
    r_s = time.perf_counter() - r_t0
    print(f"r: phase r took {r_s:.2f} s; its launches {r_launches} (the "
          f"dry run's and the multi-host rank's as their records report "
          f"them)")
    k1_launches += r_launches["K1"]
    k1n_launches += r_launches["K1n"]
    os_launches += r_launches["K3"]
    cfg3_launches += r_launches["K4"]
    audio_launches += r_launches["K5"]
    chan_launches += r_launches["K6"]
    fused_launches += r_launches["K2"]
    k7_launches += r_launches["K7"]
    k8_launches += r_launches["K8"]

    s_launches = phase_s(work)
    k1_launches += s_launches["K1"]
    k1n_launches += s_launches["K1n"]
    fused_launches += s_launches["K2"]
    os_launches += s_launches["K3"]
    cfg3_launches += s_launches["K4"]
    audio_launches += s_launches["K5"]
    chan_launches += s_launches["K6"]
    k7_launches += s_launches["K7"]
    k8_launches += s_launches["K8"]

    dist.destroy_process_group()

    # 4. the kernels line: each kernel at its main path's shape, kernel,
    # plain version and library call in turns, and its bound from the same
    # tensors by the benchmark's roofline arithmetic.
    rows = []

    def measure(name, source, replaces, launches, max_abs_err, fns, inputs,
                output, flops):
        med = in_turns(name, fns, smi)
        bound_ms, bound_by = floors.floor_ms(nbytes(*inputs, *output),
                                             flops)[:2]
        print(f"{name}: bound {bound_ms * 1e3:.2f} us ({bound_by}), "
              f"kernel at {bound_ms / med['kernel']:.3f} of it on {smi}")
        dev_ms = graph_ms(fns["kernel"])
        prof_ms, per_kernel = timing.device_ms(fns["kernel"])
        print(f"{name}: device " + ("did not capture" if dev_ms is None
                                    else f"{dev_ms * 1e3:.1f} us/call, "
                                    f"{bound_ms / dev_ms:.3f} of the bound")
              + f" (CUDA-graph replay); torch.profiler read "
              f"{prof_ms * 1e3:.1f} us/call: "
              + ", ".join(f"{k[:48]} {v * 1e3:.1f} us"
                          for k, v in per_kernel.items()))
        if dev_ms is not None and dev_ms < bound_ms:
            print(f"{name}: device time not measured: below the bound")
            dev_ms = None
        rows.append({
            "name": name.split(" ")[0], "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": max_abs_err, "ms": med["kernel"],
            "plain_ms": med["plain"], "bound_ms": bound_ms,
            "bound_us": bound_ms * 1e3, "bound_by": bound_by,
            "library_ms": med.get("library"), "device_ms": dev_ms})

    n1, n2 = 128, 32768
    L2 = n2 // 128
    Br, Bi = planes(n1, n2)
    T = tfac(n1, n2)
    W = sc.inner_twiddle(L2, n2, dev)
    C = torch.complex(Br, Bi)
    measure("rowfft_mag (128, 32768)", "basic_dsp_tpu_torch/csrc/rowfft_mag.cu",
            "basic_dsp_tpu/kernels/spectrum_pallas.py:471", k1_launches,
            abs_err_4m,
            {"plain": lambda: sc.rowfft_mag_plain(Br, Bi, True, T),
             "kernel": lambda: sc.rowfft_mag(Br, Bi, True, T, W),
             "library": lambda: torch.fft.fft(C, dim=-1)},
            (Br, Bi, *T, *W), (torch.empty(n1, L2, 128, device=dev),),
            N * (6 + 5 * np.log2(n2) + 4))
    # K1's natural entry: the same bytes and operations, the magnitudes
    # stored in spectrum order; yardstick, the path it replaces (K1, then
    # the flatten's copy)
    k1n_fns = {
        "plain": lambda: sc.rowfft_mag_natural_plain(Br, Bi, True, T),
        "kernel": lambda: sc.rowfft_mag_natural(Br, Bi, True, T, W),
        "library": lambda: torch.fft.fft(C, dim=-1),
        "K1 and flatten": lambda: sc.natural_flatten(
            sc.rowfft_mag(Br, Bi, True, T, W))}
    measure("rowfft_mag_natural (128, 32768)",
            "basic_dsp_tpu_torch/csrc/rowfft_mag.cu",
            "basic_dsp_tpu/kernels/spectrum_pallas.py:471 and the "
            "natural_flatten copy", k1n_launches, k1n_abs_err_4m, k1n_fns,
            (Br, Bi, *T, *W), (torch.empty(N, device=dev),),
            N * (6 + 5 * np.log2(n2) + 4))
    ms = graph_ms(k1n_fns["K1 and flatten"])
    print(f"rowfft_mag_natural yardstick K1 and flatten: device "
          + ("did not capture" if ms is None else f"{ms * 1e3:.1f} us/call")
          + f" (CUDA-graph replay) on {smi}")
    Ar, Ai = planes(n1, n2)
    A = torch.complex(Ar, Ai).reshape(-1)
    measure("fourstep_mag_fused (128, 32768)",
            "basic_dsp_tpu_torch/csrc/rowfft_mag.cu",
            "basic_dsp_tpu/kernels/spectrum_pallas.py:616", fused_launches,
            k2_abs_err_4m,
            {"plain": lambda: sc.fourstep_mag_fused_plain(Ar, Ai, True),
             "kernel": lambda: sc.fourstep_mag_fused(Ar, Ai, True, W),
             "library": lambda: torch.abs(torch.fft.fftshift(
                 torch.fft.fft(A)))},
            (Ar, Ai, *W, *T), (torch.empty(n1, L2, 128, device=dev),),
            N * (5 * np.log2(N) + 6 + 4))
    del Br, Bi, C, Ar, Ai, A
    hr, hi = h.real.contiguous(), h.imag.contiguous()
    _, os_L, os_nb = osc._geometry(N, CONV_TAPS, CONV_FFT_LEN)
    blocks = torch.nn.functional.pad(
        torch.nn.functional.pad(x, (0, os_nb * os_L - N)).reshape(os_nb,
                                                                  os_L),
        (0, CONV_FFT_LEN - os_L))
    H = osc.spectrum(h, CONV_FFT_LEN)
    H_blocks = torch.fft.fft(h, n=CONV_FFT_LEN)
    # the same centered circular convolution as one whole-signal product:
    # Hn the length-N FFT of the taps laid out on the circle
    Hn = torch.fft.fft(conv_ops.kernel_layout(h, N))
    measure(f"overlap_save (n={N}, {CONV_TAPS} taps, fft_len "
            f"{CONV_FFT_LEN})", "basic_dsp_tpu_torch/csrc/overlap_save.cu",
            "basic_dsp_tpu/kernels/overlap_save_pallas.py:192", os_launches,
            os_abs_err_4m,
            {"plain": lambda: osc.conv_blocks_plain(xr, xi, H, CONV_TAPS,
                                                    CONV_FFT_LEN),
             "kernel": lambda: osc.conv_blocks_cuda(xr, xi, H, CONV_TAPS,
                                                    CONV_FFT_LEN),
             "kernel with H": lambda: osc.circular_conv_cuda(
                 xr, xi, hr, hi, CONV_FFT_LEN),
             "library": lambda: torch.fft.ifft(torch.fft.fft(x) * Hn),
             "blocks": lambda: torch.fft.ifft(
                 torch.fft.fft(blocks, dim=-1) * H_blocks, dim=-1)},
            (xr, xi, H), (torch.empty(2, N, device=dev),),
            os_nb * (2 * 5 * CONV_FFT_LEN * np.log2(CONV_FFT_LEN)
                     + 6 * CONV_FFT_LEN))
    del blocks
    rows3 = torch.stack((x3.real, x3.imag))
    taps3, offs3 = interp_ops.polyphase_taps(sinc, 3, 2, 0.0, 10,
                                             torch.float32, dev)
    out3 = CFG3_N * 3 // 2
    measure(f"resample_direct (P=3, Q=2, L=10, 2 x {CFG3_N})",
            "basic_dsp_tpu_torch/csrc/resample.cu",
            "basic_dsp_tpu/kernels/resample_pallas.py:119", cfg3_launches,
            rs_abs_err[("direct", 3, 2, 1 << 20, 2)],
            {"plain": lambda: rsc.resample_direct_plain(
                rows3, taps3, 3, 2, offs3, 10, out3),
             "kernel": lambda: rsc.resample_direct_cuda(
                 rows3, taps3, 3, 2, offs3, 10, out3)},
            (rows3, taps3), (torch.empty(2, out3, device=dev),),
            2 * 21 * 2 * out3)
    rowsa = xa[None]
    tapsa, offsa = interp_ops.polyphase_taps(sinc, 160, 147, 0.0, 10,
                                             torch.float32, dev)
    measure(f"resample_rowblock (P=160, Q=147, L=10, 1 x {AUDIO_N})",
            "basic_dsp_tpu_torch/csrc/resample.cu",
            "basic_dsp_tpu/kernels/resample_pallas.py:260", audio_launches,
            rs_abs_err[("rowblock", 160, 147, 1 << 20, 1)],
            {"plain": lambda: rsc.resample_rowblock_plain(
                rowsa, tapsa, 160, 147, offsa, 10, audio_len),
             "kernel": lambda: rsc.resample_rowblock_cuda(
                 rowsa, tapsa, 160, 147, offsa, 10, audio_len)},
            (rowsa, tapsa), (torch.empty(1, audio_len, device=dev),),
            2 * 21 * audio_len)
    ts5 = chan5.taps_merged
    Y5 = torch.complex(xr5, xi5).reshape(S5, CHAN_C)
    measure(f"channelize_demod (C={CHAN_C}, S={S5}, {CHAN_TAPS + 1} tap "
            f"rows)", "basic_dsp_tpu_torch/csrc/channelizer.cu",
            "basic_dsp_tpu/kernels/channelizer_pallas.py:221", chan_launches,
            k6_abs_err,
            {"plain": lambda: chc.channelize_demod_plain(xr5, xi5, ts5,
                                                         CHAN_C),
             "kernel": lambda: chc.channelize_demod_cuda(xr5, xi5, ts5,
                                                         CHAN_C),
             "library": lambda: torch.fft.ifft(Y5, dim=-1)},
            (xr5, xi5, ts5), (torch.empty(CHAN_C, S5, device=dev),),
            CHAN_N * (4 * (CHAN_TAPS + 1) + 5 * np.log2(CHAN_C) + 6 + 1))
    # K7 at the chain's shape, its yardsticks in turns beside it: the
    # Toeplitz FIR and window it replaced (its plain version, with held
    # band matrices) and K3 in circular mode on the same planes.  Its
    # operations count the cheaper of the direct sum and overlap-save, as
    # every FIR floor does (floors.fir_flops): its bound is bytes.
    H7 = osc.spectrum(taps.to(torch.complex64), CONV_FFT_LEN)
    bands7 = conv_ops.toeplitz_bands(taps, N)
    fir_fns = {
        "plain": lambda: fcu.fir_window_plain(xr, xi, taps, window, bands7),
        "kernel": lambda: fcu.fir_window_cuda(xr, xi, taps, window),
        "K3 circular": lambda: osc.conv_blocks_cuda(xr, xi, H7, TAPS,
                                                    CONV_FFT_LEN)}
    measure(f"fir_window (n={N}, {TAPS} taps, window)",
            "basic_dsp_tpu_torch/csrc/fir_window.cu",
            "none (the JAX chain's FIR is XLA matmuls)", k7_launches,
            k7_abs_err_4m, fir_fns, (xr, xi, taps, window),
            (torch.empty(2, N, device=dev),),
            (floors.fir_flops(TAPS) + 2) * N)
    for label in ("plain", "K3 circular"):
        ms = graph_ms(fir_fns[label])
        print(f"fir_window yardstick {label}: device "
              + ("did not capture" if ms is None else f"{ms * 1e3:.1f} "
                 f"us/call") + f" (CUDA-graph replay) on {smi}")
    # K8 at the chain's shape: its plain version is the Karatsuba matmuls
    # it replaced (held planes), its yardstick torch.fft down the columns.
    # Operations: the column FFTs, 5 N log2 n1.
    Ar, Ai = planes(128, 32768)
    A8 = torch.complex(Ar, Ai)
    measure("fourstep_stage1 (128, 32768)",
            "basic_dsp_tpu_torch/csrc/rowfft_mag.cu",
            "none (the JAX chain's stage 1 is XLA matmuls)", k8_launches,
            k8_abs_err_4m,
            {"plain": lambda: sc.stage1_plain(Ar, Ai),
             "kernel": lambda: sc.stage1_cuda(Ar, Ai),
             "library": lambda: torch.fft.fft(A8, dim=0)},
            (Ar, Ai), (torch.empty(2, 128, 32768, device=dev),),
            5 * N * 7)
    del Ar, Ai, A8
    # o. profiling: time_op and throughput against a CUDA-event median of
    # the same call, and a trace on disk
    chain_ms = median_ms(lambda: chain(xr, xi))
    t_op = profiling.time_op(chain, xr, xi, iters=REPS)
    t_put = profiling.throughput(chain, N, xr, xi, iters=REPS)
    ratio = t_op["per_iter_s"] * 1e3 / chain_ms
    print(f"profiling.time_op FirFftChainPlanar: "
          f"{t_op['per_iter_s'] * 1e3:.4f} ms/iter over {REPS}, {ratio:.3f} "
          f"of the event median {chain_ms:.4f} ms; throughput "
          f"{t_put['msamples_per_s']:.1f} Msamples/s on {smi}")
    assert 0.5 <= ratio <= 2.0, ratio
    assert t_put["msamples_per_s"] > 0
    trace_dir = os.path.join(work, "trace")
    with profiling.trace(trace_dir):
        chain(xr, xi)
    traces = glob.glob(os.path.join(trace_dir, "trace_*.json"))
    assert len(traces) == 1 and os.path.getsize(traces[0]) > 0, traces
    with open(traces[0]) as f:
        events = json.load(f)["traceEvents"]
    kernels = sorted({e["name"][:40] for e in events
                      if e.get("cat") == "kernel"})
    print(f"profiling.trace: {os.path.getsize(traces[0])} bytes, "
          f"{len(events)} events, device kernels {kernels}")

    # t. the benchmark programs, after phase 4's timings; u. K3's bank
    t_launches = phase_t(work)
    u_launches = phase_u(work)
    kernel_of = {"rowfft_mag": "K1", "rowfft_mag_natural": "K1n",
                 "fourstep_mag_fused": "K2",
                 "overlap_save": "K3", "resample_direct": "K4",
                 "resample_rowblock": "K5", "channelize_demod": "K6",
                 "fir_window": "K7", "fourstep_stage1": "K8"}
    assert [r["name"] for r in rows] == list(kernel_of)
    for row in rows:
        row["launches"] += (t_launches[kernel_of[row["name"]]]
                            + u_launches[kernel_of[row["name"]]])

    # n. autotune, last: calibrate with JAX's defaults, reload from the
    # cache, a typed convolution under the tuned knobs, then the defaults
    try:
        entry = bt.autotune.calibrate()
        print(smi)
        bt.autotune.print_calibration()
        bt.autotune._reset_for_tests()
        loaded = bt.autotune.ensure_calibrated()
        print(f"autotune: ensure_calibrated after a reset: source "
              f"{loaded['source']!r}, fft_block_len "
              f"{bt.default_config().fft_block_len}, direct_conv_max_imp_len "
              f"{bt.default_config().direct_conv_max_imp_len}")
        assert loaded["source"] == "cache"
        assert (loaded["fft_block_len"], loaded["direct_conv_max_imp_len"]) \
            == (entry["fft_block_len"], entry["direct_conv_max_imp_len"])
        reset_counts()
        yh = vh.convolve_signal(imp)
        torch.cuda.synchronize()
        err = rel_err(yh.array.to(torch.complex128),
                      conv_oracle(xh.real, xh.imag, h))
        print(f"typed convolve_signal under the tuned knobs vs float64 "
              f"oracle: {err:.3e} (tol {CHAIN_TOL}), conv_blocks_cuda "
              f"launches: {osc.conv_blocks_cuda.launches}")
        assert err <= CHAIN_TOL, err
    finally:
        bt.set_default_config(default_cfg)
        bt.autotune._reset_for_tests()
    assert bt.default_config() == default_cfg
    print(f"peak device memory: "
          f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")

    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        sys.exit(main(tmp))
