#!/usr/bin/env python3
"""The multi-device layer across ranks: every sharded function on a mesh
of one card a rank over NCCL, held against its single-device function and
timed against it.

    python3 basic_dsp_tpu_torch/probes/mesh_check.py [--ranks 4] [--cpu]
                                                     [--shrink K] [--out F]

Spawns one process a rank (``torch.distributed`` over
``tcp://localhost``, a free port), then builds the 1-D mesh of all ranks
and the (2, ranks/2) host-major mesh, and on each runs at full size:
``sharded_fft`` of 2^22 complex64 (natural order and not) and
``sharded_fft_planar``; ``sharded_convolve_mat`` of (8, 2^19) complex64
with an (8, 8, 64) grid; ``to_complex_time_vec_par`` of the 2^22 signal
with ``convolve_signal`` (384 taps), ``plain_fft``, ``sum`` and
``statistics``; ``StreamingFir`` (384 taps) over 16 sharded chunks of
2^16; ``sharded_convolve_signal`` (384 taps), ``sharded_interpolatef``
(x1.5 of 2^20) and ``sharded_sum`` of PR 10's layer.  Every rank holds
the whole input (numpy seed 0) and checks its result against the
single-device function on it (<= 1e-6 of the maximum; sums of sum |x|)
and the kernels' launch counts (one K3 a rank for a convolution, one a
chunk for the stream, one K4 for the resampler).  Then each function and
its single-device counterpart are timed on every rank: CUDA events around
20 calls after a barrier, three times; the line gives the median per call
of the slowest rank.  Rank 0 prints each line with the card's name and
power limit and, with ``--out``, writes them to that JSON file.

``--cpu`` runs the same on gloo ranks on the CPU (the sizes divided by
``--shrink``, 64 by default), to rehearse without a card.
"""
import argparse
import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

TOL = 1e-6
REPS, LOOPS = 20, 3


def _rel(got, ref):
    return float((got - ref).abs().max() / ref.abs().max())


def _timed(fn, dev, dist):
    """ms a call: ``LOOPS`` loops of ``REPS`` calls, each loop after a
    barrier, between two CUDA events (the host clock on the CPU)."""
    fn()
    fn()
    out = []
    for _ in range(LOOPS):
        if dev.type == "cuda":
            torch.cuda.synchronize()
        dist.barrier()
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(REPS):
                fn()
            stop.record()
            stop.synchronize()
            out.append(start.elapsed_time(stop) / REPS)
        else:
            t0 = time.perf_counter()
            for _ in range(REPS):
                fn()
            out.append((time.perf_counter() - t0) * 1e3 / REPS)
    return float(np.median(out))


def _rank(rank, world, port, cpu, shrink, out_path, tmp):
    import torch.distributed as dist

    import basic_dsp_tpu_torch as bt
    from basic_dsp_tpu_torch import config, matrix, streaming
    from basic_dsp_tpu_torch.kernels import overlap_save_cuda as osc
    from basic_dsp_tpu_torch.kernels import resample_cuda as rsc
    from basic_dsp_tpu_torch.ops import conv_ops, interp_ops
    from basic_dsp_tpu_torch.parallel import sharded, sharded_fft

    kind = "cpu" if cpu else "cuda"
    if cpu:
        torch.set_num_threads(1)
    config.distributed_init(f"localhost:{port}", world, rank, kind)
    dev = (torch.device("cpu") if cpu
           else torch.device("cuda", torch.cuda.current_device()))
    # the typed convolutions calibrate at their first large call: a cache
    # of the default knobs keeps both sides on them without timing
    os.environ["BDSP_AUTOTUNE_CACHE"] = os.path.join(tmp, f"at{rank}.json")
    akind = "cpu" if cpu else torch.cuda.get_device_name(dev)
    with open(os.environ["BDSP_AUTOTUNE_CACHE"], "w") as f:
        json.dump({akind: {"device_kind": akind, "fft_block_len": 0,
                           "direct_conv_max_imp_len": 202}}, f)
    name = ("cpu (gloo)" if cpu else subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "-i", str(dev.index)],
        capture_output=True, text=True, check=True).stdout.strip())
    s = 1 if not cpu else shrink
    n, n3, rows, mat_n, chunk = ((1 << 22) // s, (1 << 20) // s, 8,
                                 (1 << 19) // s, (1 << 16) // s)
    rng = np.random.default_rng(0)
    x_np = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(
        np.complex64)
    x = torch.from_numpy(x_np).to(dev)
    h = torch.from_numpy((rng.standard_normal(384)
                          + 1j * rng.standard_normal(384)).astype(
                              np.complex64)).to(dev)
    x3 = x[:n3].contiguous()
    xm = torch.from_numpy((rng.standard_normal((rows, mat_n))
                           + 1j * rng.standard_normal((rows, mat_n)))
                          .astype(np.complex64)).to(dev)
    grid = (rng.standard_normal((rows, rows, 64))
            + 1j * rng.standard_normal((rows, rows, 64))).astype(np.complex64)
    sinc = bt.SincFunction()
    lines = []

    def say(text):
        if rank == 0:
            print(f"{text} on {name}", flush=True)
            lines.append(f"{text} on {name}")

    meshes = [("mesh of %d" % world, bt.make_mesh(world, device_type=kind))]
    if world % 2 == 0 and world > 2:
        meshes.append((f"(2, {world // 2}) mesh", bt.make_mesh(
            shape=(2, world // 2), device_type=kind)))
    for label, mesh in meshes:
        vp = bt.to_complex_time_vec_par(x, mesh)
        vh = bt.to_complex_time_vec(x)
        taps = bt.to_complex_time_vec(h)
        n1, n2 = sharded_fft._split_factors(n)
        fir, fir1 = streaming.StreamingFir(h), streaming.StreamingFir(h)

        def stream(fir, shard):
            state, outs = fir.init_state(), []
            for k in range(16):
                piece = x[k * chunk:(k + 1) * chunk]
                if shard:
                    piece = sharded.shard_time_axis(piece, mesh)
                out, state = fir.process(piece, state)
                outs.append(out)
            return outs

        cases = [
            ("sharded_fft", lambda: sharded_fft.sharded_fft(x, mesh),
             lambda: torch.fft.fft(x), lambda y: y.full_tensor(), None, 0),
            ("sharded_fft natural_order=False",
             lambda: sharded_fft.sharded_fft(x, mesh, natural_order=False),
             lambda: torch.fft.fft(x).reshape(n2, n1).T,
             lambda y: y.full_tensor(), None, 0),
            ("sharded_fft_planar",
             lambda: sharded_fft.sharded_fft_planar(x.real, x.imag, mesh),
             lambda: torch.fft.fft(x),
             lambda y: torch.complex(y[0].full_tensor(),
                                     y[1].full_tensor()), None, 0),
            ("sharded_convolve_mat",
             lambda: bt.parallel.sharded_convolve_mat(xm, grid, mesh),
             lambda: matrix._convolve_mat(
                 xm, torch.from_numpy(grid).to(dev), True),
             lambda y: y.full_tensor(), None, 0),
            ("par convolve_signal", lambda: vp.convolve_signal(taps),
             lambda: vh.convolve_signal(taps),
             lambda y: y.array.full_tensor(), osc.conv_blocks_cuda, 1),
            ("par plain_fft", lambda: vp.plain_fft(), lambda: vh.plain_fft(),
             lambda y: y.array.full_tensor(), None, 0),
            ("StreamingFir, 16 sharded chunks", lambda: stream(fir, True),
             lambda: stream(fir1, False),
             lambda ys: torch.cat([y.full_tensor() for y in ys]),
             osc.conv_blocks_cuda, 16),
            ("sharded_convolve_signal",
             lambda: bt.parallel.sharded_convolve_signal(x, h, mesh),
             lambda: conv_ops.convolve_signal(x, h, True),
             lambda y: y.full_tensor(), osc.conv_blocks_cuda, 1),
            ("sharded_interpolatef x1.5",
             lambda: bt.parallel.sharded_interpolatef(x3, sinc, 1.5, 0.0,
                                                      10, mesh),
             lambda: interp_ops.interpolatef(x3, sinc, 1.5, 0.0, 10, 1.0),
             lambda y: y.full_tensor(), rsc.resample_direct_cuda, 1),
        ]
        for case, fn, single, whole, counter, launches in cases:
            if counter is not None:
                counter.launches = 0
            got = fn()
            if dev.type == "cuda":
                torch.cuda.synchronize()
            if counter is not None and not cpu:
                assert counter.launches == launches, (case, counter.launches)
            ref = single()
            ref = torch.cat(ref).reshape(-1) if isinstance(ref, list) \
                else getattr(ref, "array", ref)
            err = _rel(whole(got).reshape(ref.shape), ref)
            assert err <= TOL, (case, label, err)
            t_sh, t_one = _timed(fn, dev, dist), _timed(single, dev, dist)
            times = [None] * world
            dist.all_gather_object(times, (t_sh, t_one))
            t_sh, t_one = (max(t[i] for t in times) for i in (0, 1))
            say(f"{label}: {case}: {err:.3e} of max from the single-device "
                f"call; {t_sh:.4f} ms a call (slowest rank, median of "
                f"{LOOPS} x {REPS}) against the single-device call's "
                f"{t_one:.4f} ms")
        ref = vh.sum()
        for case, got in (("par sum", vp.sum()),
                          ("sharded_sum", complex(
                              bt.parallel.sharded_sum(x, mesh).cpu()))):
            err = abs(got - ref) / float(x.abs().double().sum())
            assert err <= TOL, (case, err)
            say(f"{label}: {case}: {err:.3e} of sum |x| from the plain sum")
        st, st1 = vp.statistics(), vh.statistics()
        assert (st.min_index, st.max_index, st.count) == (
            st1.min_index, st1.max_index, st1.count)
        say(f"{label}: par statistics: indices and count equal to the plain "
            f"vector's")
    dist.destroy_process_group()
    if rank == 0 and out_path:
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        with open(out_path, "w") as f:
            json.dump({"device": name, "ranks": world, "lines": lines}, f,
                      indent=1)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--shrink", type=int, default=64)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not args.cpu and torch.cuda.device_count() < args.ranks:
        raise SystemExit(f"mesh_check: {args.ranks} ranks need as many "
                         f"cards, {torch.cuda.device_count()} visible")
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    import tempfile

    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory(prefix="mesh_check_") as tmp:
        mp.start_processes(_rank, args=(
            args.ranks, port, args.cpu, args.shrink,
            args.out and os.path.abspath(args.out), tmp),
            nprocs=args.ranks, join=True, start_method="spawn")


if __name__ == "__main__":
    main()
