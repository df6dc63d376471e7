"""One host of the multi-host harness (counterpart of the repository's
``multiproc_worker.py``), started by ``multihost.run``:

    python3 -m basic_dsp_tpu_torch.multihost_worker HOST HOSTS PORT LOCAL N
                                                    TAPS KIND

A JAX worker process owns its local devices; here a host is a group of
``LOCAL`` ranks, one process a device, which this process spawns with
torchrun's environment (``RANK = HOST * LOCAL + d``, ``LOCAL_RANK = d``,
``WORLD_SIZE``, the store at ``localhost:PORT``).  The ranks of every host
build the (host, chip) mesh ``make_mesh(shape=(HOSTS, LOCAL))``, whose
outer axis crosses the process boundary between hosts.

Each rank builds the same input from numpy seed 0 (``N`` complex64
samples, ``TAPS`` complex64 taps) and computes the single-device oracles
itself; the five sharded functions are checked against them at the JAX
harness's tolerances, with the kernels each sharded call launched.  Then
the sharded FIR is timed on the whole mesh against the host's own mesh of
``LOCAL`` ranks (the chip axis), on the same signal: CUDA events after a
barrier on the card, the host clock on gloo; the slowest rank's time a
call.  Rank 0 prints ``MULTIHOST_RESULT {json}``.
"""
from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
import torch

from . import config
from .multihost import RESULT

ITERS = 20


def main(argv=None) -> None:
    h, nhosts, port, local, n, taps = (int(a) for a in (argv or
                                                         sys.argv[1:])[:6])
    kind = (argv or sys.argv[1:])[6]
    config.spawn_ranks(_rank, (h, nhosts, port, local, n, taps, kind),
                       local, timeout=3600.0)


def _rank(d: int, h: int, nhosts: int, port: int, local: int, n: int,
          taps: int, kind: str) -> None:
    import torch.distributed as dist

    rank = h * local + d
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(d),
                      WORLD_SIZE=str(nhosts * local), MASTER_ADDR="localhost",
                      MASTER_PORT=str(port))
    if kind == "cpu":
        torch.set_num_threads(1)
    config.distributed_init(device_type=kind)
    try:
        result = _checks(rank, nhosts, local, n, taps, kind)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    if rank == 0:
        print(RESULT + json.dumps(result), flush=True)


def _fired() -> dict:
    """The kernels launched since the counts were set to 0."""
    from . import kernels
    return {k: v for k, v in kernels.launch_counts().items() if v}


def _checks(rank, nhosts, local, n, taps, kind) -> dict:
    import torch.distributed as dist

    from . import kernels
    from .conv_types import SincFunction
    from .ops import conv_ops, interp_ops, stats_ops
    from .parallel import channelizer, sharded, sharded_fft

    dev = (torch.device("cuda", torch.cuda.current_device())
           if kind == "cuda" else torch.device("cpu"))
    mesh = config.make_mesh(shape=(nhosts, local), device_type=kind)
    rng = np.random.default_rng(0)   # the same input on every rank
    x_np = (rng.normal(size=n) + 1j * rng.normal(size=n)).astype(np.complex64)
    x = torch.from_numpy(x_np).to(dev)
    h = torch.from_numpy((rng.normal(size=taps) + 1j * rng.normal(size=taps))
                         .astype(np.complex64)).to(dev)
    xs = sharded.shard_time_axis(x, mesh)

    def sharded_call(fn):
        kernels.reset_launch_counts()
        out = fn()
        if kind == "cuda":
            torch.cuda.synchronize()
        return out, _fired()

    checks = {}
    # 1) sequence-parallel FIR with the halo crossing hosts
    out, fired = sharded_call(
        lambda: sharded.sharded_convolve_signal(xs, h, mesh))
    ref = conv_ops.convolve_signal_fft(x, h, True)
    err = float((out.full_tensor() - ref).abs().max())
    scale = float(ref.abs().max())
    checks["sharded_convolve_signal"] = {
        "max_abs_err": err, "ok": err < 1e-4 * max(scale, 1),
        "launches": fired}
    # 2) statistics, the partials gathered across hosts
    st, fired = sharded_call(lambda: sharded.sharded_statistics(xs, mesh))
    oracle = stats_ops.statistics(x, True)
    checks["sharded_statistics"] = {
        "ok": bool(st.count == oracle.count
                   and abs(complex(st.sum) - complex(oracle.sum))
                   < 1e-3 * max(abs(complex(oracle.sum)), 1)
                   and abs(complex(st.rms) - complex(oracle.rms))
                   < 1e-4 * abs(complex(oracle.rms))),
        "launches": fired}
    # 3) distributed four-step FFT: the all-to-alls cross hosts
    spec, fired = sharded_call(lambda: sharded_fft.sharded_fft(xs, mesh))
    want = np.fft.fft(x_np)
    errf = float(np.max(np.abs(spec.full_tensor().cpu().numpy() - want)))
    checks["sharded_fft"] = {
        "max_abs_err": errf, "ok": errf < 1e-2 * float(np.max(np.abs(want))),
        "launches": fired}
    # 4) sequence-parallel fractional resampler, x1.5
    sinc = SincFunction()
    res, fired = sharded_call(lambda: sharded.sharded_interpolatef(
        xs, sinc, 1.5, 0.0, 10, mesh))
    refr = interp_ops.interpolatef(x, sinc, 1.5, 0.0, 10, 1.0)
    erri = float((res.full_tensor() - refr).abs().max())
    checks["sharded_interpolatef"] = {
        "max_abs_err": erri, "ok": erri < 1e-3 * float(refr.abs().max()),
        "launches": fired}
    # 5) channelizer + FM demod over 8 channels; angles compared on the
    # circle (a step of 2 pi is no difference)
    C = 8
    proto = torch.from_numpy((np.hamming(C * 8) / C).astype(np.float32))
    dem, fired = sharded_call(lambda: channelizer.sharded_channelize_and_demod(
        x, proto, C, mesh))
    demr = channelizer.channelize_and_demod(x, proto, C)
    dang = torch.remainder(dem.full_tensor().double() - demr.double()
                           + np.pi, 2 * np.pi) - np.pi
    errc = float(dang.abs().max())
    checks["sharded_channelizer"] = {"max_abs_err": errc, "ok": errc < 1e-3,
                                     "launches": fired}

    # 6) the sharded FIR timed on the whole mesh and on this host's own
    # mesh (its chip axis), on the same signal
    local_mesh = mesh["chip"]
    xl = sharded.shard_time_axis(x, local_mesh)
    mesh_ms = _slowest(_timed(
        lambda: sharded.sharded_convolve_signal(xs, h, mesh), kind))
    local_ms = _slowest(_timed(
        lambda: sharded.sharded_convolve_signal(xl, h, local_mesh), kind))
    indices = [None] * dist.get_world_size()
    dist.all_gather_object(indices, (config.local_device_index(rank),
                                     os.environ.get("CUDA_VISIBLE_DEVICES")))
    return {
        "ok": all(c["ok"] for c in checks.values()),
        "n_processes": nhosts,
        "local_devices_per_process": local,
        "global_devices": dist.get_world_size(),
        "signal_len": n,
        "taps": taps,
        "checks": checks,
        "timing": {
            "sharded_fir_mesh_ms": mesh_ms,
            "sharded_fir_local_mesh_ms": local_ms,
            "note": f"the sharded FIR ({taps} taps), ms a call of the "
                    f"slowest rank over {ITERS} calls after a barrier: on "
                    f"the ({nhosts}, {local}) mesh, and on each host's own "
                    f"mesh of {local} ranks with the same signal"
                    + (" (CUDA events)" if kind == "cuda" else
                       " (host clock; gloo ranks share the host's cores)"),
        },
        "local_device_indices": [i for i, _ in indices],
        "visible_cards": [c for _, c in indices],
        "device": config.device_name(dev),
    }


def _timed(fn, kind: str) -> float:
    """ms a call over ``ITERS`` calls after two warm-up calls and a
    barrier."""
    import torch.distributed as dist

    fn()
    fn()
    if kind == "cuda":
        torch.cuda.synchronize()
    dist.barrier()
    if kind == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(ITERS):
            fn()
        stop.record()
        stop.synchronize()
        return start.elapsed_time(stop) / ITERS
    t0 = time.perf_counter()
    for _ in range(ITERS):
        fn()
    return (time.perf_counter() - t0) * 1e3 / ITERS


def _slowest(ms: float) -> float:
    import torch.distributed as dist

    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, ms)
    return max(every)


if __name__ == "__main__":
    main()
