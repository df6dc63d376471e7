"""Scaling of the four sharded workloads over 1..N ranks (twin of the JAX
repository's ``bench_scaling.py``): the sharded convolution (63 complex
taps), the 64-channel sharded channelizer, the distributed four-step FFT
and the sharded x1.5 resampler, at a strong size of 2^20 complex samples
and a weak one of 2^17 a rank, on the reference's signals (numpy seed 0,
the taps seed 1).

Each point of d ranks is one process group of d spawned ranks
(``config.spawn_ranks``): over NCCL one card a rank, over gloo one thread
a rank (the twin of the reference's ``taskset`` pinning, so that the d = 1
point is a one-core baseline).  At each point every workload is timed
(the median over 3 attempts of the mean of ``iters`` calls, the signal
sharded once before), held against its single-device function on the
same signal, and its messages timed alone: the halo exchange of the
convolution's volumes (62 samples each way) or one all-to-all of the
FFT's volume, three times (the FFT does three).

The link projection replaces the reference's ICI one: per workload the
bytes a rank sends (the reference's models, :func:`comm_bytes`) over
NVLink 4 on the H100 SXM, 900 GB/s a card in both directions together,
450 each way, beside the measured message time; projected efficiency =
t_local / (t_local + t_link), t_local the d = 1 time over d.

    python3 -m basic_dsp_tpu_torch.bench.bench_scaling [--devices 1,2,4] [--out F] [--device cpu]

prints one JSON line a workload and writes the record to ``--out``.
Without a card it exits non-zero unless ``--device cpu`` asks for gloo
ranks on the CPU, at 2^12 strong and 2^11 a rank.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

from .. import config
from .timing import device_of

N_STRONG = 1 << 20
N_PER_DEV = 1 << 17
CPU_N, CPU_N_PER_DEV = 1 << 12, 1 << 11    # the CPU rehearsal's sizes
CHANNELS, PROTO_T = 64, 8
CONV_TAPS = 63
HALO = 62              # the convolution's m_eff - 1 samples, each way
LINK_GBPS = 450.0      # NVLink 4, H100 SXM: 900 GB/s a card, both ways
TOL = 1e-5             # a sharded call against its single-device function
WORKLOADS = ("sharded_conv", "channelizer", "sharded_fft",
             "sharded_interpolatef")
COMM_KIND = {"sharded_conv": "halo", "channelizer": "halo",
             "sharded_fft": "a2a", "sharded_interpolatef": "halo"}


def comm_bytes(name: str, n: int, d: int) -> float:
    """Bytes a rank sends one way in a call (the reference's models): the
    convolution's 62 complex samples, the channelizer's C x 8 look-back,
    the FFT's three all-to-alls of (d - 1) / d of its shard, and the
    resampler's L + (W - L) = 10 + 384 samples."""
    return {"sharded_conv": HALO * 8,
            "channelizer": CHANNELS * PROTO_T * 8,
            "sharded_fft": 3 * (n // d) * 8 * (d - 1) / d,
            "sharded_interpolatef": (10 + 384) * 8}[name]


def signal(n: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (rng.normal(size=n) + 1j * rng.normal(size=n)).astype(
        np.complex64)


def workloads(device) -> dict:
    """name -> (sharded(x, mesh), single(x)): the sharded call and the
    single-device function it must equal."""
    from ..conv_types import SincFunction
    from ..ops import conv_ops, interp_ops
    from ..parallel import (channelizer, sharded_convolve_signal,
                            sharded_fft, sharded_interpolatef)

    h = torch.from_numpy(signal(CONV_TAPS, seed=1)).to(device)
    proto = torch.from_numpy((np.hamming(CHANNELS * PROTO_T) / CHANNELS)
                             .astype(np.float32)).to(device)
    sinc = SincFunction()
    return {
        "sharded_conv": (
            lambda x, mesh: sharded_convolve_signal(x, h, mesh),
            lambda x: conv_ops.convolve_signal_fft(x, h, True)),
        "channelizer": (
            lambda x, mesh: channelizer.sharded_channelize_and_demod(
                x, proto, CHANNELS, mesh),
            lambda x: channelizer.channelize_and_demod(x, proto, CHANNELS)),
        "sharded_fft": (
            lambda x, mesh: sharded_fft.sharded_fft(x, mesh),
            lambda x: torch.fft.fft(x)),
        "sharded_interpolatef": (
            lambda x, mesh: sharded_interpolatef(x, sinc, 1.5, 0.0, 10,
                                                 mesh),
            lambda x: interp_ops.interpolatef(x, sinc, 1.5, 0.0, 10, 1.0)),
    }


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _timeit(fn, device, iters: int, attempts: int = 3) -> float:
    """Median over ``attempts`` of the mean seconds a call of ``iters``
    calls, after one warm call; the device synchronized at each end."""
    fn()
    meds = []
    for _ in range(attempts):
        _sync(device)
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        _sync(device)
        meds.append((time.perf_counter() - t0) / iters)
    return sorted(meds)[len(meds) // 2]


def _full(out):
    return out.full_tensor() if hasattr(out, "full_tensor") else out


def _rel(got, ref) -> float:
    if ref.dtype.is_floating_point and not got.is_complex():
        # angles: their difference on the circle
        d = torch.remainder(got.double() - ref.double() + np.pi, 2 * np.pi)
        return float((d - np.pi).abs().max() / ref.abs().max())
    return float((got - ref).abs().max() / ref.abs().max())


def _point(mesh, device, n: int, n_per_dev: int, iters: int) -> dict:
    """One rank's measurements at its mesh's size."""
    from ..parallel import collectives, shard_time_axis

    d = collectives.mesh_size(mesh, collectives.mesh_axes(mesh))
    axes = collectives.mesh_axes(mesh)
    out = {"devices": d, "workloads": {}}
    x = torch.from_numpy(signal(n)).to(device)
    xs = shard_time_axis(x, mesh)
    xw = shard_time_axis(torch.from_numpy(signal(n_per_dev * d)).to(device),
                         mesh)
    ln = n // d
    for name, (run, single) in workloads(device).items():
        err = _rel(_full(run(xs, mesh)), single(x))
        dt = _timeit(lambda: run(xs, mesh), device, iters)
        if d == 1:
            dt_comm = 0.0
        elif COMM_KIND[name] == "halo":
            local = xs.to_local()

            def halo():
                with collectives.on_mesh(mesh):
                    lh = collectives.shift_from_left(local[-HALO:], axes)
                    rh = collectives.shift_from_right(local[:HALO], axes)
                return torch.cat([lh, local[2 * HALO:], rh])
            dt_comm = _timeit(halo, device, iters)
        else:
            x2 = torch.zeros((1, ln), dtype=torch.complex64, device=device)

            def a2a():
                with collectives.on_mesh(mesh):
                    return collectives.all_to_all(x2, axes)
            dt_comm = 3 * _timeit(a2a, device, iters)
        dt_w = _timeit(lambda: run(xw, mesh), device, iters)
        out["workloads"][name] = {
            "strong_ms": dt * 1e3, "comm_ms": dt_comm * 1e3,
            "strong_msps": n / dt / 1e6, "weak_n": n_per_dev * d,
            "weak_ms": dt_w * 1e3, "err": err}
    return out


def _point_rank(rank: int, d: int, port: int, kind: str, n: int,
                n_per_dev: int, iters: int, out_dir: str) -> None:
    import torch.distributed as dist

    if kind == "cpu":
        torch.set_num_threads(1)     # one core a rank
    os.environ["LOCAL_RANK"] = str(rank)
    config.distributed_init(f"localhost:{port}", d, rank, kind)
    try:
        mesh = config.make_mesh(d, device_type=kind)
        device = (torch.device("cuda", torch.cuda.current_device())
                  if kind == "cuda" else torch.device("cpu"))
        record = _point(mesh, device, n, n_per_dev, iters)
        record["card"] = config.device_name(device)
    finally:
        dist.destroy_process_group()
    if rank == 0:
        with open(os.path.join(out_dir, "point.json"), "w") as f:
            json.dump(record, f)


def point(d: int, kind: str, n: int = N_STRONG, n_per_dev: int = N_PER_DEV,
          iters: int = 5, timeout: float = 600.0) -> dict:
    """Rank 0's record of one point on ``d`` spawned ranks."""
    with tempfile.TemporaryDirectory(prefix="bdsp_scaling_") as tmp:
        config.spawn_ranks(_point_rank, (d, config.free_port(), kind, n,
                                         n_per_dev, iters, tmp), d, timeout)
        with open(os.path.join(tmp, "point.json")) as f:
            return json.load(f)


def sweep(sizes, kind: str, n: int = N_STRONG, n_per_dev: int = N_PER_DEV,
          iters: int = 5) -> dict:
    """The record of a point at each mesh size of ``sizes`` (the first the
    baseline): each workload's strong and weak times, efficiencies, errors
    and link projection."""
    points = [point(d, kind, n, n_per_dev, iters) for d in sizes]
    for p in points:
        for name, w in p["workloads"].items():
            if not w["err"] <= TOL:
                raise RuntimeError(f"bench_scaling: {name} on {p['devices']}"
                                   f" ranks is {w['err']:.3e} from its "
                                   f"single-device function (tol {TOL})")
    record = {"mode": f"{kind}: one {'card' if kind == 'cuda' else 'thread'}"
                      " a rank, a process group a point",
              "card": points[0]["card"], "n_strong": n,
              "n_per_device": n_per_dev,
              "link_gbps_model": LINK_GBPS if kind == "cuda" else None,
              "points": points, "workloads": {}}
    for name in WORKLOADS:
        base = points[0]["workloads"][name]
        entry = {"strong": [], "weak": [], "strong_efficiency": {},
                 "weak_efficiency": {}, "link_projection": []}
        for p in points:
            w, d = p["workloads"][name], p["devices"]
            entry["strong"].append({"devices": d, "ms": w["strong_ms"],
                                    "comm_ms": w["comm_ms"],
                                    "msamples_per_s": w["strong_msps"],
                                    "err": w["err"]})
            entry["weak"].append({"devices": d, "n": w["weak_n"],
                                  "ms": w["weak_ms"]})
            if d == 1:
                continue
            entry["strong_efficiency"][str(d)] = (
                w["strong_msps"] / (d * base["strong_msps"]))
            entry["weak_efficiency"][str(d)] = base["weak_ms"] / w["weak_ms"]
            if kind == "cuda":     # the link of the cards, not of gloo
                t_local = base["strong_ms"] * points[0]["devices"] / d
                t_link = comm_bytes(name, n, d) / (LINK_GBPS * 1e9) * 1e3
                entry["link_projection"].append({
                    "devices": d, "bytes_per_device": comm_bytes(name, n, d),
                    "link_ms": t_link, "measured_comm_ms": w["comm_ms"],
                    "projected_efficiency": t_local / (t_local + t_link)})
        record["workloads"][name] = entry
    return record


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        prog="python3 -m basic_dsp_tpu_torch.bench.bench_scaling",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--devices", default=None,
                    help="mesh sizes, comma-separated (default: 1, 2, 4, 8 "
                         "up to the cards, or the cores)")
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default=None,
                    help="cpu for gloo ranks on the CPU (default: the cards)")
    args = ap.parse_args(argv)
    kind = device_of(args.device, "bench_scaling").type
    most = (torch.cuda.device_count() if kind == "cuda"
            else os.cpu_count() or 1)
    sizes = ([int(s) for s in args.devices.split(",")] if args.devices
             else [d for d in (1, 2, 4, 8) if d <= most])
    if max(sizes) > most:
        raise SystemExit(f"bench_scaling: {max(sizes)} ranks need as many "
                         f"{'cards' if kind == 'cuda' else 'cores'}, "
                         f"{most} here")
    record = sweep(sizes, kind, *((N_STRONG, N_PER_DEV) if kind == "cuda"
                                  else (CPU_N, CPU_N_PER_DEV)), args.iters)
    for name, entry in record["workloads"].items():
        top = entry["strong"][-1]
        line = {"metric": f"{name}_strong_eff", "device": kind,
                "devices": top["devices"],
                "value": entry["strong_efficiency"].get(
                    str(top["devices"]), 1.0), "unit": "ratio",
                "err": max(p["err"] for p in entry["strong"])}
        if entry["link_projection"]:
            line["projected"] = entry["link_projection"][-1][
                "projected_efficiency"]
        print(json.dumps(line), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)
        print(f"# wrote {args.out}", file=sys.stderr, flush=True)
    return record


if __name__ == "__main__":
    main()
