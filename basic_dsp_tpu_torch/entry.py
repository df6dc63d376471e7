"""Driver entry points of the port (counterpart of the repository's
``__graft_entry__.py``).

``entry()`` returns the flagship forward step, the FIR + windowed FFT
magnitude chain, with its inputs: on the card it launches the stage-1
kernel K8 and the row-FFT kernel K1 (its entry in spectrum order, K1n)
once each.

``dryrun_multichip(n)`` runs the whole sharded pipeline once on a mesh of
``n`` ranks, at the JAX dry run's shapes (per-shard length 256, 31 taps):
the sharded FIR with its halo exchange, the statistics, the
channel-parallel channelizer, the distributed four-step FFT, the
fractional resampler, ``StreamingFir`` over sharded chunks, the MIMO
convolution, and the same functions on a (2, n/2) (host, chip) mesh.
Torch runs one process a device, so it spawns ``n`` ranks (NCCL on the
card, gloo on the CPU).  Where the JAX dry run only runs, each rank here
also holds each step against the port's single-device function on the
same input and counts the kernels each step launched.

    python3 -m basic_dsp_tpu_torch.entry [n_devices] [--cpu] [--out F]

runs ``dryrun_multichip(n_devices)`` (1 by default) and prints its
record, without the outputs, as one JSON object (also written to ``F``).
"""
from __future__ import annotations

import json
import os
import pickle
import sys
import tempfile
import time

import numpy as np
import torch

from . import config

ENTRY_N, ENTRY_TAPS = 65536, 64
SHARD_LEN, DRYRUN_TAPS = 256, 31
DRYRUN_TOL = 1e-6     # each step against its single-device function, of
                      # the maximum


def entry(device=None):
    """``(fn, args)``: ``fn`` is ``pipelines.fir_fft_chain`` and ``args``
    its inputs, those of the JAX entry: numpy seed 0, 65536 complex64
    samples, 64 complex64 taps and a float32 Hamming window, on the card
    unless ``device`` names another.  ``fn(*args)`` is the (65536,)
    shifted magnitude spectrum; the four-step's stage 1 and row stage
    (128, 512) run K8 and K1 on the card."""
    from . import pipelines
    from .windows import HammingWindow

    dev = config.resolve_device(device)
    rng = np.random.default_rng(0)
    x = (rng.normal(size=ENTRY_N)
         + 1j * rng.normal(size=ENTRY_N)).astype(np.complex64)
    taps = (rng.normal(size=ENTRY_TAPS)
            + 1j * rng.normal(size=ENTRY_TAPS)).astype(np.complex64)
    window = HammingWindow().sample(ENTRY_N, dtype=torch.float32, device=dev)
    return pipelines.fir_fft_chain, (torch.from_numpy(x).to(dev),
                                     torch.from_numpy(taps).to(dev), window)


def dryrun_multichip(n_devices: int, device_type=None,
                     timeout: float = 600.0) -> dict:
    """Runs the sharded pipeline once on a mesh of ``n_devices`` ranks,
    each rank a spawned process: on ``n_devices`` cards over NCCL (the
    default; raises without CUDA or with fewer cards, since two NCCL ranks
    never share a card), or over gloo on the CPU with
    ``device_type="cpu"``.

    Every rank checks every step against the single-device function on
    the same input (within ``DRYRUN_TOL`` of the maximum) and raises if
    one disagrees; a failed or a timed-out rank raises here.  Returns rank
    0's record: ``steps`` maps each step (``"<mesh>: <function>"``) to its
    error and the kernel launches of the sharded call, and ``outputs``
    holds the gathered results of the sharded FIR, channelizer and
    resampler on the 1-D mesh."""
    kind = config._mesh_device_type(device_type)
    n_devices = int(n_devices)
    if n_devices < 1:
        raise ValueError(f"n_devices must be >= 1, got {n_devices}")
    if kind == "cuda" and n_devices > torch.cuda.device_count():
        raise RuntimeError(f"dryrun_multichip: {n_devices} NCCL ranks need "
                           f"as many cards, {torch.cuda.device_count()} "
                           f"visible")
    with tempfile.TemporaryDirectory(prefix="bdsp_dryrun_") as tmp:
        config.spawn_ranks(_dryrun_rank, (n_devices, config.free_port(),
                                          kind, tmp), n_devices, timeout)
        with open(os.path.join(tmp, "rank0.pkl"), "rb") as f:
            return pickle.load(f)


def _dryrun_rank(rank: int, world: int, port: int, kind: str,
                 out_dir: str) -> None:
    import torch.distributed as dist

    if kind == "cpu":
        torch.set_num_threads(1)
    os.environ["LOCAL_RANK"] = str(rank)   # one host: a card a rank
    config.distributed_init(f"localhost:{port}", world, rank, kind)
    try:
        record = _dryrun_steps(world, kind)
    finally:
        dist.destroy_process_group()
    if rank == 0:
        with open(os.path.join(out_dir, "rank0.pkl"), "wb") as f:
            pickle.dump(record, f)


def _rel(got: torch.Tensor, ref: torch.Tensor) -> float:
    return float((got - ref).abs().max() / ref.abs().max())


def _angle_rel(got: torch.Tensor, ref: torch.Tensor) -> float:
    """Angles' largest difference on the circle (a step of 2 pi is none),
    of the largest angle."""
    d = torch.remainder(got.double() - ref.double() + np.pi, 2 * np.pi)
    return float((d - np.pi).abs().max() / ref.abs().max())


def _dryrun_steps(world: int, kind: str) -> dict:
    """The JAX dry run's eight steps (``__graft_entry__.py``), each
    against its single-device function."""
    from . import kernels, matrix, streaming
    from .conv_types import SincFunction
    from .ops import conv_ops, interp_ops, stats_ops
    from .parallel import (channelizer, sharded, sharded_convolve_mat,
                           sharded_fft)

    dev = (torch.device("cuda", torch.cuda.current_device())
           if kind == "cuda" else torch.device("cpu"))
    n = SHARD_LEN * world
    rng = np.random.default_rng(0)
    x = torch.from_numpy((rng.normal(size=n) + 1j * rng.normal(size=n))
                         .astype(np.complex64)).to(dev)
    h = torch.from_numpy((rng.normal(size=DRYRUN_TAPS)
                          + 1j * rng.normal(size=DRYRUN_TAPS))
                         .astype(np.complex64)).to(dev)
    C = max(8, world)
    proto = torch.from_numpy((np.hamming(C * 8) / C).astype(np.float32))
    sinc = SincFunction()
    Cm = 2 * world
    xm = (torch.stack([x[: n // 2]] * Cm)
          * torch.arange(1.0, Cm + 1.0, device=dev)[:, None])
    imp = rng.normal(size=(Cm, Cm, 5)).astype(np.float32)

    steps, outputs = {}, {}

    def step(name, sharded_call, whole, single, err=_rel):
        kernels.reset_launch_counts()
        got = sharded_call()
        if kind == "cuda":
            torch.cuda.synchronize()
        launches = kernels.launch_counts()
        got = whole(got)
        e = err(got, single())
        if not e <= DRYRUN_TOL:
            raise AssertionError(f"dryrun_multichip, {name}: {e:.3e} of the "
                                 f"maximum from the single-device call "
                                 f"(tolerance {DRYRUN_TOL})")
        steps[name] = {"max_err": e, "launches": launches}
        return got

    def statistics(name, mesh, xs):
        kernels.reset_launch_counts()
        st = sharded.sharded_statistics(xs, mesh)
        launches = kernels.launch_counts()
        ref = stats_ops.statistics(x, True)
        scale = float(x.abs().double().sum())
        e = max(abs(complex(st.sum) - complex(ref.sum)) / scale,
                abs(complex(st.rms) - complex(ref.rms)) / abs(ref.rms))
        same = (st.count, st.min_index, st.max_index) == (
            ref.count, ref.min_index, ref.max_index)
        if not (e <= DRYRUN_TOL and same and st.count == n):
            raise AssertionError(f"dryrun_multichip, {name}: sum and rms "
                                 f"{e:.3e} from the single-device call, "
                                 f"count and indices {st} against {ref}")
        steps[name] = {"max_err": e, "launches": launches}

    full = lambda y: y.full_tensor()   # noqa: E731
    mesh = config.make_mesh(world, device_type=kind)
    label = f"mesh of {world}"
    xs = sharded.shard_time_axis(x, mesh)
    # 1) sequence-parallel FIR: time axis sharded, halo between neighbours
    outputs["sharded_convolve_signal"] = step(
        f"{label}: sharded_convolve_signal",
        lambda: sharded.sharded_convolve_signal(xs, h, mesh), full,
        lambda: conv_ops.convolve_signal(x, h, True))
    # 2) collective statistics
    statistics(f"{label}: sharded_statistics", mesh, xs)
    # 3) channel-parallel polyphase channelizer + FM demod
    outputs["sharded_channelize_and_demod"] = step(
        f"{label}: sharded_channelize_and_demod",
        lambda: channelizer.sharded_channelize_and_demod(x, proto, C, mesh),
        full, lambda: channelizer.channelize_and_demod(x, proto, C),
        _angle_rel)
    # 4) distributed four-step FFT
    step(f"{label}: sharded_fft", lambda: sharded_fft.sharded_fft(xs, mesh),
         full, lambda: torch.fft.fft(x))
    # 5) sequence-parallel fractional resampler, x1.5
    outputs["sharded_interpolatef"] = step(
        f"{label}: sharded_interpolatef",
        lambda: sharded.sharded_interpolatef(xs, sinc, 1.5, 0.0, 10, mesh),
        full, lambda: interp_ops.interpolatef(x, sinc, 1.5, 0.0, 10, 1.0))

    # 6) StreamingFir over two time-sharded chunks
    def stream(shard):
        fir = streaming.StreamingFir(h)
        state, outs = fir.init_state(), []
        for _ in range(2):
            chunk = sharded.shard_time_axis(x, mesh) if shard else x
            y, state = fir.process(chunk, state)
            outs.append(y)
        return outs

    step(f"{label}: StreamingFir, 2 sharded chunks", lambda: stream(True),
         lambda ys: torch.cat([y.full_tensor() for y in ys]),
         lambda: torch.cat(stream(False)))
    # 7) channel-parallel MIMO convolution
    step(f"{label}: sharded_convolve_mat",
         lambda: sharded_convolve_mat(xm, imp, mesh), full,
         lambda: matrix._convolve_mat(
             xm, torch.from_numpy(imp).to(dev), True))
    # 8) the (host, chip) mesh: the same functions on (2, n/2)
    if world >= 4 and world % 2 == 0:
        mesh2 = config.make_mesh(shape=(2, world // 2), device_type=kind)
        label = f"(2, {world // 2}) mesh"
        xs2 = sharded.shard_time_axis(x, mesh2)
        step(f"{label}: sharded_convolve_signal",
             lambda: sharded.sharded_convolve_signal(xs2, h, mesh2), full,
             lambda: conv_ops.convolve_signal(x, h, True))
        statistics(f"{label}: sharded_statistics", mesh2, xs2)
        step(f"{label}: sharded_fft",
             lambda: sharded_fft.sharded_fft(xs2, mesh2), full,
             lambda: torch.fft.fft(x))
        step(f"{label}: sharded_interpolatef",
             lambda: sharded.sharded_interpolatef(xs2, sinc, 1.5, 0.0, 10,
                                                  mesh2),
             full, lambda: interp_ops.interpolatef(x, sinc, 1.5, 0.0, 10,
                                                   1.0))
        step(f"{label}: sharded_channelize_and_demod",
             lambda: channelizer.sharded_channelize_and_demod(x, proto, C,
                                                              mesh2),
             full, lambda: channelizer.channelize_and_demod(x, proto, C),
             _angle_rel)
    return {"n_devices": world, "signal_len": n,
            "device": config.device_name(dev), "steps": steps,
            "outputs": {k: v.cpu().numpy() for k, v in outputs.items()}}


def main(argv=None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    out_path = None
    if "--out" in args:
        i = args.index("--out")
        out_path = args[i + 1]
        del args[i:i + 2]
    cpu = "--cpu" in args
    nums = [int(a) for a in args if a != "--cpu"]
    t0 = time.perf_counter()
    record = dryrun_multichip(nums[0] if nums else 1, "cpu" if cpu else None)
    record.pop("outputs")
    record["wall_s"] = time.perf_counter() - t0
    text = json.dumps(record)
    print(text)
    if out_path:
        with open(out_path, "w") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
