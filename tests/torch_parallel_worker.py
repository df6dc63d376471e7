"""Ranks of the sharded-function tests of the PyTorch port
(tests/test_torch_parallel.py): one process a rank, gloo on the CPU.

``run(shape, tmp_dir)`` spawns the ranks of one mesh shape (2, 4 or (2,
2)) once; each rank runs every case of :func:`_cases` on the same numpy
inputs (:func:`inputs`) and writes its results, which ``run`` gathers.  A
signal-valued case returns the rank's local shard; the test assembles the
shards in the mesh's flat order.  This module imports no JAX: the spawned
ranks import only the port.
"""
import os
import pickle
import time

import numpy as np
import torch

N = 4096          # signal length of the convolution, sum and stats cases
CHAN_C, CHAN_T, CHAN_S = 16, 2, 64
CONV_TAPS = (63, 257)   # the Toeplitz region (<= 202) and K3 (> 202)
FFT_N, FFT_REAL_N = 1 << 14, 1 << 12
MIMO_C, MIMO_N, MIMO_TAPS = 16, 1024, 9
STREAM_TAPS = 33


def stream_chunks(d: int):
    """The streaming cases' chunk lengths over N samples: chunks of 1024
    (the JAX test's), and one of 16 samples a rank, shorter than m - 1."""
    return [1024, 1024, 16 * d, 1024, 1024 - 16 * d]


def world_of(shape) -> int:
    return int(np.prod(shape)) if isinstance(shape, tuple) else int(shape)


def _c(rng, n, dtype=np.complex64):
    return (rng.normal(size=n) + 1j * rng.normal(size=n)).astype(dtype)


def inputs(d: int) -> dict:
    """The cases' inputs, from numpy seeds (``d``: the mesh size, which
    sizes the shard-geometry error cases)."""
    rng = np.random.default_rng(0)
    x = {
        "x_c": _c(rng, N), "x_r": rng.normal(size=N).astype(np.float32),
        "h_short_c": _c(rng, CONV_TAPS[0]),
        "h_short_r": rng.normal(size=CONV_TAPS[0]).astype(np.float32),
        "h_long_c": _c(rng, CONV_TAPS[1]),
        "h_long_r": rng.normal(size=CONV_TAPS[1]).astype(np.float32),
        "interp_c": _c(rng, 1024 * d),
        "interp_r": rng.normal(size=256 * d).astype(np.float32),
        "chan_x": _c(rng, CHAN_C * CHAN_S),
        "chan_proto": (np.hamming(CHAN_C * (CHAN_T + 1))[:CHAN_C * CHAN_T]
                       / CHAN_C).astype(np.float32),
        "ramp": np.arange(8.0 * d, dtype=np.float32),
        "fft_c128": _c(rng, FFT_N, np.complex128),
        "fft_r": rng.normal(size=FFT_REAL_N).astype(np.float32),
        "mimo_c": _c(rng, MIMO_C * MIMO_N).reshape(MIMO_C, MIMO_N),
        "mimo_imp_c": _c(rng, MIMO_C * MIMO_C * MIMO_TAPS).reshape(
            MIMO_C, MIMO_C, MIMO_TAPS),
        "mimo_r": rng.normal(size=(MIMO_C, MIMO_N)).astype(np.float32),
        "mimo_imp_r": rng.normal(size=(MIMO_C, MIMO_C, MIMO_TAPS)).astype(
            np.float32),
        "stream_taps": _c(rng, STREAM_TAPS),
    }
    x["fft_c64"] = x["fft_c128"].astype(np.complex64)
    x["x_c"][1234] = 9.0 + 9.0j        # one extremum far from rank 0
    x["x_r"][N - 5] = -7.5
    x["x_r"][17] = 7.5
    return x


# sharded_interpolatef's geometry errors at x1.5, kind -> (signal length
# by mesh size d, conv_len): a length no mesh size divides; shards of 128
# samples, shorter than the 401-sample window at conv_len 200; shards of
# 128 samples, which 128*Q = 256 does not divide.
ERROR_CASES = {"divisible": (lambda d: 4097, 10),
               "window": (lambda d: 128 * d, 200),
               "span": (lambda d: 128 * d, 10)}


def _local(t):
    return t.to_local().numpy().copy()


def _cases():
    import basic_dsp_tpu_torch as bt
    from basic_dsp_tpu_torch.parallel import collectives, sharded

    def shifts(mesh, x):
        axes = collectives.mesh_axes(mesh)
        with collectives.on_mesh(mesh):
            i = collectives.flat_index(axes)
            ramp = torch.from_numpy(x["ramp"][8 * i:8 * (i + 1)])
            return {
                "flat_index": i, "flat_size": collectives.flat_size(axes),
                **{f"{fn.__name__}_{wrap}": fn(ramp, axes, wrap=wrap).numpy()
                   for fn in (collectives.shift_from_left,
                              collectives.shift_from_right)
                   for wrap in (True, False)}}

    def shard(mesh, x):
        dt = sharded.shard_time_axis(torch.from_numpy(x["x_c"]), mesh)
        return {"local": _local(dt), "full": dt.full_tensor().numpy(),
                "placements": [str(p) for p in dt.placements]}

    def conv(taps_key, sig_key):
        def case(mesh, x):
            out = sharded.sharded_convolve_signal(
                torch.from_numpy(x[sig_key]), torch.from_numpy(x[taps_key]),
                mesh)
            return _local(out)
        return case

    def conv_dtensor(mesh, x):
        """A DTensor input (sharded first) gives the same shards."""
        dt = sharded.shard_time_axis(torch.from_numpy(x["x_c"]), mesh)
        return _local(sharded.sharded_convolve_signal(
            dt, torch.from_numpy(x["h_long_c"]), mesh))

    def interp(key, factor):
        def case(mesh, x):
            return _local(sharded.sharded_interpolatef(
                torch.from_numpy(x[key]), bt.SincFunction(), factor, 0.25,
                10, mesh))
        return case

    def interp_error(kind):
        n_of_d, conv_len = ERROR_CASES[kind]

        def case(mesh, x):
            d = collectives.mesh_size(mesh, collectives.mesh_axes(mesh))
            try:
                sharded.sharded_interpolatef(
                    torch.zeros(n_of_d(d), dtype=torch.complex64),
                    bt.SincFunction(), 1.5, 0.0, conv_len, mesh)
            except ValueError as e:
                return str(e)
            return None
        return case

    def ssum(key):
        def case(mesh, x):
            return sharded.sharded_sum(torch.from_numpy(x[key]),
                                       mesh).numpy()
        return case

    def stats(key):
        def case(mesh, x):
            s = sharded.sharded_statistics(torch.from_numpy(x[key]), mesh)
            return dict(vars(s))
        return case

    def chan(mesh, x):
        return _local(bt.sharded_channelize_and_demod(
            torch.from_numpy(x["chan_x"]), torch.from_numpy(x["chan_proto"]),
            CHAN_C, mesh))

    def chan_spans(mesh, x):
        # the call's span tree under a profiler: (name, call, index,
        # parent, stream ms) of each record, in the order they opened
        from torch.profiler import ProfilerActivity, profile
        from basic_dsp_tpu_torch import profiling
        profiling.reset_spans()
        with profile(activities=[ProfilerActivity.CPU]):
            bt.sharded_channelize_and_demod(
                torch.from_numpy(x["chan_x"]),
                torch.from_numpy(x["chan_proto"]), CHAN_C, mesh)
        return [(r["name"], r["call"], r["index"], r["parent"],
                 r["stream_ms"]) for r in profiling.spans()]

    def fft(key, natural_order=True):
        def case(mesh, x):
            out = bt.parallel.sharded_fft.sharded_fft(
                torch.from_numpy(x[key]), mesh, natural_order=natural_order)
            return {"local": _local(out), "shape": tuple(out.shape),
                    "placements": [str(p) for p in out.placements]}
        return case

    def fft_planar(mesh, x):
        re, im = (sharded.shard_time_axis(torch.from_numpy(p.copy()), mesh)
                  for p in (x["fft_c64"].real, x["fft_c64"].imag))
        gr, gi = bt.parallel.sharded_fft.sharded_fft_planar(re, im, mesh)
        return _local(gr) + 1j * _local(gi)

    def fft_error(mesh, x):
        d = collectives.mesh_size(mesh, collectives.mesh_axes(mesh))
        try:
            bt.parallel.sharded_fft.sharded_fft(
                torch.zeros(1023 * d, dtype=torch.complex64), mesh)
        except ValueError as e:
            return str(e)
        return None

    def mimo(kind):
        def case(mesh, x):
            out = bt.parallel.sharded_convolve_mat(
                torch.from_numpy(x[f"mimo_{kind}"]), x[f"mimo_imp_{kind}"],
                mesh)
            return {"local": _local(out),
                    "placements": [str(p) for p in out.placements]}
        return case

    def mimo_error(mesh, x):
        d = collectives.mesh_size(mesh, collectives.mesh_axes(mesh))
        try:
            bt.parallel.sharded_convolve_mat(
                torch.zeros((d + 1, 256)), np.zeros((d + 1, d + 1, 5),
                                                    np.float32), mesh)
        except ValueError as e:
            return str(e)
        return None

    def par(mesh, x):
        """The par vector's methods, one of each route: a sharded result
        as its local shard, every other one whole."""
        from torch.distributed.tensor import DTensor
        v = bt.to_complex_time_vec_par(x["x_c"], mesh)
        vr = bt.to_real_time_vec_par(x["x_r"], mesh)
        out = {"points": v.points(), "sum": v.sum(), "sum_r": vr.sum(),
               "statistics": dict(vars(v.statistics()))}

        def keep(name, w):
            """(data, sharded, its plain flavor's name); a sharded result is
            of the par flavor, a subclass of the plain one."""
            data, sharded_ = w.array, isinstance(w.array, DTensor)
            assert sharded_ is hasattr(type(w), "_PLAIN"), type(w)
            out[name] = (_local(data) if sharded_ else data.numpy().copy(),
                         sharded_,
                         (w._PLAIN if sharded_ else type(w)).__name__)
        keep("array", v)
        keep("scale", v.scale(2.0 - 1.0j))
        keep("magnitude", v.magnitude())
        keep("add", v.add(bt.to_complex_time_vec_par(x["x_c"][::-1].copy(),
                                                     mesh)))
        keep("abs_r", vr.abs())
        for m, key in zip(CONV_TAPS, ("h_short_c", "h_long_c")):
            keep(f"conv_{m}", v.convolve_signal(
                bt.to_complex_time_vec(x[key], device="cpu")))
        keep("interp", bt.to_complex_time_vec_par(x["interp_c"], mesh)
             .interpolatef(bt.SincFunction(), 1.5, 0.25, 10))
        keep("plain_fft", v.plain_fft())
        keep("plain_fft_r", vr.plain_fft())
        keep("reverse", v.reverse())
        out["to_numpy"] = v.to_numpy()
        return out

    def stream(mesh, x):
        from basic_dsp_tpu_torch import streaming
        fir = streaming.StreamingFir(torch.from_numpy(x["stream_taps"]))
        st = fir.init_state()
        outs, tails, kinds = [], [], []
        i = 0
        d = collectives.mesh_size(mesh, collectives.mesh_axes(mesh))
        for c in stream_chunks(d):
            dt = sharded.shard_time_axis(
                torch.from_numpy(x["x_c"][i:i + c]), mesh)
            y, st = fir.process(dt, st)
            outs.append(_local(y))
            kinds.append([str(p) for p in y.placements])
            tails.append(st.tail.numpy().copy())
            i += c
        return {"outs": outs, "tails": tails, "placements": kinds}

    cases = {"shifts": shifts, "shard": shard, "conv_dtensor": conv_dtensor,
             "fft_c128": fft("fft_c128"), "fft_c64": fft("fft_c64"),
             "fft_r": fft("fft_r"),
             "fft_c128_rows": fft("fft_c128", natural_order=False),
             "fft_planar": fft_planar, "fft_error": fft_error,
             "mimo_c": mimo("c"), "mimo_r": mimo("r"),
             "mimo_error": mimo_error, "par": par, "stream": stream,
             "interp_c_1.5": interp("interp_c", 1.5),
             "interp_r_2.0": interp("interp_r", 2.0),
             **{f"interp_err_{kind}": interp_error(kind)
                for kind in ERROR_CASES},
             "sum_c": ssum("x_c"), "sum_r": ssum("x_r"),
             "stats_c": stats("x_c"), "stats_r": stats("x_r"),
             "chan": chan, "chan_spans": chan_spans}
    for length in ("short", "long"):
        cases[f"conv_{length}_c"] = conv(f"h_{length}_c", "x_c")
        cases[f"conv_{length}_r"] = conv(f"h_{length}_r", "x_r")
    return cases


def _rank_main(rank, shape, init_file, out_dir):
    import torch.distributed as dist

    import basic_dsp_tpu_torch as bt

    torch.set_num_threads(1)
    world = world_of(shape)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    try:
        mesh = (bt.make_mesh(shape=shape, device_type="cpu")
                if isinstance(shape, tuple)
                else bt.make_mesh(shape, device_type="cpu"))
        x = inputs(world)
        results = {name: fn(mesh, x) for name, fn in _cases().items()}
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(results, f)


def run(shape, tmp_dir, timeout: float = 120.0):
    """Spawns the ranks of ``shape`` once; returns their results, a list
    indexed by rank (rank r is flat position r of the mesh)."""
    import torch.multiprocessing as mp

    world = world_of(shape)
    ctx = mp.start_processes(
        _rank_main, args=(shape, os.path.join(tmp_dir, "init"), tmp_dir),
        nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"mesh {shape}: ranks still running after "
                               f"{timeout} s")
    out = []
    for r in range(world):
        with open(os.path.join(tmp_dir, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out
