"""The benchmark over the five BASELINE.md configs, one JSON line each
(twin of the JAX repository's ``bench_all.py``):

1. ``windowed_fft_magnitude_1m``: a 2^20-sample real sine, Hamming window,
   shifted FFT magnitude (``pipelines._shifted_mag``, K1 through
   ``spectrum_cuda.dif_spectrum_mag_cuda``);
2. ``rc_fir_4m``: ``conv_ops.convolve_signal_planar`` of 2^22 complex
   samples with 128 complex64 raised-cosine taps (the Toeplitz path; no
   kernel);
3. ``interpolatef_1_5x_1m``: ``interp_ops.interpolatef`` x1.5 (Sinc,
   conv_len 10) of the two planes of 2^20 complex samples (K4);
4. ``modulation_chain_131k_symbols``: ``ModulationChainPlanar(0.35, 10.0,
   0.0, 10)`` on 2^17 +-0.5 symbols a plane (K4 at x10);
5. ``channelizer_1024ch_4m``: ``ChannelizeAndDemodPlanar`` of 2^22 complex
   samples into 1024 channels, prototype ``hamming(8192) / 1024`` (K6).

The names, sizes and numpy seed are the reference's; its draws come in its
order from one ``default_rng(0)``.  With ``BDSP_BENCH_AB=1`` two more
records time the 384-tap overlap-save of 2^22 complex samples (fft_len
4096) through K3 against the library path, the batched
``ifft(fft(blocks) * H)`` of ``conv_ops.overlap_save``.

Each body is timed with its carry folded in (``timing.timed``): by CUDA-
graph replay where its loop captures ("timing": "graph"), else as an eager
loop between CUDA events ("eager", with the capture's error); bodies that
copy constants from the host at every call (the Toeplitz bands of config
2, the polyphase taps of config 3) do not capture.  Each record carries
the reference's keys, the floor (``floors.floor_ms``, counted on the work:
see ``configs``), the kernels one eager call launched, and the idle share
of the eager loop, ``1 - graph_ms / eager_ms`` from CUDA events (a lower
bound: the replay's gaps between kernels count as busy), null where the
loop does not capture.  ``max_vs_floor`` is
1.0 for every config: no capture may read above its floor, and the merge
refuses one that does.  The dispatch knobs are pinned (``KNOBS``).

    python3 -m basic_dsp_tpu_torch.bench.bench_all [--json F] [--merge F] [--device cpu]

``--json`` writes the session, ``--merge`` merges it into an artifact of
captures (:func:`merge_captures`).  Without a card it exits non-zero
unless ``--device cpu`` asks for a rehearsal at sizes / 256, whose records
carry ``"device": "cpu"`` and no throughput.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
import time

import numpy as np
import torch

from dspbench import floors

from .. import config, pipelines
from ..conv_types import RaisedCosineFunction, SincFunction
from ..kernels import overlap_save_cuda
from ..ops import conv_ops, interp_ops
from ..parallel.channelizer import ChannelizeAndDemodPlanar
from ..windows import HammingWindow
from . import timing
from .bench import KNOBS

SIZES = {"cfg1": 1 << 20, "cfg2": 1 << 22, "cfg3": 1 << 20, "cfg4": 1 << 17,
         "cfg5": 1 << 22}
CPU_SHIFT = 8          # the CPU rehearsal runs every size / 2^8
CPU_ITERS = 2
CHANNELS = 1024
PROTO_TAPS = 8         # prototype taps a channel
RC_TAPS = 128
OS_TAPS, OS_FFT_LEN = 384, 4096
MAX_VS_FLOOR = 1.0
SESSION_KEYS = ("device", "card", "hbm_gbps", "fp32_tflops", "numeric_mode")


def inputs(shift: int = 0, seed: int = 0) -> dict:
    """The configs' numpy inputs at the reference's sizes / 2^shift, drawn
    from one ``default_rng(seed)`` in the reference's order."""
    n = {k: v >> shift for k, v in SIZES.items()}
    rng = np.random.default_rng(seed)
    inp = {"sine": np.sin(2 * np.pi * 0.01 * np.arange(n["cfg1"]))
           .astype(np.float32)}
    inp["x_re"] = rng.normal(size=n["cfg2"]).astype(np.float32)
    inp["x_im"] = rng.normal(size=n["cfg2"]).astype(np.float32)
    t = ((np.arange(RC_TAPS) - RC_TAPS // 2) * 0.25).astype(np.float32)
    inp["rc_taps"] = RaisedCosineFunction(0.35).calc(
        torch.from_numpy(t)).numpy().astype(np.complex64)
    inp["a_re"] = rng.normal(size=n["cfg3"]).astype(np.float32)
    inp["a_im"] = rng.normal(size=n["cfg3"]).astype(np.float32)
    inp["s_re"] = rng.choice([-0.5, 0.5], n["cfg4"]).astype(np.float32)
    inp["s_im"] = rng.choice([-0.5, 0.5], n["cfg4"]).astype(np.float32)
    inp["c_re"] = rng.normal(size=n["cfg5"]).astype(np.float32)
    inp["c_im"] = rng.normal(size=n["cfg5"]).astype(np.float32)
    inp["proto"] = (np.hamming(CHANNELS * PROTO_TAPS) / CHANNELS) \
        .astype(np.float32)
    inp["h_long"] = rng.normal(size=OS_TAPS).astype(np.float32)
    return inp


@dataclasses.dataclass
class Config:
    """One timed body ``body(*args, carry)``: ``samples`` count its
    throughput (the reference's), ``nbytes`` and ``flops`` its floor,
    ``kernels`` the kernels it launches on the card."""
    metric: str
    body: object
    args: tuple
    iters: int
    samples: int
    nbytes: float
    flops: float
    note: str
    kernels: tuple
    io_bytes: float = None    # the bytes read and written, without the carry


def configs(inp: dict, device, ab: bool = False) -> list:
    """The five configs (and with ``ab`` the overlap-save A/B) on
    ``device``.  Floors count the work, not the formulation: inputs read
    once, outputs and the carry written once, and the floating-point
    operations of the cheapest algorithm (a FIR ``floors.fir_flops``, the
    fewer of the direct sum's and overlap-save's; a resampler 2 (2L + 1)
    an output and plane; an FFT 5 n log2 n, 2.5 for a real input)."""
    def dev(a):
        return torch.from_numpy(a).to(device)

    out = []
    n1 = inp["sine"].shape[-1]
    w1 = HammingWindow().sample(n1, dtype=torch.float32, device=device)

    def cfg1(x, w, carry):
        return pipelines._shifted_mag((x + carry) * w)

    out.append(Config(
        "windowed_fft_magnitude_1m", cfg1, (dev(inp["sine"]), w1), 50, n1,
        16.0 * n1, n1 + floors.fft_flops(n1, real=True) + 3.0 * n1,
        "x, w read, |X| and the carry written; window 1, real FFT, "
        "magnitude 3 a sample", ("K1",)))

    n2 = inp["x_re"].shape[-1]
    taps = dev(inp["rc_taps"])

    def cfg2(xr, xi, h, carry):
        re, im = conv_ops.convolve_signal_planar(xr + carry, xi, h, KNOBS)
        return re + im

    out.append(Config(
        "rc_fir_4m", cfg2, (dev(inp["x_re"]), dev(inp["x_im"]), taps), 50,
        n2, 20.0 * n2 + 8 * RC_TAPS,
        floors.fir_flops(RC_TAPS, complex_taps=True) * n2,
        "complex planes in and out; FIR of complex taps, overlap-save's "
        "count (the direct sum's 8 m a sample is more); the port runs the "
        "Toeplitz path", ()))

    n3 = inp["a_re"].shape[-1]
    sinc = SincFunction()

    def cfg3(xr, xi, carry):
        return interp_ops.interpolatef(torch.stack((xr + carry, xi)), sinc,
                                       1.5, 0.0, 10, 1.0).reshape(-1)

    out.append(Config(
        "interpolatef_1_5x_1m", cfg3, (dev(inp["a_re"]), dev(inp["a_im"])),
        20, n3, 8.0 * n3 + 12.0 * n3 + 4.0 * n3, 2.0 * 21 * 2 * 1.5 * n3,
        "two planes x1.5, 21 taps an output", ("K4",)))

    n4 = inp["s_re"].shape[-1]
    mod = pipelines.ModulationChainPlanar(0.35, 10.0, 0.0, 10, device=device)

    def cfg4(sr, si, carry):
        re, im = mod(sr + carry, si)
        return re + im

    out.append(Config(
        "modulation_chain_131k_symbols", cfg4,
        (dev(inp["s_re"]), dev(inp["s_im"])), 50, 10 * n4,
        8.0 * n4 + 80.0 * n4 + 4.0 * n4, 2.0 * 21 * 2 * 10 * n4,
        "two symbol planes x10, 21 taps an output", ("K4",)))

    n5 = inp["c_re"].shape[-1]
    chan = ChannelizeAndDemodPlanar(dev(inp["proto"]), CHANNELS)

    def cfg5(xr, xi, carry):
        return chan(xr + carry, xi)

    out.append(Config(
        "channelizer_1024ch_4m", cfg5, (dev(inp["c_re"]), dev(inp["c_im"])),
        30, n5, 16.0 * n5 + 4 * CHANNELS * PROTO_TAPS,
        (4.0 * PROTO_TAPS + 5.0 * math.log2(CHANNELS) + 6.0) * n5,
        "polyphase FIR 4 x 8 taps, C-point inverse FFT, demod product 6 a "
        "sample", ("K6",), io_bytes=12.0 * n5))

    if ab:
        h_long = dev(inp["h_long"])
        nb = overlap_save_cuda._geometry(n2, OS_TAPS, OS_FFT_LEN)[2]

        def cfg_os_fft(xr, xi, h, carry):
            return conv_ops.overlap_save(torch.complex(xr + carry, xi),
                                         h.to(torch.complex64), True,
                                         OS_FFT_LEN)

        def cfg_os_kernel(xr, xi, h, carry):
            return overlap_save_cuda.overlap_save_cuda(
                torch.complex(xr + carry, xi), h, True, OS_FFT_LEN)

        for name, body, kernels in (
                ("overlap_save_fft_384tap_4m", cfg_os_fft, ()),
                ("overlap_save_kernel_384tap_4m", cfg_os_kernel, ("K3",))):
            out.append(Config(
                name, body, (dev(inp["x_re"]), dev(inp["x_im"]), h_long),
                20, n2, 20.0 * n2 + 4 * OS_TAPS,
                floors.fir_flops(OS_TAPS) * n2,
                f"A/B: {nb} blocks of {OS_FFT_LEN}; FIR of real taps, "
                f"overlap-save's count at its best length", kernels))
    return out


def run_config(cfg: Config, device, iters: int) -> dict:
    """Times one config and returns its record."""
    on_card = device.type == "cuda"
    n = cfg.args[0].shape[-1]
    zero = torch.zeros(n, dtype=torch.float32, device=device)

    def call():
        return timing.fold(cfg.body(*cfg.args, zero), n)

    launched = timing.launches(call)
    t = timing.timed(cfg.body, *cfg.args, iters=iters)
    fl, bound, bms, fms = floors.floor_ms(cfg.nbytes, cfg.flops)
    rec = {"metric": cfg.metric, "kernels": list(cfg.kernels)}
    model = {"bytes_mb": round(cfg.nbytes / 1e6, 3),
             "gflop": round(cfg.flops / 1e9, 4), "bytes_ms": bms,
             "flops_ms": fms, "note": cfg.note}
    if cfg.io_bytes is not None:
        model["io_bound_ms"] = cfg.io_bytes / floors.PEAK_BYTES * 1e3
    if not on_card:
        rec.update({"device": "cpu", "rehearsal_ms": t.eager * 1e3,
                    "launches": launched, "model": model})
        return rec
    mode = "eager" if t.graph is None else "graph"
    sec = t.eager if t.graph is None else t.graph
    rec.update({
        "value": round(cfg.samples / sec / 1e6, 2), "unit": "Msamples/s",
        "vs_baseline": round(fl / (sec * 1e3), 4),
        "measured_ms": round(sec * 1e3, 4),
        "slope_spread": round(t.eager_spread if t.graph is None
                              else t.graph_spread, 3),
        "floor_ms": round(fl, 4), "bound": bound,
        "max_vs_floor": MAX_VS_FLOOR, "model": model, "timing": mode,
        "no_graph": t.no_graph, "eager_ms": round(t.eager * 1e3, 4),
        "graph_ms": None if t.graph is None else round(t.graph * 1e3, 4),
        "launches": launched,
        "idle_share": (None if t.graph is None
                       else round(1 - t.graph / t.eager, 4))})
    return rec


def merge_captures(path: str, session: dict, probe_us: float) -> dict:
    """Merges a session into the artifact at ``path`` (the JAX repository's
    ``merge_captures``): per config a list of captures (measured_ms, the
    session's health probe, time, spread); the headline is the best capture
    that passes the checks (a spread above 1.5, a capture above
    ``max_vs_floor`` times its floor or below 0.98 of its bytes time are
    refused), with the median and spread over those that pass.  A config
    whose every capture is refused is marked unhealthy, ``vs_baseline``
    0."""
    merged = {}
    if os.path.exists(path):
        with open(path) as f:
            merged = json.load(f)
    by_metric = {c["metric"]: c for c in merged.get("configs", [])}
    now = time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())
    out_cfgs = []
    for cfg in session["configs"]:
        prev = by_metric.pop(cfg["metric"], {})
        caps = list(prev.get("captures", []))
        caps.append({"measured_ms": cfg["measured_ms"],
                     "probe_us": round(probe_us, 3), "ts": now,
                     "slope_spread": cfg.get("slope_spread")})

        def ok(c):
            sp = c.get("slope_spread")
            if sp is not None and sp > 1.5:
                return False
            if cfg["floor_ms"] / c["measured_ms"] > cfg.get(
                    "max_vs_floor", 1.5):
                return False
            bytes_ms = cfg.get("model", {}).get("bytes_ms")
            return not (bytes_ms and c["measured_ms"] < 0.98 * bytes_ms)

        pool = [c for c in caps if ok(c)]
        unhealthy = not pool
        if unhealthy:
            pool = caps
        best = min(pool, key=lambda c: c["measured_ms"])
        ms_sorted = sorted(c["measured_ms"] for c in pool)
        samples = cfg["value"] * 1e6 * (cfg["measured_ms"] * 1e-3)
        entry = dict(cfg)
        entry.update({
            "measured_ms": best["measured_ms"],
            "value": round(samples / (best["measured_ms"] * 1e-3) / 1e6, 2),
            "vs_baseline": 0.0 if unhealthy else
            round(cfg["floor_ms"] / best["measured_ms"], 4),
            "unhealthy": unhealthy,
            "median_ms": round(ms_sorted[len(ms_sorted) // 2], 4),
            "spread": round(max(ms_sorted) / min(ms_sorted), 3),
            "n_captures": len(caps),
            "captures": caps,
        })
        out_cfgs.append(entry)
    out_cfgs.extend(by_metric.values())   # configs absent this session
    merged.update({k: session[k] for k in SESSION_KEYS if k in session})
    merged["configs"] = out_cfgs
    return merged


def _log(*parts):
    print("#", *parts, file=sys.stderr, flush=True)


def main(argv=None, env=None) -> dict:
    """Runs every config, prints a line each, and returns the session."""
    ap = argparse.ArgumentParser(
        prog="python3 -m basic_dsp_tpu_torch.bench.bench_all",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--json", default=None,
                    help="also write the session to FILE")
    ap.add_argument("--merge", default=None,
                    help="merge this session's captures into FILE")
    ap.add_argument("--device", default=None,
                    help="cpu for a rehearsal on the CPU (default: the card)")
    args = ap.parse_args(argv)
    env = os.environ if env is None else env
    dev = timing.device_of(args.device, "bench_all")
    on_card = dev.type == "cuda"
    if args.merge and not on_card:
        raise SystemExit("bench_all: --merge takes captures from the card "
                         "only")
    config.set_default_config(KNOBS)
    card = timing.card_line(dev)
    probe_us = timing.health_probe(dev, 100 if on_card else 2)
    _log(f"card: {card}; knobs {dataclasses.asdict(KNOBS)}; numeric mode "
         f"{timing.NUMERIC_MODE}: {timing.tf32_off()}; health probe "
         f"{probe_us:.3f} us/iter")
    cfgs = configs(inputs(0 if on_card else CPU_SHIFT), dev,
                   ab=env.get("BDSP_BENCH_AB", "") not in ("", "0"))
    results = []
    for cfg in cfgs:
        rec = run_config(cfg, dev, cfg.iters if on_card else CPU_ITERS)
        results.append(rec)
        _log(json.dumps(rec))
    for rec in results:
        keys = (("metric", "value", "unit", "vs_baseline") if on_card
                else ("metric", "device", "rehearsal_ms"))
        print(json.dumps({k: rec[k] for k in keys}), flush=True)
    session = {"device": torch.cuda.get_device_name(dev) if on_card
               else "cpu", "card": card,
               "hbm_gbps": floors.PEAK_BYTES / 1e9,
               "fp32_tflops": floors.PEAK_FP32 / 1e12,
               "numeric_mode": timing.NUMERIC_MODE, "probe_us": probe_us,
               "knobs": dataclasses.asdict(KNOBS), "configs": results}
    if args.json:
        with open(args.json, "w") as f:
            json.dump(session, f, indent=1)
        _log(f"wrote {args.json}")
    if args.merge:
        merged = merge_captures(args.merge, session, probe_us)
        with open(args.merge, "w") as f:
            json.dump(merged, f, indent=1)
        _log(f"merged into {args.merge}: " + str(
            {c["metric"]: (c["vs_baseline"], c.get("n_captures", 1))
             for c in merged["configs"]}))
    return session


if __name__ == "__main__":
    main()
