"""Self-calibration (counterpart of ``basic_dsp_tpu/autotune.py``): the
analog of the reference's one-time multicore calibration
(multicore_support/threading.rs:39-193), which times sweeps on first
parallel use and caches the result for the process lifetime;
``print_calibration`` (threading.rs:282-289) reports the fit.

The tunables are the dispatch knobs of the convolution engine:

* ``fft_block_len``: block length of the overlap-save region (the CUDA
  kernel K3 on the card, at the block length clamped into its range);
* ``direct_conv_max_imp_len``: the Toeplitz-matmul <-> blocked-FFT
  crossover kernel length, never below the reference's gate of 202.

Each candidate is timed as ``conv_ops.convolve_signal`` runs it (CUDA
events on the card, ``perf_counter`` on the CPU), a loop whose carry feeds
each output back into the next input.  Calibration runs lazily on the
first large convolution of a typed vector and persists per device kind
(``torch.cuda.get_device_name()`` for the card, "cpu" for the CPU) to a
JSON cache: ``BDSP_AUTOTUNE_CACHE`` when set, else
``$XDG_CACHE_HOME/basic_dsp_tpu_torch/autotune.json`` (``~/.cache``
without it), a file of its own so that the two packages never overwrite
each other's entries.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from . import config as _config

# device_kind -> {"fft_block_len": int, "direct_conv_max_imp_len": int,
#                 "timings": {...}}
_state: Optional[dict] = None
_results: Dict[str, List[Tuple]] = {}


def _cache_path() -> str:
    env = os.environ.get("BDSP_AUTOTUNE_CACHE")
    if env:
        return env
    base = os.environ.get("XDG_CACHE_HOME",
                          os.path.join(os.path.expanduser("~"), ".cache"))
    return os.path.join(base, "basic_dsp_tpu_torch", "autotune.json")


def _device_kind(device=None) -> str:
    """The cache key of ``device`` (the card when None): the card's name,
    or "cpu"."""
    dev = _config.resolve_device(device)
    if dev.type == "cuda":
        return torch.cuda.get_device_name(dev)
    return dev.type


def _load_cache() -> dict:
    try:
        with open(_cache_path()) as f:
            return json.load(f)
    except (OSError, ValueError):
        return {}


def _save_cache(all_kinds: dict) -> None:
    path = _cache_path()
    try:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump(all_kinds, f, indent=1, sort_keys=True)
    except OSError:
        pass  # read-only environments: calibration stays process-local


def _install(entry: dict) -> None:
    global _state
    _state = entry
    cfg = _config.default_config()
    _config.set_default_config(dataclasses.replace(
        cfg,
        direct_conv_max_imp_len=int(entry.get(
            "direct_conv_max_imp_len", cfg.direct_conv_max_imp_len)),
        fft_block_len=int(entry.get("fft_block_len", 0)),
    ))


def ensure_calibrated(device=None) -> dict:
    """Lazy one-time calibration (threading.rs:190-193 analog): loads the
    cache entry of ``device``'s kind (the card when None) if present,
    otherwise times the sweeps on ``device`` and persists them.  Returns
    the installed entry."""
    global _state
    if _state is not None:
        return _state
    kind = _device_kind(device)
    cache = _load_cache()
    if kind in cache:
        _install(cache[kind])
        _state["source"] = "cache"
        return _state
    entry = calibrate(device=device)
    entry["source"] = "measured"
    return entry


def _time_fn(f, device: torch.device, iters: int) -> float:
    """Median-of-3 per-iteration seconds of ``f()`` after one warm-up:
    CUDA events on the card, ``perf_counter`` on the CPU (where eager
    PyTorch has finished when ``f`` returns)."""
    f()
    ts = []
    for _ in range(3):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            f()
            stop.record()
            stop.synchronize()
            ts.append(start.elapsed_time(stop) / 1e3 / iters)
        else:
            t0 = time.perf_counter()
            float(f())
            ts.append((time.perf_counter() - t0) / iters)
    return sorted(ts)[1]


def calibrate(n: int = 1 << 19,
              block_candidates: Tuple[int, ...] = (1024, 2048, 4096, 8192),
              crossover_kernels: Tuple[int, ...] = (96, 160, 224, 320),
              iters: int = 4, device=None) -> dict:
    """Times the tunables on ``device`` (the card when None) and installs
    and persists the winners.  Each candidate runs
    ``conv_ops.convolve_signal`` under a config that sends it down the
    path it tunes: the overlap-save region at each block length (K3 on
    the card), the Toeplitz matmuls or the blocked FFT at each kernel
    length."""
    from .ops import conv_ops

    dev = _config.resolve_device(device)
    rng = np.random.default_rng(0)
    x_re = torch.from_numpy(rng.normal(size=n).astype(np.float32)).to(dev)
    x_im = torch.from_numpy(rng.normal(size=n).astype(np.float32)).to(dev)
    base = _config.DspConfig()

    def loop(cfg, h_re):
        h = h_re.to(torch.complex64)

        def f():
            carry = torch.complex(x_re, x_im)
            for _ in range(iters):
                y = conv_ops.convolve_signal(carry, h, True, cfg)
                carry = y / (torch.abs(y[0]) + 1.0)
            return torch.abs(carry[0])

        return f

    # --- knob 1: overlap-save block length (128-tap workload) -----------
    h128 = torch.from_numpy(rng.normal(size=128).astype(np.float32)).to(dev)
    block_times = []
    for fl in block_candidates:
        if fl < 256:
            continue
        cfg = dataclasses.replace(base, direct_conv_max_imp_len=0,
                                  fft_block_len=fl)
        block_times.append((fl, _time_fn(loop(cfg, h128), dev, iters)))
    best_block = min(block_times, key=lambda t: t[1])[0]
    _results["fft_block_len"] = block_times

    # --- knob 2: Toeplitz <-> blocked-FFT crossover kernel length --------
    # The crossover is the largest m where the Toeplitz path still wins
    # (the reference's SIMD gate analog, convolution.rs:499: imp_len <=
    # 202).
    crossover = 0
    xo_times = []
    for m in crossover_kernels:
        hm = torch.from_numpy(rng.normal(size=m).astype(np.float32)).to(dev)
        toeplitz = dataclasses.replace(base, direct_conv_max_imp_len=m)
        blocked = dataclasses.replace(base, direct_conv_max_imp_len=0,
                                      fft_block_len=best_block)
        tt = _time_fn(loop(toeplitz, hm), dev, iters)
        tb = _time_fn(loop(blocked, hm), dev, iters)
        xo_times.append((m, tt, tb))
        if tt <= tb:
            crossover = max(crossover, m)
    _results["crossover"] = xo_times
    # Never tune below the reference's proven gate.
    direct_max = max(crossover, 202)

    entry = {
        "fft_block_len": int(best_block),
        "direct_conv_max_imp_len": int(direct_max),
        "device_kind": _device_kind(dev),
        "timings": {
            "fft_block_len": [[int(fl), float(dt)] for fl, dt in block_times],
            "crossover": [[int(m), float(tt), float(tb)]
                          for m, tt, tb in xo_times],
            "workload_n": n,
        },
    }
    cache = _load_cache()
    cache[entry["device_kind"]] = entry
    _save_cache(cache)
    _install(entry)
    return entry


def print_calibration() -> str:
    """Debug report of the fitted table (reference print_calibration,
    threading.rs:282-289)."""
    lines = []
    if _state is None:
        lines.append("not calibrated (runs lazily on the first large "
                     "convolution, or call autotune.calibrate())")
    else:
        lines.append(f"device_kind: {_state.get('device_kind', '?')} "
                     f"(source: {_state.get('source', 'measured')})")
        lines.append(f"fft_block_len: {_state.get('fft_block_len')}")
        lines.append("direct_conv_max_imp_len: "
                     f"{_state.get('direct_conv_max_imp_len')}")
        t = _state.get("timings", {})
        for fl, dt in t.get("fft_block_len", []):
            n = t.get("workload_n", 0)
            lines.append(f"  overlap_save fft_len={fl}: {dt * 1e3:.3f} "
                         f"ms/iter ({n / dt / 1e6:.0f} Msamples/s)")
        for m, tt, tb in t.get("crossover", []):
            lines.append(f"  m={m}: toeplitz {tt * 1e3:.3f} ms vs "
                         f"blocked {tb * 1e3:.3f} ms")
    report = "\n".join(lines)
    print(report)
    return report


def _reset_for_tests() -> None:
    """Clears process-local state so tests can exercise the lazy path."""
    global _state
    _state = None
    _results.clear()
