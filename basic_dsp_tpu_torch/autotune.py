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

The JAX package runs one backend a process, so it holds one entry.  A
process of the port can hold CPU and CUDA data at once, so it holds one
entry a device kind (:func:`ensure_calibrated`), and a typed convolution
runs the knobs of its own data's kind (:func:`config_for`).  Installing an
entry also writes its knobs into the process-wide default config, as the
JAX package does: with one kind in a process, ``default_config()`` carries
that kind's knobs.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import os
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from . import config as _config

# device_kind -> {"fft_block_len": int, "direct_conv_max_imp_len": int,
#                 "timings": {...}}
_entries: Dict[str, dict] = {}
# the entry installed last (the one print_calibration reports)
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
        return _card_name(dev.index)
    return dev.type


@functools.lru_cache(maxsize=None)
def _card_name(index) -> str:
    return torch.cuda.get_device_name(index)


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


def _with_knobs(cfg: _config.DspConfig, entry: dict) -> _config.DspConfig:
    return _knobbed(cfg, int(entry.get("fft_block_len", 0)), int(entry.get(
        "direct_conv_max_imp_len", cfg.direct_conv_max_imp_len)))


@functools.lru_cache(maxsize=64)
def _knobbed(cfg: _config.DspConfig, fft_block_len: int,
             direct_conv_max_imp_len: int) -> _config.DspConfig:
    """``cfg`` with the two knobs, built once for each (frozen) config and
    pair of knobs: a typed convolution asks for it at every call."""
    return dataclasses.replace(
        cfg, direct_conv_max_imp_len=direct_conv_max_imp_len,
        fft_block_len=fft_block_len)


def _install(kind: str, entry: dict) -> None:
    """Holds ``entry`` as ``kind``'s and writes its knobs into the
    process-wide default config."""
    global _state
    _entries[kind] = _state = entry
    _config.set_default_config(_with_knobs(_config.default_config(), entry))


def ensure_calibrated(device=None) -> dict:
    """Lazy one-time calibration (threading.rs:190-193 analog), once a
    device kind: returns the entry of ``device``'s kind (the card when
    None) if this process holds one, else loads it from the cache if
    present, else times the sweeps on ``device`` and persists them.
    Never returns another kind's entry."""
    kind = _device_kind(device)
    if kind in _entries:
        return _entries[kind]
    cache = _load_cache()
    if kind in cache:
        _install(kind, cache[kind])
        _entries[kind]["source"] = "cache"
        return _entries[kind]
    entry = calibrate(device=device)
    entry["source"] = "measured"
    return entry


def config_for(device, calibrate: bool = True) -> _config.DspConfig:
    """The process default config with the knobs of ``device``'s kind:
    what a typed convolution without a ``cfg`` runs, whichever kind's
    entry was installed last.  ``calibrate`` loads or measures that kind's
    entry first; without it a kind that has no entry runs the untuned
    knobs of ``DspConfig()`` once another kind's are installed."""
    cfg = _config.default_config()
    if calibrate:
        return _with_knobs(cfg, ensure_calibrated(device))
    entry = _entries.get(_device_kind(device))
    if entry is None and _entries:
        entry = dataclasses.asdict(_config.DspConfig())
    return cfg if entry is None else _with_knobs(cfg, entry)


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
    _install(entry["device_kind"], entry)
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
    """Clears process-local state (every kind's entry) so tests can
    exercise the lazy path."""
    global _state
    _state = None
    _entries.clear()
    _results.clear()
