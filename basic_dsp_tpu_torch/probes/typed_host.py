#!/usr/bin/env python3
"""The typed layer's host cost on an NVIDIA GPU, in a fresh process: the
typed path of ``chip_smoke.py`` phase 4 (a 2^22-sample complex vector's
``convolve_signal`` with 384 complex taps, ``windowed_fft`` with a
Hamming window, ``magnitude``) against the same ops called as functions.

    python3 basic_dsp_tpu_torch/probes/typed_host.py [ROOT]

``ROOT`` is the directory whose ``basic_dsp_tpu_torch`` is imported (this
checkout by default), so that two trees can be compared in one call.
``torch.distributed.tensor`` is imported first, as it is in
``chip_smoke.py`` by then.  Prints one JSON line: the host's time to
issue each path (microseconds a call over 100 calls, the three best of
seven loops, no synchronize inside a loop) and the CUDA-event medians of
20 calls of each, in the order functions, typed, typed, functions.
"""
import json
import os
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch


def main(root: str) -> None:
    sys.path.insert(0, root)
    import torch.distributed.tensor  # noqa: F401

    import basic_dsp_tpu_torch as bt
    from basic_dsp_tpu_torch.ops import conv_ops

    if not torch.cuda.is_available():
        raise SystemExit("typed_host: no CUDA device")
    # the default knobs for this card, without timing a calibration
    cache = os.path.join(tempfile.mkdtemp(prefix="typed_host_"), "at.json")
    os.environ["BDSP_AUTOTUNE_CACHE"] = cache
    kind = torch.cuda.get_device_name(0)
    with open(cache, "w") as f:
        json.dump({kind: {"device_kind": kind, "fft_block_len": 0,
                          "direct_conv_max_imp_len": 202}}, f)
    rng = np.random.default_rng(0)
    n = 1 << 22
    vh = bt.to_complex_time_vec((rng.standard_normal(n)
                                 + 1j * rng.standard_normal(n))
                                .astype(np.complex64))
    h = torch.from_numpy(rng.standard_normal(384).astype(
        np.complex64)).cuda()
    imp = bt.to_complex_time_vec(h.cpu().numpy())
    hamming = bt.HammingWindow()
    xh = vh.array

    def functions():
        y = conv_ops.convolve_signal(xh, h, True)
        w = hamming.sample(n, dtype=torch.float32, device="cuda")
        return torch.abs(bt.fft_ops.fft_shifted(y * w))

    def typed():
        return vh.convolve_signal(imp).windowed_fft(hamming).magnitude()

    def host_us(fn, calls=100):
        for _ in range(10):
            fn()
        torch.cuda.synchronize()
        loops = []
        for _ in range(7):
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            loops.append((time.perf_counter() - t0) / calls * 1e6)
            torch.cuda.synchronize()
        return sorted(loops)[:3]

    def event_us(fn, calls=20):
        for _ in range(3):
            fn()
        out = []
        for _ in range(calls):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            stop.record()
            stop.synchronize()
            out.append(start.elapsed_time(stop) * 1e3)
        return float(np.median(out))

    print(json.dumps({
        "root": root, "device": kind,
        "host_us_functions": host_us(functions),
        "host_us_typed": host_us(typed),
        "event_us": [event_us(fn) for fn in (functions, typed, typed,
                                             functions)]}))


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1
         else str(Path(__file__).resolve().parents[2]))
