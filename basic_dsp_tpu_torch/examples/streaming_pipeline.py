"""Serving-style streaming pipeline (twin of
``examples/streaming_pipeline.py``):

    sample stream --chunks--> StreamingResampler (x3/2)
                          --> StreamingFir (raised-cosine filter)
                          --> per-chunk power log

Both stages carry their overlap state as a value ((chunk, state) ->
(out, state)), so the concatenated resampler outputs equal the
whole-buffer linear (zero-padded) resample delayed by the resampler's
``output_delay``, and the concatenated filter outputs the causal part of
the linear convolution of those with the taps.  On the card each chunk
launches K4 once; the 64-tap filter's chunk of 768 samples (831 with its
tail) is shorter than its block length (2048), so it runs the
whole-extent FFT, as the JAX step does, and launches no K3.

    python3 -m basic_dsp_tpu_torch.examples.streaming_pipeline [n_chunks]
"""
import sys

import numpy as np
import torch

from basic_dsp_tpu_torch import config
from basic_dsp_tpu_torch.conv_types import RaisedCosineFunction, SincFunction
from basic_dsp_tpu_torch.streaming import StreamingFir, StreamingResampler

CHUNK = 512                     # input chunk: divisible by 128*Q (Q = 2)


def main(n_chunks: int = 8, device=None) -> dict:
    """Prints a line a chunk, as the JAX example; returns the stream's
    input, the concatenated resampler and filter outputs, the taps and the
    two stages."""
    dev = config.resolve_device(device)
    rng = np.random.default_rng(0)

    resampler = StreamingResampler(SincFunction(), 1.5, 0.0, 10, device=dev)
    t = torch.from_numpy(((np.arange(64) - 32) * 0.25).astype(np.float32))
    taps = RaisedCosineFunction(0.35).calc(t).to(torch.float32)
    taps = (taps / taps.sum()).to(dev)
    fir = StreamingFir(taps)

    rs_state = resampler.init_state(torch.float32)
    fir_state = fir.init_state(torch.float32)

    print(f"resampler latency {resampler.output_delay} out-samples; "
          f"fir latency {fir.m - fir.m // 2 - 1} samples")
    chunks, ups, filts = [], [], []
    for c in range(n_chunks):
        chunk = torch.from_numpy(rng.normal(size=CHUNK).astype(np.float32)
                                 ).to(dev)
        up, rs_state = resampler.process(chunk, rs_state)
        filt, fir_state = fir.process(up, fir_state)
        power = float(torch.mean(filt * filt))
        print(f"chunk {c}: in {CHUNK} -> resampled {up.shape[-1]} "
              f"-> filtered {filt.shape[-1]}, mean power {power:.4f}")
        chunks.append(chunk)
        ups.append(up)
        filts.append(filt)
    return {"input": torch.cat(chunks), "resampled": torch.cat(ups),
            "filtered": torch.cat(filts), "taps": taps,
            "resampler": resampler, "fir": fir}


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 8)
