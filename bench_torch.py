#!/usr/bin/env python3
"""The flagship benchmark of the PyTorch port on the card: one JSON line,
``{"metric": "fir_fft_chain_throughput", "value", "unit", "vs_baseline"}``
(``basic_dsp_tpu_torch/bench/bench.py``; its docstring has the workload,
the timing and the ``BENCH_FUSED`` switch).

    python3 bench_torch.py [--device cpu]
"""
from basic_dsp_tpu_torch.bench import bench

if __name__ == "__main__":
    bench.main()
