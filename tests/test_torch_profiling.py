"""PyTorch port, profiling (basic_dsp_tpu_torch/profiling.py), on the CPU:
``time_op`` and ``throughput`` return the JAX package's keys and count
their calls (one warm-up, then ``iters``), and ``trace`` writes a
non-empty Chrome trace naming the ops it saw.  Times are the CPU's own and
are only checked for being positive and consistent (exact arithmetic on
the returned numbers)."""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from basic_dsp_tpu import profiling as jprof
from basic_dsp_tpu_torch import profiling as tprof


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def test_time_op_keys_and_calls():
    calls = []

    def fn(x, y):
        calls.append(1)
        return x * y + 1.0

    x = torch.from_numpy(np.arange(64, dtype=np.float32))
    got = tprof.time_op(fn, x, 2.0, iters=5)
    want = jprof.time_op(lambda a, b: a * b + 1.0,
                         jnp.arange(64, dtype=jnp.float32), 2.0, iters=5)
    assert set(got) == set(want) == {"total_s", "per_iter_s"}
    assert len(calls) == 6
    assert got["total_s"] > 0
    assert got["per_iter_s"] == got["total_s"] / 5


def test_throughput_adds_msamples():
    x = torch.ones(1000)
    got = tprof.throughput(torch.fft.fft, 1000, x, iters=3)
    want = jprof.throughput(jnp.fft.fft, 1000, jnp.ones(1000), iters=3)
    assert set(got) == set(want)
    assert got["msamples_per_s"] == 1000 / got["per_iter_s"] / 1e6


def test_trace_writes_a_chrome_trace(tmp_path):
    log_dir = tmp_path / "trace"
    with tprof.trace(str(log_dir)):
        torch.fft.fft(torch.ones(256, dtype=torch.complex64))
    files = list(log_dir.glob("trace_*.json"))
    assert len(files) == 1 and files[0].stat().st_size > 0
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any("fft" in e.get("name", "") for e in events)
