"""PyTorch port, the entry points of basic_dsp_tpu_torch/entry.py
against the JAX repo's (``__graft_entry__.py``): ``entry()``'s inputs
(numpy-seeded signal and taps bit-equal, the Hamming window within the
window tests' 1e-6) and its step within the flagship tests' 2e-6 of the
maximum; ``dryrun_multichip(4)`` on four gloo ranks, every step within
1e-6 of its single-device call and the gathered FIR, channelizer and
resampler within 1e-5 of the JAX package's single-device functions
(angles on the circle); and no CPU fallback: without CUDA both raise
unless the caller names the CPU."""
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from basic_dsp_tpu.conv_types import SincFunction as JSinc
from basic_dsp_tpu.ops import conv_ops as jconv
from basic_dsp_tpu.ops import interp_ops as jinterp
from basic_dsp_tpu.parallel import channelizer as jchan
from basic_dsp_tpu_torch import entry

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import __graft_entry__ as graft  # noqa: E402

TOL = 2e-6
WINDOW_TOL = 1e-6
JAX_TOL = 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _rel(got, ref):
    return float(np.max(np.abs(got - ref)) / np.max(np.abs(ref)))


def test_entry_inputs_and_step_match_jax():
    jfn, jargs = graft.entry()
    fn, args = entry.entry("cpu")
    assert all(a.device.type == "cpu" for a in args)
    for got, want in zip(args[:2], jargs[:2]):
        assert got.dtype == torch.complex64
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert args[2].dtype == torch.float32
    assert np.max(np.abs(args[2].numpy() - np.asarray(jargs[2]))) \
        <= WINDOW_TOL
    got = fn(*args)
    assert got.shape == (entry.ENTRY_N,) and got.dtype == torch.float32
    assert _rel(got.numpy(), np.asarray(jfn(*jargs))) <= TOL


def test_dryrun_multichip_on_four_gloo_ranks_matches_jax():
    record = entry.dryrun_multichip(4, device_type="cpu", timeout=240)
    assert record["n_devices"] == 4 and record["device"] == "cpu (gloo)"
    n = entry.SHARD_LEN * 4
    assert record["signal_len"] == n
    names = [k.split(": ")[1] for k in record["steps"]]
    assert names == [
        "sharded_convolve_signal", "sharded_statistics",
        "sharded_channelize_and_demod", "sharded_fft",
        "sharded_interpolatef", "StreamingFir, 2 sharded chunks",
        "sharded_convolve_mat", "sharded_convolve_signal",
        "sharded_statistics", "sharded_fft", "sharded_interpolatef",
        "sharded_channelize_and_demod"]
    assert sum(k.startswith("(2, 2) mesh: ") for k in record["steps"]) == 5
    for name, step in record["steps"].items():
        assert step["max_err"] <= entry.DRYRUN_TOL, name
        assert not any(step["launches"].values()), name   # CPU: plain
    # the JAX dry run's input
    rng = np.random.default_rng(0)
    x = jnp.asarray((rng.normal(size=n) + 1j * rng.normal(size=n))
                    .astype(np.complex64))
    h = jnp.asarray((rng.normal(size=entry.DRYRUN_TAPS)
                     + 1j * rng.normal(size=entry.DRYRUN_TAPS))
                    .astype(np.complex64))
    proto = jnp.asarray((np.hamming(64) / 8).astype(np.float32))
    out = record["outputs"]
    assert _rel(out["sharded_convolve_signal"],
                np.asarray(jconv.convolve_signal(x, h, True))) <= JAX_TOL
    assert _rel(out["sharded_interpolatef"], np.asarray(
        jinterp.interpolatef(x, JSinc(), 1.5, 0.0, 10, 1.0))) <= JAX_TOL
    ang = np.asarray(jchan.channelize_and_demod(x, proto, 8))
    d = np.remainder(out["sharded_channelize_and_demod"] - ang + np.pi,
                     2 * np.pi) - np.pi
    assert out["sharded_channelize_and_demod"].shape == ang.shape == (8, 128)
    assert float(np.max(np.abs(d))) / float(np.max(np.abs(ang))) <= JAX_TOL


def test_entry_points_need_the_card_unless_told_otherwise():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry.entry()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry.dryrun_multichip(1)
