"""PyTorch port, windows: the same windows as the JAX package
(basic_dsp_tpu/windows.py) to 1e-6 relative to the maximum, and the
reference's five-point goldens."""
import numpy as np
import pytest
import torch

import basic_dsp_tpu as bd
import basic_dsp_tpu_torch as bt

TOL = 1e-6
NAMES = ["TriangularWindow", "HammingWindow", "BlackmanHarrisWindow",
         "RectangularWindow"]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.mark.parametrize("length", [5, 64, 1001, 4096])
@pytest.mark.parametrize("name", NAMES)
def test_window_matches_jax(name, length):
    ref = np.asarray(getattr(bd, name)().sample(length))
    got = getattr(bt, name)().sample(length, device="cpu").numpy()
    assert got.dtype == np.float32 and got.shape == (length,)
    assert np.max(np.abs(got - ref)) / np.max(np.abs(ref)) <= TOL


@pytest.mark.parametrize("name,golden", [
    ("TriangularWindow", [0.2, 0.6, 1.0, 0.6, 0.2]),
    ("HammingWindow", [0.08, 0.54, 1.0, 0.54, 0.08]),
    ("BlackmanHarrisWindow", [0.0001, 0.2175, 1.0000, 0.2175, 0.0001]),
    ("RectangularWindow", [1.0] * 5),
])
def test_window_goldens(name, golden):
    np.testing.assert_allclose(
        getattr(bt, name)().sample(5, device="cpu").numpy(), golden,
        atol=1e-4)


def test_window_dtype_device_and_identity():
    w = bt.HammingWindow(0.5).sample(16, dtype=torch.float64, device="cpu")
    assert w.dtype == torch.float64 and w.device.type == "cpu"
    ref = np.asarray(bd.HammingWindow(0.5).sample(16))
    assert np.max(np.abs(w.numpy() - ref)) <= TOL
    assert bt.HammingWindow() == bt.HammingWindow(0.54)
    assert bt.HammingWindow() != bt.HammingWindow(0.5)
    assert hash(bt.TriangularWindow()) == hash(bt.TriangularWindow())


def test_sample_defaults_to_the_card():
    """Without ``device`` the window is sampled on the card; with no CUDA
    that raises instead of falling back to the CPU."""
    if torch.cuda.is_available():
        assert bt.HammingWindow().sample(16).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            bt.HammingWindow().sample(16)
