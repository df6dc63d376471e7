"""PyTorch port, WAV I/O (basic_dsp_tpu_torch/io.py) against the JAX
package's (basic_dsp_tpu/io.py): files written by either package read back
the same through both, PCM16 round trips within one quantization step,
(channels, frames) input, and the refusals."""
import numpy as np
import pytest

from basic_dsp_tpu import io as jio
from basic_dsp_tpu_torch import io as tio


@pytest.mark.parametrize("channels", [1, 2])
def test_wav_round_trip_matches_jax(tmp_path, channels):
    rng = np.random.default_rng(channels)
    frames = rng.uniform(-0.9, 0.9, (1000, channels)).astype(np.float32)
    for writer, name in ((jio, "jax.wav"), (tio, "torch.wav")):
        path = str(tmp_path / name)
        writer.write_wav(path, frames, 44100, bits=16)
        jback, jrate = jio.read_wav(path)
        tback, trate = tio.read_wav(path)
        assert trate == jrate == 44100
        assert tback.dtype == jback.dtype == np.float32
        np.testing.assert_array_equal(tback, jback)
        np.testing.assert_allclose(tback, frames, atol=1.0 / 16000)
    # Where the JAX package's native writer is built it rounds to the
    # nearest step; both write with Python's ``wave`` (truncating) and
    # give the same bytes where it is not.
    a, _ = tio.read_wav(str(tmp_path / "jax.wav"))
    b, _ = tio.read_wav(str(tmp_path / "torch.wav"))
    np.testing.assert_allclose(a, b, atol=1.0 / 32768)
    if not jio._native():
        assert (tmp_path / "jax.wav").read_bytes() == (
            tmp_path / "torch.wav").read_bytes()


def test_channels_first_input_and_clipping(tmp_path):
    frames = np.array([[0.5, -0.5, 2.0, -2.0], [0.0, 0.25, -0.25, 1.0]],
                      np.float32)                    # (channels, frames)
    path = str(tmp_path / "x.wav")
    tio.write_wav(path, frames, 8000)
    back, rate = tio.read_wav(path)
    assert rate == 8000 and back.shape == (4, 2)
    np.testing.assert_allclose(back, np.clip(frames.T, -1, 1),
                               atol=1.0 / 16000)
    np.testing.assert_array_equal(back, jio.read_wav(path)[0])


def test_pcm32_read_matches_jax(tmp_path):
    import wave
    pcm = (np.arange(-8, 8, dtype=np.int64) * (1 << 27)).astype(np.int32)
    path = str(tmp_path / "p32.wav")
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(4)
        w.setframerate(16000)
        w.writeframes(pcm.tobytes())
    back, rate = tio.read_wav(path)
    assert rate == 16000
    np.testing.assert_array_equal(back[:, 0], pcm / 2147483648.0)
    np.testing.assert_array_equal(back, jio.read_wav(path)[0])


def test_refusals(tmp_path):
    with pytest.raises(ValueError):
        tio.write_wav(str(tmp_path / "f.wav"), np.zeros((4, 1)), 8000,
                      bits=32)
    with pytest.raises(FileNotFoundError):
        tio.read_wav(str(tmp_path / "missing.wav"))
