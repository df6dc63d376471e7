"""PyTorch port, WAV I/O (basic_dsp_tpu_torch/io.py) against the JAX
package's (basic_dsp_tpu/io.py) and against the native reader and writer
of both C ABI libraries (``bdsp_read_wav``/``bdsp_write_wav`` of
``libbasic_dsp_tpu.so`` and of the port's ``libbasic_dsp_tpu_torch.so``):
files written by either package read back the same through every reader,
the port writes the native writer's bytes at 16 and 32 bits, PCM32 and
files with unknown chunks read the same, (channels, frames) input, and the
refusals."""
import ctypes
import struct

import numpy as np
import pytest

from basic_dsp_tpu import io as jio
from basic_dsp_tpu_torch import io as tio
from basic_dsp_tpu_torch.kernels import _build
from test_torch_interop import jax_library


def _wav_lib(path):
    lib = ctypes.CDLL(path)
    lib.bdsp_read_wav.restype = ctypes.POINTER(ctypes.c_float)
    lib.bdsp_read_wav.argtypes = [ctypes.c_char_p,
                                  ctypes.POINTER(ctypes.c_int32),
                                  ctypes.POINTER(ctypes.c_int32),
                                  ctypes.POINTER(ctypes.c_int64)]
    lib.bdsp_write_wav.restype = ctypes.c_int32
    lib.bdsp_write_wav.argtypes = [ctypes.c_char_p,
                                   ctypes.POINTER(ctypes.c_float),
                                   ctypes.c_int32, ctypes.c_int32,
                                   ctypes.c_int64, ctypes.c_int32]
    lib.bdsp_free.argtypes = [ctypes.c_void_p]
    return lib


@pytest.fixture(scope="module")
def native():
    """The native WAV code of both libraries: "jax" and "torch"."""
    path = jax_library()
    if path is None:
        pytest.skip("JAX interop library not built and cmake/ninja "
                    "unavailable")
    return {"jax": _wav_lib(path),
            "torch": _wav_lib(str(_build.interop_library()))}


def _native_read(lib, path):
    ch, rate, frames = ctypes.c_int32(), ctypes.c_int32(), ctypes.c_int64()
    ptr = lib.bdsp_read_wav(str(path).encode(), ctypes.byref(ch),
                            ctypes.byref(rate), ctypes.byref(frames))
    assert ptr, path
    data = np.ctypeslib.as_array(ptr, shape=(frames.value * ch.value,)).copy()
    lib.bdsp_free(ptr)
    return data.reshape(frames.value, ch.value), rate.value


def _native_write(lib, path, frames, rate, bits):
    flat = np.ascontiguousarray(frames.reshape(-1), dtype=np.float32)
    ptr = flat.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
    assert lib.bdsp_write_wav(str(path).encode(), ptr, frames.shape[1], rate,
                              frames.shape[0], bits) == 0


def _frames(channels, seed=0):
    """Samples in and beyond [-1, 1], with PCM16 half steps (ties that
    rounding half to even resolves) among them."""
    rng = np.random.default_rng(seed)
    frames = rng.uniform(-1.2, 1.2, (1001, channels)).astype(np.float32)
    frames[:8, 0] = np.array([0.5, 1.5, 2.5, -0.5, -1.5, 3.5, 1.0, -1.0],
                             np.float32) / np.float32(32767.0)
    return frames


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
    # Both round to the nearest step where the JAX package's native writer
    # is built, and write the same bytes; its Python fallback truncates,
    # one step apart at most.
    if jio._native():
        assert (tmp_path / "jax.wav").read_bytes() == (
            tmp_path / "torch.wav").read_bytes()
    else:
        a, _ = tio.read_wav(str(tmp_path / "jax.wav"))
        b, _ = tio.read_wav(str(tmp_path / "torch.wav"))
        np.testing.assert_allclose(a, b, atol=1.0 / 32768)


@pytest.mark.parametrize("bits", [16, 32])
def test_files_written_by_jax_read_back_equal(tmp_path, native, bits):
    """A file from ``basic_dsp_tpu.io.write_wav`` (PCM16, or IEEE float32,
    format 3) reads back the same through the port's ``read_wav``, JAX's
    and the port library's ``bdsp_read_wav``; float32 exactly as written."""
    frames = _frames(2, bits)
    path = str(tmp_path / "jax.wav")
    jio.write_wav(path, frames, 48000, bits=bits)
    back, rate = tio.read_wav(path)
    assert rate == 48000 and back.shape == frames.shape
    np.testing.assert_array_equal(back, jio.read_wav(path)[0])
    np.testing.assert_array_equal(back, _native_read(native["torch"],
                                                     path)[0])
    if bits == 32:
        np.testing.assert_array_equal(back, frames)


@pytest.mark.parametrize("bits", [16, 32])
@pytest.mark.parametrize("channels", [1, 2])
def test_write_wav_bytes_match_the_native_writer(tmp_path, native, bits,
                                                 channels):
    """The port's ``write_wav`` writes the native writer's bytes: PCM16
    clipped and rounded half to even as ``lrintf`` does, float32 as is."""
    frames = _frames(channels, 3)
    tio.write_wav(str(tmp_path / "port.wav"), frames, 22050, bits=bits)
    want = (tmp_path / "port.wav").read_bytes()
    for kind, lib in native.items():
        _native_write(lib, tmp_path / f"{kind}.wav", frames, 22050, bits)
        assert (tmp_path / f"{kind}.wav").read_bytes() == want, kind


def _riff(fmt, bits, channels, rate, payload, extra=b""):
    width = bits // 8
    fmt_chunk = struct.pack("<4sIHHIIHH", b"fmt ", 16, fmt, channels, rate,
                            rate * channels * width, channels * width, bits)
    body = (b"WAVE" + fmt_chunk + extra
            + struct.pack("<4sI", b"data", len(payload)) + payload)
    return struct.pack("<4sI", b"RIFF", len(body)) + body


@pytest.mark.parametrize("kind", ["pcm32", "unknown_chunk"])
def test_pcm32_and_unknown_chunks_read_the_same(tmp_path, native, kind):
    """PCM32 samples, and a PCM16 file with an odd-sized LIST chunk (and
    its pad byte) before the data, read the same through the port's
    ``read_wav``, JAX's, and both libraries' ``bdsp_read_wav``."""
    rng = np.random.default_rng(4)
    if kind == "pcm32":
        pcm = rng.integers(-2**31, 2**31, 600, dtype=np.int64).astype(
            "<i4")
        blob = _riff(1, 32, 2, 16000, pcm.tobytes())
        want = (pcm.astype(np.float64) / 2147483648.0).astype(np.float32)
    else:
        pcm = rng.integers(-2**15, 2**15, 600, dtype=np.int64).astype(
            "<i2")
        listing = b"INFOISFT\x05\x00\x00\x00bdsp\x00"
        extra = struct.pack("<4sI", b"LIST", len(listing)) + listing + b"\0"
        assert len(listing) % 2 == 1
        blob = _riff(1, 16, 2, 16000, pcm.tobytes(), extra)
        want = pcm.astype(np.float32) / 32768.0
    path = tmp_path / f"{kind}.wav"
    path.write_bytes(blob)
    back, rate = tio.read_wav(str(path))
    assert rate == 16000 and back.shape == (300, 2)
    np.testing.assert_array_equal(back.reshape(-1), want)
    np.testing.assert_array_equal(back, jio.read_wav(str(path))[0])
    for lib in native.values():
        np.testing.assert_array_equal(back, _native_read(lib, path)[0])


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
                      bits=24)
    with pytest.raises(FileNotFoundError):
        tio.read_wav(str(tmp_path / "missing.wav"))
    (tmp_path / "text.wav").write_bytes(b"not a wav file at all")
    with pytest.raises(ValueError):
        tio.read_wav(str(tmp_path / "text.wav"))
    (tmp_path / "pcm8.wav").write_bytes(_riff(1, 8, 1, 8000, bytes(16)))
    with pytest.raises(ValueError):
        tio.read_wav(str(tmp_path / "pcm8.wav"))
