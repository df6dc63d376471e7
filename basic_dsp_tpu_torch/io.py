"""WAV I/O, the data-loading path (counterpart of ``basic_dsp_tpu/io.py``).

Reads and writes PCM WAV files with Python's ``wave`` module.  Returns
(frames, channels) float32 arrays in [-1, 1].  The JAX package first tries
the native reader of its C interop library and falls back to this same
``wave`` code when that library is not built, so both give the same
results there.
"""
from __future__ import annotations

import wave
from typing import Tuple

import numpy as np


def read_wav(path: str) -> Tuple[np.ndarray, int]:
    """Returns ((frames, channels) float32 in [-1, 1], sample_rate) of a
    PCM16 or PCM32 file."""
    with wave.open(path, "rb") as r:
        n = r.getnframes()
        raw = r.readframes(n)
        width = r.getsampwidth()
        if width == 2:
            data = np.frombuffer(raw, dtype=np.int16).astype(np.float32) \
                / 32768.0
        elif width == 4:
            data = np.frombuffer(raw, dtype=np.int32).astype(np.float32) \
                / 2147483648.0
        else:
            raise ValueError(f"unsupported sample width {width}")
        return data.reshape(n, r.getnchannels()), r.getframerate()


def write_wav(path: str, frames: np.ndarray, rate: int,
              bits: int = 16) -> None:
    """Writes (frames, channels) float32 in [-1, 1] as PCM16; a
    (channels, frames) array with at most 8 channels is accepted too."""
    frames = np.atleast_2d(np.asarray(frames, dtype=np.float32))
    if frames.shape[0] < frames.shape[1] and frames.shape[0] <= 8:
        frames = frames.T
    if bits != 16:
        raise ValueError("write_wav writes PCM16 only")
    pcm = np.clip(frames.reshape(-1) * 32767.0, -32768, 32767) \
        .astype(np.int16)
    with wave.open(path, "wb") as w:
        w.setnchannels(frames.shape[1])
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(pcm.tobytes())
