"""WAV I/O, the data-loading path (counterpart of ``basic_dsp_tpu/io.py``).

Reads and writes RIFF/WAVE files in numpy on the host, with the format
rules of the native reader and writer of the C interop library
(``interop/src/wavio.cpp``, which the port's own library also exports):
PCM16, PCM32 and IEEE float32 samples in, PCM16 (rounded half to even,
clipped to [-1, 1]) and IEEE float32 out.  Frames are (frames, channels)
float32 arrays in [-1, 1].  A WAV file is host data, so nothing here
touches a device.
"""
from __future__ import annotations

import struct
from typing import Tuple

import numpy as np

_PCM, _IEEE_FLOAT = 1, 3


def _decode(fmt: int, bits: int, raw: bytes, total: int) -> np.ndarray:
    """``total`` samples of ``raw`` as float32 in [-1, 1]."""
    if fmt == _PCM and bits == 16:
        return np.frombuffer(raw, "<i2", total).astype(np.float32) / 32768.0
    if fmt == _PCM and bits == 32:
        # the native reader divides in double, then rounds to float
        return (np.frombuffer(raw, "<i4", total).astype(np.float64)
                / 2147483648.0).astype(np.float32)
    if fmt == _IEEE_FLOAT and bits == 32:
        return np.frombuffer(raw, "<f4", total).astype(np.float32)
    raise ValueError(f"unsupported WAV sample format {fmt} at {bits} bits "
                     f"(PCM16, PCM32 and IEEE float32 are read)")


def read_wav(path: str) -> Tuple[np.ndarray, int]:
    """Returns ((frames, channels) float32 in [-1, 1], sample_rate) of a
    PCM16, PCM32 or IEEE-float32 file.  Chunks other than ``fmt `` and
    ``data`` are skipped with their pad byte."""
    with open(path, "rb") as f:
        blob = f.read()
    if blob[0:4] != b"RIFF" or blob[8:12] != b"WAVE":
        raise ValueError(f"{path}: not a RIFF/WAVE file")
    fmt = channels = bits = rate = 0
    pos = 12
    while pos + 8 <= len(blob):
        tag = blob[pos:pos + 4]
        size, = struct.unpack_from("<I", blob, pos + 4)
        pos += 8
        if tag == b"fmt ":
            fmt, channels, rate, _, _, bits = struct.unpack_from(
                "<HHIIHH", blob, pos)
        elif tag == b"data":
            if channels == 0 or bits == 0:
                break
            total = size // (bits // 8)
            raw = blob[pos:pos + size]
            if len(raw) != size:
                break
            frames = total // channels
            data = _decode(fmt, bits, raw, total)[:frames * channels]
            return data.reshape(frames, channels), rate
        pos += size + (size & 1)
    raise ValueError(f"{path}: no readable fmt and data chunks")


def write_wav(path: str, frames: np.ndarray, rate: int,
              bits: int = 16) -> None:
    """Writes (frames, channels) float32 in [-1, 1] as PCM16 (``bits=16``,
    clipped to [-1, 1] and rounded half to even) or IEEE float32
    (``bits=32``, the samples as they are); a (channels, frames) array with
    at most 8 channels is accepted too."""
    frames = np.atleast_2d(np.asarray(frames, dtype=np.float32))
    if frames.shape[0] < frames.shape[1] and frames.shape[0] <= 8:
        frames = frames.T
    if bits not in (16, 32):
        raise ValueError("write_wav writes PCM16 (bits=16) or IEEE float32 "
                         "(bits=32)")
    flat = frames.reshape(-1)
    if bits == 16:
        samples = np.rint(np.clip(flat, -1.0, 1.0) * np.float32(32767.0)
                          ).astype("<i2")
    else:
        samples = flat.astype("<f4")
    n_channels, width = frames.shape[1], bits // 8
    data = samples.tobytes()
    header = struct.pack(
        "<4sI4s4sIHHIIHH4sI", b"RIFF", (36 + len(data)) & 0xFFFFFFFF,
        b"WAVE", b"fmt ", 16, _IEEE_FLOAT if bits == 32 else _PCM,
        n_channels, rate, (rate * n_channels * width) & 0xFFFFFFFF,
        n_channels * width, bits, b"data", len(data) & 0xFFFFFFFF)
    with open(path, "wb") as f:
        f.write(header + data)
