"""Build-and-load for the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface.  At first use it is
compiled with ``nvcc`` for Hopper (``sm_90a``) into a shared library under
``basic_dsp_tpu_torch/_build/`` (git-ignored) and loaded with ``ctypes``.
The library's file name carries a hash of the source and of every header
``csrc/*.cuh`` (the shared FFT core lives in one), so an edited source or
header is rebuilt and a stale library is never loaded.  Nothing is built
when the package is imported.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME or put nvcc on PATH)")
    return found


def library_path(name: str, csrc: Path = CSRC) -> Path:
    """Where the library built from ``<csrc>/<name>.cu`` lives: keyed by
    the source, every ``*.cuh`` header beside it and the flags."""
    h = hashlib.sha256((csrc / f"{name}.cu").read_bytes())
    for header in sorted(csrc.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """Builds ``csrc/<name>.cu`` if its library is missing, then loads it."""
    so = library_path(name)
    if not so.exists():
        BUILD_DIR.mkdir(exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed to build {name}.cu:\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, so)   # atomic: a concurrent loader sees all or none
    return ctypes.CDLL(str(so))


_RAW_STREAM = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def _raw_stream(index: int) -> int:
    """The raw handle of the current stream of CUDA device ``index``."""
    if _RAW_STREAM is not None:
        return _RAW_STREAM(index)
    return torch.cuda.current_stream(index).cuda_stream


def aligned(p: torch.Tensor) -> torch.Tensor:
    """``p`` contiguous at a 16-byte aligned address, for a kernel that
    reads it in 16-byte pieces (cp.async, float4): a copy only where it is
    not (a view at an odd offset)."""
    p = p.contiguous()
    return p if p.data_ptr() % 16 == 0 else p.clone()


def launch(dev, fn, *args) -> int:
    """Calls the C entry ``fn(*args, stream)``, ``stream`` the current
    stream of ``dev``, and returns its code.  Enters ``dev``'s device
    context only when ``dev`` is not the current device; builds no Stream
    object."""
    current = torch.cuda.current_device()
    index = current if dev.index is None else dev.index
    if index == current:
        return fn(*args, _raw_stream(index))
    with torch.cuda.device(index):
        return fn(*args, _raw_stream(index))
