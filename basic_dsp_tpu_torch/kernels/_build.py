"""Build-and-load for the hand-written CUDA kernels and the C ABI library.

Each ``csrc/<name>.cu`` has a plain C interface.  At first use it is
compiled with ``nvcc`` for Hopper (``sm_90a``) into a shared library under
``basic_dsp_tpu_torch/_build/`` (git-ignored) and loaded with ``ctypes``.
The library's file name carries a hash of the source and of every header
``csrc/*.cuh`` (the shared FFT core lives in one), so an edited source or
header is rebuilt and a stale library is never loaded.

The C ABI library, ``libbasic_dsp_tpu_torch.so``, is compiled from
``csrc/interop/*.cpp`` with the host C++ compiler against the repository's
C header (``interop/include/basic_dsp_tpu.h``) and the running Python's
libpython (:func:`interop_library`), into a directory of ``_build/`` keyed
the same way.  Nothing is built when the package is imported.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shlex
import shutil
import site
import subprocess
import sys
import sysconfig
import time
from pathlib import Path
from typing import List, Tuple

import torch
import torch.autograd.profiler as _autograd_profiler

from .. import profiling

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

INTEROP_INCLUDE = _PKG.parent / "interop" / "include"
INTEROP_LIB = "libbasic_dsp_tpu_torch.so"

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


def _interop_flags() -> Tuple[List[str], List[str]]:
    """The host compiler's command for the C ABI library (compiler and
    compile flags) and its link flags.  Raises for a Python without a shared
    libpython: a C program that links the library hosts the interpreter
    through it."""
    cfg = sysconfig.get_config_vars()
    ldlib = cfg.get("LDLIBRARY") or ""
    if not cfg.get("Py_ENABLE_SHARED") or not ldlib.endswith(".so"):
        raise RuntimeError(
            f"this Python ({sys.executable}) has no shared libpython "
            f"(Py_ENABLE_SHARED {cfg.get('Py_ENABLE_SHARED')!r}, LDLIBRARY "
            f"{ldlib!r}): the C ABI library links libpython so that a C "
            f"program can host the interpreter, and cannot be built for it")
    cxx = shlex.split(cfg.get("CXX") or "")
    if not cxx or shutil.which(cxx[0]) is None:
        cxx = ["c++"]
    compile_flags = [
        *cxx, "-std=c++17", "-O2", "-shared", "-fPIC",
        f"-I{sysconfig.get_paths()['include']}", f"-I{INTEROP_INCLUDE}",
        f'-DBDSP_REPO_ROOT="{_PKG.parent}"',
        f'-DBDSP_SITE_PACKAGES="{":".join(site.getsitepackages())}"']
    libdir = cfg["LIBDIR"]
    link_flags = [f"-L{libdir}", f"-l{ldlib[3:-3]}", f"-Wl,-rpath,{libdir}"]
    return compile_flags, link_flags


@functools.cache
def interop_library() -> Path:
    """Builds ``libbasic_dsp_tpu_torch.so``, the port's C ABI, from
    ``csrc/interop/*.cpp`` if it is missing, and returns its path: under
    ``_build/``, in a directory keyed by the sources, the C header, the
    flags (the repository root and site-packages baked in among them) and
    the Python version.  A failed build raises with the compiler's
    output."""
    compile_flags, link_flags = _interop_flags()
    sources = sorted((CSRC / "interop").glob("*.cpp"))
    h = hashlib.sha256()
    for path in [*sources, INTEROP_INCLUDE / "basic_dsp_tpu.h"]:
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    h.update("\0".join([*compile_flags, *link_flags, sys.version]).encode())
    so = BUILD_DIR / f"interop_{h.hexdigest()[:16]}" / INTEROP_LIB
    if not so.exists():
        so.parent.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        proc = subprocess.run(
            [*compile_flags, "-o", str(tmp), *map(str, sources), *link_flags],
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"the C ABI library failed to build:\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, so)   # atomic: a concurrent loader sees all or none
    return so


def interop_c_flags() -> List[str]:
    """What a C program needs to compile and link against the C ABI
    library (building it first): the header's directory, the library and
    an rpath to it."""
    lib_dir = interop_library().parent
    return [f"-I{INTEROP_INCLUDE}", f"-L{lib_dir}", "-lbasic_dsp_tpu_torch",
            f"-Wl,-rpath,{lib_dir}"]


_RAW_STREAM = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def _raw_stream(index: int) -> int:
    """The raw handle of the current stream of CUDA device ``index``."""
    if _RAW_STREAM is not None:
        return _RAW_STREAM(index)
    return torch.cuda.current_stream(index).cuda_stream


def refuse_grad(kernel: str, *inputs) -> None:
    """Raises ``RuntimeError`` when grad mode is on and any tensor of
    ``inputs`` (tensors, None or tuples of them) requires grad.  A kernel
    writes into a tensor it allocates through a raw pointer, so its result
    has no ``grad_fn``: a loss through it would get a wrong or no gradient
    without a word.  The kernels have no backward, as the JAX package's
    Pallas kernels have none; the wrappers call this before a launch."""
    if not torch.is_grad_enabled():
        return
    stack = list(inputs)
    while stack:
        t = stack.pop()
        if isinstance(t, (tuple, list)):
            stack.extend(t)
        elif isinstance(t, torch.Tensor) and t.requires_grad:
            raise RuntimeError(
                f"{kernel}: the CUDA kernel has no backward (as the JAX "
                f"package's Pallas kernels have none), and an input "
                f"requires grad; run it under torch.no_grad(), or on the "
                f"CPU, where its plain version differentiates")


def aligned(p: torch.Tensor) -> torch.Tensor:
    """``p`` contiguous at a 16-byte aligned address, for a kernel that
    reads it in 16-byte pieces (cp.async, float4): a copy only where it is
    not (a view at an odd offset)."""
    p = p.contiguous()
    return p if p.data_ptr() % 16 == 0 else p.clone()


def check_launch(name: str, error_string, rc: int) -> None:
    """Raises ``RuntimeError`` where a C entry returned a code other than
    0, with the kernel's ``name`` and ``error_string(rc)``, the library's
    text for the code."""
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: "
                           + error_string(rc).decode())


def count_launch(wrapper) -> None:
    """Adds one to ``wrapper.launches`` unless the current stream is
    capturing a CUDA graph: a wrapper called then records its kernel into
    the graph and launches nothing, and a replay launches without entering
    the wrapper."""
    if not torch.cuda.is_current_stream_capturing():
        wrapper.launches += 1


def launch(dev, fn, *args) -> int:
    """Calls the C entry ``fn(*args, stream)``, ``stream`` the current
    stream of ``dev``, and returns its code.  Enters ``dev``'s device
    context only when ``dev`` is not the current device; builds no Stream
    object.  While a profiler is active, the call's host ns (the device
    lookup, the stream and the C entry) go to the open kernel span's
    ``launch_ns`` (``profiling.launched``); off, one flag check."""
    if not _autograd_profiler._is_profiler_enabled:
        return _launch(dev, fn, args)
    start = time.perf_counter_ns()
    rc = _launch(dev, fn, args)
    profiling.launched(start)
    return rc


def _launch(dev, fn, args) -> int:
    current = torch.cuda.current_device()
    index = current if dev.index is None else dev.index
    if index == current:
        return fn(*args, _raw_stream(index))
    with torch.cuda.device(index):
        return fn(*args, _raw_stream(index))


def call(fn, *args) -> int:
    """Calls the C entry ``fn(*args)``, its arguments (the stream among
    them) resolved by the caller, and returns its code: :func:`launch`'s
    call, timed the same way while a profiler is active."""
    if not _autograd_profiler._is_profiler_enabled:
        return fn(*args)
    start = time.perf_counter_ns()
    rc = fn(*args)
    profiling.launched(start)
    return rc
