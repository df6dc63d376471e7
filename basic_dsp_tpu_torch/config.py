"""Runtime configuration of the PyTorch port.

Counterpart of ``basic_dsp_tpu/config.py``: the dispatch thresholds of
``DspConfig``, the matmul-precision dial, and the device mesh of the
sharded functions (:func:`make_mesh`, :func:`distributed_init`) on
``torch.distributed``.  There are no kernel gates: a wrapper launches its
CUDA kernel for a CUDA tensor and runs its plain PyTorch version for a CPU
tensor, so the tensor's device picks the path.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DspConfig:
    """Dispatch thresholds (see ``basic_dsp_tpu.config.DspConfig``).

    Attributes:
      overlap_save_min_len: signal length above which ``convolve_signal``
        switches from one big FFT to the blocked overlap-save pipeline.
      overlap_save_min_imp_len: minimum impulse-response length for the
        blocked path.
      overlap_save_len_ratio: ``len > ratio * imp_len`` gate.
      direct_conv_max_imp_len: kernel lengths up to this use the direct
        (Toeplitz matmul) path rather than FFT.
      direct_conv_min_len: signal length above which the direct path is
        taken.
      fft_block_len: 0 = auto blocked-FFT length.
      fail_on_slow_path: when True, ``interp_ops.interpolatef`` raises
        :class:`errors.PerformanceError` instead of warning when a long
        signal would take the per-sample gather path.
    """

    overlap_save_min_len: int = 10_000
    overlap_save_min_imp_len: int = 15
    overlap_save_len_ratio: int = 10
    direct_conv_max_imp_len: int = 202
    direct_conv_min_len: int = 1_000
    fft_block_len: int = 0
    fail_on_slow_path: bool = False


def resolve_device(device) -> torch.device:
    """The device an entry point builds its tensors on: the card
    (``torch.device("cuda")``) unless the caller names one.  Without CUDA
    the default raises; it never falls back to the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: entry points run on the card by "
                           "default; pass device='cpu' to run on the CPU")
    return torch.device("cuda")


_default_config = DspConfig()


def default_config() -> DspConfig:
    return _default_config


def set_default_config(cfg: DspConfig) -> None:
    """Installs ``cfg`` as the process default; the dispatch reads it at
    each call."""
    global _default_config
    _default_config = cfg


# The dial's three settings map onto PyTorch's float32 matmul precision:
# "highest" keeps full f32 products (the reference's f32-exact contract),
# "high" allows TF32 or bf16x3, "default" allows bf16.
_TORCH_PRECISION = {"highest": "highest", "high": "high", "default": "medium"}

_matmul_precision = os.environ.get("BDSP_MATMUL_PRECISION", "highest")
if _matmul_precision not in _TORCH_PRECISION:
    _matmul_precision = "highest"


def matmul_precision() -> str:
    return _matmul_precision


def set_matmul_precision(precision: str) -> None:
    """Sets the matmul precision: "highest" | "high" | "default"."""
    if precision not in _TORCH_PRECISION:
        raise ValueError("precision must be 'highest', 'high' or 'default'")
    global _matmul_precision
    _matmul_precision = precision
    torch.set_float32_matmul_precision(_TORCH_PRECISION[precision])


# TF32 off, explicitly, for cuBLAS and cuDNN: PyTorch enables TF32 for
# cuDNN convolutions by default, and TF32 keeps ~3 decimal digits, which
# would break the f32-exact grade without any CPU test noticing.  The
# dial is applied after this, so an opt-in "high"/"default" still reaches
# cuBLAS through torch.set_float32_matmul_precision (cuDNN stays off).
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
set_matmul_precision(_matmul_precision)


def _mesh_device_type(device_type: Optional[str]) -> str:
    """The device type of a mesh: "cuda" (NCCL) unless the caller names
    "cpu" (gloo).  The default raises without CUDA; it never carries on
    over gloo."""
    if device_type is None:
        device_type = "cuda"
    if device_type not in ("cuda", "cpu"):
        raise ValueError(f"device_type must be 'cuda' or 'cpu', got "
                         f"{device_type!r}")
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: meshes run on the card over NCCL "
                           "by default; pass device_type='cpu' for a gloo "
                           "mesh on the CPU")
    return device_type


_BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def make_mesh(n_devices: Optional[int] = None,
              axis_name: str = "dsp",
              shape: Optional[Tuple[int, ...]] = None,
              axis_names: Tuple[str, ...] = ("host", "chip"),
              device_type: Optional[str] = None):
    """The device mesh over which long signals and channels shard: a
    ``torch.distributed.device_mesh.DeviceMesh`` over the ranks of the
    initialized process group, one device a rank.

    Two forms, as in the JAX package:

    * ``make_mesh(n)``: a 1-D mesh of ranks 0..n-1 (all ranks when None),
      axis ``axis_name``;
    * ``make_mesh(shape=(H, C))``: a hierarchical ``(host, chip)`` mesh of
      H x C ranks, axes ``axis_names`` outermost-first, rank h*C + c at
      (h, c).  The sharded functions shard over every mesh axis,
      host-major, so the same call works on either form.

    ``device_type`` "cuda" (the default; raises without CUDA) needs an
    NCCL process group, "cpu" a gloo one: a mesh never runs over another
    backend than its device's.  Every rank of the group calls this with
    the same arguments."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    device_type = _mesh_device_type(device_type)
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: torch.distributed is not initialized; "
                           "call config.distributed_init (or "
                           "torch.distributed.init_process_group) in every "
                           "process first")
    backend = str(dist.get_backend())
    if _BACKENDS[device_type] not in backend:
        raise RuntimeError(f"make_mesh: a {device_type} mesh needs the "
                           f"{_BACKENDS[device_type]} backend; the process "
                           f"group runs {backend}")
    world = dist.get_world_size()
    if shape is not None:
        total = int(np.prod(shape))
        if world < total:
            raise ValueError(f"mesh shape {shape} needs {total} devices, "
                             f"only {world} visible")
        if len(shape) != len(axis_names):
            raise ValueError("shape and axis_names must have equal length")
        return DeviceMesh(device_type, torch.arange(total).reshape(shape),
                          mesh_dim_names=tuple(axis_names))
    n = world if n_devices is None else min(int(n_devices), world)
    return DeviceMesh(device_type, torch.arange(n),
                      mesh_dim_names=(axis_name,))


def distributed_init(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     device_type: Optional[str] = None) -> None:
    """Initializes ``torch.distributed`` so that :func:`make_mesh` spans
    every process: one process a device, NCCL for "cuda" (the default;
    raises without CUDA), gloo for "cpu".  ``coordinator_address``
    ("host:port") is rank 0's TCP store; None reads ``MASTER_ADDR`` /
    ``MASTER_PORT``, and a None count or id ``WORLD_SIZE`` / ``RANK``
    (``env://``).  A CUDA process takes device ``LOCAL_RANK`` where the
    environment sets it (torchrun's contract: the rank's index on its
    host), else ``rank % device_count()``.  Call once per process before
    building a mesh."""
    import torch.distributed as dist

    device_type = _mesh_device_type(device_type)
    init_method = (f"tcp://{coordinator_address}" if coordinator_address
                   else "env://")
    dist.init_process_group(
        _BACKENDS[device_type], init_method=init_method,
        world_size=-1 if num_processes is None else int(num_processes),
        rank=-1 if process_id is None else int(process_id))
    if device_type == "cuda":
        torch.cuda.set_device(local_device_index(dist.get_rank()))


def local_device_index(rank: int) -> int:
    """The card a rank takes: ``LOCAL_RANK`` where the environment sets it,
    else ``rank % device_count()`` (one device count on the CPU)."""
    local = os.environ.get("LOCAL_RANK")
    if local is not None:
        return int(local)
    return rank % max(torch.cuda.device_count(), 1)


def free_port() -> int:
    """A TCP port on localhost that is free now, for a process group's
    store."""
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def spawn_ranks(fn, args: tuple, nprocs: int, timeout: float) -> None:
    """Runs ``fn(i, *args)`` for i < ``nprocs`` in as many spawned
    processes, one a rank, and waits for every one.  The first failure
    terminates the others and raises; past ``timeout`` seconds every
    process still running is killed and ``TimeoutError`` raised."""
    import time

    import torch.multiprocessing as mp

    ctx = mp.start_processes(fn, args=args, nprocs=nprocs, join=False,
                             start_method="spawn")
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()
            raise TimeoutError(f"{nprocs} ranks of {fn.__qualname__}: still "
                               f"running after {timeout} s, killed")


def device_name(dev: torch.device) -> str:
    """The card's name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them, or
    "cpu (gloo)" for the CPU."""
    if dev.type != "cuda":
        return "cpu (gloo)"
    import subprocess
    index = torch.cuda.current_device() if dev.index is None else dev.index
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "-i", str(index)],
        capture_output=True, text=True, check=True).stdout.strip()
