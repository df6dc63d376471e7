"""Runtime configuration of the PyTorch port.

Counterpart of ``basic_dsp_tpu/config.py``: the dispatch thresholds of
``DspConfig`` and the matmul-precision dial.  There are no kernel gates:
a wrapper launches its CUDA kernel for a CUDA tensor and runs its plain
PyTorch version for a CPU tensor, so the tensor's device picks the path.
"""
from __future__ import annotations

import dataclasses
import os

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
