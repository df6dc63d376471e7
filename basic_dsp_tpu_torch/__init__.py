"""basic_dsp_tpu_torch — the PyTorch/CUDA port of ``basic_dsp_tpu``.

Mirrors the JAX package's module paths (``ops/``, ``kernels/``) and
keeps its public functions' names, arguments and layouts.  Plain tensor
code is PyTorch; each Pallas kernel of the JAX package becomes a kernel
written by hand for the NVIDIA H100 (``csrc/``), built at first use.  A
wrapper launches its kernel for a CUDA tensor and runs its plain PyTorch
version for a CPU tensor.

Ported so far: the flagship FIR + FFT spectrum chain
(:func:`pipelines.fir_fft_chain_planar`, :class:`FirFftChainPlanar`) and
what it runs on, with kernel ``kernels.spectrum_cuda.rowfft_mag``; and the
convolution family of ``ops.conv_ops`` (the ``convolve_signal`` dispatch,
its planar entry, overlap-save, analytic-function convolution, frequency
multiplication, correlation) with the lookup tables of ``conv_types`` and
kernel ``kernels.overlap_save_cuda.blocked_linear_conv_cuda``.
"""
from .config import (DspConfig, default_config, matmul_precision,
                     set_default_config, set_matmul_precision)
from .conv_types import (ComplexFrequencyLinearTableLookup,
                         ComplexFrequencyResponse, ComplexImpulseResponse,
                         ComplexTimeLinearTableLookup, RaisedCosineFunction,
                         RealFrequencyLinearTableLookup,
                         RealFrequencyResponse, RealImpulseResponse,
                         RealTimeLinearTableLookup, SincFunction)
from .kernels.overlap_save_cuda import (blocked_linear_conv_cuda,
                                        blocked_linear_conv_plain,
                                        overlap_save_cuda)
from .kernels.spectrum_cuda import (dif_spectrum_mag_cuda, natural_flatten,
                                    rowfft_mag, rowfft_mag_plain, supported)
from .ops import conv_ops, fft_ops, fourstep, reorg_ops
from .pipelines import (FirFftChainPlanar, fir_fft_chain,
                        fir_fft_chain_planar, windowed_spectrum)
from .state import from_numpy
from .windows import (BlackmanHarrisWindow, HammingWindow,
                      RectangularWindow, TriangularWindow, WindowFunction)

__all__ = [
    "BlackmanHarrisWindow", "ComplexFrequencyLinearTableLookup",
    "ComplexFrequencyResponse", "ComplexImpulseResponse",
    "ComplexTimeLinearTableLookup", "DspConfig", "FirFftChainPlanar",
    "HammingWindow", "RaisedCosineFunction",
    "RealFrequencyLinearTableLookup", "RealFrequencyResponse",
    "RealImpulseResponse", "RealTimeLinearTableLookup", "RectangularWindow",
    "SincFunction", "TriangularWindow", "WindowFunction",
    "blocked_linear_conv_cuda", "blocked_linear_conv_plain", "conv_ops",
    "default_config", "dif_spectrum_mag_cuda", "fft_ops", "fir_fft_chain",
    "fir_fft_chain_planar", "fourstep", "from_numpy", "matmul_precision",
    "natural_flatten", "overlap_save_cuda", "reorg_ops", "rowfft_mag",
    "rowfft_mag_plain", "set_default_config", "set_matmul_precision",
    "supported", "windowed_spectrum",
]
