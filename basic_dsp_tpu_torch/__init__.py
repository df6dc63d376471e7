"""basic_dsp_tpu_torch — the PyTorch/CUDA port of ``basic_dsp_tpu``.

Mirrors the JAX package's module paths (``ops/``, ``kernels/``) and
keeps its public functions' names, arguments and layouts.  Plain tensor
code is PyTorch; each Pallas kernel of the JAX package becomes a kernel
written by hand for the NVIDIA H100 (``csrc/``), built at first use.  A
wrapper launches its kernel for a CUDA tensor and runs its plain PyTorch
version for a CPU tensor.

Ported so far: the flagship FIR + FFT spectrum chain
(:func:`pipelines.fir_fft_chain_planar`, :class:`FirFftChainPlanar`) and
what it runs on, with kernel ``kernels.spectrum_cuda.rowfft_mag`` (and
``rowfft_mag_natural``: K1, then its transpose into spectrum order) and,
with ``fused=True``, ``kernels.spectrum_cuda.fourstep_mag_fused``; and the
convolution family of ``ops.conv_ops`` (the ``convolve_signal`` dispatch,
its planar entry, overlap-save, analytic-function convolution, frequency
multiplication, correlation) with the lookup tables of ``conv_types`` and
kernel ``kernels.overlap_save_cuda.conv_blocks_cuda`` (circular and
linear modes: ``circular_conv_cuda``, ``blocked_linear_conv_cuda``); and the
resampling family of ``ops.interp_ops`` (``interpolatef`` and its
polyphase resampler, ``interpolatei``, ``interpolate``/``interpft``,
``decimatei``, ``interpolate_lin``/``_hermite``) with the modulation chain
(:func:`pipelines.modulation_chain_planar`, :class:`ModulationChainPlanar`)
and kernels ``kernels.resample_cuda.resample_direct_cuda`` and
``resample_rowblock_cuda``; and the channelizer of config #5
(``parallel.channelizer``: ``polyphase_channelizer``, ``fm_demodulate``,
``channelize_and_demod`` and its planar entry,
:class:`ChannelizeAndDemodPlanar`) with kernel
``kernels.channelizer_cuda.channelize_demod_cuda``.  Six kernels of the
JAX package's six, and one of the port's own (K7,
``kernels.fir_cuda.fir_window_cuda``: the chain's FIR and window, which
the JAX chain leaves to XLA), in five CUDA libraries, one per
``csrc/*.cu``.
And the typed core: the vector flavors (:class:`RealTimeVector` …,
:class:`GenDspVector` and its erroneous-state protocol) and their
constructors (``to_real_time_vec`` …), the matrix layer
(:class:`DspMatrix` …, ``convolve_mat``), :class:`Statistics` with
``merge_stats``, the approximations of ``ops.approx_ops``,
:class:`DataDomain`/:class:`NumberSpace` and ``io`` (WAV files); a typed
vector's operations call the ops above, so its ``convolve_signal`` and
``interpolatef`` reach the same kernels.  The flagship chain's ``budget``
keeps the JAX grammar and runs f32-exact under every budget.
Entry points that build tensors (``WindowFunction.sample``,
``interp_ops.polyphase_taps``, :class:`ModulationChainPlanar`, the vector
and matrix constructors given numpy or list data) put them on the card
unless the caller names a device.
Also ``streaming`` (:class:`streaming.StreamingFir` on K3 in linear
mode, :class:`streaming.StreamingResampler` on K4 and K5), ``autotune``
(the dispatch knobs calibrated per device kind, lazily at a typed vector's
first large convolution), ``profiling`` (``time_op``, ``throughput``,
``trace``), and the sharded functions on ``torch.distributed``:
:func:`make_mesh` and ``config.distributed_init``, ``parallel.collectives``
(the halo shifts as point-to-point sends between ring neighbours),
``parallel.sharded`` (``sharded_convolve_signal`` on K3,
``sharded_interpolatef`` on K4 and K5, ``sharded_sum``,
``sharded_statistics``), :func:`sharded_channelize_and_demod` (K6 with
the left neighbour's halo as its look-back prefix), ``parallel.sharded_fft``
(the four-step FFT over all-to-alls), ``parallel.sharded_convolve_mat``
(the MIMO convolution over one reduce-scatter), the mesh-sharded vector
constructors ``to_*_vec_par`` and ``StreamingFir`` over sharded chunks.
A mesh runs on the card over NCCL unless the caller names
``device_type="cpu"`` (gloo).
And the C ABI: ``_interop_support`` with its own native library
``libbasic_dsp_tpu_torch.so`` (``csrc/interop/``, built at first use by
``kernels._build.interop_library``), the repository's C header with the
JAX library's exports, whose 32-bit calls reach K3 and K4 on the card.
"""
from .config import (DspConfig, default_config, make_mesh, matmul_precision,
                     set_default_config, set_matmul_precision)
from .errors import DspError, ErrorReason, PerformanceError
from .conv_types import (ComplexFrequencyLinearTableLookup,
                         ComplexFrequencyResponse, ComplexImpulseResponse,
                         ComplexTimeLinearTableLookup, RaisedCosineFunction,
                         RealFrequencyLinearTableLookup,
                         RealFrequencyResponse, RealImpulseResponse,
                         RealTimeLinearTableLookup, SincFunction)
from .kernels.channelizer_cuda import (channelize_demod_cuda,
                                       channelize_demod_plain)
from .kernels.fir_cuda import fir_window_cuda, fir_window_plain
from .kernels.overlap_save_cuda import (blocked_linear_conv_cuda,
                                        blocked_linear_conv_plain,
                                        circular_conv_cuda,
                                        circular_conv_plain,
                                        overlap_save_cuda)
from .kernels.resample_cuda import (resample_direct_cuda,
                                    resample_direct_plain,
                                    resample_rowblock_cuda,
                                    resample_rowblock_plain)
from .kernels.spectrum_cuda import (dif_spectrum_mag_cuda,
                                    fourstep_mag_fused,
                                    fourstep_mag_fused_plain, natural_flatten,
                                    rowfft_mag, rowfft_mag_natural,
                                    rowfft_mag_natural_plain,
                                    rowfft_mag_plain, supported)
from .ops import conv_ops, fft_ops, fourstep, interp_ops, reorg_ops
from . import parallel
from .parallel import (ChannelizeAndDemodPlanar, channelize_and_demod,
                       channelize_and_demod_planar, fm_demodulate,
                       polyphase_channelizer, sharded_channelize_and_demod)
from .pipelines import (FirFftChainPlanar, ModulationChainPlanar,
                        fir_fft_chain, fir_fft_chain_planar,
                        modulation_chain_planar, windowed_spectrum)
from .state import from_numpy
from .windows import (BlackmanHarrisWindow, HammingWindow,
                      RectangularWindow, TriangularWindow, WindowFunction)
from .meta import DataDomain, NumberSpace
from .ops import approx_ops, stats_ops
from .ops.stats_ops import (STATS_VEC_CAPACITY, Statistics, merge_stats,
                            merge_stats_cols)
from .vector import (ComplexFreqVector, ComplexTimeVector, DspVector,
                     GenDspVector, RealFreqVector, RealTimeVector,
                     interleave_to_complex_freq_vec,
                     interleave_to_complex_time_vec, to_complex_freq_vec,
                     to_complex_freq_vec_par, to_complex_time_vec,
                     to_complex_time_vec_par, to_gen_dsp_vec,
                     to_real_freq_vec, to_real_freq_vec_par,
                     to_real_time_vec, to_real_time_vec_par)
from .matrix import (ComplexFreqMatrix, ComplexTimeMatrix, DspMatrix,
                     GenDspMatrix, RealFreqMatrix, RealTimeMatrix, from_rows,
                     to_complex_freq_mat, to_complex_time_mat, to_gen_dsp_mat,
                     to_mat, to_real_freq_mat, to_real_time_mat)
from . import autotune
from . import io

__version__ = "0.1.0"

__all__ = [
    "BlackmanHarrisWindow", "ChannelizeAndDemodPlanar",
    "ComplexFreqMatrix", "ComplexFreqVector",
    "ComplexFrequencyLinearTableLookup",
    "ComplexFrequencyResponse", "ComplexImpulseResponse",
    "ComplexTimeLinearTableLookup", "ComplexTimeMatrix", "ComplexTimeVector",
    "DataDomain", "DspConfig", "DspError", "DspMatrix", "DspVector",
    "ErrorReason", "FirFftChainPlanar", "GenDspMatrix", "GenDspVector",
    "HammingWindow", "ModulationChainPlanar", "NumberSpace",
    "PerformanceError", "RaisedCosineFunction", "RealFreqMatrix",
    "RealFreqVector", "RealFrequencyLinearTableLookup",
    "RealFrequencyResponse", "RealImpulseResponse",
    "RealTimeLinearTableLookup", "RealTimeMatrix", "RealTimeVector",
    "RectangularWindow", "STATS_VEC_CAPACITY", "SincFunction", "Statistics",
    "TriangularWindow", "WindowFunction", "approx_ops", "from_rows",
    "interleave_to_complex_freq_vec", "interleave_to_complex_time_vec",
    "autotune", "io", "make_mesh", "merge_stats", "merge_stats_cols",
    "stats_ops",
    "to_complex_freq_mat", "to_complex_freq_vec", "to_complex_freq_vec_par",
    "to_complex_time_mat", "to_complex_time_vec", "to_complex_time_vec_par",
    "to_gen_dsp_mat", "to_gen_dsp_vec", "to_mat", "to_real_freq_mat",
    "to_real_freq_vec", "to_real_freq_vec_par", "to_real_time_mat",
    "to_real_time_vec", "to_real_time_vec_par",
    "blocked_linear_conv_cuda", "blocked_linear_conv_plain",
    "channelize_and_demod", "channelize_and_demod_planar",
    "channelize_demod_cuda", "channelize_demod_plain",
    "circular_conv_cuda", "circular_conv_plain", "conv_ops",
    "default_config", "dif_spectrum_mag_cuda", "fft_ops", "fir_fft_chain",
    "fir_fft_chain_planar", "fir_window_cuda", "fir_window_plain",
    "fm_demodulate", "fourstep",
    "fourstep_mag_fused", "fourstep_mag_fused_plain", "from_numpy",
    "interp_ops", "matmul_precision", "modulation_chain_planar",
    "natural_flatten", "overlap_save_cuda", "parallel",
    "polyphase_channelizer", "reorg_ops", "resample_direct_cuda",
    "resample_direct_plain", "resample_rowblock_cuda",
    "resample_rowblock_plain", "rowfft_mag", "rowfft_mag_natural",
    "rowfft_mag_natural_plain", "rowfft_mag_plain",
    "set_default_config", "set_matmul_precision",
    "sharded_channelize_and_demod", "supported",
    "windowed_spectrum",
]
