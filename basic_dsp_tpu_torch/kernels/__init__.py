"""Hand-written CUDA kernels for the NVIDIA H100, each with its plain
PyTorch version (counterpart of basic_dsp_tpu/kernels).

A wrapper runs the plain version on a CPU tensor, which differentiates,
and launches its kernel on a CUDA tensor.  The kernels have no backward,
as the JAX package's Pallas kernels have none: under grad mode a wrapper
given a CUDA input that requires grad raises (``_build.refuse_grad``)
rather than return a result that autograd cannot see through."""


def wrappers() -> dict:
    """The kernel wrappers by kernel: K1 to K6 (the JAX package's six
    Pallas kernels, in the order of the port's records), K7 (the chain's
    FIR and window) and K8 (the unfused chain's stage 1), which the JAX
    package leaves to XLA, and K1n, K1's entry in natural spectrum order
    (K1, then its transpose; the unfused chain's row stage).  Each counts
    the kernels it launches in its ``launches`` attribute."""
    from . import channelizer_cuda, fir_cuda, overlap_save_cuda
    from . import resample_cuda, spectrum_cuda
    return {"K1": spectrum_cuda.rowfft_mag,
            "K2": spectrum_cuda.fourstep_mag_fused,
            "K3": overlap_save_cuda.conv_blocks_cuda,
            "K4": resample_cuda.resample_direct_cuda,
            "K5": resample_cuda.resample_rowblock_cuda,
            "K6": channelizer_cuda.channelize_demod_cuda,
            "K7": fir_cuda.fir_window_cuda,
            "K8": spectrum_cuda.stage1_cuda,
            "K1n": spectrum_cuda.rowfft_mag_natural}


def launch_counts() -> dict:
    """Each kernel's launches since its count was last set to 0."""
    return {k: fn.launches for k, fn in wrappers().items()}


def reset_launch_counts() -> None:
    for fn in wrappers().values():
        fn.launches = 0
