"""Hand-written CUDA kernels for the NVIDIA H100, each with its plain
PyTorch version (counterpart of basic_dsp_tpu/kernels)."""
