"""Functional ops on torch tensors (counterpart of basic_dsp_tpu/ops)."""
