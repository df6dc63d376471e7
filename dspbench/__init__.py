"""The benchmark of ``basic_dsp_tpu_torch`` on NVIDIA H100 cards: one
command runs one cell once and prints one JSON line (``run.py``)."""
