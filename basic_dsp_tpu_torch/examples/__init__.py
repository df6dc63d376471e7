"""The repository's user examples (``examples/``), ported to PyTorch.

Each module is the twin of the JAX example of the same name: the same
arguments and outputs, plus ``device`` (None: the card, which raises
without CUDA; the tests pass "cpu").  Run one as

    python3 -m basic_dsp_tpu_torch.examples.<name> [arguments]

They are imported only as ``basic_dsp_tpu_torch.examples.<name>``; the
JAX examples' bare module names (``crosstalk``, ``modulation``) belong to
the JAX side.  ``bench_tables`` (the per-op size sweep, CSV) and
``plot_csv_data`` (its plot, with matplotlib) are twins too.
"""
