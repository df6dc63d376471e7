"""Seconds from the start of the run to the start of the window: imports,
the CUDA context, the capture pool, the entry's constants, the kernels'
build or load and the warm-up at the cell's shapes (host clock)."""
UNIT = "s"
END_TO_END = True


def read(t):
    return t.setup_s
