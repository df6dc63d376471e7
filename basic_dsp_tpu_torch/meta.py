"""Domain and number-space metadata (counterpart of
``basic_dsp_tpu/meta.py``).

The reference encodes these as zero-sized marker types checked at compile
time (meta.rs:4-92) plus runtime-tracked variants for generic vectors.  In
Python the markers become enums carried on each vector; the distinct
vector classes (``RealTimeVector`` …) give the same early errors.
"""
from __future__ import annotations

import enum


class DataDomain(enum.Enum):
    """Domain of a data vector (reference vector_types/mod.rs:57-63)."""

    TIME = "Time"
    FREQUENCY = "Frequency"


class NumberSpace(enum.Enum):
    """Real or complex number space (reference meta.rs:4-46)."""

    REAL = "Real"
    COMPLEX = "Complex"
