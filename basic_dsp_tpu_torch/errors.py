"""Error reasons and exceptions (counterpart of
``basic_dsp_tpu/errors.py``).

Mirrors the reference error contract (basic_dsp checks_and_results.rs:3-65):
a typed enumeration of failure reasons carried by :class:`DspError`.
"""
from __future__ import annotations

import enum


class ErrorReason(enum.Enum):
    """All error reasons, mirroring reference checks_and_results.rs:3-65."""

    INPUT_MUST_HAVE_THE_SAME_SIZE = "InputMustHaveTheSameSize"
    INPUT_META_DATA_MUST_AGREE = "InputMetaDataMustAgree"
    INPUT_MUST_BE_COMPLEX = "InputMustBeComplex"
    INPUT_MUST_BE_REAL = "InputMustBeReal"
    INPUT_MUST_BE_IN_TIME_DOMAIN = "InputMustBeInTimeDomain"
    INPUT_MUST_BE_IN_FREQUENCY_DOMAIN = "InputMustBeInFrequencyDomain"
    INVALID_ARGUMENT_LENGTH = "InvalidArgumentLength"
    INPUT_MUST_BE_CONJ_SYMMETRIC = "InputMustBeConjSymmetric"
    INPUT_MUST_HAVE_AN_ODD_LENGTH = "InputMustHaveAnOddLength"
    ARGUMENT_FUNCTION_MUST_BE_SYMMETRIC = "ArgumentFunctionMustBeSymmetric"
    INVALID_NUMBER_OF_ARGUMENTS_FOR_COMBINED_OP = (
        "InvalidNumberOfArgumentsForCombinedOp"
    )
    INPUT_MUST_NOT_BE_EMPTY = "InputMustNotBeEmpty"
    INPUT_MUST_HAVE_AN_EVEN_LENGTH = "InputMustHaveAnEvenLength"
    TYPE_CAN_NOT_RESIZE = "TypeCanNotResize"


class DspError(Exception):
    """Exception carrying an :class:`ErrorReason`, raised where the
    reference returns ``Err(ErrorReason)``."""

    def __init__(self, reason: ErrorReason, message: str = ""):
        self.reason = reason
        super().__init__(f"{reason.value}: {message}" if message else reason.value)


class PerformanceError(RuntimeError):
    """Raised instead of a slow-path warning when
    ``DspConfig.fail_on_slow_path`` is set: the op would take a path the
    library documents as slow (the per-sample gather windows of
    ``interpolatef`` for factors with no polyphase form).  Repo-added
    production guard; the reference has no analog."""
