"""The C ABI sweep of ``tests/test_interop_sweep.py`` against the PyTorch
port's library (``libbasic_dsp_tpu_torch.so``, built from
``basic_dsp_tpu_torch/csrc/interop/``), on the CPU.

Every ``BDSP_DECLARE``d symbol of ``interop/include/basic_dsp_tpu.h`` is
driven at both precisions over the sweep's flavor menu with its result-code
contract (0, or -1 / 1..14 with a live handle), through the sweep's own
parser and helpers; every exported symbol must be driven, and the
glibc-colliding aliases must behave like the functions they stand for.
"""
import subprocess

import pytest
import torch

import test_interop_sweep as sweep
from test_torch_interop import load_port_lib


@pytest.fixture(scope="module")
def lib():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield load_port_lib()
    torch.set_num_threads(threads)


@pytest.mark.parametrize("X", ["32", "64"])
def test_sweep_every_declared_symbol(lib, X):
    sweep.test_sweep_every_declared_symbol(lib, X)


def test_every_exported_symbol_is_driven(lib):
    nm = subprocess.run(["nm", "-D", "--defined-only", lib._name],
                        capture_output=True, text=True, check=True)
    exported = {line.split()[-1] for line in nm.stdout.splitlines()
                if " T " in line and not line.split()[-1].startswith("_")}
    driven = {name + x for _, name, _a in sweep.parse_declarations()
              for x in ("32", "64")}
    driven |= {"bdsp_init", "bdsp_last_error", "bdsp_free", "bdsp_read_wav",
               "bdsp_write_wav", "powf32", "powf64", "expf32", "expf64"}
    assert not exported - driven, sorted(exported - driven)


@pytest.mark.parametrize("X", ["32", "64"])
def test_glibc_colliding_aliases(lib, X):
    sweep.test_glibc_colliding_aliases(lib, X)
