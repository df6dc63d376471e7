"""PyTorch port, ops/approx_ops (the reference's fast-math polynomial
family, basic_dsp_tpu_torch/ops/approx_ops.py) against the JAX package's
(basic_dsp_tpu/ops/approx_ops.py) on the same seeded data, formula for
formula: float32 results to 1e-6 relative to the maximum (both evaluate
the same float32 polynomials), and against the exact functions at the
bounds of tests/test_elementary.py's ``test_approx_ops``; and the vector
methods that call them."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import basic_dsp_tpu as bd
from basic_dsp_tpu.ops import approx_ops as jax_approx
import basic_dsp_tpu_torch as bt
from basic_dsp_tpu_torch.ops import approx_ops as torch_approx

POS = np.abs(np.random.default_rng(5).uniform(-10, 10, 1000)) + 1.0
ANY = np.random.default_rng(6).uniform(-10, 10, 1000)

# (function, args, data, exact function, bound on |approx - exact| as in
# test_elementary.py: absolute, or relative to the exact maximum)
CASES = [
    ("ln_approx", (), POS, np.log, 1e-5, False),
    ("exp_approx", (), ANY, np.exp, 1e-4, True),
    ("sin_approx", (), ANY, np.sin, 2e-6, False),
    ("cos_approx", (), ANY, np.cos, 2e-6, False),
    ("log_approx", (10.0,), POS, np.log10, 1e-5, False),
    ("powf_approx", (1.5,), POS, lambda x: x ** 1.5, 1e-4, True),
    ("expf_approx", (2.0,), ANY, lambda x: 2.0 ** x, 1e-4, True),
]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("name,args,x,exact,bound,relative", CASES,
                         ids=[c[0] for c in CASES])
def test_approx_matches_jax_and_its_bound(name, args, x, exact, bound,
                                          relative, dtype):
    x = x.astype(dtype)
    ref = np.asarray(getattr(jax_approx, name)(jnp.asarray(x), *args))
    got = getattr(torch_approx, name)(torch.from_numpy(x), *args).numpy()
    assert got.dtype == ref.dtype == dtype
    assert np.max(np.abs(got - ref)) <= 1e-6 * np.max(np.abs(ref))
    want = exact(x.astype(np.float64))
    scale = np.max(np.abs(want)) if relative else 1.0
    assert np.max(np.abs(got - want)) <= bound * scale


def test_approx_is_a_different_evaluation_than_exact():
    """As in the reference, the polynomials differ from the exact
    functions somewhere (bitwise)."""
    x = torch.from_numpy(ANY.astype(np.float32))
    assert bool((torch_approx.sin_approx(x) != torch.sin(x)).any())


@pytest.mark.parametrize("name,args", [(c[0], c[1]) for c in CASES])
def test_vector_approx_methods_match_jax(name, args):
    x = (POS if name in ("ln_approx", "log_approx", "powf_approx")
         else ANY).astype(np.float32)
    jv = getattr(bd.to_real_time_vec(x), name)(*args)
    tv = getattr(bt.to_real_time_vec(x, device="cpu"), name)(*args)
    assert isinstance(tv, bt.RealTimeVector)
    ref, got = jv.to_numpy(), tv.to_numpy()
    assert np.max(np.abs(got - ref)) <= 1e-6 * np.max(np.abs(ref))
    with pytest.raises(bt.DspError):
        getattr(bt.to_complex_time_vec(x, device="cpu"), name)(*args)
