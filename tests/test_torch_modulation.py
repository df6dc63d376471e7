"""PyTorch port, the resampling slice as a whole: the modulation chain
(config #4, ``pipelines.modulation_chain_planar`` and the
``ModulationChainPlanar`` module) against the JAX package's
``modulation_chain_planar`` on the same ±0.5 PRBS symbols (1e-6 relative
to the maximum: f32 stencil sums in another order), the port's planar
chain against its own complex ``interpolatef`` (exactly: real taps
resample the planes independently), and the rule that the port imports no
JAX.
"""
import ast
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from basic_dsp_tpu import pipelines as jpl
import basic_dsp_tpu_torch as bt
from basic_dsp_tpu_torch.kernels import resample_cuda as rc
from basic_dsp_tpu_torch.ops import interp_ops as tio

TOL = 1e-6
N = 4096


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _symbols(seed, n=N):
    rng = np.random.default_rng(seed)
    return (rng.choice([-0.5, 0.5], n).astype(np.float32),
            rng.choice([-0.5, 0.5], n).astype(np.float32))


def _rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape and got.dtype == ref.dtype
    return np.max(np.abs(got - ref)) / np.max(np.abs(ref))


@pytest.mark.parametrize("beta,factor,delay,conv_len", [
    (0.35, 10.0, 0.0, 10), (0.5, 4.0, 0.25, 6), (0.35, 1.5, 0.0, 10)])
def test_modulation_chain_planar_matches_jax(beta, factor, delay, conv_len):
    sr, si = _symbols(1)
    want = jpl.modulation_chain_planar(jnp.asarray(sr), jnp.asarray(si),
                                       beta, factor, delay, conv_len)
    got = bt.modulation_chain_planar(torch.from_numpy(sr),
                                     torch.from_numpy(si), beta, factor,
                                     delay, conv_len)
    for g, w in zip(got, want):
        assert _rel(g.numpy(), w) <= TOL
    module = bt.ModulationChainPlanar(beta, factor, delay, conv_len,
                                      device="cpu")
    for g, w in zip(module(torch.from_numpy(sr), torch.from_numpy(si)),
                    want):
        assert _rel(g.numpy(), w) <= TOL


def test_module_holds_the_taps_and_samples_nothing(monkeypatch):
    module = bt.ModulationChainPlanar(0.35, 10.0, 0.0, 10, device="cpu")
    assert module.taps.shape == (10, 21) and module.offs == (0,) * 10
    assert dict(module.named_buffers())["taps"] is module.taps

    def refuse(*args, **kwargs):
        raise AssertionError("the module sampled its taps again")

    monkeypatch.setattr(tio, "polyphase_taps", refuse)
    sr, si = _symbols(2)
    re, im = module(torch.from_numpy(sr), torch.from_numpy(si))
    assert re.shape == im.shape == (10 * N,) and re.dtype == torch.float32


def test_both_planes_go_through_one_resampler_call(monkeypatch):
    calls = []
    orig = rc.resample_direct_cuda

    def spy(rows, *args):
        calls.append(tuple(rows.shape))
        return orig(rows, *args)

    monkeypatch.setattr(rc, "resample_direct_cuda", spy)
    sr, si = map(torch.from_numpy, _symbols(3))
    bt.ModulationChainPlanar(device="cpu")(sr, si)
    bt.modulation_chain_planar(sr, si)
    assert calls == [(2, N), (2, N)]


def test_planar_chain_equals_complex_interpolatef():
    """As tests/test_pallas_spectrum.py pins for JAX: the planes of the
    planar chain are the real and imaginary parts of interpolatef on the
    complex vector, exactly."""
    sr, si = map(torch.from_numpy, _symbols(12))
    re, im = bt.modulation_chain_planar(sr, si)
    shaped = tio.interpolatef(torch.complex(sr, si),
                              bt.RaisedCosineFunction(0.35), 10.0, 0.0, 10,
                              1.0)
    assert torch.equal(re, shaped.real) and torch.equal(im, shaped.imag)
    m_re, m_im = bt.ModulationChainPlanar(device="cpu")(sr, si)
    assert torch.equal(m_re, re) and torch.equal(m_im, im)


def test_raised_cosine_recovers_the_symbols():
    """Zero-ISI: every 10th output sample is the symbol itself."""
    sr, si = _symbols(4)
    re, im = bt.ModulationChainPlanar(device="cpu")(torch.from_numpy(sr),
                                                    torch.from_numpy(si))
    np.testing.assert_allclose(re[::10].numpy(), sr, atol=1e-5)
    np.testing.assert_allclose(im[::10].numpy(), si, atol=1e-5)


def test_module_refuses_signals_of_another_path():
    module = bt.ModulationChainPlanar(0.35, 10.0, 0.0, 10, device="cpu")
    short = torch.zeros(15)
    with pytest.raises(ValueError):
        module(short, short)            # L would be 7, not 10
    with pytest.raises(ValueError):
        module(torch.zeros(100), torch.zeros(99))
    with pytest.raises(ValueError):
        bt.ModulationChainPlanar(0.35, np.pi, device="cpu")


def test_module_defaults_to_the_card():
    """Without ``device`` the taps go to the card; with no CUDA that
    raises instead of falling back to the CPU."""
    if torch.cuda.is_available():
        assert bt.ModulationChainPlanar().taps.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            bt.ModulationChainPlanar()


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("banned", ["jax", "dspbench"])
def test_port_imports_no_jax(banned):
    """Static scan (sys.modules cannot tell: the test process imports JAX
    for the reference and the benchmark's references):

    - jax: no module of the port, nor chip_smoke.py, which drives it on
      the card, imports JAX or the JAX package;
    - dspbench: no module of the port outside ``bench/`` imports the
      benchmark, whose roofline arithmetic (``dspbench/floors.py``) only
      the port's benchmark programs read."""
    root = pathlib.Path(bt.__file__).resolve().parent
    files = sorted(p for p in root.rglob("*.py")
                   if "_build" not in p.relative_to(root).parts)
    assert len(files) >= 15
    assert root / "kernels" / "spectrum_cuda.py" in files
    if banned == "jax":
        files.append(root.parent / "chip_smoke.py")
        tops = ("jax", "jaxlib", "basic_dsp_tpu")
    else:
        assert "dspbench" in _imports(root / "bench" / "bench.py")
        files = [p for p in files if p.relative_to(root).parts[0] != "bench"]
        tops = ("dspbench",)
    for path in files:
        for name in _imports(path):
            assert name.split(".")[0] not in tops, (path, name)
