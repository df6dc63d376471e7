"""PyTorch port, streaming (basic_dsp_tpu_torch/streaming.py), on the CPU,
against the JAX package chunk by chunk on the same numpy inputs.

Tolerances: 1e-5 relative to the maximum magnitude for float32 and
complex64 paths (the JAX FIR runs its blocks at the JAX block length on
XLA's FFT, the port at the kernel's clamped block length on torch.fft,
and the resampler sums 2L+1 products in another order), 1e-12 for float64
chunks, and exact equality for the integers (T, ``output_delay``, tail
and output lengths).  A CPU chunk runs the kernels' plain versions: the
spies below show which wrapper each chunk calls.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from basic_dsp_tpu import conv_types as jct
from basic_dsp_tpu import streaming as js
from basic_dsp_tpu.ops import interp_ops as jio
import basic_dsp_tpu_torch as bt
from basic_dsp_tpu_torch import streaming as ts
from basic_dsp_tpu_torch.kernels import overlap_save_cuda as osc
from basic_dsp_tpu_torch.kernels import resample_cuda as rc

F32 = 1e-5
F64 = 1e-12


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    assert got.dtype == ref.dtype, (got.dtype, ref.dtype)
    return np.max(np.abs(got - ref)) / np.max(np.abs(ref))


def _data(seed, n, kind="complex", dtype=np.float32):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=n)
    if kind == "complex":
        x = x + 1j * rng.normal(size=n)
        return x.astype(np.complex64 if dtype == np.float32
                        else np.complex128)
    return x.astype(dtype)


@pytest.fixture
def spy(monkeypatch):
    """Counts the calls of the K3 and resampler wrappers."""
    calls = {"conv_blocks_cuda": 0, "resample_direct_cuda": 0,
             "resample_rowblock_cuda": 0}
    for mod, name in ((osc, "conv_blocks_cuda"),
                      (rc, "resample_direct_cuda"),
                      (rc, "resample_rowblock_cuda")):
        real = getattr(mod, name)

        def wrapped(*a, _real=real, _name=name, **k):
            calls[_name] += 1
            return _real(*a, **k)

        monkeypatch.setattr(mod, name, wrapped)
    return calls


def _run_both(taps, x, chunks, dtype):
    """The port and JAX chunk by chunk: per-chunk outputs and tails."""
    jf = js.StreamingFir(jnp.asarray(taps))
    tf = ts.StreamingFir(torch.from_numpy(taps))
    assert tf.m == jf.m and tf.fft_len == jf.fft_len
    jstate = jf.init_state(dtype)
    tstate = tf.init_state(torch.from_numpy(np.zeros(0, dtype)).dtype)
    assert np.asarray(jstate.tail).dtype == tstate.tail.numpy().dtype
    outs = []
    start = 0
    for size in chunks:
        c = x[start:start + size]
        start += size
        jo, jstate = jf.process(jnp.asarray(c), jstate)
        to, tstate = tf.process(torch.from_numpy(c), tstate)
        outs.append((np.asarray(jo), to.numpy(), np.asarray(jstate.tail),
                     tstate.tail.numpy()))
    return outs


# (m, chunk sizes): m = 9 has fft_len 512, below the kernel's 1024; m = 33
# 2048; m = 257 4096; chunks at or below fft_len - m + 1 take the
# whole-extent FFT, longer ones the blocked path (K3 in linear mode).
FIR_CASES = [(9, (2048, 2048, 1000)), (33, (4096, 2500, 300)),
             (257, (5000, 5000, 777)), (129, (64, 96, 256, 768))]


@pytest.mark.parametrize("kind", ["complex", "real"])
@pytest.mark.parametrize("m,chunks", FIR_CASES)
def test_fir_matches_jax_chunk_by_chunk(spy, m, chunks, kind):
    """Every chunk's output and carried tail equal JAX's (1e-5); a chunk
    whose extension is longer than fft_len calls K3's wrapper once."""
    taps = _data(m, m, kind)
    x = _data(100 + m, sum(chunks), kind)
    fft_len = ts.StreamingFir(torch.from_numpy(taps)).fft_len
    blocked = sum(c + m - 1 > fft_len for c in chunks)
    for jo, to, jt, tt in _run_both(taps, x, chunks, x.dtype):
        assert _rel(to, jo) <= F32
        assert tt.shape == jt.shape == (m - 1,)
        assert np.array_equal(tt, jt)
    assert spy["conv_blocks_cuda"] == blocked
    assert blocked >= 1 or m == 129


def test_fir_chunk_size_sweep_against_linear_convolution():
    """Chunked output is chunk-size invariant, the long-kernel regime
    (m > chunk, the whole-extent FFT) included: each sweep equals JAX's
    stream_chunks and the float64 linear convolution (1e-5)."""
    n, m = 768, 129
    x, h = _data(7, n), _data(8, m)
    lin = np.convolve(x.astype(np.complex128), h.astype(np.complex128))[:n]
    tf = ts.StreamingFir(torch.from_numpy(h))
    jf = js.StreamingFir(jnp.asarray(h))
    for chunk in (64, 96, 256, 768):
        got = ts.stream_chunks(tf, torch.from_numpy(x), chunk).numpy()
        want = np.asarray(js.stream_chunks(jf, jnp.asarray(x), chunk))
        assert _rel(got, want) <= F32
        assert _rel(got.astype(np.complex128), lin) <= F32


def test_fir_one_tap_kernel():
    """m = 1: the tail stays empty, not the chunk."""
    tf = ts.StreamingFir(torch.tensor([2.0 + 0j], dtype=torch.complex64))
    state = tf.init_state(torch.complex64)
    assert state.tail.shape == (0,)
    c = torch.arange(8, dtype=torch.float32).to(torch.complex64)
    out, state = tf.process(c, state)
    assert state.tail.shape == (0,)
    assert torch.equal(out, 2 * c)
    x = _data(3, 64)
    got = ts.stream_chunks(tf, torch.from_numpy(x), 16).numpy()
    want = np.asarray(js.stream_chunks(js.StreamingFir(jnp.asarray(
        np.array([2.0 + 0j], np.complex64))), jnp.asarray(x), 16))
    assert _rel(got, want) <= F32


def test_fir_real_stays_real():
    """A real chunk with real taps gives a float32 output, as JAX's."""
    x = _data(0, 5000, "real")
    h = np.hamming(17).astype(np.float32)
    got = ts.stream_chunks(ts.StreamingFir(torch.from_numpy(h)),
                           torch.from_numpy(x), 2048)
    want = np.asarray(js.stream_chunks(js.StreamingFir(jnp.asarray(h)),
                                       jnp.asarray(x), 2048))
    assert got.dtype == torch.float32
    assert _rel(got.numpy(), want) <= F32
    lin = np.convolve(x.astype(np.float64), h.astype(np.float64))[:5000]
    assert _rel(got.numpy().astype(np.float64), lin) <= F32


def test_fir_nondivisible_tail():
    """A chunk size that does not divide n still gives every sample."""
    n, m, chunk = 1000, 21, 256
    x, h = _data(5, n), _data(6, m)
    got = ts.stream_chunks(ts.StreamingFir(torch.from_numpy(h)),
                           torch.from_numpy(x), chunk).numpy()
    want = np.asarray(js.stream_chunks(js.StreamingFir(jnp.asarray(h)),
                                       jnp.asarray(x), chunk))
    assert got.shape == want.shape == (n,)
    assert _rel(got, want) <= F32


@pytest.mark.parametrize("chunk", [300, 5000])
def test_fir_float64_on_torch_fft(spy, chunk):
    """float64 chunks compute on torch.fft in complex128, never on the
    float32 kernel (1e-12 of JAX's x64 run)."""
    n, m = 10000, 257
    x, h = (_data(11, n, dtype=np.float64),
            _data(12, m, dtype=np.float64))
    got = ts.stream_chunks(ts.StreamingFir(torch.from_numpy(h)),
                           torch.from_numpy(x), chunk).numpy()
    want = np.asarray(js.stream_chunks(js.StreamingFir(jnp.asarray(h)),
                                       jnp.asarray(x), chunk))
    assert _rel(got, want) <= F64
    assert spy["conv_blocks_cuda"] == 0


def test_fir_state_crosses_packages():
    """A JAX FirState tail, as numpy, continues in the port: the output
    equals the all-JAX run (1e-5)."""
    m, chunk = 129, 3000
    x, h = _data(21, 4 * chunk), _data(22, m)
    jf = js.StreamingFir(jnp.asarray(h))
    state = jf.init_state(jnp.complex64)
    want = []
    for k in range(4):
        out, state = jf.process(jnp.asarray(x[k * chunk:(k + 1) * chunk]),
                                state)
        want.append(np.asarray(out))
        if k == 1:
            handoff = np.asarray(state.tail)
    tf = ts.StreamingFir(torch.from_numpy(h))
    tstate = ts.FirState(tail=torch.from_numpy(handoff.copy()))
    for k in (2, 3):
        out, tstate = tf.process(
            torch.from_numpy(x[k * chunk:(k + 1) * chunk]), tstate)
        assert _rel(out.numpy(), want[k]) <= F32
    assert np.array_equal(tstate.tail.numpy(), np.asarray(state.tail))


# (factor, signal kind, chunk length, chunks): Q = 2, 1 and 4.
RESAMPLER_CASES = [(1.5, "complex", 512, 3), (2.0, "real", 256, 4),
                   (1.25, "complex", 1024, 3)]


@pytest.mark.parametrize("factor,kind,S,nchunks", RESAMPLER_CASES)
def test_resampler_matches_jax_chunk_by_chunk(spy, factor, kind, S,
                                              nchunks):
    """T and output_delay equal JAX's (exact); every chunk's output (1e-5)
    and tail (exact) too; each chunk calls K4's wrapper once."""
    jr = js.StreamingResampler(jct.SincFunction(), factor, 0.25, 10)
    tr = ts.StreamingResampler(bt.SincFunction(), factor, 0.25, 10,
                               device="cpu")
    assert (tr.P, tr.Q, tr.L) == (jr.P, jr.Q, jr.L)
    assert (tr.T, tr.output_delay) == (jr.T, jr.output_delay)
    x = _data(31, S * nchunks, kind)
    jdt = jnp.complex64 if kind == "complex" else jnp.float32
    jstate = jr.init_state(jdt)
    tstate = tr.init_state(torch.complex64 if kind == "complex"
                           else torch.float32)
    for k in range(nchunks):
        c = x[k * S:(k + 1) * S]
        jo, jstate = jr.process(jnp.asarray(c), jstate)
        to, tstate = tr.process(torch.from_numpy(c), tstate)
        assert to.shape == (S * tr.P // tr.Q,)
        assert _rel(to.numpy(), np.asarray(jo)) <= F32
        assert np.array_equal(tstate.tail.numpy(), np.asarray(jstate.tail))
    assert spy["resample_direct_cuda"] == nchunks
    assert spy["resample_rowblock_cuda"] == 0


def _linear_resample(x, fun, P, Q, L, delay=0.0):
    """The zero-padded linear resample in float64: out[i] = sum_t
    x[(i//P)*Q + offs[p] + t - L] * fun(t - L - frac[p] + delay), x zero
    outside [0, len(x)), for i < len(x) * P // Q."""
    n = x.shape[-1]
    out_len = n * P // Q
    p = np.arange(P)
    offs = (p * Q) // P
    frac = ((p * Q) % P) / P
    s = np.arange(-L, L + 1)
    taps = fun.calc(torch.from_numpy(
        (s[None, :] - frac[:, None] + delay).astype(np.float64))).numpy()
    i = np.arange(out_len)
    idx = ((i // P) * Q + offs[i % P])[:, None] + (s + L)[None, :] - L
    xp = np.where((idx >= 0) & (idx < n), x[np.clip(idx, 0, n - 1)], 0)
    return (xp * taps[i % P]).sum(-1)


def test_resampler_160_147_against_float64_oracle(spy):
    """44.1 -> 48 kHz in three chunks of 128*147 real samples: K5's
    wrapper once a chunk, and the concatenation equal to the float64
    zero-padded linear resample delayed by output_delay (1e-5).  Held
    against the oracle only: JAX's StreamingResampler refuses a
    denominator above 64, as its band matrix would be 18944 x 20480
    float32 (1.55 GB); T and output_delay follow from JAX's own _band_W."""
    P, Q, L, S = 160, 147, 10, 128 * 147
    with pytest.raises(ValueError, match="denominator <= 64"):
        js.StreamingResampler(jct.SincFunction(), 160 / 147)
    tr = ts.StreamingResampler(bt.SincFunction(), 160 / 147, 0.0, L,
                               device="cpu")
    W = jio._band_W(P, Q, L, 128)
    T0 = max(2 * L, W - 128, 0)
    assert W * 128 * P * 4 > 1.5e9
    assert tr.T == T0 + ((L - T0) % Q)
    assert tr.output_delay == (tr.T - L) // Q * P
    x = _data(41, 3 * S, "real")
    state = tr.init_state(torch.float32)
    outs = []
    for k in range(3):
        out, state = tr.process(torch.from_numpy(x[k * S:(k + 1) * S]),
                                state)
        outs.append(out.numpy())
    got = np.concatenate(outs)
    assert got.dtype == np.float32 and got.shape == (3 * S * P // Q,)
    assert spy["resample_rowblock_cuda"] == 3
    assert spy["resample_direct_cuda"] == 0
    lin = _linear_resample(x.astype(np.float64), bt.SincFunction(), P, Q, L)
    d = tr.output_delay
    assert _rel(got[d:].astype(np.float64), lin[:got.shape[0] - d]) <= F32


def test_resampler_chunk_check_is_jax():
    """The chunk-length check and its message are JAX's."""
    tr = ts.StreamingResampler(bt.SincFunction(), 1.5, device="cpu")
    jr = js.StreamingResampler(jct.SincFunction(), 1.5)
    with pytest.raises(ValueError) as te:
        tr.process(torch.zeros(300, dtype=torch.complex64),
                   tr.init_state())
    with pytest.raises(ValueError) as je:
        jr.process(jnp.zeros(300, jnp.complex64), jr.init_state())
    assert str(te.value) == str(je.value)
