"""PyTorch port, the resampler's kernel module
(basic_dsp_tpu_torch/kernels/resample_cuda.py) and the host-built constants
of ops/interp_ops.py, on the CPU.

* The host constants (polyphase taps, the band-matrix factor c, the
  row-block geometry and matrices, the band matrix) against the JAX
  package's: bit for bit, except raised-cosine taps in float32, whose
  sin/cos differ by an ulp between torch and XLA (within 1.2e-7).
* The plain versions against the JAX kernels in interpret mode:
  ``resample_direct_plain`` against ``resample_direct_pallas`` (atol 5e-5,
  the JAX test's own bound for its 3-pass bf16 dots) and
  ``resample_rowblock_plain`` against ``resample_rowblock_pallas``
  (<= 2e-5 x max).
* A numpy model of ``csrc/resample.cu`` (both modes of resample_runs,
  warp for warp, and the direct stencil for long tap rows: window start,
  modular wrap, register window, phase steps, padded output staging,
  partial last tile, 64-bit base) against the plain versions (<= 2e-6
  relative to the maximum: f32 sums of 2L+1 terms in another order), with
  its shared loads per FMA counted.
* The wrappers' routing, launch counts and input checks, and
  ``state.from_numpy``'s resampler keys.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from basic_dsp_tpu import conv_types as jct
from basic_dsp_tpu.kernels import resample_pallas as jrp
from basic_dsp_tpu.ops import interp_ops as jio
import basic_dsp_tpu_torch as bt
from basic_dsp_tpu_torch.kernels import resample_cuda as rc
from basic_dsp_tpu_torch.ops import interp_ops as tio

TOL = 2e-6

# tests/test_pallas_resample.py's K4 geometries (P, Q, L).
DIRECT = [(3, 2, 10), (10, 1, 12), (2, 1, 5), (5, 4, 10)]
ROWBLOCK = [(160, 147), (147, 160)]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    return np.max(np.abs(got - ref)) / np.max(np.abs(ref))


def _signal(seed, n, rows=None):
    rng = np.random.default_rng(seed)
    shape = (n,) if rows is None else (rows, n)
    return rng.normal(size=shape).astype(np.float32)


def _sinc_taps(P, Q, L, dtype=np.float32):
    taps, offs = jio.polyphase_taps(jct.SincFunction(), P, Q, 0.0, L, dtype)
    return np.array(taps), offs


# ---------------------------------------------------------------- constants

@pytest.mark.parametrize("P,Q,L", DIRECT + [(160, 147, 10), (147, 160, 10),
                                            (6, 5, 10), (7, 3, 4)])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_polyphase_taps_bit_equal_to_jax(P, Q, L, dtype):
    want, offs = _sinc_taps(P, Q, L, dtype)
    got, got_offs = tio.polyphase_taps(bt.SincFunction(), P, Q, 0.0, L,
                                       torch.float32 if dtype == np.float32
                                       else torch.float64, "cpu")
    assert got_offs == offs
    assert got.dtype == (torch.float32 if dtype == np.float32
                         else torch.float64)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("P,Q,delay", [(10, 1, 0.0), (3, 2, 0.25),
                                       (160, 147, 0.0)])
def test_raised_cosine_taps_match_jax(P, Q, delay):
    want, offs = jio.polyphase_taps(jct.RaisedCosineFunction(0.35), P, Q,
                                    delay, 10, np.float32)
    got, got_offs = tio.polyphase_taps(bt.RaisedCosineFunction(0.35), P, Q,
                                       delay, 10, torch.float32, "cpu")
    assert got_offs == offs
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1.2e-7)


def test_polyphase_taps_default_to_the_card():
    """Without ``device`` the taps are sampled on the card; with no CUDA
    that raises instead of falling back to the CPU."""
    if torch.cuda.is_available():
        taps, _ = tio.polyphase_taps(bt.SincFunction(), 3, 2, 0.0, 4,
                                     torch.float32)
        assert taps.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tio.polyphase_taps(bt.SincFunction(), 3, 2, 0.0, 4,
                               torch.float32)


def test_complex_function_gives_complex_taps():
    table = (np.linspace(-1, 1, 41) + 0.5j).astype(np.complex64)
    jf = jct.ComplexTimeLinearTableLookup(table, 0.5, False)
    tf = bt.ComplexTimeLinearTableLookup(table, 0.5, False)
    want, _ = jio.polyphase_taps(jf, 3, 2, 0.0, 4, np.float32)
    got, _ = tio.polyphase_taps(tf, 3, 2, 0.0, 4, torch.float32, "cpu")
    assert got.is_complex()
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not tio._direct_eligible(got, 3, 2, 4)


@pytest.mark.parametrize("P", [1, 2, 3, 5, 10, 64, 128, 147, 160, 255])
@pytest.mark.parametrize("Q", [1, 2, 3, 4, 5, 63, 64, 147, 160])
def test_choose_c_and_band_W_equal_jax(P, Q):
    assert tio._choose_c(P, Q) == jio._choose_c(P, Q)
    for L in (1, 10, 100):
        c = tio._choose_c(P, Q)
        assert tio._band_W(P, Q, L, c) == jio._band_W(P, Q, L, c)


@pytest.mark.parametrize("P,Q,L", [(160, 147, 10), (147, 160, 10),
                                   (65, 64, 3), (100, 99, 60), (3, 200, 100),
                                   (80, 147, 200)])
def test_rowblock_geometry_equal_jax(P, Q, L):
    assert tio._rowblock_geometry(P, Q, L) == jio._rowblock_geometry(P, Q, L)


@pytest.mark.parametrize("P,Q", ROWBLOCK)
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_rowblock_matrices_bit_equal_to_jax(P, Q, dtype):
    taps, offs = _sinc_taps(P, Q, 10)
    want, want_splits = jio._rowblock_matrices(jnp.asarray(taps), P, Q, offs,
                                               10, dtype)
    got, splits = tio._rowblock_matrices(taps, P, Q, offs, 10, dtype)
    assert splits == want_splits and len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    # built once per geometry and taps, read-only
    again, _ = tio._rowblock_matrices(torch.from_numpy(taps), P, Q, offs, 10,
                                      dtype)
    assert again is got and not got[0].flags.writeable


@pytest.mark.parametrize("P,Q,L", DIRECT + [(160, 147, 10)])
def test_direct_band_matrix_bit_equal_to_jax(P, Q, L):
    taps, offs = _sinc_taps(P, Q, L)
    c = jio._choose_c(P, Q)
    for dtype in (np.float32, np.float64):
        want = np.asarray(jio._direct_band_matrix(jnp.asarray(taps), P, Q,
                                                  offs, L, dtype, c))
        got = tio._direct_band_matrix(taps, P, Q, offs, L, dtype, c)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
        assert tio._direct_band_matrix(taps, P, Q, offs, L, dtype, c) is got


def test_lin_taps_band_matrix_from_float64_taps():
    """lin/hermite hand float64 numpy taps to an f32 signal: the band
    matrix is built in float64 and rounded once, as in JAX."""
    P, Q = 5, 2
    taps, L, _ = tio._lin_taps(P, Q, 0.3)
    want = np.asarray(jio._direct_band_matrix(taps, P, Q, (0,) * P, L,
                                              np.float32))
    got = tio._direct_band_matrix(taps, P, Q, (0,) * P, L, np.float32)
    np.testing.assert_array_equal(got, want)


# ------------------------------------------------ plain versions against JAX

@pytest.mark.parametrize("P,Q,L", DIRECT)
def test_direct_plain_matches_jax_kernel(P, Q, L):
    n = 4096
    x = _signal(P * 1000 + Q * 10 + L, n)
    taps, offs = _sinc_taps(P, Q, L)
    c = jio._choose_c(P, Q)
    out_len = n * P // Q
    want = np.asarray(jrp.resample_direct_pallas(
        jnp.asarray(x), taps, P, Q, tuple(offs), L, out_len, c,
        interpret=True))
    got = rc.resample_direct_plain(torch.from_numpy(x)[None],
                                   torch.from_numpy(taps), P, Q, offs, L,
                                   out_len, c)
    assert got.shape == (1, out_len) and got.dtype == torch.float32
    np.testing.assert_allclose(got[0].numpy(), want, atol=5e-5, rtol=5e-5)


@pytest.mark.parametrize("P,Q", ROWBLOCK)
def test_rowblock_plain_matches_jax_kernel(P, Q):
    L, n = 10, 2048
    x = _signal(P + Q, n)
    taps, offs = _sinc_taps(P, Q, L)
    out_len = int(round(n * P / Q))
    out_len += out_len % 2
    want = np.asarray(jrp.resample_rowblock_pallas(
        jnp.asarray(x), taps, P, Q, tuple(offs), L, out_len, interpret=True))
    got = rc.resample_rowblock_plain(torch.from_numpy(x)[None],
                                     torch.from_numpy(taps), P, Q, offs, L,
                                     out_len)[0].numpy()
    assert np.abs(got - want).max() < 2e-5 * np.abs(want).max()


def _formula(x, taps, P, Q, offs, L, out_len):
    """The defining sum in float64 numpy."""
    n = x.shape[-1]
    i = np.arange(out_len)
    p = i % P
    idx = ((i // P) * Q + np.asarray(offs)[p])[:, None] \
        + np.arange(2 * L + 1)[None, :] - L
    return np.einsum("...it,it->...i", x.astype(np.float64)[..., idx % n],
                     np.asarray(taps, np.float64)[p])


@pytest.mark.parametrize("P,Q,L,n,rowblock", [
    (3, 2, 10, 1000, False), (10, 1, 10, 333, False), (6, 5, 10, 1001, False),
    (160, 147, 10, 3000, True), (147, 160, 10, 2000, True)])
def test_plain_versions_match_formula_on_rows(P, Q, L, n, rowblock):
    """Two rows at once, n that Q does not divide, and an out_len that is
    not a multiple of P (the last block partial)."""
    x = _signal(n, n, rows=2)
    taps, offs = _sinc_taps(P, Q, L)
    out_len = int(round(n * P / Q)) | 1
    fn = rc.resample_rowblock_plain if rowblock else rc.resample_direct_plain
    got = fn(torch.from_numpy(x), torch.from_numpy(taps), P, Q, offs, L,
             out_len)
    assert got.shape == (2, out_len)
    assert _rel(got.numpy(), _formula(x, taps, P, Q, offs, L, out_len)) <= TOL


def test_plain_versions_in_float64():
    P, Q, L, n = 160, 147, 10, 3000
    x = _signal(3, n, rows=1).astype(np.float64)
    taps, offs = _sinc_taps(P, Q, L, np.float64)
    want = _formula(x, taps, P, Q, offs, L, 3264)
    c = tio._choose_c(P, Q)
    for got in (rc.resample_rowblock_plain(torch.from_numpy(x),
                                           torch.from_numpy(taps), P, Q,
                                           offs, L, 3264),
                rc.resample_direct_plain(torch.from_numpy(x),
                                         torch.from_numpy(taps), P, Q, offs,
                                         L, 3264, c)):
        assert got.dtype == torch.float64
        assert _rel(got.numpy(), want) <= 1e-13


# ------------------------------------------------- the kernel's index math

def _padded(j):
    """padded(): one pad word every 32 outputs of a tile."""
    return j + (j >> 5)


def _window(x_row, start, words):
    """stage_window: sx[w] = x[(start - start mod 4 + w) mod n], w < words
    (16-byte chunks from an aligned base; the wrap in the index math)."""
    n = x_row.shape[0]
    base = start - (start & 3)
    return x_row[(base + np.arange(words, dtype=np.int64)) % n]


def _tiles_in_numpy(x, taps, P, Q, offs, L, out_len, G, win):
    """resample_tiles (the direct stencil): tile bx of row r stages x[(bx*G*Q
    - L + w) mod n] for w < win (64-bit base, C's signed remainder), then
    output j = k*P + p of the tile sums the window from k*Q + offs[p]
    against taps row p in float32; outputs past out_len are skipped."""
    R, n = x.shape
    T = 2 * L + 1
    out = np.zeros((R, out_len), np.float32)
    writes = np.zeros((R, out_len), np.int64)
    tiles = -(-(-(-out_len // P)) // G)
    for r in range(R):
        for bx in range(tiles):
            b0 = np.int64(bx) * G
            s = int(np.fmod(b0 * Q - L, n))
            if s < 0:
                s += n
            sx = x[r, (s + np.arange(win, dtype=np.int64)) % n]
            j = np.arange(G * P)
            i = b0 * P + j
            keep = i < out_len
            k, p = j // P, j % P
            base = k * Q + offs[p]
            assert base.max() + T <= win       # reads stay in the window
            acc = np.zeros(G * P, np.float32)
            for t in range(T):
                acc = acc + sx[base + t] * taps[p, t]
            out[r, i[keep]] = acc[keep]
            writes[r, i[keep]] += 1
    return out, writes


def _kernel_in_numpy(x, taps, P, Q, offs, L, out_len, counts=None):
    """csrc/resample.cu in numpy, warp for warp (the 32 lanes of a task as
    one vector), for the geometry ``_launch_geometry`` gives.  resample_runs:
    tile t of a row holds output blocks kt = t*KT ..; its window x[(kt*Q -
    L + w) mod n] is staged from an aligned base (64-bit, C's signed
    remainder); each task is a warp: with groups == 0 one phase p a lane
    over FIXED_K blocks (taps and window in registers, output j at window
    offset j*Q), else runs of consecutive outputs walked with the window
    moving by step[p] (0, 1, 2: a register shift; else a reload); outputs
    collect at padded(k*P + p) and leave for i < out_len.  Every window
    read must stay in the staged words and every output word be written
    once.  ``counts`` gathers the shared loads (a float4 tap load, a step,
    a window word and at Q = 2 a float2 pair of window words each count
    one) and the FMAs on the 2L+1 taps.
    Returns the output and how often each output was written."""
    tw, K, groups, KT, win, _ = rc._launch_geometry(P, Q, L, tuple(offs))
    taps = np.asarray(taps, np.float32)
    offs = np.asarray(offs, np.int64)
    if tw == 0:
        return _tiles_in_numpy(x, taps, P, Q, offs, L, out_len, KT, win)
    R, n = x.shape
    T = 2 * L + 1
    ts = np.zeros((P, tw), np.float32)
    ts[:, :T] = taps
    step = np.append(offs[1:] - offs[:-1], Q + offs[0] - offs[-1])
    per_row = -(-(-(-out_len // P)) // KT)
    tasks = (P if groups == 0 else groups) * (KT // (32 * K))
    pg = -(-P // groups) if groups else P
    winw = (win + 6) & ~3
    lanes = np.arange(32)
    nout = KT * P
    counts = {} if counts is None else counts
    counts.setdefault("loads", 0)
    counts.setdefault("fmas", 0)
    out = np.zeros((R, out_len), np.float32)
    writes = np.zeros((R, out_len), np.int64)
    for r in range(R):
        for tile in range(per_row):
            kt = np.int64(tile) * KT
            start = int(np.fmod(kt * Q - L, n))
            start += n if start < 0 else 0
            a0 = start & 3
            xs = _window(x[r], start, winw)[a0:]
            os_ = np.full(_padded(nout) + 1, np.nan, np.float32)
            stored = np.zeros_like(os_, dtype=np.int64)
            for task in range(tasks):
                if groups == 0:
                    p = task % P
                    k = ((task // P) * 32 + lanes) * K
                    nw = (K - 1) * Q + tw
                    idx = (k * Q + offs[p])[:, None] + np.arange(nw)
                    assert idx.max() < xs.size
                    w = xs[idx]
                    if Q == 2:      # float2 pairs, a single word at each
                        odd = (a0 + offs[p]) & 1          # end when odd
                        window_loads = nw // 2 + odd
                    else:
                        window_loads = nw
                    counts["loads"] += 32 * (tw // 4 + window_loads)
                    for j in range(K):
                        acc = np.zeros(32, np.float32)
                        for t in range(tw):
                            acc = acc + w[:, j * Q + t] * ts[p, t]
                        a = _padded((k + j) * P + p)
                        os_[a] = acc
                        np.add.at(stored, a, 1)
                        counts["fmas"] += 32 * T
                    continue
                g = task % groups
                pb = g * pg
                if pb >= P:
                    continue
                J = K * P if groups == 1 else min(P, pb + pg) - pb
                k = ((task // groups) * 32 + lanes) * K
                p = pb
                s = k * Q + offs[p]
                w = xs[s[:, None] + np.arange(tw)]
                counts["loads"] += 32 * tw
                for j in range(J):
                    acc = np.zeros(32, np.float32)
                    for t in range(tw):
                        acc = acc + w[:, t] * ts[p, t]
                    a = _padded(k * P + p)
                    os_[a] = acc
                    np.add.at(stored, a, 1)
                    counts["loads"] += 32 * (tw // 4)
                    counts["fmas"] += 32 * T
                    if j + 1 == J:
                        break
                    d = int(step[p])
                    counts["loads"] += 32
                    p += 1
                    if p == P:
                        p, k = 0, k + 1
                    s = s + d
                    assert (s + tw - 1).max() < xs.size
                    if d in (1, 2):
                        w = np.concatenate(
                            [w[:, d:], xs[s[:, None] + np.arange(tw - d, tw)]],
                            axis=1)
                        counts["loads"] += 32 * d
                    elif d != 0:
                        w = xs[s[:, None] + np.arange(tw)]
                        counts["loads"] += 32 * tw
            m = min(nout, out_len - int(kt) * P)
            a = _padded(np.arange(m))
            assert (stored[a] == 1).all()
            out[r, int(kt) * P:int(kt) * P + m] = os_[a]
            writes[r, int(kt) * P:int(kt) * P + m] += 1
    return out, writes


@pytest.mark.parametrize("P,Q,L,n,rowblock", [
    (3, 2, 10, 4096, False),        # config #3's factor (one phase a lane)
    (10, 1, 10, 1000, False),       # config #4's factor
    (6, 5, 10, 3001, False),        # phases walked, P <= 32, span unaligned
    (160, 147, 10, 4 * 147 * 13 + 37, True),   # audio, 147 does not divide n
    (147, 160, 10, 3000, True),     # steps of 1 and 2
    (2, 1, 5, 11, False),           # windows wrap the signal several times
    (64, 1, 10, 777, False),        # P > 32 at one phase a lane
    (41, 33, 7, 2001, False),       # P > 32 walked, a ragged last group
    (5, 4, 10, 999, False),         # phases walked, a partial last block
])
def test_kernel_model_matches_plain(P, Q, L, n, rowblock):
    x = _signal(P * Q + n, n, rows=2)
    taps, offs = _sinc_taps(P, Q, L)
    out_len = int(round(n * P / Q))
    out_len += out_len % 2 if P % 2 == 0 else 1 - out_len % 2
    got, writes = _kernel_in_numpy(x, taps, P, Q, offs, L, out_len)
    assert (writes == 1).all()
    fn = rc.resample_rowblock_plain if rowblock else rc.resample_direct_plain
    want = fn(torch.from_numpy(x), torch.from_numpy(taps), P, Q, offs, L,
              out_len).numpy()
    assert _rel(got, want) <= TOL


def test_kernel_model_lin_taps_zero_offsets():
    """interpolate_lin's 2-tap geometry: offs all 0, float64 taps rounded
    to f32 once, L set by the phases' spread."""
    P, Q = 5, 2
    taps, L, _ = tio._lin_taps(P, Q, 0.3)
    n = 2000
    x = _signal(5, n, rows=1)
    out_len = n * P // Q - 7
    got, writes = _kernel_in_numpy(x, taps, P, Q, (0,) * P, L, out_len)
    assert (writes == 1).all()
    want = rc.resample_direct_plain(torch.from_numpy(x), taps, P, Q,
                                    (0,) * P, L, out_len).numpy()
    assert _rel(got, want) <= TOL


@pytest.mark.parametrize("P,Q,offs", [(5, 7, (3, 0, 6, 1, 3)),
                                      (4, 3, (2, 2, 0, 1))])
def test_kernel_model_any_offsets(P, Q, offs):
    """Offsets that do not grow with p (the contract allows any in [0,
    Q)): steps below 0 or above 2 reload the window; the model against the
    defining sum."""
    L, n = 3, 500
    x = _signal(P + Q, n, rows=1)
    taps = _signal(7, P * (2 * L + 1)).reshape(P, 2 * L + 1)
    out_len = n * P // Q
    got, writes = _kernel_in_numpy(x, taps, P, Q, offs, L, out_len)
    assert (writes == 1).all()
    assert _rel(got, _formula(x, taps, P, Q, offs, L, out_len)) <= TOL


@pytest.mark.parametrize("P,Q,L,most", [(3, 2, 10, 0.2), (10, 1, 10, 0.3),
                                        (160, 147, 10, 0.5)])
def test_shared_loads_per_fma(P, Q, L, most):
    """Fewer than one shared-memory load per FMA at K4's geometries (3/2
    of config #3, x10 of config #4: 0.17 and 0.24) and K5's (160/147:
    0.43), counted in the model: a float4 of taps, a step and a window
    word each one load, FMAs on the 2L+1 taps (the stencil before did two
    loads an FMA)."""
    n = 147 * 160 + 5 if P == 160 else 8192
    x = _signal(1, n, rows=1)
    taps, offs = _sinc_taps(P, Q, L)
    counts = {}
    _kernel_in_numpy(x, taps, P, Q, offs, L, n * P // Q, counts)
    assert counts["loads"] / counts["fmas"] <= most


@pytest.mark.parametrize("P,Q,L", [(3, 2, 10), (160, 147, 10)])
def test_kernel_base_index_is_64_bit(P, Q, L):
    """At 2^31 samples and beyond, kt*Q and kt*P overflow 32 bits; the
    kernel forms them in 64.  The model's window start and the output's
    source indices agree with the formula in Python integers, where 32-bit
    arithmetic would not."""
    _, offs = _sinc_taps(P, Q, L)
    tw, K, groups, KT, _, _ = rc._launch_geometry(P, Q, L, tuple(offs))
    n = (1 << 32) + 12345
    out_len = n * P // Q
    tile = (out_len // P) // KT - 1          # a tile near the end
    kt = np.int64(tile) * KT
    s = int(np.fmod(kt * Q - L, n)) % n
    assert s == (tile * KT * Q - L) % n
    assert int(np.int32(np.int64(tile * KT * Q - L) & 0xffffffff)) != s
    for kl in (0, K - 1, KT - 1):            # local blocks of the tile
        for p in (0, P - 1):
            i = int(kt) * P + kl * P + p
            for t in (0, tw - 1):
                via_window = (s + kl * Q + offs[p] + t) % n
                assert via_window == ((i // P) * Q + offs[p] + t - L) % n


@pytest.mark.parametrize("P,Q,L", [(1, 1, 16320), (3, 2, 10), (160, 147, 10),
                                   (2048, 1, 5), (1, 512, 16000)])
def test_tile_geometry_fits_every_eligible_band(P, Q, L):
    """Every geometry the dispatch sends to the resampler (band matrix of
    at most 2^22 elements) fits a CUDA block's shared memory: resample_runs
    where 2L+1 <= 32 and its tile fits, else the direct stencil."""
    offs = tuple((p * Q) // P for p in range(P))
    tw, K, groups, KT, win, shared = rc._launch_geometry(P, Q, L, offs)
    if tw:
        assert tw >= 2 * L + 1 and KT % (32 * K) == 0
        assert win == (KT - 1) * Q + max(offs) + tw
        assert rc.run_smem(P, tw, KT, win) <= rc.RUN_SMEM_MAX
        assert (groups == 0) == (Q <= 2)
        assert KT * P >= P * (2 * L + 1)   # the raw taps fit the outputs
    else:
        G = KT
        assert G >= 1 and win == (G - 1) * Q + max(offs) + 2 * L + 1
        smem = 4 * win + (4 * P * (2 * L + 2) if shared else 0)
        assert smem <= rc.SMEM_MAX
        assert G * P >= min(rc.TILE_OUTPUTS, P) or not shared


def test_tile_geometry_main_path_shapes():
    """Config #3 (3/2) and config #4 (x10) at one phase a lane, seven
    blocks each, 24 and 40 tasks a tile (three and five a warp); the audio
    path (160/147) walks eight groups of 20 phases, a tile of 32 blocks."""
    assert rc._launch_geometry(3, 2, 10, (0, 0, 1)) == (
        24, 7, 0, 1792, 3607, 1)
    assert rc._launch_geometry(10, 1, 10, (0,) * 10) == (
        24, 7, 0, 896, 919, 1)
    offs = tuple((p * 147) // 160 for p in range(160))
    assert rc._launch_geometry(160, 147, 10, offs) == (
        24, 1, 8, 32, 4727, 1)
    assert rc._launch_geometry(1, 1, 16320, (0,))[0] == 0


# ------------------------------------------------------- wrappers, routing

@pytest.mark.parametrize("name", ["direct", "rowblock"])
def test_cpu_tensors_take_the_plain_version_uncounted(name):
    P, Q, L = (3, 2, 10) if name == "direct" else (160, 147, 10)
    wrapper = getattr(rc, f"resample_{name}_cuda")
    plain = getattr(rc, f"resample_{name}_plain")
    x = torch.from_numpy(_signal(1, 4096, rows=2))
    taps, offs = _sinc_taps(P, Q, L)
    before = wrapper.launches
    got = wrapper(x, torch.from_numpy(taps), P, Q, offs, L, 4096 * P // Q)
    assert wrapper.launches == before
    assert torch.equal(got, plain(x, torch.from_numpy(taps), P, Q, offs, L,
                                  4096 * P // Q))


def test_other_devices_raise():
    x = torch.empty((1, 4096), device="meta")
    taps, offs = _sinc_taps(3, 2, 10)
    with pytest.raises(ValueError, match="no kernel"):
        rc.resample_direct_cuda(x, taps, 3, 2, offs, 10, 6144)


def test_bad_arguments_raise():
    x = torch.from_numpy(_signal(2, 4096, rows=1))
    taps, offs = _sinc_taps(3, 2, 10)
    with pytest.raises(TypeError):
        rc.resample_direct_cuda(x.double(), taps, 3, 2, offs, 10, 6144)
    with pytest.raises(ValueError):
        rc.resample_direct_cuda(x[0], taps, 3, 2, offs, 10, 6144)
    with pytest.raises(ValueError):
        rc.resample_direct_cuda(x, taps[:, :5], 3, 2, offs, 10, 6144)
    with pytest.raises(ValueError):
        rc.resample_direct_cuda(x, taps, 3, 2, (0, 0, 2), 10, 6144)
    taps, offs = _sinc_taps(160, 147, 10)
    with pytest.raises(ValueError, match="row-block"):   # offset 128 > n
        rc.resample_rowblock_cuda(x[:, :100], taps, 160, 147, offs, 10, 108)


def test_from_numpy_carries_jax_constants_into_the_plain_versions():
    P, Q, L, n = 160, 147, 10, 3000
    taps, offs = _sinc_taps(P, Q, L)
    mats, splits = jio._rowblock_matrices(jnp.asarray(taps), P, Q, offs, L,
                                          np.float32)
    lin_taps, _, _ = tio._lin_taps(5, 2, 0.3)
    got = bt.from_numpy({"polyphase_taps": taps, "_rowblock_matrices": mats},
                        "cpu")
    assert got["polyphase_taps"].dtype == torch.float32
    assert len(got["_rowblock_matrices"]) == len(mats) == len(splits)
    assert bt.from_numpy({"polyphase_taps": lin_taps}, "cpu")[
        "polyphase_taps"].dtype == torch.float64
    with pytest.raises(TypeError):
        bt.from_numpy({"polyphase_taps": taps.astype(np.complex64)}, "cpu")

    x = _signal(4, n)
    out_len = int(round(n * P / Q))
    out_len += out_len % 2
    want = np.asarray(jio._interpolatef_rowblock(jnp.asarray(x), taps, P, Q,
                                                 offs, L, out_len))
    rows = torch.from_numpy(x)[None]
    plain = rc.resample_rowblock_plain(rows, got["polyphase_taps"], P, Q,
                                       offs, L, out_len)[0]
    assert _rel(plain.numpy(), want) <= TOL
    # the JAX matrices themselves, over the port's row-shifted views
    _, off, _, _ = tio._rowblock_geometry(P, Q, L)
    nrows = -(-out_len // P)
    vrows = nrows + max(r for (r, _, _) in splits) + 1
    V = rc._circular(rows, off, vrows * Q)[:, :vrows * Q].reshape(1, vrows, Q)
    summed = rc._rowblock_sum(V, got["_rowblock_matrices"], splits, nrows)
    assert _rel(summed[0, :out_len].numpy(), want) <= TOL


def test_package_exports_the_kernel_wrappers():
    assert bt.resample_direct_cuda is rc.resample_direct_cuda
    assert bt.resample_rowblock_cuda is rc.resample_rowblock_cuda
    assert bt.resample_direct_plain is rc.resample_direct_plain
    assert bt.resample_rowblock_plain is rc.resample_rowblock_plain
