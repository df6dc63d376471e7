"""PyTorch port, the overlap-save kernel's module
(basic_dsp_tpu_torch/kernels/overlap_save_cuda.py) on the CPU, where its
wrappers run the plain versions: against the JAX kernel
(basic_dsp_tpu/kernels/overlap_save_pallas.py) in interpret mode, on the
same float32/complex64 inputs, to 2e-6 relative to the maximum, and
against float64 definitions of both modes.  Also the wrappers' geometry,
routing and input checks, and a numpy model of the CUDA kernel
(csrc/overlap_save.cu): its loads, in-place passes, two-level twiddles,
per-pass swizzles, product by H and stores, held against both plain
versions."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from basic_dsp_tpu.kernels import overlap_save_pallas as josp
from basic_dsp_tpu_torch.kernels import overlap_save_cuda as osc
from basic_dsp_tpu_torch.ops.conv_ops import _clip_kernel
import basic_dsp_tpu_torch as bt
from test_torch_fft_core import (bank_check, dft_regs, inplace_pass,
                                 item_twiddles, apply_twiddles,
                                 pass_swizzle, strides, two_level)

TOL = 2e-6

# tests/test_pallas_os.py's geometries: (n, taps, fft_len).
GEOMETRIES = [
    (4096, 33, 1024),
    (4096, 128, 1024),
    (8192, 129, 2048),     # pad crosses one lane group
    (5000, 63, 1024),      # n not a multiple of L
    (4096, 257, 4096),     # pad = 3 lane groups
]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    return np.max(np.abs(got - ref)) / np.max(np.abs(ref))


def _complex(seed, size):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-10, 10, size)
            + 1j * rng.uniform(-10, 10, size)).astype(np.complex64)


def _planes(*arrays):
    out = []
    for a in arrays:
        out += [np.ascontiguousarray(a.real.astype(np.float32)),
                np.ascontiguousarray(a.imag.astype(np.float32))]
    return out


def _c(y):
    """(2, k) planes -> complex numpy."""
    return y[0].numpy() + 1j * y[1].numpy()


@pytest.mark.parametrize("n,m,fft_len", GEOMETRIES)
def test_blocked_linear_conv_matches_jax_kernel(n, m, fft_len):
    planes = _planes(_complex(n, n), _complex(m, m))
    rr, ri = josp._blocked_linear_conv_pallas(
        *map(jnp.asarray, planes), fft_len=fft_len, blocks_per_tile=8,
        interpret=True)
    ref = np.asarray(rr) + 1j * np.asarray(ri)
    tp = list(map(torch.from_numpy, planes))
    for fn in (osc.blocked_linear_conv_cuda, osc.blocked_linear_conv_plain):
        got = fn(*tp, fft_len)
        assert got.dtype == torch.float32 and got.shape == (2, n + m - 1)
        assert _rel(_c(got), ref) <= TOL


@pytest.mark.parametrize("n,m,fft_len", GEOMETRIES)
def test_overlap_save_cuda_matches_jax_kernel(n, m, fft_len):
    x, h = _complex(n + 1, n), _complex(m + 1, m)
    ref = np.asarray(josp.overlap_save_pallas(jnp.asarray(x), jnp.asarray(h),
                                              True, fft_len, interpret=True))
    got = osc.overlap_save_cuda(torch.from_numpy(x), torch.from_numpy(h),
                                True, fft_len)
    assert got.dtype == torch.complex64
    assert _rel(got.numpy(), ref) <= TOL
    circ = osc.circular_conv_plain(*map(torch.from_numpy, _planes(x, h)),
                                   fft_len)
    assert circ.shape == (2, n) and _rel(_c(circ), ref) <= TOL


def test_overlap_save_cuda_real_matches_jax_kernel():
    n, m, fft_len = 4096, 65, 1024
    rng = np.random.default_rng(1)
    x = rng.uniform(-10, 10, n).astype(np.float32)
    h = rng.uniform(-10, 10, m).astype(np.float32)
    ref = np.asarray(josp.overlap_save_pallas(jnp.asarray(x), jnp.asarray(h),
                                              False, fft_len, interpret=True))
    got = osc.overlap_save_cuda(torch.from_numpy(x), torch.from_numpy(h),
                                False, fft_len)
    assert got.dtype == torch.float32 and got.shape == (n,)
    assert _rel(got.numpy(), ref) <= TOL
    z = torch.zeros(n)
    circ = osc.circular_conv_plain(torch.from_numpy(x), z, torch.from_numpy(h),
                                   torch.zeros(m), fft_len)
    assert _rel(circ[0].numpy(), ref) <= TOL
    assert float(circ[1].abs().max()) <= TOL * float(np.abs(ref).max())


def test_overlap_save_cuda_clips_long_kernel_as_jax_kernel():
    """A kernel longer than the signal is clipped around its center: m_eff
    = 2048 needs pad = L = 2048 at fft_len 4096."""
    n, m, fft_len = 2048, 4097, 4096
    x, h = _complex(3, n), _complex(4, m)
    ref = np.asarray(josp.overlap_save_pallas(jnp.asarray(x), jnp.asarray(h),
                                              True, fft_len, interpret=True))
    got = osc.overlap_save_cuda(torch.from_numpy(x), torch.from_numpy(h),
                                True, fft_len)
    assert _rel(got.numpy(), ref) <= TOL
    start, m_eff, _ = _clip_kernel(n, m)
    circ = osc.circular_conv_plain(
        *map(torch.from_numpy, _planes(x, h[start:start + m_eff])), fft_len)
    assert _rel(_c(circ), ref) <= TOL


def _circular_definition(x, h):
    """out[k] = sum_j h[j] x[(k + c - 1 - j) mod n], c = m - m//2, in
    float64: np.convolve over three copies of x (m <= n)."""
    n, m = len(x), len(h)
    c = m - m // 2
    y = np.convolve(np.concatenate([x, x, x]), h)
    return y[n + c - 1:2 * n + c - 1]


@pytest.mark.parametrize("n,m,fft_len", [(5000, 63, 1024), (3000, 1, 1024),
                                         (20000, 385, 2048)])
def test_plain_pieces_match_definition(n, m, fft_len):
    """Both modes of the plain version against float64 numpy: the
    circular mode against the defining sum, the linear mode against
    np.convolve."""
    planes = _planes(_complex(5, n), _complex(6, m))
    xr, xi, hr, hi = planes
    x = xr.astype(np.float64) + 1j * xi
    h = hr.astype(np.float64) + 1j * hi
    tp = list(map(torch.from_numpy, planes))
    lin = osc.blocked_linear_conv_plain(*tp, fft_len)
    assert lin.shape == (2, n + m - 1)
    assert _rel(_c(lin), np.convolve(x, h)) <= TOL
    circ = osc.circular_conv_plain(*tp, fft_len)
    assert circ.shape == (2, n)
    assert _rel(_c(circ), _circular_definition(x, h)) <= TOL


def test_cpu_tensors_take_the_plain_version_uncounted():
    xr, xi, hr, hi = map(torch.from_numpy,
                         _planes(_complex(7, 4096), _complex(8, 33)))
    before = osc.conv_blocks_cuda.launches
    for kernel, plain in ((osc.blocked_linear_conv_cuda,
                           osc.blocked_linear_conv_plain),
                          (osc.circular_conv_cuda, osc.circular_conv_plain)):
        assert torch.equal(kernel(xr, xi, hr, hi, 1024),
                           plain(xr, xi, hr, hi, 1024))
    assert osc.conv_blocks_cuda.launches == before


def test_other_devices_raise():
    """A tensor on neither the CPU nor a CUDA device has no kernel and no
    fallback."""
    p = [torch.empty(4096, device="meta"), torch.empty(4096, device="meta"),
         torch.empty(33, device="meta"), torch.empty(33, device="meta")]
    with pytest.raises(ValueError, match="no kernel"):
        osc.blocked_linear_conv_cuda(*p, 1024)
    with pytest.raises(ValueError, match="no kernel"):
        osc.circular_conv_cuda(*p, 1024)


@pytest.mark.parametrize("fft_len,m,error", [
    (512, 33, ValueError),      # below the kernel's range
    (32768, 33, ValueError),    # above it
    (3000, 33, ValueError),     # not a power of two
    (1024, 600, ValueError),    # pad 640 > L 384: the JAX kernel's L >= pad
])
def test_unsupported_geometry_raises(fft_len, m, error):
    xr, xi, hr, hi = map(torch.from_numpy,
                         _planes(_complex(9, 4096), _complex(10, m)))
    with pytest.raises(error):
        osc.blocked_linear_conv_cuda(xr, xi, hr, hi, fft_len)
    with pytest.raises(error):
        osc.circular_conv_cuda(xr, xi, hr, hi, fft_len)


def test_bad_planes_raise():
    xr, xi, hr, hi = map(torch.from_numpy,
                         _planes(_complex(11, 4096), _complex(12, 33)))
    with pytest.raises(TypeError):
        osc.blocked_linear_conv_cuda(xr.double(), xi, hr, hi, 1024)
    with pytest.raises(ValueError):
        osc.blocked_linear_conv_cuda(xr.reshape(2, -1), xi.reshape(2, -1),
                                     hr, hi, 1024)
    with pytest.raises(ValueError):
        osc.blocked_linear_conv_cuda(xr, xi[:100], hr, hi, 1024)
    H = osc.spectrum(torch.complex(hr, hi), 1024)
    with pytest.raises(TypeError):
        osc.conv_blocks_cuda(xr.double(), None, H, 33, 1024)
    with pytest.raises(ValueError):
        osc.conv_blocks_cuda(xr, xi[:100], H, 33, 1024)
    with pytest.raises(ValueError, match="clip"):    # more taps than n
        osc.circular_conv_cuda(xr[:20], xi[:20], hr, hi, 1024)
    with pytest.raises(ValueError, match="clip"):
        osc.circular_conv_plain(xr[:20], xi[:20], hr, hi, 1024)


@pytest.mark.parametrize("fft_len", [1024, 2048, 4096, 8192, 16384])
def test_supported_matches_jax_kernel(fft_len):
    for f in (fft_len, fft_len // 2, fft_len * 2, fft_len + 128):
        assert osc.supported(f) == josp.supported(f)


# ---------------------------------------------------------------------
# A numpy model of csrc/overlap_save.cu.

def _staged_loads(xr, xi, n, start, N, linear):
    """stage(): the N points of one block as the kernel loads them, chunk
    by chunk of four, and which chunks go by one 16-byte cp.async."""
    j = np.arange(N // 4)
    g = start + 4 * j
    if not linear:
        g = np.where(g >= n, g % n, g)
    whole = ((g & 3) == 0) & (g + 4 <= n) & ((g >= 0) if linear else True)
    zr = np.empty(N, np.float32)
    zi = np.zeros(N, np.float32)
    for e in range(4):
        ge = g + e
        if linear:
            inside = (ge >= 0) & (ge < n)
        else:
            ge = np.where(ge >= n, ge % n, ge)
            inside = np.ones_like(ge, bool)
        idx = np.clip(ge, 0, n - 1)
        zr[4 * j + e] = np.where(inside, xr[idx], 0)
        if xi is not None:
            zi[4 * j + e] = np.where(inside, xi[idx], 0)
    return zr, zi, whole


def _merged_pass(buf, RM, N, tl, H, lin_in, lin_out, log):
    """The forward's last pass (stride N / RM), x H in natural order, the
    inverse's first pass (stride 1), in place."""
    PM = N // RM
    i = np.arange(PM)
    a_in = [lin_in(i) ^ lin_in(r * PM) for r in range(RM)]
    xr = [buf[:, 0, a] for a in a_in]
    xi = [buf[:, 1, a] for a in a_in]
    apply_twiddles(xr, xi, item_twiddles(tl, RM, PM, N, i, -1))
    xr, xi = dft_regs(xr, xi, RM, -1)
    for q in range(RM):
        hr = H.real[i + q * PM].astype(np.float32)
        hi = H.imag[i + q * PM].astype(np.float32)
        xr[q], xi[q] = xr[q] * hr - xi[q] * hi, xr[q] * hi + xi[q] * hr
    xr, xi = dft_regs(xr, xi, RM, 1)
    a_out = [lin_out(i * RM + q) for q in range(RM)]
    for q in range(RM):
        buf[:, 0, a_out[q]] = xr[q]
        buf[:, 1, a_out[q]] = xi[q]
    log.extend(("read", a) for a in a_in)
    log.extend(("write", a) for a in a_out)


def kernel_model(xr, xi, H, m_eff, N, linear, imag=True):
    """csrc/overlap_save.cu in numpy, every block at once: the loads, pass
    0 from the natural staging plane, the in-place forward passes, the
    merged pass, the in-place inverse passes, the last pass's stores.
    Checks every shared-memory access of a warp for bank conflicts and
    that every output is stored exactly once.  Returns the (2, lim) or
    (1, lim) planes."""
    n = len(xr)
    pad, L, lim, shift = osc._mode(n, m_eff, N, linear)
    nb = -(-lim // L)
    buf = np.empty((nb, 2, N), np.float32)
    partial = set()
    for b in range(nb):
        start = b * L - pad if linear else (b * L - pad) % n
        buf[b, 0], buf[b, 1], whole = _staged_loads(xr, xi, n, start, N,
                                                    linear)
        if not whole.all():
            partial.add(b)
    # single loads in the first and last blocks only (none at all for a
    # circular n that 4 divides)
    if n % 4 == 0:
        assert partial <= {0, nb - 1}
        assert linear or not partial
    tl = two_level(N)
    F = osc.radix_plan(N)
    inv = F[::-1]
    log = []
    lin = lambda e: e                        # the staging plane
    for j, (R, P) in enumerate(zip(F[:-1], strides(F)[:-1])):
        out = pass_swizzle(P, R)
        inplace_pass(buf, R, P, N, -1, tl, lin, out, log)
        lin = out
    out = pass_swizzle(1, F[-1])
    _merged_pass(buf, F[-1], N, tl, H, lin, out, log)
    lin = out
    for R, P in list(zip(inv, strides(inv)))[1:-1]:
        out = pass_swizzle(P, R)
        inplace_pass(buf, R, P, N, 1, tl, lin, out, log)
        lin = out
    # the last inverse pass: item i, outputs t = i + q PL to device memory
    R0, PL = inv[-1], N // inv[-1]
    i = np.arange(PL)
    a_in = [lin(i) ^ lin(r * PL) for r in range(R0)]
    log.extend(("read", a) for a in a_in)
    for kind, a in log:
        bank_check(a, (N, kind))
    y = np.full((2, lim), np.nan, np.float32)
    stores = np.zeros(lim, int)
    for b in range(nb):
        vr = [buf[b, 0, a] for a in a_in]
        vi = [buf[b, 1, a] for a in a_in]
        apply_twiddles(vr, vi, item_twiddles(tl, R0, PL, N, i, 1))
        vr, vi = dft_regs(vr, vi, R0, 1)
        for q in range(R0):
            t = i + q * PL
            g = b * L + t - pad
            keep = (t >= pad) & (g < lim)
            o = g[keep] - shift
            o = np.where(o < 0, o + n, o)
            y[0, o] = vr[q][keep] * np.float32(1 / N)
            y[1, o] = vi[q][keep] * np.float32(1 / N)
            np.add.at(stores, o, 1)
    assert (stores == 1).all()
    return y if imag else y[:1]


# (n, taps, fft_len, real taps, real signal): the five GEOMETRIES, then
# 8192 and 16384, n < fft_len (the circular loads wrap more than once), an
# n that 4 does not divide (single loads after the wrap), the clipped long
# kernel, real taps, and a real signal with a null imaginary plane whose
# imaginary output is not stored.
MODEL_CASES = [(n, m, f, False, False) for n, m, f in GEOMETRIES] + [
    (20000, 385, 8192, False, False),
    (20000, 1000, 16384, False, False),
    (700, 129, 1024, False, False),
    (5001, 63, 1024, False, False),
    (2048, 4097, 4096, False, False),
    (5000, 63, 1024, True, False),
    (5000, 200, 2048, False, True),
]


@pytest.mark.parametrize("n,m,fft_len,real_taps,real_signal", MODEL_CASES)
def test_kernel_arithmetic_on_the_wrappers_operands(n, m, fft_len, real_taps,
                                                    real_signal):
    """The numpy model of the kernel, on the operands the wrappers hand it
    (the clipped taps' spectrum), against both plain versions."""
    x, h = _complex(13 + n, n), _complex(14 + m, m)
    if real_taps:
        h = h.real.astype(np.float32)
    start, m_eff, _ = _clip_kernel(n, m)
    H = osc.spectrum(torch.from_numpy(h[start:start + m_eff]), fft_len)
    assert H.dtype == torch.complex64 and H.shape == (fft_len,)
    xr = np.ascontiguousarray(x.real)
    xi = None if real_signal else np.ascontiguousarray(x.imag)
    txi = None if real_signal else torch.from_numpy(xi)
    for linear in (False, True):
        got = kernel_model(xr, xi, H.numpy(), m_eff, fft_len, linear,
                           imag=not real_signal)
        want = osc.conv_blocks_plain(torch.from_numpy(xr), txi, H, m_eff,
                                     fft_len, linear, imag=not real_signal)
        assert got.shape == tuple(want.shape)
        assert _rel(got, want.numpy()) <= TOL, linear


@pytest.mark.parametrize("fft_len", [1024, 2048, 4096, 8192, 16384])
def test_shared_memory_and_threads(fft_len):
    """A block's shared memory fits the card's 227 KB, two blocks an SM
    where a block stages (fft_len <= 4096; 1 KiB reserved per block), and
    every pass's items divide evenly among the threads."""
    per_block = osc.smem_bytes(fft_len) + 1024
    blocks = 2 if osc.staged(fft_len) else 1
    assert blocks * per_block <= 232448
    T = osc.threads(fft_len)
    assert T % 32 == 0 and T <= 512
    for R in osc.radix_plan(fft_len):
        assert (fft_len // R) % T == 0


def test_package_exports_the_kernel_wrappers():
    assert bt.blocked_linear_conv_cuda is osc.blocked_linear_conv_cuda
    assert bt.blocked_linear_conv_plain is osc.blocked_linear_conv_plain
    assert bt.circular_conv_cuda is osc.circular_conv_cuda
    assert bt.circular_conv_plain is osc.circular_conv_plain
    assert bt.overlap_save_cuda is osc.overlap_save_cuda
