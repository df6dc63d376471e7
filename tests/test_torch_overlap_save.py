"""PyTorch port, the overlap-save kernel's module
(basic_dsp_tpu_torch/kernels/overlap_save_cuda.py) on the CPU, where its
wrapper runs the plain version ``blocked_linear_conv_plain``: against the
JAX kernel (basic_dsp_tpu/kernels/overlap_save_pallas.py) in interpret
mode, on the same float32/complex64 inputs, to 2e-6 relative to the
maximum.  Also the wrapper's geometry, routing and input checks, and the
contract between the wrapper and the CUDA kernel (the order and scale of
the spectrum it hands over)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from basic_dsp_tpu.kernels import overlap_save_pallas as josp
from basic_dsp_tpu_torch.kernels import overlap_save_cuda as osc
import basic_dsp_tpu_torch as bt

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


@pytest.mark.parametrize("n,m,fft_len", GEOMETRIES)
def test_blocked_linear_conv_matches_jax_kernel(n, m, fft_len):
    planes = _planes(_complex(n, n), _complex(m, m))
    rr, ri = josp._blocked_linear_conv_pallas(
        *map(jnp.asarray, planes), fft_len=fft_len, blocks_per_tile=8,
        interpret=True)
    gr, gi = osc._blocked_linear_conv(*map(torch.from_numpy, planes),
                                      fft_len)
    assert gr.dtype == torch.float32 and gr.shape == (n + m - 1,)
    ref = np.asarray(rr) + 1j * np.asarray(ri)
    assert _rel(gr.numpy() + 1j * gi.numpy(), ref) <= TOL


@pytest.mark.parametrize("n,m,fft_len", GEOMETRIES)
def test_overlap_save_cuda_matches_jax_kernel(n, m, fft_len):
    x, h = _complex(n + 1, n), _complex(m + 1, m)
    ref = np.asarray(josp.overlap_save_pallas(jnp.asarray(x), jnp.asarray(h),
                                              True, fft_len, interpret=True))
    got = osc.overlap_save_cuda(torch.from_numpy(x), torch.from_numpy(h),
                                True, fft_len)
    assert got.dtype == torch.complex64
    assert _rel(got.numpy(), ref) <= TOL


def test_overlap_save_cuda_real_matches_jax_kernel():
    n, m, fft_len = 4096, 65, 1024
    rng = np.random.default_rng(1)
    x = rng.uniform(-10, 10, n).astype(np.float32)
    h = rng.uniform(-10, 10, m).astype(np.float32)
    ref = np.asarray(josp.overlap_save_pallas(jnp.asarray(x), jnp.asarray(h),
                                              False, fft_len, interpret=True))
    got = osc.overlap_save_cuda(torch.from_numpy(x), torch.from_numpy(h),
                                False, fft_len)
    assert got.dtype == torch.float32
    assert _rel(got.numpy(), ref) <= TOL


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


@pytest.mark.parametrize("n,m,fft_len", [(5000, 63, 1024), (3000, 1, 1024),
                                         (20000, 385, 2048)])
def test_plain_pieces_match_definition(n, m, fft_len):
    """Row b of the pieces is the linear convolution of x[b*L : b*L + L]
    with the taps, in float64 numpy: pad = m - 1 rounded up to 128."""
    xr, xi, hr, hi = _planes(_complex(5, n), _complex(6, m))
    yr, yi = osc.blocked_linear_conv_cuda(
        *map(torch.from_numpy, (xr, xi, hr, hi)), fft_len)
    pad = -(-(m - 1) // 128) * 128
    L = fft_len - pad
    nb = -(-n // L)
    assert yr.shape == yi.shape == (nb, fft_len)
    x = xr.astype(np.float64) + 1j * xi
    h = hr.astype(np.float64) + 1j * hi
    ref = np.zeros((nb, fft_len), np.complex128)
    for b in range(nb):
        piece = np.convolve(x[b * L:(b + 1) * L], h)
        ref[b, :piece.shape[0]] = piece
    assert _rel(yr.numpy() + 1j * yi.numpy(), ref) <= TOL


def test_cpu_tensors_take_the_plain_version_uncounted():
    xr, xi, hr, hi = map(torch.from_numpy,
                         _planes(_complex(7, 4096), _complex(8, 33)))
    before = osc.blocked_linear_conv_cuda.launches
    got = osc.blocked_linear_conv_cuda(xr, xi, hr, hi, 1024)
    want = osc.blocked_linear_conv_plain(xr, xi, hr, hi, 1024)
    assert osc.blocked_linear_conv_cuda.launches == before
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_other_devices_raise():
    """A tensor on neither the CPU nor a CUDA device has no kernel and no
    fallback."""
    p = [torch.empty(4096, device="meta"), torch.empty(4096, device="meta"),
         torch.empty(33, device="meta"), torch.empty(33, device="meta")]
    with pytest.raises(ValueError, match="no kernel"):
        osc.blocked_linear_conv_cuda(*p, 1024)


@pytest.mark.parametrize("fft_len,m,error", [
    (512, 33, ValueError),      # below the kernel's range
    (32768, 33, ValueError),    # above it
    (3000, 33, ValueError),     # not a power of two
    (1024, 600, ValueError),    # pad 640 > L 384: the fold needs L >= pad
])
def test_unsupported_geometry_raises(fft_len, m, error):
    xr, xi, hr, hi = map(torch.from_numpy,
                         _planes(_complex(9, 4096), _complex(10, m)))
    with pytest.raises(error):
        osc.blocked_linear_conv_cuda(xr, xi, hr, hi, fft_len)


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


@pytest.mark.parametrize("fft_len", [1024, 2048, 4096, 8192, 16384])
def test_supported_matches_jax_kernel(fft_len):
    for f in (fft_len, fft_len // 2, fft_len * 2, fft_len + 128):
        assert osc.supported(f) == josp.supported(f)


@pytest.mark.parametrize("k", [1, 4, 10, 14])
def test_bit_reversed_order(k):
    v = torch.arange(1 << k)
    want = [int(format(p, f"0{k}b")[::-1], 2) for p in range(1 << k)]
    assert osc._bit_reversed(v).tolist() == want


def _kernel_in_numpy(xr, xi, Hr, Hi, L, nb, fft_len):
    """The CUDA kernel's arithmetic, stage for stage, in numpy: radix-2 DIF
    forward FFT (natural in, bit-reversed out), the product with the
    spectrum the wrapper hands over, radix-2 DIT inverse (bit-reversed in,
    natural out).  Pins the wrapper/kernel contract: H in bit-reversed
    order with the 1/fft_len of the inverse folded in."""
    log2n = fft_len.bit_length() - 1
    q = np.arange(fft_len // 2)
    tw = np.exp(-2j * np.pi * q / fft_len).astype(np.complex64)
    x = np.zeros(nb * L, np.complex64)
    x[:xr.shape[0]] = xr + 1j * xi
    s = np.zeros((nb, fft_len), np.complex64)
    s[:, :L] = x.reshape(nb, L)
    for st in range(log2n):
        span = fft_len >> (st + 1)
        pos = q & (span - 1)
        i0 = ((q - pos) << 1) + pos
        i1 = i0 + span
        a, b = s[:, i0].copy(), s[:, i1].copy()
        s[:, i0], s[:, i1] = a + b, (a - b) * tw[pos << st]
    s *= (Hr + 1j * Hi).astype(np.complex64)
    for st in range(log2n):
        half = 1 << st
        pos = q & (half - 1)
        i0 = ((q - pos) << 1) + pos
        i1 = i0 + half
        a = s[:, i0].copy()
        b = s[:, i1] * np.conj(tw[pos << (log2n - 1 - st)])
        s[:, i0], s[:, i1] = a + b, a - b
    return s


def test_kernel_arithmetic_on_the_wrappers_operands():
    n, m, fft_len = 5000, 63, 1024
    planes = list(map(torch.from_numpy,
                      _planes(_complex(13, n), _complex(14, m))))
    xr, xi, hr, hi = planes
    _, L, nb = osc._geometry(n, m, fft_len)
    H = osc._kernel_spectrum(hr, hi, fft_len)
    assert H.dtype == torch.complex64 and H.shape == (fft_len,)
    got = _kernel_in_numpy(xr.numpy(), xi.numpy(), H.real.numpy(),
                           H.imag.numpy(), L, nb, fft_len)
    yr, yi = osc.blocked_linear_conv_plain(*planes, fft_len)
    assert _rel(got, yr.numpy() + 1j * yi.numpy()) <= TOL


def test_package_exports_the_kernel_wrappers():
    assert bt.blocked_linear_conv_cuda is osc.blocked_linear_conv_cuda
    assert bt.blocked_linear_conv_plain is osc.blocked_linear_conv_plain
    assert bt.overlap_save_cuda is osc.overlap_save_cuda
