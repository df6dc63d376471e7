"""A bank of taps on the streaming FIR (``streaming.StreamingFir`` with
(P, m) taps): each row equals its own 1-D stream, the float64 whole-buffer
linear convolution and the GPS matched-filter bank's plain reference
(``dspbench/references/gps_ca_bank.py``); K3's plain version with (P, N)
spectra equals P one-row calls; the L1 C/A code generator against
IS-GPS-200.  CPU only, small sizes, one thread."""
import numpy as np
import pytest
import torch

from basic_dsp_tpu_torch import profiling, streaming
from basic_dsp_tpu_torch.kernels import overlap_save_cuda as osc
from dspbench.references import gps_ca_bank as gps

# Table 3-Ia: the first 10 chips of PRN 1-12, in octal
FIRST_CHIPS = [0o1440, 0o1620, 0o1710, 0o1744, 0o1133, 0o1455, 0o1131,
               0o1454, 0o1626, 0o1504, 0o1642, 0o1750]
# (taps, chunk lengths): 300 taps take K3 (its plain version here) at 4096
# on the long chunks and the whole-extent FFT on the short tail; 9000 taps
# fit no K3 block and take the plain blocked path at 65536
CASES = [(300, [5000, 6000, 37, 9000]), (9000, [70000, 90000, 100])]


@pytest.fixture(autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _signal(n, kind, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    x = torch.tensor(x, dtype=torch.complex64)
    return x if kind == "complex" else x.real.contiguous()


def _stream(fir, x, chunks):
    state = fir.init_state(x.dtype)
    outs, start = [], 0
    for c in chunks:
        out, state = fir.process(x[start:start + c], state)
        outs.append(out)
        start += c
    return torch.cat(outs, dim=-1)


def _linear(x, h):
    """The causal part of the float64 linear convolution of x with each
    row of h, by FFT in complex128."""
    n, m = x.shape[-1], h.shape[-1]
    size = 1 << (n + m - 1).bit_length()
    y = torch.fft.ifft(torch.fft.fft(x.to(torch.complex128), n=size)
                       * torch.fft.fft(h.to(torch.complex128), n=size))
    return y[..., :n]


def _rel(a, b):
    return float((a.to(torch.complex128) - b.to(torch.complex128)).abs()
                 .max() / b.abs().max())


@pytest.mark.parametrize("kind", ["complex", "real"])
@pytest.mark.parametrize("m,chunks", CASES)
def test_bank_rows_match_their_own_streams(m, chunks, kind):
    x = _signal(sum(chunks), kind)
    h = torch.tensor(np.random.default_rng(1).standard_normal((3, m)),
                     dtype=torch.float32)
    y = _stream(streaming.StreamingFir(h), x, chunks)
    assert y.shape == (3, sum(chunks)) and y.dtype == x.dtype
    for p in range(3):
        row = _stream(streaming.StreamingFir(h[p]), x, chunks)
        assert _rel(y[p], row) <= 1e-6, p
    assert _rel(y, _linear(x, h)) <= 1e-5


@pytest.mark.parametrize("kind", ["complex", "real"])
def test_bank_matches_the_gps_reference(kind):
    cfg = {"prns": [1, 2, 3], "samples_per_chip": 1, "chips": 1023}
    consts = gps.constants(cfg, 0, "cpu")
    chunks = [3000, 5000, 17, 4100]
    x = _signal(sum(chunks), kind, seed=2)
    y = _stream(streaming.StreamingFir(consts["taps"]), x, chunks)
    xr, xi = (x.real, x.imag) if kind == "complex" else (x, torch.zeros_like(x))
    ref = gps.reference(cfg, consts, xr, xi)
    errs = gps.errors(y, ref)
    assert errs["corr_max_rel_err"] <= 1e-6, errs
    assert _rel(ref[0], _linear(x, consts["taps"])) <= 1e-12


@pytest.mark.parametrize("kind", ["complex", "real"])
def test_one_row_bank_is_the_1d_filter(kind):
    x = _signal(12000, kind, seed=3)
    h = torch.tensor(np.random.default_rng(4).standard_normal(300),
                     dtype=torch.float32)
    one = _stream(streaming.StreamingFir(h), x, [5000, 7000])
    bank = _stream(streaming.StreamingFir(h[None]), x, [5000, 7000])
    assert one.shape == (12000,) and bank.shape == (1, 12000)
    assert one.dtype == bank.dtype == x.dtype
    assert torch.equal(one, bank[0])


def test_one_k3_call_a_chunk_for_the_whole_bank(monkeypatch):
    seen = []
    real = osc.conv_blocks_cuda

    def spy(xr, xi, H, *args, **kw):
        seen.append(tuple(H.shape))
        return real(xr, xi, H, *args, **kw)
    monkeypatch.setattr(osc, "conv_blocks_cuda", spy)
    h = torch.ones((4, 300))
    chunks0, rows0 = streaming.StreamingFir.chunks, streaming.StreamingFir.rows
    _stream(streaming.StreamingFir(h), _signal(15000, "complex"),
            [5000] * 3)
    assert seen == [(4, 4096)] * 3
    assert streaming.StreamingFir.chunks - chunks0 == 3
    assert streaming.StreamingFir.rows - rows0 == 12


def test_bank_spans_under_one_root_a_chunk():
    from torch.profiler import profile
    fir = streaming.StreamingFir(torch.ones((2, 300)))
    x = _signal(10000, "complex")
    profiling.reset_spans()
    with profile():
        _stream(fir, x, [5000, 5000])
    recs = profiling.spans()
    roots = [r for r in recs if r["parent"] is None]
    assert [r["name"] for r in roots] == ["dsp.stream"] * 2
    for root in roots:
        kids = [r["name"] for r in recs if r["parent"] == root["index"]]
        assert kids == ["dsp.extend", "dsp.K3", "dsp.assemble"]


@pytest.mark.parametrize("taps", [(2, 3, 4), (0, 5), (3, 0)])
def test_taps_of_another_shape_raise(taps):
    with pytest.raises(ValueError):
        streaming.StreamingFir(torch.ones(taps))


@pytest.mark.parametrize("imag", [True, False])
@pytest.mark.parametrize("linear", [True, False])
def test_plain_bank_equals_one_row_calls(linear, imag):
    rng = np.random.default_rng(5)
    n, m, fl = 9001, 129, 1024
    xr = torch.tensor(rng.standard_normal(n), dtype=torch.float32)
    xi = torch.tensor(rng.standard_normal(n), dtype=torch.float32)
    h = torch.tensor(rng.standard_normal((3, m))
                     + 1j * rng.standard_normal((3, m)), dtype=torch.complex64)
    H = osc.spectrum(h, fl)
    assert H.shape == (3, fl)
    y = osc.conv_blocks_plain(xr, xi, H, m, fl, linear=linear, imag=imag)
    lim = n + m - 1 if linear else n
    assert y.shape == (3, lim)
    assert y.dtype == (torch.complex64 if imag else torch.float32)
    if imag:
        # a bank takes a complex signal whole as well as its planes
        whole = osc.conv_blocks_cuda(torch.complex(xr, xi), None, H, m, fl,
                                     linear=linear, imag=imag)
        assert torch.equal(whole, y)
    for p in range(3):
        assert torch.equal(H[p], osc.spectrum(h[p], fl))
        one = osc.conv_blocks_plain(xr, xi, H[p], m, fl, linear=linear,
                                    imag=imag)
        want = torch.complex(one[0], one[1]) if imag else one[0]
        assert _rel(y[p], want) <= 1e-6, p


@pytest.mark.parametrize("blocks,rows,resident,group", [
    (86, 12, 132, 4), (86, 1, 132, 1), (10, 12, 132, 1),
    (1000, 12, 132, 12), (258, 3, 264, 3)])
def test_bank_group_balances_transforms_and_rounds(blocks, rows, resident,
                                                    group):
    assert osc.bank_group(blocks, rows, resident) == group


@pytest.mark.parametrize("prn", range(1, 13))
def test_ca_code_first_chips_match_table_3_ia(prn):
    chips = gps.ca_code(prn, 10)
    assert int("".join(map(str, chips)), 2) == FIRST_CHIPS[prn - 1]


def test_ca_codes_are_balanced_gold_codes():
    codes = np.array([gps.ca_code(p) for p in range(1, 13)])
    assert (codes.sum(axis=1) == 512).all()
    s = np.fft.fft(1.0 - 2.0 * codes, axis=1)
    # periodic correlation of every pair at every lag
    corr = np.rint(np.fft.ifft(s[:, None, :] * np.conj(s[None, :, :]),
                               axis=-1).real).astype(int)
    off = np.ones(corr.shape, dtype=bool)
    off[np.arange(12), np.arange(12), 0] = False
    assert (corr[np.arange(12), np.arange(12), 0] == 1023).all()
    assert set(np.unique(corr[off])) <= {-65, -1, 63}


def test_replicas_hold_each_chip_for_its_samples():
    cfg = {"prns": [1, 7], "samples_per_chip": 4, "chips": 1023}
    taps = gps.constants(cfg, 0, "cpu")["taps"]
    assert taps.shape == (2, 4092) and taps.dtype == torch.float32
    want = 1.0 - 2.0 * torch.tensor(gps.ca_code(7), dtype=torch.float32)
    assert torch.equal(taps[1].flip(-1)[::4], want)
    assert torch.equal(taps[1].flip(-1)[3::4], want)
