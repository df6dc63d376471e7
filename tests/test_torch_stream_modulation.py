"""Complex64 IQ streams on the streaming resampler
(``streaming.StreamingResampler`` with (C, S) complex64 chunks and a (C,
T) complex64 tail, handed to the wrappers apart): the multi-carrier pulse
shaper at 10/1 with the raised cosine of roll-off 0.35 against its plain
reference (``dspbench/references/modulation_rc.py``), and against the
planar float32 route (each plane streamed alone on its own tail), bit for
bit, at 10/1 (K4) and 160/147 (K5); 1-D complex chunks; a complex chunk on
a float32 tail; the wrappers' complex rows.  CPU (the kernels' plain
versions), small sizes, one thread; the card-marked cases run the
kernel's complex form at the cell's shapes."""
import warnings

import pytest
import torch

import basic_dsp_tpu_torch as bt
from basic_dsp_tpu_torch import streaming
from basic_dsp_tpu_torch.kernels import resample_cuda as rc
from basic_dsp_tpu_torch.ops import interp_ops
from dspbench.references import modulation_rc as ref

CFG = {"factor": "10", "conv_len": 10, "rolloff": 0.35}
C, S, CHUNKS = 4, 1280, 5
F32 = 1e-5   # float32 against float64, of each carrier's peak
# (P, Q, chunk length): K4 with one phase a lane, K5 with the phases walked
ROUTES = {"10/1": (10, 1, 1280), "160/147": (160, 147, 128 * 147)}


@pytest.fixture(autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _resampler(P=10, Q=1, device="cpu"):
    fun = (bt.RaisedCosineFunction(0.35) if Q == 1 else bt.SincFunction())
    return streaming.StreamingResampler(fun, P / Q, 0.0, 10, device=device)


def _planes(shape, seed):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(shape, generator=g), torch.randn(shape, generator=g))


def _iq(shape, seed):
    """Complex64 samples of the given shape."""
    return torch.complex(*_planes(shape, seed))


def _stream(rs, x, S, state=None):
    if state is None:
        state = rs.init_state(x.dtype, x.device, channels=tuple(x.shape[:-1]))
    outs, tails = [], []
    for s in range(0, x.shape[-1], S):
        out, state = rs.process(x[..., s:s + S], state)
        outs.append(out)
        tails.append(state.tail)
    return outs, tails


def _planar(rs, x, S):
    """Each plane of the complex stream streamed alone as float32 on its
    own tail, joined: the outputs and the tails of each chunk."""
    re, re_tails = _stream(rs, x.real.contiguous(), S)
    im, im_tails = _stream(rs, x.imag.contiguous(), S)
    return ([torch.complex(a, b) for a, b in zip(re, im)],
            [torch.complex(a, b) for a, b in zip(re_tails, im_tails)])


def test_the_pulse_shaper_is_its_plain_reference():
    rs = _resampler()
    assert (rs.P, rs.Q, rs.L, rs.T) == (10, 1, 10, 128)
    xr, xi = _planes((C * CHUNKS * S,), seed=26)
    x = torch.complex(0.5 * torch.sign(xr), 0.5 * torch.sign(xi))
    in_place0 = streaming.StreamingResampler.in_place
    outs, tails = _stream(rs, x.reshape(C, -1), S)
    assert streaming.StreamingResampler.in_place - in_place0 == CHUNKS
    got = torch.cat(outs, dim=-1)
    assert got.dtype == tails[-1].dtype == torch.complex64
    assert got.shape == (C, CHUNKS * S * 10)
    consts = ref.constants(CFG, 0, "cpu")
    want = ref.reference(dict(CFG, carriers=C), consts, xr, xi)
    assert consts["delay"] * 10 == rs.output_delay
    err = ref.errors(got, want)
    assert err["out_max_rel_err"] <= F32, err
    # the imaginary plane counts: dropped, the check refuses it
    dropped = torch.complex(got.real, torch.zeros_like(got.real))
    assert ref.errors(dropped, want)["out_max_rel_err"] > 0.1


@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("lead", [(C,), ()])
def test_a_complex_stream_is_the_planar_route_bit_for_bit(route, lead):
    """(C, S) blocks and 1-D chunks: outputs and tails equal the planes
    streamed alone as float32 and joined."""
    P, Q, S_ = ROUTES[route]
    rs = _resampler(P, Q)
    x = _iq(lead + (3 * S_,), seed=P + len(lead))
    outs, tails = _stream(rs, x, S_)
    want_outs, want_tails = _planar(rs, x, S_)
    for k in range(3):
        assert outs[k].dtype == torch.complex64
        assert outs[k].shape == lead + (S_ * P // Q,)
        assert torch.equal(outs[k], want_outs[k]), k
        assert torch.equal(tails[k], want_tails[k]), k


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_the_wrappers_take_complex_rows_with_their_tail(route):
    """The wrapper given a complex64 chunk (a column slice) and tail apart:
    the planes' calls joined, bit for bit, and the last T samples of
    [tail, chunk] in next_tail."""
    P, Q, S_ = ROUTES[route]
    rs = _resampler(P, Q)
    L, T, out_len = rs.L, rs.T, S_ * P // Q
    wrapper = (rc.resample_rowblock_cuda
               if interp_ops._takes_rowblock(P, Q, L, S_ + T)
               else rc.resample_direct_cuda)
    assert (wrapper is rc.resample_rowblock_cuda) == (Q >= 64)
    rows = _iq((3, 2 * S_ + 1), seed=3)[:, 1:S_ + 1]
    tail = _iq((3, T), seed=4)
    nxt = torch.full_like(tail, float("nan"))
    got = wrapper(rows, rs.taps, P, Q, rs.offs, L, out_len, tail=tail,
                  next_tail=nxt)
    assert got.dtype == torch.complex64 and got.shape == (3, out_len)
    planes = []
    for part in (torch.real, torch.imag):
        n = torch.empty((3, T))
        planes.append(wrapper(part(rows).contiguous(), rs.taps, P, Q,
                              rs.offs, L, out_len,
                              tail=part(tail).contiguous(), next_tail=n))
    assert torch.equal(got, torch.complex(*planes))
    assert torch.equal(nxt, torch.cat([tail, rows], dim=-1)[:, S_:])
    # without a tail: the planes resampled alone, joined
    whole = wrapper(rows, rs.taps, P, Q, rs.offs, L, out_len)
    assert torch.equal(whole, torch.complex(
        wrapper(rows.real.contiguous(), rs.taps, P, Q, rs.offs, L, out_len),
        wrapper(rows.imag.contiguous(), rs.taps, P, Q, rs.offs, L,
                out_len)))


@pytest.mark.parametrize("route,kernel", [("10/1", "dsp.K4"),
                                          ("160/147", "dsp.K5")])
def test_a_complex_chunk_runs_under_the_resamplers_spans(route, kernel):
    """One root a chunk, over the next tail's allocation and the one
    wrapper call; no stack or join span of the planes."""
    from torch.profiler import profile
    from basic_dsp_tpu_torch import profiling
    P, Q, S_ = ROUTES[route]
    rs = _resampler(P, Q)
    x = _iq((2, 2 * S_), seed=31)
    profiling.reset_spans()
    with profile():
        _stream(rs, x, S_)
    recs = profiling.spans()
    roots = [r for r in recs if r["parent"] is None]
    assert [r["name"] for r in roots] == ["dsp.resample_stream"] * 2
    for root in roots:
        kids = [r["name"] for r in recs if r["parent"] == root["index"]]
        assert kids == ["dsp.rotate", kernel]
    assert len(recs) == 6


def test_a_complex_tail_is_refused_under_real_rows_and_back():
    rs = _resampler()
    rows, T = torch.zeros((2, S)), rs.T
    for r, t in ((rows, torch.zeros((2, T), dtype=torch.complex64)),
                 (rows.to(torch.complex64), torch.zeros((2, T)))):
        with pytest.raises(TypeError, match="tensor on"):
            rc.resample_direct_cuda(r, rs.taps, 10, 1, rs.offs, 10, 10 * S,
                                    tail=t, next_tail=t.clone())


def test_a_complex_chunk_on_a_float32_tail_is_cast_as_before():
    """The float32 state under complex64 chunks: the tail cast to
    complex64 (imaginary zero), the chunk read in place, the new tail's
    real part kept; each output that of the complex tail with the same
    values."""
    rs = _resampler()
    x = _iq((C, 3 * S), seed=27)
    state = rs.init_state(torch.float32, channels=C)
    for k in range(3):
        chunk = x[:, k * S:(k + 1) * S]
        twin = streaming.ResamplerState(tail=state.tail.to(torch.complex64))
        in_place0 = streaming.StreamingResampler.in_place
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")   # the imaginary part dropped
            a, state = rs.process(chunk, state)
        assert streaming.StreamingResampler.in_place - in_place0 == 1
        b, _ = rs.process(chunk, twin)
        assert a.dtype == torch.complex64 and torch.equal(a, b)
        assert state.tail.dtype == torch.float32
        assert torch.equal(state.tail, chunk[:, S - rs.T:].real)


def test_a_float64_stream_keeps_the_rotation():
    rs = _resampler()
    assert rs._in_place == {torch.float32, torch.complex64}
    x = _iq((2, S), seed=28).to(torch.complex128)
    in_place0 = streaming.StreamingResampler.in_place
    out, state = rs.process(x, rs.init_state(x.dtype, channels=2))
    assert streaming.StreamingResampler.in_place == in_place0
    assert out.dtype == state.tail.dtype == torch.complex128


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_a_conjugate_view_streams_as_its_values(route):
    """A lazy conjugate (``x.conj()``, its bit unresolved) streams as the
    conjugated values laid out: outputs and tails bit-equal."""
    P, Q, S_ = ROUTES[route]
    rs = _resampler(P, Q)
    x = _iq((C, 2 * S_), seed=32)
    lazy = x.conj()
    assert lazy.is_conj()
    outs, tails = _stream(rs, lazy, S_)
    want_outs, want_tails = _stream(rs, x.conj_physical(), S_)
    for k in range(2):
        assert not outs[k].is_conj() and not tails[k].is_conj()
        assert torch.equal(outs[k], want_outs[k]), k
        assert torch.equal(tails[k], want_tails[k]), k


def test_a_conjugate_next_tail_is_refused():
    rs = _resampler()
    rows, tail = _iq((2, S), seed=33), _iq((2, rs.T), seed=34)
    with pytest.raises(ValueError, match="conjugate bit"):
        rc.resample_direct_cuda(rows, rs.taps, 10, 1, rs.offs, 10, 10 * S,
                                tail=tail, next_tail=tail.clone().conj())


# the cell's shapes: (64, 65536) complex64 chunks at 10/1; the audio
# cell's (64, 150528) at 160/147
CARD = {"10/1": (10, 1, 65536), "160/147": (160, 147, 150528)}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: run on the card")
    return torch.device("cuda")


@pytest.mark.card
@pytest.mark.parametrize("route", sorted(CARD))
def test_the_complex_in_place_launch_is_the_planar_route_on_the_card(
        card, route):
    """Four (64, S) complex64 column slices of a (64, 4 S) capture: one
    kernel launch a chunk reading tail and chunk where they lie (counted
    in ``complex_launches`` and ``in_place``), outputs and tails bit-equal
    to the planes streamed alone as float32, each read in place too."""
    P, Q, S_ = CARD[route]
    rs = _resampler(P, Q, card)
    wrapper = (rc.resample_rowblock_cuda if Q >= 64
               else rc.resample_direct_cuda)
    x = _iq((64, 4 * S_), seed=29).to(card)
    _stream(rs, x[:, :S_], S_)                 # builds the kernel
    torch.cuda.synchronize()
    launches0 = wrapper.launches
    complex0 = wrapper.complex_launches
    in_place0 = streaming.StreamingResampler.in_place
    outs, tails = _stream(rs, x, S_)
    torch.cuda.synchronize()
    assert wrapper.launches - launches0 == 4
    assert wrapper.complex_launches - complex0 == 4
    assert streaming.StreamingResampler.in_place - in_place0 == 4
    want_outs, want_tails = _planar(rs, x, S_)
    torch.cuda.synchronize()
    assert wrapper.launches - launches0 == 12
    assert wrapper.complex_launches - complex0 == 4
    for k in range(4):
        assert outs[k].dtype == torch.complex64
        assert torch.equal(outs[k], want_outs[k]), k
        assert torch.equal(tails[k], want_tails[k]), k
    # complex64 rows without a tail: refused on the card, nothing launched
    launches0 = wrapper.launches
    with pytest.raises(TypeError, match="complex64 rows only"):
        wrapper(x[:, :S_ + rs.T], rs.taps, P, Q, rs.offs, rs.L,
                S_ * P // Q)
    assert wrapper.launches == launches0
    if Q == 1:
        xr, xi = _planes((64 * 4 * S_,), seed=30)
        sym = torch.complex(0.5 * torch.sign(xr), 0.5 * torch.sign(xi))
        got = torch.cat(_stream(rs, sym.reshape(64, -1).to(card), S_)[0],
                        dim=-1)
        want = ref.reference(dict(CFG, carriers=64),
                             ref.constants(CFG, 0, card), xr.to(card),
                             xi.to(card))
        err = ref.errors(got, want)
        assert err["out_max_rel_err"] <= F32, err


@pytest.mark.card
@pytest.mark.parametrize("route", sorted(CARD))
def test_a_conjugate_view_streams_as_its_values_on_the_card(card, route):
    """``chunk.conj()`` and a conjugated tail, their bits unresolved, read
    in place: outputs and tails bit-equal to the conjugates laid out, one
    complex64 launch a chunk."""
    P, Q, S_ = CARD[route]
    rs = _resampler(P, Q, card)
    x = _iq((64, 2 * S_), seed=35).to(card)
    state = streaming.ResamplerState(
        tail=_iq((64, rs.T), seed=36).to(card).conj())
    twin = streaming.ResamplerState(tail=state.tail.resolve_conj())
    complex0 = rc.resample_direct_cuda.complex_launches + \
        rc.resample_rowblock_cuda.complex_launches
    for k in range(2):
        chunk = x[:, k * S_:(k + 1) * S_]
        a, state = rs.process(chunk.conj(), state)
        b, twin = rs.process(chunk.conj_physical(), twin)
        torch.cuda.synchronize()
        assert not a.is_conj()
        assert torch.equal(a, b), k
        assert torch.equal(state.tail, twin.tail), k
    assert (rc.resample_direct_cuda.complex_launches
            + rc.resample_rowblock_cuda.complex_launches - complex0) == 4
