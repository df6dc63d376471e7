"""A block of channels on the streaming resampler
(``streaming.StreamingResampler`` with (C, S) chunks and a (C, T) tail):
the stream against the multichannel rate converter's plain reference
(``dspbench/references/audio_src_madi.py``) at 160/147 (K5's route) and
3/2 (K4's); each row equal, bit for bit, to its channel streamed alone;
1-D streams as before, bit for bit; a tail of another shape refused; the
counters and spans.  CPU only (the kernels' plain versions), small sizes,
one thread."""
import math

import pytest
import torch

import basic_dsp_tpu_torch as bt
from basic_dsp_tpu_torch import profiling, streaming
from basic_dsp_tpu_torch.kernels import resample_cuda as rc
from basic_dsp_tpu_torch.ops import interp_ops
from dspbench.references import audio_src_madi as ref

# (factor, P, Q, channels, chunk, chunks, the wrapper a chunk calls)
CASES = {"160/147": (160, 147, 4, 128 * 147, 3, "resample_rowblock_cuda"),
         "3/2": (3, 2, 3, 512, 3, "resample_direct_cuda")}
F32 = 1e-5   # float32 against float64 (2L + 1 products a sample)


@pytest.fixture(autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def spy(monkeypatch):
    """Counts the calls of the two resampler wrappers."""
    calls = {"resample_direct_cuda": 0, "resample_rowblock_cuda": 0}
    for name in calls:
        real = getattr(rc, name)

        def wrapped(*a, _real=real, _name=name, **k):
            calls[_name] += 1
            return _real(*a, **k)
        monkeypatch.setattr(rc, name, wrapped)
    return calls


def _resampler(factor):
    P, Q = CASES[factor][:2]
    return streaming.StreamingResampler(bt.SincFunction(), P / Q, 0.0, 10,
                                        device="cpu")


def _signal(shape, dtype=torch.float32, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(shape, generator=g, dtype=torch.float64)
    if dtype.is_complex:
        x = torch.complex(x, torch.randn(shape, generator=g,
                                         dtype=torch.float64))
    return x.to(dtype)


def _stream(rs, x, S):
    state = rs.init_state(x.dtype, channels=tuple(x.shape[:-1]))
    outs = []
    for s in range(0, x.shape[-1], S):
        out, state = rs.process(x[..., s:s + S], state)
        outs.append(out)
    return torch.cat(outs, dim=-1), state


@pytest.mark.parametrize("factor", sorted(CASES))
def test_a_block_of_channels_is_the_plain_reference(spy, factor):
    P, Q, C, S, nchunks, route = CASES[factor]
    rs = _resampler(factor)
    x = _signal((C, nchunks * S), seed=7)
    got, state = _stream(rs, x, S)
    assert got.dtype == torch.float32 and got.shape == (C, nchunks * S
                                                        * P // Q)
    assert state.tail.dtype == torch.float32
    assert state.tail.shape == (C, rs.T)
    assert spy[route] == nchunks and sum(spy.values()) == nchunks
    consts = ref.constants({"factor": factor, "conv_len": 10}, 0, "cpu")
    assert consts["delay"] // Q * P == rs.output_delay
    err = ref.errors(got, (ref.resample(consts, x.to(torch.float64)),))
    assert err["out_max_rel_err"] <= F32, err


@pytest.mark.parametrize("dtype", [torch.float32, torch.complex64])
@pytest.mark.parametrize("factor", sorted(CASES))
def test_each_row_is_its_channel_streamed_alone(factor, dtype):
    _, _, C, S, nchunks, _ = CASES[factor]
    rs = _resampler(factor)
    x = _signal((C, nchunks * S), dtype, seed=8)
    block, state = _stream(rs, x, S)
    for c in range(C):
        alone, tail = _stream(rs, x[c], S)
        assert alone.dtype == block.dtype == dtype
        assert torch.equal(alone, block[c])
        assert torch.equal(tail.tail, state.tail[c])


def test_a_two_axis_block_streams_as_its_rows():
    rs = _resampler("160/147")
    S = CASES["160/147"][3]
    x = _signal((2, 3, 2 * S), seed=9)
    block, state = _stream(rs, x, S)
    rows, _ = _stream(rs, x.reshape(6, -1), S)
    assert state.tail.shape == (2, 3, rs.T)
    assert torch.equal(block.reshape(6, -1), rows)


def _parents_process(rs, chunk, state):
    """``process`` as it was for 1-D chunks alone."""
    S, L, T = chunk.shape[-1], rs.L, rs.T
    tail = state.tail.to(chunk.dtype)
    rotated = torch.cat([tail[L:], chunk, tail[:L]])
    out = interp_ops._interpolatef_direct(
        rotated, rs.taps, rs.P, rs.Q, rs.offs, L, S * rs.P // rs.Q,
        interp_ops._choose_c(rs.P, rs.Q))
    new_tail = chunk[S - T:] if S >= T else torch.cat([tail[S:], chunk])
    return out.to(chunk.dtype), streaming.ResamplerState(
        tail=new_tail.to(state.tail.dtype, copy=True))


@pytest.mark.parametrize("dtype", [torch.float32, torch.complex64])
@pytest.mark.parametrize("S", [128 * 147, 2 * 128 * 147, 4 * 128 * 147])
def test_a_1d_stream_is_the_parents_bit_for_bit(spy, S, dtype):
    rs = _resampler("160/147")
    x = _signal((3 * S,), dtype, seed=10)
    new = rs.init_state(dtype)
    old = rs.init_state(dtype)
    assert new.tail.shape == (rs.T,)
    for k in range(3):
        chunk = x[k * S:(k + 1) * S]
        s0 = dict(spy)
        a, new = rs.process(chunk, new)
        s1 = dict(spy)
        b, old = _parents_process(rs, chunk, old)
        # the same route, one wrapper call each
        assert {n: s1[n] - s0[n] for n in spy} == \
            {n: spy[n] - s1[n] for n in spy} == \
            {"resample_direct_cuda": 0, "resample_rowblock_cuda": 1}
        assert a.dtype == b.dtype == dtype and a.shape == (S * 160 // 147,)
        assert torch.equal(a, b)
        assert new.tail.dtype == old.tail.dtype
        assert torch.equal(new.tail, old.tail)


@pytest.mark.filterwarnings("ignore:Casting complex values to real")
@pytest.mark.parametrize("S", [128 * 147, 2 * 128 * 147])
def test_a_real_chunk_on_a_complex_tail_is_the_parents(S):
    """The default complex64 state under float32 chunks: the tail cast
    to the chunk's dtype and the new tail back to the state's, as the
    parent cast them."""
    rs = _resampler("160/147")
    x = _signal((3 * S,), seed=13)
    new = old = rs.init_state()
    for k in range(3):
        chunk = x[k * S:(k + 1) * S]
        a, new = rs.process(chunk, new)
        b, old = _parents_process(rs, chunk, old)
        assert a.dtype == b.dtype == torch.float32
        assert torch.equal(a, b)
        assert new.tail.dtype == old.tail.dtype == torch.complex64
        assert torch.equal(new.tail, old.tail)


@pytest.mark.parametrize("lead", [(), (3,)])
def test_a_chunk_shorter_than_the_window_is_the_parents(lead):
    """S = 128 < L = 200 at 2/1: the new tail is the last T samples of
    [tail, chunk], built as the parent built it."""
    rs = streaming.StreamingResampler(bt.SincFunction(), 2.0, 0.0, 200,
                                      device="cpu")
    S = 128
    assert S < rs.L and S < rs.T
    x = _signal(lead + (3 * S,), seed=12)
    new = rs.init_state(torch.float32, channels=lead)
    olds = [rs.init_state(torch.float32) for _ in range(math.prod(lead))]
    for k in range(3):
        a, new = rs.process(x[..., k * S:(k + 1) * S], new)
        rows = x.reshape(-1, 3 * S)
        for r, old in enumerate(olds):
            b, olds[r] = _parents_process(rs, rows[r, k * S:(k + 1) * S],
                                          old)
            assert torch.equal(a.reshape(-1, a.shape[-1])[r], b)
            assert torch.equal(new.tail.reshape(-1, rs.T)[r], olds[r].tail)


@pytest.mark.parametrize("chunk,tail", [
    ((128 * 147,), (4, 18826)), ((4, 128 * 147), (18826,)),
    ((4, 128 * 147), (5, 18826)), ((4, 128 * 147), (4, 18825)),
    ((128 * 147,), (18827,))])
def test_a_tail_of_another_shape_is_refused(chunk, tail):
    rs = _resampler("160/147")
    state = streaming.ResamplerState(tail=torch.zeros(tail))
    with pytest.raises(ValueError, match="does not carry chunks"):
        rs.process(torch.zeros(chunk), state)


def test_init_state_takes_the_channels():
    rs = _resampler("3/2")
    assert rs.init_state(torch.float32, channels=5).tail.shape == (5, rs.T)
    assert rs.init_state(channels=(2, 3)).tail.shape == (2, 3, rs.T)
    assert rs.init_state().tail.shape == (rs.T,)
    assert rs.init_state().tail.dtype == torch.complex64


def test_the_counters_count_chunks_and_channels():
    rs = _resampler("160/147")
    S = CASES["160/147"][3]
    chunks0 = streaming.StreamingResampler.chunks
    rows0 = streaming.StreamingResampler.rows
    _stream(rs, _signal((4, 3 * S)), S)
    _stream(rs, _signal((S,)), S)
    assert streaming.StreamingResampler.chunks - chunks0 == 4
    assert streaming.StreamingResampler.rows - rows0 == 13


@pytest.mark.parametrize("factor,kernel", [("160/147", "dsp.K5"),
                                           ("3/2", "dsp.K4")])
def test_spans_under_one_root_a_chunk(factor, kernel):
    from torch.profiler import profile
    _, _, C, S, _, _ = CASES[factor]
    rs = _resampler(factor)
    x = _signal((C, 2 * S))
    profiling.reset_spans()
    with profile():
        _stream(rs, x, S)
    recs = profiling.spans()
    roots = [r for r in recs if r["parent"] is None]
    assert [r["name"] for r in roots] == ["dsp.resample_stream"] * 2
    for root in roots:
        kids = [r["name"] for r in recs if r["parent"] == root["index"]]
        assert kids == ["dsp.rotate", kernel]
    # on the CPU no record has markers: the reader finds nothing to read
    from dspbench import cells
    glue = cells.module(cells.ROOT, "metrics", "resample_glue_ms")
    assert glue.value(recs) is None
    rotates = [r for r in recs if r["name"] == "dsp.rotate"]
    marked = [dict(r, stream_ms=0.02 * (i + 1))
              for i, r in enumerate(rotates)]
    assert glue.value(marked) == pytest.approx(0.03)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: run on the card")
    return torch.device("cuda")


@pytest.mark.card
def test_a_64_channel_chunk_is_one_k5_launch_on_the_card(card):
    """The cell's chunk: (64, 150528) float32 through K5 itself, one
    launch a chunk, each row bit-equal to its channel streamed alone, all
    within float32 of the plain reference."""
    rs = streaming.StreamingResampler(bt.SincFunction(), 160 / 147, 0.0,
                                      10, device=card)
    S = 150528
    x = _signal((64, 2 * S), seed=11).to(card)
    _stream(rs, x, S)             # builds the kernel
    launches0 = rc.resample_rowblock_cuda.launches
    chunks0 = streaming.StreamingResampler.chunks
    rows0 = streaming.StreamingResampler.rows
    block, state = _stream(rs, x, S)
    torch.cuda.synchronize()
    assert rc.resample_rowblock_cuda.launches - launches0 == 2
    assert streaming.StreamingResampler.chunks - chunks0 == 2
    assert streaming.StreamingResampler.rows - rows0 == 128
    assert block.dtype == state.tail.dtype == torch.float32
    for c in (0, 17, 63):
        alone, tail = _stream(rs, x[c], S)
        assert torch.equal(alone, block[c])
        assert torch.equal(tail.tail, state.tail[c])
    consts = ref.constants({"factor": "160/147", "conv_len": 10}, 0, card)
    err = ref.errors(block, (ref.resample(consts, x.to(torch.float64)),))
    assert err["out_max_rel_err"] <= F32, err
