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


# (factor, P, Q, chunk lengths): K5, and K4 with the phases walked (5/3)
# or one phase a lane (3/2); T is 18826, 385 and 256
IN_PLACE = [(160, 147, 128 * 147), (160, 147, 2 * 128 * 147),
            (5, 3, 384), (5, 3, 768), (3, 2, 384), (3, 2, 768)]


def _chunk(layout, C, S, seed):
    """A float32 chunk of C rows (one where 1-D) and S samples: the rows of
    a block, or a column slice of a wider capture (its rows 3 S + 1
    apart)."""
    if layout == "1-D":
        return _signal((S,), seed=seed)
    if layout == "block":
        return _signal((C, S), seed=seed)
    return _signal((C, 3 * S + 1), seed=seed)[:, S + 1:2 * S + 1]


def _rotated(tail, chunk, L):
    return torch.cat([tail[..., L:], chunk, tail[..., :L]], dim=-1)


@pytest.mark.parametrize("layout", ["1-D", "block", "column slice"])
@pytest.mark.parametrize("P,Q,S", IN_PLACE)
def test_the_wrappers_two_source_form_is_the_rotated_call(P, Q, S, layout):
    """The wrapper given chunk and tail apart: the one-source call on the
    rotated extension bit for bit, and the last T samples of [tail,
    chunk] in next_tail; S >= T and S < T."""
    rs = streaming.StreamingResampler(bt.SincFunction(), P / Q, 0.0, 10,
                                      device="cpu")
    L, T, out_len = rs.L, rs.T, S * P // Q
    chunk = _chunk(layout, 3, S, seed=P + S)
    rows = chunk.reshape(-1, S)
    if layout == "column slice":
        assert rows.stride(0) == 3 * S + 1
    tail = _signal((rows.shape[0], T), seed=S)
    wrapper = (rc.resample_rowblock_cuda
               if interp_ops._takes_rowblock(P, Q, L, S + T)
               else rc.resample_direct_cuda)
    assert (wrapper is rc.resample_rowblock_cuda) == (Q >= 64)
    nxt = torch.full_like(tail, float("nan"))
    got = wrapper(rows, rs.taps, P, Q, rs.offs, L, out_len, tail=tail,
                  next_tail=nxt)
    want = wrapper(_rotated(tail, rows, L), rs.taps, P, Q, rs.offs, L,
                   out_len)
    assert torch.equal(got, want)
    assert torch.equal(nxt, torch.cat([tail, rows], dim=-1)[:, S:])
    # the stream's route: the same numbers through interp_ops
    nxt2 = torch.empty((*chunk.shape[:-1], T))
    got2 = interp_ops._interpolatef_stream(
        chunk, tail.reshape(nxt2.shape), nxt2, rs.taps, P, Q, rs.offs, L,
        out_len)
    assert got2.shape == chunk.shape[:-1] + (out_len,)
    assert torch.equal(got2.reshape(-1, out_len), want)
    assert torch.equal(nxt2.reshape(-1, T), nxt)


@pytest.mark.parametrize("bad,match", [
    (lambda t, n: (t, n[:, 1:].contiguous()), "expected shape"),
    (lambda t, n: (t[:2], n[:2]), "expected shape"),
    (lambda t, n: (t[:, :5], n[:, :5]), "fewer than L"),
    (lambda t, n: (t.double(), n), "float32"),
    (lambda t, n: (t, n.t().contiguous().t()), "contiguous"),
    (lambda t, n: (t, None), "float32")])
def test_the_wrapper_refuses_a_tail_that_does_not_fit(bad, match):
    P, Q, L, S, T = 160, 147, 10, 128 * 147, 18826
    rs = _resampler("160/147")
    rows = _signal((3, S))
    tail, nxt = bad(torch.zeros(3, T), torch.zeros(3, T))
    with pytest.raises((TypeError, ValueError), match=match):
        rc.resample_rowblock_cuda(rows, rs.taps, P, Q, rs.offs, L,
                                  S * P // Q, tail=tail, next_tail=nxt)


@pytest.mark.parametrize("factor", sorted(CASES))
def test_the_new_tail_is_not_the_callers_chunk_nor_the_old_tail(factor):
    """After ``process``: writing into the caller's chunk leaves the new
    tail as it was, and the zero state passed in is still zero."""
    _, _, C, S, _, _ = CASES[factor]
    rs = _resampler(factor)
    zero = rs.init_state(torch.float32, channels=C)
    kept = zero.tail.clone()
    x = _signal((C, 2 * S), seed=14)
    _, state = rs.process(x[:, :S], zero)
    _, state = rs.process(x[:, S:], state)
    tail = state.tail.clone()
    x.fill_(7.0)
    assert torch.equal(state.tail, tail)
    assert torch.equal(zero.tail, kept)
    assert torch.equal(state.tail,
                       _signal((C, 2 * S), seed=14)[:, 2 * S - rs.T:])


@pytest.mark.filterwarnings("ignore:Casting complex values to real")
@pytest.mark.parametrize("dtype,counted", [
    (torch.float32, 1), (torch.complex64, 0), (torch.float64, 0)])
@pytest.mark.parametrize("factor", sorted(CASES))
def test_in_place_counts_the_float32_chunks(spy, factor, dtype, counted):
    _, _, C, S, _, route = CASES[factor]
    rs = _resampler(factor)
    x = _signal((C, S), dtype, seed=15)
    for state in (rs.init_state(dtype, channels=C),
                  rs.init_state(channels=C)):       # complex64 tail
        in_place0 = streaming.StreamingResampler.in_place
        rs.process(x, state)
        assert streaming.StreamingResampler.in_place - in_place0 == counted
    assert spy[route] == (2 if dtype != torch.float64 else 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.complex64])
def test_an_empty_chunk_gives_nothing_and_keeps_the_tail(dtype):
    rs = _resampler("160/147")
    state = streaming.ResamplerState(tail=_signal((2, rs.T), dtype))
    out, new = rs.process(torch.zeros((2, 0), dtype=dtype), state)
    assert out.shape == (2, 0) and out.dtype == dtype
    assert torch.equal(new.tail, state.tail)


def test_a_window_longer_than_the_runs_takes_the_rotation(spy):
    """2L+1 = 401 > 32: the direct stencil's geometry keeps the rotated
    copy, and no chunk counts as read in place."""
    rs = streaming.StreamingResampler(bt.SincFunction(), 2.0, 0.0, 200,
                                      device="cpu")
    assert not rs._in_place
    in_place0 = streaming.StreamingResampler.in_place
    rs.process(_signal((2, 256)), rs.init_state(torch.float32, channels=2))
    assert streaming.StreamingResampler.in_place == in_place0
    assert spy["resample_direct_cuda"] == 1


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


@pytest.mark.card
def test_the_cells_column_slices_are_read_in_place_on_the_card(card):
    """The cell's stream: (64, 150528) column slices of a (64, 602112)
    capture over four chunks, tail and chunk read where they lie: outputs
    and tails bit-equal to the rotation then K5 (the parent's path), one
    K5 launch and one chunk read in place a chunk; then the same with the
    chunk's and the tail's rows off the 16-byte grid, each by its own
    amount, from a random tail."""
    rs = streaming.StreamingResampler(bt.SincFunction(), 160 / 147, 0.0,
                                      10, device=card)
    C, S, L, T = 64, 150528, rs.L, rs.T
    out_len = S * rs.P // rs.Q
    x = _signal((C, 4 * S), seed=16).to(card)

    def parents(chunk, tail):
        rotated = _rotated(tail, chunk, L)
        out = rc.resample_rowblock_cuda(rotated, rs.taps, rs.P, rs.Q,
                                        rs.offs, L, out_len)
        return out, rotated[:, S - L:S - L + T]

    def check(x, state):
        tail = state.tail
        launches0 = rc.resample_rowblock_cuda.launches
        in_place0 = streaming.StreamingResampler.in_place
        outs, tails = [], []
        for k in range(4):
            out, state = rs.process(x[:, k * S:(k + 1) * S], state)
            outs.append(out)
            tails.append(state.tail)
        torch.cuda.synchronize()
        assert rc.resample_rowblock_cuda.launches - launches0 == 4
        assert streaming.StreamingResampler.in_place - in_place0 == 4
        for k in range(4):
            want, tail = parents(x[:, k * S:(k + 1) * S], tail)
            assert torch.equal(outs[k], want), k
            assert torch.equal(tails[k], tail), k

    rs.process(x[:, :S], rs.init_state(torch.float32, card, channels=C))
    check(x, rs.init_state(torch.float32, card, channels=C))
    wide = torch.zeros((C, 4 * S + 3), device=card)
    wide[:, 1:4 * S + 1] = x                  # rows 4 S + 3 samples apart
    held = torch.zeros((C, T + 3), device=card)
    held[:, 1:T + 1] = _signal((C, T), seed=17).to(card)
    off = streaming.ResamplerState(tail=held[:, 1:T + 1])
    assert (wide[:, 1:].stride(0) * 4) % 16 and (T + 3) * 4 % 16
    check(wide[:, 1:4 * S + 1], off)
    assert not held[:, 0].any() and not held[:, T + 1:].any()
