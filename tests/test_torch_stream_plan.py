"""PyTorch port, the streaming resampler's launch plan
(basic_dsp_tpu_torch/streaming.py ``StreamingResampler``,
``_StreamPlan``).

On the CPU, on a stand-in card (tensors that report card 0, a fake
library that records each C entry's arguments): over a 4-chunk stream of
column slices, as the benchmark's entries cut them, the plan passes
``resample_stream_launch`` (float32 at 160/147, K5's route) and
``resample_stream_launch_complex`` (complex64 at 10/1, K4's route) what
``resample_cuda._launch`` passes them on the wrappers' route; it counts
the wrapper's ``launches`` and ``complex_launches`` and the stream's
``chunks``, ``rows``, ``in_place`` and ``planned_chunks``, none while a
CUDA graph is captured; it records the wrappers' route's spans; it
declines what it does not hold, which takes the wrappers' route; it
raises the wrappers' error where the entry fails; the chunk checks
before the root raise as before; the resampler drops its plan when an
attribute is replaced or it is copied.  The tests marked ``card`` skip
without CUDA (on the card: ``python3 -m pytest --noconftest
tests/test_torch_stream_plan.py``, since tests/conftest.py imports JAX):
a planned stream's outputs and tails are bit-equal to the wrappers'
route's at the two benchmark cells' geometries, and each planned chunk
records its root, ``dsp.rotate`` and its kernel span with one launch.
This file imports no JAX."""
import contextlib
import copy

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from basic_dsp_tpu_torch import kernels, profiling, streaming
from basic_dsp_tpu_torch.conv_types import RaisedCosineFunction
from basic_dsp_tpu_torch.conv_types import SincFunction
from basic_dsp_tpu_torch.kernels import _build
from basic_dsp_tpu_torch.kernels import resample_cuda as rc

STREAM = 0x5EED
CARD = torch.device("cuda", 0)
RS = streaming.StreamingResampler
# (pulse, P, Q, dtype, channels, chunk length, kernel, entry)
GEOMETRIES = {
    "audio": (SincFunction, 160, 147, torch.float32, 4, 128 * 147, "K5",
              "resample_stream_launch"),
    "pulse": (lambda: RaisedCosineFunction(0.35), 10, 1, torch.complex64, 4,
              512, "K4", "resample_stream_launch_complex")}
CHUNKS = 4
# the entries' pointer arguments: chunk, tail, next tail, taps, offs, out
POINTERS = (0, 2, 4, 7, 8, 9)


@pytest.fixture(autouse=True)
def _own_state(monkeypatch):
    """One thread; a span recorder of each test's own (its ring and its
    pool of events, stand-ins or the card's, go with it); the counters the
    tests bump restored after the test."""
    torch.set_num_threads(1)
    monkeypatch.setattr(profiling, "_RECORDER", profiling.SpanRecorder())
    for wrapper in (rc.resample_direct_cuda, rc.resample_rowblock_cuda):
        for name in ("launches", "complex_launches"):
            monkeypatch.setattr(wrapper, name, getattr(wrapper, name))
    for name in ("chunks", "rows", "in_place", "planned_chunks"):
        monkeypatch.setattr(RS, name, getattr(RS, name))


class _OnCard(torch.Tensor):
    """A CPU tensor that reports itself on card 0."""

    @property
    def is_cuda(self):
        return True

    @property
    def device(self):
        return CARD

    def get_device(self):
        return 0


class _OnCard1(_OnCard):
    """A CPU tensor that reports itself on card 1."""

    @property
    def device(self):
        return torch.device("cuda", 1)

    def get_device(self):
        return 1


class _FakeLib:
    """The resampler's C entries, each recording its arguments in
    ``calls``."""

    def __init__(self):
        self.calls = []
        self.fails = None     # the entry that returns an error code

    def _entry(name):
        def launch(self, *args):
            self.calls.append((name, args))
            return 7 if name == self.fails else 0
        return launch

    resample_launch = _entry("resample_launch")
    resample_stream_launch = _entry("resample_stream_launch")
    resample_stream_launch_complex = _entry("resample_stream_launch_complex")

    def resample_error_string(self, rc):
        return f"fake error {rc}".encode()


@pytest.fixture
def fake_card(monkeypatch):
    """The wrappers' and the plan's CUDA calls on the CPU: a fake library,
    card 0 current, stream ``STREAM``, allocations on the card made as
    :class:`_OnCard` tensors."""
    lib = _FakeLib()
    monkeypatch.setattr(rc, "_lib", lambda: lib)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    monkeypatch.setattr(_build, "_raw_stream", lambda index: STREAM)
    real = torch.empty

    def empty(*size, device=None, **kw):
        t = real(*size, **kw)
        if device is not None and torch.device(device).type == "cuda":
            return t.as_subclass(_OnCard)
        return t
    monkeypatch.setattr(torch, "empty", empty)
    return lib


def _signal(shape, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(shape, generator=g)
    if dtype.is_complex:
        x = torch.complex(x, torch.randn(shape, generator=g))
    return x.to(dtype)


def _resampler(geometry, monkeypatch, conv_len=10, on_card=True):
    """The geometry's resampler, its taps and offsets on the stand-in
    card (the offsets' record restored after the test)."""
    pulse, P, Q = GEOMETRIES[geometry][:3]
    rs = RS(pulse(), P / Q, 0.0, conv_len, device="cpu")
    if on_card:
        rs.taps = rs.taps.as_subclass(_OnCard)
        record = rc._offsets(P, Q, rs.offs)
        monkeypatch.setitem(record[2], CARD, torch.tensor(
            record[1], dtype=torch.int32).as_subclass(_OnCard))
    return rs


def _inputs(geometry, rs, on_card=True, seed=0):
    """(x, zero tail): a (C, CHUNKS * S) capture and a zero (C, T) tail of
    the geometry's dtype."""
    dtype, C, S = GEOMETRIES[geometry][3:6]
    x = _signal((C, CHUNKS * S), dtype, seed)
    tail = torch.zeros((C, rs.T), dtype=dtype)
    if on_card:
        x, tail = x.as_subclass(_OnCard), tail.as_subclass(_OnCard)
    return x, tail


def _stream(rs, x, tail, S):
    """The outputs and the tails of each chunk of x, column slices of S."""
    state, outs, tails = streaming.ResamplerState(tail=tail), [], []
    for s in range(0, x.shape[-1], S):
        out, state = rs.process(x[:, s:s + S], state)
        outs.append(out)
        tails.append(state.tail)
    return outs, tails


@contextlib.contextmanager
def _unplanned(monkeypatch):
    """A context in which no resampler builds a plan."""
    with monkeypatch.context() as m:
        m.setattr(streaming, "_stream_plan", lambda rs, chunk: None)
        yield


def _normalised(calls, known):
    """Each call's pointers named: a known one by its name in ``known``
    ({pointer: name}), any other by the order it first appears in."""
    fresh, out = {}, []
    for name, args in calls:
        args = list(args)
        for i in POINTERS:
            p = args[i]
            args[i] = known.get(p) or fresh.setdefault(p, ("fresh",
                                                            len(fresh)))
        out.append((name, tuple(args)))
    return out


def _counts():
    wrappers = kernels.wrappers()
    counts = kernels.launch_counts()
    counts.update({f"{k}.complex": wrappers[k].complex_launches
                   for k in ("K4", "K5")})
    counts.update({name: getattr(RS, name) for name in
                   ("chunks", "rows", "in_place", "planned_chunks")})
    return counts


def _moved(before, after):
    return {k: after[k] - before[k] for k in after if after[k] != before[k]}


@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_the_plan_passes_the_entry_what_launch_passes(geometry, fake_card,
                                                      monkeypatch):
    rs = _resampler(geometry, monkeypatch)
    _, P, Q, dtype, C, S, _, entry = GEOMETRIES[geometry]
    x, tail = _inputs(geometry, rs)
    with _unplanned(monkeypatch):
        _stream(rs, x, tail, S)
    wrapped, fake_card.calls = fake_card.calls, []
    outs, tails = _stream(rs, x, tail, S)
    planned = fake_card.calls
    assert rs._launch_plan is not None
    record = rc._offsets(P, Q, rs.offs)
    known = {x[:, s:s + S].data_ptr(): ("chunk", s // S)
             for s in range(0, CHUNKS * S, S)}
    known.update({tail.data_ptr(): "zero tail", rs.taps.data_ptr(): "taps",
                  record[2][CARD].data_ptr(): "offs"})
    assert [name for name, _ in planned] == [entry] * CHUNKS
    assert _normalised(planned, known) == _normalised(wrapped, known)
    # the scalars as the geometry gives them, then the stream
    geometry5 = rc._geometry(record, P, Q, rs.L, dtype.is_complex)[:5]
    for k, (_, args) in enumerate(planned):
        assert args[1] == CHUNKS * S           # the capture's row stride
        assert args[3] == rs.T and args[5:7] == (S, rs.T)
        assert args[10:15] == (S * P // Q, C, P, Q, rs.L)
        assert args[15:] == (*geometry5, STREAM)
        # the entry wrote what the chunk returned, read the tail it was
        # given
        assert args[9] == outs[k].data_ptr() and args[4] == \
            tails[k].data_ptr()
        assert args[2] == (tail if k == 0 else tails[k - 1]).data_ptr()
    for out, t in zip(outs, tails):
        assert out.dtype is dtype and out.shape == (C, S * P // Q)
        assert t.dtype is dtype and t.shape == (C, rs.T)


@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_the_plan_counts_as_the_wrappers_and_none_in_a_capture(
        geometry, fake_card, monkeypatch):
    rs = _resampler(geometry, monkeypatch)
    dtype, C, S, kernel = GEOMETRIES[geometry][3:7]
    x, tail = _inputs(geometry, rs)
    before = _counts()
    with _unplanned(monkeypatch):
        _stream(rs, x, tail, S)
    wrapped = _moved(before, _counts())
    before = _counts()
    _stream(rs, x, tail, S)
    planned = _moved(before, _counts())
    want = {kernel: CHUNKS, "chunks": CHUNKS, "rows": CHUNKS * C,
            "in_place": CHUNKS}
    if dtype.is_complex:
        want[f"{kernel}.complex"] = CHUNKS
    assert wrapped == want
    assert planned == dict(want, planned_chunks=CHUNKS)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    before = _counts()
    _stream(rs, x, tail, S)
    assert _counts() == before
    assert len(fake_card.calls) == 3 * CHUNKS


class _Event:
    """A CUDA event's stand-in for the spans' markers."""

    def __init__(self, enable_timing=False):
        pass

    def record(self, stream=None):
        pass

    def query(self):
        return True

    def elapsed_time(self, other):
        return 1.0


@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_a_planned_chunk_records_the_wrappers_spans(geometry, fake_card,
                                                    monkeypatch):
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: None)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: None)
    rs = _resampler(geometry, monkeypatch)
    S, kernel = GEOMETRIES[geometry][5:7]
    x, tail = _inputs(geometry, rs)
    before = RS.planned_chunks
    with profile(activities=[ProfilerActivity.CPU]):
        _stream(rs, x, tail, S)
    assert RS.planned_chunks == before + CHUNKS
    recs = profiling.spans()
    roots = [r for r in recs if r["parent"] is None]
    assert [r["name"] for r in roots] == ["dsp.resample_stream"] * CHUNKS
    for root in roots:
        children = [r for r in recs if r["parent"] == root["index"]]
        assert [r["name"] for r in children] == ["dsp.rotate",
                                                 f"dsp.{kernel}"]
        rotate, launch = children
        assert (rotate["launches"], launch["launches"]) == (0, 1)
        assert 0 < launch["launch_ns"] <= (launch["end_ns"]
                                           - launch["start_ns"]
                                           - launch["trace_ns"])
        assert root["stream_ms"] is not None


def _declined(case, monkeypatch):
    """(resampler, chunk, tail, the route's stand-in it takes) of each
    case that the plan declines, after a plan was built where the
    resampler takes one."""
    geometry = "pulse" if case == "conjugate" else "audio"
    rs = _resampler(geometry, monkeypatch,
                    conv_len=16 if case == "wide_window" else 10)
    S = GEOMETRIES[geometry][5]
    x, tail = _inputs(geometry, rs)
    rs.process(x[:, :S], streaming.ResamplerState(tail=tail))
    chunk = x[:, S:2 * S]
    route = "_interpolatef_stream"
    if case in ("float64", "wide_window"):
        route = "_interpolatef_direct"
        if case == "float64":
            chunk, tail = chunk.double(), tail.double()
    elif case == "conjugate":
        chunk = chunk.conj()
    elif case == "strided":
        chunk = x[:, :2 * S:2]
    elif case == "grad":
        chunk = x.detach().requires_grad_(True)[:, S:2 * S]
    elif case == "another_S":
        chunk = x[:, S:3 * S]
    elif case == "another_card":
        chunk, tail = chunk.as_subclass(_OnCard1), tail.as_subclass(_OnCard1)
    elif case == "cpu":
        chunk, tail = (chunk.as_subclass(torch.Tensor),
                       tail.as_subclass(torch.Tensor))
    elif case == "tail_on_another_card":
        tail = tail.as_subclass(_OnCard1)
    return rs, chunk, tail, route


@pytest.mark.parametrize("case", ["float64", "wide_window", "conjugate",
                                  "strided", "grad", "another_S",
                                  "another_card", "cpu",
                                  "tail_on_another_card"])
def test_the_plan_declines_what_it_does_not_hold(case, fake_card,
                                                 monkeypatch):
    rs, chunk, tail, route = _declined(case, monkeypatch)
    fake_card.calls.clear()
    taken = []
    for name in ("_interpolatef_stream", "_interpolatef_direct"):
        def stand_in(x, *args, _name=name):
            taken.append(_name)
            return torch.zeros(0, dtype=x.dtype)
        monkeypatch.setattr(streaming.interp_ops, name, stand_in)
    before = _counts()
    with torch.enable_grad():
        rs.process(chunk, streaming.ResamplerState(tail=tail))
    assert taken == [route]
    assert fake_card.calls == []
    moved = _moved(before, _counts())
    assert "planned_chunks" not in moved and moved["chunks"] == 1


@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_the_plan_raises_as_the_wrappers_where_the_entry_fails(
        geometry, fake_card, monkeypatch):
    fake_card.fails = GEOMETRIES[geometry][7]
    rs = _resampler(geometry, monkeypatch)
    S = GEOMETRIES[geometry][5]
    x, tail = _inputs(geometry, rs)
    with _unplanned(monkeypatch):
        with pytest.raises(RuntimeError) as wrapped:
            _stream(rs, x, tail, S)
    before = _counts()
    with pytest.raises(RuntimeError) as got:
        _stream(rs, x, tail, S)
    assert rs._launch_plan is not None
    assert str(got.value) == str(wrapped.value)
    assert str(got.value) == "resample kernel launch failed: fake error 7"
    # nothing counted, as the wrappers count nothing for a failed launch
    assert _counts() == before


@pytest.mark.parametrize("bad", ["length", "tail"])
def test_the_chunk_checks_raise_as_before(bad, fake_card, monkeypatch):
    rs = _resampler("audio", monkeypatch)
    S = GEOMETRIES["audio"][5]
    x, tail = _inputs("audio", rs)
    rs.process(x[:, :S], streaming.ResamplerState(tail=tail))
    assert rs._launch_plan is not None
    plain = _resampler("audio", monkeypatch, on_card=False)
    px, ptail = _inputs("audio", plain, on_card=False)
    if bad == "length":
        args, pargs = (x[:, :S + 128], tail), (px[:, :S + 128], ptail)
    else:
        args, pargs = (x[:, :S], tail[:3]), (px[:, :S], ptail[:3])
    with pytest.raises(ValueError) as want:
        plain.process(pargs[0], streaming.ResamplerState(tail=pargs[1]))
    with pytest.raises(ValueError) as got:
        rs.process(args[0], streaming.ResamplerState(tail=args[1]))
    assert str(got.value) == str(want.value)


def test_the_resampler_drops_its_plan_when_it_changes(fake_card,
                                                      monkeypatch):
    rs = _resampler("audio", monkeypatch)
    S = GEOMETRIES["audio"][5]
    x, tail = _inputs("audio", rs)
    state = streaming.ResamplerState(tail=tail)
    rs.process(x[:, :S], state)
    plan = rs._launch_plan
    assert plan is not None
    rs.process(x[:, S:2 * S], state)
    assert rs._launch_plan is plan
    # a copy builds its own
    assert copy.copy(rs)._launch_plan is None
    assert rs._launch_plan is plan
    rs.taps = rs.taps.clone().as_subclass(_OnCard)
    assert rs._launch_plan is None
    rs.process(x[:, :S], state)
    assert rs._launch_plan is not plan
    assert fake_card.calls[-1][1][7] == rs.taps.data_ptr()


# --- on the card -----------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: run on the card")
    return torch.device("cuda")


# the benchmark cells' chunks: (64, 150528) float32, (64, 65536) complex64
CELLS = {"audio": 150528, "pulse": 65536}


def _on(geometry, device, seed=0):
    pulse, P, Q, dtype = GEOMETRIES[geometry][:4]
    rs = RS(pulse(), P / Q, 0.0, 10, device=device)
    S = CELLS[geometry]
    x = _signal((64, CHUNKS * S), dtype, seed).to(device)
    return rs, x, rs.init_state(dtype, device, channels=64), S


@pytest.mark.card
@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_a_planned_stream_is_bit_equal_to_the_wrappers(card, geometry,
                                                       monkeypatch):
    rs, x, zero, S = _on(geometry, card)
    before = RS.planned_chunks
    outs, tails = _stream(rs, x, zero.tail, S)
    assert RS.planned_chunks == before + CHUNKS
    with _unplanned(monkeypatch):
        w_outs, w_tails = _stream(RS(GEOMETRIES[geometry][0](),
                                     rs.P / rs.Q, 0.0, 10, device=card),
                                  x, zero.tail, S)
    assert RS.planned_chunks == before + CHUNKS
    for a, b in zip(outs + tails, w_outs + w_tails):
        assert a.dtype is b.dtype and torch.equal(a, b)


@pytest.mark.card
@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_each_planned_chunk_records_its_launch_on_the_card(card, geometry):
    rs, x, zero, S = _on(geometry, card, seed=1)
    kernel = GEOMETRIES[geometry][6]
    _stream(rs, x, zero.tail, S)             # builds and warms the kernel
    torch.cuda.synchronize()
    before = RS.planned_chunks
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        _stream(rs, x, zero.tail, S)
        torch.cuda.synchronize()
    assert RS.planned_chunks == before + CHUNKS
    recs = profiling.spans()
    roots = [r for r in recs if r["parent"] is None]
    assert [r["name"] for r in roots] == ["dsp.resample_stream"] * CHUNKS
    for root in roots:
        children = [r for r in recs if r["parent"] == root["index"]]
        assert [r["name"] for r in children] == ["dsp.rotate",
                                                 f"dsp.{kernel}"]
        assert [r["launches"] for r in children] == [0, 1]
        assert root["stream_ms"] > 0 and children[1]["stream_ms"] > 0
