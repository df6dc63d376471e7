"""PyTorch port, the spans of the call path (basic_dsp_tpu_torch/
profiling.py ``span``, ``spanned``, ``spans``, ``reset_spans``) and the
benchmark's readers of them (dspbench/metrics/call_idle_share.py,
fir_stream_ms.py, stage1_stream_ms.py, launch_host_us.py,
dispatch_host_us.py), on the CPU: off without a profiler; under
``torch.profiler`` the chain's and the channelizer's span trees, one call
id a call, a ``record_function`` of each name, no stream ms; each C
entry's call (``_build.launch``, ``_build.call``) timed into its kernel
span's ``launch_ns`` and counted in its ``launches``, nothing off; the
recorder's own time (``trace_ns``) inside its spans' events and
intervals; the stream roots' counters inside them; the ring's bound; the
readers on hand-made records.  The tests marked ``card`` skip without
CUDA (on the card: ``python3 -m pytest --noconftest
tests/test_torch_spans.py``, since tests/conftest.py imports JAX): the
markers resolve, a root's stream ms covers its children's, each root's
records count each launch its wrappers count, and a CUDA graph capture
leaves the launch counts as they were.  This file imports no JAX."""
import math
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from basic_dsp_tpu_torch import kernels, pipelines, profiling, streaming
from basic_dsp_tpu_torch.conv_types import RaisedCosineFunction
from basic_dsp_tpu_torch.conv_types import SincFunction
from basic_dsp_tpu_torch.kernels import _build, channelizer_cuda, fir_cuda
from basic_dsp_tpu_torch.kernels import overlap_save_cuda
from basic_dsp_tpu_torch.kernels import resample_cuda, spectrum_cuda
from basic_dsp_tpu_torch.ops import interp_ops
from basic_dsp_tpu_torch.parallel import channelizer
from dspbench import cells

N = 1 << 16
# the unfused chain's row stage stores the spectrum in natural order
# itself (rowfft_mag_natural): no dsp.flatten
CHAIN = ["dsp.fir", "dsp.stage1", "dsp.K1"]
# the chain's kernel spans inside its stages: K7 in the FIR's, K8 in
# stage 1's
NESTED = {"dsp.K7": "dsp.fir", "dsp.K8": "dsp.stage1"}
C, TAPS_PER_PHASE = 1024, 8


@pytest.fixture(autouse=True)
def _fresh_ring():
    torch.set_num_threads(1)
    profiling.reset_spans()
    yield
    profiling.reset_spans()


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: run on the card")
    return torch.device("cuda")


def _planes(device="cpu", n=N, seed=0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(n, generator=g).to(device),
            torch.randn(n, generator=g).to(device))


def _chain(device="cpu", n=N, fused=False):
    g = torch.Generator().manual_seed(1)
    return pipelines.FirFftChainPlanar(
        torch.randn(128, generator=g).to(device),
        torch.hamming_window(n).to(device), n1=128, fused=fused)


def _prototype(device="cpu"):
    m = C * TAPS_PER_PHASE
    return (torch.hamming_window(m + C)[:m] / C).to(device)


def _dur(r):
    return r["end_ns"] - r["start_ns"]


def _profiled(fn, *args):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn(*args)
    return prof


def _tree(recs):
    """(root, children) of a one-call record list, each child's parent
    checked to be the root."""
    roots = [r for r in recs if r["parent"] is None]
    assert len(roots) == 1, recs
    root = roots[0]
    children = [r for r in recs if r["parent"] == root["index"]]
    assert {r["call"] for r in recs} == {root["call"]}
    return root, children


def test_off_span_is_one_shared_noop_and_records_nothing():
    assert profiling.span("dsp.a") is profiling.span("dsp.b", torch.ones(1))
    with profiling.span("dsp.a"):
        pass
    _chain()(*_planes())
    assert profiling.spans() == []


def test_chain_records_its_stages_under_one_root():
    chain, planes = _chain(), _planes()
    _profiled(chain, *planes)
    recs = profiling.spans()
    root, children = _tree(recs)
    assert root["name"] == "dsp.chain"
    assert recs[0] == root
    assert [r["name"] for r in children] == CHAIN
    # the FIR and window are one K7 call inside dsp.fir, stage 1 one K8
    # call inside dsp.stage1
    assert len(recs) == 1 + len(CHAIN) + len(NESTED)
    by_index = {r["index"]: r for r in recs}
    for name, parent in NESTED.items():
        inner = [r for r in recs if r["name"] == name]
        assert len(inner) == 1
        assert by_index[inner[0]["parent"]]["name"] == parent
    for r in recs:
        assert root["start_ns"] <= r["start_ns"] <= r["end_ns"] \
            <= root["end_ns"]
    starts = [r["start_ns"] for r in children]
    assert starts == sorted(starts)


def test_two_calls_get_two_call_ids():
    chain, planes = _chain(), _planes()

    def twice():
        chain(*planes)
        chain(*planes)
    _profiled(twice)
    recs = profiling.spans()
    calls = sorted({r["call"] for r in recs})
    assert len(calls) == 2
    for call in calls:
        root, children = _tree([r for r in recs if r["call"] == call])
        assert root["name"] == "dsp.chain"
        assert [r["name"] for r in children] == CHAIN


@pytest.mark.parametrize("fused", [False, True], ids=["K1", "K2"])
def test_functional_chain_adds_its_constants(fused):
    g = torch.Generator().manual_seed(1)
    taps = torch.randn(128, generator=g)
    _profiled(pipelines.fir_fft_chain_planar, *_planes(), taps,
              torch.hamming_window(N), 128, None, fused)
    root, children = _tree(profiling.spans())
    assert root["name"] == "dsp.chain"
    stages = (["dsp.fir", "dsp.K2", "dsp.flatten"] if fused else CHAIN)
    assert [r["name"] for r in children] == ["dsp.constants"] + stages


def test_channelizer_records_k6_under_its_root(monkeypatch):
    # CPU planes down the K6 branch, whose wrapper runs its plain version
    monkeypatch.setattr(channelizer, "_kernel_eligible",
                        channelizer._kernel_admits)
    mod = channelizer.ChannelizeAndDemodPlanar(_prototype(), C)
    _profiled(mod, *_planes())
    root, children = _tree(profiling.spans())
    assert root["name"] == "dsp.channelize"
    assert [r["name"] for r in children] == ["dsp.K6"]


def _kernel_calls():
    """A CPU call of each wrapper (its plain version) by kernel."""
    xr, xi = _planes(n=4096)
    g = torch.Generator().manual_seed(2)
    h = torch.randn(33, dtype=torch.complex64, generator=g)
    rows = torch.stack((xr, xi))

    def resample(P, Q):
        taps, offs = interp_ops.polyphase_taps(
            RaisedCosineFunction(0.35), P, Q, 0.0, 10, torch.float32, "cpu")
        fn = (resample_cuda.resample_direct_cuda if Q < 64
              else resample_cuda.resample_rowblock_cuda)
        return lambda: fn(rows, taps, P, Q, offs, 10, 4096 * P // Q)

    A = (xr.reshape(16, 256), xi.reshape(16, 256))
    return {
        "K1": lambda: spectrum_cuda.rowfft_mag(*A),
        "K2": lambda: spectrum_cuda.fourstep_mag_fused(*A),
        "K3": lambda: overlap_save_cuda.conv_blocks_cuda(
            xr, xi, overlap_save_cuda.spectrum(h, 1024), 33, 1024),
        "K4": resample(3, 2),
        "K5": resample(160, 147),
        "K6": lambda: channelizer_cuda.channelize_demod_cuda(
            xr, xi, channelizer._merged_tap_rows(_prototype(), C), C),
        "K7": lambda: fir_cuda.fir_window_cuda(
            xr, xi, h.real.contiguous(), torch.hamming_window(4096)),
        "K8": lambda: spectrum_cuda.stage1_cuda(*A),
        "K1n": lambda: spectrum_cuda.rowfft_mag_natural(*A),
    }


@pytest.mark.parametrize("kernel", list(kernels.wrappers()))
def test_each_kernel_wrapper_is_a_span(kernel):
    call = _kernel_calls()[kernel]
    before = kernels.launch_counts()
    _profiled(call)
    recs = profiling.spans()
    # K1's two entries share its span
    span = "dsp.K1" if kernel == "K1n" else f"dsp.{kernel}"
    assert [(r["name"], r["parent"]) for r in recs] == [(span, None)]
    assert kernels.launch_counts() == before   # CPU: no launch


def test_profiler_events_hold_each_span_by_name(monkeypatch):
    monkeypatch.setattr(channelizer, "_kernel_eligible",
                        channelizer._kernel_admits)
    mod = channelizer.ChannelizeAndDemodPlanar(_prototype(), C)
    chain, planes = _chain(), _planes()

    def both():
        chain(*planes)
        mod(*planes)
    prof = _profiled(both)
    names = {e.name for e in prof.events()}
    recorded = {r["name"] for r in profiling.spans()}
    assert recorded == {"dsp.chain", "dsp.channelize", "dsp.K6", *NESTED,
                        *CHAIN}
    assert recorded <= names


def test_stream_ms_is_none_on_the_cpu():
    _profiled(_chain(), *_planes())
    recs = profiling.spans()
    assert recs and all(r["stream_ms"] is None for r in recs)


def test_the_ring_is_bounded_and_keeps_the_newest_calls():
    rec = profiling.SpanRecorder(capacity=8)
    for _ in range(20):
        with rec.span("dsp.root"):
            with rec.span("dsp.child"):
                with rec.span("dsp.grandchild"):
                    pass
    recs = rec.records()
    assert 0 < len(recs) <= 8
    calls = [r["call"] for r in recs]
    # whole calls, the newest, each root over its child and grandchild
    assert calls == sorted(calls) and calls[-1] == 19
    assert all(calls.count(c) == 3 for c in calls)
    rec.reset()
    assert rec.records() == []
    # the module's ring holds a profiled second of any cell: the chain's
    # calls of 6 records, the channelizer's of 2, a stream's chunks of up
    # to 5
    assert profiling.RING_RECORDS >= max(3000 * 6, 9000 * 2, 2500 * 5)


class _FakeEvent:
    """A CUDA event's stand-in: its time is a tick of a shared clock."""
    made = 0
    clock = 0
    passed = 1 << 30   # the device has passed every event up to this tick

    def __init__(self, enable_timing=False):
        assert enable_timing
        type(self).made += 1
        self.t = None

    def record(self, stream=None):
        type(self).clock += 1
        self.t = type(self).clock

    def query(self):
        return self.t <= type(self).passed

    def elapsed_time(self, other):
        assert self.query() and other.query()
        return float(other.t - self.t)


@pytest.fixture
def fake_card(monkeypatch):
    """The recorder's CUDA calls on the CPU: events on a tick clock."""
    _FakeEvent.made = _FakeEvent.clock = 0
    _FakeEvent.passed = 1 << 30
    cuda = profiling.torch.cuda
    monkeypatch.setattr(cuda, "Event", _FakeEvent)
    monkeypatch.setattr(cuda, "is_current_stream_capturing", lambda: False)
    monkeypatch.setattr(cuda, "current_device", lambda: 0)
    monkeypatch.setattr(cuda, "current_stream", lambda device=None: None)
    monkeypatch.setattr(cuda, "synchronize", lambda device=None: None)
    return torch.device("cuda")


def test_markers_chain_a_roots_children(fake_card):
    rec = profiling.SpanRecorder()
    with rec.span("dsp.root", fake_card):              # tick 1
        with rec.span("dsp.a"):                        # ends at tick 2
            pass
        with rec.span("dsp.b"):                        # ends at tick 3
            with rec.span("dsp.b.inner"):              # no marker
                pass
        with rec.span("dsp.c"):                        # ends at tick 4
            pass
    with rec.span("dsp.alone", fake_card):             # ticks 5, 6
        pass
    with rec.span("dsp.on_cpu", torch.zeros(1)):       # no markers
        with rec.span("dsp.child"):
            pass
    ms = {r["name"]: r["stream_ms"] for r in rec.records()}
    assert ms == {"dsp.root": 3.0, "dsp.a": 1.0, "dsp.b": 1.0,
                  "dsp.b.inner": None, "dsp.c": 1.0, "dsp.alone": 1.0,
                  "dsp.on_cpu": None, "dsp.child": None}
    # the first root made four events; the second took them back
    assert _FakeEvent.made == 4
    rec.reset()
    with rec.span("dsp.root", fake_card):
        with rec.span("dsp.a"):
            pass
    assert _FakeEvent.made == 4
    assert [r["stream_ms"] for r in rec.records()] == [1.0, 1.0]


def test_a_root_takes_back_only_the_events_the_device_passed(fake_card):
    rec = profiling.SpanRecorder()

    def call():
        with rec.span("dsp.root", fake_card):
            with rec.span("dsp.a"):
                pass
    _FakeEvent.passed = 0          # the device is behind
    call()
    call()
    assert _FakeEvent.made == 4    # nothing came back
    _FakeEvent.passed = 1 << 30    # it caught up
    call()
    assert _FakeEvent.made == 4    # the third took the first's events
    recs = rec.records()
    assert [r["stream_ms"] for r in recs] == [1.0] * 6
    assert [r["call"] for r in recs] == [0, 0, 1, 1, 2, 2]


def test_no_markers_while_a_graph_is_captured(fake_card, monkeypatch):
    monkeypatch.setattr(profiling.torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    rec = profiling.SpanRecorder()
    with rec.span("dsp.root", fake_card):
        with rec.span("dsp.a"):
            pass
    assert [r["stream_ms"] for r in rec.records()] == [None, None]
    assert _FakeEvent.made == 0


STREAM = 0x5EED


class _Entry:
    """A C entry's stand-in: records its arguments, sleeps ``sleep_s``,
    returns ``rc``."""

    def __init__(self, rc=0, sleep_s=0.0):
        self.rc, self.calls, self.sleep_s = rc, [], sleep_s

    def __call__(self, *args):
        self.calls.append(args)
        if self.sleep_s:
            time.sleep(self.sleep_s)
        return self.rc


class _EntryLib:
    """The chain plan's library: its three entries and error strings."""

    def __init__(self):
        self.fir_window_launch = _Entry()
        self.fourstep_stage1_launch = _Entry()
        self.rowfft_mag_natural_launch = _Entry()

    def fir_window_error_string(self, rc):
        return b"fake"

    rowfft_mag_error_string = fir_window_error_string


@pytest.fixture
def fake_entries(fake_card, monkeypatch):
    """The C entries on the CPU: a stand-in library for the plan, the
    current stream ``STREAM``."""
    lib = _EntryLib()
    monkeypatch.setattr(fir_cuda, "_lib", lambda: lib)
    monkeypatch.setattr(spectrum_cuda, "_lib", lambda: lib)
    monkeypatch.setattr(_build, "_raw_stream", lambda index: STREAM)
    return lib


def _launches(recs):
    """{span name: the launches its records count}, each such span checked
    to be a kernel span."""
    out = {}
    for r in recs:
        if r["launches"]:
            assert r["name"].startswith("dsp.K"), r["name"]
            out[r["name"]] = out.get(r["name"], 0) + r["launches"]
    return out


def test_a_launch_is_timed_into_its_kernel_span(fake_entries):
    entry = _Entry(rc=3, sleep_s=0.002)

    @profiling.spanned("dsp.K3")
    def wrapper(dev):
        return _build.launch(dev, entry, 1, 2)
    prof = _profiled(wrapper, torch.device("cuda"))
    assert entry.calls == [(1, 2, STREAM)]
    (k3,) = profiling.spans()
    assert k3["name"] == "dsp.K3" and k3["launches"] == 1
    # the entry's call lies in launch_ns, the recorder's work beside it
    assert 2_000_000 <= k3["launch_ns"] <= _dur(k3) - k3["trace_ns"]
    # and it opens no record_function of its own
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    assert "dsp.K3" in names and not any(
        n.startswith("dsp.") and n != "dsp.K3" for n in names)


def test_a_launch_outside_any_span_records_nothing(fake_entries):
    entry = _Entry(rc=4)
    got = []
    _profiled(lambda: got.append(
        (_build.launch(torch.device("cuda"), entry, 1),
         _build.call(entry, 2, STREAM))))
    assert got == [(4, 4)] and entry.calls == [(1, STREAM), (2, STREAM)]
    assert profiling.spans() == []


def test_a_plan_times_each_entry_into_its_kernel_span(fake_entries,
                                                      monkeypatch):
    # the wrappers' counters as they were after the test
    for counted in (fir_cuda.fir_window_cuda, spectrum_cuda.stage1_cuda,
                    spectrum_cuda.rowfft_mag_natural):
        monkeypatch.setattr(counted, "launches", counted.launches)
    monkeypatch.setattr(pipelines.FirFftChainPlanar, "planned_calls",
                        pipelines.FirFftChainPlanar.planned_calls)
    n1, n2, L2 = 128, 512, 4
    f32 = torch.zeros
    Tfac = (f32(n1, L2), f32(n1, L2), f32(n1, 128), f32(n1, 128))
    W = (f32(L2, 128), f32(L2, 128))
    plan = pipelines._ChainPlan(torch.device("cuda", 0), f32(128), 128,
                                f32(n1 * n2), Tfac, W, n1, n2)
    before = kernels.launch_counts()

    def call():
        with profiling.span("dsp.chain", torch.device("cuda")):
            plan._issue(16, 32, 48, 64)
    _profiled(call)
    after = kernels.launch_counts()
    recs = profiling.spans()
    assert _launches(recs) == {"dsp.K7": 1, "dsp.K8": 1, "dsp.K1": 1}
    assert len(recs) == 1 + len(CHAIN) + len(NESTED)
    for r in recs:
        assert 0 <= r["launch_ns"] <= _dur(r) - r["trace_ns"]
    # one launch counted a launch the wrappers count
    assert {k: after[k] - before[k] for k in ("K7", "K8", "K1n")} == \
        {"K7": 1, "K8": 1, "K1n": 1}
    for e in (fake_entries.fir_window_launch,
              fake_entries.fourstep_stage1_launch,
              fake_entries.rowfft_mag_natural_launch):
        assert len(e.calls) == 1 and e.calls[0][-1] == STREAM


def test_off_a_launch_records_nothing_and_makes_no_span(fake_entries,
                                                         monkeypatch):
    def no_span(*args, **kwargs):
        raise AssertionError("a span made with the profiler off")
    monkeypatch.setattr(profiling, "span", no_span)
    monkeypatch.setattr(profiling, "_Span", no_span)
    monkeypatch.setattr(profiling, "launched", no_span)
    entry = _Entry(rc=5)
    assert _build.launch(torch.device("cuda"), entry, 1) == 5
    assert _build.call(entry, 2, STREAM) == 5
    assert entry.calls == [(1, STREAM), (2, STREAM)]
    assert profiling.spans() == []


def test_trace_ns_is_the_recorders_own_time_inside_each_interval():
    rec = profiling.SpanRecorder()
    with rec.span("dsp.root"):
        with rec.span("dsp.a"):
            time.sleep(0.002)
        with rec.span("dsp.b"):
            with rec.span("dsp.b.inner"):
                pass
    root, a, b, inner = rec.records()
    for r in (root, a, b, inner):
        assert 0 < r["trace_ns"] < _dur(r)
    # a root's host interval encloses its children's, and its trace time
    # holds theirs
    for r in (a, b, inner):
        assert root["start_ns"] < r["start_ns"] <= r["end_ns"] \
            < root["end_ns"]
    assert b["start_ns"] < inner["start_ns"] <= inner["end_ns"] \
        < b["end_ns"]
    assert b["trace_ns"] > inner["trace_ns"]
    assert root["trace_ns"] > a["trace_ns"] + b["trace_ns"]
    # the program's sleep is no trace time
    assert _dur(a) - a["trace_ns"] >= 2_000_000
    assert _dur(root) - root["trace_ns"] >= 2_000_000


def test_the_recorders_work_lies_inside_its_spans(fake_card, monkeypatch):
    """A root's taking back of finished calls' events runs inside its
    ``record_function`` and counts in its ``trace_ns``."""
    def slow_query(self):
        time.sleep(0.003)
        return True
    monkeypatch.setattr(_FakeEvent, "query", slow_query)
    rec = profiling.SpanRecorder()

    def call():
        with rec.span("dsp.root", fake_card):
            with rec.span("dsp.a"):
                pass
    call()                          # leaves two events to take back
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        call()
    second = [r for r in rec.records() if r["call"] == 1]
    root = second[0]
    assert root["parent"] is None and root["trace_ns"] >= 3_000_000
    assert _dur(root) - root["trace_ns"] < 3_000_000
    (event,) = [e for e in prof.profiler.kineto_results.events()
                if e.name() == "dsp.root"]
    assert event.duration_ns() >= 3_000_000


def test_stream_roots_hold_their_counters(monkeypatch):
    for name in ("chunks", "rows", "in_place"):
        monkeypatch.setattr(streaming.StreamingResampler, name,
                            getattr(streaming.StreamingResampler, name))
    depth = []

    def count(self, chunk):
        depth.append(len(profiling._RECORDER._stack()))
    monkeypatch.setattr(streaming.StreamingFir, "_count", count)
    prod = math.prod

    def counting_prod(shape):
        depth.append(len(profiling._RECORDER._stack()))
        return prod(shape)
    monkeypatch.setattr(streaming.math, "prod", counting_prod)
    fir = streaming.StreamingFir(torch.randn(2, 33))
    rs = streaming.StreamingResampler(SincFunction(), 160 / 147, 0.0, 10,
                                      device="cpu")
    chunk = torch.randn(2, 128 * 147)

    def both():
        fir.process(chunk[0], fir.init_state(torch.float32, "cpu"))
        rs.process(chunk, rs.init_state(torch.float32, "cpu", channels=2))
    _profiled(both)
    # each counted inside its root, after its last child closed
    assert depth == [1, 1]
    roots = [r["name"] for r in profiling.spans() if r["parent"] is None]
    assert roots == ["dsp.stream", "dsp.resample_stream"]


def _reader(name):
    return cells.module(cells.ROOT, "metrics", name)


def _rec(name, call, index, parent, stream_ms):
    return {"name": name, "call": call, "index": index, "parent": parent,
            "start_ns": 0, "end_ns": 1, "stream_ms": stream_ms}


def _hand_made():
    """Three chain calls with stream ms: roots 0.6, 0.5, 0.55 ms."""
    recs, i = [], 0
    for call, (root, fir, st1) in enumerate([(0.6, 0.25, 0.12),
                                             (0.5, 0.2, 0.1),
                                             (0.55, 0.3, 0.14)]):
        recs.append(_rec("dsp.chain", call, i, None, root))
        for name, ms in (("dsp.fir", fir), ("dsp.window", 0.05),
                         ("dsp.stage1", st1), ("dsp.K1", 0.07),
                         ("dsp.flatten", 0.02)):
            recs.append(_rec(name, call, i + 1, i, ms))
            i += 1
        i += 1
    # a call without markers counts for nothing
    recs.append(_rec("dsp.chain", 3, i, None, None))
    recs.append(_rec("dsp.fir", 3, i + 1, i, None))
    return recs


def test_readers_on_hand_made_records():
    recs = _hand_made()
    idle = _reader("call_idle_share")
    assert idle.value(recs, 0.44) == pytest.approx(1 - 0.44 / 0.55)
    assert idle.value(recs, None) is None
    assert _reader("fir_stream_ms").value(recs) == pytest.approx(0.25)
    assert _reader("stage1_stream_ms").value(recs) == pytest.approx(0.12)


def _timed(name, call, index, parent, start, end, trace, launch_ns=0,
           launches=0):
    return dict(_rec(name, call, index, parent, None), start_ns=start,
                end_ns=end, trace_ns=trace, launch_ns=launch_ns,
                launches=launches)


def test_host_split_readers_on_hand_made_records():
    """Three roots: 100, 60 and 80 us, each with its recorder's time and
    its kernel spans' launches (one, two in two spans, two in one); a root
    without a launch counts for nothing."""
    recs = []
    roots = [(100_000, 10_000, [(6_000, 1)]),
             (60_000, 6_000, [(3_000, 1), (2_000, 1)]),
             (80_000, 8_000, [(7_000, 2)])]
    i = 0
    for call, (dur, trace, kernels_) in enumerate(roots):
        t0 = call * 1_000_000
        recs.append(_timed("dsp.chain", call, i, None, t0, t0 + dur, trace))
        for j, (launch_ns, launches) in enumerate(kernels_):
            recs.append(_timed("dsp.K7", call, i + 1 + j, i, t0,
                               t0 + dur // 2, trace // 4, launch_ns,
                               launches))
        i += 1 + len(kernels_)
    recs.append(_timed("dsp.chain", 3, i, None, 0, 10**9, 0))
    # launch ns 6000, 5000, 7000; dispatch ns 84000, 49000, 65000
    assert _reader("launch_host_us").value(recs) == pytest.approx(6.0)
    assert _reader("dispatch_host_us").value(recs) == pytest.approx(65.0)


@pytest.mark.parametrize("name", ["call_idle_share", "fir_stream_ms",
                                  "stage1_stream_ms", "launch_host_us",
                                  "dispatch_host_us"])
def test_readers_give_none_without_marked_records(name):
    unmarked = [_rec("dsp.chain", 0, 0, None, None),
                _rec("dsp.fir", 0, 1, 0, None),
                _rec("dsp.stage1", 0, 2, 0, None)]
    mod = _reader(name)
    args = (0.44,) if name == "call_idle_share" else ()
    assert mod.value([], *args) is None
    assert mod.value(unmarked, *args) is None
    # in the process: the ring is empty (CPU calls, no profiler)
    t = type("T", (), {"device_ms": {"call": 0.44}})()
    assert mod.read(t) is None


@pytest.mark.card
def test_markers_resolve_and_a_root_covers_its_children(card):
    chain, planes = _chain(card, n=1 << 20), _planes(card, n=1 << 20)
    mod = channelizer.ChannelizeAndDemodPlanar(_prototype(card), C)
    for _ in range(3):       # builds and warms the kernels
        chain(*planes)
        mod(*planes)
    torch.cuda.synchronize()

    def calls():
        for _ in range(5):
            chain(*planes)
            mod(*planes)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        calls()
    recs = profiling.spans()
    by_call = {}
    for r in recs:
        by_call.setdefault(r["call"], []).append(r)
    assert len(by_call) == 10
    for group in by_call.values():
        root, children = _tree(group)
        want = CHAIN if root["name"] == "dsp.chain" else ["dsp.K6"]
        assert [r["name"] for r in children] == want
        assert root["stream_ms"] > 0
        assert all(r["stream_ms"] > 0 for r in children)
        total = sum(r["stream_ms"] for r in children)
        assert root["stream_ms"] >= 0.99 * total, (root, children)


@pytest.mark.card
def test_a_graph_capture_leaves_the_launch_counts(card):
    chain, planes = _chain(card, n=1 << 20), _planes(card, n=1 << 20)
    mod = channelizer.ChannelizeAndDemodPlanar(_prototype(card), C)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        chain(*planes)
        mod(*planes)
    torch.cuda.current_stream().wait_stream(stream)
    before = kernels.launch_counts()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        chain(*planes)
        mod(*planes)
    assert kernels.launch_counts() == before
    graph.replay()
    torch.cuda.synchronize()
    assert kernels.launch_counts() == before
    chain(*planes)
    mod(*planes)
    del graph
    want = dict(before, K1n=before["K1n"] + 1, K6=before["K6"] + 1,
                K7=before["K7"] + 1, K8=before["K8"] + 1)
    assert kernels.launch_counts() == want


@pytest.mark.card
def test_each_launch_is_counted_in_its_root(card):
    """Chain 3, channelizer 1, a stream chunk 1 (StreamingFir's bank,
    StreamingResampler on float32 and complex64): the launches each root's
    records count equal its wrappers' launches, and both readers read."""
    chain, planes = _chain(card, n=1 << 20), _planes(card, n=1 << 20)
    mod = channelizer.ChannelizeAndDemodPlanar(_prototype(card), C)
    g = torch.Generator().manual_seed(3)
    bank = streaming.StreamingFir(torch.randn(4, 129, generator=g).to(card))
    x = torch.randn(1 << 16, generator=g).to(card)
    rs = streaming.StreamingResampler(SincFunction(), 160 / 147, 0.0, 10,
                                      device=card)
    rows = torch.randn(4, 128 * 147, generator=g).to(card)
    zero = {dt: rs.init_state(dt, card, channels=4)
            for dt in (torch.float32, torch.complex64)}
    calls = {"dsp.chain": lambda: chain(*planes),
             "dsp.channelize": lambda: mod(*planes),
             "dsp.stream": lambda: bank.process(
                 x, bank.init_state(torch.float32, card)),
             "dsp.resample_stream": lambda: (
                 rs.process(rows, zero[torch.float32]),
                 rs.process(rows.to(torch.complex64),
                            zero[torch.complex64]))}
    for fn in calls.values():      # builds and warms the kernels
        fn()
    torch.cuda.synchronize()
    for root, fn in calls.items():
        profiling.reset_spans()
        before = kernels.launch_counts()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            fn()
            torch.cuda.synchronize()
        after = kernels.launch_counts()
        recs = profiling.spans()
        launched = sum(after[k] - before[k] for k in after)
        roots = [r for r in recs if r["parent"] is None]
        assert [r["name"] for r in roots] == [root] * len(roots)
        assert sum(_launches(recs).values()) == launched >= len(roots)
        for r in roots:
            mine = [q for q in recs if q["call"] == r["call"]]
            assert sum(_launches(mine).values()) == \
                (3 if root == "dsp.chain" else 1)
        for name in ("launch_host_us", "dispatch_host_us"):
            assert _reader(name).value(recs) > 0
