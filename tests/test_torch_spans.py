"""PyTorch port, the spans of the call path (basic_dsp_tpu_torch/
profiling.py ``span``, ``spanned``, ``spans``, ``reset_spans``) and the
benchmark's readers of them (dspbench/metrics/call_idle_share.py,
fir_stream_ms.py, stage1_stream_ms.py), on the CPU: off without a
profiler; under ``torch.profiler`` the chain's and the channelizer's span
trees, one call id a call, a ``record_function`` of each name, no stream
ms; the ring's bound; the readers on hand-made records.  The tests marked
``card`` skip without CUDA (on the card: ``python3 -m pytest --noconftest
tests/test_torch_spans.py``, since tests/conftest.py imports JAX): the
markers resolve, a root's stream ms covers its children's, and a CUDA
graph capture leaves the launch counts as they were.  This file imports
no JAX."""
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from basic_dsp_tpu_torch import kernels, pipelines, profiling
from basic_dsp_tpu_torch.conv_types import RaisedCosineFunction
from basic_dsp_tpu_torch.kernels import channelizer_cuda, fir_cuda
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
    # the module's ring holds a profiled second of either cell
    assert profiling.RING_RECORDS >= max(1500 * 6, 9000 * 2)


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


@pytest.mark.parametrize("name", ["call_idle_share", "fir_stream_ms",
                                  "stage1_stream_ms"])
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
