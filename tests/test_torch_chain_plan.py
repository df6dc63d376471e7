"""PyTorch port, the flagship chain's launch plan
(basic_dsp_tpu_torch/pipelines.py ``FirFftChainPlanar``, ``_ChainPlan``).

On the CPU, on a stand-in card (tensors that report card 0, a fake
library that records each C entry's arguments): the plan passes K7, K8
and K1 what their wrappers pass for the same planes; it counts one launch
of each and one planned call a call, none while a CUDA graph is captured;
it declines what it does not hold, which takes ``_planar_chain``; it
raises as the wrappers do where an entry fails; the module drops its
plans when it moves, a buffer is replaced or it is copied.  The tests
marked ``card`` skip without CUDA (on the card: ``python3 -m pytest
--noconftest tests/test_torch_chain_plan.py``, since tests/conftest.py
imports JAX): the planned call is bit-equal to the wrappers' route, held
outputs stay apart, a CUDA graph of it replays, a misaligned view takes
the wrappers.  This file imports no JAX."""
import copy

import pytest
import torch

from basic_dsp_tpu_torch import kernels, pipelines
from basic_dsp_tpu_torch.kernels import _build, fir_cuda, spectrum_cuda

N = 1 << 16                   # n1 = 128, n2 = 512
STREAM = 0x5EED
# the leading pointer arguments of each entry
POINTERS = {"K7": 6, "K8": 4, "K1n": 10}
Chain = pipelines.FirFftChainPlanar


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


class _OnCard(torch.Tensor):
    """A CPU tensor that reports itself on card 0."""

    @property
    def is_cuda(self):
        return True

    @property
    def device(self):
        return torch.device("cuda", 0)

    def get_device(self):
        return 0


class _FakeLib:
    """The three C entries, each recording its arguments in ``calls``."""

    def __init__(self):
        self.calls = []
        self.fails = None     # the entry that returns an error code

    def _entry(name):
        def launch(self, *args):
            self.calls.append((name, args))
            return 7 if name == self.fails else 0
        return launch

    fir_window_launch = _entry("K7")
    fourstep_stage1_launch = _entry("K8")
    rowfft_mag_natural_launch = _entry("K1n")

    def fir_window_error_string(self, rc):
        return f"fake error {rc}".encode()

    rowfft_mag_error_string = fir_window_error_string


@pytest.fixture
def fake_card(monkeypatch):
    """The wrappers' and the plan's CUDA calls on the CPU: a fake library,
    card 0 current, stream ``STREAM``, allocations on the card made as
    :class:`_OnCard` tensors."""
    lib = _FakeLib()
    monkeypatch.setattr(fir_cuda, "_lib", lambda: lib)
    monkeypatch.setattr(spectrum_cuda, "_lib", lambda: lib)
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


def _chain(n=N, m=128, n1=128, fused=False, on_card=True):
    g = torch.Generator().manual_seed(1)
    chain = Chain(torch.randn(m, generator=g), torch.hamming_window(n),
                  n1=n1, fused=fused)
    if on_card:
        for name, b in chain._buffers.items():
            if b is not None:
                chain._buffers[name] = b.as_subclass(_OnCard)
    return chain


def _planes(n=N, seed=0, on_card=True):
    g = torch.Generator().manual_seed(seed)
    planes = (torch.randn(n, generator=g), torch.randn(n, generator=g))
    return tuple(p.as_subclass(_OnCard) for p in planes) if on_card \
        else planes


def _held(chain):
    return ((chain.tw_ar, chain.tw_ai, chain.tw_br, chain.tw_bi),
            (chain.w_r, chain.w_i))


def _wrappers(chain, xr, xi):
    Tfac, W = _held(chain)
    return pipelines._planar_chain(xr, xi, chain.taps, chain.bands,
                                   chain.window, Tfac, W, chain.n1,
                                   chain.n2, False)


def _normalised(calls, known):
    """Each call's pointers named: a known plane by its place in
    ``known``, any other by the order it first appears in."""
    known = {p.data_ptr(): ("held", i) for i, p in enumerate(known)}
    fresh, out = {}, []
    for name, args in calls:
        k = POINTERS[name]
        ptrs = tuple(None if p is None else known.get(p) or fresh.setdefault(
            p, ("fresh", len(fresh))) for p in args[:k])
        out.append((name, ptrs, args[k:]))
    return out


def test_plan_passes_the_entries_what_the_wrappers_pass(fake_card):
    chain, (xr, xi) = _chain(), _planes()
    _wrappers(chain, xr, xi)
    wrapped, fake_card.calls = fake_card.calls, []
    chain(xr, xi)
    planned = fake_card.calls
    Tfac, W = _held(chain)
    known = (xr, xi, chain.taps, chain.window, *Tfac, *W)
    assert [name for name, _ in planned] == ["K7", "K8", "K1n"]
    assert _normalised(planned, known) == _normalised(wrapped, known)
    # the scalars as the module's geometry gives them, then the stream
    assert [args[POINTERS[name]:] for name, args in planned] == [
        (N, 128, STREAM), (128, 512, STREAM), (128, 4, 64, STREAM)]
    # K8 reads what K7 wrote, K1 what K8 wrote; five planes of scratch
    k7, k8, k1 = (args for _, args in planned)
    assert k8[:2] == k7[4:6] and k1[:2] == k8[2:4]
    s = k7[4]
    assert [k7[5], k8[2], k8[3], k1[8]] == [s + 4 * N * i for i in (1, 2,
                                                                      3, 4)]


def test_plan_counts_each_launch_and_none_in_a_capture(fake_card,
                                                        monkeypatch):
    chain, (xr, xi) = _chain(), _planes()
    before, planned = kernels.launch_counts(), Chain.planned_calls
    chain(xr, xi)
    chain(xr, xi)
    want = dict(before, K7=before["K7"] + 2, K8=before["K8"] + 2,
                K1n=before["K1n"] + 2)
    assert kernels.launch_counts() == want
    assert Chain.planned_calls == planned + 2
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    chain(xr, xi)
    assert kernels.launch_counts() == want
    assert Chain.planned_calls == planned + 2
    assert len(fake_card.calls) == 9


def _declined(case):
    """(chain, xr, xi) of each case that the plan declines."""
    if case == "cpu":
        return (_chain(on_card=False), *_planes(on_card=False))
    if case == "fused":
        return (_chain(fused=True), *_planes())
    if case == "taps_k7_refuses":
        return (_chain(m=fir_cuda.MAX_TAPS + 88), *_planes())
    if case == "n1_k8_refuses":
        return (_chain(n=96 * 512, n1=96), *_planes(n=96 * 512))
    xr, xi = _planes()
    if case == "misaligned":
        xr, xi = (torch.cat((p[:1], p)).as_subclass(_OnCard)[1:]
                  for p in (xr, xi))
    elif case == "float64":
        xr, xi = xr.double(), xi.double()
    elif case == "grad":
        xr.requires_grad_(True)
    return _chain(), xr, xi


@pytest.mark.parametrize("case", ["cpu", "fused", "misaligned", "float64",
                                  "grad", "taps_k7_refuses",
                                  "n1_k8_refuses"])
def test_plan_declines_what_it_does_not_hold(case, fake_card, monkeypatch):
    chain, xr, xi = _declined(case)
    taken, sentinel = [], torch.zeros(1)

    def planar_chain(*args):
        taken.append(args)
        return sentinel
    monkeypatch.setattr(pipelines, "_planar_chain", planar_chain)
    planned = Chain.planned_calls
    with torch.enable_grad():
        assert chain(xr, xi) is sentinel
    assert len(taken) == 1 and taken[0][0] is xr and taken[0][1] is xi
    assert Chain.planned_calls == planned
    assert fake_card.calls == []


@pytest.mark.parametrize("entry", ["K7", "K8", "K1n"])
def test_plan_raises_as_the_wrappers_where_an_entry_fails(entry, fake_card):
    fake_card.fails = entry
    chain, (xr, xi) = _chain(), _planes()
    with pytest.raises(RuntimeError) as wrapped:
        _wrappers(chain, xr, xi)
    before, planned = kernels.launch_counts(), Chain.planned_calls
    with pytest.raises(RuntimeError) as got:
        chain(xr, xi)
    assert str(got.value) == str(wrapped.value)
    assert "kernel launch failed: fake error 7" in str(got.value)
    # the launches before the failed one count, as the wrappers count them
    ran = ["K7", "K8", "K1n"][:["K7", "K8", "K1n"].index(entry)]
    assert kernels.launch_counts() == dict(
        before, **{k: before[k] + 1 for k in ran})
    assert Chain.planned_calls == planned


def test_module_drops_its_plans_when_it_moves(fake_card):
    chain, (xr, xi) = _chain(), _planes()
    chain(xr, xi)
    assert list(chain._plans) == [0]
    plain = _chain(on_card=False)           # a copy builds its own plans
    plain._plans[0] = "a plan"
    assert copy.deepcopy(plain)._plans == {}
    assert plain._plans == {0: "a plan"}
    chain.float()
    assert chain._plans == {}
    chain(xr, xi)
    chain.window = chain.window.clone()
    assert chain._plans == {}
    chain(xr, xi)
    assert [args[3] for name, args in fake_card.calls if name == "K7"][-1] \
        == chain.window.data_ptr()


# --- on the card -----------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: run on the card")
    return torch.device("cuda")


def _on(device, n, seed=0):
    g = torch.Generator().manual_seed(seed)
    chain = Chain(torch.randn(128, generator=g),
                  torch.hamming_window(n), n1=128).to(device)
    return chain, [tuple(torch.randn(n, generator=g).to(device)
                         for _ in range(2)) for _ in range(3)]


@pytest.mark.card
@pytest.mark.parametrize("n", [1 << 22, 1 << 16])
def test_planned_call_is_bit_equal_to_the_wrappers(card, n):
    chain, planes = _on(card, n)
    for xr, xi in planes:
        planned = Chain.planned_calls
        got = chain(xr, xi)
        assert Chain.planned_calls == planned + 1
        assert torch.equal(got, _wrappers(chain, xr, xi))


@pytest.mark.card
def test_held_outputs_stay_apart(card):
    chain, planes = _on(card, 1 << 22)
    a, b = chain(*planes[0]), chain(*planes[1])
    chain(*planes[2])
    torch.cuda.synchronize()
    assert a.data_ptr() != b.data_ptr()
    assert torch.equal(a, _wrappers(chain, *planes[0]))
    assert torch.equal(b, _wrappers(chain, *planes[1]))
    assert not torch.equal(a, b)


@pytest.mark.card
def test_a_graph_of_the_planned_call_replays(card):
    chain, planes = _on(card, 1 << 22)
    xr, xi = planes[0]
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        chain(xr, xi)
    torch.cuda.current_stream().wait_stream(stream)
    before, planned = kernels.launch_counts(), Chain.planned_calls
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        out = chain(xr, xi)
    graph.replay()
    torch.cuda.synchronize()
    assert kernels.launch_counts() == before
    assert Chain.planned_calls == planned
    assert torch.equal(out, chain(xr, xi))
    del graph


@pytest.mark.card
def test_a_misaligned_view_takes_the_wrappers(card):
    chain, planes = _on(card, 1 << 16)
    xr, xi = (torch.cat((p[:1], p))[1:] for p in planes[0])
    planned = Chain.planned_calls
    got = chain(xr, xi)
    assert Chain.planned_calls == planned
    assert torch.equal(got, chain(*planes[0]))
    assert Chain.planned_calls == planned + 1
