"""PyTorch port, autotune (basic_dsp_tpu_torch/autotune.py), on the CPU,
against the JAX package's autotune: the four cases of
tests/test_autotune.py run on both packages (lazy trigger, a measured and
persisted sweep, the cache picked up without timing, no trigger below the
overlap-save length), and the pinned "cpu" entry of tests/conftest.py
installs the same knobs in both.  The knobs, sources, device kinds and
reports compare exactly; timings are each package's own.
"""
import json
import os

import numpy as np
import pytest
import torch

import basic_dsp_tpu as bd
from basic_dsp_tpu import autotune as jat
from basic_dsp_tpu import config as jcfg
import basic_dsp_tpu_torch as bt
from basic_dsp_tpu_torch import autotune as tat
from basic_dsp_tpu_torch import config as tcfg

KNOBS = ("fft_block_len", "direct_conv_max_imp_len")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture
def fresh_cache(tmp_path, monkeypatch):
    """One temporary cache file for both packages, their states reset and
    their default configs restored afterwards."""
    path = tmp_path / "autotune.json"
    monkeypatch.setenv("BDSP_AUTOTUNE_CACHE", str(path))
    saved = (jcfg.default_config(), tcfg.default_config())
    jat._reset_for_tests()
    tat._reset_for_tests()
    yield path
    jat._reset_for_tests()
    tat._reset_for_tests()
    jcfg.set_default_config(saved[0])
    tcfg.set_default_config(saved[1])


def _knobs(cfg):
    return tuple(getattr(cfg, k) for k in KNOBS)


def _data(seed, n):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=n) + 1j * rng.normal(size=n)).astype(np.complex64)


def test_device_kind_of_cpu_data():
    """CPU data's kind is "cpu", the JAX package's kind on its CPU
    backend: both key the same cache entry."""
    assert tat._device_kind("cpu") == jat._device_kind() == "cpu"


def test_calibrate_measures_installs_and_persists(fresh_cache):
    """A small sweep on each package: the winner is a candidate, the
    crossover never below 202, the entry installed and persisted under the
    device kind, with the same keys and report lines in both."""
    kw = dict(n=1 << 14, block_candidates=(1024, 2048),
              crossover_kernels=(96,), iters=2)
    jentry = jat.calibrate(**kw)
    tentry = tat.calibrate(**kw, device="cpu")
    for entry, cfg in ((jentry, jcfg), (tentry, tcfg)):
        assert entry["fft_block_len"] in (1024, 2048)
        assert entry["direct_conv_max_imp_len"] >= 202
        assert cfg.default_config().fft_block_len == entry["fft_block_len"]
    assert set(tentry) == set(jentry)
    assert set(tentry["timings"]) == set(jentry["timings"])
    assert [len(v) for v in tentry["timings"].values()
            if isinstance(v, list)] == [
        len(v) for v in jentry["timings"].values() if isinstance(v, list)]
    on_disk = json.loads(fresh_cache.read_text())
    assert on_disk["cpu"]["fft_block_len"] == tentry["fft_block_len"]
    jreport, treport = jat.print_calibration(), tat.print_calibration()
    assert len(treport.splitlines()) == len(jreport.splitlines())
    assert "fft_block_len" in treport and "toeplitz" in treport


def test_fresh_process_picks_cache_without_measuring(fresh_cache):
    """Both packages load the same entry, install the same knobs, report
    "cache" and the same text, and are idempotent."""
    fresh_cache.write_text(json.dumps({"cpu": {
        "device_kind": "cpu", "fft_block_len": 8192,
        "direct_conv_max_imp_len": 256}}))
    jentry = jat.ensure_calibrated()
    tentry = tat.ensure_calibrated("cpu")
    assert tentry["source"] == jentry["source"] == "cache"
    assert _knobs(tcfg.default_config()) == _knobs(jcfg.default_config()) \
        == (8192, 256)
    assert tat.ensure_calibrated("cpu") is tentry
    assert tat.print_calibration() == jat.print_calibration()


def test_lazy_trigger_on_first_large_convolution(fresh_cache):
    """A typed convolution longer than overlap_save_min_len calibrates
    (from the cache) on both packages, for the data's device."""
    fresh_cache.write_text(json.dumps({"cpu": {
        "device_kind": "cpu", "fft_block_len": 2048,
        "direct_conv_max_imp_len": 202}}))
    n = tcfg.default_config().overlap_save_min_len + 24
    x, h = _data(1, n), _data(2, 17)
    assert tat._state is None and jat._state is None
    got = bt.to_complex_time_vec(x, device="cpu").convolve_signal(
        bt.to_complex_time_vec(h, device="cpu"))
    want = bd.to_complex_time_vec(x).convolve_signal(bd.to_complex_time_vec(h))
    assert tat._state is not None and jat._state is not None
    assert _knobs(tcfg.default_config()) == _knobs(jcfg.default_config()) \
        == (2048, 202)
    ref = np.asarray(want.array)
    assert np.max(np.abs(got.to_numpy() - ref)) / np.max(np.abs(ref)) <= 1e-5


def test_small_convolution_does_not_trigger(fresh_cache):
    x, h = _data(3, 256), _data(4, 9)
    bt.to_complex_time_vec(x, device="cpu").convolve_signal(
        bt.to_complex_time_vec(h, device="cpu"))
    bd.to_complex_time_vec(x).convolve_signal(bd.to_complex_time_vec(h))
    assert tat._state is None and jat._state is None


def test_pinned_cpu_entry_installs_the_same_config(monkeypatch):
    """The pinned cache of tests/data (conftest's BDSP_AUTOTUNE_CACHE)
    installs the same knobs in both packages, without timing."""
    path = os.path.join(os.path.dirname(__file__), "data",
                        "autotune_pinned.json")
    monkeypatch.setenv("BDSP_AUTOTUNE_CACHE", path)
    saved = (jcfg.default_config(), tcfg.default_config())
    jat._reset_for_tests()
    tat._reset_for_tests()
    try:
        jentry = jat.ensure_calibrated()
        tentry = tat.ensure_calibrated("cpu")
        assert jentry["source"] == tentry["source"] == "cache"
        assert _knobs(tcfg.default_config()) == _knobs(jcfg.default_config())
        with open(path) as f:
            pinned = json.load(f)["cpu"]
        assert _knobs(tcfg.default_config()) == tuple(pinned[k]
                                                      for k in KNOBS)
    finally:
        jat._reset_for_tests()
        tat._reset_for_tests()
        jcfg.set_default_config(saved[0])
        tcfg.set_default_config(saved[1])


def test_default_cache_is_the_ports_own(monkeypatch, tmp_path):
    """Without BDSP_AUTOTUNE_CACHE the two packages use two files, so
    neither overwrites the other's "cpu" entry."""
    monkeypatch.delenv("BDSP_AUTOTUNE_CACHE", raising=False)
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path))
    assert tat._cache_path() != jat._cache_path()
    assert tat._cache_path().endswith(
        "basic_dsp_tpu_torch/autotune.json")


def test_default_device_is_the_card():
    """The default device is the card: its kind is the card's name, and
    without CUDA the default raises (calibrate never times the CPU
    instead)."""
    if torch.cuda.is_available():
        assert tat._device_kind() == torch.cuda.get_device_name()
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tat._device_kind()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tat.calibrate(n=1 << 10)


@pytest.mark.parametrize("order", [("kind-a", "kind-b"), ("kind-b", "kind-a")])
def test_each_device_kind_runs_its_own_entry(fresh_cache, monkeypatch, order):
    """Two device kinds in one process, each with a cache entry of other
    knobs: a typed convolution of each kind, large (which calibrates from
    the cache) or small, runs its own kind's knobs in either order;
    ensure_calibrated returns each kind's entry, the default config
    carries the knobs installed last (the JAX package's one-kind
    behaviour), a small convolution of a third kind with no entry runs
    the untuned knobs, and _reset_for_tests clears every entry."""
    entries = {"kind-a": {"device_kind": "kind-a", "fft_block_len": 2048,
                          "direct_conv_max_imp_len": 202},
               "kind-b": {"device_kind": "kind-b", "fft_block_len": 8192,
                          "direct_conv_max_imp_len": 320}}
    fresh_cache.write_text(json.dumps(entries))
    kind = {"now": None}
    monkeypatch.setattr(tat, "_device_kind", lambda device=None: kind["now"])
    seen = []
    convolve = bt.conv_ops.convolve_signal

    def spy(x, h, is_complex, cfg=None):
        seen.append(_knobs(cfg))
        return convolve(x, h, is_complex, cfg)

    monkeypatch.setattr(bt.conv_ops, "convolve_signal", spy)
    n = tcfg.default_config().overlap_save_min_len + 24
    h = bt.to_complex_time_vec(_data(2, 17), device="cpu")
    large = bt.to_complex_time_vec(_data(1, n), device="cpu")
    small = bt.to_complex_time_vec(_data(3, 256), device="cpu")
    want = {k: _knobs(tcfg.DspConfig(**{f: e[f] for f in KNOBS}))
            for k, e in entries.items()}
    for k in order:
        kind["now"] = k
        large.convolve_signal(h)
        assert seen[-1] == want[k]
        assert _knobs(tcfg.default_config()) == want[k]
    for k in order:
        kind["now"] = k
        small.convolve_signal(h)
        assert seen[-1] == want[k]
        assert tat.ensure_calibrated()["device_kind"] == k
    assert set(tat._entries) == set(entries)
    kind["now"] = "kind-c"      # no entry: the untuned knobs, no timing
    small.convolve_signal(h)
    assert seen[-1] == _knobs(tcfg.DspConfig())
    assert set(tat._entries) == set(entries)
    tat._reset_for_tests()
    assert tat._entries == {} and tat._state is None
