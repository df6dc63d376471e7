"""PyTorch port, the user examples (basic_dsp_tpu_torch/examples/), each
against the JAX example of the same name on the same inputs: the
modulation CSVs within 1e-5, the crosstalk and slow-down WAVs within one
PCM16 step, the streaming pipeline's printed lines (powers to their 4
printed decimals) equal, ``custom_window`` and
``interpolatef_vs_interpolate``'s arrays within 1e-5 of the maximum,
``approx_accuracy``'s largest errors within twice the JAX example's;
``interpolation`` against ``scipy.signal.resample`` and
``python_ctypes_example`` on the port's C library with BDSP_PLATFORM=cpu;
``show_calibration`` into a temporary cache.

The JAX examples are loaded from their files under names of their own;
the twins only as ``basic_dsp_tpu_torch.examples.<name>``, so that the
bare names ``crosstalk`` and ``modulation`` of tests/test_examples.py stay
the JAX ones in a worker that runs both files.
"""
import importlib.util
import os
import sys

import numpy as np
import pytest
import torch

from basic_dsp_tpu_torch import autotune, config
from basic_dsp_tpu_torch import io as bio
from basic_dsp_tpu_torch.examples import (approx_accuracy, crosstalk,
                                          custom_window,
                                          interpolatef_vs_interpolate,
                                          interpolation, modulation,
                                          python_ctypes_example,
                                          show_calibration, slow_down_music,
                                          streaming_pipeline)

EXAMPLES = os.path.join(os.path.dirname(__file__), "..", "examples")
TOL = 1e-5
PCM16_STEP = 1 / 32767


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _jax_example(name):
    """The JAX example ``examples/<name>.py`` as module ``_jax_<name>``;
    ``slow_down_music`` imports ``crosstalk`` by its bare name, from
    ``examples/`` (as tests/test_examples.py puts it on the path)."""
    if EXAMPLES not in sys.path:
        sys.path.insert(0, EXAMPLES)
    key = f"_jax_{name}"
    if key not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            key, os.path.join(EXAMPLES, f"{name}.py"))
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        sys.modules[key] = module
    return sys.modules[key]


def _rel(got, ref):
    return float(np.max(np.abs(got - ref)) / np.max(np.abs(ref)))


def test_modulation_csvs_match_jax(tmp_path):
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    _jax_example("modulation").main(str(tmp_path / "jax"))
    modulation.main(str(tmp_path / "port"), device="cpu")
    for i in range(3):
        for name, kw in ((f"baseband_time{i}.csv", {"delimiter": ","}),
                         (f"modulated_time{i}.csv", {})):
            got = np.loadtxt(tmp_path / "port" / name, **kw)
            want = np.loadtxt(tmp_path / "jax" / name, **kw)
            assert got.shape == want.shape, name
            assert np.max(np.abs(got - want)) <= TOL, name
        # raised-cosine shaping keeps each symbol at its symbol instant
        real = np.loadtxt(tmp_path / "port" / f"modulated_time{i}.csv")
        assert real.shape == (10 * modulation.NUMBER_OF_SYMBOLS,)
        assert np.max(np.abs(np.abs(real[::10]) - 0.5)) <= TOL


def _stereo(path, ch1, ch2):
    bio.write_wav(str(path), np.stack([ch1, ch2], axis=1), 44100)


def _read(path):
    frames, rate = bio.read_wav(str(path))
    return frames, rate


@pytest.mark.parametrize("example", ["crosstalk", "slow_down_music"])
def test_wav_examples_match_jax_within_one_pcm16_step(tmp_path, example):
    rng = np.random.default_rng(0)
    n = 1500
    t = np.arange(n)
    if example == "crosstalk":
        ch1, ch2 = rng.uniform(-0.5, 0.5, n), rng.uniform(-0.5, 0.5, n)
    else:
        ch1 = 0.5 * np.sin(2 * np.pi * 0.01 * t)
        ch2 = 0.5 * np.cos(2 * np.pi * 0.013 * t) + 0.1 * rng.normal(size=n)
    src = tmp_path / "src.wav"
    _stereo(src, ch1, ch2)
    _jax_example(example).main(str(src), str(tmp_path / "jax.wav"))
    port = {"crosstalk": crosstalk, "slow_down_music": slow_down_music}
    port[example].main(str(src), str(tmp_path / "port.wav"), device="cpu")
    got, rate = _read(tmp_path / "port.wav")
    want, jrate = _read(tmp_path / "jax.wav")
    assert rate == jrate == 44100
    assert got.shape == want.shape == (
        n if example == "crosstalk" else n * 3 // 2, 2)
    assert np.max(np.abs(got - want)) <= PCM16_STEP * (1 + 1e-6)
    assert np.max(np.abs(got)) > 0.1


def test_streaming_pipeline_prints_what_jax_prints(capsys):
    _jax_example("streaming_pipeline").main(4)
    want = capsys.readouterr().out
    out = streaming_pipeline.main(4, device="cpu")
    got = capsys.readouterr().out
    assert got == want
    assert got.count("chunk") == 4 and "resampled 768" in got
    assert out["input"].shape == (4 * streaming_pipeline.CHUNK,)
    assert out["resampled"].shape == out["filtered"].shape == (4 * 768,)


def test_custom_window_matches_jax(capsys):
    jex = _jax_example("custom_window")
    import basic_dsp_tpu as bd
    jex.main()
    want_text = capsys.readouterr().out
    got_conv, got_spec = custom_window.main(device="cpu")
    assert capsys.readouterr().out == want_text
    want_conv = np.asarray(bd.to_real_time_vec(np.zeros(100, np.float32))
                           .convolve(jex.Identity(), 1.0, 12).to_numpy())
    rng = np.random.default_rng(0)
    want_spec = np.asarray(bd.to_real_time_vec(
        rng.normal(size=256).astype(np.float32)).windowed_fft(
            jex.Welch()).to_numpy())
    np.testing.assert_array_equal(got_conv, want_conv)
    assert _rel(got_spec, want_spec) <= TOL


def test_interpolatef_vs_interpolate_matches_jax(tmp_path):
    _jax_example("interpolatef_vs_interpolate").main(str(tmp_path / "j.csv"))
    rows = interpolatef_vs_interpolate.main(str(tmp_path / "p.csv"),
                                            device="cpu")

    def table(path):
        out = {}
        for line in path.read_text().splitlines():
            name, *vals = [c.strip() for c in line.split(",")]
            out[name] = np.array([float(v) for v in vals if v])
        return out

    got, want = table(tmp_path / "p.csv"), table(tmp_path / "j.csv")
    assert list(got) == list(want) == [name for name, _ in rows]
    for name in got:
        assert _rel(got[name], want[name]) <= TOL, name


def test_approx_accuracy_at_jax_grade(capsys):
    _jax_example("approx_accuracy").main()
    jerr = capsys.readouterr().err
    maxima = approx_accuracy.main(device="cpu")
    assert config.matmul_precision() == "highest"
    want = {line.split(" max, ")[0]: float(line.split(" max, ")[1])
            for line in jerr.splitlines() if " max, " in line}
    assert set(want) == {"Sin", "Cos", "Ln", "Exp", "Log2", "Expf2",
                         "Powf2"}
    for name, jax_max in want.items():
        assert maxima[name] <= 2 * jax_max, (name, maxima[name], jax_max)
    assert maxima["FIR high"] == 0.0


def test_interpolation_through_the_c_abi_matches_scipy(tmp_path,
                                                       monkeypatch):
    monkeypatch.setenv("BDSP_PLATFORM", "cpu")
    out = tmp_path / "interpolation.csv"
    assert interpolation.main(str(out)) == 0
    rows = {line.split(",")[0]: np.array(
        [float(v) for v in line.split(",")[1:] if v.strip()])
        for line in out.read_text().splitlines()}
    from scipy import signal
    want = signal.resample(rows["data"], 100)
    assert np.max(np.abs(rows["resampled basic_dsp_tpu_torch"] - want)) \
        <= 1e-9


def test_python_ctypes_example_on_the_port_library(monkeypatch, capsys):
    monkeypatch.setenv("BDSP_PLATFORM", "cpu")
    assert python_ctypes_example.main() == 0
    out = capsys.readouterr().out
    assert "vec[0] = 50.0" in out and out.endswith("ok\n")


def test_show_calibration_into_a_temporary_cache(tmp_path, monkeypatch):
    path = tmp_path / "autotune.json"
    monkeypatch.setenv("BDSP_AUTOTUNE_CACHE", str(path))
    saved = config.default_config()
    autotune._reset_for_tests()
    try:
        best = show_calibration.main(device="cpu")
    finally:
        autotune._reset_for_tests()
        config.set_default_config(saved)
    assert best["device_kind"] == "cpu"
    assert best["fft_block_len"] in (512, 1024, 2048, 4096)
    assert path.exists()
