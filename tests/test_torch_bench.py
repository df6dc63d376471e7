"""PyTorch port, the benchmark programs (basic_dsp_tpu_torch/bench/:
``timing``, ``bench``, ``bench_all``, ``bench_scaling``, ``round_summary``,
and the root launcher bench_torch.py) against the JAX repository's root
programs of the same names, on the CPU.

- each of bench_all's five config bodies, with a carry, against the JAX
  body of the reference's ``bench_all.main`` at the sizes / 2^8, from the
  same numpy seed-0 inputs: within 1e-5 of the maximum (the channelizer's
  angles by their wrapped difference weighted by |z|, of max |z|);
  measured 1.0e-7 to 1.8e-7;
- ``timing.fold`` against the fold inside the reference's
  ``bench_all.timed`` (caught by a ``jax.debug.callback`` on the carry),
  within 1e-6;
- ``bench_all.merge_captures`` against the reference's on the same
  synthetic sessions, and the refusal of a capture above its floor;
- ``bench_scaling.comm_bytes`` against the reference's
  ``_build_workloads`` models;
- the floor model (``dspbench/floors.py``, which the programs read)
  against hand counts, a FIR's operations the fewer of the direct sum's
  and overlap-save's;
- a CUDA-graph capture leaving the kernels' launch counts;
- ``timing.device_ms`` summing kernels and not the spans' user
  annotations (a fake profiler window);
- the scaling sweep on gloo ranks at d = 1, 2 and n = 2^12, every point
  within 1e-5 of its single-device function;
- ``round_summary`` over a temporary directory;
- every program exiting non-zero without a card unless given
  ``--device cpu``.

The reference programs are loaded from their files under names of their
own; ``bench_all.py`` and ``bench_scaling.py`` import JAX only inside
their functions.
"""
import importlib.util
import json
import math
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from basic_dsp_tpu_torch.bench import (bench, bench_all, bench_scaling,
                                       round_summary, timing)
from dspbench import floors

ROOT = os.path.join(os.path.dirname(__file__), "..")
SHIFT = 8
TOL = 1e-5
CONFIGS = ("windowed_fft_magnitude_1m", "rc_fir_4m", "interpolatef_1_5x_1m",
           "modulation_chain_131k_symbols", "channelizer_1024ch_4m")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _reference(name):
    spec = importlib.util.spec_from_file_location(
        f"_jax_root_{name}", os.path.join(ROOT, f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def inp():
    return bench_all.inputs(SHIFT)


def _jax_bodies(inp):
    """The bodies of the reference's ``bench_all.main``, configs 1-5, each
    a function of the carry, on the same numpy inputs."""
    from basic_dsp_tpu import pipelines
    from basic_dsp_tpu.conv_types import SincFunction
    from basic_dsp_tpu.ops import conv_ops, interp_ops
    from basic_dsp_tpu.parallel import channelizer
    from basic_dsp_tpu.windows import HammingWindow

    j = {k: jnp.asarray(v) for k, v in inp.items()}
    w1 = HammingWindow().sample(inp["sine"].shape[-1], dtype=jnp.float32)

    def cfg2(c):
        re, im = conv_ops.convolve_signal_planar(
            j["x_re"] + c, j["x_im"], j["rc_taps"].astype(jnp.complex64))
        return re + im

    def cfg3(c):
        f = SincFunction()
        re = interp_ops.interpolatef(j["a_re"] + c, f, 1.5, 0.0, 10, 1.0)
        im = interp_ops.interpolatef(j["a_im"], f, 1.5, 0.0, 10, 1.0)
        return jnp.concatenate([re, im])

    def cfg4(c):
        re, im = pipelines.modulation_chain_planar(j["s_re"] + c, j["s_im"])
        return re + im

    return {
        "windowed_fft_magnitude_1m":
            lambda c: pipelines._shifted_mag((j["sine"] + c) * w1),
        "rc_fir_4m": cfg2,
        "interpolatef_1_5x_1m": cfg3,
        "modulation_chain_131k_symbols": cfg4,
        "channelizer_1024ch_4m":
            lambda c: channelizer.channelize_and_demod_planar(
                j["c_re"] + c, j["c_im"], j["proto"],
                bench_all.CHANNELS),
    }


@pytest.mark.parametrize("name", CONFIGS)
def test_config_body_matches_the_jax_body(inp, name):
    cfgs = {c.metric: c for c in bench_all.configs(inp, "cpu")}
    assert list(cfgs) == list(CONFIGS)
    cfg = cfgs[name]
    n = cfg.args[0].shape[-1]
    carry = (np.random.default_rng(1).normal(size=n) * 1e-3).astype(
        np.float32)
    got = cfg.body(*cfg.args, torch.from_numpy(carry)).numpy()
    want = np.asarray(_jax_bodies(inp)[name](jnp.asarray(carry)))
    assert got.shape == want.shape, (got.shape, want.shape)
    if name == "channelizer_1024ch_4m":
        # angles: the wrapped difference weighted by |z|, z = y conj(prev)
        # of the channels y (an angle where |z| ~ 0 has no phase to agree
        # on), of max |z|, as tests/test_torch_channelizer.py holds them
        from basic_dsp_tpu.parallel import channelizer as jch
        x = (inp["c_re"] + carry) + 1j * inp["c_im"]
        y = np.asarray(jch.polyphase_channelizer(
            jnp.asarray(x.astype(np.complex64)), jnp.asarray(inp["proto"]),
            bench_all.CHANNELS), np.complex128)
        amp = np.abs(y * np.conj(np.concatenate([y[:, :1], y[:, :-1]], 1)))
        d = np.abs(np.angle(np.exp(1j * (got.astype(np.float64) - want))))
        err = (amp * d).max() / amp.max()
    else:
        err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= TOL, (name, err)
    # the carry reaches the output
    moved = cfg.body(*cfg.args, torch.from_numpy(carry * 0)).numpy()
    assert not np.array_equal(moved, got) or name == "channelizer_1024ch_4m"


def test_fold_matches_the_reference_timed_fold():
    ref = _reference("bench_all")
    n = 64
    rng = np.random.default_rng(2)
    for out in ((rng.normal(size=3 * n + 7)
                 + 1j * rng.normal(size=3 * n + 7)).astype(np.complex64),
                rng.normal(size=(5, 2 * n)).astype(np.float32)):
        caught = []

        def fn(x, carry, out=out):
            jax.debug.callback(lambda c: caught.append(np.asarray(c)), carry)
            return jnp.asarray(out)

        ref.timed(fn, jnp.zeros(n, jnp.float32), iters=1)
        want = [c for c in caught if np.any(c)][-1]
        got = timing.fold(torch.from_numpy(out), n).numpy()
        assert got.shape == want.shape == (n,)
        assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


def _sessions():
    """Three synthetic sessions: a good capture each, a capture past its
    floor, one with a wide spread and one below its bytes time."""
    def cfg(metric, ms, spread=1.1, floor=0.5, value=100.0, bytes_ms=0.2):
        return {"metric": metric, "value": value, "unit": "Msamples/s",
                "vs_baseline": floor / ms, "measured_ms": ms,
                "slope_spread": spread, "floor_ms": floor,
                "max_vs_floor": bench_all.MAX_VS_FLOOR,
                "model": {"bytes_ms": bytes_ms}}
    keys = {"device": "card", "mxu_tflops_highest": 1.0, "hbm_gbps": 3350.0,
            "card": "card, 700.00 W", "fp32_tflops": 67.0,
            "numeric_mode": timing.NUMERIC_MODE}
    return [
        (dict(keys, configs=[cfg("a", 2.0), cfg("b", 1.0)]), 1.5),
        (dict(keys, configs=[cfg("a", 0.4), cfg("b", 0.9, spread=1.8)]),
         3.0),
        (dict(keys, configs=[cfg("a", 1.5), cfg("c", 0.1, floor=0.05)]),
         2.0),
    ]


def _strip(merged):
    for c in merged["configs"]:
        for cap in c.get("captures", []):
            cap.pop("ts")
    return merged


def test_merge_captures_matches_the_reference(tmp_path):
    ref = _reference("bench_all")
    ours, theirs = tmp_path / "ours.json", tmp_path / "theirs.json"
    for session, probe in _sessions():
        for path, merge in ((ours, bench_all.merge_captures),
                            (theirs, ref.merge_captures)):
            merged = merge(str(path), session, probe)
            path.write_text(json.dumps(merged))
    got, want = (_strip(json.loads(p.read_text())) for p in (ours, theirs))
    assert got["configs"] == want["configs"]
    for k in ("device", "hbm_gbps"):
        assert got[k] == want[k]
    by = {c["metric"]: c for c in got["configs"]}
    # a: 0.4 ms reads 1.25x its 0.5 ms floor and is refused; the best of
    # the others is 1.5 ms
    assert by["a"]["measured_ms"] == 1.5 and by["a"]["n_captures"] == 3
    assert by["a"]["vs_baseline"] == round(0.5 / 1.5, 4)
    # b: its 1.8x-spread capture refused; c: below its bytes time, refused,
    # and with no capture left it is unhealthy
    assert by["b"]["measured_ms"] == 1.0
    assert by["c"]["unhealthy"] and by["c"]["vs_baseline"] == 0.0


def test_a_capture_past_its_floor_is_refused(tmp_path):
    over = {"metric": "x", "value": 1.0, "measured_ms": 0.9,
            "slope_spread": 1.0, "floor_ms": 1.0, "max_vs_floor": 1.0,
            "model": {"bytes_ms": 0.1}}
    merged = bench_all.merge_captures(str(tmp_path / "m.json"),
                                      {"configs": [over]}, 1.0)
    assert merged["configs"][0]["unhealthy"]
    assert merged["configs"][0]["vs_baseline"] == 0.0


@pytest.mark.parametrize("n, d", [(1 << 20, 2), (1 << 20, 4), (1 << 12, 8)])
def test_comm_models_match_the_reference(n, d):
    ref = _reference("bench_scaling")
    models = {name: w[2] for name, w in ref._build_workloads().items()}
    assert set(models) == set(bench_scaling.WORKLOADS)
    for name, model in models.items():
        assert bench_scaling.comm_bytes(name, n, d) == model(n, d), name
        kind = ref._build_workloads()[name][1]
        assert bench_scaling.COMM_KIND[name] == kind


# overlap-save's operations an output at length N: an FFT and its inverse,
# 5 N log2 N each, and the product, 6 a bin, over N - m + 1 outputs
OS_128 = (2 * 5 * 1024 * 10 + 6 * 1024) / (1024 - 128 + 1)     # N = 1024
OS_384 = (2 * 5 * 4096 * 12 + 6 * 4096) / (4096 - 384 + 1)     # N = 4096


@pytest.mark.parametrize("m, complex_taps, want", [
    (128, False, OS_128), (128, True, OS_128), (384, False, OS_384),
    (8, False, 4 * 8), (8, True, 8 * 8), (1, False, 4.0)])
def test_fir_flops_is_the_cheaper_algorithm(m, complex_taps, want):
    assert math.isclose(floors.fir_flops(m, complex_taps), want,
                        rel_tol=1e-12)


def test_floor_model_against_hand_counts(inp):
    assert floors.floor_ms(3.35e9, 0.0) == (1.0, "bytes", 1.0, 0.0)
    assert floors.floor_ms(0.0, 67e9) == (1.0, "operations", 0.0, 1.0)
    n, m = 1 << 22, 128
    nbytes, flops = bench.work(n, m)
    # planes 32 MiB, window 16, taps 512 B in; spectrum 16 MiB out; carry 16
    assert nbytes == 80 * 2 ** 20 + 512
    # the FIR by overlap-save (121.0 a sample; the direct sum's 512 is
    # more), window 2, FFT 5 x 22, magnitude 3
    assert math.isclose(flops, (OS_128 + 2 + 5 * 22 + 3) * n, rel_tol=1e-12)
    fl, bound, bms, fms = floors.floor_ms(nbytes, flops)
    assert bound == "bytes" and math.isclose(fl, 0.02504, rel_tol=1e-3)
    assert math.isclose(fms, 0.014775, rel_tol=1e-3)
    # rc_fir_4m at full size: 20 bytes a sample, bound by them too
    fl, bound, _, fms = floors.floor_ms(20 * n + 8 * m, OS_128 * n)
    assert bound == "bytes" and math.isclose(fl, 0.02504, rel_tol=1e-3)
    assert math.isclose(fms, 0.007575, rel_tol=1e-3)
    by = {c.metric: c for c in bench_all.configs(inp, "cpu", ab=True)}
    n5 = inp["c_re"].shape[-1]
    chan = by["channelizer_1024ch_4m"]
    assert chan.nbytes == 16 * n5 + 4 * 8192
    assert chan.flops == (32 + 5 * 10 + 6) * n5
    # the bytes-read bound at full size: 32 MiB in, 16 MiB out, ~15 us
    assert math.isclose(12 * (1 << 22) / floors.PEAK_BYTES * 1e6, 15.02,
                        rel_tol=1e-3)
    n2 = inp["x_re"].shape[-1]
    assert math.isclose(by["rc_fir_4m"].flops, OS_128 * n2, rel_tol=1e-12)
    for name in ("overlap_save_fft_384tap_4m",
                 "overlap_save_kernel_384tap_4m"):
        assert math.isclose(by[name].flops, OS_384 * n2, rel_tol=1e-12)
    assert by["interpolatef_1_5x_1m"].flops == 2 * 21 * 2 * 1.5 * (n2 >> 2)
    assert by["overlap_save_kernel_384tap_4m"].kernels == ("K3",)
    assert [c.kernels for c in by.values()][:5] == [
        ("K1n",), (), ("K4",), ("K4",), ("K6",)]


def test_the_flagship_chain_loop_feeds_back(inp):
    xr, xi, taps, window = bench.workload(1 << 15, "cpu")
    assert math.isclose(float(taps.sum()), 1.0, rel_tol=1e-6)
    from basic_dsp_tpu_torch import pipelines
    chain = pipelines.FirFftChainPlanar(taps, window)
    one = bench.chain_loop(chain, xr, xi)(1)
    two = bench.chain_loop(chain, xr, xi)(2)
    assert one.shape == (1 << 15,) and torch.isfinite(two).all()
    # 1 + fb * 1e-30 rounds to 1 in float32, as in the reference: the
    # carry orders the iterations without changing what they compute
    assert torch.equal(one, chain(xr, xi) * 1e-3) and torch.equal(one, two)


@pytest.fixture(scope="module")
def scaling(tmp_path_factory):
    out = tmp_path_factory.mktemp("scaling") / round_summary.SCALING
    record = bench_scaling.main(["--device", "cpu", "--devices", "1,2",
                                 "--iters", "1", "--out", str(out)])
    return record, out


def test_scaling_sweep_on_gloo_equals_the_single_device_calls(scaling):
    record, out = scaling
    assert json.loads(out.read_text()) == record
    assert [p["devices"] for p in record["points"]] == [1, 2]
    for name in bench_scaling.WORKLOADS:
        e = record["workloads"][name]
        assert [p["devices"] for p in e["strong"]] == [1, 2]
        assert all(p["err"] <= bench_scaling.TOL for p in e["strong"]), e
        assert set(e["strong_efficiency"]) == {"2"}
        assert e["link_projection"] == []     # gloo: no card's link
        assert [w["n"] for w in e["weak"]] == [2048, 4096]
        assert e["strong"][0]["comm_ms"] == 0.0 < e["strong"][1]["comm_ms"]


def test_round_summary_renders_what_exists(tmp_path, scaling):
    assert round_summary.lines(str(tmp_path)) == []
    session = bench_all.main(["--device", "cpu", "--json",
                              str(tmp_path / round_summary.BENCH_ALL)])
    assert [c["metric"] for c in session["configs"]] == list(CONFIGS)
    for c in session["configs"]:
        assert c["device"] == "cpu" and "value" not in c
        assert c["rehearsal_ms"] > 0 and c["launches"] == {}
    lines = round_summary.lines(str(tmp_path))
    assert len(lines) == 2 + len(CONFIGS)
    assert all(any(line.startswith(m) for line in lines) for m in CONFIGS)
    (tmp_path / round_summary.SCALING).write_text(
        scaling[1].read_text())
    lines = round_summary.lines(str(tmp_path))
    assert len(lines) == 2 + len(CONFIGS) + 1 + 4
    assert round_summary.main([str(tmp_path)]) == lines


def test_programs_exit_nonzero_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main in (bench.main, bench_all.main, bench_scaling.main):
        with pytest.raises(SystemExit) as e:
            main([])
        assert e.value.code not in (0, None)
    r = subprocess.run([sys.executable, "bench_torch.py"], cwd=ROOT,
                       capture_output=True, text=True, timeout=120,
                       env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert r.returncode != 0 and r.stdout == ""
    assert "--device cpu" in r.stderr


def test_the_flagship_rehearses_on_the_cpu(capsys):
    record = bench.main(["--device", "cpu"], env={})
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1
    line = json.loads(out[0])
    assert line == {"metric": "fir_fft_chain_throughput", "device": "cpu",
                    "n": bench.CPU_N, "rehearsal_ms": line["rehearsal_ms"]}
    assert line["rehearsal_ms"] > 0 and record["launches"] == {}
    assert record["bound"] == "bytes" and not record["fused"]
    fused = bench.main(["--device", "cpu"], env={"BENCH_FUSED": "1"})
    assert fused["fused"] and fused["launches"] == {}


def test_a_graph_capture_leaves_the_launch_counts(monkeypatch):
    """The wrappers count a launch (``_build.count_launch``) only while no
    CUDA graph is captured, so ``timing.Graphs`` needs no guard."""
    from basic_dsp_tpu_torch import kernels
    from basic_dsp_tpu_torch.kernels import _build
    before = kernels.launch_counts()
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    for fn in kernels.wrappers().values():
        _build.count_launch(fn)
    assert kernels.launch_counts() == before
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    for fn in kernels.wrappers().values():
        _build.count_launch(fn)
    assert kernels.launch_counts() == {k: n + 1 for k, n in before.items()}
    for k, fn in kernels.wrappers().items():
        fn.launches = before[k]


def test_device_ms_counts_kernels_and_not_annotations(monkeypatch):
    """``timing.device_ms`` sums the window's kernels; the device-side
    copy of a ``record_function`` range (a ``dsp.*`` span, a user
    annotation) and host events are left out."""
    import torch.profiler as tp
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU

    def event(key, device, us, annotation=False):
        return type("E", (), {"key": key, "device_type": device,
                              "self_device_time_total": us,
                              "is_user_annotation": annotation})()

    class Window:
        def __init__(self, activities):
            pass

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def key_averages(self):
            return [event("overlap_save_blocks", cuda, 400.0),
                    event("dsp.K3", cuda, 400.0, annotation=True),
                    event("vector_fft", cuda, 60.0),
                    event("aten::mm", cpu, 90.0),
                    event("idle", cuda, 0.0)]

    monkeypatch.setattr(tp, "profile", Window)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    total, per_kernel = timing.device_ms(lambda: None)
    assert per_kernel == {"overlap_save_blocks": 0.04, "vector_fft": 0.006}
    assert total == pytest.approx(0.046)
