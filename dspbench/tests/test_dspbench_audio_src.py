"""The check of ``audio_src_madi.stream_64ch`` at CPU sizes: the plain
reference against a direct float64 loop of the upstream ``interpolatef``;
a small copy of the cell (4 channels of two 18816-sample chunks at 160/147,
the cell's limit) whose run is correct, whose control (the reference in
TF32 in the program's place) fails the limit, and whose run comes out not
correct under each fault of the stream: the taps a phase off, the tail
dropped at a chunk boundary; and K5's floor written out for one shape."""
import json
import math
import shutil
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import basic_dsp_tpu_torch as bt
from basic_dsp_tpu_torch import streaming
from dspbench import cells, floors, harness, run, traffic

BENCH = Path(__file__).resolve().parents[1]
SEED = 2 ** 31 + 11
CELL = "audio_src_tiny.madi_tiny"


@pytest.fixture
def tiny(tmp_path):
    """A copy of the benchmark's files with the small cell added."""
    root = tmp_path / "dspbench"
    shutil.copytree(BENCH, root, ignore=shutil.ignore_patterns(
        "tests", "__pycache__"))
    cfg = json.loads((root / "configs" / "audio_src_madi.json").read_text())
    cfg.update(name="audio_src_tiny", channels=4, chunk=128 * 147)
    (root / "configs" / "audio_src_tiny.json").write_text(json.dumps(cfg))
    for kind in ("entries", "references"):
        shutil.copy(root / kind / "audio_src_madi.py",
                    root / kind / "audio_src_tiny.py")
    spec = json.loads((root / "traffic" / "madi_64ch.json").read_text())
    spec.update(samples=4 * 2 * 128 * 147 // 2, pool=3, keep=4)
    (root / "traffic" / "madi_tiny.json").write_text(json.dumps(spec))
    limits = json.loads((root / "workloads" / "audio_src_madi.stream_64ch"
                         ".json").read_text())["limits"]
    (root / "workloads" / f"{CELL}.json").write_text(json.dumps(
        {"config": "audio_src_tiny", "traffic": "madi_tiny", "chips": 1,
         "limits": limits}))
    torch.set_num_threads(1)
    return root


def _run(root):
    cell = cells.load(CELL, root)
    res = harness.launch(cell, harness.run_body,
                         (SEED, 0.3, False, time.perf_counter()), "cpu")
    return run.assemble(cell, res, False, "cpu", "cpu")


def _direct(x, P, Q, L, delay):
    """interpolatef's sum, output by output, on x prefixed with ``delay``
    zeros: center = i Q / P in integers, r = floor(center)."""
    C, n = x.shape
    z = np.concatenate([np.zeros((C, delay)), x], axis=1)
    out = np.zeros((C, n * P // Q))
    for i in range(out.shape[1]):
        r, rem = divmod(i * Q, P)
        frac = rem / P
        for t in range(2 * L + 1):
            j = r - L + t
            if 0 <= j < z.shape[1]:
                arg = t - L - frac
                w = 1.0 if arg == 0 else math.sin(math.pi * arg) / (
                    math.pi * arg)
                out[:, i] += z[:, j] * w
    return out


def test_the_reference_is_the_direct_sum_and_the_streams_delay(tiny):
    cell = cells.load(CELL, tiny)
    ref = cell.reference
    consts = ref.constants(cell.config, 0, "cpu")
    P, Q, L = consts["P"], consts["Q"], consts["L"]
    rs = streaming.StreamingResampler(bt.SincFunction(), P / Q, 0.0, L,
                                      device="cpu")
    assert (P, Q, L) == (rs.P, rs.Q, rs.L) == (160, 147, 10)
    assert ref.tail_len(P, Q, L) == rs.T == 18826
    assert consts["delay"] // Q * P == rs.output_delay == 20480
    x = torch.randn((2, 8 * Q), generator=torch.Generator().manual_seed(3),
                    dtype=torch.float64)
    got = ref.resample(consts, x)
    want = _direct(x.numpy(), P, Q, L, consts["delay"])
    assert got.shape == want.shape == (2, 8 * P)
    assert np.abs(got.numpy() - want).max() <= 1e-12 * np.abs(want).max()


def test_the_run_is_correct_and_the_control_fails_the_limit(tiny):
    assert _run(tiny)["correct"] is True
    cell = cells.load(CELL, tiny)
    consts = cell.reference.constants(cell.config, 0, "cpu")
    xr, xi = traffic.capture(cell.traffic, SEED, 1, "cpu")
    ref = cell.reference.reference(cell.config, consts, xr, xi)
    ctl = cell.reference.reference(cell.config, consts, xr, xi, "tf32")[0]
    errs = cell.reference.errors(ctl, ref)
    assert any(v > cell.limits[name] * 3 for name, v in errs.items()), errs


def _taps_a_phase_off(init):
    def f(self, *args, **kw):
        init(self, *args, **kw)
        self.taps = self.taps.roll(1, dims=0)
    return f


def _tail_dropped(process):
    def f(self, chunk, state):
        return process(self, chunk, self.init_state(
            chunk.dtype, chunk.device, channels=tuple(chunk.shape[:-1])))
    return f


@pytest.mark.parametrize("name,fault", [("__init__", _taps_a_phase_off),
                                        ("process", _tail_dropped)])
def test_a_broken_stream_is_not_correct(tiny, monkeypatch, name, fault):
    target = streaming.StreamingResampler
    monkeypatch.setattr(target, name, fault(getattr(target, name)))
    rec = _run(tiny)
    assert rec["correct"] is False and rec["failed"] > 0, rec["checks"]


def test_k5s_floor_at_the_cells_shape():
    entry = cells.module(BENCH, "entries", "audio_src_madi")
    nbytes, flops, floor = entry.k5_work(64, 150528 + 18826, 163840, 160,
                                         21)
    assert nbytes == 4 * 64 * (169354 + 163840) + 4 * 160 * 22
    assert nbytes == 85_311_744
    assert flops == 2 * 21 * 64 * 163840 == 440_401_920
    assert floor == floors.floor_ms(nbytes, flops)
    assert floor[1] == "bytes"
    assert floor[0] == pytest.approx(85_311_744 / 3.35e12 * 1e3)
