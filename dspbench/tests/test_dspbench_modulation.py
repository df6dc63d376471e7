"""The check of ``modulation_rc.stream_64c`` at CPU sizes: the reference's
raised-cosine taps against a direct evaluation of the definition, and its
delay against the stream's; a small copy of the cell (4 carriers of two
1280-symbol chunks at 10/1, the cell's limit) whose run is correct, whose
control (the reference in TF32 in the program's place) fails the limit,
and whose run comes out not correct under each fault of the stream: one
tap's sign flipped, the imaginary plane dropped; and K4's floor written
out for the cell's shape, the next tail's write counted."""
import json
import math
import shutil
import time
from pathlib import Path

import pytest
import torch

from basic_dsp_tpu_torch import conv_types, streaming
from dspbench import cells, floors, harness, run, traffic

BENCH = Path(__file__).resolve().parents[1]
SEED = 2 ** 31 + 26
CELL = "modulation_tiny.qpsk_tiny"


@pytest.fixture
def tiny(tmp_path):
    """A copy of the benchmark's files with the small cell added."""
    root = tmp_path / "dspbench"
    shutil.copytree(BENCH, root, ignore=shutil.ignore_patterns(
        "tests", "__pycache__"))
    cfg = json.loads((root / "configs" / "modulation_rc.json").read_text())
    cfg.update(name="modulation_tiny", carriers=4, chunk=1280)
    (root / "configs" / "modulation_tiny.json").write_text(json.dumps(cfg))
    for kind in ("entries", "references"):
        shutil.copy(root / kind / "modulation_rc.py",
                    root / kind / "modulation_tiny.py")
    spec = json.loads((root / "traffic" / "qpsk_64c.json").read_text())
    spec.update(samples=4 * 2 * 1280, pool=3, keep=4)
    (root / "traffic" / "qpsk_tiny.json").write_text(json.dumps(spec))
    limits = json.loads((root / "workloads" / "modulation_rc.stream_64c"
                         ".json").read_text())["limits"]
    (root / "workloads" / f"{CELL}.json").write_text(json.dumps(
        {"config": "modulation_tiny", "traffic": "qpsk_tiny", "chips": 1,
         "limits": limits}))
    torch.set_num_threads(1)
    return root


def _run(root):
    cell = cells.load(CELL, root)
    res = harness.launch(cell, harness.run_body,
                         (SEED, 0.3, False, time.perf_counter()), "cpu")
    return run.assemble(cell, res, False, "cpu", "cpu")


def _rc(x: float, b: float) -> float:
    """The upstream crate's raised cosine at x (conv_types.rs), in Python
    floats."""
    if x == 0:
        return 1.0
    if abs(abs(2 * b * x) - 1) < 1e-12:
        xp = 1 / (2 * b)
        return math.pi / 4 * math.sin(math.pi * xp) / (math.pi * xp)
    return (math.sin(math.pi * x) / (math.pi * x) * math.cos(math.pi * b * x)
            / (1 - (2 * b * x) ** 2))


def test_the_references_taps_and_the_streams_delay(tiny):
    cell = cells.load(CELL, tiny)
    ref = cell.reference
    consts = ref.constants(cell.config, 0, "cpu")
    P, Q, L = consts["P"], consts["Q"], consts["L"]
    b = cell.config["rolloff"]
    want = torch.tensor([[_rc(t - L - p / P, b) for t in range(2 * L + 1)]
                         for p in range(P)], dtype=torch.float64)
    assert consts["taps"].shape == (10, 21) and (P, Q, L) == (10, 1, 10)
    assert (consts["taps"] - want).abs().max() <= 1e-15
    # no tap lies on the pole |x| = 1 / (2 b), and the limit is the RC's
    assert all(abs(abs(2 * b * (t - L - p / P)) - 1) > 1e-3
               for p in range(P) for t in range(2 * L + 1))
    pole = ref.rc_taps(4, 2, 0.25)[0, 0]          # x = -2: the pole
    assert pole == pytest.approx(_rc(-2.0, 0.25), rel=1e-15)
    rs = streaming.StreamingResampler(conv_types.RaisedCosineFunction(b),
                                      10.0, 0.0, L, device="cpu")
    from dspbench.references import audio_src_madi
    assert audio_src_madi.tail_len(P, Q, L) == rs.T == 128
    assert consts["delay"] * P == rs.output_delay == 1180


def test_the_run_is_correct_and_the_control_fails_the_limit(tiny):
    assert _run(tiny)["correct"] is True
    cell = cells.load(CELL, tiny)
    consts = cell.reference.constants(cell.config, 0, "cpu")
    xr, xi = traffic.capture(cell.traffic, SEED, 1, "cpu")
    ref = cell.reference.reference(cell.config, consts, xr, xi)
    ctl = cell.reference.reference(cell.config, consts, xr, xi, "tf32")[0]
    assert ctl.dtype == torch.complex64
    errs = cell.reference.errors(ctl, ref)
    assert any(v > cell.limits[name] * 3 for name, v in errs.items()), errs


def _one_tap_flipped(init):
    def f(self, *args, **kw):
        init(self, *args, **kw)
        self.taps = self.taps.clone()
        self.taps[3, 7] = -self.taps[3, 7]
    return f


def _imaginary_dropped(process):
    def f(self, chunk, state):
        out, state = process(self, chunk, state)
        return torch.complex(out.real, torch.zeros_like(out.real)), state
    return f


@pytest.mark.parametrize("name,fault", [("__init__", _one_tap_flipped),
                                        ("process", _imaginary_dropped)])
def test_a_broken_stream_is_not_correct(tiny, monkeypatch, name, fault):
    target = streaming.StreamingResampler
    monkeypatch.setattr(target, name, fault(getattr(target, name)))
    rec = _run(tiny)
    assert rec["correct"] is False and rec["failed"] > 0, rec["checks"]


def test_k4s_floor_at_the_cells_shape_counts_the_next_tail():
    entry = cells.module(BENCH, "entries", "modulation_rc")
    S, T, n_out = 65536, 128, 655360
    nbytes, flops, floor = entry.k4_work(64, S, T, n_out, 10, 21)
    # chunk and tail read, next tail and outputs written, 8 bytes each
    assert nbytes == 8 * 64 * (S + T) + 8 * 64 * (T + n_out) + 4 * 10 * 22
    assert nbytes == 369_230_704
    # the next tail's write: T samples a row beyond the chunk, the tail
    # and the outputs
    assert nbytes - 8 * 64 * (S + T + n_out) - 4 * 10 * 22 == 8 * 64 * T
    assert flops == 2 * 21 * 2 * 64 * n_out == 3_523_215_360
    assert floor == floors.floor_ms(nbytes, flops)
    assert floor[1] == "bytes"
    assert floor[0] == pytest.approx(369_230_704 / 3.35e12 * 1e3)
