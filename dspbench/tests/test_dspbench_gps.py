"""The check of ``gps_ca_bank.stream_4m`` at CPU sizes: a small copy of
the cell (3 PRNs at one sample a chip, 2^14-sample chunks of 2^16-sample
captures, the cell's limit) whose run is correct, whose control (the
reference in TF32 in the program's place) fails the limit, and whose run
comes out not correct under each fault of the bank's path: a dropped tap,
the tail lost between chunks, one row's taps swapped for another's, the
spectra rounded to bf16."""
import json
import shutil
import time
from pathlib import Path

import pytest
import torch

from dspbench import cells, harness, run, traffic
from basic_dsp_tpu_torch import streaming
from basic_dsp_tpu_torch.kernels import overlap_save_cuda

BENCH = Path(__file__).resolve().parents[1]
SEED = 2 ** 31 + 7
CELL = "gps_ca_tiny.l1_tiny"


@pytest.fixture
def tiny(tmp_path):
    """A copy of the benchmark's files with the small cell added."""
    root = tmp_path / "dspbench"
    shutil.copytree(BENCH, root, ignore=shutil.ignore_patterns(
        "tests", "__pycache__"))
    cfg = json.loads((root / "configs" / "gps_ca_bank.json").read_text())
    cfg.update(name="gps_ca_tiny", prns=[1, 2, 3], samples_per_chip=1,
               chunk=1 << 14)
    (root / "configs" / "gps_ca_tiny.json").write_text(json.dumps(cfg))
    for kind in ("entries", "references"):
        shutil.copy(root / kind / "gps_ca_bank.py",
                    root / kind / "gps_ca_tiny.py")
    spec = json.loads((root / "traffic" / "l1_4m.json").read_text())
    spec.update(samples=1 << 16, pool=3, keep=4)
    (root / "traffic" / "l1_tiny.json").write_text(json.dumps(spec))
    limits = json.loads((root / "workloads" /
                         "gps_ca_bank.stream_4m.json").read_text())["limits"]
    (root / "workloads" / f"{CELL}.json").write_text(json.dumps(
        {"config": "gps_ca_tiny", "traffic": "l1_tiny", "chips": 1,
         "limits": limits}))
    torch.set_num_threads(1)
    return root


def _run(root):
    cell = cells.load(CELL, root)
    res = harness.launch(cell, harness.run_body,
                         (SEED, 0.3, False, time.perf_counter()), "cpu")
    return run.assemble(cell, res, False, "cpu", "cpu")


def test_the_control_fails_the_limit(tiny):
    cell = cells.load(CELL, tiny)
    consts = cell.reference.constants(cell.config, 0, "cpu")
    xr, xi = traffic.capture(cell.traffic, SEED, 1, "cpu")
    ref = cell.reference.reference(cell.config, consts, xr, xi)
    ctl = cell.reference.reference(cell.config, consts, xr, xi, "tf32")[0]
    errs = cell.reference.errors(ctl, ref)
    assert any(v > cell.limits[name] * 3 for name, v in errs.items()), errs


def _dropped_tap(init):
    def f(self, taps, device=None):
        taps = taps.clone()
        taps[1, 500] = 0.0
        init(self, taps, device)
    return f


def _swapped_rows(init):
    def f(self, taps, device=None):
        init(self, taps[[1, 0, 2]], device)
    return f


def _lost_tail(process):
    def f(self, chunk, state):
        return process(self, chunk, self.init_state(chunk.dtype,
                                                    chunk.device))
    return f


def _bf16(spectrum):
    def f(h, fft_len):
        H = spectrum(h, fft_len)
        return torch.complex(H.real.to(torch.bfloat16).float(),
                             H.imag.to(torch.bfloat16).float())
    return f


@pytest.mark.parametrize("target,name,fault", [
    (streaming.StreamingFir, "__init__", _dropped_tap),
    (streaming.StreamingFir, "process", _lost_tail),
    (streaming.StreamingFir, "__init__", _swapped_rows),
    (overlap_save_cuda, "spectrum", _bf16)])
def test_a_broken_bank_is_not_correct(tiny, monkeypatch, target, name,
                                      fault):
    assert _run(tiny)["correct"] is True
    monkeypatch.setattr(target, name, fault(getattr(target, name)))
    rec = _run(tiny)
    assert rec["correct"] is False and rec["failed"] > 0, rec["checks"]
