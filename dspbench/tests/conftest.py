"""Fixtures of the benchmark's own tests: a copy of the benchmark's files
with small cells added as files alone, and the card, for the tests that
need it (marked ``card``; they skip without CUDA, decided inside the
fixture)."""
import json
import shutil
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parents[1]
REPO = BENCH.parent

# Small cells, added as files alone: traffic files and workloads
TINY = {
    "tones_tiny": ({"samples": 65536, "pool": 3, "keep": 4,
                    "signal": {"noise_rms": 1.0, "tones": 4,
                               "tone_amplitude": [0.05, 0.5]}},
                   "fir_fft_spectrum", 1,
                   {"spectrum_max_rel_err": 1e-05}),
    "fm_tiny": ({"samples": 65536, "pool": 3, "keep": 4,
                 "signal": {"noise_rms": 0.05, "fm_grid": 1024,
                            "fm_carriers": 16, "fm_amplitude": [0.2, 1.0],
                            "fm_deviation": 0.3, "fm_message": 0.02}},
                "channelizer_fm", 1, {"angle_weighted_err": 1e-03}),
    "fm_tiny_mesh": ({"samples": 65536, "pool": 2, "keep": 3,
                      "signal": {"noise_rms": 0.05, "fm_grid": 1024,
                                 "fm_carriers": 16,
                                 "fm_amplitude": [0.2, 1.0],
                                 "fm_deviation": 0.3, "fm_message": 0.02}},
                     "channelizer_fm", 2, {"angle_weighted_err": 1e-03}),
}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA card (skips without CUDA)")


def add_tiny_cells(root: Path) -> dict:
    """Adds the small cells to the benchmark files under ``root``; returns
    their names by traffic."""
    names = {}
    for traffic, (spec, config, chips, limits) in TINY.items():
        (root / "traffic" / f"{traffic}.json").write_text(json.dumps(spec))
        name = f"{config}.{traffic}"
        (root / "workloads" / f"{name}.json").write_text(json.dumps(
            {"config": config, "traffic": traffic, "chips": chips,
             "limits": limits}))
        names[traffic] = name
    return names


@pytest.fixture
def tiny_root(tmp_path):
    """A copy of the benchmark's files with the small cells added."""
    root = tmp_path / "dspbench"
    shutil.copytree(BENCH, root, ignore=shutil.ignore_patterns(
        "tests", "__pycache__"))
    return root, add_tiny_cells(root)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: run on the card")
    return torch.device("cuda")
