"""PyTorch port, the kernels' build cache (basic_dsp_tpu_torch/kernels/
_build.py) on the CPU: a library's path is keyed by its source, by every
``csrc/*.cuh`` header beside it and by the nvcc flags, so an edit to a
shared header rebuilds every library.  Nothing is compiled here."""
import shutil

import pytest

from basic_dsp_tpu_torch.kernels import _build

SOURCES = ["rowfft_mag", "overlap_save", "resample", "channelizer"]


def _copy(tmp_path):
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    return csrc


@pytest.mark.parametrize("name", SOURCES)
def test_path_is_stable_and_matches_the_package(name, tmp_path):
    csrc = _copy(tmp_path)
    assert _build.library_path(name, csrc) == _build.library_path(name)
    assert _build.library_path(name, csrc) == _build.library_path(name, csrc)
    assert _build.library_path(name).parent == _build.BUILD_DIR


@pytest.mark.parametrize("name", SOURCES)
def test_header_edit_changes_the_path(name, tmp_path):
    csrc = _copy(tmp_path)
    before = _build.library_path(name, csrc)
    headers = sorted(csrc.glob("*.cuh"))
    assert headers, "the FFT core lives in a csrc/*.cuh header"
    headers[0].write_text(headers[0].read_text() + "\n// edited\n")
    assert _build.library_path(name, csrc) != before


def test_new_header_and_source_edit_change_the_path(tmp_path):
    csrc = _copy(tmp_path)
    before = _build.library_path("channelizer", csrc)
    (csrc / "extra.cuh").write_text("#pragma once\n")
    added = _build.library_path("channelizer", csrc)
    assert added != before
    src = csrc / "channelizer.cu"
    src.write_text(src.read_text() + "\n")
    assert _build.library_path("channelizer", csrc) != added
