"""PyTorch port, the kernels' build cache (basic_dsp_tpu_torch/kernels/
_build.py) on the CPU: a library's path is keyed by its source, by every
``csrc/*.cuh`` header beside it and by the nvcc flags, so an edit to a
shared header rebuilds every library.  No kernel is compiled here; the C
ABI library is, with the host compiler, and its build refuses a Python
without a shared libpython.  The timing probe's source edits
(``probes/phase_cuts.py``) are held to the sources they edit."""
import shutil

import pytest

from basic_dsp_tpu_torch.kernels import _build

SOURCES = ["rowfft_mag", "overlap_save", "resample", "channelizer",
           "fir_window"]


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


def test_interop_library_is_built_once_under_the_build_dir():
    """The C ABI library is built at first use into a directory of
    ``_build/`` keyed by its sources, and a C program links it by name."""
    path = _build.interop_library()
    assert path.name == "libbasic_dsp_tpu_torch.so" and path.exists()
    assert path.parent.parent == _build.BUILD_DIR
    assert path.parent.name.startswith("interop_")
    flags = _build.interop_c_flags()
    assert "-lbasic_dsp_tpu_torch" in flags
    assert f"-L{path.parent}" in flags
    assert f"-I{_build.INTEROP_INCLUDE}" in flags


def test_interop_build_refuses_a_python_without_libpython(monkeypatch):
    """A Python without a shared libpython cannot host a C caller, so the
    C ABI library's build raises and says so."""
    cfg = dict(_build.sysconfig.get_config_vars(), Py_ENABLE_SHARED=0,
               LDLIBRARY="libpython3.12.a")
    monkeypatch.setattr(_build.sysconfig, "get_config_vars", lambda: cfg)
    with pytest.raises(RuntimeError, match="no shared libpython"):
        _build._interop_flags()


@pytest.mark.parametrize("tag,source", [
    ("K1", "rowfft_mag"), ("K2", "rowfft_mag"), ("K3", "overlap_save"),
    ("K6", "channelizer"), ("RS", "resample")])
def test_phase_cuts_edits_match_their_source(tag, source):
    """Each source edit of ``probes/phase_cuts.py`` (a phase cut out for
    timing on the card) names text its kernel source holds: the probe
    stops on the card where one does not."""
    import importlib.util
    path = _build.CSRC.parent / "probes" / "phase_cuts.py"
    spec = importlib.util.spec_from_file_location("phase_cuts", path)
    cuts = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cuts)
    text = (_build.CSRC / f"{source}.cu").read_text()
    edits = getattr(cuts, f"{tag}_CUTS")
    assert edits["as built"] == []
    for label, pairs in edits.items():
        for old, _ in pairs:
            assert old in text, (tag, label, old[:60])
