"""PyTorch port, the multi-host harness (basic_dsp_tpu_torch/multihost.py,
multihost_worker.py), the twin of tests/test_multiprocess.py: two host
processes of two gloo ranks each, the (host, chip) mesh's outer axis
crossing the process boundary; the five sharded functions must agree with
their single-device oracles at the JAX harness's tolerances, each host's
ranks take local indices 0 and 1 (``config.distributed_init`` reads
``LOCAL_RANK``), the command line writes its result only to ``--out``,
and a rank that fails fails the run."""
import json
import os

import pytest

from basic_dsp_tpu_torch import multihost

ROOT = os.path.join(os.path.dirname(__file__), "..")


def test_two_hosts_of_two_ranks_agree_with_the_oracles(tmp_path, capsys):
    record = os.path.join(ROOT, "MULTIHOST_r05.json")
    before = os.stat(record).st_mtime_ns
    out = tmp_path / "multihost.json"
    code = multihost.main(["2", "2", str(1 << 14), "--cpu", "--out",
                           str(out)])
    assert code == 0
    result = json.loads(out.read_text())
    assert json.loads(capsys.readouterr().out.strip()) == result
    assert os.stat(record).st_mtime_ns == before
    assert result["n_processes"] == 2
    assert result["local_devices_per_process"] == 2
    assert result["global_devices"] == 4
    assert result["signal_len"] == 1 << 14 and result["taps"] == 31
    assert set(result["checks"]) == {
        "sharded_convolve_signal", "sharded_statistics", "sharded_fft",
        "sharded_interpolatef", "sharded_channelizer"}
    for name, chk in result["checks"].items():
        assert chk["ok"], (name, chk)
        assert chk["launches"] == {}, name      # gloo: the plain versions
    assert result["ok"]
    assert result["local_device_indices"] == [0, 1, 0, 1]
    assert result["device"] == "cpu (gloo)"
    timing = result["timing"]
    assert timing["sharded_fir_mesh_ms"] > 0
    assert timing["sharded_fir_local_mesh_ms"] > 0


def test_a_failing_rank_fails_the_run():
    """1000 samples on two ranks: a shard of 500, which 128 * Q = 256 does
    not divide, so the sharded resampler raises in every rank, as the JAX
    package's does."""
    with pytest.raises(RuntimeError, match=r"(?s)host 0 failed.*128\*Q = 256"):
        multihost.run(1, 2, 1000, device_type="cpu", timeout=120)
